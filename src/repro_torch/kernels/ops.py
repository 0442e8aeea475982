"""The MX quantize (B6), fake-quant (B7) and Slice-and-Scale (B5) kernels
behind the API of ``repro/kernels/ops.py``: any leading dims, any block axis.

On a CUDA tensor each wrapper checks what its kernel takes (contiguous f32
or bf16 values and a block size of 8, 16, 32 or 64; int8 / uint8 codes),
allocates the outputs and launches the kernel, or raises (a tensor that
holds no data, fake or ``meta``, takes the same branch and launches
shape-only: ``kernels/common.py``). On a CPU tensor it computes the plain
version: ``core/mx.py::quantize``,
``core/mx.py::quantize_dequantize``,
``core/slice_scale.py::slice_and_scale`` (then ``pack_int4_splitn`` for the
fused split-N mode). The quantizing kernels read the
block axis in place — a tensor is viewed as (outer, K, inner) with K the
block axis — so a weight blocked along its contraction axis, or a stacked
(G, K, N) leaf, needs no transposed copy (JAX's ``_as2d`` makes one).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core.formats import MXFormat, delta_e
from repro_torch.core.mx import MXTensor, quantize, quantize_dequantize
from repro_torch.core.packed import pack_int4_splitn, splitn_ok
from repro_torch.core.slice_scale import slice_and_scale
from repro_torch.kernels import fake_quant as _fq
from repro_torch.kernels import mx_quantize as _mq
from repro_torch.kernels import ss_convert as _ss
from repro_torch.kernels.common import on_card

KERNEL_BLOCK_SIZES = (8, 16, 32, 64)
VALUE_DTYPES = (torch.float32, torch.bfloat16)


def _view3(v: torch.Tensor, fmt: MXFormat, axis: int, name: str
           ) -> Tuple[int, int, int]:
    """(outer, K, inner) of ``v`` around the block axis, after checking
    what the kernel takes."""
    if v.dtype not in VALUE_DTYPES:
        raise ValueError(f"{name}: the kernel reads f32 or bf16, got "
                         f"{v.dtype}")
    if not v.is_contiguous():
        raise ValueError(f"{name}: the kernel reads a contiguous tensor")
    if fmt.block_size not in KERNEL_BLOCK_SIZES:
        raise ValueError(f"{name}: the kernel takes block sizes "
                         f"{KERNEL_BLOCK_SIZES}, got {fmt.block_size}")
    k = v.shape[axis]
    if k % fmt.block_size:
        raise ValueError(f"block axis length {k} not divisible by block size "
                         f"{fmt.block_size}")
    return math.prod(v.shape[:axis]), k, math.prod(v.shape[axis + 1:])


def mx_quantize(v: torch.Tensor, fmt: MXFormat, axis: int = -1) -> MXTensor:
    """B6: MX quantization -> MXTensor (the API of ``core.mx.quantize``)."""
    axis = axis % v.ndim
    if not on_card(v):
        return quantize(v, fmt, axis=axis)
    outer, k, inner = _view3(v, fmt, axis, "mx_quantize")
    codes = torch.empty(v.shape, device=v.device, dtype=torch.int8
                        if fmt.kind == "int" else torch.uint8)
    scales = torch.empty(v.shape[:axis] + v.shape[axis + 1:]
                         + (k // fmt.block_size,), device=v.device,
                         dtype=torch.int8)
    _mq.launch(v, codes, scales, fmt, outer, k, inner)
    return MXTensor(codes=codes, scale_exp=scales, fmt=fmt, block_axis=axis)


def fake_quant(v: torch.Tensor, fmt: MXFormat, axis: int = -1, *,
               out_dtype=None, ste: bool = False) -> torch.Tensor:
    """B7: fused quantize -> dequantize (the QAT forward weight) in
    ``v.dtype``; ``ste`` gives the straight-through value ``v + (w_q - v)``
    in ``v.dtype``; the result is cast to ``out_dtype`` (default
    ``v.dtype``)."""
    axis = axis % v.ndim
    out_dtype = out_dtype or v.dtype
    if not on_card(v):
        return fake_quant_plain(v, fmt, axis, out_dtype=out_dtype, ste=ste)
    outer, k, inner = _view3(v, fmt, axis, "fake_quant")
    if out_dtype not in VALUE_DTYPES:
        raise ValueError(f"fake_quant: the kernel writes f32 or bf16, got "
                         f"{out_dtype}")
    out = torch.empty(v.shape, device=v.device, dtype=out_dtype)
    _fq.launch(v, out, fmt, outer, k, inner, ste)
    return out


def fake_quant_plain(v: torch.Tensor, fmt: MXFormat, axis: int = -1, *,
                     out_dtype=None, ste: bool = False) -> torch.Tensor:
    """The plain version of ``fake_quant``, on any device."""
    wq = quantize_dequantize(v, fmt, axis=axis)
    return (v + (wq - v) if ste else wq).to(out_dtype or v.dtype)


def _same_format(t: MXTensor, low: MXFormat) -> bool:
    return low.name == t.fmt.name and low.block_size == t.fmt.block_size


def _check_ss(t: MXTensor, low: MXFormat, name: str) -> None:
    """Raise unless B5 takes ``t`` -> ``low``."""
    high = t.fmt
    if high.kind != low.kind:
        raise ValueError(
            f"cannot slice-and-scale across kinds ({high.name} -> {low.name})")
    if low.block_size != high.block_size:
        raise ValueError("slice-and-scale preserves block size")
    delta_e(high, low)                          # raises on an up-conversion
    want = torch.int8 if high.kind == "int" else torch.uint8
    if t.codes.dtype != want or t.scale_exp.dtype != torch.int8:
        raise ValueError(f"{name}: {high.name} takes {want} codes and "
                         f"int8 scales, got {t.codes.dtype} and "
                         f"{t.scale_exp.dtype}")
    if not (t.codes.is_contiguous() and t.scale_exp.is_contiguous()):
        raise ValueError(f"{name}: codes and scales must be contiguous")
    if t.scale_exp.device != t.codes.device:
        raise ValueError(f"{name}: codes and scales on different devices")


def ss_convert(t: MXTensor, low: MXFormat) -> MXTensor:
    """B5: Slice-and-Scale on packed codes and scales (the API of
    ``core.slice_scale.slice_and_scale``; identity if the formats match)."""
    if not on_card(t.codes) or _same_format(t, low):
        return slice_and_scale(t, low)
    _check_ss(t, low, "ss_convert")
    codes = torch.empty_like(t.codes, dtype=torch.int8
                             if low.kind == "int" else torch.uint8)
    scales = torch.empty_like(t.scale_exp)
    _ss.launch(t.codes, t.scale_exp, codes, scales, t.fmt, low)
    return MXTensor(codes=codes, scale_exp=scales, fmt=low,
                    block_axis=t.block_axis)


def ss_convert_int4_splitn(t: MXTensor, low: MXFormat
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5 with the split-N nibble packing fused: Slice-and-Scale ``t`` to
    the 4-bit MXINT ``low`` and return (packed (..., N/2) uint8, scales) —
    ``pack_int4_splitn`` of the converted codes, the container B2 reads.
    ``t`` must take the split-N layout (``core.packed.splitn_ok``). The
    plain version (CPU tensors, or ``low`` equal to ``t``'s format) packs
    ``slice_and_scale(t, low)``."""
    if not (low.kind == "int" and low.bits == 4):
        raise ValueError(f"split-N packing is for 4-bit MXINT, not "
                         f"{low.name}")
    if not splitn_ok(t.codes.shape, t.block_axis):
        raise ValueError(f"codes {tuple(t.codes.shape)} blocked along axis "
                         f"{t.block_axis} do not take the split-N layout")
    if not on_card(t.codes) or _same_format(t, low):
        s = slice_and_scale(t, low)
        return pack_int4_splitn(s.codes).contiguous(), s.scale_exp
    _check_ss(t, low, "ss_convert_int4_splitn")
    half = t.codes.shape[-1] // 2
    packed = torch.empty(t.codes.shape[:-1] + (half,), device=t.codes.device,
                         dtype=torch.uint8)
    scales = torch.empty_like(t.scale_exp)
    _ss.launch(t.codes, t.scale_exp, packed, scales, t.fmt, low, half=half)
    return packed, scales
