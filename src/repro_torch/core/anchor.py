"""Anchor-format model storage + elastic conversion (paper §3.5).

Counterpart of ``repro/core/anchor.py``:
  1. quantize the trained master weights once to the anchor format
     (MXINT8 / MXFP8) -> ``AnchorModel`` (MXTensor leaves + raw leaves),
  2. derive any lower-precision format by Slice-and-Scale, without the
     full-precision weights,
  3. serve the packed codes through the dequant-GEMM kernels, or
     ``materialize`` a dense tree.

Leaves are keyed by JAX ``keystr`` paths (``core/tree.py``). On a CUDA
tensor a stacked leaf (G, K, N), or a MoE expert leaf (G, E, K, N), is
quantized by one B6 launch and converted by one B5 launch
(``kernels/ops.py``), blocked along ndim-2 and read in place with no
temporaries; on the CPU the plain versions run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core.formats import MXFormat
from repro_torch.core.mx import MXTensor, dequantize
from repro_torch.core.qat import QATConfig, pytree_block_axis
from repro_torch.core.tree import flatten_paths, unflatten_paths
from repro_torch.devices import resolve_device
from repro_torch.kernels.ops import mx_quantize, ss_convert


@dataclasses.dataclass
class AnchorModel:
    """quantized: dict path -> MXTensor; raw: dict path -> float leaf."""

    quantized: Dict[str, MXTensor]
    raw: Dict[str, torch.Tensor]
    fmt_name: str


def make_anchor(params, cfg: QATConfig, anchor: MXFormat | None = None, *,
                device="cuda") -> AnchorModel:
    """One-time quantization of master weights to the anchor format."""
    dev = resolve_device(device)
    fmt = anchor or cfg.anchor_obj()
    if fmt is None:
        raise ValueError("anchor format required")
    q, raw = {}, {}
    for path, w in flatten_paths(params):
        w = w.to(dev)
        ax = pytree_block_axis(w)
        if (w.ndim >= 2 and cfg.is_quantized_path(path)
                and w.shape[ax] % fmt.block_size == 0):
            q[path] = mx_quantize(w.contiguous(), fmt, axis=ax)
        else:
            raw[path] = w
    return AnchorModel(quantized=q, raw=raw, fmt_name=fmt.name)


def convert(model: AnchorModel, target: MXFormat) -> AnchorModel:
    """Slice-and-Scale the whole model to a lower-precision format."""
    return AnchorModel(
        quantized={k: ss_convert(t, target)
                   for k, t in model.quantized.items()},
        raw=model.raw,
        fmt_name=target.name,
    )


def materialize(model: AnchorModel, dtype=torch.bfloat16):
    """Rebuild a dense param tree (for the dense reference contracts)."""
    out = {}
    for path, t in model.quantized.items():
        out[path] = dequantize(t, dtype=dtype)
    for path, w in model.raw.items():
        out[path] = w.to(dtype) if w.is_floating_point() else w
    return unflatten_paths(out)


def storage_bytes(model: AnchorModel) -> int:
    """True packed checkpoint size (elements at fmt.bits + E8M0 scales)."""
    total = sum(t.nbytes_logical for t in model.quantized.values())
    return total + sum(w.numel() * w.element_size()
                       for w in model.raw.values())
