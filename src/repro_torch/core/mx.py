"""Block-wise MX quantization / dequantization in PyTorch (OCP MX semantics).

Bit-exact counterpart of ``repro/core/mx.py``:

    shared_exp = floor(log2(max_i |V_i|)) - e_max(f)
    X          = 2^shared_exp
    P_i        = quantize_f(V_i / X)

Codes: MXINT as int8 two's-complement values, MXFP as uint8 bit patterns
``s | e | m`` in the low ``bits`` bits. Scales: int8 E8M0 exponents.
``torch.frexp`` mirrors ``jnp.frexp``; ``torch.round`` rounds half to even
like ``jnp.round``; powers of two are built from float32 bit patterns, as
``jnp.ldexp`` gives them under XLA (subnormal powers flush to zero).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.formats import MXFormat, SCALE_EXP_MAX, SCALE_EXP_MIN


@dataclasses.dataclass
class MXTensor:
    """A tensor in an MX format.

    codes:      element codes, same shape as the logical tensor (int8/uint8)
    scale_exp:  int8 block-scale exponents; codes.shape with the block axis
                divided by fmt.block_size and moved last
    fmt:        the MXFormat
    block_axis: which axis blocks run along (non-negative)
    """

    codes: torch.Tensor
    scale_exp: torch.Tensor
    fmt: MXFormat
    block_axis: int

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.codes.shape)

    @property
    def nbytes_logical(self) -> int:
        """True packed storage footprint in bytes (elements + scales)."""
        n = int(np.prod(self.shape)) if self.shape else 1
        nblocks = n // self.fmt.block_size
        return (n * self.fmt.bits + nblocks * 8 + 7) // 8


def _to_blocks(x: torch.Tensor, block_size: int, axis: int) -> torch.Tensor:
    """(..., n, ...) -> (..., n/bs, bs) with the block axis moved last."""
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    if n % block_size != 0:
        raise ValueError(f"block axis length {n} not divisible by block size "
                         f"{block_size}")
    return x.reshape(*x.shape[:-1], n // block_size, block_size)


def _from_blocks(xb: torch.Tensor, axis: int) -> torch.Tensor:
    x = xb.reshape(*xb.shape[:-2], xb.shape[-2] * xb.shape[-1])
    return torch.movedim(x, -1, axis)


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for x > 0, exact at powers of two (frexp-based)."""
    return (torch.frexp(x).exponent - 1).to(torch.int32)


def _exp2i(e: torch.Tensor) -> torch.Tensor:
    """2^e as float32 for integer e, as ``jnp.ldexp(1, e)`` gives it under
    XLA: exact for e in [-126, 127], +inf above, and 0 below — XLA flushes
    the subnormal range to zero, and so does this, bit for bit."""
    e = e.to(torch.int32)
    bits = (torch.clamp(e, -126, 128) + 127) << 23     # 128 -> +inf pattern
    return torch.where(e >= -126, bits, torch.zeros_like(bits)) \
        .view(torch.float32)


# =============================================================================
# Element quantizers (value domain)
# =============================================================================
def quantize_int_element(y: torch.Tensor, fmt: MXFormat) -> torch.Tensor:
    """clip_b(round(y)) -> int8 integer codes. Round half-to-even."""
    assert fmt.kind == "int"
    maxq = fmt.int_maxq
    return torch.clamp(torch.round(y), -maxq, maxq).to(torch.int8)


def quantize_fp_element_value(y: torch.Tensor, fmt: MXFormat) -> torch.Tensor:
    """Round-to-nearest-even into the MXFP(η,μ) value set, saturating."""
    assert fmt.kind == "fp"
    y = y.to(torch.float32)
    a = torch.abs(y)
    e_raw = torch.frexp(torch.where(a > 0, a, torch.ones_like(a))).exponent
    e = torch.clamp(e_raw - 1, min=fmt.emin)
    quantum = _exp2i(e - fmt.mbits)
    q = torch.round(y / quantum) * quantum
    q = torch.clamp(q, -fmt.fp_max, fmt.fp_max)
    return torch.where(a > 0, q, torch.zeros_like(q))


# ---- MXFP code <-> value ----------------------------------------------------
def encode_fp(values: torch.Tensor, fmt: MXFormat) -> torch.Tensor:
    """Exactly-representable float values -> uint8 bit patterns."""
    assert fmt.kind == "fp"
    v = values.to(torch.float32)
    s = (v < 0) | ((v == 0) & torch.signbit(v))
    a = torch.abs(v)
    e_raw = torch.frexp(torch.where(a > 0, a, torch.ones_like(a))).exponent
    expo = e_raw - 1                                  # floor(log2 a)
    is_sub = (expo < fmt.emin) | (a == 0)
    mant_n = torch.round((a * _exp2i(-expo) - 1.0) * (1 << fmt.mbits))
    e_field_n = expo + fmt.fp_bias
    mant_s = torch.round(a * _exp2i(torch.full_like(expo,
                                                    fmt.mbits - fmt.emin)))
    e_field = torch.where(is_sub, torch.zeros_like(e_field_n),
                          e_field_n).to(torch.int32)
    mant = torch.where(is_sub, mant_s, mant_n).to(torch.int32)
    code = (s.to(torch.int32) << (fmt.bits - 1)) | (e_field << fmt.mbits) \
        | mant
    return code.to(torch.uint8)


def _fp_decode_table(fmt: MXFormat) -> np.ndarray:
    """256-entry LUT: uint8 code -> float32 value (top bits ignored)."""
    assert fmt.kind == "fp"
    codes = np.arange(256, dtype=np.uint32) & ((1 << fmt.bits) - 1)
    s = (codes >> (fmt.bits - 1)) & 1
    e = (codes >> fmt.mbits) & ((1 << fmt.ebits) - 1)
    m = codes & ((1 << fmt.mbits) - 1)
    normal = e > 0
    mag = np.where(
        normal,
        (1.0 + m / (1 << fmt.mbits)) * np.exp2(e.astype(np.float64) - fmt.fp_bias),
        (m / (1 << fmt.mbits)) * np.exp2(float(fmt.emin)),
    )
    vals = np.where(s == 1, -mag, mag).astype(np.float32)
    # OCP E4M3: exponent-all-ones + mantissa-all-ones is NaN.
    if fmt.ebits == 4 and fmt.mbits == 3:
        nan_mask = (e == 15) & (m == 7)
        vals = np.where(nan_mask, np.nan, vals).astype(np.float32)
    return vals


@functools.lru_cache(maxsize=None)
def _fp_decode_lut(fmt: MXFormat, device: torch.device,
                   dtype) -> torch.Tensor:
    """The LUT on ``device``, made once: no host-to-device copy per call
    (which a CUDA graph could not capture)."""
    return torch.from_numpy(_fp_decode_table(fmt)).to(device=device,
                                                      dtype=dtype)


def decode_fp(codes: torch.Tensor, fmt: MXFormat,
              dtype=torch.float32) -> torch.Tensor:
    return _fp_decode_lut(fmt, codes.device, dtype)[codes.to(torch.int64)]


def decode_elements(codes: torch.Tensor, fmt: MXFormat,
                    dtype=torch.float32) -> torch.Tensor:
    if fmt.kind == "int":
        return codes.to(dtype)
    return decode_fp(codes, fmt, dtype=dtype)


# =============================================================================
# Block quantize / dequantize
# =============================================================================
def compute_scale_exp(v: torch.Tensor, fmt: MXFormat,
                      axis: int = -1) -> torch.Tensor:
    """shared_exp per block: floor(log2 max|V|) - emax(f), clipped to E8M0."""
    axis = axis % v.ndim
    vb = _to_blocks(v.to(torch.float32), fmt.block_size, axis)
    bmax = torch.amax(torch.abs(vb), dim=-1)
    exp = torch.where(
        bmax > 0, _floor_log2(torch.where(bmax > 0, bmax,
                                          torch.ones_like(bmax))),
        torch.full_like(bmax, SCALE_EXP_MIN + fmt.emax, dtype=torch.int32))
    exp = torch.clamp(exp - fmt.emax, SCALE_EXP_MIN, SCALE_EXP_MAX)
    return exp.to(torch.int8)


def quantize(v: torch.Tensor, fmt: MXFormat, axis: int = -1) -> MXTensor:
    """Direct MX quantization of a float tensor (paper Eqs. 1-3/5)."""
    axis = axis % v.ndim
    v32 = v.to(torch.float32)
    scale_exp = compute_scale_exp(v32, fmt, axis)
    vb = _to_blocks(v32, fmt.block_size, axis)
    y = vb * _exp2i(-scale_exp.to(torch.int32))[..., None]
    if fmt.kind == "int":
        codes_b = quantize_int_element(y, fmt)
    else:
        codes_b = encode_fp(quantize_fp_element_value(y, fmt), fmt)
    codes = _from_blocks(codes_b, axis).contiguous()
    return MXTensor(codes=codes, scale_exp=scale_exp, fmt=fmt, block_axis=axis)


def dequantize(t: MXTensor, dtype=torch.float32) -> torch.Tensor:
    """V̂_i = X * P_i."""
    vals_b = _to_blocks(decode_elements(t.codes, t.fmt, torch.float32),
                        t.fmt.block_size, t.block_axis)
    out = vals_b * _exp2i(t.scale_exp.to(torch.int32))[..., None]
    return _from_blocks(out, t.block_axis).to(dtype)


def quantize_dequantize(v: torch.Tensor, fmt: MXFormat, axis: int = -1,
                        dtype=None) -> torch.Tensor:
    """Fused fake-quant value: dequantize(quantize(v)) without codes, in
    ``dtype`` (default ``v.dtype``) — the plain version of B7."""
    axis = axis % v.ndim
    v32 = v.to(torch.float32)
    scale_exp = compute_scale_exp(v32, fmt, axis).to(torch.int32)
    vb = _to_blocks(v32, fmt.block_size, axis)
    y = vb * _exp2i(-scale_exp)[..., None]
    if fmt.kind == "int":
        q = torch.clamp(torch.round(y), -fmt.int_maxq, fmt.int_maxq)
    else:
        q = quantize_fp_element_value(y, fmt)
    out = _from_blocks(q * _exp2i(scale_exp)[..., None], axis)
    return out.to(dtype if dtype is not None else v.dtype)
