"""Slice-and-Scale format conversion (paper §3.3 / §3.4), bit-exact with
``repro/core/slice_scale.py``.

  SSMXINT (Eq. 4):  P_l = clip_{b_l}(round(P_h / 2^Δe)),  X_l = X_h · 2^Δe
                    — an arithmetic right shift with round-to-nearest-even on
                    int32 lanes.
  SSMXFP  (Eq. 6):  P_l = quantize_{η_l,μ_l}(P_h / 2^Δe),  X_l = X_h · 2^Δe
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import (MXFormat, SCALE_EXP_MAX, SCALE_EXP_MIN,
                                      delta_e)
from repro_torch.core.mx import (MXTensor, decode_fp, encode_fp,
                                 quantize_fp_element_value)


def _rshift_rne(p: torch.Tensor, de: int) -> torch.Tensor:
    """Integer right shift by `de` with round-to-nearest-even (int32 math)."""
    if de == 0:
        return p
    q = p >> de                      # floor division (two's complement)
    r = p - (q << de)                # remainder in [0, 2^de)
    half = 1 << (de - 1)
    round_up = (r > half) | ((r == half) & ((q & 1) == 1))
    return q + round_up.to(p.dtype)


def _bump_scale(scale_exp: torch.Tensor, de: int) -> torch.Tensor:
    return torch.clamp(scale_exp.to(torch.int32) + de, SCALE_EXP_MIN,
                       SCALE_EXP_MAX).to(torch.int8)


def ss_mxint(t: MXTensor, low: MXFormat) -> MXTensor:
    """SSMXINT: right-shift-and-round on integer codes + scale bump."""
    assert t.fmt.kind == "int" and low.kind == "int"
    if low.block_size != t.fmt.block_size:
        raise ValueError("slice-and-scale preserves block size")
    de = delta_e(t.fmt, low)
    q = _rshift_rne(t.codes.to(torch.int32), de)
    q = torch.clamp(q, -low.int_maxq, low.int_maxq).to(torch.int8)
    return MXTensor(codes=q, scale_exp=_bump_scale(t.scale_exp, de), fmt=low,
                    block_axis=t.block_axis)


def ss_mxfp(t: MXTensor, low: MXFormat) -> MXTensor:
    """SSMXFP: explicit divide + requantize of element values + scale bump."""
    assert t.fmt.kind == "fp" and low.kind == "fp"
    if low.block_size != t.fmt.block_size:
        raise ValueError("slice-and-scale preserves block size")
    de = delta_e(t.fmt, low)
    y = decode_fp(t.codes, t.fmt, torch.float32) * (2.0 ** -de)
    codes = encode_fp(quantize_fp_element_value(y, low), low)
    return MXTensor(codes=codes, scale_exp=_bump_scale(t.scale_exp, de),
                    fmt=low, block_axis=t.block_axis)


def slice_and_scale(t: MXTensor, low: MXFormat) -> MXTensor:
    """Dispatch SSMXINT / SSMXFP; identity if formats match."""
    if low.name == t.fmt.name and low.block_size == t.fmt.block_size:
        return t
    if t.fmt.kind != low.kind:
        raise ValueError(
            f"cannot slice-and-scale across kinds ({t.fmt.name} -> {low.name})")
    if t.fmt.kind == "int":
        return ss_mxint(t, low)
    return ss_mxfp(t, low)


def ss_quantize_dequantize(t: MXTensor, low: MXFormat, dtype=torch.float32):
    """dequantize(slice_and_scale(t, low)) — runtime target weights W_t."""
    from repro_torch.core.mx import dequantize
    return dequantize(slice_and_scale(t, low), dtype=dtype)
