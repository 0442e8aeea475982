"""Plain MX arithmetic for the reference: MXINT quantization of a float32
weight in blocks of 32 along its contraction axis, Slice-and-Scale to a
narrower MXINT format, and dequantization.

Written from the MX definitions (OCP MX v1.0; the MF-QAT paper's Eqs. 1-4),
not from the program: a block's shared exponent is floor(log2 max|v|) minus
the element format's emax (b - 2 for MXINT-b), clipped to E8M0's
[-127, 127]; an element is round-half-to-even of v / 2^exp, clipped to
+-(2^(b-1) - 1). Slice-and-Scale from b_h to b_l bits shifts each code right
by de = b_h - b_l with round-half-to-even, clips to the narrower range, and
adds de to the exponent.
"""
from __future__ import annotations

import torch

SCALE_MIN, SCALE_MAX = -127, 127


def int_bits(fmt: str) -> int:
    if not fmt.startswith("mxint"):
        raise ValueError(f"the reference knows MXINT formats only, got {fmt!r}")
    return int(fmt[len("mxint"):])


def _pow2(e: torch.Tensor) -> torch.Tensor:
    return torch.pow(2.0, e.to(torch.float64)).to(torch.float32)


def quantize(w: torch.Tensor, bits: int, block: int = 32):
    """w (..., K, N) float32 -> (codes (..., K/bs, bs, N) int32, exp
    (..., K/bs, 1, N) int32), blocks along K."""
    *lead, k, n = w.shape
    wb = w.to(torch.float32).reshape(*lead, k // block, block, n)
    amax = wb.abs().amax(dim=-2, keepdim=True)
    safe = torch.where(amax > 0, amax, torch.ones_like(amax))
    e = torch.floor(torch.log2(safe)).to(torch.int32)
    # log2 of a float32 can round up just below a power of two: correct it
    e = torch.where(_pow2(e) > safe, e - 1, e)
    e = torch.where(_pow2(e + 1) <= safe, e + 1, e)
    e = torch.where(amax > 0, e, torch.full_like(e, SCALE_MIN + bits - 2))
    e = torch.clamp(e - (bits - 2), SCALE_MIN, SCALE_MAX)
    maxq = 2 ** (bits - 1) - 1
    codes = torch.clamp(torch.round(wb / _pow2(e)), -maxq, maxq)
    return codes.to(torch.int32), e


def slice_and_scale(codes: torch.Tensor, e: torch.Tensor, bits_hi: int,
                    bits_lo: int):
    de = bits_hi - bits_lo
    if de < 0:
        raise ValueError("Slice-and-Scale only narrows")
    if de == 0:
        return codes, e
    q = torch.div(codes, 2 ** de, rounding_mode="floor")
    r = codes - q * 2 ** de
    half = 2 ** (de - 1)
    q = q + ((r > half) | ((r == half) & (q % 2 == 1))).to(q.dtype)
    maxq = 2 ** (bits_lo - 1) - 1
    return torch.clamp(q, -maxq, maxq), torch.clamp(e + de, SCALE_MIN,
                                                    SCALE_MAX)


def dequantize(codes: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    out = codes.to(torch.float32) * _pow2(e)
    *lead, kb, bs, n = out.shape
    return out.reshape(*lead, kb * bs, n)


def served_weight(w: torch.Tensor, anchor: str, served: str,
                  block: int = 32) -> torch.Tensor:
    """The float32 value of w once quantized to the anchor format and
    Slice-and-Scaled to the served one."""
    hi, lo = int_bits(anchor), int_bits(served)
    codes, e = quantize(w, hi, block)
    return dequantize(*slice_and_scale(codes, e, hi, lo))
