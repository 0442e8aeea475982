"""Shared numerics of the MX dequant-GEMM kernels, as plain PyTorch, and
what every ctypes launch of the port's kernels shares.

Counterpart of ``repro/kernels/common.py``. ``csrc/mx_matmul.cu`` implements
the same two functions per element (``pow2i``, ``decode_fp``); these are
what the kernels' plain versions in ``ref.py`` use. ``MxFmt`` is the format
struct the quantize, fake-quant and Slice-and-Scale kernels take by value
(``csrc/mx_numerics.cuh``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.formats import MXFormat


class MxFmt(ctypes.Structure):
    """``struct MxFmt`` of ``csrc/mx_numerics.cuh``, field for field."""

    _fields_ = [("fp", ctypes.c_int), ("bits", ctypes.c_int),
                ("ebits", ctypes.c_int), ("mbits", ctypes.c_int),
                ("bias", ctypes.c_int), ("emin", ctypes.c_int),
                ("emax", ctypes.c_int), ("maxq", ctypes.c_int),
                ("fp_max", ctypes.c_float)]


def mx_fmt(fmt: MXFormat) -> MxFmt:
    fp = fmt.kind == "fp"
    return MxFmt(int(fp), fmt.bits, fmt.ebits, fmt.mbits,
                 fmt.fp_bias if fp else 0, fmt.emin if fp else 0, fmt.emax,
                 0 if fp else fmt.int_maxq, fmt.fp_max if fp else 0.0)


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s card, as a ctypes pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on(rc: int, name: str) -> None:
    """Raise on the CUDA error code a C launch function returned."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def pow2i(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e for integer e, clamped to [-126, 127], from f32 exponent
    bits. e < -126 saturates to 2^-126; MX scale exponents of -127 only
    occur for all-zero blocks, whose elements are 0 anyway."""
    e = torch.clamp(e.to(torch.int32), -126, 127)
    return ((e + 127) << 23).view(torch.float32)


def decode_fp_arith(codes: torch.Tensor, fmt: MXFormat) -> torch.Tensor:
    """MXFP uint8 bit patterns -> f32 values (arithmetic, no LUT).

    The E4M3 pattern 0x7F / 0xFF decodes to ±480 here (the LUT in
    ``core/mx.py`` says NaN); quantizers never produce it.
    """
    c = codes.to(torch.int32)
    s = (c >> (fmt.bits - 1)) & 1
    e = (c >> fmt.mbits) & ((1 << fmt.ebits) - 1)
    mf = (c & ((1 << fmt.mbits) - 1)).to(torch.float32) * (2.0 ** -fmt.mbits)
    mag = torch.where(e > 0, (1.0 + mf) * pow2i(e - fmt.fp_bias),
                      mf * (2.0 ** fmt.emin))
    return torch.where(s == 1, -mag, mag)
