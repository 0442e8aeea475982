"""Shared numerics of the MX dequant-GEMM kernels, as plain PyTorch.

Counterpart of ``repro/kernels/common.py``. ``csrc/mx_matmul.cu`` implements
the same two functions per element (``pow2i``, ``decode_fp``); these are
what the kernels' plain versions in ``ref.py`` use.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import MXFormat


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
