"""B5 on the card: bind and launch ``csrc/ss_convert.cu``.

Replaces ``repro/kernels/ss_convert.py::ss_convert_pallas``. Slice-and-Scale
is elementwise on codes and on scales, so ``launch`` takes both as flat
contiguous byte buffers in whatever layout they have, and outputs that its
caller allocated: codes of the same size, or, with ``half`` > 0, split-N
nibble bytes — rows of ``2 * half`` codes written as rows of ``half`` bytes
(a 4-bit MXINT target). The public wrappers — the plain versions on the CPU
— are ``kernels/ops.py::ss_convert`` and ``ss_convert_int4_splitn``.
``launches`` counts kernel launches (either mode) and nothing else; a tensor
that holds no data launches shape-only (``kernels/common.py``: no
operations, a code is a table lookup).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.core.formats import MXFormat, delta_e
from repro_torch.kernels import build as _build
from repro_torch.kernels.common import (MxFmt, mx_fmt, nbytes, raise_on,
                                        record_shape_only, shape_only,
                                        stream_of)

SOURCE = _build.CSRC / "ss_convert.cu"

launches: Dict[str, int] = {"ss_convert": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    launches["ss_convert"] = 0


def build() -> ctypes.CDLL:
    """Build (once) the port's kernel library and bind B5."""
    global _lib
    if _lib is None:
        lib = _build.library()
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ss_convert_launch.argtypes = [ptr, ptr, i64, i64, ptr, ptr, i64,
                                          i32, MxFmt, MxFmt, ptr]
        lib.ss_convert_launch.restype = i32
        _lib = lib
    return _lib


def launch(codes: torch.Tensor, scales: torch.Tensor,
           out_codes: torch.Tensor, out_scales: torch.Tensor,
           high: MXFormat, low: MXFormat, half: int = 0) -> None:
    if shape_only(codes):
        record_shape_only("ss_convert", 0, nbytes(codes) + nbytes(scales),
                          nbytes(out_codes) + nbytes(out_scales))
        return
    lib = build()
    with torch.cuda.device(codes.device):
        rc = lib.ss_convert_launch(
            codes.data_ptr(), out_codes.data_ptr(), codes.numel(), half,
            scales.data_ptr(), out_scales.data_ptr(), scales.numel(),
            delta_e(high, low), mx_fmt(high), mx_fmt(low), stream_of(codes))
    raise_on(rc, "ss_convert")
    launches["ss_convert"] += 1
