"""B6 on the card: bind and launch ``csrc/mx_quantize.cu``.

Replaces ``repro/kernels/mx_quantize.py::mx_quantize_pallas``. ``launch``
takes a contiguous f32/bf16 tensor viewed as (outer, K, inner), blocks of
``fmt.block_size`` along K, and the outputs its caller allocated: codes of
the input's shape and scales (outer, inner, K/bs). The public wrapper —
any shape and block axis, the plain version on the CPU — is
``kernels/ops.py::mx_quantize``. ``launches`` counts kernel launches and
nothing else; a tensor that holds no data launches shape-only
(``kernels/common.py``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.core.formats import MXFormat
from repro_torch.kernels import build as _build
from repro_torch.kernels.common import (QUANT_OPS_PER_ELEMENT, MxFmt, mx_fmt,
                                        nbytes, raise_on, record_shape_only,
                                        shape_only, stream_of)

SOURCE = _build.CSRC / "mx_quantize.cu"

launches: Dict[str, int] = {"mx_quantize": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    launches["mx_quantize"] = 0


def build() -> ctypes.CDLL:
    """Build (once) the port's kernel library and bind B6."""
    global _lib
    if _lib is None:
        lib = _build.library()
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mx_quantize_launch.argtypes = [ptr, i32, ptr, ptr, i64, i32, i64,
                                           i32, MxFmt, ptr]
        lib.mx_quantize_launch.restype = i32
        _lib = lib
    return _lib


def launch(v: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
           fmt: MXFormat, outer: int, k: int, inner: int) -> None:
    if shape_only(v):
        record_shape_only("mx_quantize", QUANT_OPS_PER_ELEMENT * v.numel(),
                          nbytes(v), nbytes(codes) + nbytes(scales))
        return
    lib = build()
    with torch.cuda.device(v.device):
        rc = lib.mx_quantize_launch(
            v.data_ptr(), int(v.dtype == torch.bfloat16), codes.data_ptr(),
            scales.data_ptr(), outer, k, inner, fmt.block_size, mx_fmt(fmt),
            stream_of(v))
    raise_on(rc, "mx_quantize")
    launches["mx_quantize"] += 1
