"""B7 on the card: bind and launch ``csrc/fake_quant.cu``.

Replaces ``repro/kernels/fake_quant.py::fake_quant_pallas``. ``launch``
takes a contiguous f32/bf16 tensor viewed as (outer, K, inner), blocks of
``fmt.block_size`` along K, and an output of its shape (f32 or bf16) that
its caller allocated; ``ste`` adds the straight-through epilogue
``v + (w_q - v)``. The public wrapper — any shape and block axis, the plain
version on the CPU — is ``kernels/ops.py::fake_quant``. ``launches`` counts
kernel launches and nothing else; a tensor that holds no data launches
shape-only (``kernels/common.py``).
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

SOURCE = _build.CSRC / "fake_quant.cu"

launches: Dict[str, int] = {"fake_quant": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    launches["fake_quant"] = 0


def build() -> ctypes.CDLL:
    """Build (once) the port's kernel library and bind B7."""
    global _lib
    if _lib is None:
        lib = _build.library()
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fake_quant_launch.argtypes = [ptr, i32, ptr, i32, i64, i32, i64,
                                          i32, i32, MxFmt, ptr]
        lib.fake_quant_launch.restype = i32
        _lib = lib
    return _lib


def launch(v: torch.Tensor, out: torch.Tensor, fmt: MXFormat, outer: int,
           k: int, inner: int, ste: bool) -> None:
    if shape_only(v):
        record_shape_only("fake_quant", QUANT_OPS_PER_ELEMENT * v.numel(),
                          nbytes(v), nbytes(out))
        return
    lib = build()
    with torch.cuda.device(v.device):
        rc = lib.fake_quant_launch(
            v.data_ptr(), int(v.dtype == torch.bfloat16), out.data_ptr(),
            int(out.dtype == torch.bfloat16), outer, k, inner,
            fmt.block_size, int(ste), mx_fmt(fmt), stream_of(v))
    raise_on(rc, "fake_quant")
    launches["fake_quant"] += 1
