"""Hopper dequant-fused GEMMs over packed MX weights: build, bind, launch.

Replaces ``repro/kernels/mx_matmul.py`` (``mx_matmul_pallas`` and
``mx_matmul_int4_pallas``) with the CUDA C++ kernels in
``csrc/mx_matmul.cu``, compiled with ``nvcc`` for ``sm_90a`` into the
port's one kernel library (``kernels/build.py``) and loaded with
``ctypes``. The build runs at the first launch of any kernel of the port.

The wrappers take a weight in its serving layout — codes (K, N) int8/uint8
or split-N packed (K, N/2) uint8, scales (N, K/bs) int8 — and copy nothing
weight-sized: the kernel reads the leaf's own buffers, masks ragged M/N
edges itself and reads ``x`` as bf16 or f32 (other dtypes are converted to
an activation-sized f32 copy). On a CUDA tensor a wrapper launches its
kernel or raises; on a CPU tensor it computes the plain version from
``kernels/ref.py``. ``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.core.formats import MXFormat
from repro_torch.kernels import build as _build
from repro_torch.kernels import ref

SOURCE = _build.CSRC / "mx_matmul.cu"

# Kernel launches per wrapper (B1 = mx_matmul, B2 = mx_matmul_int4).
launches: Dict[str, int] = {"mx_matmul": 0, "mx_matmul_int4": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build() -> ctypes.CDLL:
    """Build (once) the port's kernel library and bind B1/B2."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mx_matmul_launch.argtypes = [ptr, i32, ptr, ptr, ptr, i32, i32, i32,
                                     i32, i32, i32, i32, i32, i32, i32, i32,
                                     ptr]
    lib.mx_matmul_launch.restype = i32
    lib.mx_matmul_int4_launch.argtypes = [ptr, i32, ptr, ptr, ptr, i32, i32,
                                          i32, i32, i32, ptr]
    lib.mx_matmul_int4_launch.restype = i32
    _lib = lib
    return lib


def _check(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
           k: int, n: int, fmt: MXFormat, codes_cols: int) -> None:
    if x.ndim != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (M, {k}), got {tuple(x.shape)}")
    if tuple(codes.shape) != (k, codes_cols):
        raise ValueError(f"codes must be ({k}, {codes_cols}), got "
                         f"{tuple(codes.shape)}")
    if k % fmt.block_size:
        raise ValueError(f"K={k} is not a multiple of block size "
                         f"{fmt.block_size}")
    if x.is_cuda and fmt.block_size % 8:
        raise ValueError(f"the kernels walk K-blocks 8 rows at a time; block "
                         f"size {fmt.block_size} is not a multiple of 8")
    if tuple(scales.shape) != (n, k // fmt.block_size) \
            or scales.dtype != torch.int8:
        raise ValueError(f"scales must be int8 ({n}, {k // fmt.block_size}) "
                         f"(serving layout), got {scales.dtype} "
                         f"{tuple(scales.shape)}")
    if codes.dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"codes must be int8/uint8, got {codes.dtype}")
    devs = {x.device, codes.device, scales.device}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {devs}")
    if x.is_cuda and not (codes.is_contiguous() and scales.is_contiguous()):
        raise ValueError("codes and scales must be contiguous")


def _launch_args(x: torch.Tensor, n: int):
    """(x as the kernel reads it, its bf16 flag, output, stream)."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        x = x.to(torch.float32)
    x = x.contiguous()
    y = torch.empty((x.shape[0], n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return x, int(x.dtype == torch.bfloat16), y, ctypes.c_void_p(stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def mx_matmul(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
              fmt: MXFormat) -> torch.Tensor:
    """B1: x (M, K) @ dequant(codes (K, N), scales (N, K/bs)) -> (M, N) f32."""
    k, n = codes.shape
    _check(x, codes, scales, k, n, fmt, n)
    if not x.is_cuda:
        return ref.ref_mx_matmul(x, codes, scales, fmt)
    lib = build()
    xk, bf16, y, stream = _launch_args(x, n)
    fp = fmt.kind == "fp"
    vec = int(n % 4 == 0 and codes.data_ptr() % 4 == 0)
    with torch.cuda.device(x.device):
        rc = lib.mx_matmul_launch(
            xk.data_ptr(), bf16, codes.data_ptr(), scales.data_ptr(),
            y.data_ptr(), x.shape[0], k, n, int(fp), fmt.bits, fmt.ebits,
            fmt.mbits, fmt.fp_bias if fp else 0, fmt.emin if fp else 0,
            fmt.block_size, vec, stream)
    _raise_on(rc, "mx_matmul")
    launches["mx_matmul"] += 1
    return y


def mx_matmul_int4(x: torch.Tensor, packed: torch.Tensor,
                   scales: torch.Tensor, fmt: MXFormat) -> torch.Tensor:
    """B2: x (M, K) @ dequant(split-N int4 (K, N/2), scales (N, K/bs))."""
    if fmt.kind != "int" or fmt.bits != 4:
        raise ValueError(f"mx_matmul_int4 serves mxint4, got {fmt.name}")
    if packed.dtype != torch.uint8:
        raise ValueError(f"packed must be uint8, got {packed.dtype}")
    k, half = packed.shape
    n = 2 * half
    _check(x, packed, scales, k, n, fmt, half)
    if not x.is_cuda:
        return ref.ref_mx_matmul_int4(x, packed, scales, fmt)
    lib = build()
    xk, bf16, y, stream = _launch_args(x, n)
    vec = int(half % 4 == 0 and packed.data_ptr() % 4 == 0)
    with torch.cuda.device(x.device):
        rc = lib.mx_matmul_int4_launch(
            xk.data_ptr(), bf16, packed.data_ptr(), scales.data_ptr(),
            y.data_ptr(), x.shape[0], k, n, fmt.block_size, vec, stream)
    _raise_on(rc, "mx_matmul_int4")
    launches["mx_matmul_int4"] += 1
    return y
