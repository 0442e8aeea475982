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
``kernels/ref.py``. ``launches`` counts kernel launches and nothing else; a
tensor that holds no data takes the card branch and launches shape-only
(``kernels/common.py``: 2·M·K·N operations, x, codes and scales read, y
written).

Two kernel bodies, chosen by M alone: up to ``DECODE_MAX_M`` rows (the
decode batch) the decode body streams the weight split over K across a
thread-block cluster, cut as ``decode_plan`` says; above it (prefill
buckets, the mixed tick) the tiled body dequantizes code tiles into shared
memory and multiplies on the tensor cores (wgmma), its K split over a
cluster as ``tiled_plan`` says. Both plans read shapes alone, so every call
can be captured in a CUDA graph.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.formats import MXFormat
from repro_torch.kernels import build as _build
from repro_torch.kernels import ref
from repro_torch.kernels.common import (nbytes, on_card, raise_on,
                                        record_shape_only, shape_only,
                                        stream_of)

SOURCE = _build.CSRC / "mx_matmul.cu"

# Kernel launches per wrapper (B1 = mx_matmul, B2 = mx_matmul_int4).
launches: Dict[str, int] = {"mx_matmul": 0, "mx_matmul_int4": 0}

_lib: Optional[ctypes.CDLL] = None

DECODE_MAX_M = 4         # the decode body serves M <= 4 (PERF.md: the
#                          bodies cross between M = 4 and 8 for B1)
DECODE_MIN_BLOCKS = 264  # two blocks for each of the H100's 132 SMs
DECODE_MAX_BLOCKS = 512  # within the four blocks per SM that fit at once
SMS = 132                # the H100's streaming multiprocessors
TILED_BN = 64            # output columns per tiled block
# The tiled plan, chosen from a card sweep of every qwen3-4b shape:
# cluster ranks of at most this many K rows, and at least this many blocks
# (where K allows; 64-row M-tiles run three blocks per SM, 128-row two).
TILED_RANK_ROWS = 1280
TILED_MIN_BLOCKS = 192


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """The decode body's grid: ``cluster`` blocks split K over each strip
    of ``strip`` code bytes per row (both nibble ranges of them at int4),
    ``m_tiles`` tiles of x rows (4 at M <= 4 and at int4, else 8)."""
    strip: int
    cluster: int
    strips: int
    m_tiles: int

    @property
    def blocks(self) -> int:
        return self.cluster * self.strips * self.m_tiles


def decode_plan(m: int, k: int, n: int, block_size: int,
                int4: bool = False) -> DecodePlan:
    """Shapes -> grid of the decode body. From the widest strip down (128
    bytes, 64 at int4: narrower strips give a block more rows in parallel),
    the cluster takes as many K ranges as keep the grid within four blocks
    per SM (``DECODE_MAX_BLOCKS``), at most 8 (the portable size) and one
    K-block each; the first strip whose grid reaches ``DECODE_MIN_BLOCKS``
    wins. Where even 16-byte strips fall short, the cluster grows to 16 (a
    size Hopper allows beyond the portable one)."""
    width = n // 2 if int4 else n
    nkb = k // block_size
    m_tile = 4 if m <= 4 or int4 else 8
    strip = 64 if int4 else 128
    while True:
        strips = -(-width // strip)
        cluster = max(1, min(8, nkb, DECODE_MAX_BLOCKS // strips))
        if strips * cluster >= DECODE_MIN_BLOCKS or strip == 16:
            break
        strip //= 2
    if strips * cluster < DECODE_MIN_BLOCKS and nkb >= 16:
        cluster = 16
    return DecodePlan(strip, cluster, strips, -(-m // m_tile))


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    """The tiled body's grid: ``m_tiles`` x ``n_tiles`` output tiles of
    ``bm`` x ``TILED_BN`` (split-N int4: ``TILED_BN / 2`` packed columns,
    both nibble ranges of them), each reduced over a cluster of
    ``cluster`` blocks that split the ``k_blocks`` K-blocks as
    ``k_ranges`` says."""
    bm: int
    cluster: int
    m_tiles: int
    n_tiles: int
    k_blocks: int

    @property
    def blocks(self) -> int:
        return self.cluster * self.m_tiles * self.n_tiles

    def k_ranges(self):
        """[kb_lo, kb_hi) of each rank, as the kernel computes them."""
        cs, nkb = self.cluster, self.k_blocks
        return [(r * nkb // cs, (r + 1) * nkb // cs) for r in range(cs)]


def tiled_plan(m: int, k: int, n: int, block_size: int,
               int4: bool = False) -> TiledPlan:
    """Shapes -> grid of the tiled body. 64-row M-tiles up to M = 64, else
    128. The cluster (at most 16 ranks of at least one K-block) is the
    smallest whose ranks walk at most ``TILED_RANK_ROWS`` rows and whose
    grid has ``TILED_MIN_BLOCKS`` blocks, where K allows."""
    bm = 64 if m <= 64 else 128
    m_tiles = -(-m // bm)
    n_tiles = -(-n // TILED_BN)      # int4: n / 2 bytes in 32-byte strips
    nkb = k // block_size
    top = max(1, min(16, nkb))
    cs = min(top, max(1, -(-k // TILED_RANK_ROWS)))
    while m_tiles * n_tiles * cs < TILED_MIN_BLOCKS and cs < top:
        cs += 1
    return TiledPlan(bm, cs, m_tiles, n_tiles, nkb)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def snapshot() -> Dict[str, int]:
    """The launch counts as they stand; the difference of two snapshots is
    what ``credit`` takes (``serve/tick_graph.py`` credits a CUDA graph's
    launches at each replay, where no wrapper runs)."""
    return dict(launches)


def credit(delta: Dict[str, int]) -> None:
    for k, v in delta.items():
        launches[k] += v


def build() -> ctypes.CDLL:
    """Build (once) the port's kernel library and bind B1/B2."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mx_matmul_tiled_launch.argtypes = [ptr, i32, ptr, ptr, ptr, i32,
                                           i32, i32, i32, i32, i32, i32,
                                           i32, i32, i32, i32, i32, i32, ptr]
    lib.mx_matmul_tiled_launch.restype = i32
    lib.mx_matmul_decode_launch.argtypes = [ptr, i32, ptr, ptr, ptr, i32,
                                            i32, i32, i32, i32, i32, i32,
                                            i32, i32, i32, i32, i32, i32,
                                            ptr]
    lib.mx_matmul_decode_launch.restype = i32
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
    if on_card(x) and fmt.block_size % 8:
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
    if on_card(x) and not (codes.is_contiguous()
                           and scales.is_contiguous()):
        raise ValueError("codes and scales must be contiguous")


def _launch_args(x: torch.Tensor, n: int):
    """(x as the kernel reads it, its bf16 flag, output)."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        x = x.to(torch.float32)
    x = x.contiguous()
    y = torch.empty((x.shape[0], n), dtype=torch.float32, device=x.device)
    return x, int(x.dtype == torch.bfloat16), y


def _launch(name: str, x: torch.Tensor, codes: torch.Tensor,
            scales: torch.Tensor, n: int, mode: int, fmt: MXFormat,
            body: Optional[str]) -> torch.Tensor:
    """Launch B1 (mode 0 int, 1 fp) or B2 (mode 2) on the card: the decode
    body up to DECODE_MAX_M rows, the tiled body above (``body`` forces
    one, to measure where they cross); returns y. On a tensor that holds
    no data, a shape-only launch."""
    xk, bf16, y = _launch_args(x, n)
    m, k = xk.shape
    if shape_only(x):
        record_shape_only(name, 2 * m * k * n,
                          nbytes(xk) + nbytes(codes) + nbytes(scales),
                          nbytes(y))
        return y
    lib = build()
    int4 = mode == 2
    fp = mode == 1
    width = n // 2 if int4 else n
    vec = int(width % 16 == 0 and codes.data_ptr() % 16 == 0) \
        | int(xk.data_ptr() % 16 == 0 and k * xk.element_size() % 16 == 0) << 1
    body = body or ("decode" if m <= DECODE_MAX_M else "tiled")
    fmt_args = (mode, fmt.bits, fmt.ebits, fmt.mbits,
                fmt.fp_bias if fp else 0, fmt.emin if fp else 0,
                fmt.block_size)
    with torch.cuda.device(x.device):
        if body == "decode":
            plan = decode_plan(m, k, n, fmt.block_size, int4)
            rc = lib.mx_matmul_decode_launch(
                xk.data_ptr(), bf16, codes.data_ptr(), scales.data_ptr(),
                y.data_ptr(), m, k, n, *fmt_args, plan.strip, plan.cluster,
                vec, stream_of(x))
        elif body == "tiled":
            plan = tiled_plan(m, k, n, fmt.block_size, int4)
            rc = lib.mx_matmul_tiled_launch(
                xk.data_ptr(), bf16, codes.data_ptr(), scales.data_ptr(),
                y.data_ptr(), m, k, n, *fmt_args, plan.bm, plan.cluster, vec,
                stream_of(x))
        else:
            raise ValueError(f"unknown body {body!r}")
    raise_on(rc, name)
    launches[name] += 1
    return y


def mx_matmul(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
              fmt: MXFormat, body: Optional[str] = None) -> torch.Tensor:
    """B1: x (M, K) @ dequant(codes (K, N), scales (N, K/bs)) -> (M, N) f32.
    ``body`` ("decode" / "tiled") overrides the choice by M on the card."""
    k, n = codes.shape
    _check(x, codes, scales, k, n, fmt, n)
    if not on_card(x):
        return ref.ref_mx_matmul(x, codes, scales, fmt)
    return _launch("mx_matmul", x, codes, scales, n,
                   int(fmt.kind == "fp"), fmt, body)


def mx_matmul_int4(x: torch.Tensor, packed: torch.Tensor,
                   scales: torch.Tensor, fmt: MXFormat,
                   body: Optional[str] = None) -> torch.Tensor:
    """B2: x (M, K) @ dequant(split-N int4 (K, N/2), scales (N, K/bs)).
    ``body`` ("decode" / "tiled") overrides the choice by M on the card."""
    if fmt.kind != "int" or fmt.bits != 4:
        raise ValueError(f"mx_matmul_int4 serves mxint4, got {fmt.name}")
    if packed.dtype != torch.uint8:
        raise ValueError(f"packed must be uint8, got {packed.dtype}")
    k, half = packed.shape
    n = 2 * half
    _check(x, packed, scales, k, n, fmt, half)
    if not on_card(x):
        return ref.ref_mx_matmul_int4(x, packed, scales, fmt)
    return _launch("mx_matmul_int4", x, packed, scales, n, 2, fmt, body)
