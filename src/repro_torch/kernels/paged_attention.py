"""Paged attention read straight off the KV page pools: bind, launch, dispatch.

Replaces ``repro/kernels/paged_attention.py`` (``paged_attention_pallas``,
B3, and ``paged_attention_pallas_mq``, B4) with the CUDA C++ kernels in
``csrc/paged_attention.cu``, built into the port's one kernel library
(``kernels/build.py``). The wrappers take one layer's pools (P, ps, Hkv, D)
where they lie — a layer's pool is the view ``pool[g]`` of the stacked
(G, P, ps, Hkv, D) tensor, read at its data pointer with no copy — the
block table (B, max_pages) int32 and the per-row lengths, and return f32.
On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor it
computes the plain version from ``kernels/ref.py``. ``launches`` counts
kernel launches and nothing else.

Dispatch (``paged_decode_attention`` / ``paged_mixed_attention``, the entry
points ``models/layers.py`` routes through):

  mode "kernel"  B3 / B4 above. ``attn_impl="paged_kernel"``.
  mode "gather"  materialise each row's logical view (``paged_gather``) and
                 run the masked softmax of ``decode_attention`` /
                 ``mixed_attention``. ``attn_impl="gather"``: a separate
                 contract that only a caller who asks for it gets, never a
                 fallback.

``pages_read`` / ``pages_read_mq`` are the host-side mirror of the kernels'
clamped walk; the engine's attention-read accounting uses them.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref

SOURCE = _build.CSRC / "paged_attention.cu"
MODES = ("kernel", "gather")
# A block holds its (rows x D) accumulator in registers as 4 x 4 tiles,
# two per thread: B3 runs 128 threads, B4 256.
B3_TILES, B4_TILES = 2 * 128, 2 * 256
MAX_SMEM = 232448        # bytes of shared memory a block may opt into
B4_MAX_TQ = 16           # query lanes per B4 block

# Kernel launches per wrapper (B3 = paged_attention, B4 = paged_attention_mq).
launches: Dict[str, int] = {"paged_attention": 0, "paged_attention_mq": 0}

_stats: Dict[str, int] = {"kernel": 0, "gather": 0,
                          "kernel_mq": 0, "gather_mq": 0}
_lib: Optional[ctypes.CDLL] = None


def stats() -> Dict[str, int]:
    """Host-side counts of which paged-attention path each call took."""
    return dict(_stats)


def reset_stats() -> None:
    for k in _stats:
        _stats[k] = 0


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def pages_read(length: int, page_size: int,
               window: Optional[int] = None) -> int:
    """Distinct pages one slot's block-table walk covers for ``length`` live
    tokens — the host-side mirror of the kernels' clamped walk (the engine's
    attention-read accounting must use this, never reimplement it, so the
    metric stays consistent with the kernel). Zero-length rows still count
    the clamped page 0 once."""
    pages = max(-(-length // page_size), 1)
    if window is not None:
        pages -= min(max((length - window) // page_size, 0), pages - 1)
    return pages


def pages_read_mq(q_offset: int, q_len: int, page_size: int,
                  window: Optional[int] = None) -> int:
    """Distinct pages the multi-query walk covers for one row whose ``q_len``
    queries sit at positions ``q_offset .. q_offset + q_len - 1`` — the
    union of its q blocks' clamped walks. The highest query attends up to
    ``q_offset + q_len`` positions; the lowest query's window lower-bounds
    the walk. ``q_len == 1`` collapses to ``pages_read(q_offset + 1, ...)``
    — decode rows in a mixed batch cost exactly what they cost in the
    single-query kernel."""
    last = max(-(-(q_offset + q_len) // page_size) - 1, 0)
    first = 0
    if window is not None:
        first = min(max((q_offset + 1 - window) // page_size, 0), last)
    return last - first + 1


def build() -> ctypes.CDLL:
    """Build (once) the port's kernel library and bind B3/B4."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.library()
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_attention_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, f32,
        i32, i32, ptr]
    lib.paged_attention_launch.restype = i32
    lib.paged_attention_mq_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
        i32, i32, f32, i32, i32, ptr]
    lib.paged_attention_mq_launch.restype = i32
    _lib = lib
    return lib


def _tiles(rows: int, d: int) -> int:
    return -(-rows // 4) * (d // 4)


def b4_lanes(c: int, h: int, hkv: int, d: int) -> int:
    """Query lanes per B4 block: at most 16, and few enough that the
    block's (lanes x G) x D accumulator fits its registers."""
    tq = min(B4_MAX_TQ, c)
    while tq > 1 and _tiles(tq * (h // hkv), d) > B4_TILES:
        tq -= 1
    return tq


def _smem_bytes(rows: int, ps: int, d: int) -> int:
    return 4 * (rows * (d + 4) + 2 * ps * (d + 4) + rows * ps + 3 * rows)


def _check(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
           block_table: torch.Tensor, lens) -> None:
    """Shapes, devices and, for the kernels, dtypes and contiguity."""
    h, d = q.shape[-2:]
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"pools must both be (P, ps, Hkv, D), got "
                         f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    _, ps, hkv, dk = k_pages.shape
    if dk != d or h % hkv:
        raise ValueError(f"q heads/dim ({h}, {d}) do not fit pools with "
                         f"Hkv={hkv}, D={dk}")
    if block_table.ndim != 2 or block_table.shape[0] != q.shape[0] \
            or block_table.dtype != torch.int32:
        raise ValueError(f"block_table must be int32 ({q.shape[0]}, "
                         f"max_pages), got {block_table.dtype} "
                         f"{tuple(block_table.shape)}")
    for t in lens:
        if tuple(t.shape) != (q.shape[0],) or t.dtype != torch.int32:
            raise ValueError(f"lengths must be int32 ({q.shape[0]},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    tensors = (q, k_pages, v_pages, block_table, *lens)
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {devs}")
    if not q.is_cuda:
        return
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"the kernels read q and the pools in one dtype, "
                         f"bf16 or f32; got q {q.dtype}, pools "
                         f"{k_pages.dtype}/{v_pages.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, the pools, the block table and the lengths "
                         "must be contiguous")


def _check_fit(rows: int, ps: int, d: int, tile_limit: int) -> None:
    """A block's query rows fit its registers and shared memory."""
    if d % 4:
        raise ValueError(f"the kernels take D in steps of 4, got D={d}")
    if _tiles(rows, d) > tile_limit:
        raise ValueError(f"{rows} query rows x D={d} exceed the "
                         f"{16 * tile_limit} accumulator values a block "
                         "holds")
    if _smem_bytes(rows, ps, d) > MAX_SMEM:
        raise ValueError(f"page size {ps} x D={d} needs more shared memory "
                         f"than a block has")


def _vec(k_pages: torch.Tensor, v_pages: torch.Tensor) -> int:
    """16-byte loads of K/V rows stay aligned."""
    row = k_pages.shape[-1] * k_pages.element_size()
    return int(row % 16 == 0 and k_pages.data_ptr() % 16 == 0
               and v_pages.data_ptr() % 16 == 0)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    cache_len: torch.Tensor,
                    window: Optional[int] = None) -> torch.Tensor:
    """B3: q (B, H, D) over one layer's pools (P, ps, Hkv, D) through
    block_table (B, max_pages); row b sees positions < cache_len[b] (this
    tick's token included). Returns f32 (B, H, D)."""
    if q.ndim != 3:
        raise ValueError(f"q must be (B, H, D), got {tuple(q.shape)}")
    _check(q, k_pages, v_pages, block_table, (cache_len,))
    if not q.is_cuda:
        return ref.ref_paged_attention(q, k_pages, v_pages, block_table,
                                       cache_len, window)
    b, h, d = q.shape
    _, ps, hkv, _ = k_pages.shape
    _check_fit(h // hkv, ps, d, B3_TILES)
    lib = build()
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), cache_len.data_ptr(), out.data_ptr(), b,
            h, hkv, d, ps, block_table.shape[1],
            -1 if window is None else window, 1.0 / d ** 0.5,
            int(q.dtype == torch.bfloat16), _vec(k_pages, v_pages),
            ctypes.c_void_p(stream))
    _raise_on(rc, "paged_attention")
    launches["paged_attention"] += 1
    return out


def paged_attention_mq(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_table: torch.Tensor,
                       q_offset: torch.Tensor, q_len: torch.Tensor,
                       window: Optional[int] = None) -> torch.Tensor:
    """B4: ragged q (B, C, H, D); query i of row b sits at position
    q_offset[b] + i and is live iff i < q_len[b]. The pools must already
    hold each row's new K/V. Dead lanes give zeros. Returns f32
    (B, C, H, D)."""
    if q.ndim != 4:
        raise ValueError(f"q must be (B, C, H, D), got {tuple(q.shape)}")
    _check(q, k_pages, v_pages, block_table, (q_offset, q_len))
    if not q.is_cuda:
        return ref.ref_paged_attention_mq(q, k_pages, v_pages, block_table,
                                          q_offset, q_len, window)
    b, c, h, d = q.shape
    _, ps, hkv, _ = k_pages.shape
    tq = b4_lanes(c, h, hkv, d)
    _check_fit(tq * (h // hkv), ps, d, B4_TILES)
    lib = build()
    out = torch.empty((b, c, h, d), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.paged_attention_mq_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), q_offset.data_ptr(), q_len.data_ptr(),
            out.data_ptr(), b, c, h, hkv, d, ps, block_table.shape[1], tq,
            -1 if window is None else window, 1.0 / d ** 0.5,
            int(q.dtype == torch.bfloat16), _vec(k_pages, v_pages),
            ctypes.c_void_p(stream))
    _raise_on(rc, "paged_attention_mq")
    launches["paged_attention_mq"] += 1
    return out


# ---------------------------------------------------------------------------
# Serving dispatch
# ---------------------------------------------------------------------------
def _resolve(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"unknown paged-attention mode {mode!r}; one of "
                         f"{MODES}")
    return mode


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           cache_len: torch.Tensor, *,
                           window: Optional[int] = None,
                           mode: str = "kernel") -> torch.Tensor:
    """Paged decode attention: q (B, 1, H, D) over the pool -> same dtype.
    ``cache_len`` already includes this tick's appended token."""
    if _resolve(mode) == "kernel":
        _stats["kernel"] += 1
        out = paged_attention(q[:, 0], k_pages, v_pages, block_table,
                              cache_len, window)
        return out[:, None].to(q.dtype)
    _stats["gather"] += 1
    from repro_torch.models.layers import decode_attention, paged_gather
    return decode_attention(q, paged_gather(k_pages, block_table),
                            paged_gather(v_pages, block_table), cache_len,
                            window=window)


def paged_mixed_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_table: torch.Tensor,
                          q_offset: torch.Tensor, q_len: torch.Tensor, *,
                          window: Optional[int] = None,
                          mode: str = "kernel") -> torch.Tensor:
    """Mixed-tick attention: ragged q (B, C, H, D) over the pool -> same
    dtype. The pool already holds each row's new K/V; dead lanes give
    zeros on both paths."""
    if _resolve(mode) == "kernel":
        _stats["kernel_mq"] += 1
        return paged_attention_mq(q, k_pages, v_pages, block_table, q_offset,
                                  q_len, window).to(q.dtype)
    _stats["gather_mq"] += 1
    from repro_torch.models.layers import mixed_attention, paged_gather
    return mixed_attention(q, paged_gather(k_pages, block_table),
                           paged_gather(v_pages, block_table), q_offset,
                           q_len, window=window)
