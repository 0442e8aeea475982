"""Paged attention read straight off the KV page pools: bind, launch, dispatch.

Replaces ``repro/kernels/paged_attention.py`` (``paged_attention_pallas``,
B3, and ``paged_attention_pallas_mq``, B4) with the CUDA C++ kernel in
``csrc/paged_attention.cu``, built into the port's one kernel library
(``kernels/build.py``). The wrappers take one layer's pools (P, ps, Hkv, D)
where they lie — a layer's pool is the view ``pool[g]`` of the stacked
(G, P, ps, Hkv, D) tensor, read at its data pointer with no copy — the
block table (B, max_pages) int32 and the per-row lengths, and return f32.
On a CUDA tensor a wrapper launches its kernel (one launch per call) or
raises; on a CPU tensor it computes the plain version from
``kernels/ref.py``. ``launches`` counts kernel launches and nothing else; a
tensor that holds no data takes the card branch and launches shape-only
(``kernels/common.py``), counting the most the block table can map.

The kernel splits each (slot, kv head, q block)'s page walk across blocks
and merges the splits' partial softmaxes in the same launch.
``split_plan`` cuts the work from shapes alone — the lengths stay on the
device, so a call can be captured in a CUDA graph — and ``walk`` /
``split_pages`` mirror, on the host, which pages each block reads.

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
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref
from repro_torch.kernels.common import (nbytes, on_card, record_shape_only,
                                        shape_only)

SOURCE = _build.CSRC / "paged_attention.cu"
MODES = ("kernel", "gather")
# The kernel's own constants (kRows, kTileKeys, kFoldRows, kFoldTiles in
# csrc/paged_attention.cu) are mirrored here for the plan and the host
# mirror of its walk.
TARGET_BLOCKS = 8 * 132    # blocks a plan aims for, live and empty: eight
#                            waves on the 132 SMs of an H100 SXM
ROWS = 64                  # query rows (lane x head) a block holds
QBLOCK_ROWS = 32           # query rows a q block aims at
TILE_KEYS = 64             # key rows of one staged tile
MAX_SPLITS = 16            # splits a merge folds, at most
FOLD_ROWS, FOLD_TILES = 16, 4   # a q block of more rows whose walk spans
#                               at most this many tiles is walked by one
#                               block, with no merge
MAX_SMEM = 232448          # bytes of shared memory a block may opt into

# Kernel launches per wrapper (B3 = paged_attention, B4 = paged_attention_mq).
launches: Dict[str, int] = {"paged_attention": 0, "paged_attention_mq": 0}

_stats: Dict[str, int] = {"kernel": 0, "gather": 0,
                          "kernel_mq": 0, "gather_mq": 0}
_lib: Optional[ctypes.CDLL] = None
# Ticket counters per device; every buffer ever handed to a launch stays
# alive, since a captured CUDA graph keeps its pointer.
_tickets: Dict[torch.device, List[torch.Tensor]] = {}


def stats() -> Dict[str, int]:
    """Host-side counts of which paged-attention path each call took."""
    return dict(_stats)


def reset_stats() -> None:
    for k in _stats:
        _stats[k] = 0


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def snapshot() -> Dict[str, int]:
    """The launch counts and the dispatch paths' counts as they stand (their
    keys differ); the difference of two snapshots is what ``credit`` takes
    (``serve/tick_graph.py`` credits a CUDA graph's at each replay)."""
    return {**launches, **_stats}


def credit(delta: Dict[str, int]) -> None:
    for k, v in delta.items():
        (launches if k in launches else _stats)[k] += v


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


# ---------------------------------------------------------------------------
# The split plan
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SplitPlan:
    """How one launch cuts its work. The grid is (splits, Hkv, B x nq):
    one block per split of each (slot, kv head, q block) group; split s
    covers logical pages [s, s + 1) x pages_per_split of the row, in tiles
    of tile_pages pages (at most 64 keys), except where a short walk of
    many rows is folded into one split (``split_pages``)."""
    b: int
    hkv: int
    d: int
    tq: int                # query lanes per q block
    nq: int                # q blocks per row
    rows: int              # query rows per q block: tq x G
    tile_pages: int
    tiles_per_split: int
    splits: int
    stages: int            # tiles in flight per block: 1 or 2
    smem_bytes: int        # dynamic shared memory per block

    @property
    def groups(self) -> int:
        return self.b * self.hkv * self.nq

    @property
    def pages_per_split(self) -> int:
        return self.tiles_per_split * self.tile_pages

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (self.splits, self.hkv, self.b * self.nq)

    @property
    def scratch_acc(self) -> int:
        """f32 values of the partial accumulators (groups, splits, rows, D);
        none with one split, whose blocks write the output themselves."""
        return 0 if self.splits == 1 else \
            self.groups * self.splits * self.rows * self.d

    @property
    def scratch_ml(self) -> int:
        """f32 values of the partial max and sum (groups, splits, 2, rows)."""
        return 0 if self.splits == 1 else \
            self.groups * self.splits * 2 * self.rows


def _smem(d: int, itemsize: int, stages: int) -> int:
    """Dynamic shared memory of a block (``smem_bytes`` in the source): the
    q rows and the stages (which the warps' merge reuses) and the f32
    path's probabilities."""
    ld = d + 16 // itemsize               # rows padded by 16 bytes
    p_s = 4 * 16 * 16 * 4 if itemsize == 4 else 0
    return itemsize * (ROWS + stages * 2 * TILE_KEYS) * ld + p_s


def split_plan(b: int, c: int, h: int, hkv: int, d: int, ps: int, mp: int,
               itemsize: int = 2) -> SplitPlan:
    """The launch's cut from shapes alone (B, C, H, Hkv, D, ps, the block
    table's width ``mp`` and the element size), never from the lengths.

    A q block holds as many lanes as give at most QBLOCK_ROWS query rows
    (one lane when G is larger, up to the 64 rows a block holds). A tile is
    64 // ps pages (64 keys at ps 16). The walk of the widest row, mp pages,
    is cut into as many splits as give about TARGET_BLOCKS blocks (eight
    waves on 132 SMs: most are empty at short lengths and exit at once), at
    most one per tile and at most MAX_SPLITS, which bounds the merge. Raises
    ValueError for what the kernel does not take."""
    if hkv < 1 or h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    g = h // hkv
    if g > ROWS:
        raise ValueError(f"{g} query heads per kv head exceed the {ROWS} "
                         "query rows a block holds")
    if d not in (16, 32, 64, 128, 256):
        raise ValueError(f"the kernel takes D a power of two from 16 to "
                         f"256, got D={d}")
    if not 0 < ps <= TILE_KEYS:
        raise ValueError(f"the kernel takes page sizes 1..{TILE_KEYS}, got "
                         f"{ps}")
    if mp < 1 or c < 1:
        raise ValueError(f"the block table needs a column and q a lane, got "
                         f"max_pages={mp}, C={c}")
    if mp * ps >= 1 << 20:
        raise ValueError(f"the kernel takes rows of fewer than 2^20 positions,"
                         f" got max_pages={mp} x page size {ps}")
    tq = min(c, max(1, QBLOCK_ROWS // g))
    nq = -(-c // tq)
    tile_pages = TILE_KEYS // ps
    n_tiles = -(-mp // tile_pages)
    groups = b * hkv * nq
    splits = min(n_tiles, MAX_SPLITS,
                 max(1, -(-TARGET_BLOCKS // max(groups, 1))))
    tiles_per_split = -(-n_tiles // splits)
    splits = -(-n_tiles // tiles_per_split)
    # two tiles in flight where a block may walk more than one
    multi = tiles_per_split > 1 or tq * g > FOLD_ROWS
    stages = 2 if multi and _smem(d, itemsize, 2) <= MAX_SMEM else 1
    smem = _smem(d, itemsize, stages)
    if smem > MAX_SMEM:
        raise ValueError(f"D={d} needs {smem} bytes of shared memory, more "
                         "than a block has")
    if hkv > 65535 or b * nq > 65535:
        raise ValueError(f"grid {(splits, hkv, b * nq)} exceeds the launch "
                         "limits")
    return SplitPlan(b=b, hkv=hkv, d=d, tq=tq, nq=nq, rows=tq * g,
                     tile_pages=tile_pages, tiles_per_split=tiles_per_split,
                     splits=splits, stages=stages, smem_bytes=smem)


def live_lanes(q_len: int, qb: int, tq: int, c: int) -> int:
    """Live query lanes of q block ``qb`` (its live rows are these x G)."""
    return max(min(q_len - qb * tq, tq, c - qb * tq), 0)


def walk(q_offset: int, q_len: int, qb: int, tq: int, c: int, ps: int,
         mp: int, window: Optional[int] = None) -> Optional[Tuple[int, int]]:
    """Pages [first, last] that q block ``qb`` of a row reads — the
    kernel's clamped walk, as the Pallas index maps clamp it, and within the
    block table. None for a q block with no live lane (it reads nothing).
    B3 is ``walk(cache_len - 1, 1, 0, 1, 1, ...)``."""
    i0 = qb * tq
    live = live_lanes(q_len, qb, tq, c)
    if live == 0:
        return None
    hi = q_offset + i0 + live
    last = min(max(-(-hi // ps) - 1, 0), mp - 1)
    first = 0
    if window is not None:
        first = min(max((q_offset + i0 + 1 - window) // ps, 0), last)
    return first, last


def split_pages(plan: SplitPlan, first: int, last: int, s: int,
                rows: int) -> range:
    """The pages of walk [first, last] that split ``s`` reads (empty when
    the split lies outside the walk), for a q block of ``rows`` live query
    rows (live lanes x G). A walk of more than FOLD_ROWS rows over at most
    FOLD_TILES tiles is read whole by the split holding its first page."""
    pps = plan.pages_per_split
    if rows > FOLD_ROWS and last - first < FOLD_TILES * plan.tile_pages:
        return range(first, last + 1) if s == first // pps else range(0)
    return range(max(first, s * pps), min(last, s * pps + pps - 1) + 1)


def _ticket_buffer(device: torch.device, n: int) -> torch.Tensor:
    """Zeroed int32 counters, at least ``n``, kept per device. The kernel
    leaves them zero. Grown (never freed) outside a CUDA-graph capture."""
    bufs = _tickets.setdefault(device, [])
    if not bufs or bufs[-1].numel() < n:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("paged attention needs more ticket counters "
                               "than a capture may allocate; call it once "
                               "with these shapes before capturing")
        bufs.append(torch.zeros(max(4096, 1 << (n - 1).bit_length()),
                                dtype=torch.int32, device=device))
    return bufs[-1]


def launch_buffers(plan: SplitPlan, device: torch.device
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What a launch writes besides the output: the partials' scratch
    (``torch.empty``, sized by the plan) and the device's ticket
    counters."""
    acc = torch.empty(plan.scratch_acc, dtype=torch.float32, device=device)
    ml = torch.empty(plan.scratch_ml, dtype=torch.float32, device=device)
    return acc, ml, _ticket_buffer(device, plan.groups)


def build() -> ctypes.CDLL:
    """Build (once) the port's kernel library and bind B3/B4."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.library()
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_attention_launch.argtypes = [ptr] * 10 + [i32] * 13 + [
        f32, i32, i32, ptr]
    lib.paged_attention_launch.restype = i32
    _lib = lib
    return lib


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
    if not on_card(q):
        return
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"the kernels read q and the pools in one dtype, "
                         f"bf16 or f32; got q {q.dtype}, pools "
                         f"{k_pages.dtype}/{v_pages.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, the pools, the block table and the lengths "
                         "must be contiguous")


def _vec(*tensors: torch.Tensor) -> int:
    """16-byte copies of q and the K/V rows stay aligned (D is a power of
    two from 16, so rows are whole 16-byte chunks)."""
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _launch(name: str, q: torch.Tensor, c: int, k_pages: torch.Tensor,
            v_pages: torch.Tensor, block_table: torch.Tensor,
            lens: torch.Tensor, q_len: Optional[torch.Tensor],
            window: Optional[int], out_shape) -> torch.Tensor:
    """One launch of the kernel: B3 (``q_len`` None, ``lens`` the cache
    lengths) or B4 (``lens`` the cursors)."""
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    _, ps, hkv, _ = k_pages.shape
    mp = block_table.shape[1]
    plan = split_plan(b, c, h, hkv, d, ps, mp, q.element_size())
    out = torch.empty(out_shape, dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    if shape_only(q):
        # the data decide how much of the walk is live: count the most the
        # block table can map (every row, every page)
        positions = b * mp * ps
        kv = 2 * positions * hkv * d * k_pages.element_size()
        record_shape_only(name, 4 * c * h * d * positions,
                          nbytes(q) + nbytes(block_table) + nbytes(lens)
                          + (0 if q_len is None else nbytes(q_len)) + kv,
                          nbytes(out))
        return out
    lib = build()
    acc, ml, tickets = launch_buffers(plan, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), lens.data_ptr(),
            None if q_len is None else q_len.data_ptr(), out.data_ptr(),
            acc.data_ptr(), ml.data_ptr(), tickets.data_ptr(), b, c, h, hkv,
            d, ps, mp, plan.tq, plan.tile_pages, plan.tiles_per_split,
            plan.splits, plan.stages, -1 if window is None else window,
            1.0 / d ** 0.5, int(q.dtype == torch.bfloat16),
            _vec(q, k_pages, v_pages), ctypes.c_void_p(stream))
    _raise_on(rc, name)
    launches[name] += 1
    return out


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
    if not on_card(q):
        return ref.ref_paged_attention(q, k_pages, v_pages, block_table,
                                       cache_len, window)
    return _launch("paged_attention", q, 1, k_pages, v_pages, block_table,
                   cache_len, None, window, tuple(q.shape))


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
    if not on_card(q):
        return ref.ref_paged_attention_mq(q, k_pages, v_pages, block_table,
                                          q_offset, q_len, window)
    return _launch("paged_attention_mq", q, q.shape[1], k_pages, v_pages,
                   block_table, q_offset, q_len, window, tuple(q.shape))


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
