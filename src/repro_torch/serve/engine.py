"""Packed-weight continuous-batching engine for elastic-precision serving.

Counterpart of ``repro/serve/engine.py`` on its default path: one anchor
checkpoint (MXINT8/MXFP8) stays resident; per-format weight caches hold
packed trees from ``make_packed_params`` (MXTensor leaves, split-N
``PackedInt4Leaf`` at mxint4), built by one Slice-and-Scale pass on first
use. Every projection of every step runs through ``kernels/dispatch.py``:

  fused (default)  the packed leaf goes to the dequant-GEMM kernel — the
                   CUDA kernel on the card, its plain version on the CPU;
  densify          ``fused=False``: each leaf is dequantized at its point of
                   use and multiplied by ``torch.matmul`` (the reference).

Slot lifecycle:

  admit   — a free slot takes the next queued request. Monolithic admission
            prefills the whole prompt alone into that slot
            (``ModelApi.prefill_slot``; prompts right-padded to power-of-two
            buckets with exact masking, or at their own length with
            ``bucket_prompts=False``). Chunked admission
            (``prefill_chunk``) streams it one chunk per tick, cursor on the
            host: under the mixed scheduler the chunk rides the decode batch
            (``ModelApi.mixed_step``, one executable per tick).
  decode  — one ``serve_step`` advances every slot per tick; free slots are
            masked (their cache_len does not advance, their tokens drop).
  retire  — a slot frees when its request reaches ``max_new`` or the cache
            capacity, and is re-admitted on the next tick.

KV layouts: dense (slots x max_len per layer) or paged — shared page pools
with a host-side free list (page 0 is scratch), pages allocated at
admission (per chunk when chunked), at each decode page boundary before the
step, and freed at retire. Exhaustion is contained: an unservable prompt
ends FAILED_CAPACITY, an admission that finds no free page is requeued
until a retire frees one, and when decode starves the largest page-holder
retires FAILED_CAPACITY. On the paged layout, ``attn_impl="paged_kernel"``
reads the pools through B3/B4 (``kernels/paged_attention.py``).

The format is batch-pinned: the policy picks when the engine goes from
drained to busy, and every request admitted while a slot is live inherits
it. The pseudo-format ``"bf16"`` serves dense anchor-precision weights.

Sampling (``generate(greedy=False)``): temperature / top-p draws from
per-slot key streams on JAX's threefry chain (``serve/sampling.py``), as
the reference draws them. A completing admission reseeds its slot from
``fold_in(engine key, rid)`` and draws the first token; every
decode-carrying tick advances every slot's key once (free and mid-prefill
slots included, their draws discarded), and under the mixed scheduler a
completing admission reseeds after that batch draw. A request's stream is
therefore a function of (seed, rid, its logits) alone — the JAX engine's
stream, token for token. ``Request.temperature`` / ``top_p`` override the
engine's per slot.

The logit guard (``logit_guard=True``, the default): non-finite logits in a
consumed row (a live decode row, or the row of a prompt's last chunk)
escalate the pinned format one rung toward the anchor, quarantine the rung
that misbehaved and replay the tick from its pre-tick state; at the anchor
the dead rows alone retire FAILED_NUMERIC. The finite flags ride the tick's
one device-to-host copy, so a clean tick pays nothing for the guard.

The rest of the per-request failure model is the reference's: at each tick
boundary cancelled requests (``Request.cancel()``, the injector's
``cancel_at``) retire CANCELLED and those past ``deadline_s`` TIMED_OUT,
queued, mid-prefill or decoding, their pages freed. A decode or mixed step
that raises ``InjectedFault`` before dispatch is retried at the same format
up to ``max_step_retries`` times, then the fault escapes ``generate``.
``fault_injector`` (``runtime/fault.py::FaultInjector``) drives all of it:
poisoned logits, a NaN-filled pool page (written in place, before the
tick), failed page allocations (they take the real exhaustion paths),
step crashes and cancellations.

Preemption (``generate(guard=, snapshot_dir=)``): a triggered
``PreemptionGuard`` (a signal, or the injector's ``preempt_at`` mid-tick)
is acted on at the next tick boundary, before any executable runs: the
wave's whole state goes to ``snapshot_dir`` (``checkpoint/io.py``: the KV
leaves, lengths, tokens, keys and sampling lanes, the block-table mirror,
each request's prompt and tokens; queues, cursors, counters, statuses and
quarantine in the manifest) and ``generate`` returns the wave incomplete.
``resume(snapshot_dir)`` on an identically configured engine — a fresh
one, or this one with its graphs captured — copies the arrays into the
engine's buffers in place and finishes the wave with the streams of an
uninterrupted run.

Self-speculative decoding (``speculative=SpecConfig(draft_fmt, k)``): a
pure decode tick drafts ``k_eff`` greedy tokens at ``draft_fmt`` (the same
anchor through Slice-and-Scale, the same cache) against a draft cursor of
its own, then one guarded ``verify_step`` at the pinned format scores the
``k_eff + 1`` positions of every slot; each slot commits its longest
matching draft prefix plus the verify's bonus token, and on the paged
layout hands back the pages past its new frontier. Only verify-format
argmaxes are committed, so the streams are plain pinned-format decode's at
any acceptance rate. Greedy only.

On the card each decode tick (``serve_step``), each mixed tick
(``mixed_step``), each draft step and each verify runs as one CUDA graph
(``serve/tick_graph.py``): the first tick of each (entry point, format,
KV layout, width) runs eagerly and is then captured, and every later one
is a replay — the counterpart of the reference's one jitted executable
per tick. What a captured tick reads and writes keeps its storage for the
engine's lifetime: the KV cache and a hybrid stack's Mamba state (zeroed
at each wave, written in place by ``resume``), ``cache_len``, the tokens, the block table, one token /
``q_len`` buffer per mixed-tick and per verify width, the draft cursor and
tokens, and the slots' keys, temperatures and top-p values. A sampled
tick's batch draw runs as a CUDA graph of its own, after the tick's.
Prefill executables run eagerly.

SLO serving (``serve/slo.py``): ``Request.slo`` carries a tier and TTFT /
TPOT budgets, ``Request.arrival_tick`` the scheduler tick at which a request
becomes visible to admission (a tick with nothing live and nothing arrived
is an idle tick), and ``admission_order="slo"`` admits the arrived requests
by (tier rank, queue position). A drained engine re-picks its format from
the arrived requests, passing the wave's tightest TPOT budget and expected
decode rows to ``FormatPolicy.pick``; with a ``CostModel`` attached, each
format build re-seeds its weight term from the bytes the cached tree
streams, and each clean pure-decode tick (no prefill work, one executable,
no guard replay, not speculative) after a format's first is folded into
that format's calibration. The first is skipped as the reference skips its
jit warm-up: here it runs eagerly, or is the CUDA-graph capture.

Stacks that are not pure attention (jamba's Mamba layers, rwkv6-7b's
RWKV layers) serve as the reference serves them: on the dense layout,
prompts prefilled whole at their own length (a recurrent state would fold
bucket padding in), no chunked admission, no mixed tick, no speculation. A
decode tick writes the recurrent state (Mamba's ``h`` / ``conv``, RWKV's
``shift_t`` / ``wkv`` / ``shift_c``) in place, so the guard keeps a copy of
it before each guarded tick and puts it back before a replay: every
attempt starts from the pre-tick state, as the reference's functional step
does.

Tensor parallelism (``mesh=``, a ``launch/mesh.py::Mesh`` with a
``model`` axis): one logical engine whose weights and KV pools are sharded
over the mesh's ``model`` axis, one process per shard. Every process of the
axis's group builds the engine with the same arguments and calls
``generate`` with the same requests; the step functions run this
process's shard (``models/__init__.py::shard_dims`` of the parameters'
resolved specs: its heads and kv heads, beside the global config) and
all-reduce the row-parallel projections and the vocab-sharded embedding
and gather the head's logit slices (``models/common.py::TensorParallel``),
so every process holds the same logits and runs the same host bookkeeping. Each format's
packed tree is built whole, its column-sharded split-N leaves repacked per
shard, and cut to the local shard; the KV pools and the dense cache hold
the local kv heads, and the block table and the host state stay
replicated. A meshed engine runs its ticks eagerly: a collective over a
gloo group cannot be captured in a CUDA graph, so ``cuda_graphs`` resolves
to False and True raises. A snapshot records the mesh shape and goes to a
subdirectory per shard; resume refuses another mesh shape. Data
parallelism is ``serve/replicas.py::ReplicaSet``.

Left out of this slice: configs with a vision prefix and the
encoder-decoder family, whose frames or image embeddings a ``Request`` has
no field to carry (refused at construction, ROADMAP C.10 and C.12; the
reference fails at its first admission).
"""
from __future__ import annotations

import dataclasses
import enum
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core.anchor import AnchorModel, convert, materialize
from repro_torch.core.formats import get_format
from repro_torch.core.tree import flatten_paths
from repro_torch.devices import resolve_device
from repro_torch.kernels import mx_matmul, paged_attention
from repro_torch.kernels.dispatch import make_qmm
from repro_torch.kernels.paged_attention import pages_read, pages_read_mq
from repro_torch.models import shard_dims
from repro_torch.models.common import TensorParallel, spec_accept_counts
from repro_torch.models.transformer import ModelApi, make_model, param_axes
from repro_torch.runtime.fault import FaultInjector, InjectedFault
from repro_torch.serve.packed_params import (anchor_block_size,
                                             is_packed_leaf, local_shard,
                                             make_packed_params,
                                             packed_param_specs,
                                             repack_splitn_for_tp,
                                             weight_stream_bytes,
                                             weight_stream_bytes_local)
from repro_torch.serve.policy import FormatPolicy, SpecConfig
from repro_torch.serve.sampling import (fold_in, prng_key, sample_batch,
                                        split)
from repro_torch.serve.slo import SLOClass, tier_rank
from repro_torch.serve.tick_graph import TickGraphs
from repro_torch.sharding.rules import mesh_sizes, param_specs
from repro_torch.train.state import state_shardings

DENSE_BF16 = "bf16"   # pseudo-format: dense anchor-precision weights

MIN_PREFILL_BUCKET = 8


def _bucket_len(plen: int, cap: int) -> int:
    """Smallest power-of-two bucket >= plen (floor MIN_PREFILL_BUCKET),
    clamped to the cache capacity ``cap``."""
    b = MIN_PREFILL_BUCKET
    while b < plen:
        b *= 2
    return min(b, cap)


class RequestStatus(str, enum.Enum):
    """Every request ends in exactly one terminal state; a non-COMPLETED
    one carries ``Request.error`` and a record in ``stats()["failures"]``."""
    QUEUED = "queued"
    RUNNING = "running"
    COMPLETED = "completed"              # reached max_new / cache capacity
    FAILED_NUMERIC = "failed_numeric"    # non-finite logits at anchor rung
    FAILED_CAPACITY = "failed_capacity"  # unservable prompt / pool starved
    TIMED_OUT = "timed_out"              # per-request deadline_s exceeded
    CANCELLED = "cancelled"              # cancel() / injected cancellation

    @property
    def terminal(self) -> bool:
        return self not in (RequestStatus.QUEUED, RequestStatus.RUNNING)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    fmt_used: Optional[str] = None
    done: bool = False
    ttft_s: Optional[float] = None  # generate() entry to first token
    deadline_s: Optional[float] = None  # budget from generate() entry;
    #                                     past it -> TIMED_OUT at the next
    #                                     tick boundary
    status: RequestStatus = RequestStatus.QUEUED
    error: Optional[str] = None
    cancel_requested: bool = False
    slo: Optional[SLOClass] = None  # tier + TTFT/TPOT budgets; None =
    #                                 best-effort, no budgets
    tenant: Optional[str] = None    # workload attribution
    arrival_tick: int = 0           # scheduler tick this request becomes
    #                                 visible to admission (0 = queued)
    arrival_s: Optional[float] = None   # wave clock when it came due
    #                                     (stamped by the engine; TTFT
    #                                     against the SLO is ttft_s minus
    #                                     this)
    admitted_tick: Optional[int] = None  # tick admission claimed it
    temperature: Optional[float] = None  # None -> the engine's
    top_p: Optional[float] = None        # None -> the engine's

    def cancel(self) -> None:
        """Retire this request as CANCELLED at the next tick boundary
        (queued, mid-prefill or decoding); a terminal one is unaffected."""
        self.cancel_requested = True


# A graph key's kind -> the ModelApi entry point it runs: a draft step is
# a serve_step against the draft cursor and tokens, keyed apart from the
# committed ones'.
_ENTRY = {"draft_step": "serve_step"}


@dataclasses.dataclass
class _Drain:
    """What one decode, mixed or verify attempt brings back in its one host
    copy: every row's next token (a verify: every lane's argmax) and finite
    flag, and a mixed tick's completing admission's first token; plus, when
    sampling, the advanced keys that stay on the device until the guard
    settles."""
    tokens: Optional[torch.Tensor]      # (B,) next tokens, on the device
    drained: np.ndarray                 # (B,) the same, on the host; a
    #                                     verify's (B, C) lane argmaxes
    finite: np.ndarray                  # (B,) 1 where the row is finite
    first: Optional[int] = None         # the completing admission's token
    keys: Optional[torch.Tensor] = None       # (B, 2) advanced slot keys
    first_key: Optional[torch.Tensor] = None  # (2,) its reseeded key


class ElasticEngine:
    """Continuous-batching engine serving from packed MX weight caches.

    ``fused``: None or True runs packed leaves through the dequant-GEMM
    kernels; False selects the densify reference contract. ``packed=False``
    serves every format from densified weights instead. ``device`` holds
    the weights and caches ("cuda" unless the caller asks for "cpu").

    ``kv_layout``: ``"dense"`` preallocates (slots, max_len) per layer;
    ``"paged"`` serves from shared page pools of ``kv_page_size``-token
    pages (``kv_num_pages``, None = dense capacity + the scratch page 0)
    and a per-slot block table, with the free list on the host. ``attn_impl``
    picks the paged read path: ``"paged_kernel"`` (B3/B4, the default when
    paged) or ``"gather"`` (materialise each row's view first; the only
    choice on the dense layout). ``prefill_chunk`` (int, or ``"auto"`` =
    one page when paged, else 64) streams each prompt in chunks of that
    many tokens, at most one chunk per tick; ``scheduler`` ``"mixed"`` (the
    default with chunks) runs that chunk inside the decode batch as one
    ``mixed_step``, ``"sequential"`` as its own executable before the
    decode step. ``logit_guard`` escalates and replays a tick whose consumed
    logits are not finite (module docstring); ``max_step_retries`` bounds
    the same-format retries of a step that crashed with ``InjectedFault``;
    ``fault_injector`` drives both and the rest of the failure model.
    ``seed``, ``temperature`` and ``top_p`` set the sampled streams of
    ``generate(greedy=False)`` (temperature <= 0 decodes greedily);
    ``bucket_prompts=False`` prefills each prompt (and final chunk) at its
    own length instead of a power-of-two bucket; ``admission_order``
    ``"fifo"`` admits arrived requests in queue order, ``"slo"`` by (tier
    rank, queue position). ``speculative`` (a ``SpecConfig``)
    turns pure decode ticks self-speculative (module docstring).
    ``cuda_graphs`` (None = on where the device is CUDA) runs decode,
    mixed, draft and verify ticks, and a sampled tick's draw, as CUDA
    graphs; False runs every launch eagerly, as ``jax.disable_jit`` does
    for the reference. ``mesh`` shards the engine over the mesh's ``model``
    axis (module docstring; eager ticks).
    """

    def __init__(self, api: ModelApi, anchor: AnchorModel, *,
                 batch_slots: int = 4, max_len: int = 256,
                 policy: Optional[FormatPolicy] = None, packed: bool = True,
                 fused: Optional[bool] = None, seed: int = 0,
                 temperature: float = 1.0, top_p: float = 1.0,
                 bucket_prompts: bool = True, kv_layout: str = "dense",
                 kv_page_size: int = 16, kv_num_pages: Optional[int] = None,
                 attn_impl: Optional[str] = None, prefill_chunk=None,
                 scheduler: Optional[str] = None, logit_guard: bool = True,
                 max_step_retries: int = 2,
                 fault_injector: Optional[FaultInjector] = None,
                 speculative: Optional[SpecConfig] = None,
                 admission_order: str = "fifo",
                 cuda_graphs: Optional[bool] = None, device="cuda",
                 mesh=None):
        if admission_order not in ("fifo", "slo"):
            raise ValueError(f"unknown admission_order {admission_order!r}; "
                             "one of ('fifo', 'slo')")
        self.admission_order = admission_order
        if fault_injector is not None:
            if not isinstance(fault_injector, FaultInjector):
                raise TypeError("fault_injector must be a repro_torch."
                                "runtime.fault.FaultInjector, got "
                                f"{type(fault_injector).__name__}")
        self.logit_guard = logit_guard
        self.max_step_retries = max_step_retries
        self._fault_injector = fault_injector
        self.device = resolve_device(device)
        self._tp, self.mesh = self._check_mesh(mesh, api, anchor), mesh
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda" and mesh is None
        elif cuda_graphs and mesh is not None:
            raise ValueError(
                "cuda_graphs=True on a mesh: a gloo collective cannot be "
                "captured in a CUDA graph, so a meshed engine runs its "
                "ticks eagerly")
        elif cuda_graphs and self.device.type != "cuda":
            raise ValueError(f"cuda_graphs=True needs a CUDA device, got "
                             f"{self.device}; the CPU path runs every tick "
                             "eagerly")
        self._graphs = TickGraphs() if cuda_graphs else None
        # the sampled ticks' batch draw: a graph pool of its own, so a draw
        # replay never overwrites a tick graph's static logits
        self._draw_graphs = TickGraphs() if cuda_graphs else None
        # Sampling: the engine key and one key, temperature and top-p lane
        # per slot, kept for the engine's lifetime (a captured draw reads
        # them where they lie). A completing admission reseeds its slot.
        self.temperature = temperature
        self.top_p = top_p
        self._key = prng_key(seed)
        self._keys = split(self._key, batch_slots).to(self.device)
        self._temps = torch.full((batch_slots,), temperature,
                                 dtype=torch.float32, device=self.device)
        self._tops = torch.full((batch_slots,), top_p, dtype=torch.float32,
                                device=self.device)
        self._draw_in: Optional[torch.Tensor] = None   # the draw's logits
        self._sampled = False           # this generate() call draws
        self.anchor = anchor
        self.slots = batch_slots
        self.max_len = max_len
        self.policy = policy or FormatPolicy(anchor.fmt_name)
        self.packed = packed
        self.fused = fused is None or fused
        self.api = api
        self._block_size = anchor_block_size(anchor)
        cfg = api.cfg
        if cfg.vision_tokens > 0:
            raise ValueError(
                f"{cfg.name!r} prepends {cfg.vision_tokens} vision embeddings "
                "that a Request cannot carry: the engine serves text-only "
                "configs (ROADMAP C.10; the reference engine fails at the "
                "first admission with KeyError: 'vision_embeds'). Call the "
                "ModelApi's prefill / serve_step with batch['vision_embeds'] "
                "instead")
        if cfg.family == "encdec":
            raise ValueError(
                f"{cfg.name!r} is an encoder-decoder whose frame embeddings "
                "a Request cannot carry: the engine serves decoder-only "
                "text configs (ROADMAP C.12; the reference engine has no "
                "qmm hook for the family and its densify path fails at the "
                "first admission with KeyError: 'frame_embeds'). Call the "
                "ModelApi's prefill_slot / serve_step with "
                "batch['frame_embeds'] instead")
        # Length bucketing needs exact masking of right-padded prompts; a
        # recurrent mixer folds pad tokens into its state, so only
        # pure-attention stacks bucket (the reference's rule).
        pure_attn = cfg.family not in ("ssm", "encdec") \
            and cfg.attn_every <= 0
        self._bucket = bucket_prompts and pure_attn

        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}; "
                             "one of ('dense', 'paged')")
        self.kv_layout = kv_layout
        self.kv_page_size = kv_page_size
        self.kv_num_pages = kv_num_pages
        if attn_impl is None:
            attn_impl = "paged_kernel" if kv_layout == "paged" else "gather"
        if attn_impl not in ("gather", "paged_kernel"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}; one of "
                             "('gather', 'paged_kernel')")
        if attn_impl == "paged_kernel" and kv_layout != "paged":
            raise ValueError(
                "attn_impl='paged_kernel' requires kv_layout='paged' — the "
                "dense layout has no block table for the kernel to consume")
        self.attn_impl = attn_impl
        if prefill_chunk == "auto":
            prefill_chunk = kv_page_size if kv_layout == "paged" else 64
        if prefill_chunk is not None:
            if not pure_attn or cfg.vision_tokens > 0:
                raise ValueError(
                    "prefill_chunk requires a pure-attention text stack; "
                    f"family {cfg.family!r} folds the prompt into "
                    "recurrent state (or prepends vision embeds) and cannot "
                    "resume prefill mid-prompt — use prefill_chunk=None")
            if prefill_chunk < MIN_PREFILL_BUCKET:
                raise ValueError(
                    f"prefill_chunk ({prefill_chunk}) must be >= the "
                    f"minimum prefill bucket ({MIN_PREFILL_BUCKET})")
            if kv_layout == "paged" and prefill_chunk % kv_page_size:
                raise ValueError(
                    f"prefill_chunk ({prefill_chunk}) must be a multiple of "
                    f"kv_page_size ({kv_page_size}) so chunk boundaries "
                    "fall on page boundaries")
        self.prefill_chunk = prefill_chunk
        if scheduler in (None, "auto"):
            scheduler = "mixed" if prefill_chunk is not None else "sequential"
        if scheduler not in ("sequential", "mixed"):
            raise ValueError(f"unknown scheduler {scheduler!r}; one of "
                             "('sequential', 'mixed')")
        if scheduler == "mixed" and prefill_chunk is None:
            raise ValueError(
                "scheduler='mixed' coalesces the prefill chunk into the "
                "decode batch; set prefill_chunk (or 'auto')")
        self.scheduler = scheduler
        if speculative is not None:
            if getattr(api, "verify_step", None) is None:
                raise ValueError(
                    f"model family {cfg.family!r} has no verify_step entry "
                    "point; speculative decoding needs the multi-query "
                    "mixed-attention machinery (pure-attention stacks only)")
            # the reference's rule: only a pure-attention text stack can
            # rewind (recurrent mixers cannot)
            if cfg.family in ("ssm", "encdec") or not pure_attn \
                    or cfg.vision_tokens > 0:
                raise ValueError(
                    "speculative decoding requires a pure-attention text "
                    f"stack; family {cfg.family!r} cannot rewind recurrent "
                    "state (or prepends vision embeds)")
            if speculative.k < 1:
                raise ValueError(
                    f"SpecConfig.k ({speculative.k}) must be >= 1")
            if speculative.draft_fmt == DENSE_BF16:
                raise ValueError(
                    "draft_fmt='bf16' drafts at anchor precision or above — "
                    "drafting must be cheaper than verifying")
        self.speculative = speculative
        self._spec_ticks = 0        # decode ticks that ran draft + verify
        self._spec_accepted = 0     # draft tokens committed to streams
        self._spec_rejected = 0     # draft tokens rolled back
        self._spec_aborts = 0       # bursts abandoned (draft fault, pages)
        self._snapshots_saved = 0
        self._resumes = 0
        self._snap_step = 0
        self.last_snapshot: Optional[str] = None

        # The serving entry points with both knobs baked in: the packed
        # contract's GEMM hook, and the paged read path. On a mesh they
        # run this process's shard, as the parameters' resolved specs
        # describe it (shard_dims: its heads and kv heads), with the
        # collectives over the model axis' group.
        self.tensor_parallel: Optional[TensorParallel] = None
        self._src_api = api
        if self._tp > 1:
            rank = mesh.coord("model")
            self.tensor_parallel = TensorParallel(
                mesh.group, rank, self._tp, dims=shard_dims(
                    cfg, state_shardings(api, mesh)[0], rank, self._tp))
            self._src_api = make_model(cfg, qat=api.qat,
                                       tp=self.tensor_parallel)
        self._packed_api = self._src_api.with_serving(
            make_qmm(mode="kernel" if self.fused else "densify"), attn_impl)
        self._plain_api = self._src_api.with_serving(None, attn_impl)
        self._weight_bytes: Dict[str, int] = {}   # a mesh's global trees
        self._weights: Dict[str, object] = {}
        self.current_fmt: Optional[str] = None
        self._fmt_swaps = 0
        self._ticks = 0                 # decode-carrying ticks
        self._prefills = 0              # prefill executables (whole prompts
        #                                 or chunks that ran alone)
        self._tokens_out = 0
        self._prefill_s = 0.0           # host wall time in prefill executables
        self._decode_s = 0.0            # host wall time in decode/mixed steps
        self._nonfinite_rows = 0        # consumed logit rows with NaN/Inf
        self._faults_detected = 0       # guarded attempts with a dead row
        self._fmt_escalations = 0
        self._escalation_events: List[dict] = []
        self._ticks_replayed = 0
        self._failures: List[dict] = []  # one per non-COMPLETED request
        self._status_counts: Dict[str, int] = {}
        self._admission_requeues = 0
        self._alloc_calls = 0           # keys the injector's fail_allocs
        self._kv_pages_alloc = 0
        self._kv_pages_freed = 0
        self._kv_pages_hwm = 0
        self._attn_tokens_read = 0
        self._fmt_decode_ticks: Dict[str, int] = {}  # clean decode ticks
        #                          per format (the first is not cost)
        self.tick_trace: List[Dict[str, float]] = []   # reset per generate
        # What a captured tick reads and writes, allocated at the first wave
        # and kept (``_wave_state``, ``_mixed_batch``).
        self._cache = None
        self._cache_len: Optional[torch.Tensor] = None
        self._tokens: Optional[torch.Tensor] = None
        self._mixed_bufs: Dict[int, Dict[str, torch.Tensor]] = {}
        self._verify_bufs: Dict[int, Dict[str, torch.Tensor]] = {}
        self._draft_len: Optional[torch.Tensor] = None   # the draft cursor
        self._draft_tok: Optional[torch.Tensor] = None   # and tokens
        self._state_copy: List[torch.Tensor] = []   # the recurrent state
        #                                             as a guarded tick
        #                                             found it

        # every cache leaf's bytes (KV, Mamba state, block table), from
        # the global shapes alone; init_cache refuses a recurrent stack
        # paged here
        shapes = self._init_cache(batch_slots, device="meta", api=api)
        self._kv_cache_bytes = sum(
            t.numel() * t.element_size() for c in shapes["blocks"]
            for t in c.values())
        itemsize = torch.empty((), dtype=cfg.compute_dtype).element_size()
        attn_layers = sum(cfg.is_attn_layer(j)
                          for j in range(cfg.scan_group)) * cfg.n_groups
        if kv_layout == "paged":
            bt = shapes["block_table"]
            self._kv_total_pages = shapes["blocks"][0]["k_pages"].shape[1]
            self._kv_cache_bytes += bt.numel() * bt.element_size()
            self._attn_read_span = bt.shape[1] * kv_page_size
        else:
            self._kv_total_pages = 0
            self._attn_read_span = max_len + cfg.vision_tokens
        # K+V bytes of one token over every attention layer; a chip of a
        # mesh reads its kv heads' 1/tp of them (n_kv_heads % tp == 0)
        self._attn_token_bytes = 2 * attn_layers * cfg.n_kv_heads * cfg.hd \
            * itemsize
        self._attn_token_bytes_chip = self._attn_token_bytes // self._tp

    def _check_mesh(self, mesh, api: ModelApi, anchor: AnchorModel) -> int:
        """The reference's tensor-parallel guards, with its messages;
        returns the ``model`` axis size (1 without a mesh)."""
        if mesh is None:
            return 1
        names = tuple(getattr(mesh, "axis_names", ()))
        if "model" not in names:
            raise ValueError(
                "ElasticEngine(mesh=...) needs a mesh with a 'model' "
                f"axis; got axes {names}")
        sizes = mesh_sizes(mesh)
        tp = sizes["model"]
        extra = {a: n for a, n in sizes.items() if a != "model" and n != 1}
        if extra:
            raise ValueError(
                "ElasticEngine shards over the 'model' mesh axis only; "
                f"axes {extra} have size > 1 — run one engine per "
                "data-parallel slice (serve.replicas.ReplicaSet)")
        cfg = api.cfg
        if cfg.family != "dense" or cfg.vision_tokens > 0:
            raise ValueError(
                "tensor-parallel serving supports pure-attention dense "
                f"text stacks only; family {cfg.family!r} is not "
                "wired for head-sharded step functions")
        bs = anchor_block_size(anchor)
        bad = {k: v for k, v in {
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "vocab": cfg.vocab, "d_ff": cfg.d_ff}.items() if v % tp}
        # row-parallel packed scales tile the contraction dim by the MX
        # block: those dims must split into whole scale rows per shard
        bad.update({k: v for k, v in {
            "n_heads*head_dim": cfg.n_heads * cfg.hd,
            "d_ff": cfg.d_ff}.items() if v % (bs * tp)})
        if bad:
            raise ValueError(
                f"mesh 'model' axis size {tp} cannot shard this "
                f"config: {bad} not divisible (block_size={bs})")
        if tp > 1 and getattr(mesh, "group", None) is None:
            raise ValueError(
                f"a mesh whose 'model' axis has {tp} shards needs the "
                "process group of that axis (launch/mesh.py::"
                "make_debug_mesh over an initialised default group)")
        return tp

    def _mesh_str(self) -> Optional[str]:
        """The mesh shape "DxM" (None on one device)."""
        if self.mesh is None:
            return None
        return f"{mesh_sizes(self.mesh).get('data', 1)}x{self._tp}"

    def _weight_specs(self, w):
        """Specs placing a serving weight tree on the mesh: packed trees
        through ``packed_param_specs``, dense ones through the logical
        rules."""
        axes = param_axes(self.api.cfg)
        if any(is_packed_leaf(leaf) for _, leaf in flatten_paths(w)):
            return packed_param_specs(w, axes, self.mesh)
        return param_specs(axes, w, self.mesh)

    # ---- weights ----------------------------------------------------------
    def _serves_packed(self, fmt_name: str) -> bool:
        return self.packed and fmt_name != DENSE_BF16

    def weights_for(self, fmt_name: str):
        """Serving weights at ``fmt_name`` (packed containers by default).
        A miss costs one Slice-and-Scale pass from the anchor (+ nibble
        packing at 4 bits); hits are free."""
        if fmt_name not in self._weights:
            if self._serves_packed(fmt_name):
                w = make_packed_params(self.anchor, target_fmt=fmt_name,
                                       dtype=self.api.cfg.compute_dtype)
            else:
                w = self.dense_weights_for(fmt_name)
            if self.mesh is not None:
                self._weight_bytes[fmt_name] = weight_stream_bytes(w)
                # split-N int4 nibbles interleave the output halves: a
                # column-sharded leaf is repacked per shard before the cut
                # (repack_splitn_for_tp), or half of every head's and
                # ff-block's columns would pair wrong
                specs = self._weight_specs(w)
                w = local_shard(repack_splitn_for_tp(w, specs, self.mesh),
                                specs, self.mesh)
            self._weights[fmt_name] = w
            self._fmt_swaps += 1
            if self.policy.cost is not None:
                # the analytic weight term becomes the bytes the cached
                # tree streams (seed() keeps a learned factor); on a mesh
                # both terms are per chip
                self.policy.cost.seed(
                    fmt_name, weight_stream_bytes_local(w),
                    self._attn_read_span * self._attn_token_bytes_chip)
        return self._weights[fmt_name]

    def dense_weights_for(self, fmt_name: str):
        """Dense weights at ``fmt_name`` — numerically the packed tree's
        (same codes, dequantized ahead of time). Not cached."""
        model = self.anchor
        if fmt_name not in (DENSE_BF16, self.anchor.fmt_name):
            model = convert(self.anchor,
                            get_format(fmt_name, self._block_size))
        return materialize(model, dtype=self.api.cfg.compute_dtype)

    def set_format(self, fmt_name: str):
        self.current_fmt = fmt_name
        return self.weights_for(fmt_name)

    def _api_for(self, fmt_name: str) -> ModelApi:
        return self._packed_api if self._serves_packed(fmt_name) \
            else self._plain_api

    # ---- KV cache and the ticks' static buffers -------------------------
    def _init_cache(self, b: int, device=None, api=None):
        """The cache of ``api`` (default: the step functions' model, whose
        kv heads are the local ones on a mesh)."""
        device = device or self.device
        api = api or self._src_api
        if self.kv_layout == "paged":
            return api.init_cache(
                b, self.max_len, device=device, kv_layout="paged",
                page_size=self.kv_page_size, num_pages=self.kv_num_pages)
        return api.init_cache(b, self.max_len, device=device)

    def _wave_state(self):
        """The KV cache, ``cache_len`` (B,) and the tokens (B, 1): allocated
        at the first wave, zeroed in place at every later one, so a wave
        starts as from fresh zeros and a captured tick finds them where it
        was captured."""
        b = self.slots
        if self._cache is None:
            self._cache = self._init_cache(b)
            self._cache_len = torch.zeros(b, dtype=torch.int32,
                                          device=self.device)
            self._tokens = torch.zeros((b, 1), dtype=torch.int32,
                                       device=self.device)
            self._state_copy = [torch.empty_like(t)
                                for t in self._state_leaves()]
        else:
            for c in self._cache["blocks"]:
                for t in c.values():
                    t.zero_()
            if "block_table" in self._cache:
                self._cache["block_table"].zero_()
            self._cache_len.zero_()
            self._tokens.zero_()
        return self._cache, self._cache_len, self._tokens

    def _state_leaves(self) -> List[torch.Tensor]:
        """The recurrent layers' state buffers: Mamba's ``h`` and ``conv``,
        RWKV's ``shift_t``, ``wkv`` and ``shift_c`` (none for a
        pure-attention stack)."""
        return [c[k] for c in self._cache["blocks"]
                for k in ("h", "conv", "shift_t", "wkv", "shift_c") if k in c]

    def _keep_state(self) -> None:
        """Copy the recurrent state aside before a guarded tick."""
        for dst, src in zip(self._state_copy, self._state_leaves()):
            dst.copy_(src)

    def _rewind_state(self) -> None:
        """Put the kept state back before a replay: a decode tick rewrites
        it in place, and a replay must not apply the recurrence twice."""
        for dst, src in zip(self._state_leaves(), self._state_copy):
            dst.copy_(src)

    def _batch_bufs(self, bufs: Dict[int, Dict[str, torch.Tensor]],
                    width: int) -> Dict[str, torch.Tensor]:
        """A multi-query tick's inputs at width ``width``: tokens (B,
        width) and q_len (B,), one pair per width for the engine's
        lifetime."""
        if width not in bufs:
            bufs[width] = {
                "tokens": torch.zeros((self.slots, width), dtype=torch.int32,
                                      device=self.device),
                "q_len": torch.zeros(self.slots, dtype=torch.int32,
                                     device=self.device)}
        return bufs[width]

    def _mixed_batch(self, width: int) -> Dict[str, torch.Tensor]:
        """The mixed tick's inputs at chunk width ``width``."""
        return self._batch_bufs(self._mixed_bufs, width)

    def _verify_batch(self, width: int) -> Dict[str, torch.Tensor]:
        """The verify's inputs at width ``width`` = k_eff + 1."""
        return self._batch_bufs(self._verify_bufs, width)

    def _draft_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The draft cursor (B,) and tokens (B, 1), kept for the engine's
        lifetime: a burst copies the committed ``cache_len`` / tokens in
        and advances these, so the committed ones (which the decode
        graphs read) never move during a burst."""
        if self._draft_len is None:
            self._draft_len = torch.zeros_like(self._cache_len)
            self._draft_tok = torch.zeros_like(self._tokens)
        return self._draft_len, self._draft_tok

    def _tick(self, kind: str, fmt: str, width: int, batch, cache,
              cache_len) -> torch.Tensor:
        """The logits of one decode (``kind="serve_step"``), mixed
        (``"mixed_step"``), draft (``"draft_step"``: a ``serve_step``
        against the draft buffers) or verify (``"verify_step"``) tick at
        ``fmt``: eager launches, or a CUDA graph keyed by (kind, format, KV
        layout, width). A graph reads the weight tree where it lies: trees
        stay in ``_weights`` for the engine's lifetime."""
        weights = self.weights_for(fmt)
        fn = getattr(self._api_for(fmt), _ENTRY.get(kind, kind))

        def step():
            return fn(weights, batch, cache, cache_len)[0]

        if self._graphs is None:
            return step()
        return self._graphs.run((kind, fmt, self.kv_layout, width), step)

    def _alloc_pages(self, free: List[int], n: int, why: str) -> List[int]:
        """Pop ``n`` physical pages off the free list, or raise
        ``RuntimeError``; ``generate`` contains the exhaustion (requeue an
        admission, or retire the largest page-holder). The injector's
        ``fail_allocs`` raises ``InjectedFault`` (a ``RuntimeError``) here,
        keyed by this call's index, so chaos takes the same paths."""
        self._alloc_calls += 1
        if self._fault_injector is not None:
            self._fault_injector.on_alloc(self._alloc_calls - 1)
        if len(free) < n:
            raise RuntimeError(
                f"KV page pool exhausted at {why}: need {n} page(s), "
                f"{len(free)} free (pool = {self._kv_total_pages} pages x "
                f"{self.kv_page_size} tokens, {self.slots} slots, "
                f"{self._kv_pages_hwm} pages high-water). Increase "
                "kv_num_pages, shrink batch_slots/max_len, or admit less.")
        got = [free.pop() for _ in range(n)]
        self._kv_pages_alloc += n
        in_use = self._kv_total_pages - 1 - len(free)
        self._kv_pages_hwm = max(self._kv_pages_hwm, in_use)
        return got

    def _nan_pool_page(self, page: int) -> None:
        """NaN-fill physical page ``page`` of every layer's K/V pool, in
        place (captured ticks read these pools where they lie): injected
        persistent corruption. A replay reads it again, so only escalation
        or retiring the rows that map it clears it; a page no row maps is
        harmless, and a recycled one is overwritten by its next prefill."""
        for c in self._cache["blocks"]:
            for name in ("k_pages", "v_pages"):
                c[name][:, page] = float("nan")

    def _free_slot_pages(self, free: List[int], bt: np.ndarray,
                         slot: int) -> None:
        """Return a slot's pages to the free list and point its block-table
        row at scratch page 0, so any further masked write from the
        still-batched slot lands there, never on a recycled page."""
        used = bt[slot][bt[slot] != 0]
        free.extend(int(p) for p in used)
        self._kv_pages_freed += used.size
        bt[slot, :] = 0

    @staticmethod
    def _capacity_victim(active: List[Optional[Request]],
                         bt: np.ndarray) -> Optional[int]:
        """Slot to retire when decode starves the pool with no admission to
        roll back: the largest page-holder (ties -> lowest slot)."""
        best, best_pages = None, 0
        for j, r in enumerate(active):
            if r is None:
                continue
            held = int((bt[j] != 0).sum())
            if held > best_pages:
                best, best_pages = j, held
        return best

    # ---- admission --------------------------------------------------------
    @property
    def prompt_capacity(self) -> int:
        """Longest admissible prompt: ``max_len - 1`` tokens (the first
        generated token's KV is written at position ``plen``)."""
        return self.max_len - 1

    def _prefill_batch(self, prompt: np.ndarray):
        """Tokens (and, when bucketing, the true length) of one admission."""
        plen = prompt.size
        if not self._bucket:
            return {"tokens": torch.as_tensor(prompt[None],
                                              device=self.device)}
        padded = np.zeros(_bucket_len(plen, self.prompt_capacity), np.int32)
        padded[:plen] = prompt
        return {"tokens": torch.as_tensor(padded[None], device=self.device),
                "lengths": torch.tensor([plen], dtype=torch.int32,
                                        device=self.device)}

    def _finish(self, r: Request, status: RequestStatus,
                error: Optional[str] = None) -> None:
        """Terminal transition, one per request; a non-COMPLETED one is
        recorded in ``stats()["failures"]``."""
        r.status, r.done = status, True
        if error is not None:
            r.error = error
        self._status_counts[status.value] = \
            self._status_counts.get(status.value, 0) + 1
        if status is not RequestStatus.COMPLETED:
            self._failures.append({"rid": r.rid, "status": status.value,
                                   "error": error})

    def _max_pages_needed(self, plen: int) -> int:
        """Peak page count one request's admission holds: the pages of the
        (bucket-padded) prompt plus the first decode write; under chunked
        admission the peak is at the final chunk."""
        ps = self.kv_page_size
        chunk = self.prefill_chunk
        if chunk is None:
            blen = _bucket_len(plen, self.prompt_capacity) if self._bucket \
                else plen
            return max(-(-blen // ps), plen // ps + 1)
        start = ((plen - 1) // chunk) * chunk        # final chunk's cursor
        take = plen - start
        padded = _bucket_len(take, chunk) if self._bucket else take
        end = min(start + padded, self.max_len)
        return max(-(-end // ps), plen // ps + 1)

    def _admission_reject(self, r: Request) -> Optional[str]:
        """Why this request can never be served (None = admissible): a
        prompt past cache capacity, or (paged) a page demand beyond the
        whole pool even when empty."""
        plen = int(np.asarray(r.prompt).size)
        if plen > self.prompt_capacity:
            return (f"prompt ({plen} tokens) exceeds capacity "
                    f"({self.prompt_capacity} = max_len - 1)")
        if self.kv_layout == "paged":
            need = self._max_pages_needed(plen)
            allocatable = self._kv_total_pages - 1    # page 0 is scratch
            if need > allocatable:
                return (f"prompt ({plen} tokens) needs {need} KV page(s) "
                        f"at its admission peak; the pool has only "
                        f"{allocatable} allocatable")
        return None

    def _pop_admissible(self, pending: List[Request],
                        tick: int) -> Optional[Request]:
        """Next servable request that has arrived by ``tick``
        (``Request.arrival_tick``) off the queue, stamped with its
        ``admitted_tick``; unservable ones end FAILED_CAPACITY right here.
        ``"fifo"`` takes the earliest queued, ``"slo"`` the least (tier
        rank, queue position): FIFO within a tier."""
        while True:
            best_key, idx = None, None
            for j, r in enumerate(pending):
                if r.arrival_tick > tick:
                    continue
                key = (tier_rank(r.slo), j) \
                    if self.admission_order == "slo" else (0, j)
                if best_key is None or key < best_key:
                    best_key, idx = key, j
            if idx is None:
                return None
            r = pending.pop(idx)
            reason = self._admission_reject(r)
            if reason is None:
                r.admitted_tick = tick
                return r
            self._finish(r, RequestStatus.FAILED_CAPACITY, reason)

    # ---- the logit guard --------------------------------------------------
    def _escalate_or_none(self, fmt: str, tick: int,
                          what: str) -> Optional[str]:
        """One rung toward the anchor, quarantining the rung that just
        misbehaved so later waves never pick it; None at the anchor (the
        caller then retires the dead rows)."""
        nxt = self.policy.escalate(fmt)
        if nxt is None:
            return None
        self.policy.quarantine(fmt)
        self._fmt_escalations += 1
        self._escalation_events.append(
            {"tick": tick, "from": fmt, "to": nxt, "at": what})
        self.set_format(nxt)
        return nxt

    # ---- sampling -----------------------------------------------------------
    def _first_draw(self, logits: torch.Tensor, r: Request):
        """The first token of ``r`` from its prefill logits (V,): the argmax,
        or, sampling, one draw with the slot's key reseeded from
        ``fold_in(engine key, rid)`` at the request's temperature and top-p.
        Returns (token (1,), the advanced key (2,) or None)."""
        if not self._sampled:
            return torch.argmax(logits, -1)[None], None
        key = fold_in(self._key, r.rid).to(self.device)
        keys, tok = sample_batch(
            key[None], logits[None],
            torch.tensor([self._temp_of(r)], dtype=torch.float32,
                         device=self.device),
            torch.tensor([self._top_of(r)], dtype=torch.float32,
                         device=self.device))
        return tok, keys[0]

    def _temp_of(self, r: Request) -> float:
        return self.temperature if r.temperature is None else r.temperature

    def _top_of(self, r: Request) -> float:
        return self.top_p if r.top_p is None else r.top_p

    def _batch_draw(self, logits: torch.Tensor):
        """Every row's next token from a tick's logits (B, V): the argmax,
        or, sampling, one draw per slot from the slots' pre-tick keys (a
        CUDA graph of its own where the ticks are graphs). Returns (tokens
        (B,), the advanced keys (B, 2) or None); the keys are committed
        once, after the guard settles."""
        if not self._sampled:
            return torch.argmax(logits, -1), None
        if self._draw_graphs is None:
            keys, toks = sample_batch(self._keys, logits, self._temps,
                                      self._tops)
            return toks, keys
        if self._draw_in is None:
            self._draw_in = torch.empty_like(logits)
        self._draw_in.copy_(logits)
        keys, lg, temps, tops = self._keys, self._draw_in, self._temps, \
            self._tops

        def step():
            # (B, 3) int64: the advanced keys and the tokens, from the
            # lifetime buffers alone
            nxt, toks = sample_batch(keys, lg, temps, tops)
            return torch.cat([nxt, toks[:, None]], dim=1)

        out = self._draw_graphs.run("draw", step)
        return out[:, 2], out[:, :2]

    def _guarded_prefill(self, attempt, r: Request, pinned: str, tick: int,
                         what: str):
        """Escalate-and-replay around one admission executable whose logits
        are consumed (a whole prompt, or a final chunk). ``attempt(fmt)``
        returns ``(logits (V,), cache, new_len)``; ``r``'s first token
        (``_first_draw``) comes back with the finite flag in one host
        transfer. Returns ``(first, key, cache, new_len, pinned,
        fail_reason, execs)``."""
        execs = 0
        while True:
            logits, cache, new_len = attempt(pinned)
            execs += 1
            tok, key = self._first_draw(logits, r)
            first, finite = torch.cat([
                tok, torch.isfinite(logits).all()[None].to(tok.dtype)]) \
                .tolist()
            if finite:
                return first, key, cache, new_len, pinned, None, execs
            self._nonfinite_rows += 1
            if not self.logit_guard:
                return first, key, cache, new_len, pinned, None, execs
            self._faults_detected += 1
            nxt = self._escalate_or_none(pinned, tick, what)
            if nxt is None:
                return first, key, cache, new_len, pinned, (
                    f"non-finite prefill logits at the anchor rung "
                    f"({pinned}) during {what}"), execs
            pinned = nxt
            self._ticks_replayed += 1

    def _drain_tick(self, logits: torch.Tensor, admit) -> _Drain:
        """A decode or mixed attempt's logits (B, V) drained in one host
        copy: finite flags, the completing admission's first draw, then the
        batch draw (``_guarded_step``)."""
        b = self.slots
        finite = torch.isfinite(logits).all(-1)
        first_tok = first_key = None
        if admit is not None and self._sampled:
            first_tok, first_key = self._first_draw(logits[admit[0]],
                                                    admit[1])
        nxt, keys = self._batch_draw(logits)
        parts = [nxt, finite.to(nxt.dtype)]
        if first_tok is not None:
            parts.append(first_tok)
        host = torch.cat(parts).cpu().numpy()
        drain = _Drain(nxt, host[:b], host[b:2 * b], keys=keys,
                       first_key=first_key)
        if admit is not None:
            drain.first = int(host[2 * b]) if first_tok is not None \
                else int(host[admit[0]])
        return drain

    def _drain_verify(self, logits: torch.Tensor) -> _Drain:
        """A verify attempt's logits (B, C, V) drained in one host copy:
        every lane's argmax (B, C) and each row's finite flag over all its
        lanes."""
        b, c = logits.shape[:2]
        host = torch.cat([
            torch.argmax(logits, -1).reshape(-1),
            torch.isfinite(logits).all(-1).all(-1).to(torch.int64)]) \
            .cpu().numpy()
        return _Drain(None, host[:b * c].reshape(b, c), host[b * c:])

    def _guarded_step(self, attempt, pinned: str, consumed: List[int],
                      tick: int, admit=None, verify: bool = False):
        """Escalate-and-replay around one decode, mixed or (``verify``)
        speculative verify tick.

        Every attempt is a function of the pre-tick ``(cache_len, tokens)``,
        slot keys and recurrent state: the caller commits the cache_len
        advance, the next tokens, the keys and the drain only after this
        returns, a replay overwrites whatever KV an attempt wrote at
        positions >= cache_len, on either layout, and a Mamba state, kept
        aside before the first attempt, is put back before each replay. An ``InjectedFault`` raised before dispatch is
        retried at the same format, up to ``max_step_retries`` times, then
        re-raised. ``admit``, (row, request), names a mixed tick's completing
        admission, whose first token is drawn here too. A verify attempt
        overwrites every draft-written position before it attends, so its
        replay is a function of the committed state too, and never re-runs
        the drafts. Returns ``(drain, cache, pinned, dead_rows, execs)``;
        ``dead_rows`` is non-empty only at the anchor rung.

        Under CUDA graphs an attempt's logits are a graph's static output,
        which the next replay of any tick graph may overwrite: each attempt
        drains them here (``_drain_tick`` / ``_drain_verify``, read off the
        injector's poisoned copy when it fires) in one host copy before the
        next one runs.
        """
        execs = 0
        retries = 0
        self._keep_state()
        while True:
            try:
                logits, cache = attempt(pinned)
            except InjectedFault:
                self._faults_detected += 1
                if retries >= self.max_step_retries:
                    raise
                retries += 1
                self._ticks_replayed += 1
                self._rewind_state()
                continue
            execs += 1
            drain = self._drain_verify(logits) if verify \
                else self._drain_tick(logits, admit)
            dead = [i for i in consumed if not drain.finite[i]]
            self._nonfinite_rows += len(dead)
            if not dead or not self.logit_guard:
                return drain, cache, pinned, [], execs
            self._faults_detected += 1
            fmt = self._escalate_or_none(pinned, tick, f"decode tick {tick}")
            if fmt is None:
                return drain, cache, pinned, dead, execs
            pinned = fmt
            self._ticks_replayed += 1
            self._rewind_state()

    # ---- serving loop -----------------------------------------------------
    @torch.no_grad()
    def generate(self, requests: List[Request], greedy: bool = True,
                 fmt_override: Optional[str] = None, *, guard=None,
                 snapshot_dir: Optional[str] = None,
                 _state: Optional[dict] = None) -> List[Request]:
        """Serve requests to completion with slot-level continuous
        batching: greedy decoding, or (``greedy=False``) temperature /
        top-p draws from per-slot streams (module docstring).

        Slot lifecycle: free -> prefilling (one whole prompt, or chunk by
        chunk with the cursor on the host) -> decoding -> retired. With
        ``prefill_chunk`` at most one slot is mid-prefill and each tick runs
        at most one chunk: under ``"mixed"`` inside the decode batch (one
        executable per tick; a chunk with no slot decoding runs alone and
        ends the tick), under ``"sequential"`` before it. On the paged
        layout the pages of a prompt (of a chunk) are allocated at its
        admission, a decoding slot's next page just before the tick that
        writes into it, and all of a slot's pages return at retire.
        Executables whose logits are consumed run under the logit guard
        (class docstring); a replay adds to the tick's ``execs``. At each
        tick boundary, before any executable runs, a triggered ``guard``
        (a ``PreemptionGuard``) snapshots the wave to ``snapshot_dir`` (if
        given) and returns it incomplete, then cancelled and expired
        requests retire and an injected pool poison lands. An
        ``InjectedFault`` past the step-retry budget escapes.
        ``tick_trace`` records each tick's work. ``_state`` is ``resume``'s
        way back in; callers never pass it.
        """
        if self.speculative is not None and not greedy:
            raise ValueError(
                "speculative decoding is greedy-only: the acceptance rule "
                "compares greedy argmaxes token-for-token; build the "
                "engine without speculative= for sampled decoding")
        self._sampled = not greedy and self.temperature > 0
        b = self.slots
        paged = self.kv_layout == "paged"
        chunk = self.prefill_chunk
        ps = self.kv_page_size
        window = self.api.cfg.sliding_window
        dev = self.device
        fi = self._fault_injector
        if _state is None:
            pending = list(requests)
            active: List[Optional[Request]] = [None] * b
            slot_len = [0] * b          # host mirror of cache_len
            cache, cache_len, tokens = self._wave_state()
            pinned: Optional[str] = None    # format for this batch's lifetime
            filling: Optional[Request] = None   # the (single) mid-prefill
            fill_slot, fill_cursor = -1, 0
            wait_pages = False  # a requeued admission waits for a retire
            elapsed0 = 0.0
            tick_no = 0     # per-wave scheduler tick: keys the injector and
            #                 survives snapshot / resume
            if paged:
                # page 0 is reserved scratch; allocatable pages 1..P-1
                free_pages = list(range(self._kv_total_pages - 1, 0, -1))
                bt = np.zeros(tuple(cache["block_table"].shape), np.int32)
            else:
                free_pages, bt = [], None
        else:
            # resume(): the arrays are already in the lifetime buffers
            cache, cache_len, tokens = self._cache, self._cache_len, \
                self._tokens
            pending = _state["pending"]
            active = _state["active"]
            slot_len = _state["slot_len"]
            pinned = _state["pinned"]
            filling = _state["filling"]
            fill_slot = _state["fill_slot"]
            fill_cursor = _state["fill_cursor"]
            wait_pages = _state["wait_pages"]
            free_pages = _state["free_pages"]
            bt = _state["bt"]
            elapsed0 = _state["elapsed_s"]
            tick_no = _state["tick_no"]
        t0 = time.perf_counter() - elapsed0   # deadlines span resumes
        self.tick_trace = []

        def sync_table() -> None:
            cache["block_table"].copy_(torch.from_numpy(bt))

        def release_slot(i: int) -> None:
            nonlocal wait_pages
            if paged:
                self._free_slot_pages(free_pages, bt, i)
                sync_table()
            wait_pages = False     # freed pages: admission may retry

        def repin(fmt: str) -> str:
            # escalation mid-wave: every live request now decodes at fmt
            for a in active:
                if a is not None:
                    a.fmt_used = fmt
            return fmt

        def complete_admission(i: int, r: Request, first: int,
                               key: Optional[torch.Tensor]) -> None:
            """prefilling -> decoding (or straight to retired): the first
            token from the prefill logits, TTFT stamped. Sampling, the
            slot's key restarts from (seed, rid), already advanced past the
            first draw, and its lanes take the request's parameters."""
            if key is not None:
                self._keys[i].copy_(key)
                self._temps[i] = self._temp_of(r)
                self._tops[i] = self._top_of(r)
            tokens[i, 0] = first
            r.fmt_used = pinned
            r.out_tokens.append(first)
            r.ttft_s = time.perf_counter() - t0
            self._tokens_out += 1
            if len(r.out_tokens) >= r.max_new:
                self._finish(r, RequestStatus.COMPLETED)
                release_slot(i)
            else:
                r.status = RequestStatus.RUNNING
                active[i] = r

        def poisoned(logits, tick: int, fmt: str):
            return logits if fi is None \
                else fi.maybe_poison_logits(tick, fmt, logits)

        def run_prefill(fn, *args):
            t_pf = time.perf_counter()
            out = fn(*args)
            self._prefill_s += time.perf_counter() - t_pf
            self._prefills += 1
            return out

        def expired(r: Request, now: float):
            if r.cancel_requested:
                return RequestStatus.CANCELLED, "cancelled by client"
            if r.deadline_s is not None and now > r.deadline_s:
                return (RequestStatus.TIMED_OUT,
                        f"deadline {r.deadline_s:.3f}s exceeded "
                        f"({now:.3f}s into the wave)")
            return None

        while pending or filling is not None \
                or any(a is not None for a in active):
            t_tick = time.perf_counter()
            # ---- tick boundary: a preemption (a signal, or the injector's
            # mid-tick trigger) is acted on here, with nothing in flight and
            # the host state consistent: snapshot, hand the wave back
            if guard is not None and guard.preempted:
                if snapshot_dir is not None:
                    self.last_snapshot = self._save_snapshot(
                        snapshot_dir, requests, dict(
                            pending=pending, active=active,
                            slot_len=slot_len, pinned=pinned,
                            filling=filling, fill_slot=fill_slot,
                            fill_cursor=fill_cursor, wait_pages=wait_pages,
                            free_pages=free_pages, bt=bt,
                            elapsed_s=time.perf_counter() - t0,
                            tick_no=tick_no),
                        greedy, fmt_override)
                    self._snapshots_saved += 1
                return requests
            # one profiler range per scheduler tick, closed by _record_tick:
            # a trace reads the card's busy share of each tick from it
            span = torch.profiler.record_function("ElasticEngine.tick")
            span.__enter__()
            tick_id = tick_no
            tick_no += 1
            # ---- tick boundary: cancellations (client or injector) and
            # deadlines over queued, mid-prefill and decoding requests; each
            # is one terminal status with its pages freed
            if fi is not None:
                rid = fi.cancel_rid(tick_id)
                if rid is not None:
                    for r in pending + [a for a in active if a] + \
                            ([filling] if filling is not None else []):
                        if r.rid == rid:
                            r.cancel_requested = True
            now = time.perf_counter() - t0
            for r in list(pending):
                if r.arrival_s is None and r.arrival_tick <= tick_id:
                    r.arrival_s = now       # came due: SLO TTFT counts
                    #                         from here
                verdict = expired(r, now)
                if verdict is not None:
                    pending.remove(r)
                    self._finish(r, *verdict)
            if filling is not None:
                verdict = expired(filling, now)
                if verdict is not None:
                    release_slot(fill_slot)
                    self._finish(filling, *verdict)
                    filling = None
            for i, r in enumerate(active):
                if r is not None:
                    verdict = expired(r, now)
                    if verdict is not None:
                        active[i] = None
                        release_slot(i)
                        self._finish(r, *verdict)
            if not (pending or filling is not None
                    or any(a is not None for a in active)):
                span.__exit__(None, None, None)
                break               # the sweep drained the wave
            # injected pool corruption lands before any executable runs
            if fi is not None and paged:
                page = fi.pool_poison_page(tick_id)
                if page is not None:
                    self._nan_pool_page(page)
            # arrival gating: nothing live and every queued request still
            # in the future makes this an idle tick
            if filling is None and not any(a is not None for a in active) \
                    and not any(r.arrival_tick <= tick_id for r in pending):
                pinned = None
                self._record_tick(dict(prefill_tokens=0, prefill_chunks=0,
                                       execs=0, rows=0), 0, t_tick, span,
                                  decode_rows=0)
                continue
            if pinned is None:          # engine drained: re-pick format
                # load, the tightest TPOT budget and the expected decode
                # rows of the ARRIVED requests
                arrived = [r for r in pending if r.arrival_tick <= tick_id]
                pinned = self.policy.pick(
                    queue_depth=len(arrived), active=0,
                    prefill_tokens=sum(np.asarray(r.prompt).size
                                       for r in arrived),
                    tpot_budget_ms=self._tightest_tpot_ms(arrived),
                    decode_rows=max(1, min(b, len(arrived))),
                    override=fmt_override)
            self.set_format(pinned)
            tick = dict(prefill_tokens=0, prefill_chunks=0, execs=0, rows=0)
            chunk_tok = None            # staged chunk for the mixed tick
            chunk_ran_alone = False

            if chunk is None:
                # ---- monolithic admission: one whole prompt per free slot
                for i in range(b):
                    if active[i] is not None or wait_pages:
                        continue
                    r = self._pop_admissible(pending, tick_id)
                    if r is None:
                        break
                    r.status = RequestStatus.RUNNING
                    prompt = np.asarray(r.prompt, np.int32)
                    pbatch = self._prefill_batch(prompt)
                    blen = pbatch["tokens"].shape[1]
                    if paged:
                        # the bucket-padded prompt and the first decode write
                        need = max(-(-blen // ps), prompt.size // ps + 1)
                        try:
                            got = self._alloc_pages(
                                free_pages, need, f"admission of rid={r.rid}")
                        except RuntimeError as e:
                            # admission never outranks running work: requeue
                            # and wait for a retire (the whole-pool check in
                            # _pop_admissible guarantees the wait ends); an
                            # injected failure retries next tick; a real one
                            # with nothing running means the free list
                            # leaked — raise
                            r.status = RequestStatus.QUEUED
                            pending.insert(0, r)
                            self._admission_requeues += 1
                            if isinstance(e, InjectedFault):
                                break
                            if not any(a is not None for a in active):
                                raise
                            wait_pages = True
                            break
                        bt[i, :need] = got
                        sync_table()

                    def attempt(fmt, pb=pbatch, slot=i):
                        lg, c2, nl = run_prefill(
                            self._api_for(fmt).prefill_slot,
                            self.weights_for(fmt), pb, cache, slot)
                        return poisoned(lg, tick_id, fmt), c2, nl

                    first, key, cache, new_len, new_pinned, fail, execs = \
                        self._guarded_prefill(attempt, r, pinned, tick_id,
                                              f"prefill of rid={r.rid}")
                    if new_pinned != pinned:
                        pinned = repin(new_pinned)
                    tick["prefill_tokens"] += blen
                    tick["prefill_chunks"] += 1
                    tick["execs"] += execs
                    tick["rows"] += execs
                    if fail is not None:
                        release_slot(i)
                        self._finish(r, RequestStatus.FAILED_NUMERIC, fail)
                        continue
                    cache_len[i] = new_len
                    slot_len[i] = prompt.size
                    complete_admission(i, r, first, key)
            else:
                # ---- chunked admission: claim the (single) mid-prefill
                # request and allocate this chunk's pages
                if filling is None and not wait_pages and None in active:
                    cand = self._pop_admissible(pending, tick_id)
                    if cand is not None:
                        fill_slot = active.index(None)
                        filling, fill_cursor = cand, 0
                        filling.status = RequestStatus.RUNNING
                        # the mixed tick reads the fill row's cursor from
                        # cache_len: drop the previous occupant's value
                        cache_len[fill_slot] = 0
                if filling is not None:
                    r, i = filling, fill_slot
                    prompt = np.asarray(r.prompt, np.int32)
                    plen = prompt.size
                    start = fill_cursor
                    take = min(chunk, plen - start)
                    final = start + take >= plen
                    padded = take if (final and not self._bucket) else \
                        (_bucket_len(take, chunk) if final else chunk)
                    padded = min(padded, self.max_len - start)
                    ok = True
                    if paged:
                        # this chunk's pages only; the first decode write's
                        # page is the decode tick's job
                        first_pg = start // ps
                        last_pg = -(-(start + padded) // ps)
                        try:
                            got = self._alloc_pages(
                                free_pages, last_pg - first_pg,
                                f"prefill chunk at {start} of rid={r.rid}")
                            bt[i, first_pg:last_pg] = got
                        except RuntimeError as e:
                            # a partial admission must not starve the pool:
                            # release what it holds, requeue, retry after a
                            # retire (an injected failure: next tick); with
                            # nothing running, raise
                            self._free_slot_pages(free_pages, bt, i)
                            r.status = RequestStatus.QUEUED
                            pending.insert(0, r)
                            filling = None
                            self._admission_requeues += 1
                            ok = False
                            if isinstance(e, InjectedFault):
                                pass
                            elif any(a is not None for a in active):
                                wait_pages = True
                            else:
                                raise
                        sync_table()
                    if ok:
                        ctoks = np.zeros(padded, np.int32)
                        ctoks[:take] = prompt[start:start + take]
                        chunk_tok = (start, take, padded, final)

                # The staged chunk runs as its own executable under the
                # sequential scheduler, and when no slot is decoding.
                if chunk_tok is not None and (
                        self.scheduler == "sequential"
                        or not any(a is not None for a in active)):
                    chunk_ran_alone = True
                    start, take, padded, final = chunk_tok
                    pbatch = {"tokens": torch.as_tensor(ctoks[None],
                                                        device=dev),
                              "lengths": torch.tensor([plen],
                                                      dtype=torch.int32,
                                                      device=dev)}

                    def attempt(fmt, pb=pbatch, slot=i, st=start):
                        # a non-final chunk's logits are never consumed, so
                        # a poison landing there is invisible
                        lg, c2, nl = run_prefill(
                            self._api_for(fmt).prefill_chunk_slot,
                            self.weights_for(fmt), pb, cache, slot, st)
                        return poisoned(lg, tick_id, fmt), c2, nl

                    fail = None
                    if final:
                        (first, key, cache, new_len, new_pinned, fail,
                         execs) = self._guarded_prefill(
                            attempt, r, pinned, tick_id,
                            f"final chunk of rid={r.rid}")
                        if new_pinned != pinned:
                            pinned = repin(new_pinned)
                    else:
                        _, cache, new_len = attempt(pinned)
                        execs = 1
                    tick["prefill_tokens"] += padded
                    tick["prefill_chunks"] += 1
                    tick["execs"] += execs
                    tick["rows"] += execs
                    if fail is not None:
                        release_slot(i)
                        self._finish(r, RequestStatus.FAILED_NUMERIC, fail)
                        filling = None
                    else:
                        cache_len[i] = new_len
                        fill_cursor = start + take
                        if final:
                            slot_len[i] = plen
                            complete_admission(i, r, first, key)
                            filling = None
                    chunk_tok = None

            # an injected preemption fires mid-tick; the guard is acted on
            # at the next tick boundary, as a real signal is
            if fi is not None and guard is not None:
                fi.maybe_preempt(tick_id, guard)

            all_free = all(a is None for a in active)
            if all_free or (chunk_ran_alone and self.scheduler == "mixed"):
                # No decode this tick. Under the mixed scheduler a chunk that
                # ran alone ends the tick: the new slot's first decode is
                # next tick's (one) executable.
                self._record_tick(tick, 0, t_tick, span, decode_rows=0)
                if all_free and filling is None:
                    pinned = None       # drained; the next wave re-picks
                continue

            # ---- decode tick: map the page each decoding slot writes into
            # before the step runs (where exhaustion surfaces mid-stream)
            if paged:
                dirty = False
                for i in range(b):
                    r = active[i]
                    if r is None:
                        continue
                    pg = slot_len[i] // ps
                    while active[i] is not None and bt[i, pg] == 0:
                        dirty = True
                        try:
                            bt[i, pg] = self._alloc_pages(
                                free_pages, 1, f"decode tick for rid={r.rid}")[0]
                        except RuntimeError as e:
                            if filling is not None:
                                # a decoding slot outranks a partial
                                # admission: release it, requeue, retry
                                self._free_slot_pages(free_pages, bt,
                                                      fill_slot)
                                filling.status = RequestStatus.QUEUED
                                pending.insert(0, filling)
                                filling = None
                                chunk_tok = None
                                self._admission_requeues += 1
                                wait_pages = True
                                continue
                            # nothing to roll back: the largest page-holder
                            # retires FAILED_CAPACITY, the rest keep serving
                            victim = self._capacity_victim(active, bt)
                            if victim is None:
                                raise       # free-list invariant breach
                            vr = active[victim]
                            held = int((bt[victim] != 0).sum())
                            active[victim] = None
                            self._free_slot_pages(free_pages, bt, victim)
                            wait_pages = False
                            self._finish(
                                vr, RequestStatus.FAILED_CAPACITY,
                                f"KV pool exhausted at decode; retired as "
                                f"largest page-holder ({held} page(s)) "
                                f"after {len(vr.out_tokens)} token(s): {e}")
                if dirty:
                    sync_table()
            if chunk_tok is None and all(a is None for a in active):
                # victim retirement emptied the batch
                self._record_tick(tick, 0, t_tick, span, decode_rows=0)
                if filling is None:
                    pinned = None
                continue

            mask = np.asarray([a is not None for a in active], np.int32)
            # the rows whose logits this tick consumes: the guard checks
            # exactly these (free and masked rows may hold anything)
            consumed = [i for i in range(b) if active[i] is not None]
            if chunk_tok is not None and chunk_tok[3]:
                consumed.append(fill_slot)
            t_dec = time.perf_counter()

            # ---- speculative decode tick: k_eff draft steps at the cheap
            # rung against the draft cursor, one guarded verify at the
            # pinned format over the k_eff + 1 positions of every slot,
            # commit the longest matching prefix plus the bonus token, and
            # rewind the rest. Only on pure decode ticks, and only while the
            # policy says drafting pays.
            sc = self.speculative
            spec_now = sc is not None and chunk_tok is None and bool(consumed)
            if spec_now:
                tot = self._spec_accepted + self._spec_rejected
                rate = (self._spec_accepted / tot
                        if self._spec_ticks >= sc.window and tot else None)
                spec_now = self.policy.allow_speculation(
                    sc.draft_fmt, pinned, rate, sc.min_acceptance)
            if spec_now:
                # the burst never writes past the cache (the verify's write
                # frontier is slot_len + k_eff <= max_len - 1) and never
                # drafts deeper than the hungriest slot can still commit
                buds = {i: min(active[i].max_new - len(active[i].out_tokens),
                               self.prompt_capacity - slot_len[i])
                        for i in consumed}
                k_eff = min(sc.k,
                            self.max_len - 1
                            - max(slot_len[i] for i in consumed),
                            max(buds.values()) - 1)
                spec_now = k_eff >= 1
            if spec_now and paged:
                # draft-ahead pages for positions slot_len .. slot_len +
                # k_eff, beyond the decode page mapped above; speculation
                # outranks nothing: on starvation they go back and the
                # tick runs plain
                spec_extra = []
                try:
                    for i in consumed:
                        for pg in range(slot_len[i] // ps + 1,
                                        (slot_len[i] + k_eff) // ps + 1):
                            if bt[i, pg] == 0:
                                bt[i, pg] = self._alloc_pages(
                                    free_pages, 1, f"spec draft-ahead for "
                                    f"rid={active[i].rid}")[0]
                                spec_extra.append((i, pg))
                except RuntimeError:
                    for i, pg in spec_extra:
                        free_pages.append(int(bt[i, pg]))
                        bt[i, pg] = 0
                        self._kv_pages_freed += 1
                    spec_extra = []
                    self._spec_aborts += 1
                    spec_now = False
                if spec_extra:
                    sync_table()
            if spec_now:
                drafts, drafts_host, draft_execs = self._draft_burst(
                    sc.draft_fmt, k_eff, consumed, mask, tick_id)
                if drafts is None:
                    self._spec_aborts += 1
                    spec_now = False
            if spec_now:
                # ---- verify: one pinned-format executable scores [last
                # committed token, d_1 .. d_k] per slot (q_len k_eff + 1;
                # masked rows ride at q_len 1, as in a mixed tick)
                cdim = k_eff + 1
                vbatch = self._verify_batch(cdim)
                vbatch["tokens"][:, :1].copy_(tokens)
                vbatch["tokens"][:, 1:].copy_(drafts)
                q_np = np.ones(b, np.int32)
                q_np[mask.astype(bool)] = cdim
                vbatch["q_len"].copy_(torch.from_numpy(q_np))

                def vattempt(fmt):
                    if fi is not None:
                        fi.maybe_raise_step(tick_id)    # before dispatch
                    lg = self._tick("verify_step", fmt, cdim, vbatch, cache,
                                    cache_len)
                    return poisoned(lg, tick_id, fmt), cache

                try:
                    drain, cache, new_pinned, dead, vexecs = \
                        self._guarded_step(vattempt, pinned, consumed,
                                           tick_id, verify=True)
                except InjectedFault:
                    span.__exit__(None, None, None)
                    raise
                if new_pinned != pinned:
                    pinned = repin(new_pinned)
                tick["execs"] += draft_execs + vexecs
                tick["rows"] += b * (draft_execs + vexecs)

                # ---- commit: every committed token is the verify format's
                # own argmax (an accepted draft equals it by definition)
                anchor_toks = drain.drained                      # (B, C)
                budgets = np.zeros(b, np.int64)
                for i in consumed:
                    if i not in dead:
                        budgets[i] = buds[i]
                commit = spec_accept_counts(drafts_host, anchor_toks,
                                            budgets)
                cache_len.add_(torch.as_tensor(
                    (commit * mask).astype(np.int32), device=dev))
                nxt = anchor_toks[np.arange(b), np.maximum(commit - 1, 0)]
                tokens.copy_(torch.as_tensor(
                    nxt.astype(np.int32)[:, None], device=dev))
                self._decode_s += time.perf_counter() - t_dec
                self._ticks += 1
                self._spec_ticks += 1
                for i in consumed:
                    if i not in dead:
                        acc = int(commit[i]) - 1
                        self._spec_accepted += acc
                        self._spec_rejected += k_eff - acc

                # attention-read accounting: k_eff single-query walks at a
                # growing cursor plus vexecs multi-query walks per live slot
                for i in range(b):
                    if not (paged and self.attn_impl == "paged_kernel"):
                        self._attn_tokens_read += \
                            self._attn_read_span * (draft_execs + vexecs)
                    elif active[i] is not None:
                        for j in range(draft_execs):
                            self._attn_tokens_read += pages_read(
                                slot_len[i] + 1 + j, ps, window) * ps
                        self._attn_tokens_read += vexecs * pages_read_mq(
                            slot_len[i], cdim, ps, window) * ps
                    elif filling is not None and i == fill_slot:
                        self._attn_tokens_read += \
                            (draft_execs + vexecs) * pages_read(
                                fill_cursor + 1, ps, window) * ps
                    else:
                        self._attn_tokens_read += \
                            (draft_execs + vexecs) * ps

                # dead rows (non-finite verify logits at the anchor rung)
                # retire before the drain; their budget was 0
                for i in dead:
                    r_dead = active[i]
                    if r_dead is None:
                        continue
                    active[i] = None
                    release_slot(i)
                    self._finish(
                        r_dead, RequestStatus.FAILED_NUMERIC,
                        f"non-finite logits in this request's row at the "
                        f"anchor rung ({pinned}), verify tick {tick_id}")

                # ---- drain and rewind: commit[i] tokens enter the stream;
                # pages past the new frontier go back to the free list (no
                # data moves: cache_len masks the stale positions)
                for i, r in enumerate(active):
                    if r is None:
                        continue
                    n_c = int(commit[i])
                    slot_len[i] += n_c
                    r.out_tokens.extend(int(t) for t in anchor_toks[i, :n_c])
                    self._tokens_out += n_c
                    if paged:
                        self._rollback_slot_pages(free_pages, bt, i,
                                                  slot_len[i])
                    if len(r.out_tokens) >= r.max_new or \
                            slot_len[i] >= self.prompt_capacity:
                        self._finish(r, RequestStatus.COMPLETED)
                        active[i] = None
                        release_slot(i)
                if paged:
                    sync_table()
                self._record_tick(tick, 1, t_tick, span,
                                  decode_rows=int(mask.sum()),
                                  draft_execs=draft_execs,
                                  verify_execs=vexecs)
                if all(a is None for a in active) and filling is None:
                    pinned = None
                continue

            if chunk_tok is not None:
                # ---- mixed tick: decode rows carry their token in column
                # 0, the fill row its chunk at its cursor; one executable
                start, take, padded, final = chunk_tok
                mbatch = self._mixed_batch(padded)
                tok2d = mbatch["tokens"]
                tok2d.zero_()
                tok2d[:, 0] = tokens[:, 0]
                tok2d[fill_slot] = torch.as_tensor(ctoks, device=dev)
                q_len = np.ones(b, np.int32)
                q_len[fill_slot] = take
                mbatch["q_len"].copy_(torch.from_numpy(q_len))

                def attempt(fmt):
                    if fi is not None:
                        fi.maybe_raise_step(tick_id)    # before dispatch
                    lg = self._tick("mixed_step", fmt, padded, mbatch, cache,
                                    cache_len)
                    return poisoned(lg, tick_id, fmt), cache

                adv = mask.copy()
                adv[fill_slot] = take
                tick["prefill_tokens"] += padded
                tick["prefill_chunks"] += 1
            else:
                def attempt(fmt):
                    if fi is not None:
                        fi.maybe_raise_step(tick_id)    # before dispatch
                    lg = self._tick("serve_step", fmt, 1, {"tokens": tokens},
                                    cache, cache_len)
                    return poisoned(lg, tick_id, fmt), cache

                adv = mask
            # escalate-and-replay against the pre-tick state; the commits
            # below happen once, after the guard settles
            admit = (fill_slot, filling) \
                if chunk_tok is not None and chunk_tok[3] else None
            try:
                drain, cache, new_pinned, dead, execs = self._guarded_step(
                    attempt, pinned, consumed, tick_id, admit)
            except InjectedFault:
                span.__exit__(None, None, None)    # past the retry budget
                raise
            if new_pinned != pinned:
                pinned = repin(new_pinned)
            tick["execs"] += execs
            tick["rows"] += b * execs
            cache_len.add_(torch.as_tensor(adv, device=dev))
            tokens.copy_(drain.tokens[:, None])
            if drain.keys is not None:
                # every slot's key advanced once; a completing admission
                # reseeds its own below
                self._keys.copy_(drain.keys)
            drained = drain.drained
            self._decode_s += time.perf_counter() - t_dec
            self._ticks += 1
            attn_before = self._attn_tokens_read

            # Attention-read accounting for the tick that just ran. The
            # gather path (and the dense layout) reads every row's whole
            # view; the kernels walk pages_read / pages_read_mq pages of
            # each row with mapped pages, and a free row's walk stays on
            # scratch page 0 (counted once).
            for i in range(b):
                if not (paged and self.attn_impl == "paged_kernel"):
                    self._attn_tokens_read += self._attn_read_span
                elif active[i] is not None:
                    self._attn_tokens_read += \
                        pages_read(slot_len[i] + 1, ps, window) * ps
                elif chunk_tok is not None and i == fill_slot:
                    self._attn_tokens_read += \
                        pages_read_mq(start, take, ps, window) * ps
                elif filling is not None and i == fill_slot:
                    self._attn_tokens_read += \
                        pages_read(fill_cursor + 1, ps, window) * ps
                else:
                    self._attn_tokens_read += ps

            # ---- dead rows (non-finite logits at the anchor rung): retire
            # them before the drain, so no poisoned token enters a stream
            for i in dead:
                if chunk_tok is not None and i == fill_slot:
                    release_slot(i)
                    self._finish(
                        filling, RequestStatus.FAILED_NUMERIC,
                        f"non-finite final-chunk logits in this request's "
                        f"row at the anchor rung ({pinned}), tick {tick_id}")
                    filling = None
                    continue
                r_dead = active[i]
                active[i] = None
                release_slot(i)
                self._finish(
                    r_dead, RequestStatus.FAILED_NUMERIC,
                    f"non-finite logits in this request's row at the "
                    f"anchor rung ({pinned}), tick {tick_id}")

            # ---- retire
            for i, r in enumerate(active):
                if r is None:
                    continue
                slot_len[i] += 1
                r.out_tokens.append(int(drained[i]))
                self._tokens_out += 1
                if len(r.out_tokens) >= r.max_new or \
                        slot_len[i] >= self.prompt_capacity:
                    self._finish(r, RequestStatus.COMPLETED)
                    active[i] = None    # slot re-admissible next tick
                    release_slot(i)
            if chunk_tok is not None:
                # mixed-tick chunk epilogue: advance the cursor; the final
                # chunk's row gives the request its first token (a dead
                # fill row retired above)
                fill_cursor = start + take
                if final and filling is not None:
                    slot_len[fill_slot] = plen
                    complete_admission(fill_slot, filling, drain.first,
                                       drain.first_key)
                    filling = None
            # ---- cost-model calibration: only clean pure-decode ticks (no
            # prefill work, one executable: no replay) are the pinned
            # format's per-tick cost; the measured attention read refreshes
            # the per-row term. A format's first such tick (eager, or the
            # CUDA-graph capture) is warm-up, never folded in.
            cost = self.policy.cost
            rows_d = int(mask.sum())
            if cost is not None and rows_d and tick["prefill_chunks"] == 0 \
                    and tick["execs"] == 1:
                seen = self._fmt_decode_ticks.get(pinned, 0)
                self._fmt_decode_ticks[pinned] = seen + 1
                if seen:
                    cost.observe(
                        pinned, rows_d, time.perf_counter() - t_tick,
                        attn_bytes_per_row=(self._attn_tokens_read
                                            - attn_before)
                        * self._attn_token_bytes / rows_d)
            self._record_tick(tick, 1, t_tick, span, decode_rows=rows_d)
            if all(a is None for a in active) and filling is None:
                pinned = None
        return requests

    @staticmethod
    def _tightest_tpot_ms(reqs: List[Request]) -> Optional[float]:
        """The wave's binding per-token budget: the least ``tpot_ms`` among
        requests that carry one (None when none does)."""
        vals = [r.slo.tpot_ms for r in reqs
                if r.slo is not None and r.slo.tpot_ms is not None]
        return min(vals) if vals else None

    def _record_tick(self, tick: Dict[str, int], decode: int, t_tick: float,
                     span, decode_rows: int, draft_execs: int = 0,
                     verify_execs: int = 0) -> None:
        """One scheduler-tick trace entry: padded prompt tokens and chunks
        prefilled, whether a decode (or mixed) step ran, the executables
        dispatched (the mixed scheduler's invariant: at most one, plus one
        per guard replay), the batch rows they processed, the live decoding
        rows, the host wall time, and a speculative tick's split of
        ``execs`` into draft and verify executables (0 otherwise). Closes
        the tick's profiler range ``span``."""
        self.tick_trace.append({
            "prefill_tokens": tick["prefill_tokens"],
            "prefill_chunks": tick["prefill_chunks"], "decode": decode,
            "wall_s": time.perf_counter() - t_tick, "execs": tick["execs"],
            "rows": tick["rows"], "decode_rows": decode_rows,
            "draft_execs": draft_execs, "verify_execs": verify_execs})
        span.__exit__(None, None, None)

    def _draft_burst(self, fmt: str, k_eff: int, consumed: List[int],
                     mask: np.ndarray, tick: int):
        """``k_eff`` greedy draft steps at ``fmt`` against the draft cursor
        and tokens (``_draft_state``), which start as copies of the
        committed ones: the committed ``cache_len`` / tokens never move,
        so abandoning the burst needs no undo (the draft KV lies past every
        committed cursor, masked, and the next write there overwrites it).
        A step that crashes with ``InjectedFault`` abandons the burst; so
        do non-finite draft logits in a consumed row under the guard, which
        also quarantine ``fmt`` (``allow_speculation`` then vetoes drafting
        for the rest of the wave). Returns (drafts (B, k_eff) on the
        device, the same on the host, draft executables run); the drafts
        are None when the burst was abandoned."""
        fi = self._fault_injector
        cache = self._cache
        dlen, dtok = self._draft_state()
        dlen.copy_(self._cache_len)
        dtok.copy_(self._tokens)
        adv = torch.as_tensor(mask, device=self.device)
        cols, host_cols = [], []
        execs = 0
        for _ in range(k_eff):
            try:
                if fi is not None:
                    fi.maybe_raise_step(tick)           # before dispatch
                lg = self._tick("draft_step", fmt, 1, {"tokens": dtok},
                                cache, dlen)
            except InjectedFault:
                # a transient crash mid-burst: drop the burst, decode plain
                # this tick (the injector fires once per tick)
                self._faults_detected += 1
                return None, None, execs
            if fi is not None:
                lg = fi.maybe_poison_logits(tick, fmt, lg)
            execs += 1
            d = torch.argmax(lg, -1)
            host = torch.cat([d, torch.isfinite(lg).all(-1).to(d.dtype)]) \
                .cpu().numpy()
            if self.logit_guard and not all(
                    host[self.slots + i] for i in consumed):
                self._faults_detected += 1
                self.policy.quarantine(fmt)
                return None, None, execs
            cols.append(d)
            host_cols.append(host[:self.slots])
            dtok.copy_(d[:, None])
            dlen.add_(adv)
        return torch.stack(cols, 1), np.stack(host_cols, 1), execs

    def _rollback_slot_pages(self, free: List[int], bt: np.ndarray,
                             slot: int, frontier: int) -> None:
        """Speculative rewind, page half: free this slot's pages past the
        one holding position ``frontier - 1`` (its last committed token).
        Earlier pages and every other slot's row are untouched; the freed
        pages' stale draft KV is masked by ``cache_len`` until a later
        occupant overwrites it. A slot then holds ``ceil(slot_len / page)``
        pages between ticks, as under plain decode, so ``alloc == freed``
        at retire whatever was accepted."""
        keep = -(-frontier // self.kv_page_size)
        tail = bt[slot, keep:]
        drop = tail[tail != 0]
        free.extend(int(p) for p in drop)
        self._kv_pages_freed += drop.size
        bt[slot, keep:] = 0

    # ---- snapshot / resume ------------------------------------------------
    def _cache_leaves(self) -> List[torch.Tensor]:
        """The KV cache's tensors in the snapshot's fixed order: each
        layer group's ``blocks`` dict by sorted key, then the block
        table."""
        leaves = [c[k] for c in self._cache["blocks"] for k in sorted(c)]
        if "block_table" in self._cache:
            leaves.append(self._cache["block_table"])
        return leaves

    def _snapshot_fingerprint(self) -> dict:
        """The engine facts a snapshot's arrays and scheduler state only
        mean something under, with the reference's keys; ``resume`` refuses
        a snapshot whose fingerprint differs (resuming onto another layout
        would corrupt streams, not fail)."""
        sc = self.speculative
        return {
            "family": self.api.cfg.family,
            "slots": self.slots,
            "max_len": self.max_len,
            "kv_layout": self.kv_layout,
            "kv_page_size": self.kv_page_size,
            "kv_total_pages": self._kv_total_pages,
            "attn_impl": self.attn_impl,
            "fused": bool(self.fused),
            "packed": self.packed,
            "prefill_chunk": self.prefill_chunk,
            "scheduler": self.scheduler,
            "bucket": self._bucket,
            "temperature": self.temperature,
            "top_p": self.top_p,
            "admission_order": self.admission_order,
            # string-encoded so the JSON manifest round-trips exactly
            "speculative": (f"{sc.draft_fmt}:k{sc.k}" if sc is not None
                            else None),
            # "DxM" (None on one device): a snapshot taken on a mesh holds
            # sharded state and resumes only on the same mesh shape
            "mesh": self._mesh_str(),
        }

    def _snap_root(self, root: str) -> str:
        """Where this process's snapshot goes: ``root`` on one device, a
        subdirectory per shard on a mesh (each holds its own kv heads)."""
        if self.mesh is None:
            return root
        return os.path.join(root, f"model{self.mesh.coord('model')}")

    def _save_snapshot(self, root: str, requests: List[Request], st: dict,
                       greedy: bool, fmt_override: Optional[str]) -> str:
        """The wave's whole state at a tick boundary, as one step of
        ``checkpoint/io.py`` (atomic, manifest-driven). Arrays: the KV
        leaves (``_cache_leaves``), cache_len, tokens, the engine and slot
        keys, the temperature and top-p lanes, the block-table mirror, and
        each request's prompt and emitted tokens; everything host-side
        rides the manifest. ``resume`` rebuilds from these alone, so a
        fresh engine of the same configuration finishes the wave."""
        arrays: Dict[str, object] = {
            f"cache_{n:04d}": t for n, t in enumerate(self._cache_leaves())}
        arrays.update(cache_len=self._cache_len, tokens=self._tokens,
                      slot_keys=self._keys, engine_key=self._key,
                      slot_temp=self._temps, slot_topp=self._tops)
        if st["bt"] is not None:
            arrays["bt"] = st["bt"]
        for r in requests:
            arrays[f"prompt_{r.rid}"] = np.asarray(r.prompt, np.int32)
            # int64 whatever the length: an empty list must not come back
            # as float64
            arrays[f"out_{r.rid}"] = np.asarray(r.out_tokens, np.int64)
        meta = {
            "kind": "elastic-engine-snapshot",
            "fingerprint": self._snapshot_fingerprint(),
            "greedy": bool(greedy),
            "fmt_override": fmt_override,
            "pinned": st["pinned"],
            "elapsed_s": float(st["elapsed_s"]),
            "tick_no": int(st["tick_no"]),
            "requests": [{"rid": r.rid, "max_new": int(r.max_new),
                          "status": r.status.value, "error": r.error,
                          "fmt_used": r.fmt_used, "ttft_s": r.ttft_s,
                          "deadline_s": r.deadline_s, "done": bool(r.done),
                          "cancel_requested": bool(r.cancel_requested),
                          "slo": (r.slo.to_dict() if r.slo is not None
                                  else None),
                          "tenant": r.tenant,
                          "arrival_tick": int(r.arrival_tick),
                          "arrival_s": r.arrival_s,
                          "admitted_tick": r.admitted_tick,
                          "temperature": r.temperature, "top_p": r.top_p}
                         for r in requests],
            "pending": [r.rid for r in st["pending"]],
            "active": [(a.rid if a is not None else None)
                       for a in st["active"]],
            "slot_len": [int(v) for v in st["slot_len"]],
            "filling": (st["filling"].rid if st["filling"] is not None
                        else None),
            "fill_slot": int(st["fill_slot"]),
            "fill_cursor": int(st["fill_cursor"]),
            "wait_pages": bool(st["wait_pages"]),
            "free_pages": [int(p) for p in st["free_pages"]],
            "quarantined": sorted(self.policy.quarantined),
            "counters": {
                "ticks": self._ticks,
                "prefills": self._prefills,
                "tokens_out": self._tokens_out,
                "nonfinite_logit_rows": self._nonfinite_rows,
                "kv_pages_alloc": self._kv_pages_alloc,
                "kv_pages_freed": self._kv_pages_freed,
                "kv_pages_hwm": self._kv_pages_hwm,
                "faults_detected": self._faults_detected,
                "fmt_escalations": self._fmt_escalations,
                "ticks_replayed": self._ticks_replayed,
                "admission_requeues": self._admission_requeues,
                "attn_tokens_read": self._attn_tokens_read,
                "spec_ticks": self._spec_ticks,
                "spec_accepted": self._spec_accepted,
                "spec_rejected": self._spec_rejected,
                "spec_aborts": self._spec_aborts,
                "status_counts": self._status_counts,
                "failures": self._failures,
                "escalation_events": self._escalation_events,
            },
        }
        self._snap_step += 1
        return ckpt_io.save(self._snap_root(root), self._snap_step, arrays,
                            extra_meta=meta)

    def resume(self, snapshot_dir: str, *, guard=None,
               step: Optional[int] = None) -> List[Request]:
        """Finish a preempted wave from its snapshot (the latest by
        default): the requests, queues, counters, KV cache, keys and
        sampling lanes of ``_save_snapshot`` come back, and ``generate``
        goes on mid-wave with the streams of the uninterrupted run. The
        arrays are copied into this engine's buffers in place (never
        rebound: a captured tick graph reads them where they lie), so the
        engine may be a fresh one or one whose graphs are captured. A
        snapshot whose fingerprint differs from this engine's raises
        ``ValueError`` naming the fields. Returns the rebuilt request
        list, finished."""
        arrays, manifest = ckpt_io.restore(self._snap_root(snapshot_dir),
                                           step)
        meta = manifest["meta"]
        if meta.get("kind") != "elastic-engine-snapshot":
            raise ValueError(f"{snapshot_dir} holds {meta.get('kind')!r}, "
                             "not an elastic-engine-snapshot")
        fp_saved, fp_now = meta["fingerprint"], self._snapshot_fingerprint()
        if fp_saved != fp_now:
            diff = {k: {"snapshot": fp_saved.get(k), "engine": fp_now.get(k)}
                    for k in sorted(set(fp_saved) | set(fp_now))
                    if fp_saved.get(k) != fp_now.get(k)}
            raise ValueError(
                "snapshot/engine fingerprint mismatch — resume requires an "
                f"identically configured engine; differs on: {diff}")
        self._wave_state()
        for n, t in enumerate(self._cache_leaves()):
            _copy_in(t, arrays[f"cache_{n:04d}"])
        for name, t in (("cache_len", self._cache_len),
                        ("tokens", self._tokens), ("slot_keys", self._keys),
                        ("slot_temp", self._temps),
                        ("slot_topp", self._tops)):
            _copy_in(t, arrays[name])
        self._key = torch.from_numpy(np.asarray(arrays["engine_key"],
                                                np.int64).copy())
        by_rid: Dict[int, Request] = {}
        requests: List[Request] = []
        for rd in meta["requests"]:
            r = Request(rid=rd["rid"], prompt=arrays[f"prompt_{rd['rid']}"],
                        max_new=rd["max_new"])
            r.out_tokens = [int(t) for t in arrays[f"out_{rd['rid']}"]]
            r.status = RequestStatus(rd["status"])
            for f in ("error", "fmt_used", "ttft_s", "deadline_s", "done",
                      "cancel_requested", "tenant", "arrival_tick",
                      "arrival_s", "admitted_tick", "temperature", "top_p"):
                setattr(r, f, rd[f])
            r.slo = SLOClass.from_dict(rd["slo"]) \
                if rd["slo"] is not None else None
            by_rid[r.rid] = r
            requests.append(r)
        c = meta["counters"]
        self._ticks = c["ticks"]
        self._prefills = c["prefills"]
        self._tokens_out = c["tokens_out"]
        self._nonfinite_rows = c["nonfinite_logit_rows"]
        self._kv_pages_alloc = c["kv_pages_alloc"]
        self._kv_pages_freed = c["kv_pages_freed"]
        self._kv_pages_hwm = c["kv_pages_hwm"]
        self._faults_detected = c["faults_detected"]
        self._fmt_escalations = c["fmt_escalations"]
        self._ticks_replayed = c["ticks_replayed"]
        self._admission_requeues = c["admission_requeues"]
        self._attn_tokens_read = c["attn_tokens_read"]
        self._spec_ticks = c["spec_ticks"]
        self._spec_accepted = c["spec_accepted"]
        self._spec_rejected = c["spec_rejected"]
        self._spec_aborts = c["spec_aborts"]
        self._status_counts = dict(c["status_counts"])
        self._failures = list(c["failures"])
        self._escalation_events = list(c["escalation_events"])
        self.policy.quarantined |= set(meta["quarantined"])
        self._resumes += 1
        state = dict(
            pending=[by_rid[rid] for rid in meta["pending"]],
            active=[by_rid[rid] if rid is not None else None
                    for rid in meta["active"]],
            slot_len=[int(v) for v in meta["slot_len"]],
            pinned=meta["pinned"],
            filling=(by_rid[meta["filling"]]
                     if meta["filling"] is not None else None),
            fill_slot=meta["fill_slot"],
            fill_cursor=meta["fill_cursor"],
            wait_pages=meta["wait_pages"],
            free_pages=list(meta["free_pages"]),
            bt=(np.asarray(arrays["bt"], np.int32).copy()
                if "bt" in arrays else None),
            elapsed_s=meta["elapsed_s"],
            tick_no=meta["tick_no"])
        return self.generate(requests, greedy=meta["greedy"],
                             fmt_override=meta["fmt_override"],
                             guard=guard, snapshot_dir=snapshot_dir,
                             _state=state)

    # ---- introspection ----------------------------------------------------
    def stats(self) -> Dict[str, object]:
        return {
            "formats_cached": sorted(self._weights),
            # the global tree's bytes (a mesh's, recorded before the cut)
            "weight_bytes": (dict(self._weight_bytes) if self.mesh is not None
                             else {f: weight_stream_bytes(t)
                                   for f, t in self._weights.items()}),
            "weight_bytes_per_chip": {f: weight_stream_bytes_local(t)
                                      for f, t in self._weights.items()},
            "mesh": self._mesh_str(),
            "kernel_launches": {**mx_matmul.launches,
                                **paged_attention.launches},
            "cuda_graphs": self._graphs is not None,
            "graph_captures": self._graphs.captures if self._graphs else 0,
            "graph_replays": self._graphs.replays if self._graphs else 0,
            "graph_capture_s": self._graphs.capture_s if self._graphs
            else 0.0,
            "draw_graph_captures": self._draw_graphs.captures
            if self._draw_graphs else 0,
            "draw_graph_replays": self._draw_graphs.replays
            if self._draw_graphs else 0,
            "fmt_swaps": self._fmt_swaps,
            "ticks": self._ticks,
            "prefills": self._prefills,
            "tokens_out": self._tokens_out,
            "prefill_s": self._prefill_s,
            "decode_s": self._decode_s,
            "nonfinite_logit_rows": self._nonfinite_rows,
            "logit_guard": self.logit_guard,
            "faults_detected": self._faults_detected,
            "fmt_escalations": self._fmt_escalations,
            "escalation_events": list(self._escalation_events),
            "ticks_replayed": self._ticks_replayed,
            "quarantined_formats": sorted(self.policy.quarantined),
            "failures": list(self._failures),
            "current": self.current_fmt,
            "fused": self.fused,
            "device": str(self.device),
            "request_statuses": dict(self._status_counts),
            "prefill_chunk": self.prefill_chunk,
            "admission_order": self.admission_order,
            "admission_requeues": self._admission_requeues,
            "kv_layout": self.kv_layout,
            "kv_cache_bytes": self._kv_cache_bytes,
            "kv_bytes_per_slot": self._kv_cache_bytes // self.slots,
            "kv_page_size": self.kv_page_size,
            "kv_total_pages": self._kv_total_pages,
            "kv_pages_alloc": self._kv_pages_alloc,
            "kv_pages_freed": self._kv_pages_freed,
            "kv_pages_hwm": self._kv_pages_hwm,
            "attn_impl": self.attn_impl,
            "attn_tokens_read": self._attn_tokens_read,
            "attn_read_bytes": self._attn_tokens_read
            * self._attn_token_bytes,
            "speculative": (dataclasses.asdict(self.speculative)
                            if self.speculative is not None else None),
            "spec_ticks": self._spec_ticks,
            "spec_accepted": self._spec_accepted,
            "spec_rejected": self._spec_rejected,
            "spec_aborts": self._spec_aborts,
            "spec_acceptance_rate": (
                self._spec_accepted
                / (self._spec_accepted + self._spec_rejected)
                if self._spec_accepted + self._spec_rejected else None),
            "snapshots_saved": self._snapshots_saved,
            "resumes": self._resumes,
            "cost_model": (self.policy.cost.snapshot()
                           if self.policy.cost is not None else None),
        }


def _copy_in(dst: torch.Tensor, a: np.ndarray) -> None:
    """Write a snapshot array into ``dst`` in place (a bf16 tensor comes
    back from the archive as 2-byte raw records)."""
    a = np.asarray(a)
    if dst.dtype == torch.bfloat16:
        src = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        src = torch.from_numpy(a.copy())
    dst.copy_(src.reshape(dst.shape))
