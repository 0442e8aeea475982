"""Shared model infrastructure: the config and the quantization context.

Counterpart of ``repro/models/common.py``. Every projection weight flows
through ``QuantCtx.dense``: with a ``qmm`` hook a packed MX leaf goes
straight to the dequant-GEMM dispatch (``kernels/dispatch.py``); without one
it is dequantized at its point of use. MF-QAT training fake-quantizes the
stacked projection leaves before the layer loop
(``models/transformer.py::fake_quant_blocks``), so ``dense`` sees them
already quantized. Weights are (d_in, d_out) with MX blocks along d_in, the
contraction axis. ``spec_accept_counts`` is the speculative verify tick's
acceptance rule.

Tensor parallelism (``TensorParallel``, the counterpart of the reference's
``tp_axis``; in training, of GSPMD's cut of each leaf): a forward over
sharded weights runs in every process of a ``torch.distributed`` group,
told what it holds by ``ShardDims`` (heads, kv heads, Mamba channels,
RWKV heads, a MoE layer's experts or their d_ff), and the reference's
``psum`` / ``all_gather`` inside ``shard_map`` become ``dist.all_reduce``
/ ``dist.all_gather`` over that group. The collectives are differentiable,
each with the backward that matches what its forward replicates (a value
every process holds alike carries its whole gradient in every process): an
all-reduce of partial sums has the identity backward, ``copy_in`` (a
replicated value entering sharded work) the identity forward and an
all-reduce backward, and the all-gather's backward takes this process's
slice. The sequence-parallel residual (``ModelConfig.seq_sharding``) adds
a pair along the sequence: ``gather_seq`` (all-gather forward, this
process's slice backward) and ``cut_seq`` (the slice forward, in storage
of its own, and an all-gather of the gradient's slices backward).
``torch.distributed.nn``'s collectives sum in their backward, which
on a loss every process computes alike multiplies gradients by the group's
size. ``DataParallel`` is the same group object for the batch axes of a
sharded training step: the loss's masked sums and the MoE balance
fractions are all-reduced over it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.serve.packed_params import densify_leaf, is_packed_leaf


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters of the decoder-only families the port
    serves: the fields of ``repro/models/common.py::ModelConfig`` that the
    dense configs (qwen3-4b, smollm-135m, starcoder2-3b, qwen2-72b), the
    MoE configs (mixtral-8x7b, mixtral-8x22b), the hybrid jamba-1.5-large
    the vision-language llava-next-mistral-7b, the RWKV6 rwkv6-7b
    (family ``"ssm"``: every layer an RWKV time mix and channel mix of
    ``rwkv_head_dim`` heads) and the encoder-decoder seamless-m4t-large-v2
    (family ``"encdec"``: ``enc_layers`` bidirectional encoder layers over
    frame embeddings, ``n_layers`` decoder layers with cross attention;
    ``audio_downsample`` sets the default encoder length of a serving
    cache) set. ``act``: the SwiGLU
    or the tanh-gelu MLP; ``qkv_bias`` / ``mlp_bias``: biases on the q/k/v
    projections and on the MLP's up and down projections;
    ``sliding_window``: attention sees the last W positions (mixtral's
    4096); ``moe_*``: top-k routed experts with capacity dispatch at the
    layers ``is_moe_layer`` names; ``attn_every`` / ``attn_offset``: a
    hybrid stack's attention layers (``is_attn_layer``), the others Mamba
    blocks of ``mamba_*`` widths; ``vision_tokens``: the length of the
    image-embedding prefix a ``"vlm"`` batch carries (otherwise the
    ``"dense"`` family). Training runs the O(S)-memory flash backward
    (``flash_vjp``) and recomputes each layer group in the backward
    (``remat``; ``remat_inner`` also each layer of a group), the JAX
    package's defaults. ``seq_sharding``: under tensor parallelism each
    process keeps only its slice of the sequence of the residual stream
    between layer groups, so a group's saved input is 1 / tp of it
    (Megatron-SP's saving; ``models/transformer.py::forward_hidden``)."""

    name: str
    family: str                     # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    mlp_bias: bool = False
    sliding_window: Optional[int] = None    # attention sees the last W
    norm_eps: float = 1e-5
    act: str = "swiglu"             # swiglu | gelu
    tie_embeddings: bool = False
    # MoE
    moe_experts: int = 0
    moe_topk: int = 2
    moe_every: int = 1              # MoE at layers where i % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # Hybrid (jamba): attention at layers where i % attn_every == attn_offset
    attn_every: int = 0             # 0 -> attention everywhere
    attn_offset: int = 0
    # Mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0          # 0 -> ceil(d_model / 16)
    rwkv_head_dim: int = 64
    enc_layers: int = 0
    vision_tokens: int = 0          # llava anyres patch embeds
    audio_downsample: int = 0       # seamless: enc frames = seq // this
    compute_dtype: Any = torch.bfloat16
    scan_group: int = 1             # layers per stacked group
    seq_chunk: int = 1024           # flash-attention / loss chunking
    flash_vjp: bool = True          # flash attention with an O(S) backward
    seq_sharding: bool = False      # sequence-parallel residual stream (SP)
    remat: bool = True              # recompute each group in the backward
    remat_inner: bool = False       # also each layer inside a group

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.scan_group == 0
        return self.n_layers // self.scan_group

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_every <= 0:
            return True
        return i % self.attn_every == self.attn_offset

    def is_moe_layer(self, i: int) -> bool:
        if self.moe_experts <= 0:
            return False
        return i % self.moe_every == self.moe_offset

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or max(1, -(-self.d_model // 16))


def _sum_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every process's ``x`` over ``group``, in ``x``'s dtype:
    the sum runs in f32 (for two shards an f32 sum of two bf16 values is
    exact, so the rounding back is the one a bf16 add makes)."""
    import torch.distributed as dist
    buf = x.to(torch.float32).contiguous()
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


class _AllReduce(torch.autograd.Function):
    """Sum of partials forward; identity backward (the sum is replicated,
    so each partial's gradient is the sum's)."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyIn(torch.autograd.Function):
    """Identity forward; all-reduce backward (each process's sharded work
    gives a part of the replicated input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.group), None


class _GatherLast(torch.autograd.Function):
    """Concatenation of the shards along the last axis forward; this
    process's slice of the gradient backward: with ``per_rank`` false no
    sum (the gathered value is replicated), with it true the sum of every
    process's gradient first (each process's own work reads the gathered
    value, so each holds a part of its gradient: a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, size, rank, per_rank):
        import torch.distributed as dist
        ctx.n, ctx.rank, ctx.group, ctx.per_rank = (x.shape[-1], rank,
                                                    group, per_rank)
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        if ctx.per_rank:
            g = _sum_f32(g, ctx.group)
        lo = ctx.rank * ctx.n
        return g[..., lo:lo + ctx.n], None, None, None, None


def _gather_seq(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Every process's ``x`` concatenated along axis 1 in rank order."""
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


class _GatherSeq(torch.autograd.Function):
    """The whole sequence from every process's slice forward; this
    process's slice of the (replicated) gradient backward."""

    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.n, ctx.rank = x.shape[1], rank
        return _gather_seq(x, group, size)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.n
        return g[:, lo:lo + ctx.n], None, None, None


class _CutSeq(torch.autograd.Function):
    """This process's slice of a replicated sequence forward, copied into
    storage of its own (a view would keep the whole sequence alive);
    backward, the gradient's slices all-gathered into the whole one."""

    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.group, ctx.size = group, size
        n = x.shape[1] // size
        return x[:, rank * n:(rank + 1) * n].clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.group, ctx.size), None, None, None


@dataclasses.dataclass(frozen=True)
class ShardDims:
    """What one process of a tensor-parallel group holds of each dim the
    forward cuts, read from the resolved spec of each leaf
    (``models/__init__.py::shard_dims``), beside the global config that
    routing, capacity and the losses read: its attention heads and the kv
    heads they attend with, Mamba's ``d_inner`` channels, RWKV heads, and
    of a MoE layer ``moe``, the logical axis that took ``model``:
    ``"experts"`` (it holds experts ``[expert_offset, expert_offset +
    experts)`` whole) or ``"mlp"`` (every expert on its slice of d_ff;
    ``experts`` is all of them). ``kv_gather``: the axis outnumbers the kv
    heads, so a process holds a part of one kv head's K / V columns; the
    columns are gathered and its query heads attend with kv head
    ``kv_offset``. The MLP needs no field: its product shapes follow the
    leaves."""

    n_heads: int
    n_kv_heads: int
    d_inner: int
    rwkv_heads: int
    experts: int
    expert_offset: int = 0
    moe: Optional[str] = None
    kv_gather: bool = False
    kv_offset: int = 0

    @classmethod
    def whole(cls, cfg: "ModelConfig") -> "ShardDims":
        """The dims of one device: the config's own."""
        return cls(cfg.n_heads, cfg.n_kv_heads, cfg.mamba_d_inner,
                   cfg.d_model // cfg.rwkv_head_dim, cfg.moe_experts)


@dataclasses.dataclass
class TensorParallel:
    """One process's place on the ``model`` axis of a mesh: its process
    ``group`` (the default group when None), its ``rank`` there, the axis
    ``size`` and ``dims``, what it holds of the dims the forward cuts
    (``ShardDims``; a ``DataParallel`` has none). ``timed``: synchronize
    the device around each collective and add its host seconds to
    ``collective_s`` (off by default: the synchronizes cost what they
    measure)."""

    group: Any
    rank: int
    size: int
    dims: Optional[ShardDims] = None
    timed: bool = False
    collective_s: float = 0.0

    def _run(self, fn, x: torch.Tensor):
        if not self.timed:
            return fn(x)
        sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
        sync()
        t0 = time.perf_counter()
        y = fn(x)
        sync()
        self.collective_s += time.perf_counter() - t0
        return y

    def all_reduce(self, y: torch.Tensor) -> torch.Tensor:
        """The sum of every shard's ``y``, in ``y``'s dtype, summed in f32
        (the reference's bf16 ``psum`` rounds the same way at two shards).
        Identity backward."""
        return self._run(lambda x: _AllReduce.apply(x, self.group), y)

    def all_gather_last(self, y: torch.Tensor,
                        per_rank: bool = False) -> torch.Tensor:
        """Every shard's ``y`` concatenated along the last axis in rank
        order (the reference's tiled ``all_gather``): no arithmetic. Its
        backward takes this shard's slice; ``per_rank``: what reads the
        gathered value is each process's own work (Mamba's ``[x | z]``
        channels), so the backward sums the processes' gradients first."""
        return self._run(lambda x: _GatherLast.apply(
            x, self.group, self.size, self.rank, per_rank), y)

    def gather_seq(self, y: torch.Tensor) -> torch.Tensor:
        """Every shard's slice of the sequence (axis 1) of ``y``
        concatenated in rank order: no arithmetic. Its backward takes this
        shard's slice of the gradient."""
        return self._run(lambda x: _GatherSeq.apply(
            x, self.group, self.size, self.rank), y)

    def cut_seq(self, y: torch.Tensor) -> torch.Tensor:
        """This shard's slice of the sequence (axis 1) of ``y``, which
        every shard holds alike, in storage of its own. Its backward
        all-gathers the gradient's slices."""
        return self._run(lambda x: _CutSeq.apply(
            x, self.group, self.size, self.rank), y)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (replicated over the group) as the input of sharded work:
        the identity, whose backward sums the shards' gradients. A no-op
        outside autograd."""
        if not torch.is_grad_enabled():
            return x
        return _CopyIn.apply(x, self.group)


class DataParallel(TensorParallel):
    """One process's place on the batch axes (``pod`` x ``data``) of a
    sharded training step: the same collectives over the group of the
    processes that hold other rows of the batch."""


@dataclasses.dataclass
class QuantCtx:
    """``qmm``: the serving matmul hook ``(x, packed_leaf, name) -> y``.
    ``tp``: the tensor-parallel group a head- and ffn-sharded forward runs
    over (None: one device, no collectives). ``dp``: the batch axes' group
    of a sharded training step (None: the batch is whole here)."""

    qmm: Optional[Any] = None
    tp: Optional[TensorParallel] = None
    dp: Optional[DataParallel] = None

    def shard(self, cfg: ModelConfig) -> ShardDims:
        """The dims this process runs: ``tp.dims`` under tensor
        parallelism, the config's own otherwise."""
        if self.tp is None:
            return ShardDims.whole(cfg)
        if self.tp.dims is None:
            raise ValueError("a tensor-parallel forward needs the shard's "
                             "dims (TensorParallel.dims, from shard_dims)")
        return self.tp.dims

    def tp_in(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` entering column-parallel (or per-head) work: under tensor
        parallelism its gradient is summed over the shards."""
        return x if self.tp is None else self.tp.copy_in(x)

    def dp_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the batch axes' processes of a per-shard mean of
        equal-sized shards: the whole batch's mean."""
        if self.dp is None:
            return x
        return self.dp.all_reduce(x) / self.dp.size

    def dense(self, x: torch.Tensor, w, name: str,
              b: Optional[torch.Tensor] = None, *,
              tp_reduce: bool = False) -> torch.Tensor:
        """y = x @ w (+ b) in the activation dtype: the bias, raw in every
        tree, is added after the product, as the JAX package adds it.
        ``tp_reduce`` marks a row-parallel projection (wo, w_down): under
        tensor parallelism the shard's partial product is all-reduced
        before the bias add, so the replicated bias is added once; a
        dequant-GEMM's partial stays in its f32 accumulator through the
        all-reduce and is rounded to the activation dtype once, as the
        single-device product is (the reference's psum adds partials
        already rounded)."""
        reduce = tp_reduce and self.tp is not None
        if self.qmm is not None and is_packed_leaf(w):
            y = self.qmm(x, w, name, out_dtype=torch.float32) if reduce \
                else self.qmm(x, w, name)
        else:
            if is_packed_leaf(w):
                w = densify_leaf(w, None, x.dtype, serving_axis=True)
            y = torch.matmul(x, w.to(x.dtype))
        if reduce:
            y = self.tp.all_reduce(y).to(x.dtype)
        if b is not None:
            y = y + b.to(x.dtype)
        return y


def at_use(w, dtype) -> torch.Tensor:
    """A non-projection leaf in ``dtype``: a packed one densified here."""
    if is_packed_leaf(w):
        return densify_leaf(w, None, dtype, serving_axis=True)
    return w.to(dtype)


def is_paged_cache(cache) -> bool:
    """True for the paged KV layout (shared page pools + per-slot block
    table): its pool leaves have no batch axis, so slot surgery goes
    through the block table instead."""
    return isinstance(cache, dict) and "block_table" in cache


def spec_accept_counts(drafts, anchor_toks, budgets) -> np.ndarray:
    """Per-row commit counts of a speculative verify tick (host side).

    ``drafts`` (B, k): the draft rung's greedy tokens of the burst.
    ``anchor_toks`` (B, k+1): the argmax of ``ModelApi.verify_step``'s
    logits — lane ``i`` is the verify format's own next token after input
    token ``i`` (lane 0 after the last committed token, lane ``i > 0``
    after draft ``i-1``). A row accepts the longest prefix where
    ``drafts[:, i] == anchor_toks[:, i]`` and commits those ``m`` tokens
    plus the bonus token at lane ``m``, clamped to its ``budgets`` entry
    (max_new / cache-capacity headroom; 0 for a masked or dead row).
    Returns (B,) int64 commit counts."""
    drafts = np.asarray(drafts)
    anchor_toks = np.asarray(anchor_toks)
    b, k = drafts.shape
    if anchor_toks.shape != (b, k + 1):
        raise ValueError(
            f"anchor_toks {anchor_toks.shape} vs drafts {drafts.shape}")
    hit = drafts == anchor_toks[:, :k]
    # the longest all-True prefix per row: the first miss (k if none)
    m = np.where(hit.all(axis=1), k, hit.argmin(axis=1))
    return np.minimum(m + 1, np.asarray(budgets)).astype(np.int64)
