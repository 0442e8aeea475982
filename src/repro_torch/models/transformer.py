"""Decoder-only LM (dense, MoE, the attention/Mamba hybrid, RWKV6 and the
vision-prefixed backbone): init, KV cache, prefill, chunks, decode, mixed.

Counterpart of the dense, MoE, hybrid, ssm and vlm families of
``repro/models/transformer.py``. The parameter tree keeps the JAX layout —
``{"embed", "blocks": [group], ...}`` with every block leaf stacked over
layer groups (G, ...), expert leaves over groups and experts (G, E, ...) —
so anchor checkpoints map 1:1; the JAX ``lax.scan`` over groups becomes a
Python loop over ``leaf[g]`` views, and under ``cfg.remat`` each group's
body is recomputed in the backward (``jax.checkpoint``'s
``nothing_saveable`` becomes ``torch.utils.checkpoint``). The KV cache,
dense (G, B, S, Hkv, D) or paged (pools (G, P, ps, Hkv, D) and a block
table), is updated in place; a Mamba layer's recurrent state, ``h``
(G, B, d_inner, N) f32 and ``conv`` (G, B, d_conv-1, d_inner), lives in the
same cache, dense layout only, and a decode step overwrites it in place
(so a replayed decode must first put back the pre-tick state: the serving
engine keeps a copy). An RWKV layer's state, ``shift_t`` / ``shift_c``
(G, B, 1, d) and ``wkv`` (G, B, H, hd, hd) f32, lives there the same way.
A ``"vlm"`` batch carries ``vision_embeds`` (B, V, d), prepended to the
token embeddings in training and prefill; the loss drops those positions
and prefill counts them in ``cache_len``. Chunked prefill, the mixed tick
and the verify refuse a vision prefix and recurrent mixers with the
reference's messages.

Entry points (``ModelApi``): ``train_loss`` (the MF-QAT training loss, with
autograd), ``prefill``, ``prefill_slot`` (one request into one slot of the
batched cache), ``prefill_chunk`` / ``prefill_chunk_slot`` (one prompt chunk
at a cursor), ``serve_step`` (one token for every slot), ``mixed_step``
(decode rows and one prompt chunk in one step), ``verify_step`` (the same
step with logits at every query position: the speculative verify),
``with_serving`` /
``with_qmm`` (the same entry points with a dequant-GEMM hook and a paged
read path, ``attn_impl``).

Training fake-quantizes each stacked projection leaf once per step, before
the layer loop (``fake_quant_blocks``): the JAX package fake-quantizes
inside ``dense``, one layer slice at a time (inside the rematted body), and
the values are the same (blocks run along d_in, inside a slice), in 7
launches per step instead of 7 × layers.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.qat import QATConfig
from repro_torch.core.tree import unflatten_paths
from repro_torch.devices import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import rwkv, ssm
from repro_torch.models.common import (DataParallel, ModelConfig, QuantCtx,
                                      TensorParallel, is_paged_cache)
from repro_torch.serve.packed_params import (densify_leaf, is_packed_leaf,
                                             layer_slice)


# =============================================================================
# Init
# =============================================================================
def mixer_kind(cfg: ModelConfig, j: int) -> str:
    """The mixer of in-group layer ``j``: "attn", "mamba" or (family
    "ssm") "rwkv"."""
    if cfg.family == "ssm":
        return "rwkv"
    return "attn" if cfg.is_attn_layer(j) else "mamba"


def ffn_kind(cfg: ModelConfig, j: int) -> str:
    """The feed-forward of in-group layer ``j``: "moe", "mlp" or (family
    "ssm") the RWKV channel mix "cmix"."""
    if cfg.family == "ssm":
        return "cmix"
    return "moe" if cfg.is_moe_layer(j) else "mlp"


def attn_shapes(cfg: ModelConfig, g: int) -> Dict:
    """An attention layer's (G, ...) leaves: projections, the biases and
    q/k norms the config asks for."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    down = 0.02 / cfg.n_layers ** 0.5
    attn = {"wq": ((g, d, h * hd), 0.02), "wk": ((g, d, hkv * hd), 0.02),
            "wv": ((g, d, hkv * hd), 0.02), "wo": ((g, h * hd, d), down)}
    if cfg.qkv_bias:
        attn.update(bq=((g, h * hd), "zeros"), bk=((g, hkv * hd), "zeros"),
                    bv=((g, hkv * hd), "zeros"))
    if cfg.qk_norm:
        attn.update(q_norm=((g, hd), "ones"), k_norm=((g, hd), "ones"))
    return attn


def mlp_shapes(cfg: ModelConfig, g: int) -> Dict:
    """An MLP layer's (G, ...) leaves (SwiGLU or gelu, biases)."""
    d, f = cfg.d_model, cfg.d_ff
    mlp = {"w_up": ((g, d, f), 0.02),
           "w_down": ((g, f, d), 0.02 / cfg.n_layers ** 0.5)}
    if cfg.act == "swiglu":
        mlp["w_gate"] = ((g, d, f), 0.02)
    elif cfg.act != "gelu":
        raise ValueError(f"unknown act {cfg.act!r}; one of ('swiglu', "
                         "'gelu')")
    if cfg.mlp_bias:
        mlp.update(b_up=((g, f), "zeros"), b_down=((g, d), "zeros"))
    return mlp


def param_shapes(cfg: ModelConfig) -> Dict:
    """Nested {name: (shape, init)} with init "ones", "zeros", a
    truncated-normal std, ``("full", v)`` or "a_log" (log(1..N) along the
    last axis, ``models/ssm.py``) — the shapes and inits of the JAX init.
    A Mamba layer holds ``mamba`` (``ssm.mamba_param_shapes``), an RWKV
    layer ``rwkv`` and ``cmix`` (``rwkv.rwkv_param_shapes``). Biases
    (``qkv_bias``: bq / bk / bv; ``mlp_bias``: b_up / b_down) are stacked
    (G, n) like every block leaf and start at zero, as in JAX. A MoE layer
    holds ``moe``: a raw ``router`` (G, d, E) and ``experts`` (G, E, d, f)
    / (G, E, f, d)."""
    if cfg.family not in ("dense", "moe", "hybrid", "ssm", "vlm"):
        raise ValueError(f"the decoder-only stack builds the dense, MoE, "
                         f"hybrid, ssm and vlm families, got {cfg.family!r}"
                         " (encdec: models/encdec.py)")
    d, f = cfg.d_model, cfg.d_ff
    g = cfg.n_groups
    down = 0.02 / cfg.n_layers ** 0.5
    attn, mlp = attn_shapes(cfg, g), mlp_shapes(cfg, g)
    e = cfg.moe_experts
    moe = {"router": ((g, d, e), 0.02),
           "experts": {"w_gate": ((g, e, d, f), 0.02),
                       "w_up": ((g, e, d, f), 0.02),
                       "w_down": ((g, e, f, d), down)}}

    def block(j):
        blk = {"mixer_norm": ((g, d), "ones"), "ffn_norm": ((g, d), "ones")}
        if mixer_kind(cfg, j) == "rwkv":
            blk.update(rwkv.rwkv_param_shapes(cfg, g))
            return blk
        if mixer_kind(cfg, j) == "attn":
            blk["attn"] = attn
        else:
            blk["mamba"] = ssm.mamba_param_shapes(cfg, g)
        if ffn_kind(cfg, j) == "moe":
            blk["moe"] = moe
        else:
            blk["mlp"] = mlp
        return blk

    shapes = {"embed": ((cfg.vocab, d), 0.02),
              "blocks": [block(j) for j in range(cfg.scan_group)],
              "final_norm": ((d,), "ones")}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((d, cfg.vocab), 0.02)
    return shapes


def param_leaves(cfg: ModelConfig, shapes=None):
    """[(keystr path, (shape, init))] of ``shapes`` (default
    ``param_shapes(cfg)``) in ``init_params``' order (dict keys sorted, as
    JAX flattens)."""
    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k], f"{prefix}['{k}']")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                yield from walk(v, f"{prefix}[{i}]")
        else:
            yield prefix, node
    return list(walk(param_shapes(cfg) if shapes is None else shapes, ""))


def init_leaf(shape, init, gen: torch.Generator) -> torch.Tensor:
    """One f32 leaf of ``param_shapes`` on ``gen``'s device; a truncated
    normal draws from ``gen``."""
    dev = gen.device
    if init in ("ones", "zeros"):
        fill = torch.ones if init == "ones" else torch.zeros
        return fill(shape, dtype=torch.float32, device=dev)
    if isinstance(init, tuple):
        return torch.full(shape, init[1], dtype=torch.float32, device=dev)
    if init == "a_log":
        n = torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=dev)
        return torch.log(n).expand(shape).contiguous()
    t = torch.empty(shape, dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0, generator=gen)
    return t.mul_(init)


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                shapes=None) -> Dict:
    """Float32 master weights of ``shapes`` (default ``param_shapes(cfg)``)
    from a seeded ``torch.Generator`` on ``device``: truncated normal at
    ±2 std, the JAX init's stds."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return unflatten_paths({path: init_leaf(shape, init, gen) for path,
                            (shape, init) in param_leaves(cfg, shapes)})


def attn_axes(cfg: ModelConfig) -> Dict:
    """An attention layer's (unstacked) logical axes: q / k / v
    column-parallel, wo row-parallel, the biases with their heads, the q/k
    norms replicated."""
    attn = {"wq": ("fsdp", "model"), "wk": ("fsdp", "model"),
            "wv": ("fsdp", "model"), "wo": ("model", "fsdp")}
    if cfg.qkv_bias:
        attn.update(bq=("model",), bk=("model",), bv=("model",))
    if cfg.qk_norm:
        attn.update(q_norm=(None,), k_norm=(None,))
    return attn


def mlp_axes(cfg: ModelConfig) -> Dict:
    """An MLP layer's: gate / up column-parallel, down row-parallel."""
    if cfg.act == "swiglu":
        mlp = {"w_gate": ("fsdp", "mlp"), "w_up": ("fsdp", "mlp"),
               "w_down": ("mlp", "fsdp")}
    else:
        mlp = {"w_up": ("fsdp", "mlp"), "w_down": ("mlp", "fsdp")}
    if cfg.mlp_bias:
        mlp.update(b_up=("mlp",), b_down=(None,))
    return mlp


def moe_axes(cfg: ModelConfig) -> Dict:
    """A MoE layer's: the raw router over d_model, the experts over
    ``experts`` (expert parallelism where the rules map it) and ``mlp``."""
    return {"router": ("fsdp", None),
            "experts": {"w_gate": ("experts", "fsdp", "mlp"),
                        "w_up": ("experts", "fsdp", "mlp"),
                        "w_down": ("experts", "mlp", "fsdp")}}


def block_axes(cfg: ModelConfig, j: int) -> Dict:
    """In-group layer ``j``'s (unstacked) logical axes, by mixer and
    feed-forward kind, the reference's ``block_axes``."""
    mk, fk = mixer_kind(cfg, j), ffn_kind(cfg, j)
    p: Dict = {"mixer_norm": (None,), "ffn_norm": (None,)}
    if mk == "attn":
        p["attn"] = attn_axes(cfg)
    elif mk == "mamba":
        p["mamba"] = ssm.mamba_param_axes(cfg)
    else:
        p["rwkv"] = rwkv.rwkv_param_axes(cfg)["time"]
    if fk == "moe":
        p["moe"] = moe_axes(cfg)
    elif fk == "mlp":
        p["mlp"] = mlp_axes(cfg)
    else:
        p["cmix"] = rwkv.rwkv_param_axes(cfg)["channel"]
    return p


def stack_axes(tree):
    """Every axes tuple of ``tree`` with a leading None: the stacked layer
    (group) axis."""
    if isinstance(tree, dict):
        return {k: stack_axes(v) for k, v in tree.items()}
    return (None,) + tuple(tree)


def param_axes(cfg: ModelConfig) -> Dict:
    """Logical axis names of every leaf of the parameter tree, the
    reference's (``sharding/rules.py`` maps them onto a mesh), for every
    mixer and feed-forward kind: the embedding and the head vocab-sharded,
    norms replicated, block leaves with a leading None for the stacked
    group axis."""
    axes = {"embed": ("vocab", "fsdp"),
            "blocks": [stack_axes(block_axes(cfg, j))
                       for j in range(cfg.scan_group)],
            "final_norm": (None,)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("fsdp", "vocab")
    return axes


def cache_axes(cfg: ModelConfig, kv_layout: str = "dense") -> Dict:
    """Logical axis names of the KV cache's leaves, the reference's: dense
    K / V (G, B, S, Hkv, D) over the batch and the sequence, paged pools
    (G, P, ps, Hkv, D) over the page axis, the block table over the batch.
    (The tensor-parallel engine places its pools by kv head instead, as
    the reference's engine does.)"""
    if kv_layout == "paged":
        pool = (None, "kv_seq", None, None, None)
        return {"blocks": [{"k_pages": pool, "v_pages": pool}
                           for _ in range(cfg.scan_group)],
                "block_table": ("batch", None)}
    kv = (None, "batch", "kv_seq", None, None)
    return {"blocks": [{"k": kv, "v": kv} for _ in range(cfg.scan_group)]}


# =============================================================================
# Forward
# =============================================================================
def _group_params(tree, g: int):
    """The layer-group ``g`` view of a stacked block tree."""
    if isinstance(tree, dict):
        return {k: _group_params(v, g) for k, v in tree.items()}
    return layer_slice(tree, g)


def _densify_group_axis(tree):
    """A stacked block tree with every packed leaf whose MX blocks run
    along the layer axis densified (float32): at G % 32 == 0 the anchor
    quantizes a (G, d) vector leaf that way (rwkv6-7b's ``mix_*``, ROADMAP
    C.11), so no layer owns a block and a row is read from the whole
    leaf. Once per forward, instead of once per layer in ``layer_slice``."""
    if isinstance(tree, dict):
        return {k: _densify_group_axis(v) for k, v in tree.items()}
    if is_packed_leaf(tree) and tree.block_axis == 0:
        return densify_leaf(tree, None, torch.float32)
    return tree


def _layer(ctx: QuantCtx, x, p, cfg: ModelConfig, j: int, positions,
           cs, cache_len, block_table, monolithic: bool,
           chunk_start, q_len, attn_impl: str):
    """One block against ``cs``, the layer group's cache slice (None in
    training): K/V land in ``cs["k"]`` / ``cs["v"]`` (or the page pools),
    a Mamba layer's state in ``cs["h"]`` / ``cs["conv"]``, an RWKV layer's
    in ``cs["shift_t"]`` / ``cs["wkv"]`` / ``cs["shift_c"]``, in place.
    Returns (x, aux): the MoE layer's aux loss, None otherwise."""
    mk = mixer_kind(cfg, j)
    if mk != "attn" and cs is not None and not monolithic:
        chunked = chunk_start is not None
        if chunked or q_len is not None:
            raise ValueError(
                f"{'chunked prefill' if chunked else 'the mixed tick'} "
                f"requires attention mixers; layer {j} of family "
                f"{cfg.family!r} is {mk!r} (its recurrent state cannot "
                "resume mid-prompt) — use monolithic admission")
    h = L.rms_norm(x, p["mixer_norm"], cfg.norm_eps)
    carried = cs is not None and not monolithic
    if mk == "rwkv":
        out, (shift, wkv) = rwkv.rwkv_time_mix(
            ctx, h, p["rwkv"], cfg, f"blk{j}.rwkv",
            state=(cs["shift_t"], cs["wkv"]) if carried else None)
        x = x + out
        h = L.rms_norm(x, p["ffn_norm"], cfg.norm_eps)
        out, shift_c = rwkv.rwkv_channel_mix(
            ctx, h, p["cmix"], cfg, f"blk{j}.cmix",
            state=cs["shift_c"] if carried else None)
        if cs is not None:
            cs["shift_t"].copy_(shift)
            cs["wkv"].copy_(wkv)
            cs["shift_c"].copy_(shift_c)
        return x + out, None
    if mk == "mamba":
        state = (cs["h"], cs["conv"]) if carried else None
        out, (hst, conv) = ssm.mamba_block(ctx, h, p["mamba"], cfg,
                                           f"blk{j}.mamba", state=state)
        if cs is not None:
            cs["h"].copy_(hst)
            cs["conv"].copy_(conv)
        return _ffn(ctx, x + out, p, cfg, j)
    kc = vc = None
    if cs is not None:
        kc, vc = (cs["k_pages"], cs["v_pages"]) if block_table is not None \
            else (cs["k"], cs["v"])
    out, (k_new, v_new) = L.attention_block(
        ctx, h, p["attn"], cfg, positions, f"blk{j}.attn",
        kv_cache=None if monolithic else (kc, vc),
        cache_len=cache_len, block_table=block_table,
        chunk_start=chunk_start, q_len=q_len, attn_impl=attn_impl)
    if monolithic and block_table is not None:
        L.paged_prefill_update(kc, k_new, block_table)
        L.paged_prefill_update(vc, v_new, block_table)
    elif monolithic and cs is not None:
        s = k_new.shape[1]
        kc[:, :s] = k_new.to(kc.dtype)
        vc[:, :s] = v_new.to(vc.dtype)
    return _ffn(ctx, x + out, p, cfg, j)


def _ffn(ctx: QuantCtx, x, p, cfg: ModelConfig, j: int):
    """The block's feed-forward half on the residual ``x``: (x, aux)."""
    h = L.rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if ffn_kind(cfg, j) == "moe":
        out, aux = L.moe_block(ctx, h, p["moe"], cfg, f"blk{j}.moe")
    else:
        out, aux = L.mlp_block(ctx, h, p["mlp"], cfg, f"blk{j}.mlp"), None
    return x + out, aux


def forward_hidden(ctx: QuantCtx, params, cfg: ModelConfig, x, positions,
                   cache, cache_len, prefill: bool,
                   chunk_start: Optional[int] = None, q_len=None,
                   attn_impl: str = "gather"):
    """Run the block stack over x (B, S, d); the cache is updated in place.

    Monolithic prefill (``prefill`` without ``chunk_start``) attends
    causally over x and writes each layer's K/V at positions [0, S) — of a
    batch-row view of the dense cache, or through ``cache["block_table"]``
    when paged; with no cache (training) nothing is written. Chunked prefill
    (``chunk_start``), the mixed tick (``q_len``) and decode read and write
    the cache inside ``attention_block``. Training (no cache, grad enabled)
    under ``cfg.remat`` recomputes each layer group's body in the backward
    (and, with ``remat_inner`` and ``scan_group > 1``, each layer inside
    it), keeping only the group inputs. With ``cfg.seq_sharding`` under
    tensor parallelism (``_seq_parallel``) the residual stream between
    groups is this process's slice of the sequence: cut before the first
    group and at the end of each, gathered at the start of each and after
    the last, so a group's saved input is 1 / tp of the sequence (the
    reference's ``seq_sp`` residual). Returns the final-norm hidden states
    (B, S, d) and the layers' summed MoE aux loss.
    """
    block_table = cache.get("block_table") if cache is not None else None
    monolithic = prefill and chunk_start is None
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    blocks = [_densify_group_axis(b) for b in params["blocks"]]

    def layer_fn(j):
        def run(xv, p, cs):
            return _layer(ctx, xv, p, cfg, j, positions, cs, cache_len,
                          block_table, monolithic, chunk_start, q_len,
                          attn_impl)
        if remat and cfg.remat_inner and cfg.scan_group > 1:
            return lambda *a: checkpoint(run, *a, use_reentrant=False)
        return run

    layers = [layer_fn(j) for j in range(cfg.scan_group)]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    sp = _seq_parallel(ctx, cfg, x.shape[1])
    if sp is not None:
        x = sp.cut_seq(x)
    for g in range(cfg.n_groups):
        slices = [None if cache is None else
                  {k: t[g] for k, t in cache["blocks"][j].items()}
                  for j in range(cfg.scan_group)]

        def group_body(xv, aux, g=g, slices=slices):
            if sp is not None:
                xv = sp.gather_seq(xv)
            for j in range(cfg.scan_group):
                p = _group_params(blocks[j], g)
                xv, a = layers[j](xv, p, slices[j])
                if a is not None:
                    aux = aux + a
            if sp is not None:
                xv = sp.cut_seq(xv)
            return xv, aux

        if remat:
            x, aux = checkpoint(group_body, x, aux, use_reentrant=False)
        else:
            x, aux = group_body(x, aux)
    if sp is not None:
        x = sp.gather_seq(x)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def _seq_parallel(ctx: QuantCtx, cfg: ModelConfig,
                  s: int) -> Optional[TensorParallel]:
    """The group the residual stream's sequence is sharded over between
    layer groups, or None: ``cfg.seq_sharding`` under tensor parallelism
    over more than one process, at a length above 1 that the group's size
    divides (the reference resolves ``seq_sp`` to ``model`` only there)."""
    tp = ctx.tp
    if not cfg.seq_sharding or tp is None or tp.size <= 1 or s <= 1 \
            or s % tp.size:
        return None
    return tp


def _embed(params, cfg: ModelConfig, tokens, tp=None):
    """Token embeddings. Under tensor parallelism the table is
    vocab-sharded: each token's row lives on one shard, so the ids are
    offset into the local range, rows out of it select exact zeros, and the
    all-reduce gives every shard the true row (bit-identical to the
    unsharded lookup)."""
    emb = params["embed"]
    tokens = tokens.long()
    if tp is not None and emb.shape[0] != cfg.vocab:
        v_local = emb.shape[0]
        local = tokens - tp.rank * v_local
        ok = (local >= 0) & (local < v_local)
        rows = emb[torch.where(ok, local, 0)]
        x = torch.where(ok[..., None], rows, torch.zeros((), dtype=emb.dtype,
                                                         device=emb.device))
        return tp.all_reduce(x).to(cfg.compute_dtype)
    return emb[tokens].to(cfg.compute_dtype)


def _embed_prefixed(params, cfg: ModelConfig, batch, tp=None):
    """Token embeddings behind the batch's ``vision_embeds`` (B, V, d) when
    the config has a vision prefix: (x (B, V + S, d), V)."""
    x = _embed(params, cfg, batch["tokens"], tp)
    if cfg.vision_tokens <= 0:
        return x, 0
    ve = batch["vision_embeds"].to(device=x.device, dtype=cfg.compute_dtype)
    return torch.cat([ve, x], dim=1), ve.shape[1]


def _head_logits(ctx: QuantCtx, params, cfg: ModelConfig, h_last):
    """lm-head projection of the last-position hidden states (B, d), in f32.
    A quantized lm_head leaf (non-default exclusions) goes through the
    dequant-GEMM hook like every other projection. Under tensor parallelism
    the head is vocab-sharded: the shards' logit slices are gathered into
    the global vocab (a concatenation, so bit-identical)."""
    if not cfg.tie_embeddings and ctx.qmm is not None and \
            is_packed_leaf(params["lm_head"]):
        logits = ctx.qmm(h_last.to(torch.float32), params["lm_head"],
                         "lm_head")
    else:
        logits = torch.matmul(h_last.to(torch.float32),
                              _lm_head_w(params, cfg).to(torch.float32))
    if ctx.tp is not None and logits.shape[-1] != cfg.vocab:
        logits = ctx.tp.all_gather_last(logits)
    return logits


def _last_hidden(hidden, lengths):
    """hidden (B, S, d) -> (B, d) at each row's own last real position."""
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    return hidden[rows, lengths.long() - 1]


# Projection weights of a block per feed-forward kind (the MLP's ``act``,
# or "moe"), by sub-tree (a dotted path) and leaf name, named as ``dense``
# names them (``blk{j}.attn.wq``, ...): the leaves MF-QAT fake-quantizes.
# Weights only: JAX's ``dense`` fake-quantizes ``w`` and adds the bias raw;
# the MoE router stays raw (``core/qat.py::DEFAULT_EXCLUDE``).
PROJECTIONS = {
    "swiglu": {"attn": ("wq", "wk", "wv", "wo"),
               "mlp": ("w_gate", "w_up", "w_down")},
    "gelu": {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("w_up", "w_down")},
    "moe": {"attn": ("wq", "wk", "wv", "wo"),
            "moe.experts": ("w_gate", "w_up", "w_down")},
}


# A Mamba layer's projections, in place of attention's: ``dt_w`` and the
# other SSM leaves stay raw (``DEFAULT_EXCLUDE``'s ``dt_``, ``A_log``,
# ``D``, ``conv``), as JAX's ``dense`` never sees them.
MAMBA_PROJECTIONS = {"mamba": ("in_proj", "x_proj", "out_proj")}

# An RWKV layer's eight: the decay LoRA is a plain product in JAX too.
RWKV_PROJECTIONS = {"rwkv": ("wr", "wk", "wv", "wg", "wo"),
                    "cmix": ("w_key", "w_value", "w_recept")}


def projections(cfg: ModelConfig, j: int) -> Dict:
    """``PROJECTIONS`` of in-group layer ``j`` (a Mamba layer's mixer
    ``MAMBA_PROJECTIONS``, an RWKV layer ``RWKV_PROJECTIONS``)."""
    if mixer_kind(cfg, j) == "rwkv":
        return RWKV_PROJECTIONS
    out = PROJECTIONS["moe" if ffn_kind(cfg, j) == "moe" else cfg.act]
    if mixer_kind(cfg, j) == "mamba":
        out = dict(MAMBA_PROJECTIONS, **{k: v for k, v in out.items()
                                         if k != "attn"})
    return out


def fake_quant_projections(qat: QATConfig, fmt_idx: int, blk, subs: Dict,
                           cfg: ModelConfig, prefix: str):
    """The stacked block tree ``blk`` with the leaves ``subs`` names
    (``{dotted sub-tree: leaf names}``) fake-quantized (STE) at format
    ``fmt_idx`` once for the whole stack, in the compute dtype. A
    (G, d_in, d_out) leaf, or a (G, E, d_in, d_out) expert leaf, is blocked
    at ndim-2 (``qat.pytree_block_axis``), so each layer and expert slice
    gets the value JAX's ``dense`` gives it."""
    blk = dict(blk)
    for sub, names in subs.items():
        path = sub.split(".")
        node = blk
        for key in path[:-1]:
            node[key] = dict(node[key])
            node = node[key]
        leaves = node[path[-1]] = dict(node[path[-1]])
        for n in names:
            w = leaves[n]
            leaves[n] = qat.apply(w, f"{prefix}.{sub}.{n}", fmt_idx,
                                  axis=qat.block_axis % 2 + w.ndim - 2,
                                  out_dtype=cfg.compute_dtype)
    return blk


def fake_quant_blocks(qat: QATConfig, fmt_idx: int, params,
                      cfg: ModelConfig):
    """``params`` with every block's ``projections`` fake-quantized."""
    return dict(params, blocks=[
        fake_quant_projections(qat, fmt_idx, blk, projections(cfg, j), cfg,
                               f"blk{j}")
        for j, blk in enumerate(params["blocks"])])


def _lm_head_w(params, cfg: ModelConfig):
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


def chunked_ce_loss(hidden, head_w, labels, mask, cfg: ModelConfig,
                    tp: Optional[TensorParallel] = None, dp=None):
    """Mean cross entropy over the masked positions, with the f32 logits
    taken ``seq_chunk`` positions at a time (JAX's scan over chunks).
    Under tensor parallelism a vocab-sharded head's logit slices are
    gathered into the global vocab. With ``dp`` (the batch axes' group of a
    sharded step) the masked sum and the count are summed over the batch's
    shards first: one global masked mean, as on one device."""
    s = hidden.shape[1]
    c = min(cfg.seq_chunk, s)
    while s % c:
        c //= 2
    gather = tp is not None and head_w.shape[-1] != cfg.vocab
    if gather:
        hidden = tp.copy_in(hidden)
    w = head_w.to(torch.float32)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, c):
        logits = torch.matmul(hidden[:, i:i + c].to(torch.float32), w)
        if gather:
            logits = tp.all_gather_last(logits)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, labels[:, i:i + c, None].long())[..., 0]
        mk = mask[:, i:i + c]
        tot = tot + torch.sum((lse - tgt) * mk)
        cnt = cnt + torch.sum(mk)
    if dp is not None:
        tot, cnt = dp.all_reduce(tot), dp.all_reduce(cnt)
    return tot / torch.clamp(cnt, min=1.0)


def _slot_view(cache, slot: int):
    """The cache as one slot sees it: on the paged layout the pools and the
    slot's block-table row (its pages are its isolation), on the dense
    layout a batch-row view of every K/V and state buffer."""
    if is_paged_cache(cache):
        return dict(cache, block_table=cache["block_table"][slot:slot + 1])
    return {"blocks": [{k: c[k][:, slot:slot + 1] for k in c}
                       for c in cache["blocks"]]}


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig
    init_params: Callable         # (seed, device=) -> params
    train_loss: Callable          # (params, batch, fmt_idx=None) -> (loss,
    #                               {"ce", "aux"}), differentiable
    init_cache: Callable          # (batch, s_max, dtype=None, device=,
    #                               kv_layout=, page_size=, num_pages=)
    prefill: Callable             # (params, batch, cache) -> (logits, cache, len)
    serve_step: Callable          # (params, batch, cache, len) -> (logits, cache)
    prefill_slot: Callable        # (params, batch(1,S), cache, slot)
    #                               -> (logits (V,), cache, len scalar)
    prefill_chunk: Callable       # (params, batch(B,C), cache, start_pos)
    #                               -> (logits, cache, len): one prompt chunk
    prefill_chunk_slot: Callable  # (params, batch(1,C), cache, slot,
    #                               start_pos) -> (logits (V,), cache, len)
    mixed_step: Callable          # (params, batch{tokens (B,C), q_len (B,)},
    #                               cache, cache_len) -> (logits (B,V), cache)
    verify_step: Callable         # mixed_step's batch -> (logits (B,C,V),
    #                               cache): every query position's logits
    with_qmm: Callable            # (qmm) -> ModelApi routing packed leaves
    #                               through the dequant-GEMM hook, keeping
    #                               this api's attn_impl
    with_serving: Callable        # (qmm=None, attn_impl="gather") -> ModelApi
    #                               with both serving knobs baked in
    attn_impl: str = "gather"     # paged read path: "gather" | "paged_kernel"
    qat: Optional[QATConfig] = None   # the MF-QAT config train_loss runs


def make_model(cfg: ModelConfig, qmm: Optional[Callable] = None,
               attn_impl: str = "gather",
               qat: Optional[QATConfig] = None,
               tp: Optional[TensorParallel] = None,
               dp: Optional[DataParallel] = None) -> ModelApi:
    """The ModelApi of ``cfg``. ``tp`` (the reference's ``tp_axis``): the
    entry points run on this process's shard of the weights, as
    ``tp.dims`` describes it (``models/__init__.py::shard_dims``; ``cfg``
    stays the global config) and all-reduce / all-gather over ``tp``'s
    group: the row-parallel projections, the MoE layer's partial outputs,
    the vocab-sharded embedding, the head's logit slices;
    ``train_loss``'s gradients are the single device's, sharded.
    ``dp``: ``train_loss`` runs on this process's rows of a batch sharded
    over that group and returns the whole batch's loss (a sharded training
    step, ``train/state.py``). None is the single-device math."""
    if attn_impl not in ("gather", "paged_kernel"):
        raise ValueError(f"unknown attn_impl {attn_impl!r}; one of "
                         "('gather', 'paged_kernel')")
    ctx = QuantCtx(qmm=qmm, tp=tp)
    n_fmts = len(qat.formats) if qat else 0

    def train_loss(params, batch, fmt_idx=None):
        """Next-token cross entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (optional ``batch["mask"]``) with every
        projection fake-quantized at format ``fmt_idx`` (a host int; None is
        the pass-through branch). A vision config's batch carries
        ``vision_embeds`` (B, V, d), prepended; the loss is over the text
        positions. Returns ``(loss, {"ce", "aux"})``; the graph reaches
        every leaf of ``params`` that requires grad."""
        qparams = params
        if qat is not None and qat.enabled:
            qparams = fake_quant_blocks(
                qat, n_fmts if fmt_idx is None else int(fmt_idx), params, cfg)
        x, extra = _embed_prefixed(params, cfg, batch, tp)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        hidden, aux = forward_hidden(QuantCtx(tp=tp, dp=dp), qparams, cfg, x,
                                     positions, None, None, prefill=True)
        hidden = hidden[:, extra:]
        labels = batch["labels"]
        mask = batch.get("mask")
        mask = torch.ones(labels.shape, device=x.device) if mask is None \
            else mask.to(torch.float32)
        loss = chunked_ce_loss(hidden, _lm_head_w(params, cfg), labels, mask,
                               cfg, tp, dp)
        return loss + aux, {"ce": loss, "aux": aux}

    def init_cache(b, s_max, dtype=None, *, device="cuda",
                   kv_layout="dense", page_size=16, num_pages=None):
        """KV cache, with room for ``s_max`` tokens behind the vision
        prefix. ``"dense"``: per stacked group, K and V (G, B, s_max, Hkv,
        D) for an attention layer, ``h`` (G, B, d_inner, N) f32 and
        ``conv`` (G, B, d_conv-1, d_inner) for a Mamba layer, ``shift_t``
        and ``shift_c`` (G, B, 1, d) and ``wkv`` (G, B, H, hd, hd) f32 for
        an RWKV layer. ``"paged"``
        (pure-attention stacks only): per stacked group, page pools
        (G, P, ps, Hkv, D) for K and V plus a ``block_table``
        (B, ceil(s_max/ps)) int32 of physical page ids; page 0 is scratch,
        and ``num_pages=None`` gives every slot room for ``s_max`` tokens
        (P = B * pages_per_slot + 1)."""
        dev = resolve_device(device)
        dtype = dtype or cfg.compute_dtype
        s_max = s_max + cfg.vision_tokens
        g = cfg.n_groups
        sd = ctx.shard(cfg)

        def zeros(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=dev)

        if kv_layout == "dense":
            blocks = []
            for j in range(cfg.scan_group):
                if mixer_kind(cfg, j) == "attn":
                    shape = (g, b, s_max, sd.n_kv_heads, cfg.hd)
                    blocks.append({"k": zeros(shape), "v": zeros(shape)})
                elif mixer_kind(cfg, j) == "rwkv":
                    d, hd = cfg.d_model, cfg.rwkv_head_dim
                    blocks.append({
                        "shift_t": zeros((g, b, 1, d)),
                        "wkv": zeros((g, b, sd.rwkv_heads, hd, hd),
                                     torch.float32),
                        "shift_c": zeros((g, b, 1, d))})
                else:
                    di = sd.d_inner
                    blocks.append({
                        "h": zeros((g, b, di, cfg.mamba_d_state),
                                   torch.float32),
                        "conv": zeros((g, b, cfg.mamba_d_conv - 1, di))})
            return {"blocks": blocks}
        if kv_layout != "paged":
            raise ValueError(f"unknown kv_layout {kv_layout!r}; one of "
                             "('dense', 'paged')")
        bad = [mixer_kind(cfg, j) for j in range(cfg.scan_group)
               if mixer_kind(cfg, j) != "attn"]
        if bad:
            raise ValueError(
                f"kv_layout='paged' requires a pure-attention stack; "
                f"family {cfg.family!r} has {bad} mixers whose recurrent "
                "state cannot be paged — use kv_layout='dense'")
        pages_per_slot = -(-s_max // page_size)
        if num_pages is None:
            num_pages = b * pages_per_slot + 1
        shape = (cfg.n_groups, num_pages, page_size, sd.n_kv_heads, cfg.hd)
        return {"blocks": [
            {"k_pages": torch.zeros(shape, dtype=dtype, device=dev),
             "v_pages": torch.zeros(shape, dtype=dtype, device=dev)}
            for _ in range(cfg.scan_group)],
            "block_table": torch.zeros((b, pages_per_slot),
                                       dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def prefill(params, batch, cache):
        """Process whole prompts, fill the cache, return last-position
        logits. ``batch["lengths"]`` (B,), optional: true prompt lengths of
        right-padded (bucketed) prompts — logits are read at each row's own
        last real token and cache_len is the true length. A vision config's
        ``batch["vision_embeds"]`` (B, V, d) goes first; cache_len counts
        it."""
        x, extra = _embed_prefixed(params, cfg, batch, tp)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        hidden, _ = forward_hidden(ctx, params, cfg, x, positions, cache,
                                   None, prefill=True)
        lengths = batch.get("lengths")
        if lengths is None:
            cache_len = torch.full((b,), s, dtype=torch.int32,
                                   device=x.device)
        else:
            cache_len = lengths.to(device=x.device, dtype=torch.int32) \
                + extra
        h_last = _last_hidden(hidden, cache_len)
        return _head_logits(ctx, params, cfg, h_last), cache, cache_len

    def prefill_slot(params, batch, cache, slot: int):
        """One request (tokens (1, S)) into slot ``slot``; other slots are
        untouched. Dense: the slot's rows are zeroed first, so positions
        past the prompt read as zeros, as in the JAX scratch-then-insert
        version. Paged: the prompt lands in the pages the slot's row maps."""
        view = _slot_view(cache, slot)
        if not is_paged_cache(cache):
            for c in view["blocks"]:
                for t in c.values():
                    t.zero_()
        logits, _, clen = prefill(params, batch, view)
        return logits[0], cache, clen[0]

    @torch.no_grad()
    def prefill_chunk(params, batch, cache, start_pos: int):
        """One prompt chunk at cursor ``start_pos``: ``batch["tokens"]``
        (B, C) is the prompt slice [start_pos, start_pos + C) (the final
        chunk may be right-padded), ``batch["lengths"]`` (B,) the true total
        prompt length. K/V land at the cursor and the chunk's queries attend
        over everything written so far. Returns ``(logits, cache,
        new_len)``, ``new_len = min(lengths, start_pos + C)``; the logits
        are read at the last real token (meaningful on the final chunk)."""
        if cfg.vision_tokens > 0:
            raise ValueError(
                "chunked prefill does not support prepended vision "
                "embeds; use monolithic admission")
        tokens = batch["tokens"]
        b, c = tokens.shape
        x = _embed(params, cfg, tokens, tp)
        positions = (start_pos + torch.arange(c, device=x.device)).expand(b, c)
        hidden, _ = forward_hidden(ctx, params, cfg, x, positions, cache,
                                   None, prefill=True, chunk_start=start_pos)
        new_len = torch.clamp(batch["lengths"].to(device=x.device,
                                                  dtype=torch.int32),
                              max=start_pos + c)
        h_last = _last_hidden(hidden, new_len - start_pos)
        return _head_logits(ctx, params, cfg, h_last), cache, new_len

    def prefill_chunk_slot(params, batch, cache, slot: int, start_pos: int):
        """``prefill_chunk`` of one request (tokens (1, C)) in slot
        ``slot``: through the slot's block-table row when paged, on a view
        of the slot's rows (not zeroed: chunk N sees chunks 0..N-1) when
        dense."""
        logits, _, clen = prefill_chunk(params, batch, _slot_view(cache, slot),
                                        start_pos)
        return logits[0], cache, clen[0]

    @torch.no_grad()
    def serve_step(params, batch, cache, cache_len):
        """One decode step: batch["tokens"] (B, 1) against the cache."""
        x = _embed(params, cfg, batch["tokens"], tp)
        hidden, _ = forward_hidden(ctx, params, cfg, x, cache_len[:, None],
                                   cache, cache_len, prefill=False,
                                   attn_impl=attn_impl)
        return _head_logits(ctx, params, cfg, hidden[:, -1]), cache

    @torch.no_grad()
    def mixed_step(params, batch, cache, cache_len):
        """One mixed prefill+decode tick: ``batch["tokens"]`` (B, C) holds
        each row's new tokens left-aligned, ``batch["q_len"]`` (B,) how many
        are real (decode rows 1, the mid-prefill row its chunk); row b's
        token i sits at ``cache_len[b] + i``. Logits come back at each
        row's last real token."""
        if cfg.vision_tokens > 0:
            raise ValueError(
                "mixed_step does not support prepended vision embeds; "
                "use sequential admission")
        tokens = batch["tokens"]
        q_len = batch["q_len"].to(torch.int32)
        b, c = tokens.shape
        x = _embed(params, cfg, tokens, tp)
        positions = cache_len[:, None] + torch.arange(c, device=x.device)
        hidden, _ = forward_hidden(ctx, params, cfg, x, positions, cache,
                                   cache_len, prefill=False, q_len=q_len,
                                   attn_impl=attn_impl)
        return _head_logits(ctx, params, cfg,
                            _last_hidden(hidden, q_len)), cache

    @torch.no_grad()
    def verify_step(params, batch, cache, cache_len):
        """One speculative-verify tick: ``mixed_step``'s contract with
        logits at every query position, (B, C, V). The K/V of all C tokens
        land at each row's cursor before attention reads them, so a verify
        overwrites what the draft steps wrote there: each attempt is a
        function of the committed cache, and a guard replay is safe. Pad
        lanes past a row's q_len give meaningless logits."""
        if cfg.vision_tokens > 0:
            raise ValueError(
                "verify_step does not support prepended vision embeds; "
                "disable speculative decoding for VLM configs")
        tokens = batch["tokens"]
        q_len = batch["q_len"].to(torch.int32)
        b, c = tokens.shape
        x = _embed(params, cfg, tokens, tp)
        positions = cache_len[:, None] + torch.arange(c, device=x.device)
        hidden, _ = forward_hidden(ctx, params, cfg, x, positions, cache,
                                   cache_len, prefill=False, q_len=q_len,
                                   attn_impl=attn_impl)
        logits = _head_logits(ctx, params, cfg,
                              hidden.reshape(b * c, hidden.shape[-1]))
        return logits.reshape(b, c, -1), cache

    def with_serving(qmm=None, attn_impl="gather"):
        return make_model(cfg, qmm, attn_impl, qat, tp, dp)

    return ModelApi(
        cfg=cfg,
        init_params=functools.partial(init_params, cfg),
        train_loss=train_loss,
        init_cache=init_cache,
        prefill=prefill,
        serve_step=serve_step,
        prefill_slot=prefill_slot,
        prefill_chunk=prefill_chunk,
        prefill_chunk_slot=prefill_chunk_slot,
        mixed_step=mixed_step,
        verify_step=verify_step,
        # the derived api keeps this one's attn_impl: chaining composes
        with_qmm=lambda q: make_model(cfg, q, attn_impl, qat, tp, dp),
        with_serving=with_serving,
        attn_impl=attn_impl,
        qat=qat,
    )
