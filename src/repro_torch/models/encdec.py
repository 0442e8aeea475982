"""Encoder-decoder LM (the seamless-m4t-large-v2 backbone).

Counterpart of ``repro/models/encdec.py``. The speech frontend is a stub,
as in the reference: the encoder takes precomputed frame embeddings
``batch["frame_embeds"]`` (B, Se, d). ``enc_layers`` bidirectional layers
encode them; ``n_layers`` causal decoder layers each attend over
themselves and then over the encoder output (cross attention, no RoPE on
its queries). Both stacks keep the JAX layout — ``{"encoder": {"blocks":
[layers], "final_norm"}, "decoder": {...}, "embed", "lm_head"}`` with every
block leaf stacked over layers — and run as Python loops over layer views;
under ``cfg.remat`` each layer is recomputed in the backward.

Serving caches, per decoder layer, the self-attention K/V (L, B, s_max,
Hkv, D) and the cross-attention K/V of the encoder output (L, B, Se, Hkv,
D), written once at prefill; a decode step reads both and writes its own
K/V in place. Dense layout only (the reference refuses paging). With a
``qmm`` hook (``with_serving``) every packed projection of both stacks
reaches the dequant-GEMM dispatch (``kernels/dispatch.py::qmatmul``,
B1/B2); the reference has no hook for this family and densifies the tree
(ROADMAP C.12: the same function, the densify contract as the oracle).
Training fake-quantizes every stacked projection leaf once per step, as
``models/transformer.py`` does.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.qat import QATConfig
from repro_torch.devices import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import (DataParallel, ModelConfig, QuantCtx,
                                      TensorParallel)

ATTN = ("wq", "wk", "wv", "wo")


def param_shapes(cfg: ModelConfig) -> Dict:
    """Nested {name: (shape, init)} of the JAX init: the encoder's layers
    hold ``attn`` and ``mlp``, the decoder's ``self_attn``, ``cross_attn``
    and ``mlp``, each with its norms."""
    d = cfg.d_model

    def stack(n, names):
        blk = {f"{a}_norm": ((n, d), "ones") for a in names[0]}
        blk.update({a: T.attn_shapes(cfg, n) for a in names[1]})
        blk["mlp"] = T.mlp_shapes(cfg, n)
        return {"blocks": [blk], "final_norm": ((d,), "ones")}

    return {"embed": ((cfg.vocab, d), 0.02),
            "encoder": stack(cfg.enc_layers, (("mixer", "ffn"), ("attn",))),
            "decoder": stack(cfg.n_layers,
                             (("self", "cross", "ffn"),
                              ("self_attn", "cross_attn"))),
            "lm_head": ((d, cfg.vocab), 0.02)}


def param_axes(cfg: ModelConfig) -> Dict:
    """Logical axes of every leaf, the reference's: both stacks' attention
    and MLP leaves as the decoder-only stack's, stacked over layers."""
    enc = {"mixer_norm": (None,), "attn": T.attn_axes(cfg),
           "ffn_norm": (None,), "mlp": T.mlp_axes(cfg)}
    dec = {"self_norm": (None,), "self_attn": T.attn_axes(cfg),
           "cross_norm": (None,), "cross_attn": T.attn_axes(cfg),
           "ffn_norm": (None,), "mlp": T.mlp_axes(cfg)}
    return {"embed": ("vocab", "fsdp"),
            "encoder": {"blocks": [T.stack_axes(enc)],
                        "final_norm": (None,)},
            "decoder": {"blocks": [T.stack_axes(dec)],
                        "final_norm": (None,)},
            "lm_head": ("fsdp", "vocab")}


def projections(cfg: ModelConfig, stack: str) -> Dict:
    """The projection leaves MF-QAT fake-quantizes in one layer of
    ``stack`` ("encoder" or "decoder"), by sub-tree."""
    mlp = T.PROJECTIONS[cfg.act]["mlp"]
    if stack == "encoder":
        return {"attn": ATTN, "mlp": mlp}
    return {"self_attn": ATTN, "cross_attn": ATTN, "mlp": mlp}


def _layers(grad: bool, cfg: ModelConfig, body, x, n: int):
    """x through ``body(x, i)`` for i < n, each layer recomputed in the
    backward under ``cfg.remat`` when ``grad`` (autograd records)."""
    for i in range(n):
        if grad and cfg.remat:
            x = checkpoint(body, x, i, use_reentrant=False)
        else:
            x = body(x, i)
    return x


def _encode(ctx: QuantCtx, params, cfg: ModelConfig, frames):
    """Frame embeddings (B, Se, d) -> the encoder output (B, Se, d)."""
    dev = params["embed"].device
    x = frames.to(device=dev, dtype=cfg.compute_dtype)
    b, se, _ = x.shape
    positions = torch.arange(se, device=dev).expand(b, se)
    blocks = params["encoder"]["blocks"][0]

    def body(xv, i):
        p = T._group_params(blocks, i)
        h = L.rms_norm(xv, p["mixer_norm"], cfg.norm_eps)
        out, _ = L.attention_block(ctx, h, p["attn"], cfg, positions,
                                   "enc.attn", causal=False)
        xv = xv + out
        h = L.rms_norm(xv, p["ffn_norm"], cfg.norm_eps)
        return xv + L.mlp_block(ctx, h, p["mlp"], cfg, "enc.mlp")

    x = _layers(torch.is_grad_enabled(), cfg, body, x, cfg.enc_layers)
    return L.rms_norm(x, params["encoder"]["final_norm"], cfg.norm_eps)


def _cross_attention(ctx: QuantCtx, h, p, cfg: ModelConfig, ck, cv):
    """The decoder's queries (no RoPE) over the encoder K/V: one query a
    row at decode, a non-causal flash pass otherwise."""
    b, s, _ = h.shape
    h_loc = ctx.shard(cfg).n_heads
    q = ctx.dense(ctx.tp_in(h), p["wq"], "dec.cross.wq").reshape(
        b, s, h_loc, cfg.hd)
    if s == 1:
        se = ck.shape[1]
        out = L.decode_attention(q, ck, cv, torch.full(
            (b,), se, dtype=torch.int32, device=h.device))
    else:
        out = L.flash_attention(q, ck, cv, causal=False, chunk=cfg.seq_chunk)
    return ctx.dense(out.reshape(b, s, h_loc * cfg.hd), p["wo"],
                     "dec.cross.wo", tp_reduce=True)


def _decode_stack(ctx: QuantCtx, params, cfg: ModelConfig, x, positions,
                  memory=None, cache=None, cache_len=None,
                  prefill: bool = False):
    """The decoder over x (B, S, d) -> final-norm hidden states. With a
    cache: at prefill each layer's self K/V land at [0, S) and its cross
    K/V (from ``memory``) fill ``ck`` / ``cv``; at decode the step's K/V
    land at ``cache_len`` and the cross attention reads ``ck`` / ``cv``.
    Without one (training) the cross K/V come from ``memory``."""
    blocks = params["decoder"]["blocks"][0]

    def body(xv, i):
        p = T._group_params(blocks, i)
        cs = None if cache is None else \
            {k: t[i] for k, t in cache["blocks"][0].items()}
        h = L.rms_norm(xv, p["self_norm"], cfg.norm_eps)
        kv = (cs["k"], cs["v"]) if cs is not None and not prefill else None
        out, (k, v) = L.attention_block(ctx, h, p["self_attn"], cfg,
                                        positions, "dec.self", kv_cache=kv,
                                        cache_len=cache_len)
        if cs is not None and prefill:
            s = k.shape[1]
            cs["k"][:, :s] = k.to(cs["k"].dtype)
            cs["v"][:, :s] = v.to(cs["v"].dtype)
        xv = xv + out

        h = L.rms_norm(xv, p["cross_norm"], cfg.norm_eps)
        if cs is None or prefill:
            ck, cv = L.cross_kv_from_memory(ctx, memory, p["cross_attn"],
                                            cfg, "dec.cross")
            if cs is not None:
                if ck.shape != cs["ck"].shape:
                    raise ValueError(
                        f"the cache holds {cs['ck'].shape[1]} encoder "
                        f"positions, the frames give {ck.shape[1]}: build "
                        "it with init_cache(s_enc=<frame count>)")
                cs["ck"].copy_(ck)
                cs["cv"].copy_(cv)
        else:
            ck, cv = cs["ck"], cs["cv"]
        xv = xv + _cross_attention(ctx, h, p["cross_attn"], cfg, ck, cv)

        h = L.rms_norm(xv, p["ffn_norm"], cfg.norm_eps)
        return xv + L.mlp_block(ctx, h, p["mlp"], cfg, "dec.mlp")

    grad = cache is None and torch.is_grad_enabled()
    x = _layers(grad, cfg, body, x, cfg.n_layers)
    return L.rms_norm(x, params["decoder"]["final_norm"], cfg.norm_eps)


def _embed(params, cfg: ModelConfig, tokens, tp=None):
    return T._embed(params, cfg, tokens.to(params["embed"].device), tp)


def make_model(cfg: ModelConfig, qmm: Optional[Callable] = None,
               attn_impl: str = "gather",
               qat: Optional[QATConfig] = None,
               tp: Optional[TensorParallel] = None,
               dp: Optional[DataParallel] = None) -> T.ModelApi:
    """The family's ``ModelApi``: ``train_loss``, ``init_cache``,
    ``prefill``, ``prefill_slot``, ``serve_step``, ``with_serving`` /
    ``with_qmm``. Chunked prefill, the mixed tick and the verify are None,
    as in the reference (the engine refuses the family, ROADMAP C.12).
    ``tp``: the entry points run on this process's shard, as
    ``transformer.make_model``'s do: both stacks' attention (the encoder's
    non-causal, the decoder's self and cross attention) on its heads, both
    MLPs on its slice of d_ff, the vocab-sharded embedding and head; the
    cross K/V read the replicated encoder output. ``dp``: ``train_loss``
    over this process's rows of a batch sharded over that group, returning
    the whole batch's loss."""
    if attn_impl != "gather":
        raise ValueError(f"attn_impl={attn_impl!r}: the encdec family "
                         "reads a dense cache only")
    ctx = QuantCtx(qmm=qmm, tp=tp)
    n_fmts = len(qat.formats) if qat else 0

    def fake_quant(params, fmt_idx):
        out = dict(params)
        for stack in ("encoder", "decoder"):
            blk = T.fake_quant_projections(
                qat, fmt_idx, params[stack]["blocks"][0],
                projections(cfg, stack), cfg, stack[:3])
            out[stack] = dict(params[stack], blocks=[blk])
        return out

    def train_loss(params, batch, fmt_idx=None):
        """Next-token cross entropy of the decoder over ``batch["tokens"]``
        against ``batch["labels"]`` (optional ``batch["mask"]``), the
        encoder over ``batch["frame_embeds"]`` (B, Se, d), every projection
        fake-quantized at format ``fmt_idx`` (a host int; None is the
        pass-through branch). Returns ``(loss, {"ce"})``."""
        qparams = params
        if qat is not None and qat.enabled:
            qparams = fake_quant(params,
                                 n_fmts if fmt_idx is None else int(fmt_idx))
        plain = QuantCtx(tp=tp)
        memory = _encode(plain, qparams, cfg, batch["frame_embeds"])
        x = _embed(params, cfg, batch["tokens"], tp)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        hidden = _decode_stack(plain, qparams, cfg, x, positions,
                               memory=memory)
        labels = batch["labels"].to(x.device)
        mask = batch.get("mask")
        mask = torch.ones(labels.shape, device=x.device) if mask is None \
            else mask.to(device=x.device, dtype=torch.float32)
        loss = T.chunked_ce_loss(hidden, params["lm_head"], labels, mask, cfg,
                                 tp, dp)
        return loss, {"ce": loss}

    def init_cache(b, s_max, dtype=None, s_enc=None, *, device="cuda",
                   kv_layout="dense", page_size=16, num_pages=None):
        """Per decoder layer: self K/V (L, B, s_max, Hkv, D) and cross K/V
        (L, B, s_enc, Hkv, D); ``s_enc`` defaults to s_max //
        audio_downsample, as in the reference, and must equal the frame
        count a prefill brings."""
        if kv_layout != "dense":
            raise ValueError(
                f"kv_layout={kv_layout!r}: paged KV requires a pure-attention"
                " stack; the encdec family keeps per-slot cross-attention KV "
                "whose paging is unimplemented — use kv_layout='dense'")
        dev = resolve_device(device)
        dtype = dtype or cfg.compute_dtype
        s_enc = s_enc or max(1, s_max // max(cfg.audio_downsample, 1))
        kvh = (ctx.shard(cfg).n_kv_heads, cfg.hd)

        def zeros(s):
            return torch.zeros((cfg.n_layers, b, s) + kvh, dtype=dtype,
                               device=dev)

        return {"blocks": [{"k": zeros(s_max), "v": zeros(s_max),
                            "ck": zeros(s_enc), "cv": zeros(s_enc)}]}

    @torch.no_grad()
    def prefill(params, batch, cache):
        """Encode ``batch["frame_embeds"]``, run the prompts through the
        decoder filling the cache, return last-position logits, the cache
        and the lengths."""
        memory = _encode(ctx, params, cfg, batch["frame_embeds"])
        x = _embed(params, cfg, batch["tokens"], tp)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        hidden = _decode_stack(ctx, params, cfg, x, positions, memory=memory,
                               cache=cache, prefill=True)
        return (T._head_logits(ctx, params, cfg, hidden[:, -1]), cache,
                torch.full((b,), s, dtype=torch.int32, device=x.device))

    def prefill_slot(params, batch, cache, slot: int):
        """One request (tokens (1, S), frame_embeds (1, Se, d)) into slot
        ``slot``; its rows are zeroed first, the other slots untouched."""
        view = {"blocks": [{k: t[:, slot:slot + 1]
                            for k, t in cache["blocks"][0].items()}]}
        for t in view["blocks"][0].values():
            t.zero_()
        logits, _, clen = prefill(params, batch, view)
        return logits[0], cache, clen[0]

    @torch.no_grad()
    def serve_step(params, batch, cache, cache_len):
        """One decode step: batch["tokens"] (B, 1) against the cache."""
        x = _embed(params, cfg, batch["tokens"], tp)
        hidden = _decode_stack(ctx, params, cfg, x, cache_len[:, None],
                               cache=cache, cache_len=cache_len)
        return T._head_logits(ctx, params, cfg, hidden[:, -1]), cache

    def with_serving(qmm=None, attn_impl="gather"):
        return make_model(cfg, qmm, attn_impl, qat, tp, dp)

    return T.ModelApi(
        cfg=cfg,
        init_params=functools.partial(T.init_params, cfg,
                                      shapes=param_shapes(cfg)),
        train_loss=train_loss,
        init_cache=init_cache,
        prefill=prefill,
        serve_step=serve_step,
        prefill_slot=prefill_slot,
        prefill_chunk=None,
        prefill_chunk_slot=None,
        mixed_step=None,
        verify_step=None,
        with_qmm=lambda q: make_model(cfg, q, attn_impl, qat, tp, dp),
        with_serving=with_serving,
        attn_impl=attn_impl,
        qat=qat,
    )
