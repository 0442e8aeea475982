"""Dense decoder-only LM: init, dense KV cache, prefill and decode step.

Counterpart of the dense family of ``repro/models/transformer.py``. The
parameter tree keeps the JAX layout — ``{"embed", "blocks": [group], ...}``
with every block leaf stacked over layer groups (G, ...) — so anchor
checkpoints map 1:1; the JAX ``lax.scan`` over groups becomes a Python loop
over ``leaf[g]`` views. The dense KV cache is updated in place.

Entry points (``ModelApi``): ``prefill``, ``prefill_slot`` (one request into
one slot of the batched cache), ``serve_step`` (one token for every slot),
``with_qmm`` (the same entry points with a dequant-GEMM hook).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch

from repro_torch.devices import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig, QuantCtx
from repro_torch.serve.packed_params import is_packed_leaf, layer_slice


# =============================================================================
# Init
# =============================================================================
def param_shapes(cfg: ModelConfig) -> Dict:
    """Nested {name: (shape, init)} with init "ones" or a truncated-normal
    std — the shapes and stds of the JAX init."""
    if cfg.family != "dense":
        raise ValueError(f"the port serves the dense family only, got "
                         f"{cfg.family!r}")
    d, h, hkv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
        cfg.d_ff
    g = cfg.n_groups
    down = 0.02 / cfg.n_layers ** 0.5
    attn = {"wq": ((g, d, h * hd), 0.02), "wk": ((g, d, hkv * hd), 0.02),
            "wv": ((g, d, hkv * hd), 0.02), "wo": ((g, h * hd, d), down)}
    if cfg.qk_norm:
        attn.update(q_norm=((g, hd), "ones"), k_norm=((g, hd), "ones"))
    mlp = {"w_gate": ((g, d, f), 0.02), "w_up": ((g, d, f), 0.02),
           "w_down": ((g, f, d), down)}
    block = {"mixer_norm": ((g, d), "ones"), "attn": attn,
             "ffn_norm": ((g, d), "ones"), "mlp": mlp}
    shapes = {"embed": ((cfg.vocab, d), 0.02),
              "blocks": [block for _ in range(cfg.scan_group)],
              "final_norm": ((d,), "ones")}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((d, cfg.vocab), 0.02)
    return shapes


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> Dict:
    """Float32 master weights from a seeded ``torch.Generator`` on
    ``device``: truncated normal at ±2 std, the JAX init's stds."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in sorted(node.items())}
        if isinstance(node, list):
            return [build(v) for v in node]
        shape, init = node
        if init == "ones":
            return torch.ones(shape, dtype=torch.float32, device=dev)
        t = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0, generator=gen)
        return t.mul_(init)

    return build(param_shapes(cfg))


# =============================================================================
# Forward
# =============================================================================
def _group_params(tree, g: int):
    """The layer-group ``g`` view of a stacked block tree."""
    if isinstance(tree, dict):
        return {k: _group_params(v, g) for k, v in tree.items()}
    return layer_slice(tree, g)


def forward_hidden(ctx: QuantCtx, params, cfg: ModelConfig, x, positions,
                   cache, cache_len, prefill: bool):
    """Run the block stack over x (B, S, d).

    Prefill writes each layer's K/V at positions [0, S) of ``cache`` (any
    batch-row view of the dense cache); decode writes one token per slot at
    ``cache_len`` and attends over the cache. Returns the final-norm hidden
    states (B, S, d); the cache is updated in place.
    """
    for g in range(cfg.n_groups):
        for j in range(cfg.scan_group):
            p = _group_params(params["blocks"][j], g)
            kc = cache["blocks"][j]["k"][g]
            vc = cache["blocks"][j]["v"][g]
            h = L.rms_norm(x, p["mixer_norm"], cfg.norm_eps)
            out, (k_new, v_new) = L.attention_block(
                ctx, h, p["attn"], cfg, positions, f"blk{j}.attn",
                kv_cache=None if prefill else (kc, vc), cache_len=cache_len)
            if prefill:
                s = k_new.shape[1]
                kc[:, :s] = k_new.to(kc.dtype)
                vc[:, :s] = v_new.to(vc.dtype)
            x = x + out
            h = L.rms_norm(x, p["ffn_norm"], cfg.norm_eps)
            x = x + L.mlp_block(ctx, h, p["mlp"], f"blk{j}.mlp")
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def _embed(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens.long()].to(cfg.compute_dtype)


def _head_logits(ctx: QuantCtx, params, cfg: ModelConfig, h_last):
    """lm-head projection of the last-position hidden states (B, d), in f32.
    A quantized lm_head leaf (non-default exclusions) goes through the
    dequant-GEMM hook like every other projection."""
    if not cfg.tie_embeddings and ctx.qmm is not None and \
            is_packed_leaf(params["lm_head"]):
        return ctx.qmm(h_last.to(torch.float32), params["lm_head"], "lm_head")
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(h_last.to(torch.float32), w.to(torch.float32))


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig
    init_params: Callable         # (seed, device=) -> params
    init_cache: Callable          # (batch, s_max, dtype=None, device=) -> cache
    prefill: Callable             # (params, batch, cache) -> (logits, cache, len)
    serve_step: Callable          # (params, batch, cache, len) -> (logits, cache)
    prefill_slot: Callable        # (params, batch(1,S), cache, slot)
    #                               -> (logits (V,), cache, len scalar)
    with_qmm: Callable            # (qmm) -> ModelApi routing packed leaves
    #                               through the dequant-GEMM hook


def make_model(cfg: ModelConfig, qmm: Optional[Callable] = None) -> ModelApi:
    ctx = QuantCtx(qmm=qmm)

    def init_cache(b, s_max, dtype=None, *, device="cuda"):
        """Dense KV cache: per stacked group, K and V (G, B, s_max, Hkv, D)."""
        dev = resolve_device(device)
        shape = (cfg.n_groups, b, s_max, cfg.n_kv_heads, cfg.hd)
        dtype = dtype or cfg.compute_dtype
        return {"blocks": [
            {"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
            for _ in range(cfg.scan_group)]}

    @torch.no_grad()
    def prefill(params, batch, cache):
        """Process whole prompts, fill the cache, return last-position
        logits. ``batch["lengths"]`` (B,), optional: true prompt lengths of
        right-padded (bucketed) prompts — logits are read at each row's own
        last real token and cache_len is the true length."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = _embed(params, cfg, tokens)
        positions = torch.arange(s, device=x.device).expand(b, s)
        hidden = forward_hidden(ctx, params, cfg, x, positions, cache,
                                None, prefill=True)
        lengths = batch.get("lengths")
        if lengths is None:
            cache_len = torch.full((b,), s, dtype=torch.int32,
                                   device=x.device)
        else:
            cache_len = lengths.to(device=x.device, dtype=torch.int32)
        h_last = hidden[torch.arange(b, device=x.device),
                        cache_len.long() - 1]
        return _head_logits(ctx, params, cfg, h_last), cache, cache_len

    def prefill_slot(params, batch, cache, slot: int):
        """One request (tokens (1, S)) into slot ``slot`` of the batched
        cache; other slots are untouched. The slot's rows are zeroed first,
        so positions past the prompt read as zeros, as in the JAX
        scratch-then-insert version."""
        view = {"blocks": [{k: c[k][:, slot:slot + 1] for k in c}
                           for c in cache["blocks"]]}
        for c in view["blocks"]:
            for t in c.values():
                t.zero_()
        logits, _, clen = prefill(params, batch, view)
        return logits[0], cache, clen[0]

    @torch.no_grad()
    def serve_step(params, batch, cache, cache_len):
        """One decode step: batch["tokens"] (B, 1) against the cache."""
        x = _embed(params, cfg, batch["tokens"])
        hidden = forward_hidden(ctx, params, cfg, x, cache_len[:, None],
                                cache, cache_len, prefill=False)
        return _head_logits(ctx, params, cfg, hidden[:, -1]), cache

    return ModelApi(
        cfg=cfg,
        init_params=functools.partial(init_params, cfg),
        init_cache=init_cache,
        prefill=prefill,
        serve_step=serve_step,
        prefill_slot=prefill_slot,
        with_qmm=lambda q: make_model(cfg, q),
    )
