"""Transformer building blocks for serving: norms, RoPE, attention, MLP.

Counterpart of ``repro/models/layers.py`` on the dense KV layout. Attention
is plain PyTorch in float32 (the JAX package computes it in jnp, not in a
TPU kernel): causal prefill attention over the prompt, and single-token
decode attention over the dense cache (B, Smax, Hkv, D) masked by each
slot's own ``cache_len``. Decode writes each slot's new K/V at its own
position in place (the JAX version returns an updated copy).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, QuantCtx


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x (..., S, H, D), positions (..., S) -> rotated (llama half-split)."""
    half = x.shape[-1] // 2
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half))
    ang = positions.to(torch.float32)[..., None] * inv_freq  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def prefill_attention(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Causal attention of a prompt over itself, f32 softmax, GQA.
    q (B,S,H,D), k/v (B,S,Hkv,D) -> (B,S,H,D)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d).to(torch.float32)
    sc = torch.einsum("bqkgd,btkd->bkgqt", qg,
                      k.to(torch.float32)) * (1.0 / d ** 0.5)
    pos = torch.arange(s, device=q.device)
    sc = sc.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v.to(torch.float32))
    return out.reshape(b, s, h, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """Single-token attention: q (B,1,H,D) over cache (B,Skv,Hkv,D), where
    row b sees positions < cache_len[b]."""
    b, _, h, d = q.shape
    skv, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d).to(torch.float32)
    sc = torch.einsum("bkgd,btkd->bkgt", qg,
                      k_cache.to(torch.float32)) / (d ** 0.5)
    pos = torch.arange(skv, device=q.device)
    valid = pos[None, :] < cache_len[:, None]
    sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, d).to(q.dtype)


def attention_block(ctx: QuantCtx, x: torch.Tensor, p, cfg: ModelConfig,
                    positions: torch.Tensor, name: str,
                    kv_cache=None, cache_len=None):
    """Self-attention. Without ``kv_cache`` (prefill) returns
    ``(out, (k, v))`` for the caller to store; with ``kv_cache = (kc, vc)``
    (decode, S == 1) writes this token's K/V at each slot's ``cache_len`` in
    place, attends over ``cache_len + 1`` positions and returns
    ``(out, (kc, vc))``."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = ctx.dense(x, p["wq"], name + ".wq").reshape(b, s, h, hd)
    k = ctx.dense(x, p["wk"], name + ".wk").reshape(b, s, hkv, hd)
    v = ctx.dense(x, p["wv"], name + ".wv").reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if kv_cache is None:
        out = prefill_attention(q, k, v)
        new_kv = (k, v)
    else:
        kc, vc = kv_cache
        rows = torch.arange(b, device=x.device)
        kc[rows, cache_len.long()] = k[:, 0].to(kc.dtype)
        vc[rows, cache_len.long()] = v[:, 0].to(vc.dtype)
        out = decode_attention(q, kc, vc, cache_len + 1)
        new_kv = (kc, vc)
    out = ctx.dense(out.reshape(b, s, h * hd), p["wo"], name + ".wo")
    return out, new_kv


def mlp_block(ctx: QuantCtx, x: torch.Tensor, p, name: str) -> torch.Tensor:
    """SwiGLU MLP."""
    gate = ctx.dense(x, p["w_gate"], name + ".w_gate")
    up = ctx.dense(x, p["w_up"], name + ".w_up")
    return ctx.dense(F.silu(gate) * up, p["w_down"], name + ".w_down")
