"""Plain float32 forward pass of the decoder-only dense and MoE families, as
the benchmark's configurations state them, for judging served tokens.

No kernel, cache or batching: each sequence is run whole, layer by layer,
with its attention computed from the full score matrix in blocks of query
rows. TF32 is switched off, so every matmul is float32. The layer, as the
configuration file states it (``departures`` there lists where it differs
from the published model):

  h = x + Wo·attn(rope(Wq·n1(x) + bq), rope(Wk·n1(x) + bk), Wv·n1(x) + bv)
  y = h + ffn(n2(h))

with n1, n2 RMSNorm (eps from the file) times a learned scale; rope the
half-split rotation of each head at the token's absolute position; attn
causal grouped-query softmax attention over the last ``sliding_window``
positions (the query's own included) when the file gives a window; ffn the
tanh-gelu MLP ``W_down·gelu(W_up·x + b_up) + b_down`` or the SiLU-gated
expert ``W_down·(silu(W_gate·x) * W_up·x)``; a MoE layer routes each token
to the experts of its top-k router logits (lower index first among equal
values) and sums their outputs weighted by the softmax of those k logits,
with no capacity limit. Logits are ``W_head·RMSNorm(h_L)``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D) at positions pos (S,)."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                       device=x.device) / half)
    ang = (pos.to(torch.float64)[:, None] * inv)[:, None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window, block: int = 1024):
    """q (S, H, D), k / v (S, Hkv, D), causal, windowed -> (S, H, D)."""
    s, h, d = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    kpos = torch.arange(s, device=q.device)
    for lo in range(0, s, block):
        hi = min(s, lo + block)
        sc = torch.einsum("qhd,khd->hqk", q[lo:hi], k[:hi]) / math.sqrt(d)
        qpos = torch.arange(lo, hi, device=q.device)
        dead = kpos[None, :hi] > qpos[:, None]
        if window:
            dead |= qpos[:, None] - kpos[None, :hi] >= window
        p = torch.softmax(sc.masked_fill(dead, float("-inf")), dim=-1)
        out[lo:hi] = torch.einsum("hqk,khd->qhd", p, v[:hi])
    return out


def _same(v):
    return v


def mlp(x, p, act: str, cast=_same):
    x = cast(x)
    if act == "gelu":
        hid = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
        return cast(hid) @ p["w_down"] + p["b_down"]
    return cast(F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def moe(x, p, topk: int, cast=_same):
    """x (T, d); p["router"] (d, E), p["w_gate"] / p["w_up"] (E, d, f),
    p["w_down"] (E, f, d)."""
    logits = x @ p["router"]
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[:, :topk], dim=-1)
    idx = idx[:, :topk]
    out = torch.zeros_like(x)
    for e in range(p["router"].shape[1]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = cast(x[rows])
        ye = cast(F.silu(xe @ p["w_gate"][e]) * (xe @ p["w_up"][e])) \
            @ p["w_down"][e]
        out.index_add_(0, rows, ye * gates[rows, slot, None])
    return out


def layer(x: torch.Tensor, lens: Sequence[int], p: Dict, cfg: Dict,
          cast=_same):
    """One block over the packed stream x (sum(lens), d); ``cast`` rounds
    each projection's input (identity: float32 throughout)."""
    d = cfg["hidden_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    window = cfg.get("sliding_window")
    n1 = cast(rms_norm(x, p["mixer_norm"], eps))
    q = n1 @ p["wq"] + p.get("bq", 0.0)
    k = n1 @ p["wk"] + p.get("bk", 0.0)
    v = n1 @ p["wv"] + p.get("bv", 0.0)
    att = torch.empty_like(q)
    off = 0
    for n in lens:
        pos = torch.arange(n, device=x.device)
        qs = rope(q[off:off + n].view(n, h, hd), pos, theta)
        ks = rope(k[off:off + n].view(n, hkv, hd), pos, theta)
        vs = v[off:off + n].view(n, hkv, hd)
        att[off:off + n] = attention(qs, ks, vs, window).reshape(n, d)
        off += n
    x = x + cast(att) @ p["wo"]
    n2 = rms_norm(x, p["ffn_norm"], eps)
    if "router" in p:
        return x + moe(n2, p, cfg["num_experts_per_tok"], cast)
    return x + mlp(n2, p, cfg["act"], cast)


def logits_at(seqs: List[torch.Tensor], want: List[torch.Tensor],
              embed: torch.Tensor, layer_params: Callable[[int], Dict],
              final_norm: torch.Tensor, head: torch.Tensor,
              cfg: Dict) -> List[torch.Tensor]:
    """Float32 logits of each sequence (token ids, on the device) at the
    positions ``want[i]``. ``layer_params(j)`` gives layer j's float32
    weights as the served format holds them."""
    lens = [int(s.numel()) for s in seqs]
    x = embed[torch.cat(seqs).long()].float()
    for j in range(cfg["num_hidden_layers"]):
        x = layer(x, lens, layer_params(j), cfg)
    out, off = [], 0
    for n, w in zip(lens, want):
        hs = rms_norm(x[off + w.long()], final_norm, cfg["norm_eps"])
        out.append(hs @ head)
        off += n
    return out
