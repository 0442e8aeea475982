"""Transformer building blocks: norms, RoPE, attention, MLP, MoE.

Counterpart of ``repro/models/layers.py`` for the dense and the paged KV
layouts. Attention the JAX package computes in jnp is plain PyTorch in
float32 here: attention over a whole sequence with no cache (training and
monolithic prefill) is ``models/flash_vjp.py`` (or, with ``flash_vjp``
off, ``prefill_attention``), a chunk's queries over the cache view at the
chunk's cursor, single-token decode attention and ragged mixed-tick
attention over a dense cache masked by each slot's own lengths. On the
paged layout the decode and mixed ticks read the page pools through B3/B4
(``kernels/paged_attention.py``). Every KV write lands in the cache in
place (the JAX versions return updated copies). ``moe_block`` routes each
batch row's tokens to its top-k experts with capacity dispatch.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                 paged_mixed_attention)
from repro_torch.models.common import ModelConfig, QuantCtx
from repro_torch.models.flash_vjp import flash_attention_vjp, fwd_pass
from repro_torch.serve.packed_params import layer_slice


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


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_offset: int = 0,
                      window: Optional[int] = None) -> torch.Tensor:
    """Causal attention, f32 softmax, GQA: q (B,S,H,D) at positions
    ``q_offset + i`` over k/v (B,Skv,Hkv,D) at positions ``0 .. Skv-1``
    -> (B,S,H,D). A prompt attends over itself (``q_offset = 0``); a prompt
    chunk at cursor ``q_offset`` attends over the cache view that already
    holds every earlier chunk and this one. V rows past the last query's
    position are selected to zero, so whatever a view holds there (stale
    or recycled KV) never reaches the output."""
    b, s, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d).to(torch.float32)
    sc = torch.einsum("bqkgd,btkd->bkgqt", qg,
                      k.to(torch.float32)) * (1.0 / d ** 0.5)
    qpos = q_offset + torch.arange(s, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    dead = kpos[None, :] > qpos[:, None]
    if window is not None:
        dead |= qpos[:, None] - kpos[None, :] >= window
    sc = sc.masked_fill(dead, float("-inf"))
    p = torch.softmax(sc, dim=-1)
    v32 = v.to(torch.float32)
    if skv > q_offset + s:
        v32 = torch.where((kpos < q_offset + s)[:, None, None], v32, 0.0)
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v32)
    return out.reshape(b, s, h, d).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    chunk: int = 1024) -> torch.Tensor:
    """q (B,Sq,H,D), k/v (B,Skv,Hkv,D) -> (B,Sq,H,D): the chunked online
    softmax of the JAX package's ``flash_attention`` (queries and keys at
    positions from 0), f32 inside, differentiated by autograd through the
    chunks as JAX differentiates its scans. The encoder-decoder's cross
    attention (``causal=False``, Sq != Skv) runs it at prefill and in
    training."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, d).to(torch.float32)
    out, _ = fwd_pass(qg, k.to(torch.float32), v.to(torch.float32), causal,
                      window, chunk)
    return out.reshape(b, sq, h, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention: q (B,1,H,D) over cache (B,Skv,Hkv,D), where
    row b sees positions < cache_len[b] (and >= cache_len[b] - window)."""
    b, _, h, d = q.shape
    skv, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d).to(torch.float32)
    sc = torch.einsum("bkgd,btkd->bkgt", qg,
                      k_cache.to(torch.float32)) / (d ** 0.5)
    pos = torch.arange(skv, device=q.device)
    valid = pos[None, :] < cache_len[:, None]
    if window is not None:
        valid &= pos[None, :] >= cache_len[:, None] - window
    sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, d).to(q.dtype)


def mixed_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, q_offset: torch.Tensor,
                    q_len: torch.Tensor,
                    window: Optional[int] = None) -> torch.Tensor:
    """Ragged multi-query attention: q (B,C,H,D) over cache (B,Skv,Hkv,D).

    Query ``i`` of row ``b`` sits at position ``q_offset[b] + i``; lanes
    with ``i < q_len[b]`` attend causally (self-inclusive) over positions
    below the row's frontier ``q_offset + q_len``, within the window; dead
    pad lanes give exact zeros. The same op sequence as
    ``decode_attention`` with one extra query axis, as in the JAX
    package."""
    b, c, h, d = q.shape
    skv, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, c, hkv, h // hkv, d).to(torch.float32)
    sc = torch.einsum("bikgd,btkd->bkgit", qg,
                      k_cache.to(torch.float32)) / (d ** 0.5)
    pos = torch.arange(skv, device=q.device)
    lane = torch.arange(c, device=q.device)
    qpos = q_offset[:, None] + lane[None]                         # (B, C)
    live = lane[None] < q_len[:, None]                            # (B, C)
    valid = pos[None, None, :] <= qpos[:, :, None]
    valid &= pos[None, None, :] < (q_offset + q_len)[:, None, None]
    valid &= live[..., None]
    if window is not None:
        valid &= (qpos[:, :, None] - pos[None, None, :]) < window
    sc = sc.masked_fill(~valid[:, None, None], float("-inf"))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    den = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgit,btkd->bikgd", p / den,
                       v_cache.to(torch.float32))
    # dead lanes divide 0/0 -> NaN: force exact zeros
    out = torch.where(live[..., None, None, None], out, 0.0)
    return out.reshape(b, c, h, d).to(q.dtype)


# =============================================================================
# KV cache writes (in place)
# =============================================================================
# Paged layout: each layer owns a page pool (P, ps, Hkv, D); a slot's KV
# lives in the physical pages its block-table row names, in logical order —
# position p maps to page row[p // ps], offset p % ps. Page 0 is reserved
# scratch: unmapped entries point at it, so free slots and pad lanes write
# there, and every read of it is masked. The JAX package returns updated
# copies; these write into the pool in place.
def paged_prefill_update(pool: torch.Tensor, kv_new: torch.Tensor,
                         block_table: torch.Tensor,
                         start_pos: int = 0) -> None:
    """Scatter prompt K/V (B, S, Hkv, D) into the pages each row maps,
    starting at the page-aligned position ``start_pos``; S is zero-padded
    to whole pages."""
    b, s, hkv, d = kv_new.shape
    ps = pool.shape[1]
    n_p = -(-s // ps)
    vals = kv_new.to(pool.dtype)
    if n_p * ps != s:
        vals = F.pad(vals, (0, 0, 0, 0, 0, n_p * ps - s))
    first = start_pos // ps
    ids = block_table[:, first:first + n_p].reshape(-1).long()
    pool[ids] = vals.reshape(b * n_p, ps, hkv, d)


def paged_decode_append(pool: torch.Tensor, kv_tok: torch.Tensor,
                        block_table: torch.Tensor,
                        cache_len: torch.Tensor) -> None:
    """Write one token's K/V (B, 1, Hkv, D) at each slot's cache_len; the
    engine maps the page before the tick, free slots land on page 0."""
    ps = pool.shape[1]
    cl = cache_len.long()
    phys = block_table.long().gather(1, (cl // ps)[:, None])[:, 0]
    pool[phys, cl % ps] = kv_tok[:, 0].to(pool.dtype)


def mixed_cache_update(cache: torch.Tensor, kv_new: torch.Tensor,
                       cache_len: torch.Tensor, q_len: torch.Tensor) -> None:
    """Ragged multi-token append into a dense cache (B, Smax, Hkv, D): row
    b's token i lands at ``cache_len[b] + i`` when ``i < q_len[b]``; pad
    lanes and positions past the cache are dropped.

    Shapes never depend on the data (a CUDA graph captures it): every lane
    writes, at ``(cache_len[b] + i) % Smax``, its new value if kept and the
    value already there if dropped. Within a row those C <= Smax positions
    are distinct, so no two writes collide and a dropped lane never lands
    on a kept one. Lanes at i >= Smax are past the cache in every row."""
    b, smax = cache.shape[:2]
    c = min(kv_new.shape[1], smax)
    lane = torch.arange(c, device=kv_new.device)
    pos = cache_len.long()[:, None] + lane[None]                 # (B, C)
    keep = (lane[None] < q_len[:, None]) & (pos < smax)
    rows = torch.arange(b, device=kv_new.device)[:, None].expand(b, c)
    pos = pos % smax
    cache[rows, pos] = torch.where(keep[..., None, None],
                                   kv_new[:, :c].to(cache.dtype),
                                   cache[rows, pos])


def paged_mixed_update(pool: torch.Tensor, kv_new: torch.Tensor,
                       block_table: torch.Tensor, cache_len: torch.Tensor,
                       q_len: torch.Tensor) -> None:
    """Ragged multi-token append through the block table: position
    ``cache_len[b] + i`` (``i < q_len[b]``) maps to page
    ``block_table[b, pos // ps]``; pad lanes and positions past the table
    write zeros to scratch page 0."""
    ps = pool.shape[1]
    mp = block_table.shape[1]
    c = kv_new.shape[1]
    lane = torch.arange(c, device=kv_new.device)
    pos = cache_len.long()[:, None] + lane[None]                 # (B, C)
    valid = (lane[None] < q_len[:, None]) & (pos // ps < mp)
    phys = block_table.long().gather(1, (pos // ps).clamp(0, mp - 1))
    phys = torch.where(valid, phys, 0)
    vals = torch.where(valid[..., None, None], kv_new.to(pool.dtype), 0)
    pool[phys, pos % ps] = vals


def paged_gather(pool: torch.Tensor, block_table: torch.Tensor
                 ) -> torch.Tensor:
    """Each slot's logical KV view (B, max_pages*ps, Hkv, D): the read of
    the ``attn_impl="gather"`` contract and of chunked prefill."""
    b, mp = block_table.shape
    pages = pool[block_table.long()]                 # (B, MP, ps, Hkv, D)
    return pages.reshape(b, mp * pool.shape[1], *pool.shape[2:])


# =============================================================================
# Attention block
# =============================================================================
def kv_heads(ctx: QuantCtx, cfg: ModelConfig, t: torch.Tensor
             ) -> torch.Tensor:
    """A K or V projection (B, S, columns) as (B, S, Hkv, D) of the kv
    heads this process attends with: under ``ShardDims.kv_gather`` its
    part of the columns is gathered (the backward sums every process's
    gradient: each reads its own kv head) and kv head ``kv_offset`` kept."""
    sd = ctx.shard(cfg)
    if sd.kv_gather:
        lo = sd.kv_offset * cfg.hd
        t = ctx.tp.all_gather_last(t, per_rank=True)[..., lo:lo + cfg.hd]
    return t.reshape(t.shape[0], t.shape[1], sd.n_kv_heads, cfg.hd)


def attention_block(ctx: QuantCtx, x: torch.Tensor, p, cfg: ModelConfig,
                    positions: torch.Tensor, name: str, kv_cache=None,
                    cache_len=None, block_table=None,
                    chunk_start: Optional[int] = None, q_len=None,
                    attn_impl: str = "gather", causal: bool = True):
    """Self-attention; K/V land in ``kv_cache`` in place.

      no ``kv_cache``   training or monolithic prefill: attention over the
                        sequence, causal unless ``causal=False`` (the
                        encoder), ``flash_attention_vjp`` when
                        ``cfg.flash_vjp`` (as in JAX), ``prefill_attention``
                        (``flash_attention`` when not causal) otherwise;
                        returns ``(out, (k, v))`` for the caller to store.
      ``chunk_start``   chunked prefill: ``x`` is one prompt chunk at that
                        cursor; its K/V are written there (through the block
                        table when paged) and its queries attend over the
                        cache view, which holds every earlier chunk.
      ``q_len``         the mixed tick: row b's first ``q_len[b]`` tokens sit
                        at ``cache_len[b] + i``; each row writes them at its
                        own cursor and the ragged queries attend — B4
                        (``paged_mixed_attention``) when paged under
                        ``attn_impl="paged_kernel"``, ``mixed_attention``
                        otherwise.
      otherwise         decode (S == 1): this token's K/V land at each
                        slot's ``cache_len``, attention over ``cache_len + 1``
                        positions — B3 (``paged_decode_attention``) when
                        paged under ``"paged_kernel"``.

    ``block_table`` selects the paged layout: ``kv_cache`` then holds one
    layer's pools (P, ps, Hkv, D)."""
    b, s, _ = x.shape
    sd = ctx.shard(cfg)
    h, hd = sd.n_heads, cfg.hd
    window = cfg.sliding_window
    x = ctx.tp_in(x)
    q = ctx.dense(x, p["wq"], name + ".wq", p.get("bq")).reshape(b, s, h, hd)
    k = kv_heads(ctx, cfg, ctx.dense(x, p["wk"], name + ".wk", p.get("bk")))
    v = kv_heads(ctx, cfg, ctx.dense(x, p["wv"], name + ".wv", p.get("bv")))
    if cfg.qk_norm:     # replicated scales applied to this shard's heads
        q = rms_norm(q, ctx.tp_in(p["q_norm"]), cfg.norm_eps)
        k = rms_norm(k, ctx.tp_in(p["k_norm"]), cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    mode = "kernel" if attn_impl == "paged_kernel" else "gather"
    if kv_cache is None:
        if cfg.flash_vjp:
            out = flash_attention_vjp(q, k, v, causal=causal, window=window,
                                      chunk=cfg.seq_chunk)
        elif causal:
            out = prefill_attention(q, k, v, window=window)
        else:
            out = flash_attention(q, k, v, causal=False, window=window,
                                  chunk=cfg.seq_chunk)
        new_kv = (k, v)
    else:
        kc, vc = kv_cache
        new_kv = kv_cache
        if chunk_start is not None:
            if block_table is not None:
                paged_prefill_update(kc, k, block_table, chunk_start)
                paged_prefill_update(vc, v, block_table, chunk_start)
                k_view = paged_gather(kc, block_table)
                v_view = paged_gather(vc, block_table)
            else:
                kc[:, chunk_start:chunk_start + s] = k.to(kc.dtype)
                vc[:, chunk_start:chunk_start + s] = v.to(vc.dtype)
                k_view, v_view = kc, vc
            out = prefill_attention(q, k_view, v_view, q_offset=chunk_start,
                                    window=window)
        elif q_len is not None:
            if block_table is not None:
                paged_mixed_update(kc, k, block_table, cache_len, q_len)
                paged_mixed_update(vc, v, block_table, cache_len, q_len)
                out = paged_mixed_attention(q, kc, vc, block_table,
                                            cache_len, q_len, window=window,
                                            mode=mode)
            else:
                mixed_cache_update(kc, k, cache_len, q_len)
                mixed_cache_update(vc, v, cache_len, q_len)
                out = mixed_attention(q, kc, vc, cache_len, q_len,
                                      window=window)
        elif block_table is not None:
            paged_decode_append(kc, k, block_table, cache_len)
            paged_decode_append(vc, v, block_table, cache_len)
            out = paged_decode_attention(q, kc, vc, block_table,
                                         cache_len + 1, window=window,
                                         mode=mode)
        else:
            rows = torch.arange(b, device=x.device)
            kc[rows, cache_len.long()] = k[:, 0].to(kc.dtype)
            vc[rows, cache_len.long()] = v[:, 0].to(vc.dtype)
            out = decode_attention(q, kc, vc, cache_len + 1, window=window)
    out = ctx.dense(out.reshape(b, s, h * hd), p["wo"], name + ".wo",
                    tp_reduce=True)
    return out, new_kv


def cross_kv_from_memory(ctx: QuantCtx, memory: torch.Tensor, p,
                         cfg: ModelConfig, name: str):
    """The encoder-side K/V (B, Se, Hkv, D) of a decoder layer's cross
    attention, from the encoder output ``memory`` (B, Se, d); no RoPE.
    Under tensor parallelism the replicated ``memory`` enters this shard's
    kv heads."""
    memory = ctx.tp_in(memory)
    return (kv_heads(ctx, cfg, ctx.dense(memory, p["wk"], name + ".wk")),
            kv_heads(ctx, cfg, ctx.dense(memory, p["wv"], name + ".wv")))


def mlp_block(ctx: QuantCtx, x: torch.Tensor, p, cfg: ModelConfig,
              name: str) -> torch.Tensor:
    """SwiGLU MLP, or (``act="gelu"``) up -> gelu -> down. The gelu is the
    tanh approximation, ``jax.nn.gelu``'s default: the exact erf form
    differs by ~1e-3. Biases, where the config has them, as in JAX: on the
    gelu MLP's up projection and on the down projection."""
    x = ctx.tp_in(x)
    if cfg.act == "swiglu":
        gate = ctx.dense(x, p["w_gate"], name + ".w_gate")
        up = ctx.dense(x, p["w_up"], name + ".w_up")
        hidden = F.silu(gate) * up
    else:
        hidden = F.gelu(ctx.dense(x, p["w_up"], name + ".w_up",
                                  p.get("b_up")), approximate="tanh")
    return ctx.dense(hidden, p["w_down"], name + ".w_down", p.get("b_down"),
                     tp_reduce=True)


def _topk_stable(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, and among equal
    values the lower index first (``torch.topk`` promises no order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(ctx: QuantCtx, x: torch.Tensor, p, cfg: ModelConfig,
              name: str):
    """Top-k routed MoE with per-row routing groups and capacity dispatch,
    op for op the JAX package's ``moe_block``: each batch row routes its
    own S tokens, each expert takes at most ``cap = cf * S * k / E`` of
    them by gate (so routing depends on S, the padded shape), and the
    Switch load-balance loss comes back beside the output. The router is
    raw (never quantized) and goes through ``torch.matmul``; each expert's
    2-D slice of the layer's (E, K, N) leaf goes through ``ctx.dense``,
    so a packed leaf reaches the dequant-GEMM dispatch with the row's
    gathered tokens (the JAX package densifies the vmapped experts
    instead; ROADMAP C.8). ``cap`` is a host int from the static S: nothing
    here reads the device. Returns (out, aux).

    Under tensor parallelism (``ctx.shard(cfg).moe``) every process routes
    every token with the replicated router over the global E, so capacity,
    the one-hot routing and the Switch loss are the single device's;
    expert-parallel, it runs only its own experts, FFN-parallel every
    expert on its slice of d_ff (``w_down`` row-parallel), and the partial
    outputs are all-reduced once. The tokens and the gates enter the
    per-process work through ``copy_in`` (the whole gate tensor, then this
    process's experts), so the router's and the input's gradients are
    whole on every process."""
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_topk
    sd = ctx.shard(cfg)

    logits = ctx.dense(x, p["router"], name + ".router").to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                        # (B, S, E)
    top_vals, top_idx = _topk_stable(logits, k)
    gates = torch.softmax(top_vals, dim=-1)                      # (B, S, k)
    onehot = F.one_hot(top_idx, e).to(gates.dtype)               # (B, S, k, E)
    expert_gate = torch.einsum("bsk,bske->bse", gates, onehot)

    cap = max(1, min(s, int(cfg.capacity_factor * s * k / e)))
    prio = expert_gate.transpose(1, 2)                           # (B, E, S)
    top_gate, token_idx = _topk_stable(prio, cap)                # (B, E, C)

    lo, el = sd.expert_offset, sd.experts
    top_gate = ctx.tp_in(top_gate)[:, lo:lo + el]
    token_idx = token_idx[:, lo:lo + el]
    rows = torch.arange(b, device=x.device)[:, None]
    xe = ctx.tp_in(x)[rows, token_idx.reshape(b, el * cap)].reshape(
        b, el, cap, d)
    experts = p["experts"]
    ye = []
    for i in range(el):
        xi = xe[:, i]                                            # (B, C, d)
        gate = ctx.dense(xi, layer_slice(experts["w_gate"], i),
                         name + ".expert.w_gate")
        up = ctx.dense(xi, layer_slice(experts["w_up"], i),
                       name + ".expert.w_up")
        ye.append(ctx.dense(F.silu(gate) * up,
                            layer_slice(experts["w_down"], i),
                            name + ".expert.w_down"))
    ye = torch.stack(ye, 1)                                      # (B, E, C, d)
    ye = ye * top_gate[..., None].to(ye.dtype)
    out = torch.zeros((b, s, d), dtype=ye.dtype, device=x.device)
    out = out.index_put((rows.expand(b, el * cap), token_idx.reshape(b, -1)),
                        ye.reshape(b, el * cap, d), accumulate=True)
    if ctx.tp is not None:
        out = ctx.tp.all_reduce(out)

    # Switch-style load-balance aux loss: a product of batch means, so a
    # sharded batch takes each mean over the whole batch first
    frac_tokens = ctx.dp_mean(onehot.sum(2).mean(dim=(0, 1)))   # (E,)
    frac_probs = ctx.dp_mean(probs.mean(dim=(0, 1)))
    aux = cfg.router_aux_coef * e * torch.sum(frac_tokens * frac_probs)
    return out.to(x.dtype), aux
