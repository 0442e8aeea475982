"""Flash attention with a hand-written backward (recompute in backward).

Counterpart of ``repro/models/flash_vjp.py``. Autograd through a softmax
over the whole (Sq, Skv) score matrix keeps that matrix, and the
probabilities, for the backward: O(S^2) memory per layer. Here the forward
runs the chunked online softmax and saves only (q, k, v, out, lse); the
backward recomputes each score block from them, the FlashAttention-2
recipe, so the backward holds O(S) tensors plus one block.

The JAX package computes this in ``jnp`` scans outside any Pallas kernel;
the port's loops over chunks run the same einsums (the chunking sets the
summation order). The chunk plan (``_plan``) is the reference's where
``chunk`` divides a length or the length is at most ``chunk``: the
reference's ``_chunk_len``. Elsewhere the reference halves ``chunk`` until
it divides (64 positions at llava's 2,880 + 4,096), and the port's walk,
a Python loop over every (q, kv) pair, would grow with the square of the
chunk count; so the port pads q, k and v with zeros to the next multiple
of ``chunk``, walks ``chunk``-wide blocks and drops the padded rows
(padded keys are masked where the attention is not causal; under
causality they lie past every real query). That changes the summation
order against the reference only at such lengths. Under causality the
non-banded loops skip the kv chunks that start past a q chunk's last
position: every score there is masked, so the block adds exact zeros.
Sliding windows: a window that bites (``skv > window``) walks one band of
``window + cq`` keys per query chunk, forward and backward, and the
backward accumulates the overlapping dk/dv bands.
"""
from __future__ import annotations

from typing import Optional

import torch


# Skip the kv chunks that causality masks whole (a switch for the tests,
# which hold the skip bit-exact against the full walk).
SKIP_MASKED_CHUNKS = True


def _mask(q_pos, k_pos, causal: bool, window: Optional[int],
          kv_len: Optional[int] = None):
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    if kv_len is not None:
        m &= (k_pos < kv_len)[None, :]
    return m


def _chunk_len(total: int, chunk: int) -> int:
    """``chunk`` (at most ``total``), halved until it divides ``total``."""
    c = min(chunk, total)
    while total % c:
        c //= 2
    return max(c, 1)


def _chunk_pad(total: int, chunk: int):
    """(chunk length, padded length) of one axis: ``_chunk_len`` and no
    padding where ``chunk`` divides ``total`` or ``total <= chunk``, else
    ``chunk`` over ``total`` padded up to a multiple of it."""
    if total <= chunk or total % chunk == 0:
        return _chunk_len(total, chunk), total
    return chunk, -(-total // chunk) * chunk


def _plan(sq: int, skv: int, causal: bool, window: Optional[int],
          chunk: int):
    """(cq, ck, padded sq, padded skv, banded, band, kv_len): ``kv_len``
    masks the padded keys where a real query could see them (not causal,
    or more queries than keys); None where nothing is to mask."""
    cq, sq_p = _chunk_pad(sq, chunk)
    ck, skv_p = _chunk_pad(skv, chunk)
    banded = window is not None and causal and skv > window
    band = min(skv_p, window + cq) if banded else None
    kv_len = skv if skv_p > skv and (not causal or sq > skv) else None
    return cq, ck, sq_p, skv_p, banded, band, kv_len


def _live_chunks(qi: int, cq: int, ck: int, nk: int, causal: bool) -> int:
    """How many kv chunks q chunk ``qi`` walks: under causality (and
    ``SKIP_MASKED_CHUNKS``) those that start at or before its last
    position, else all ``nk``."""
    if not (causal and SKIP_MASKED_CHUNKS):
        return nk
    return min(nk, (qi * cq + cq - 1) // ck + 1)


def _pad_seq(t: torch.Tensor, n: int, value: float = 0.0,
             dim: int = 1) -> torch.Tensor:
    """``t`` padded with ``value`` along ``dim`` to length ``n``."""
    extra = n - t.shape[dim]
    if extra == 0:
        return t
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, t.new_full(shape, value)], dim)


def _band_start(qi: int, cq: int, band: int, skv: int) -> int:
    return min(max(qi * cq + cq - band, 0), skv - band)


def _scores(qc, kc, q_pos, k_pos, causal, window, scale, kv_len=None):
    s = torch.einsum("bqkgd,btkd->bkgqt", qc, kc) * scale
    return s.masked_fill(~_mask(q_pos, k_pos, causal, window, kv_len),
                         float("-inf"))


def fwd_pass(q, k, v, causal: bool, window: Optional[int], chunk: int):
    """q (B,Sq,Hkv,G,D), k/v (B,Skv,Hkv,D), all f32 -> out (B,Sq,Hkv,G,D)
    and lse (B,Hkv,G,Sq)."""
    b, sq, hkv, g, d = q.shape
    skv = k.shape[1]
    scale = 1.0 / (d ** 0.5)
    cq, ck, sq_p, skv_p, banded, band, kv_len = _plan(sq, skv, causal,
                                                      window, chunk)
    q = _pad_seq(q, sq_p)
    k, v = _pad_seq(k, skv_p), _pad_seq(v, skv_p)
    dev = q.device
    outs, lses = [], []
    for qi in range(sq_p // cq):
        qc = q[:, qi * cq:(qi + 1) * cq]
        q_pos = qi * cq + torch.arange(cq, device=dev)
        if banded:
            start = _band_start(qi, cq, band, skv_p)
            kc = k[:, start:start + band]
            vc = v[:, start:start + band]
            s = _scores(qc, kc, q_pos, start + torch.arange(band, device=dev),
                        causal, window, scale, kv_len)
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            l = p.sum(-1)
            o = torch.einsum("bkgqt,btkd->bqkgd", p, vc) / \
                l.permute(0, 3, 1, 2)[..., None]
            lse = m + torch.log(l)
        else:
            m = torch.full((b, hkv, g, cq), float("-inf"),
                           dtype=torch.float32, device=dev)
            l = torch.zeros((b, hkv, g, cq), dtype=torch.float32, device=dev)
            acc = torch.zeros((b, hkv, g, cq, d), dtype=torch.float32,
                              device=dev)
            for ki in range(_live_chunks(qi, cq, ck, skv_p // ck, causal)):
                kc = k[:, ki * ck:(ki + 1) * ck]
                vc = v[:, ki * ck:(ki + 1) * ck]
                s = _scores(qc, kc, q_pos,
                            ki * ck + torch.arange(ck, device=dev),
                            causal, window, scale, kv_len)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + \
                    torch.einsum("bkgqt,btkd->bkgqd", p, vc)
                m = m_new
            o = (acc / torch.clamp(l, min=1e-30)[..., None]) \
                .permute(0, 3, 1, 2, 4)
            lse = m + torch.log(torch.clamp(l, min=1e-30))
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, 1)[:, :sq], torch.cat(lses, -1)[..., :sq]


def flash_bwd(q, k, v, out, lse, dout, causal: bool,
              window: Optional[int], chunk: int):
    """(dq, dk, dv) from the saved (q, k, v, out, lse) and the f32
    cotangent ``dout`` of ``out``. Padded query rows carry a zero
    cotangent and an lse of +inf, so their probabilities, and all they add
    to dk and dv, are exact zeros."""
    b, sq, hkv, g, d = q.shape
    skv = k.shape[1]
    scale = 1.0 / (d ** 0.5)
    cq, ck, sq_p, skv_p, banded, band, kv_len = _plan(sq, skv, causal,
                                                      window, chunk)
    q, out, dout = (_pad_seq(t, sq_p) for t in (q, out, dout))
    lse = _pad_seq(lse, sq_p, float("inf"), dim=-1)
    k, v = _pad_seq(k, skv_p), _pad_seq(v, skv_p)
    dev = q.device
    delta = torch.sum(dout * out, -1)                       # (B,Sq,Hkv,G)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    dqs = []
    for qi in range(sq_p // cq):
        sl = slice(qi * cq, (qi + 1) * cq)
        qc, doc = q[:, sl], dout[:, sl]
        lse_c = lse[..., sl]
        del_c = delta[:, sl].permute(0, 2, 3, 1)[..., None]
        q_pos = qi * cq + torch.arange(cq, device=dev)

        def block(kc, vc, k_pos):
            s = _scores(qc, kc, q_pos, k_pos, causal, window, scale, kv_len)
            p = torch.exp(s - lse_c[..., None])               # (b,k,g,q,t)
            dp = torch.einsum("bqkgd,btkd->bkgqt", doc, vc)
            ds = p * (dp - del_c)
            dq_blk = torch.einsum("bkgqt,btkd->bqkgd", ds, kc) * scale
            dk_blk = torch.einsum("bkgqt,bqkgd->btkd", ds, qc) * scale
            dv_blk = torch.einsum("bkgqt,bqkgd->btkd", p, doc)
            return dq_blk, dk_blk, dv_blk

        if banded:
            start = _band_start(qi, cq, band, skv_p)
            bs = slice(start, start + band)
            dq_c, dk_blk, dv_blk = block(
                k[:, bs], v[:, bs], start + torch.arange(band, device=dev))
            dk[:, bs] = dk[:, bs] + dk_blk
            dv[:, bs] = dv[:, bs] + dv_blk
        else:
            dq_c = torch.zeros_like(qc)
            for ki in range(_live_chunks(qi, cq, ck, skv_p // ck, causal)):
                ks = slice(ki * ck, (ki + 1) * ck)
                dq_blk, dk_blk, dv_blk = block(
                    k[:, ks], v[:, ks], ki * ck + torch.arange(ck, device=dev))
                dk[:, ks] = dk[:, ks] + dk_blk
                dv[:, ks] = dv[:, ks] + dv_blk
                dq_c = dq_c + dq_blk
        dqs.append(dq_c)
    return torch.cat(dqs, 1)[:, :sq], dk[:, :skv], dv[:, :skv]


class _Flash(torch.autograd.Function):
    """Forward ``fwd_pass``, backward ``flash_bwd``; saves (q, k, v, out,
    lse) and nothing of size Sq x Skv."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk):
        out, lse = fwd_pass(q, k, v, causal, window, chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.to(torch.float32),
                               *ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        chunk: int = 1024) -> torch.Tensor:
    """q (B,Sq,H,D), k/v (B,Skv,Hkv,D) -> (B,Sq,H,D) in ``q.dtype``, f32
    inside, with an O(S)-memory backward."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, d).to(torch.float32)
    out = _Flash.apply(qg, k.to(torch.float32), v.to(torch.float32), causal,
                       window, chunk)
    return out.reshape(b, sq, h, d).to(q.dtype)
