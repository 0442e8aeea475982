"""Mamba-1 selective-SSM block (jamba's dominant mixer).

Counterpart of ``repro/models/ssm.py``, plain PyTorch (the JAX block is
``jnp`` and ``lax.scan``; no Pallas kernel reaches it). The Δ/B/C
projections run over the whole sequence; the discretized (B, c, d_inner,
d_state) operands exist one chunk of ``c`` tokens at a time, and inside a
chunk the recurrence ``h_t = exp(Δ_t A) h_{t-1} + Δ_t x_t B_t`` is a
log-depth scan (Hillis–Steele doubling) of the (a, b) pairs that
``_ssm_combine`` composes, in float32. At one token (decode) the chunk is
that one step. Under autograd each chunk is recomputed in the backward
(``torch.utils.checkpoint``), so training keeps one chunk's expanded
operands at a time, as the JAX scan does.

A served tree may hold a packed ``A_log`` (the anchor quantizes it:
``core/qat.py::DEFAULT_EXCLUDE`` matches ``A_log`` against the lowercased
path, ROADMAP C.9): every non-projection leaf is densified where it is
used (``common.at_use``), the densify contract. The projections
(``in_proj``, ``x_proj``, ``out_proj``) go through ``QuantCtx.dense``;
``dt_w`` is applied as a plain product, never through the dispatch.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ModelConfig, QuantCtx, at_use

SCAN_CHUNK = 256


def mamba_param_shapes(cfg: ModelConfig, g: int) -> Dict:
    """The stacked (G, ...) leaves of a Mamba block, as ``param_shapes``
    describes them, with the JAX init: ``A_log`` = log(1..N) per channel,
    ``dt_bias`` = softplus^-1(0.01), ``D`` ones, ``conv_b`` zeros,
    ``conv_w`` std 0.1, ``out_proj`` std 0.02 / sqrt(n_layers)."""
    d, di = cfg.d_model, cfg.mamba_d_inner
    n, kc, dtr = cfg.mamba_d_state, cfg.mamba_d_conv, cfg.dt_rank
    return {"in_proj": ((g, d, 2 * di), 0.02),
            "conv_w": ((g, kc, di), 0.1),
            "conv_b": ((g, di), "zeros"),
            "x_proj": ((g, di, dtr + 2 * n), 0.02),
            "dt_w": ((g, dtr, di), 0.02),
            "dt_bias": ((g, di), ("full", -4.6)),
            "A_log": ((g, di, n), "a_log"),
            "D": ((g, di), "ones"),
            "out_proj": ((g, di, d), 0.02 / cfg.n_layers ** 0.5)}


def mamba_param_axes(cfg: ModelConfig) -> Dict:
    """Logical axes of a Mamba block's (unstacked) leaves, the reference's:
    the inner channels (d_inner) on ``model``, the projections' d_model
    dims on ``fsdp``."""
    return {"in_proj": ("fsdp", "model"), "conv_w": (None, "model"),
            "conv_b": ("model",), "x_proj": ("model", None),
            "dt_w": (None, "model"), "dt_bias": ("model",),
            "A_log": ("model", None), "D": ("model",),
            "out_proj": ("model", "fsdp")}


def _causal_conv1d(x, w, b, conv_state):
    """Depthwise causal conv along S. x (B, S, di), w (K, di), b (di,);
    ``conv_state`` (B, K-1, di) the last K-1 inputs before x, or None for
    zeros. Returns (y, new conv state (B, K-1, di))."""
    kc = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((x.shape[0], kc - 1, x.shape[2]),
                                 dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = 0
    for i in range(kc):
        y = y + xp[:, i:i + s] * w[i]
    return y + b.to(y.dtype), xp[:, -(kc - 1):]


def _chunk_len(s: int, chunk: int = SCAN_CHUNK) -> int:
    """The reference's chunk: min(chunk, S), halved until it divides S."""
    c = min(chunk, s)
    while s % c:
        c //= 2
    return c


def _scan_chunk(h, a, dt_c, b_c, c_c, x_c):
    """One chunk: h (B, di, N) f32 in, (y (B, c, di), h out). The inclusive
    scan of (exp(dt a), dt x B) along the chunk by doubling: after the step
    at offset ``k`` position t holds the composition of positions
    (t - 2k, t]."""
    da = torch.exp(dt_c[..., None] * a)                     # (B, c, di, N)
    dbx = (dt_c * x_c)[..., None] * b_c[:, :, None, :]      # (B, c, di, N)
    c = da.shape[1]
    k = 1
    while k < c:
        # _ssm_combine(left = t - k, right = t) for t >= k
        da, dbx = (torch.cat([da[:, :k], da[:, :-k] * da[:, k:]], dim=1),
                   torch.cat([dbx[:, :k], da[:, k:] * dbx[:, :-k]
                              + dbx[:, k:]], dim=1))
        k *= 2
    hs = da * h[:, None] + dbx
    y = torch.einsum("bcdn,bcn->bcd", hs, c_c)
    return y, hs[:, -1]


def selective_scan(dt, a_log, b_in, c_in, xi, h0, chunk: int = SCAN_CHUNK):
    """Chunked selective scan. dt (B, S, di) f32, a_log (di, N), b_in /
    c_in (B, S, N), xi (B, S, di), h0 (B, di, N) or None for zeros.
    Returns (y (B, S, di) f32, h_final (B, di, N) f32)."""
    bsz, s, di = dt.shape
    a = -torch.exp(at_use(a_log, torch.float32))           # (di, N)
    n = a.shape[1]
    c = _chunk_len(s, chunk)
    h = torch.zeros((bsz, di, n), dtype=torch.float32, device=dt.device) \
        if h0 is None else h0.to(torch.float32)
    grad = torch.is_grad_enabled()
    ys = []
    for i in range(0, s, c):
        args = (h, a, dt[:, i:i + c], b_in[:, i:i + c], c_in[:, i:i + c],
                xi[:, i:i + c])
        if grad:
            y, h = checkpoint(_scan_chunk, *args, use_reentrant=False)
        else:
            y, h = _scan_chunk(*args)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def mamba_block(ctx: QuantCtx, x, p, cfg: ModelConfig, name: str,
                state: Optional[Tuple] = None):
    """x (B, S, d) -> (out, (h (B, di, N) f32, conv (B, K-1, di))).
    ``state`` = (h, conv) carries a decode's recurrent state; None starts
    from zeros (prefill, training).

    Under tensor parallelism this process runs its slice of the d_inner
    channels (``ctx.shard(cfg).d_inner``): ``in_proj``'s spec cuts its
    fused ``[x | z]`` columns contiguously, so the shards' outputs are
    gathered (a backward that sums, then cuts) and this process takes its
    channels of both halves; the conv, Δ, A, D and the scan are per
    channel; ``x_proj`` and ``out_proj`` are row-parallel, and the
    all-reduced (Δ_lo, B, C) enter the per-channel work through
    ``copy_in``."""
    h0, conv0 = state if state is not None else (None, None)
    dtr, n = cfg.dt_rank, cfg.mamba_d_state

    xz = ctx.dense(ctx.tp_in(x), p["in_proj"], name + ".in_proj")
    if ctx.tp is None:
        xi, z = torch.chunk(xz, 2, dim=-1)
    else:
        xz = ctx.tp.all_gather_last(xz, per_rank=True)
        dl = ctx.shard(cfg).d_inner
        lo = ctx.tp.rank * dl
        xi = xz[..., lo:lo + dl]
        z = xz[..., cfg.mamba_d_inner + lo:cfg.mamba_d_inner + lo + dl]
    xi, conv_state = _causal_conv1d(xi, at_use(p["conv_w"], xi.dtype),
                                    at_use(p["conv_b"], torch.float32),
                                    conv0)
    xi = F.silu(xi)

    bcd = ctx.tp_in(ctx.dense(xi, p["x_proj"], name + ".x_proj",
                              tp_reduce=True)).to(torch.float32)
    dt_lo, b_in, c_in = torch.split(bcd, [dtr, n, n], dim=-1)
    dt = F.softplus(dt_lo @ at_use(p["dt_w"], torch.float32)
                    + at_use(p["dt_bias"], torch.float32))

    xf = xi.to(torch.float32)
    y, h = selective_scan(dt, p["A_log"], b_in, c_in, xf, h0)
    y = y + at_use(p["D"], torch.float32) * xf
    y = y.to(x.dtype) * F.silu(z)
    out = ctx.dense(y, p["out_proj"], name + ".out_proj", tp_reduce=True)
    return out, (h, conv_state)
