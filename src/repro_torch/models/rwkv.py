"""RWKV6 "Finch" block: token-shift lerps, a data-dependent per-channel
decay and the WKV matrix-state recurrence

    S_t = diag(w_t) S_{t-1} + k_t v_t^T,
    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T).

Counterpart of ``repro/models/rwkv.py``, op for op, plain PyTorch (the JAX
block is ``jnp`` and ``lax.scan``; no Pallas kernel reaches it). The
recurrence runs in the reference's chunks (``_wkv_chunked``): inside a
chunk the carried state enters through one product against the
cumulative decay, and the chunk's own tokens through a masked (c x c)
pairwise term, all in float32. Under autograd each chunk's pairwise term
is recomputed in the backward (``torch.utils.checkpoint``), so training
holds one chunk's (B, c, c, H, hd) pairwise tensor at a time, as the JAX
scan does.

The projections (``wr``, ``wk``, ``wv``, ``wg``, ``wo``; ``w_key``,
``w_value``, ``w_recept``) go through ``QuantCtx.dense``; the decay LoRA
is a plain float32 product, as in JAX, and every other leaf (the ``mix_*``
lerp weights, ``decay_*``, ``bonus``, ``ln_scale``) is densified where it
is used if it comes packed (``common.at_use``). At 32 stacked layers the
anchor quantizes the seven (G, d) ``mix_*`` leaves with their blocks along
the layer axis (ROADMAP C.11): ``forward_hidden`` densifies those whole
leaves once per call, before any layer reads its row.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ModelConfig, QuantCtx, at_use

WKV_CHUNK = 64
DECAY_LORA = 64


def rwkv_param_shapes(cfg: ModelConfig, g: int) -> Dict:
    """The stacked (G, ...) leaves of the time mix (``rwkv``) and the
    channel mix (``cmix``) with the JAX init: lerp weights 0.5,
    ``decay_base`` -4, the decay LoRA std 0.01, ``bonus`` std 0.1, the
    output projections std 0.02 / sqrt(n_layers), the others 0.02."""
    d, hd, f = cfg.d_model, cfg.rwkv_head_dim, cfg.d_ff
    down = 0.02 / cfg.n_layers ** 0.5
    half = ("full", 0.5)
    time = {f"mix_{m}": ((g, d), half) for m in "rkvgw"}
    time.update(decay_base=((g, d), ("full", -4.0)),
                decay_w1=((g, d, DECAY_LORA), 0.01),
                decay_w2=((g, DECAY_LORA, d), 0.01),
                bonus=((g, d // hd, hd), 0.1),
                wr=((g, d, d), 0.02), wk=((g, d, d), 0.02),
                wv=((g, d, d), 0.02), wg=((g, d, d), 0.02),
                wo=((g, d, d), down), ln_scale=((g, d), "ones"))
    channel = {"mix_k": ((g, d), half), "mix_r": ((g, d), half),
               "w_key": ((g, d, f), 0.02), "w_value": ((g, f, d), down),
               "w_recept": ((g, d, d), 0.02)}
    return {"rwkv": time, "cmix": channel}


def rwkv_param_axes(cfg: ModelConfig) -> Dict:
    """Logical axes of the (unstacked) time-mix (``time``) and channel-mix
    (``channel``) leaves, the reference's."""
    mm = ("fsdp", "model")
    return {
        "time": {
            "mix_r": (None,), "mix_k": (None,), "mix_v": (None,),
            "mix_g": (None,), "mix_w": (None,),
            "decay_base": ("model",),
            "decay_w1": ("fsdp", None), "decay_w2": (None, "model"),
            "bonus": ("heads", None),
            "wr": mm, "wk": mm, "wv": mm, "wg": mm,
            "wo": ("model", "fsdp"),
            "ln_scale": (None,),
        },
        "channel": {
            "mix_k": (None,), "mix_r": (None,),
            "w_key": ("fsdp", "mlp"), "w_value": ("mlp", "fsdp"),
            "w_recept": mm,
        },
    }


def _token_shift(x, shift_state):
    """Previous-token features. x (B, S, d); shift_state (B, 1, d) or
    None for zeros."""
    prev = torch.zeros_like(x[:, :1]) if shift_state is None else \
        shift_state.to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def _chunk_len(s: int, chunk: int = WKV_CHUNK) -> int:
    """The reference's chunk: min(chunk, S), halved until it divides S."""
    c = min(chunk, s)
    while s % c:
        c //= 2
    return c


def _intra(rc, kc, vc, cum, cum_prev):
    """One chunk's pairwise term: rc/kc/vc (B, c, H, hd) and the chunk's
    inclusive / exclusive cumulative log decays -> (B, c, H, hd), the sum
    over j < t of r_t (k_j ⊙ W_{t-1} / W_j) v_j^T."""
    c = rc.shape[1]
    # exp(cum_prev_t - cum_j) <= 1 (cum does not increase): the
    # overflow-safe form
    diff = cum_prev[:, :, None] - cum[:, None]      # (B, c_t, c_j, H, hd)
    att = (rc[:, :, None] * torch.exp(torch.clamp(diff, max=0.0))
           * kc[:, None]).sum(-1).permute(0, 3, 1, 2)      # (B, H, t, j)
    mask = torch.ones((c, c), dtype=torch.bool, device=rc.device).tril(-1)
    att = torch.where(mask, att, 0.0)
    return torch.einsum("bhtj,bjhv->bthv", att, vc)


def _wkv_chunked(r, k, v, w, u, s0, chunk: int = WKV_CHUNK):
    """WKV recurrence in chunks. r, k, v, w: (B, S, H, hd) float32 (w the
    per-step decay factors in (0, 1)), u (H, hd), s0 (B, H, hd, hd) or
    None for zeros. Returns (y (B, S, H, hd), s_final).

    Per chunk, as the reference's scan step: y = r ⊙ W_{t-1} against the
    carried state, plus the pairwise term, plus the bonus; the state
    becomes S ⊙ W_c + sum_j (W_c / W_j) k_j v_j^T. Only the state's
    recursion is sequential: the terms that do not read it are computed
    for every chunk at once, so a prompt of one-token chunks (an odd
    length) loops over two small ops per token, not over the whole step.
    The pairwise term runs chunk by chunk (one chunk's (B, c, c, H, hd)
    tensor at a time, recomputed in the backward under grad) and is left
    out for one-token chunks, where it is exact zeros."""
    bsz, s, h, hd = r.shape
    c = _chunk_len(s, chunk)
    nc = s // c
    logw = torch.log(torch.clamp(w, min=1e-38))
    rs, ks, vs, lw = (t.reshape(bsz, nc, c, h, hd) for t in (r, k, v, logw))
    cum = torch.cumsum(lw, dim=2)                   # W_t (inclusive)
    cum_prev = cum - lw                             # W_{t-1} (exclusive)
    # each chunk's own increment of the state, and its decay of the
    # carried one
    kv = torch.einsum("bnjhk,bnjhv->bnhkv",
                      ks * torch.exp(cum[:, :, -1:] - cum), vs)
    wtot = torch.exp(cum[:, :, -1])[..., None]      # (B, nc, H, hd, 1)
    state = torch.zeros((bsz, h, hd, hd), dtype=torch.float32,
                        device=r.device) if s0 is None \
        else s0.to(torch.float32)
    carried = []
    for i in range(nc):
        carried.append(state)
        state = state * wtot[:, i] + kv[:, i]
    y = torch.einsum("bnchk,bnhkv->bnchv", rs * torch.exp(cum_prev),
                     torch.stack(carried, 1))
    if c > 1:
        grad = torch.is_grad_enabled()
        intra = []
        for i in range(nc):
            args = (rs[:, i], ks[:, i], vs[:, i], cum[:, i], cum_prev[:, i])
            intra.append(checkpoint(_intra, *args, use_reentrant=False)
                         if grad else _intra(*args))
        y = y + torch.stack(intra, 1)
    y = y + (rs * ks * u).sum(-1, keepdim=True) * vs        # the bonus
    return y.reshape(bsz, s, h, hd), state


def _group_norm_heads(x, scale, eps: float):
    """x (B, S, H, hd): normalize each head, then flatten to (B, S, d)."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    b, s, h, hd = y.shape
    return y.reshape(b, s, h * hd) * scale


def rwkv_time_mix(ctx: QuantCtx, x, p, cfg: ModelConfig, name: str,
                  state: Optional[Tuple] = None):
    """x (B, S, d) -> (out, (shift (B, 1, d), wkv (B, H, hd, hd) f32)).
    ``state`` = (shift, wkv) carries a decode's state; None starts from
    zeros (prefill, training).

    Under tensor parallelism this process runs its heads
    (``ctx.shard(cfg).rwkv_heads``): ``wr`` / ``wk`` / ``wv`` / ``wg``
    column-parallel, the WKV state, ``bonus``, ``decay_base``,
    ``decay_w2``'s columns and the group norm per local head or channel,
    ``wo`` row-parallel. The lerped inputs, the decay LoRA's replicated
    hidden and the whole ``ln_scale`` enter the per-head work through
    ``copy_in``."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = ctx.shard(cfg).rwkv_heads
    shift0, wkv0 = state if state is not None else (None, None)
    xx = _token_shift(x, shift0)

    def mixed(m):
        return x + (xx - x) * at_use(p[m], x.dtype)

    r = ctx.dense(ctx.tp_in(mixed("mix_r")), p["wr"], name + ".wr")
    k = ctx.dense(ctx.tp_in(mixed("mix_k")), p["wk"], name + ".wk")
    v = ctx.dense(ctx.tp_in(mixed("mix_v")), p["wv"], name + ".wv")
    g = F.silu(ctx.dense(ctx.tp_in(mixed("mix_g")), p["wg"], name + ".wg"))

    # the data-dependent decay: d_t = base + lora(x_w), in f32
    f32 = torch.float32
    xw = mixed("mix_w").to(f32)
    dlo = ctx.tp_in(torch.tanh(xw @ at_use(p["decay_w1"], f32))) \
        @ at_use(p["decay_w2"], f32)
    decay = torch.exp(-torch.exp(at_use(p["decay_base"], f32) + dlo))

    def heads(t):
        return t.to(f32).reshape(b, s, h, hd)

    y, wkv = _wkv_chunked(heads(r), heads(k), heads(v), heads(decay),
                          at_use(p["bonus"], f32), wkv0)
    scale = ctx.tp_in(at_use(p["ln_scale"], f32))
    if ctx.tp is not None:
        scale = scale[ctx.tp.rank * h * hd:(ctx.tp.rank + 1) * h * hd]
    y = _group_norm_heads(y, scale, cfg.norm_eps)
    y = y.to(x.dtype) * g
    out = ctx.dense(y, p["wo"], name + ".wo", tp_reduce=True)
    return out, (x[:, -1:], wkv)


def rwkv_channel_mix(ctx: QuantCtx, x, p, cfg: ModelConfig, name: str,
                     state=None):
    """x (B, S, d) -> (out, shift (B, 1, d)); ``state`` the carried shift
    or None for zeros. Under tensor parallelism ``w_key`` is
    column-parallel and ``w_value`` row-parallel (d_ff on ``model``), and
    ``w_recept`` column-parallel over d: its slice of the receptance is
    all-gathered before the product with the replicated value."""
    xx = _token_shift(x, state)

    def mixed(m):
        return ctx.tp_in(x + (xx - x) * at_use(p[m], x.dtype))

    kx = ctx.dense(mixed("mix_k"), p["w_key"], name + ".w_key")
    kx = torch.square(F.relu(kx))
    vx = ctx.dense(kx, p["w_value"], name + ".w_value", tp_reduce=True)
    rx = torch.sigmoid(ctx.dense(mixed("mix_r"), p["w_recept"],
                                 name + ".w_recept"))
    if ctx.tp is not None:
        rx = ctx.tp.all_gather_last(rx)
    return rx * vx, x[:, -1:]
