"""Seeded temperature / top-p sampling on JAX's threefry key chain.

The port's own copy of what the reference engine's sampler
(``repro/serve/engine.py::_sample_one`` / ``_sample_batch``) draws with:
``jax.random``'s ``PRNGKey``, ``split``, ``fold_in``, random bits,
``uniform``, ``gumbel`` (mode "low") and ``categorical``, under
``jax_threefry_partitionable`` (the default): every counter is the flat
index of its element, hashed by Threefry-2x32 (20 rounds) under the key.

A key is an int64 tensor (..., 2) holding two uint32 words; the uint32
arithmetic runs in int64 masked to 32 bits, so a key chain and its random
bits are bit-identical to JAX's on the CPU and on CUDA. ``uniform`` is
exact as well; ``gumbel`` and ``categorical`` go through ``log`` and
``exp``, whose last bit may differ from XLA's. Nothing here keeps state:
no global generator, no ``torch.Generator`` — a draw is a function of its
key, so a replayed tick draws the same token from the same pre-tick key.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words (x0, x1) under the key words
    (k1, k2), all uint32 values in int64 tensors that broadcast together
    (``jax._src.prng._threefry2x32_lowering``)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _hash(keys: torch.Tensor, counts: torch.Tensor):
    """Both output words of each key (..., 2) over the counters ``counts``
    (N,) with a zero high word: two (..., N) tensors."""
    return threefry2x32(keys[..., :1], keys[..., 1:],
                        torch.zeros_like(counts), counts)


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for an int32 seed (JAX's default,
    64-bit types off): the words (0, seed mod 2**32)."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is not an int32")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of each key (..., 2): (..., num, 2)."""
    b1, b2 = _hash(keys, torch.arange(num, device=keys.device))
    return torch.stack([b1, b2], dim=-1)


def fold_in(keys: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` of each key (..., 2) with the uint32 ``data``."""
    b1, b2 = _hash(keys, torch.tensor([data & _MASK], device=keys.device))
    return torch.stack([b1[..., 0], b2[..., 0]], dim=-1)


def random_bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits`` (32-bit) of each key (..., 2): (..., *shape)
    uint32 values in int64."""
    shape = tuple(shape)
    n = int(np.prod(shape))
    if n >= 2 ** 32:
        raise ValueError(f"{n} draws need a high counter word")
    b1, b2 = _hash(keys, torch.arange(n, device=keys.device))
    return (b1 ^ b2).reshape(*keys.shape[:-1], *shape)


def uniform(keys: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` (float32) of each key: 23 random mantissa
    bits under exponent 0, minus one, scaled into [minval, maxval). XLA
    contracts the scale and the shift into one fused multiply-add; the
    product of two floats is exact in float64, so the shift there rounds
    once more only where float64 cannot hold the sum (never on [0, 1) or
    [tiny, 1), the sampler's ranges, where the scale is exact)."""
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    bits = (random_bits(keys, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min((floats.double() * span + lo).float(), lo)


def gumbel(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` (float32, mode "low") of each key."""
    return -torch.log(-torch.log(uniform(keys, shape, _TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: the Gumbel-max draw,
    one per key (..., 2) and row of ``logits`` (..., V)."""
    return torch.argmax(gumbel(keys, logits.shape[-1:]) + logits, dim=-1)


def sample_batch(keys: torch.Tensor, logits: torch.Tensor,
                 temps: torch.Tensor, tops: torch.Tensor):
    """One temperature / top-p draw per row: keys (B, 2), logits (B, V),
    temps and tops (B,) -> (advanced keys (B, 2), tokens (B,) int64).

    Row by row the reference's ``_sample_one``: split the key into (next,
    draw); divide the f32 logits by max(T, 1e-6); softmax; a stable sort
    of the probabilities, descending; keep the smallest prefix whose mass
    before each token is below top_p (the top token always); draw
    ``categorical`` over the kept logits with the draw key."""
    ks = split(keys)
    lg = logits.float() / torch.clamp_min(temps.float(), 1e-6)[:, None]
    unnorm = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    probs = unnorm / unnorm.sum(dim=-1, keepdim=True)
    neg, order = torch.sort(-probs, dim=-1, stable=True)
    sp = -neg
    keep_sorted = (torch.cumsum(sp, dim=-1) - sp) < tops.float()[:, None]
    keep = torch.zeros_like(keep_sorted).scatter_(-1, order, keep_sorted)
    masked = torch.where(keep, lg, torch.full_like(lg, float("-inf")))
    return ks[:, 0], categorical(ks[:, 1], masked)


def sample_one(key: torch.Tensor, logits: torch.Tensor, temperature: float,
               top_p: float):
    """``sample_batch`` of one key (2,) and logits (V,): (advanced key,
    token)."""
    dev = logits.device
    nxt, tok = sample_batch(
        key[None], logits[None],
        torch.tensor([temperature], dtype=torch.float32, device=dev),
        torch.tensor([top_p], dtype=torch.float32, device=dev))
    return nxt[0], tok[0]
