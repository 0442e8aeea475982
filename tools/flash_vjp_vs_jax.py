#!/usr/bin/env python3
"""The largest differences between the port's flash attention
(``repro_torch.models.flash_vjp``, the padded plan where the chunk does not
divide the length) and the JAX package's, on the inputs of
``tests/test_torch_flash_vjp.py``: the output and (dq, dk, dv), f32, on the
CPU. One line per case: the max abs difference and the max of
|difference| / (|jax| + 1e-30) over the elements where |jax| > 2e-5.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/flash_vjp_vs_jax.py
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.flash_vjp import flash_attention_vjp as jflash
from repro_torch.models.flash_vjp import _plan, flash_attention_vjp

CASES = [(sq, chunk, window) for sq, chunk in ((64, 16), (64, 32), (96, 64),
                                               (200, 64), (97, 32))
         for window in (None, 24)]


def _qkv(sq, seed=0, b=2, h=4, hkv=2, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sq, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sq, hkv, d)).astype(np.float32)
    ct = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, ct


def main() -> int:
    for sq, chunk, window in CASES:
        q, k, v, ct = _qkv(sq)
        kw = dict(causal=True, window=window, chunk=chunk)
        want = [jflash(q, k, v, **kw)] + list(jax.grad(
            lambda *a: jnp.sum(jflash(*a, **kw) * ct), (0, 1, 2))(q, k, v))
        tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        out = flash_attention_vjp(tq, tk, tv, **kw)
        (out * torch.from_numpy(ct)).sum().backward()
        got = [out.detach(), tq.grad, tk.grad, tv.grad]
        abs_err = rel_err = 0.0
        for g, w in zip(got, want):
            w = np.asarray(w)
            diff = np.abs(g.numpy() - w)
            abs_err = max(abs_err, float(diff.max()))
            big = np.abs(w) > 2e-5
            rel_err = max(rel_err, float((diff[big] / np.abs(w[big])).max()))
        cq, _, sq_p = _plan(sq, sq, True, window, chunk)[:3]
        print(f"S {sq} chunk {chunk} window {window}: port chunks {cq} over "
              f"{sq_p}; max abs {abs_err:.3g}, max rel {rel_err:.3g}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
