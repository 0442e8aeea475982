"""The one general traffic generator. A mix file gives its parameters:

  {"requests": N,
   "prompt": {"median": m, "sigma": s, "min": lo, "max": hi},
   "output": {"median": m, "sigma": s, "min": lo, "max": hi},
   "arrivals": {"kind": "at_once"} | {"kind": "poisson_ticks",
                                        "per_tick": r}}

Lengths are log-normal with the given median and sigma, clipped to
[min, max]. Every seed gets the same multiset of sizes and of gaps between
arrivals, the quantiles (i + 0.5) / N of the distributions, dealt out in an
order drawn from the seed: the seed changes which request is which and the
tokens of every prompt, not the amount of work. A mix with
``"order": {"fixed": k}`` deals them out in one order for every seed,
drawn from k: the seed then draws only the tokens (a fixed trace, for
cells whose tail is a queue's, which the order alone would move more than
anything the program does). Arrivals are in scheduler
ticks (``Request.arrival_tick``): "at_once" makes every request due at
tick 0 (an offline batch); "poisson_ticks" spaces them by exponential gaps
of mean 1 / per_tick ticks.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np


def _quantiles(spec: Dict, n: int) -> np.ndarray:
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    v = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    return np.clip(np.rint(v), spec["min"], spec["max"]).astype(np.int64)


def generate(mix: Dict, seed: int, vocab: int) -> List[Dict]:
    """[{"prompt": int32 array, "max_new": int, "arrival_tick": int}] in
    arrival order."""
    n = int(mix["requests"])
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    fixed = mix.get("order", {}).get("fixed")
    deal = rng if fixed is None else \
        np.random.Generator(np.random.PCG64(int(fixed)))
    plen = deal.permutation(_quantiles(mix["prompt"], n))
    olen = deal.permutation(_quantiles(mix["output"], n))
    arr = mix.get("arrivals", {"kind": "at_once"})
    if arr["kind"] == "at_once":
        ticks = np.zeros(n, np.int64)
    elif arr["kind"] == "poisson_ticks":
        u = (np.arange(n) + 0.5) / n
        gaps = deal.permutation(-np.log1p(-u) / float(arr["per_tick"]))
        ticks = np.floor(np.cumsum(gaps)).astype(np.int64)
    else:
        raise ValueError(f"unknown arrivals kind {arr['kind']!r}")
    return [{"prompt": rng.integers(0, vocab, size=int(p), dtype=np.int32),
             "max_new": int(o), "arrival_tick": int(t)}
            for p, o, t in zip(plen, olen, ticks)]
