"""Deterministic synthetic LM corpus: a copy of ``repro/data/synthetic.py``
(numpy only), so the port makes the same token stream without importing
the JAX package.

A Zipf-ish Markov-chain token stream with enough structure that a small LM's
loss drops well below the unigram entropy: next-token logits follow a
per-state transition row (few successors per token) plus periodic copy
motifs. The stream is generated in self-contained 64k chunks — chunk i is a
pure function of (config, i) — so any absolute position is seekable in
O(needed chunks), which the resumable pipeline and far-offset eval splits
rely on.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

CHUNK = 65536


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    vocab: int = 512
    seed: int = 0
    branch: int = 4           # successors per state
    copy_period: int = 64     # every k-th token repeats position t-k
    copy_prob: float = 0.3


@functools.lru_cache(maxsize=64)
def _transition_table(cfg: SyntheticConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed)
    return rng.integers(0, cfg.vocab, size=(cfg.vocab, cfg.branch))


@functools.lru_cache(maxsize=32)
def _gen_chunk(cfg: SyntheticConfig, ci: int) -> np.ndarray:
    """Self-contained chunk ci (state re-seeded per chunk => O(1) seek)."""
    table = _transition_table(cfg)
    decisions = np.random.default_rng(cfg.seed * 7919 + 2 + ci).random(CHUNK)
    picks = np.random.default_rng(cfg.seed * 7919 + 3 + ci).integers(
        0, cfg.branch, CHUNK)
    buf = np.empty(CHUNK, np.int32)
    hist = np.zeros(cfg.copy_period, np.int32)
    state = int((ci * 2654435761 + 1) % cfg.vocab)
    cp, cprob = cfg.copy_period, cfg.copy_prob
    for i in range(CHUNK):
        if i % cp == 0 and decisions[i] < cprob:
            tok = hist[i % cp]
        else:
            tok = table[state, picks[i]]
        buf[i] = tok
        hist[i % cp] = tok
        state = int(tok)
    return buf


def make_tokens(cfg: SyntheticConfig, n: int, start: int = 0) -> np.ndarray:
    """Tokens [start, start+n) — touches only the covering chunks."""
    out = np.empty(n, np.int32)
    first = start // CHUNK
    last = (start + n - 1) // CHUNK
    for ci in range(first, last + 1):
        buf = _gen_chunk(cfg, ci)
        lo = max(start, ci * CHUNK)
        hi = min(start + n, (ci + 1) * CHUNK)
        out[lo - start:hi - start] = buf[lo - ci * CHUNK:hi - ci * CHUNK]
    return out


def token_stream(cfg: SyntheticConfig, start: int = 0):
    """Iterator view (kept for API compatibility)."""
    pos = start
    while True:
        chunk = make_tokens(cfg, CHUNK - (pos % CHUNK), pos)
        for t in chunk:
            yield int(t)
        pos += len(chunk)
