"""Resumable, shardable data pipeline over the deterministic synthetic corpus:
a copy of ``repro/data/pipeline.py`` (numpy only).

Batches are a pure function of (config, step): restart at step k reproduces
batch k exactly (required for checkpoint/restart to be bit-reproducible), and
each data-parallel host slices its own rows (no global shuffle state).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.data.synthetic import SyntheticConfig, make_tokens


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_examples: Optional[int] = None   # paper: 128 QAT examples, cycled


class LMDataset:
    """Next-token-prediction batches from the synthetic stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.scfg = SyntheticConfig(vocab=cfg.vocab, seed=cfg.seed)
        if cfg.n_examples is not None:
            n_tok = cfg.n_examples * (cfg.seq_len + 1)
            self._pool = make_tokens(self.scfg, n_tok).reshape(
                cfg.n_examples, cfg.seq_len + 1)
        else:
            self._pool = None

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        b, s = self.cfg.global_batch, self.cfg.seq_len
        if self._pool is not None:
            idx = (step * b + np.arange(b)) % self._pool.shape[0]
            seqs = self._pool[idx]
        else:
            start = step * b * (s + 1)
            seqs = make_tokens(self.scfg, b * (s + 1), start).reshape(b, s + 1)
        return {
            "tokens": seqs[:, :-1].astype(np.int32),
            "labels": seqs[:, 1:].astype(np.int32),
        }

    def epoch_steps(self) -> int:
        if self._pool is None:
            raise ValueError("infinite dataset has no epochs")
        return max(1, self._pool.shape[0] // self.cfg.global_batch)

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(step)
            step += 1


def eval_batches(cfg: DataConfig, n_batches: int, offset: int = 10 ** 6):
    """Held-out eval split: the SAME generating process (same seed/table),
    a disjoint far-offset stream region (cheap: chunks seek in O(1))."""
    ds = LMDataset(dataclasses.replace(cfg, n_examples=None))
    return [ds.batch_at(offset + i) for i in range(n_batches)]
