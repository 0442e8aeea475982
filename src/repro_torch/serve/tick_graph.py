"""The engine's decode and mixed ticks as CUDA graphs, captured once per key.

Counterpart, on one card, of the reference's one jitted executable per
tick (``repro/serve/engine.py``: each step entry point goes through
``jax.jit`` by ``_mesh_jit``). ``TickGraphs.run(key, step)`` runs one tick
— ``step()`` is the engine's ``serve_step`` or ``mixed_step`` against
buffers that keep their storage for the engine's lifetime — and returns
its logits:

  first call of a key  ``step()`` runs eagerly. That run is the tick's real
                       work, and also the warm-up that grows what a capture
                       may not allocate (B3/B4's ticket counters, cuBLAS's
                       workspace). Then ``step`` is captured; a capture
                       launches nothing, so it writes no KV and its counts
                       are rolled back.
  every later call     one ``replay()``, which rewrites the graph's static
                       logits; the launches the capture recorded are
                       credited to the wrappers' counters.

A key is (entry point, format, KV layout, chunk width). A hybrid stack's
Mamba state (``h``, ``conv``) lives in the cache, so a decode graph reads
and rewrites it in place like the KV. Every graph of one
engine allocates from one memory pool, so one graph per format and width
does not multiply activation memory. The price: a replay may overwrite
another graph's static logits, so a caller consumes the logits a ``run``
returns before the next ``run``. A capture that fails raises; nothing
falls back to eager launches.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Hashable, List, Tuple

import torch

from repro_torch.kernels import dispatch, mx_matmul, paged_attention

# The counter modules a tick moves: B1/B2 and B3/B4 launches, and the
# dispatch paths' counts. Each offers snapshot() and credit(delta).
COUNTERS = (mx_matmul, paged_attention, dispatch)


def _snapshot() -> List[Dict[str, int]]:
    return [m.snapshot() for m in COUNTERS]


def _delta(before: List[Dict[str, int]],
           after: List[Dict[str, int]]) -> List[Dict[str, int]]:
    return [{k: n - b[k] for k, n in a.items() if n != b[k]}
            for b, a in zip(before, after)]


def _credit(deltas: List[Dict[str, int]], sign: int = 1) -> None:
    for m, d in zip(COUNTERS, deltas):
        m.credit({k: sign * n for k, n in d.items()})


def capture(step: Callable[[], torch.Tensor], pool
            ) -> Tuple[torch.cuda.CUDAGraph, torch.Tensor]:
    """``step`` captured into a CUDA graph that allocates from ``pool``:
    (the graph, its static output)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        static = step()
    return graph, static


@dataclasses.dataclass
class TickGraph:
    graph: torch.cuda.CUDAGraph
    logits: torch.Tensor              # static output, rewritten per replay
    launches: List[Dict[str, int]]    # what one replay adds, per counter


class TickGraphs:
    """The captured ticks of one engine, by key, and what they cost:
    ``captures``, ``replays`` and ``capture_s`` (host seconds spent
    capturing, the synchronize before each capture included)."""

    def __init__(self):
        self._pool = torch.cuda.graph_pool_handle()
        self._entries: Dict[Hashable, TickGraph] = {}
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    def run(self, key: Hashable,
            step: Callable[[], torch.Tensor]) -> torch.Tensor:
        """The logits of one tick: a replay of ``key``'s graph, or, the
        first time, ``step()`` eagerly and then its capture. Everything
        ``step`` reads must keep its storage while the graph lives."""
        entry = self._entries.get(key)
        if entry is not None:
            entry.graph.replay()
            _credit(entry.launches)
            self.replays += 1
            return entry.logits
        logits = step()
        t0 = time.perf_counter()
        before = _snapshot()
        try:
            graph, static = capture(step, self._pool)
        finally:
            launches = _delta(before, _snapshot())
            _credit(launches, -1)       # the capture launched nothing
        self._entries[key] = TickGraph(graph, static, launches)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return logits
