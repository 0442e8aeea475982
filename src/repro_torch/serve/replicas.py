"""Data-parallel serving replicas: one ``ElasticEngine`` per device slice.

Counterpart of ``repro/serve/replicas.py``. ``ElasticEngine(mesh=...)`` is
tensor parallelism: one logical engine sharded over a mesh's ``model``
axis. Data parallelism is the other axis: independent engines, each serving
a disjoint slice of the request stream. Requests partition by
``rid % n_replicas``: deterministic, stateless and stable across snapshot /
resume. Each replica's wave is a plain single-engine wave, so its streams
are the ones its requests get alone on one engine; replicas serve one after
another, as the reference's do.

``tp == 1`` builds every engine with ``mesh=None`` on the caller's device,
as the reference does. A replica of ``tp > 1`` shards over processes (one
per shard), so one process cannot hold the whole set: such a set is
refused (ROADMAP A.9.3); run one ``ElasticEngine(mesh=...)`` per replica's
process group instead. ``replica_meshes`` carves the grid all the same.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.launch.mesh import Mesh
from repro_torch.serve.engine import ElasticEngine, Request


def replica_meshes(n_replicas: int, tp: int = 1,
                   devices: Optional[Sequence[int]] = None) -> List[Mesh]:
    """Carve ``devices`` (default: the ranks of the initialised default
    group, or this process alone) into ``n_replicas`` disjoint ``(1, tp)``
    mesh descriptions with axes ``("data", "model")``."""
    if devices is None:
        import torch.distributed as dist
        on = dist.is_available() and dist.is_initialized()
        devices = list(range(dist.get_world_size() if on else 1))
    need = n_replicas * tp
    if len(devices) < need:
        raise ValueError(
            f"{n_replicas} replica(s) x tp={tp} needs {need} device(s); "
            f"only {len(devices)} available")
    return [Mesh(np.array(devices[i * tp:(i + 1) * tp]).reshape(1, tp),
                 ("data", "model"))
            for i in range(n_replicas)]


class ReplicaSet:
    """``n_replicas`` independent engines serving a partitioned stream.

    Every engine is built with the same configuration (same anchor, same
    knobs), so a request gets the same tokens on whichever replica it lands;
    the partition decides where, never what."""

    def __init__(self, api, anchor, *, n_replicas: int, tp: int = 1,
                 devices=None, **engine_kwargs):
        if n_replicas < 1:
            raise ValueError(f"n_replicas ({n_replicas}) must be >= 1")
        if "mesh" in engine_kwargs:
            raise ValueError(
                "pass tp= instead of mesh=; ReplicaSet builds one "
                "(1, tp) mesh per replica")
        if tp > 1:
            replica_meshes(n_replicas, tp, devices)
            raise NotImplementedError(
                f"ReplicaSet(tp={tp}): each replica shards over tp "
                "processes, so one process cannot build the set; run one "
                "ElasticEngine(mesh=...) per replica's group (ROADMAP "
                "A.9.3)")
        self.n_replicas = n_replicas
        self.tp = tp
        self.engines: List[ElasticEngine] = [
            ElasticEngine(api, anchor, **engine_kwargs)
            for _ in range(n_replicas)]

    def home(self, rid: int) -> int:
        """The replica index serving request ``rid``."""
        return rid % self.n_replicas

    def partition(self, requests: List[Request]) -> List[List[Request]]:
        parts: List[List[Request]] = [[] for _ in range(self.n_replicas)]
        for r in requests:
            parts[self.home(r.rid)].append(r)
        return parts

    def generate(self, requests: List[Request], **kw) -> List[Request]:
        """Serve ``requests`` across the replicas; returns them all (each
        mutated in place by its home engine, in the original order)."""
        for part, eng in zip(self.partition(requests), self.engines):
            if part:
                eng.generate(part, **kw)
        return requests

    def stats(self) -> Dict:
        per = [e.stats() for e in self.engines]
        return {
            "n_replicas": self.n_replicas,
            "tp": self.tp,
            "tokens_out": sum(s["tokens_out"] for s in per),
            "ticks": sum(s["ticks"] for s in per),
            "replicas": per,
        }
