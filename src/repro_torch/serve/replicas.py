"""Data-parallel serving replicas: one ``ElasticEngine`` per device slice.

Counterpart of ``repro/serve/replicas.py``. ``ElasticEngine(mesh=...)`` is
tensor parallelism: one logical engine sharded over a mesh's ``model``
axis. Data parallelism is the other axis: independent engines, each serving
a disjoint slice of the request stream. Requests partition by
``rid % n_replicas``: deterministic, stateless and stable across snapshot /
resume. Each replica's wave is a plain single-engine wave, so its streams
are the ones its requests get alone on one engine.

``tp == 1`` builds every engine with ``mesh=None`` on the caller's device,
as the reference does; its replicas serve one after another in this
process. A replica of ``tp > 1`` shards over ``tp`` processes (one per
shard, as ``ElasticEngine(mesh=...)``), so the set runs in
``n_replicas * tp`` processes of an initialised default group, every one
of them building the set: each makes every replica's process group (in the
same order: ``new_group`` is collective) and holds its own replica's
engine, on that replica's ``(1, tp)`` mesh. Each process serves its
replica's partition, so the replicas serve at the same time; the finished
requests are then exchanged, so that every process returns all of them,
mutated in place, as the reference's ``generate`` does. ``stats`` sums
over the replicas, a collective too.
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
        self.n_replicas = n_replicas
        self.tp = tp
        self.replica: Optional[int] = None   # this process's (tp > 1)
        if tp > 1:
            self.replica, mesh = self._join(
                replica_meshes(n_replicas, tp, devices))
            self.engines: List[ElasticEngine] = [
                ElasticEngine(api, anchor, mesh=mesh, **engine_kwargs)]
        else:
            self.engines = [ElasticEngine(api, anchor, **engine_kwargs)
                            for _ in range(n_replicas)]

    def _join(self, meshes: List[Mesh]):
        """Make every replica's process group (every process, in order)
        and return (this process's replica, its mesh with the group)."""
        import torch.distributed as dist
        need = self.n_replicas * self.tp
        world = dist.get_world_size() if dist.is_available() \
            and dist.is_initialized() else None
        if world != need or sorted(int(r) for m in meshes
                                   for r in m.devices.ravel()) \
                != list(range(need)):
            raise ValueError(
                f"ReplicaSet(n_replicas={self.n_replicas}, tp={self.tp}) "
                f"runs in {need} processes, one per shard, the ranks of an "
                f"initialised default group of {need} (this one: "
                f"{'none' if world is None else world})")
        rank, mine = dist.get_rank(), None
        for i, m in enumerate(meshes):
            ranks = [int(r) for r in m.devices.ravel()]
            group = dist.new_group(ranks)
            if rank in ranks:
                mine = i, Mesh(m.devices, m.axis_names, group=group,
                               coords={"data": 0,
                                       "model": ranks.index(rank)})
        return mine

    def _gather(self, obj) -> List:
        """Every process's ``obj``, in rank order (a collective)."""
        import torch.distributed as dist
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, obj)
        return out

    def _lead(self) -> bool:
        """This process is its replica's first shard (tp > 1)."""
        return self.engines[0].mesh.coord("model") == 0

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
        mutated in place by its home engine, in the original order). With
        ``tp > 1`` every process of the set calls it with the same
        requests: it serves its replica's part, then takes the others'
        finished requests from their replicas' first shards."""
        if self.tp == 1:
            for part, eng in zip(self.partition(requests), self.engines):
                if part:
                    eng.generate(part, **kw)
            return requests
        part = self.partition(requests)[self.replica]
        if part:
            self.engines[0].generate(part, **kw)
        mine = [(i, vars(r)) for i, r in enumerate(requests)
                if self.home(r.rid) == self.replica] if self._lead() else []
        for done in self._gather(mine):
            for i, fields in done:
                if self.home(requests[i].rid) != self.replica:
                    vars(requests[i]).update(fields)
        return requests

    def stats(self) -> Dict:
        """The set's counters: per replica, and ``tokens_out`` / ``ticks``
        summed (with ``tp > 1``, a collective of every process)."""
        if self.tp == 1:
            per = [e.stats() for e in self.engines]
        else:
            lead = (self.replica, self.engines[0].stats()) \
                if self._lead() else None
            per = [st for _, st in sorted(
                (x for x in self._gather(lead) if x is not None),
                key=lambda x: x[0])]
        return {
            "n_replicas": self.n_replicas,
            "tp": self.tp,
            "tokens_out": sum(s["tokens_out"] for s in per),
            "ticks": sum(s["ticks"] for s in per),
            "replicas": per,
        }
