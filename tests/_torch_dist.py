"""Run a function in every rank of a small gloo group on the host.

``run_ranks(fn, world, *args)`` spawns ``world`` processes, joins them into
one ``torch.distributed`` gloo group over ``tcp://127.0.0.1``, runs
``fn(rank, *args)`` in each and returns their results in rank order. It
skips the calling test when gloo cannot start here. ``fn`` must be a
module-level function of a module that the spawned children can import
without JAX (this one, or ``repro_torch``).
"""
from __future__ import annotations

import socket
import traceback

import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank, world, port, fn, args, q):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
    except Exception as e:               # noqa: BLE001 - reported as a skip
        q.put((rank, "nogloo", repr(e)))
        return
    try:
        q.put((rank, "ok", fn(rank, *args)))
    except Exception:                    # noqa: BLE001 - re-raised in parent
        q.put((rank, "error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = 240.0):
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_child, args=(r, world, port, fn, args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in procs:
            rank, kind, val = q.get(timeout=timeout)
            out[rank] = (kind, val)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    if any(k == "nogloo" for k, _ in out.values()):
        pytest.skip(f"gloo cannot start here: {out}")
    errors = [v for k, v in out.values() if k == "error"]
    if errors:
        raise AssertionError("a rank failed:\n" + "\n".join(errors))
    return [out[r][1] for r in range(world)]


# ---- rank functions (no JAX: the children import only this module) -------
def allreduce_worker(rank, grads_by_rank, fmt_name):
    """``compressed_pod_allreduce`` of this rank's gradient tree (numpy
    leaves) over the default group, from a zero error state."""
    import numpy as np
    import torch
    from repro_torch.train.compression import (compressed_pod_allreduce,
                                               init_error_state)
    grads = {k: torch.from_numpy(np.asarray(v))
             for k, v in grads_by_rank[rank].items()}
    red, err = compressed_pod_allreduce(grads, init_error_state(grads),
                                        fmt_name)
    return ({k: v.numpy() for k, v in red.items()},
            {k: v.numpy() for k, v in err.items()})


def tp_engine_worker(rank, arch, path, prompts, max_new, fmts, snap_dir):
    """The port's ``ElasticEngine`` on a (1, world) mesh of this group:
    greedy streams on the dense and the paged layout at each format, the
    last-position prefill logits of the first prompt through the sharded
    model, the weight bytes, and a snapshot taken mid-wave then resumed on
    a fresh meshed engine."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.anchor_ckpt import load_anchor
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.transformer import make_model
    from repro_torch.runtime.fault import FaultInjector, PreemptionGuard
    from repro_torch.serve.engine import ElasticEngine, Request

    mesh = make_debug_mesh(1, dist.get_world_size())
    api = make_model(get_reduced(arch))
    anchor = load_anchor(path, device="cpu")

    def engine(layout, **kw):
        if layout == "paged":
            kw.update(kv_layout="paged", kv_page_size=8)
        return ElasticEngine(api, anchor, batch_slots=2, max_len=48,
                             device="cpu", mesh=mesh, **kw)

    def reqs(n=None):
        return [Request(i, p, max_new) for i, p in enumerate(prompts[:n])]

    out = {"streams": {}, "logits": {}, "stats": {}}
    for layout in ("dense", "paged"):
        eng = engine(layout)
        for fmt in fmts:
            got = eng.generate(reqs(), fmt_override=fmt)
            out["streams"][layout, fmt] = [r.out_tokens for r in got]
        st = eng.stats()
        out["stats"][layout] = {k: st[k] for k in (
            "weight_bytes", "weight_bytes_per_chip", "mesh", "cuda_graphs",
            "kv_pages_alloc", "kv_pages_freed")}
        if layout == "dense":
            for fmt in fmts:
                cache = eng._init_cache(1)
                logits, _, _ = eng._api_for(fmt).prefill(
                    eng.weights_for(fmt),
                    {"tokens": torch.from_numpy(prompts[0][None])}, cache)
                out["logits"][fmt] = logits.numpy()
    inj = FaultInjector(preempt_at=2)
    eng = engine("dense", fault_injector=inj)
    eng.generate(reqs(3), fmt_override=fmts[0], guard=PreemptionGuard(),
                 snapshot_dir=snap_dir)
    out["snapshot"] = eng.last_snapshot
    out["resumed"] = [r.out_tokens
                      for r in engine("dense").resume(snap_dir)]
    return out
