"""Run a function in every rank of a small gloo group on the host.

``run_ranks(fn, world, *args)`` spawns ``world`` processes, joins them into
one ``torch.distributed`` gloo group over ``tcp://127.0.0.1``, runs
``fn(rank, *args)`` in each and returns their results in rank order
(``start_ranks`` returns at once, with a function that waits for them). It
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


def start_ranks(fn, world: int, *args, timeout: float = 240.0):
    """``run_ranks`` started: the processes run while the caller works on;
    the returned function waits for them and gives their results."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_child, args=(r, world, port, fn, args, q))
             for r in range(world)]
    for p in procs:
        p.start()

    def wait():
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
    return wait


def run_ranks(fn, world: int, *args, timeout: float = 240.0):
    return start_ranks(fn, world, *args, timeout=timeout)()


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


def _np_tree(tree):
    """{keystr path: numpy} of a tensor tree."""
    from repro_torch.core.tree import flatten_paths
    return {k: v.detach().cpu().numpy() for k, v in flatten_paths(tree)}


def sharded_step_worker(rank, arch, cases, flat, batches, fmt_idx, lr,
                        anchor=None, over=None, formats=None):
    """The port's sharded train step of a reduced ``arch`` (``over``: its
    fields replaced; ``formats``, MXINT's by default, ``anchor`` for
    anchored QAT) on meshes
    of this group, from the whole numpy parameters ``flat`` and a zero
    AdamW state. Per case ``(shape, microbatch)``: ``gather_state(
    shard_state(s)) == s`` bit for bit, the state bytes this process holds
    and the whole state's, then one step per batch of ``batches``: each
    step's loss and grad norm; at the first batch the whole-batch
    ``train_loss`` terms (ce, aux) and the gathered gradients (microbatch
    1), and the gathered parameters and moments after the first step, and
    on a ``model`` axis above 1 this process's leaves of the state that the
    axis replicates (``replicated``), as they are after that step."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.core.formats import TRAIN_FORMATS_MXINT
    from repro_torch.core.qat import QATConfig
    from repro_torch.core.tree import flatten_paths
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.state import (TrainState, gather_tree,
                                         make_sharded_train_step, with_specs)
    cfg = dataclasses.replace(get_reduced(arch), **(over or {}))
    api = get_model(cfg, QATConfig(formats=formats or TRAIN_FORMATS_MXINT,
                                   anchor=anchor))
    opt = AdamWConfig(lr=lr)
    tbs = [{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
           for b in batches]

    def nbytes(s):
        return sum(t.numel() * t.element_size() for _, t in flatten_paths(
            (s.params, s.opt["m"], s.opt["v"])))

    out = {}
    for shape, microbatch in cases:
        mesh = make_debug_mesh(*shape)
        params = params_from_numpy(flat, cfg, device="cpu")
        state = TrainState(params, init_opt_state(params, opt), 0)
        step, specs = make_sharded_train_step(api, mesh, opt, tbs[0],
                                              microbatch=microbatch)
        local = step.shard_state(state)
        back = step.gather_state(local)
        same = (back.step, back.opt["step"]) == (
            state.step, state.opt["step"]) and all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                flatten_paths((state.params, state.opt["m"],
                               state.opt["v"])),
                flatten_paths((back.params, back.opt["m"],
                               back.opt["v"]))))
        rec = {"roundtrip": same, "bytes": (nbytes(local), nbytes(state)),
               "losses": [], "grad_norms": []}
        for i, tb in enumerate(tbs):
            lb = step.shard_batch(tb)
            if i == 0:
                _, terms = step.loss(local.params, lb, fmt_idx)
                rec["terms"] = {k: float(v) for k, v in terms.items()}
                if microbatch == 1:
                    _, g = step.loss_and_grads(local.params, lb, fmt_idx)
                    rec["grads"] = _np_tree(gather_tree(g, specs.params,
                                                        mesh))
            local, m = step(local, lb, fmt_idx)
            rec["losses"].append(float(m["loss"]))
            rec["grad_norms"].append(float(m["grad_norm"]))
            if i == 0:
                whole = step.gather_state(local)
                rec["params"] = _np_tree(whole.params)
                rec["m"] = _np_tree(whole.opt["m"])
                rec["step"] = (whole.step, whole.opt["step"])
                if mesh.size(("model",)) > 1:
                    rec["replicated"] = {
                        f"{part}{k}": t.detach().numpy().copy()
                        for part, tree in (("params", local.params),
                                           ("m", local.opt["m"]),
                                           ("v", local.opt["v"]))
                        for k, t, spec in with_specs(tree, specs.params)
                        if not any(e == "model" or isinstance(e, tuple)
                                   and "model" in e for e in spec)}
        out[shape, microbatch] = rec
    return out


def sharded_jobs_worker(rank, jobs):
    """``sharded_step_worker`` of each job (its arguments after the rank)
    in turn: one spawn for several configs."""
    return [sharded_step_worker(rank, *job) for job in jobs]


def sharded_loop_worker(rank, arch, shape, ckpt_dir, steps, seq, batch, lr):
    """``run_training`` with a sharded step on a ``shape`` mesh of this
    group (sequential MXINT schedule over ``steps``), checkpointing into
    ``ckpt_dir`` at the end: the per-step losses."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.formats import TRAIN_FORMATS_MXINT
    from repro_torch.core.qat import QATConfig
    from repro_torch.data.pipeline import DataConfig, LMDataset
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import LoopConfig, run_training
    from repro_torch.train.state import make_sharded_train_step
    cfg = get_reduced(arch)
    api = get_model(cfg, QATConfig(formats=TRAIN_FORMATS_MXINT))
    data = LMDataset(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                global_batch=batch))
    opt = AdamWConfig(lr=lr)
    step, _ = make_sharded_train_step(api, make_debug_mesh(*shape), opt,
                                      data.batch_at(0))
    res = run_training(api, data, opt,
                       LoopConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                                  ckpt_every=steps),
                       step_fn=step, device="cpu")
    return [h["loss"] for h in res["history"]]


def replica_set_worker(rank, arch, path, prompts, max_new, fmt, n_replicas,
                       tp):
    """``ReplicaSet(n_replicas, tp=tp)`` over this group (every process
    builds it and serves every request): the streams, statuses and homes
    of the requests this process returns, and the set's ``stats``."""
    from repro_torch.checkpoint.anchor_ckpt import load_anchor
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import make_model
    from repro_torch.serve.engine import Request
    from repro_torch.serve.replicas import ReplicaSet

    rs = ReplicaSet(make_model(get_reduced(arch)),
                    load_anchor(path, device="cpu"), n_replicas=n_replicas,
                    tp=tp, batch_slots=2, max_len=48, device="cpu")
    reqs = [Request(i, p, max_new) for i, p in enumerate(prompts)]
    got = rs.generate(reqs, fmt_override=fmt)
    st = rs.stats()
    return {"same_objects": all(a is b for a, b in zip(got, reqs)),
            "rids": [r.rid for r in got],
            "streams": [r.out_tokens for r in got],
            "status": [r.status.value for r in got],
            "homes": [rs.home(r.rid) for r in got],
            "replica": rs.replica,
            "stats": {k: st[k] for k in ("n_replicas", "tp", "tokens_out",
                                         "ticks")},
            "per_replica": [(s["tokens_out"], s["ticks"])
                            for s in st["replicas"]]}


def dryrun_cells_worker(rank, cells, variant="baseline"):
    """The dry run's record (``launch/dryrun.py::trace_cell``) of each
    ``(arch, kind, seq, batch)`` at ``variant`` on real CPU tensors (zeros)
    on the (1, 2) mesh of this group: its collectives in order, FLOPs and
    memory."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(1, 2)
    out = []
    for arch, kind, seq, batch in cells:
        rec = trace_cell(get_reduced(arch), ShapeSpec(kind, seq, batch, kind),
                         mesh, variant, device="cpu", fake=False)
        out.append({k: rec[k] for k in ("collective_records", "flops",
                                        "memory")})
    return out
