"""The training loop: MF-QAT schedules, fault tolerance, checkpointing.

Counterpart of ``repro/train/loop.py``:
  - multi-format QAT: the sequential increasing-bit schedule (2→4→6→8), one
    epoch per format (or interleaved within one epoch for large models),
  - single-format QAT / full-precision baselines (the same loop, other
    schedule arrays),
  - anchor-storage training (§3.5) via ``QATConfig.anchor``,
with auto-resume from LATEST (a checkpoint written by either package),
preemption-safe checkpointing, a watchdog, a straggler monitor and the
deterministic step -> batch mapping (a restart sees the same batches).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core.qat import (fp_schedule, interleaved_schedule,
                                  sequential_schedule, single_format_schedule)
from repro_torch.data.pipeline import LMDataset
from repro_torch.devices import resolve_device
from repro_torch.interop import train_state_from_numpy
from repro_torch.models.transformer import ModelApi
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.runtime.fault import (PreemptionGuard, StragglerMonitor,
                                       Watchdog)
from repro_torch.train.state import (ShardedTrainStep, TrainState,
                                     build_train_step, state_arrays)


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    schedule: str = "multiformat"   # multiformat | interleaved | fp |
    #                                 single:<pos>
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_n: int = 3
    watchdog_timeout_s: float = 600.0


def make_schedule(kind: str, n_formats: int, total_steps: int) -> np.ndarray:
    if kind == "multiformat":
        per = max(1, total_steps // max(n_formats, 1))
        sched = sequential_schedule(n_formats, per)
        if len(sched) < total_steps:
            sched = np.concatenate([
                sched, np.full(total_steps - len(sched), n_formats - 1,
                               np.int32)])
        return sched[:total_steps]
    if kind == "interleaved":
        return interleaved_schedule(n_formats, total_steps)
    if kind == "fp":
        return fp_schedule(total_steps, n_formats)
    if kind.startswith("single:"):
        return single_format_schedule(int(kind.split(":")[1]), total_steps)
    raise ValueError(kind)


def run_training(api: ModelApi, data: LMDataset, opt_cfg: AdamWConfig,
                 loop: LoopConfig, *, step_fn=None, seed: int = 0,
                 on_step: Optional[Callable] = None,
                 device="cuda") -> Dict:
    """Resume from the latest checkpoint in ``loop.ckpt_dir`` (written by
    either package), or train from ``api.init_params(seed)``.

    ``step_fn`` may be a sharded step (``train/state.py::
    make_sharded_train_step``), run in every process of its mesh: each
    builds or restores the whole state and keeps its shard, steps on its
    rows of each batch, and a checkpoint gathers the whole state, which the
    process at the mesh's origin writes (the single device's format, so
    either a mesh or one device resumes it). The result's ``state`` is then
    this process's shard."""
    dev = resolve_device(device)
    n_formats = len(api.qat.formats) if api.qat else 0
    schedule = make_schedule(loop.schedule, n_formats, loop.total_steps)
    if step_fn is None:
        step_fn = build_train_step(api, opt_cfg)
    sharded = isinstance(step_fn, ShardedTrainStep)

    start_step = 0
    if loop.ckpt_dir and ckpt_io.latest_step(loop.ckpt_dir) is not None:
        arrays, manifest = ckpt_io.restore(loop.ckpt_dir)
        state = train_state_from_numpy(arrays, api.cfg, device=dev)
        start_step = int(manifest["step"])
    else:
        params = api.init_params(seed, device=dev)
        state = TrainState(params=params,
                           opt=init_opt_state(params, opt_cfg), step=0)
        del params         # the state owns the tree; each step replaces it
    if sharded:
        state = step_fn.shard_state(state)

    monitor = StragglerMonitor()
    history: List[Dict] = []
    watchdog = Watchdog(loop.watchdog_timeout_s).start()

    preempted = False
    with PreemptionGuard() as guard:
        for step in range(start_step, loop.total_steps):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch_at(step).items()}
            if sharded:
                batch = step_fn.shard_batch(batch)
            state, metrics = step_fn(state, batch, int(schedule[step]))
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            watchdog.heartbeat()
            monitor.record(step, dt)
            metrics.update(step=step, sec=dt, fmt_idx=int(schedule[step]))
            history.append(metrics)
            if on_step:
                on_step(step, metrics)

            # a signal may reach one process of a mesh: all stop together
            preempted = step_fn.any(guard.preempted) if sharded \
                else guard.preempted
            should_ckpt = loop.ckpt_dir and (
                (step + 1) % loop.ckpt_every == 0 or preempted
                or step + 1 == loop.total_steps)
            if should_ckpt:
                whole = step_fn.gather_state(state) if sharded else state
                if not sharded or step_fn.is_writer:
                    ckpt_io.save(loop.ckpt_dir, step + 1,
                                 state_arrays(whole),
                                 extra_meta={"schedule": loop.schedule},
                                 keep_n=loop.keep_n)
                del whole
            if preempted:
                break
    watchdog.stop()
    return {"state": state, "history": history,
            "stragglers": monitor.events,
            "preempted": guard.preempted or preempted,
            "last_step": history[-1]["step"] + 1 if history else start_step}
