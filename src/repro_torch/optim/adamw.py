"""AdamW over nested parameter trees, matching torch.optim.AdamW defaults.

Counterpart of ``repro/optim/adamw.py``, with the same arithmetic in the
same order: global-norm gradient clipping, f32 update math, moments stored
in ``moment_dtype`` (bf16 for very large models). The update is functional
like JAX's: it returns new trees and leaves its inputs as they are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.tree import flatten_paths, tree_map, unflatten_paths


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    moment_dtype: Any = torch.float32     # bf16 for 100B+ models
    grad_clip: Optional[float] = 1.0


def init_opt_state(params, cfg: AdamWConfig):
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    return {"step": 0, "m": tree_map(zeros, params),
            "v": tree_map(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for _, x in flatten_paths(tree)))


def adamw_update(params, grads, state, cfg: AdamWConfig,
                 lr_scale: float = 1.0, gnorm: Optional[torch.Tensor] = None):
    """Returns (new_params, new_state, metrics). ``gnorm``: the global
    gradient norm when ``grads`` is one process's shard of the tree (a
    sharded step computes it over every shard); None takes it from
    ``grads``."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = None
    if cfg.grad_clip is not None:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
    # the bias corrections in f32, as JAX computes them from the int step
    b1c = float(np.float32(1.0) - np.float32(cfg.b1) ** np.float32(step))
    b2c = float(np.float32(1.0) - np.float32(cfg.b2) ** np.float32(step))
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        if scale is not None:
            g = g * scale
        m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g * g
        mhat = m32 / b1c
        vhat = v32 / b2c
        p32 = p.to(torch.float32)
        p_new = p32 - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                            + cfg.weight_decay * p32)
        return (p_new.to(p.dtype), m32.to(cfg.moment_dtype),
                v32.to(cfg.moment_dtype))

    with torch.no_grad():
        flat = {path: upd(p, g, m, v) for (path, p), (_, g), (_, m), (_, v)
                in zip(flatten_paths(params), flatten_paths(grads),
                       flatten_paths(state["m"]), flatten_paths(state["v"]))}
    new = [unflatten_paths({k: t[i] for k, t in flat.items()})
           for i in range(3)]
    return new[0], {"step": step, "m": new[1], "v": new[2]}, \
        {"grad_norm": gnorm}


def cosine_schedule(base_steps: int, warmup: int = 0, floor: float = 0.1):
    """lr multiplier at an int step: linear warm-up, then cosine to
    ``floor``."""
    def sched(step: int) -> float:
        s = float(step)
        warm = min(1.0, s / max(warmup, 1))
        prog = min(max((s - warmup) / max(base_steps - warmup, 1), 0.0), 1.0)
        return warm * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi
                                                                  * prog)))
    return sched
