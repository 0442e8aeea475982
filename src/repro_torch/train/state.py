"""The training state and the train step (forward, backward, AdamW).

Counterpart of ``repro/train/state.py`` on one device: ``TrainState`` holds
the parameter tree, the AdamW state and the step; ``build_train_step``
returns ``(state, batch, fmt_idx) -> (state, metrics)``, with gradients
from autograd through the model's straight-through fake-quant and optional
accumulation over microbatches. The mesh and sharding builders wait for
tensor parallelism.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.tree import flatten_paths, tree_map, unflatten_paths
from repro_torch.models.transformer import ModelApi
from repro_torch.optim.adamw import AdamWConfig, adamw_update


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any          # {"step": int, "m": tree, "v": tree}
    step: int


def state_arrays(state: TrainState) -> Dict[str, Any]:
    """The state keyed as JAX's ``keystr`` names a ``TrainState``'s leaves
    (``.params[...]``, ``.opt['m'][...]``, ``.opt['step']``, ``.step``)."""
    out = {".params" + p: t for p, t in flatten_paths(state.params)}
    for name in ("m", "v"):
        out.update({f".opt['{name}']" + p: t
                    for p, t in flatten_paths(state.opt[name])})
    out[".opt['step']"] = np.int32(state.opt["step"])
    out[".step"] = np.int32(state.step)
    return out


def build_train_step(api: ModelApi, opt_cfg: AdamWConfig,
                     lr_schedule: Optional[Callable] = None,
                     microbatch: int = 1):
    """(state, batch, fmt_idx) -> (state, metrics). Accumulates gradients
    over ``microbatch`` row slices of the batch when > 1."""

    def loss_and_grads(params, batch, fmt_idx):
        flat = flatten_paths(params)
        leaves = [p.detach().requires_grad_(True) for _, p in flat]
        tree = unflatten_paths({k: p for (k, _), p in zip(flat, leaves)})
        loss, _ = api.train_loss(tree, batch, fmt_idx)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), unflatten_paths(
            {k: g for (k, _), g in zip(flat, grads)})

    def train_step(state: TrainState, batch, fmt_idx: int):
        if microbatch <= 1:
            loss, grads = loss_and_grads(state.params, batch, fmt_idx)
        else:
            rows = next(iter(batch.values())).shape[0] // microbatch
            grads, loss = None, 0.0
            for i in range(microbatch):
                part = {k: v[i * rows:(i + 1) * rows]
                        for k, v in batch.items()}
                l, g = loss_and_grads(state.params, part, fmt_idx)
                g = tree_map(lambda t: t.to(torch.float32), g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / microbatch, grads)
            loss = loss / microbatch
        lr_scale = lr_schedule(state.step) if lr_schedule else 1.0
        params, opt, om = adamw_update(state.params, grads, state.opt,
                                       opt_cfg, lr_scale)
        return TrainState(params, opt, state.step + 1), {"loss": loss, **om}

    return train_step
