"""Carry parameters and training state across from the JAX package as numpy
arrays.

``params_from_numpy`` takes ``{keystr path: np.ndarray}`` — what
``jax.tree_util.tree_flatten_with_path`` + ``keystr`` + ``np.asarray`` give
for a JAX param tree — and returns the port's nested tree on ``device``,
after checking that every path and shape is the one ``cfg`` expects (MoE
layers: ``['blocks'][j]['moe']['router']`` and
``['blocks'][j]['moe']['experts'][...]``; a hybrid stack's in-group
positions hold ``['attn']`` or ``['mamba'][...]`` by ``mixer_kind``, an
RWKV layer ``['rwkv'][...]`` and ``['cmix'][...]``; the encoder-decoder
family ``['encoder']`` and ``['decoder']`` trees). With
the same weights, both packages compute the same function.
``train_state_from_numpy`` does the same for a JAX ``TrainState`` (params,
AdamW moments and steps), as a JAX training checkpoint stores it. bf16
arrays may come as ml_dtypes' bfloat16 or as the 2-byte raw records numpy
reads back from a checkpoint.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.tree import unflatten_paths
from repro_torch.devices import resolve_device
from repro_torch.models import param_shapes
from repro_torch.models.common import ModelConfig
from repro_torch.train.state import TrainState


def _spec_paths(node, prefix=""):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _spec_paths(node[k], f"{prefix}['{k}']")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _spec_paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tuple(node[0])


def params_from_numpy(flat: Dict[str, np.ndarray], cfg: ModelConfig, *,
                      device="cuda"):
    dev = resolve_device(device)
    want = dict(_spec_paths(param_shapes(cfg)))
    if set(flat) != set(want):
        raise ValueError(
            f"parameter paths differ from {cfg.name}'s: missing "
            f"{sorted(set(want) - set(flat))}, unexpected "
            f"{sorted(set(flat) - set(want))}")
    bad = {k: (tuple(np.shape(v)), want[k]) for k, v in flat.items()
           if tuple(np.shape(v)) != want[k]}
    if bad:
        raise ValueError(f"shape mismatch (got, want): {bad}")
    return unflatten_paths({k: _tensor(v).to(dev) for k, v in flat.items()})


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def train_state_from_numpy(flat: Dict[str, np.ndarray], cfg: ModelConfig, *,
                           device="cuda") -> TrainState:
    """A JAX ``TrainState`` keyed by ``keystr`` (``.params[...]``,
    ``.opt['m'][...]``, ``.opt['v'][...]``, ``.opt['step']``, ``.step``) ->
    the port's ``TrainState`` on ``device``."""
    groups = {".params": {}, ".opt['m']": {}, ".opt['v']": {}}
    scalars = {}
    for k, a in flat.items():
        prefix = next((p for p in groups if k.startswith(p + "[")), None)
        if prefix is None:
            scalars[k] = a
        else:
            groups[prefix][k[len(prefix):]] = a
    want = {".opt['step']", ".step"}
    if set(scalars) != want:
        raise ValueError(f"not a training state: keys {sorted(scalars)}, "
                         f"want {sorted(want)} beside the trees")
    trees = {k: params_from_numpy(v, cfg, device=device)
             for k, v in groups.items()}
    return TrainState(
        params=trees[".params"],
        opt={"step": int(scalars[".opt['step']"]), "m": trees[".opt['m']"],
             "v": trees[".opt['v']"]},
        step=int(scalars[".step"]))
