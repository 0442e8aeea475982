"""Carry parameters across from the JAX package as numpy arrays.

``params_from_numpy`` takes ``{keystr path: np.ndarray}`` — what
``jax.tree_util.tree_flatten_with_path`` + ``keystr`` + ``np.asarray`` give
for a JAX param tree — and returns the port's nested tree on ``device``,
after checking that every path and shape is the one ``cfg`` expects. With
the same weights, both packages compute the same function.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.tree import unflatten_paths
from repro_torch.devices import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import param_shapes


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
    return unflatten_paths({k: torch.from_numpy(np.array(v)).to(dev)
                            for k, v in flat.items()})
