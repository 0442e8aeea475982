"""Logical-axis sharding rules mapped onto a mesh description.

Counterpart of ``repro/sharding/rules.py``. Parameters carry *logical* axis
names (``models/transformer.py::param_axes``); a rule table maps each name
to an ordered tuple of candidate mesh axes, resolved against a mesh as the
reference resolves them:

  - mesh axes that do not exist are dropped,
  - a candidate is taken only while the product of the taken sizes divides
    the dim (the largest divisible prefix wins; none = replicated),
  - each mesh axis is used at most once per spec.

A spec is a plain tuple with one entry per dim: ``None`` (replicated), a
mesh axis name, or a tuple of names (sharded over their product, the first
major), as a ``PartitionSpec`` reads. A mesh is anything with
``axis_names`` and a ``devices`` array whose shape gives the axis sizes: the
port's ``launch/mesh.py::Mesh``, or a JAX mesh.

``shard_act`` has no counterpart: the reference hands activations to GSPMD
with sharding constraints, and the port's tensor-parallel path is explicit
collectives instead (``models/common.py::TensorParallel``), so nothing
reads an activation's logical axes. The one constraint that changes what
a process holds, ``seq_sp`` on the residual stream between layer groups
(``ModelConfig.seq_sharding``), is the explicit cut and gather of
``models/transformer.py::forward_hidden`` over the ``model`` group.
``param_shardings`` becomes
``param_specs``: specs over the port's nested trees, which
``serve/packed_params.py::local_shard`` slices to a process's shard.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.tree import tree_map

# name -> ordered candidate mesh axes (subsets applied left to right)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),       # ZeRO-style param/optimizer sharding
    "model": ("model",),           # tensor parallel
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),             # d_ff
    "seq": (),                     # residual-stream seq: replicated
    "seq_sp": ("model",),          # sequence-parallel residual
    "kv_seq": ("model",),          # decode KV-cache sequence dim
    "experts": ("model",),         # expert parallelism (jamba)
    "experts_tp": (),              # placeholder for TP-expert policies
    "none": (),
}

Spec = Tuple[Optional[object], ...]


@dataclasses.dataclass
class LogicalRules:
    table: Dict[str, Tuple[str, ...]]

    def lookup(self, name: Optional[str]) -> Tuple[str, ...]:
        if name is None:
            return ()
        return self.table.get(name, ())


_STATE = threading.local()


def set_rules(mesh, rules: Optional[LogicalRules] = None) -> None:
    _STATE.mesh = mesh
    _STATE.rules = rules or LogicalRules(dict(DEFAULT_RULES))


def clear_rules() -> None:
    _STATE.mesh = None
    _STATE.rules = None


def active_mesh():
    return getattr(_STATE, "mesh", None)


def _active_rules() -> Optional[LogicalRules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def use_rules(mesh, rules: Optional[LogicalRules] = None):
    prev_mesh, prev_rules = active_mesh(), _active_rules()
    set_rules(mesh, rules)
    try:
        yield
    finally:
        _STATE.mesh = prev_mesh
        _STATE.rules = prev_rules


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh description (or a JAX mesh)."""
    return {a: int(n) for a, n in zip(mesh.axis_names, mesh.devices.shape)}


def spec_for_axes(shape: Sequence[int],
                  logical_axes: Sequence[Optional[str]], mesh,
                  rules: Optional[LogicalRules] = None) -> Spec:
    """Resolve logical names to a spec valid for ``shape`` on ``mesh``."""
    rules = rules or _active_rules() or LogicalRules(dict(DEFAULT_RULES))
    sizes = mesh_sizes(mesh)
    used = set()
    entries = []
    for dim, name in zip(shape, logical_axes):
        cands = [a for a in rules.lookup(name)
                 if a in sizes and a not in used]
        chosen = []
        prod = 1
        for a in cands:
            if dim % (prod * sizes[a]) == 0:
                chosen.append(a)
                prod *= sizes[a]
        used.update(chosen)
        if not chosen:
            entries.append(None)
        elif len(chosen) == 1:
            entries.append(chosen[0])
        else:
            entries.append(tuple(chosen))
    return tuple(entries)


def param_specs(param_axes, params, mesh,
                rules: Optional[LogicalRules] = None):
    """A tree of logical-axis tuples and a same-shaped tree of tensors ->
    the same tree of specs."""
    def one(t, axes):
        return spec_for_axes(tuple(t.shape), axes, mesh, rules)

    return tree_map(one, params, param_axes)
