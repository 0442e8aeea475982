"""Hardware constants of the card the port serves on, and mesh descriptions.

Counterpart of ``repro/launch/mesh.py``, for the NVIDIA H100 SXM 80 GB
(HBM3) instead of a TPU: the serving cost model (``serve/slo.py::CostModel``)
divides bytes by ``HBM_BW``, and ``launch/costmodel.py::roofline`` divides
flops by ``PEAK_FLOPS_BF16``, bytes by ``HBM_BW`` and collective bytes by
``LINK_BW``.

A JAX mesh is an array of devices with named axes, and one program drives
all of them. The port runs one process per shard (``torch.distributed``), so
its ``Mesh`` describes the same grid — ``axis_names`` and ``devices`` (the
global ranks, shaped like the reference's device array, so
``sharding/rules.py::spec_for_axes`` reads it as it reads a JAX mesh) — plus
what one process needs to take part: the process group of its ``model``
axis and its coordinates on the grid. ``make_production_mesh`` waits for
the dry-run tooling (ROADMAP A.10.2), its only caller.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

# NVIDIA H100 SXM 80 GB HBM3: peak memory bandwidth, bytes/s per card.
HBM_BW = 3.35e12
# NVIDIA H100 SXM 80 GB: dense bf16 tensor-core peak, flop/s per card.
PEAK_FLOPS_BF16 = 989e12
# NVIDIA H100 SXM: NVLink 4, 900 GB/s per card in both directions together,
# 450 GB/s per direction (the public spec; the reference's ICI_BW is its
# per-link rate). A published figure, not a measurement.
LINK_BW = 450e9


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of processes with named axes, seen from one of them.

    ``devices``: the global ranks, shape (size of each axis).
    ``group``: the ``torch.distributed`` process group of this process's
    ``model`` axis (None: no collectives, e.g. a description built for
    resolving specs, or a mesh of one). ``coords``: this process's index on
    each axis."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    group: Any = None
    coords: Optional[Dict[str, int]] = None

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for "
                             f"axes {self.axis_names}")

    def coord(self, axis: str) -> int:
        """This process's index on ``axis`` (0 when no coordinates)."""
        return (self.coords or {}).get(axis, 0)


def make_debug_mesh(n_data: int = 1, n_model: int = 1) -> Mesh:
    """A ``(n_data, n_model)`` mesh with axes ``("data", "model")`` over the
    processes of the initialised default group, one rank per cell in
    row-major order (rank = data * n_model + model). Every rank must call it
    (it makes one group per model row). With no default group, a 1 x 1 mesh
    of this process alone."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if world < n_data * n_model:
        raise ValueError(f"Number of devices {world} must be >= the product "
                         f"of mesh_shape {(n_data, n_model)}")
    if world != n_data * n_model:
        raise ValueError(f"the default group has {world} processes; a "
                         f"{(n_data, n_model)} mesh takes "
                         f"{n_data * n_model}, one per cell")
    group = None
    if world > 1:
        if n_data == 1:
            group = dist.group.WORLD
        else:
            for d in range(n_data):         # every rank makes every group
                g = dist.new_group(list(range(d * n_model,
                                              (d + 1) * n_model)))
                if d == rank // n_model:
                    group = g
    return Mesh(np.arange(world).reshape(n_data, n_model), ("data", "model"),
                group=group,
                coords={"data": rank // n_model, "model": rank % n_model})


def parse_mesh(spec: str):
    """``"DxM"`` -> ``(n_data, n_model)``: the CLI mesh-shape syntax
    (``--mesh 1x2``)."""
    parts = spec.lower().split("x")
    if len(parts) != 2:
        raise ValueError(f"mesh spec {spec!r} is not of the form 'DxM'")
    try:
        n_data, n_model = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(f"mesh spec {spec!r} is not of the form 'DxM'")
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh spec {spec!r} must have positive axes")
    return n_data, n_model
