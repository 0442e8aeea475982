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
what one process needs to take part: its coordinates on the grid and the
process group of each set of axes it collects over (``group_of``: the
``model`` axis for tensor parallelism, ``pod`` x ``data`` for the batch and
the ZeRO-sharded parameters of a training step). ``make_production_mesh``
is the reference's two production grids, (16, 16) and (2, 16, 16), over an
initialised default group of 256 or 512 processes: the dry run
(``launch/dryrun.py``) builds it over a fake world of that size.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Optional, Sequence, Tuple

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
    each axis. ``groups``: {axes: process group} for each set of axes of
    size > 1 (``make_mesh``), keyed in the mesh's axis order."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    group: Any = None
    coords: Optional[Dict[str, int]] = None
    groups: Optional[Dict[Tuple[str, ...], Any]] = None

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for "
                             f"axes {self.axis_names}")

    def coord(self, axis: str) -> int:
        """This process's index on ``axis`` (0 when no coordinates)."""
        return (self.coords or {}).get(axis, 0)

    def size(self, axes: Sequence[str]) -> int:
        """The number of processes along ``axes`` (absent axes count 1)."""
        sizes = dict(zip(self.axis_names, self.devices.shape))
        return int(np.prod([sizes.get(a, 1) for a in axes]))

    def index(self, axes: Sequence[str]) -> int:
        """This process's position along ``axes``, the first major (as a
        ``PartitionSpec`` entry of several axes reads)."""
        sizes = dict(zip(self.axis_names, self.devices.shape))
        k = 0
        for a in axes:
            k = k * sizes.get(a, 1) + self.coord(a)
        return k

    def group_of(self, axes: Sequence[str]):
        """The process group of the processes that share this one's
        coordinates on every axis but ``axes`` (ordered along ``axes`` as
        ``index`` counts), or None when ``axes`` hold one process."""
        sizes = dict(zip(self.axis_names, self.devices.shape))
        key = tuple(a for a in self.axis_names
                    if a in axes and sizes[a] > 1)
        if not key:
            return None
        if key == ("model",) and self.group is not None:
            return self.group
        if not self.groups or key not in self.groups:
            raise ValueError(f"this mesh holds no process group for axes "
                             f"{key}; build it with make_mesh")
        return self.groups[key]


def _world() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _axis_groups(devices: np.ndarray, axis_names: Tuple[str, ...],
                rank: int) -> Dict[Tuple[str, ...], Any]:
    """{axes: group} of every set of axes whose size is > 1: the group of
    the processes that share ``rank``'s coordinates on the other axes, its
    members in row-major order along the set. Every process of the default
    group must call it (``new_group`` is collective), in the same order; a
    group of the whole default group is ``WORLD``."""
    import torch.distributed as dist
    world = dist.get_world_size()
    shape = devices.shape
    dims = [i for i in range(len(shape)) if shape[i] > 1]
    out = {}
    for k in range(1, len(dims) + 1):
        for sub in itertools.combinations(dims, k):
            rest = [i for i in range(len(shape)) if i not in sub]
            n = int(np.prod([shape[i] for i in sub]))
            rows = np.transpose(devices, rest + list(sub)).reshape(-1, n)
            for row in rows:
                ranks = [int(r) for r in row]
                g = dist.group.WORLD if len(ranks) == world \
                    else dist.new_group(ranks)
                if rank in ranks:
                    out[tuple(axis_names[i] for i in sub)] = g
    return out


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh of ``shape`` with ``axis_names`` over the processes of the
    initialised default group, one rank per cell in row-major order, with
    the process group of every set of axes (``_axis_groups``: every rank
    must call it). With no default group, a mesh of this process alone
    (every axis of size 1)."""
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    world, rank = _world()
    need = int(np.prod(shape))
    if world < need:
        raise ValueError(f"Number of devices {world} must be >= the product "
                         f"of mesh_shape {shape}")
    if world != need:
        raise ValueError(f"the default group has {world} processes; a "
                         f"{shape} mesh takes {need}, one per cell")
    devices = np.arange(world).reshape(shape)
    coords = {a: int(c) for a, c in
              zip(axis_names, np.unravel_index(rank, shape))}
    groups = _axis_groups(devices, axis_names, rank) if world > 1 else {}
    return Mesh(devices, axis_names, group=groups.get(("model",)),
                coords=coords, groups=groups)


# The reference's production grids: one pod of 16 x 16 chips, and two.
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The (16, 16) ``("data", "model")`` mesh, or with ``multi_pod`` the
    (2, 16, 16) ``("pod", "data", "model")`` one, over the initialised
    default group (``make_mesh``: every rank calls it). Without a default
    group of that size it raises, as the reference does on too few
    devices."""
    shape, names = PRODUCTION_MESHES[multi_pod]
    return make_mesh(shape, names)


def make_debug_mesh(n_data: int = 1, n_model: int = 1) -> Mesh:
    """A ``(n_data, n_model)`` mesh with axes ``("data", "model")`` over the
    processes of the initialised default group, one rank per cell in
    row-major order (rank = data * n_model + model): ``make_mesh``. Every
    rank must call it (it makes the groups of each model row and data
    column). With no default group, a 1 x 1 mesh of this process alone."""
    return make_mesh((n_data, n_model), ("data", "model"))


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
