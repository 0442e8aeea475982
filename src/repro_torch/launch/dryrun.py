"""The dry run: trace one rank's step of every (arch x shape x mesh) cell
with no card and no data, and record what it would cost.

Counterpart of ``repro/launch/dryrun.py``, which compiles the sharded step
with ``jax.jit(...).lower(...).compile()`` on 512 placeholder CPU devices.
The port runs one process per shard, so the dry run traces **the step of
rank 0**: ``make_production_mesh`` over a fake process group of 256 or 512
ranks (``fake_world``: the ``fake`` backend of ``torch.distributed``,
opened only when no default group exists and destroyed on exit, so nothing
leaks into the caller's process), the rank's shard of the state on
tensors that hold no data, and the port's own entry points:
``make_sharded_train_step`` for a train cell, ``prefill`` /
``serve_step`` of the tensor-parallel ``ModelApi`` for a serving cell.
Where a card is present the tensors are fake ``cuda`` ones
(``FakeTensorMode``: shapes, dtypes and aliasing, no storage); on a host
without one they are ``meta`` tensors, which stand for the card (a CPU
build of torch has no CUDA device guard or stream, so autograd cannot run
over fake ``cuda`` tensors there; meta ones also trace 3x faster, their
kernels running in C++ rather than through a Python mode). Either way
every kernel wrapper takes its card branch and launches shape-only
(``kernels/common.py``): no kernel is built or called and no launch
counter counts; the launch is recorded with its operations and bytes.
A record's ``launches`` adds those records to what the counters counted,
so a trace and a real step on the card give comparable counts.
``device="cpu"`` traces the plain versions on fake CPU tensors, as a CPU
step runs them; ``fake=False`` runs the same cell on real tensors (zeros)
under the same counters, which is how the tests and ``chip_smoke.py``
hold a trace to a real step.

The record is the reference's schema (``lower_cell``), per rank:

- ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s total (the
  matmuls, convolutions and attention products autograd and the forward
  issue) **plus** the operations of each shape-only kernel launch, which
  the counter cannot see; ``flops_counted`` and ``kernels`` (per kernel:
  launches, operations, bytes) keep the parts;
- ``bytes_accessed``: what eager PyTorch moves, op by op, with no fusion
  (each op's tensor inputs read and outputs written; views, factories and
  collectives move nothing), plus the kernels' bytes. It is not XLA's
  fused count, which is much smaller;
- ``collectives``: ``collective_bytes`` of the collectives the step really
  issued (``record_collectives`` wraps ``dist.all_reduce``,
  ``all_gather``, ``reduce_scatter_tensor`` and ``all_to_all`` for the
  cell), the per-rank result bytes of each kind
  and the ring-weighted total, as ``parse_collective_bytes`` reads them
  off optimized HLO;
- ``memory``: ``argument_size_in_bytes``, this rank's state shard (params,
  AdamW moments) or weights and cache, plus its batch shard (the step and
  the format index are host ints: no bytes); ``output_size_in_bytes``,
  the distinct storages the step returns; ``alias_size_in_bytes``, those
  of them that are an argument's (a cache written in place);
  ``temp_size_in_bytes``, the peak of the live bytes of the storages the
  step allocated (``MemoryTracker``: each storage counted once while it
  lives, outputs included while they live), so argument + temp is the
  step's peak on the card; ``generated_code_size_in_bytes`` is 0: eager
  PyTorch generates no code (the kernels are one library, built once);
- ``compile_s``: the trace's seconds (state, step and all);
  ``n_devices``: the mesh's ranks.

Shapes (``batch_specs``) are the reference's: tokens and labels int32 (the
port's embedding and loss take int32 ids as the reference's do), image
and frame embeddings f32; a decode cell's cache holds
``decode_cache_len + 1`` positions rounded up to 128, as the reference's
(which rounds so GSPMD can shard ``kv_seq``); the port places caches by kv
head, as its tensor-parallel engine does, never over ``kv_seq`` (ROADMAP
C.14). A config whose dims the ``model`` axis does not cut into whole
heads and MX blocks is ``"refused"`` with the guard's message
(``train/state.py::_check_model_axis``): GSPMD splits inside a head, the
port's explicit tensor parallelism does not.

Variants (the reference's, mapped to the port's mechanisms):

- ``baseline``: the defaults (flash_vjp, remat); ``novjp``:
  ``flash_vjp=False``; ``sp`` / ``sp_mb4``: ``seq_sharding=True`` (the
  residual stream between layer groups sequence-parallel over ``model``,
  so each group's saved input is 1 / 16 of the sequence) with 1 / 4
  microbatches; ``inner`` / ``inner_mb4`` / ``inner_mb8``:
  ``remat_inner=True`` with 1 / 4 / 8 microbatches;
- ``w16tp`` / ``w8tp`` / ``w4tp``: weights stationary (the rules' ``fsdp``
  emptied, so no gather over the data axes), bf16 / packed MXINT8 / packed
  MXINT4 weights; ``w8`` / ``w4``: packed weights in the FSDP layout,
  gathered over the data axes inside the step. A packed tree is built from
  a fake anchor of the whole tree (B6), Slice-and-Scaled to MXINT4 (B5,
  split-N packed), repacked per ``model`` shard and cut, as the engine
  builds it, and B1 / B2 run in the step; the port packs prefill cells
  too, where the reference packs only decode cells;
- ``w8scan`` / ``w4scan``: the same step as ``w8tp`` / ``w4tp`` (the port
  always dequantizes per layer at the point of use; the record says so).

``_compat.compiled_cost`` has no counterpart: it flattens JAX's
list-of-dicts ``cost_analysis()``, and torch has nothing of the kind; the
record's flat ``flops`` / ``bytes_accessed`` are its role.

``main`` takes the reference's flags (``--variant`` also a comma-separated
list, traced in turn) and writes
``{arch}__{shape}__{mesh}__{variant}.json`` under ``--out`` cell by cell,
skipping a file that exists (``--force`` redoes it), so a sweep resumes. A
failing cell is recorded (``"error"`` with the trace), not raised; so is
a trace that outlasts ``TRACE_LIMIT_S``::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import threading
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import (SHAPES, ShapeSpec, applicable,
                                        decode_cache_len)
from repro_torch.core.anchor import make_anchor
from repro_torch.core.formats import TRAIN_FORMATS_MXINT, get_format
from repro_torch.core.mx import MXTensor
from repro_torch.core.qat import QATConfig
from repro_torch.core.tree import tree_map, unflatten_paths
from repro_torch.kernels import common as kernel_common
from repro_torch.kernels import (fake_quant, mx_matmul, mx_quantize,
                                 paged_attention, ss_convert)
from repro_torch.kernels.dispatch import make_qmm
from repro_torch.launch.mesh import (PRODUCTION_MESHES, Mesh,
                                     make_production_mesh)
from repro_torch.models import get_model, param_axes, shard_dims
from repro_torch.models.common import ModelConfig, TensorParallel
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.serve.packed_params import (PackedInt4Leaf, local_shard,
                                             make_packed_params,
                                             packed_param_specs,
                                             repack_splitn_for_tp)
from repro_torch.sharding.rules import DEFAULT_RULES, LogicalRules, use_rules
from repro_torch.train.state import (DATA_AXES, TrainState, _axes,
                                     _check_model_axis, _data_spec,
                                     abstract_params, batch_shardings,
                                     gather_tree, make_sharded_train_step,
                                     state_shardings, with_specs)

VARIANTS = ("baseline", "novjp", "sp", "sp_mb4", "inner", "inner_mb4",
            "inner_mb8", "w16tp", "w8tp", "w4tp", "w8", "w4", "w8scan",
            "w4scan")
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
# per-chip traffic of a ring on N shards, as the reference weighs them
RING_FACTORS = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}
MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "generated_code_size_in_bytes",
               "alias_size_in_bytes")
_LAUNCH_MODULES = (mx_matmul, paged_attention, mx_quantize, ss_convert,
                   fake_quant)
# ``main`` stops a cell's trace after this many seconds and records the
# cell as an error (a guard: every cell of the sweep traces within it on a
# CPU host).
TRACE_LIMIT_S = 900
# (deadline on time.monotonic(), its seconds) of the trace under
# ``_time_limit``, which every op dispatched under a ``MemoryTracker``
# checks; None outside it.
_DEADLINE: List[Optional[Tuple[float, float]]] = [None]


# =============================================================================
# The fake world, the inputs, the collectives
# =============================================================================
@contextlib.contextmanager
def fake_world(n: int) -> Iterator[None]:
    """A default process group of ``n`` fake ranks (this process is rank 0)
    for the block, when none exists; destroyed on exit, so the caller's
    process is left as it was. An existing default group is left alone."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), world_size=n, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def trace_device(device) -> torch.device:
    """The device a trace's tensors lie on for ``device``: ``meta`` stands
    for a card that this host does not have."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        return torch.device("meta")
    return dev


def batch_specs(cfg: ModelConfig, shape: ShapeSpec,
                kind: str) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (global shape, dtype)} of the step's batch: the reference's
    shapes and dtypes (int32 ids, f32 image / frame embeddings)."""
    b, s = shape.global_batch, shape.seq_len
    if kind == "train":
        batch = {"tokens": ((b, s), torch.int32),
                 "labels": ((b, s), torch.int32)}
    elif kind == "prefill":
        batch = {"tokens": ((b, s), torch.int32)}
    else:
        batch = {"tokens": ((b, 1), torch.int32)}
    if cfg.family == "vlm" and kind != "decode":
        batch["vision_embeds"] = ((b, cfg.vision_tokens, cfg.d_model),
                                  torch.float32)
    if cfg.family == "encdec" and kind != "decode":
        batch["frame_embeds"] = (
            (b, max(1, s // max(cfg.audio_downsample, 1)), cfg.d_model),
            torch.float32)
    return batch


def decode_alloc(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """A decode cell's cache positions: ``decode_cache_len + 1`` rounded up
    to 128, the reference's rule."""
    return -(-(decode_cache_len(cfg, shape) + 1) // 128) * 128


def _result_bytes(name: str, args, kwargs) -> int:
    def arg(i, key):
        return kwargs[key] if key in kwargs else args[i]
    if name == "all_reduce":
        return kernel_common.nbytes(arg(0, "tensor"))
    if name in ("all_gather", "all_to_all"):
        key = "tensor_list" if name == "all_gather" else "output_tensor_list"
        return sum(kernel_common.nbytes(t) for t in arg(0, key))
    return kernel_common.nbytes(arg(0, "output"))   # reduce_scatter_tensor


_COLLECTIVES = {"all_reduce": "all-reduce", "all_gather": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all": "all-to-all"}


@contextlib.contextmanager
def record_collectives() -> Iterator[List[Dict]]:
    """The collectives issued through ``torch.distributed`` inside the
    block, in order: {"kind", "bytes" (this rank's result), "ranks"}. The
    functions are wrapped for the block and put back after it."""
    import torch.distributed as dist
    out: List[Dict] = []
    saved = {name: getattr(dist, name) for name in _COLLECTIVES}

    def wrap(name, fn):
        def call(*args, **kwargs):
            group = kwargs.get("group")
            out.append({"kind": _COLLECTIVES[name],
                        "bytes": _result_bytes(name, args, kwargs),
                        "ranks": dist.get_world_size(group)})
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield out
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def collective_bytes(records) -> Dict[str, float]:
    """Per-rank result bytes of each collective kind and their ring-weighted
    sum (all-reduce x 2, the others x 1): ``parse_collective_bytes``'s dict
    from recorded collectives."""
    out = {k: 0.0 for k in COLLECTIVE_KINDS}
    for r in records:
        out[r["kind"]] += r["bytes"]
    out["total_weighted"] = sum(out[k] * RING_FACTORS[k]
                                for k in COLLECTIVE_KINDS)
    return out


# =============================================================================
# What a step costs
# =============================================================================
def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _no_traffic(func) -> bool:
    """Ops that move no bytes: views, allocations, collectives (counted
    apart), metadata (``prim.device``, which fake tensors dispatch)."""
    name = func.__name__
    return (func.is_view or func.namespace in ("c10d", "prim")
            or name.startswith(("empty", "detach", "lift_fresh", "alias",
                                "_local_scalar_dense", "set_")))


class MemoryTracker(TorchDispatchMode):
    """Under it: the live bytes of every storage an op returned that did
    not exist before (``arguments`` are the tensors that did), each storage
    counted once while it lives (its ``weakref.finalize`` takes it off),
    their peak (``peak_bytes``) and, at the peak (to 0.1 %), the live
    bytes by the op that made them (``peak_by_op``), and the bytes eager
    PyTorch moves op by op (``bytes_accessed``: each op's tensor inputs and
    outputs, views, allocations and collectives aside). Works alike over
    fake and real tensors."""

    def __init__(self, arguments=()):
        super().__init__()
        self._old = {_storage_key(t) for t in arguments}
        self._live: Dict[int, Tuple[int, str]] = {}
        self._by_op: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_by_op: Dict[str, int] = {}
        self.bytes_accessed = 0

    def _free(self, key: int) -> None:
        with self._lock:
            n, op = self._live.pop(key, (0, ""))
            self.live_bytes -= n
            if op:
                self._by_op[op] -= n

    def _see(self, t: torch.Tensor, op: str) -> None:
        st = t.untyped_storage()
        key = st._cdata
        with self._lock:
            if key in self._old or key in self._live:
                return
            n = st.nbytes()
            self._live[key] = (n, op)
            self._by_op[op] = self._by_op.get(op, 0) + n
            self.live_bytes += n
            if self.live_bytes > self.peak_bytes:
                if self.live_bytes > 1.001 * sum(self.peak_by_op.values()):
                    self.peak_by_op = {k: v for k, v in self._by_op.items()
                                       if v}
                self.peak_bytes = self.live_bytes
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        limit = _DEADLINE[0]
        if limit is not None and time.monotonic() > limit[0]:
            raise TimeoutError(f"the trace took over {limit[1]} s")
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not _no_traffic(func):
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes_accessed += sum(kernel_common.nbytes(t)
                                       for t in ins + outs)
        for t in outs:
            self._see(t, func.__name__)
        return out


def _storages(tree) -> Dict[int, int]:
    """{storage key: bytes} of the tensors of a tree (containers' too)."""
    out = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def _tensors(tree) -> List[torch.Tensor]:
    out = []
    for leaf in tree_leaves(tree, is_leaf=lambda x: isinstance(
            x, (MXTensor, PackedInt4Leaf, TrainState))):
        if isinstance(leaf, MXTensor):
            out += [leaf.codes, leaf.scale_exp]
        elif isinstance(leaf, PackedInt4Leaf):
            out += [leaf.packed, leaf.scale_exp]
        elif isinstance(leaf, TrainState):
            out += _tensors((leaf.params, leaf.opt))
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def _launch_counts() -> Dict[str, int]:
    out = {}
    for mod in _LAUNCH_MODULES:
        out.update(mod.launches)
    return out


def _launches(before: Dict[str, int], records) -> Dict[str, int]:
    """Launches per kernel since ``before``: the kernels that ran (the
    counters) and the shape-only ones (``records``), which count nowhere
    else."""
    now = _launch_counts()
    out = {k: now[k] - before[k] for k in now if now[k] != before[k]}
    for r in records:
        out[r["name"]] = out.get(r["name"], 0) + 1
    return out


def _kernel_summary(records) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    for r in records:
        k = out.setdefault(r["name"], {"launches": 0, "flops": 0.0,
                                       "bytes_read": 0, "bytes_written": 0})
        k["launches"] += 1
        k["flops"] += r["flops"]
        k["bytes_read"] += r["bytes_read"]
        k["bytes_written"] += r["bytes_written"]
    return out


def measure(fn: Callable, args: Tuple) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under the counters: the FLOP counter, the
    memory tracker, the collective recorder, the shape-only launch records
    and the kernels' launch counters. Returns the record's cost fields."""
    from torch.utils.flop_counter import FlopCounterMode
    arg_tensors = _tensors(args)
    before = _launch_counts()
    with kernel_common.shape_only_launches() as kernels, \
            record_collectives() as colls, \
            FlopCounterMode(display=False) as flop_counter, \
            MemoryTracker(arg_tensors) as mem:
        out = fn(*args)
    arg_st = _storages(args)
    out_st = _storages(out)
    kernel = _kernel_summary(kernels)
    counted = float(flop_counter.get_total_flops())
    return {
        "flops": counted + sum(k["flops"] for k in kernel.values()),
        "flops_counted": counted,
        "bytes_accessed": float(mem.bytes_accessed + sum(
            k["bytes_read"] + k["bytes_written"] for k in kernel.values())),
        "collectives": collective_bytes(colls),
        "collective_calls": {k: sum(1 for c in colls if c["kind"] == k)
                             for k in COLLECTIVE_KINDS},
        "memory": {
            "argument_size_in_bytes": sum(arg_st.values()),
            "output_size_in_bytes": sum(out_st.values()),
            "temp_size_in_bytes": mem.peak_bytes,
            "generated_code_size_in_bytes": 0,
            "alias_size_in_bytes": sum(n for k, n in out_st.items()
                                       if k in arg_st)},
        "peak_by_op": dict(sorted(mem.peak_by_op.items(),
                                  key=lambda kv: -kv[1])[:6]),
        "kernels": kernel,
        "launches": _launches(before, kernels),
        "collective_records": colls,
    }


# =============================================================================
# A cell
# =============================================================================
def variant_setup(cfg: ModelConfig, variant: str,
                  rules_override: Optional[dict]):
    """(cfg, microbatch, packed bits or None, rules override, note) of a
    reference variant, as the port's mechanisms give it."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    microbatch, bits, note = 1, None, None
    if variant == "novjp":
        cfg = dataclasses.replace(cfg, flash_vjp=False)
    elif variant.startswith("sp"):
        cfg = dataclasses.replace(cfg, seq_sharding=True)
        microbatch = 4 if variant == "sp_mb4" else 1
    elif variant.startswith("inner"):
        cfg = dataclasses.replace(cfg, remat_inner=True)
        microbatch = {"inner": 1, "inner_mb4": 4, "inner_mb8": 8}[variant]
    if variant.endswith(("tp", "scan")):
        rules_override = dict(rules_override or {})
        rules_override["fsdp"] = ()
    if variant in ("w8", "w8tp", "w8scan"):
        bits = 8
    elif variant in ("w4", "w4tp", "w4scan"):
        bits = 4
    if variant.endswith("scan"):
        note = (f"{variant} is the {variant[:2]}tp step: the port "
                "dequantizes packed weights per layer at their point of use "
                "in every step")
    return cfg, microbatch, bits, rules_override, note


def _local_shape(shape, spec, mesh: Mesh) -> Tuple[int, ...]:
    return tuple(d // mesh.size(_axes(e)) for d, e in zip(shape, spec)) \
        + tuple(shape[len(spec):])


def _empty(shape, dtype, device, fake: bool) -> torch.Tensor:
    """A fake tensor (under the block's FakeTensorMode), or real zeros."""
    if fake:
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.zeros(shape, dtype=dtype, device=device)


def _local_batch(cfg, shape, kind, mesh, device, fake):
    specs = batch_specs(cfg, shape, kind)
    sharding = batch_shardings({k: s for k, (s, _) in specs.items()}, mesh)
    return {k: _empty(_local_shape(s, sharding[k], mesh), dt, device, fake)
            for k, (s, dt) in specs.items()}


def _local_params(api, specs, mesh, dtype, device, fake):
    """This rank's shard of the parameter tree under ``specs``."""
    return unflatten_paths({
        path: _empty(_local_shape(t.shape, spec, mesh), dtype, device, fake)
        for path, t, spec in with_specs(abstract_params(api), specs)})


def _map_spec(fn, spec):
    """``fn`` over each spec of a leaf's spec (a container's fields)."""
    if isinstance(spec, MXTensor):
        return dataclasses.replace(spec, codes=fn(spec.codes),
                                   scale_exp=fn(spec.scale_exp))
    if isinstance(spec, PackedInt4Leaf):
        return dataclasses.replace(spec, packed=fn(spec.packed),
                                   scale_exp=fn(spec.scale_exp))
    return fn(spec)


def _model_spec(spec):
    """A spec with the data axes taken out (what a repack per ``model``
    shard reads)."""
    return tuple(None if _axes(e) and set(_axes(e)) <= set(DATA_AXES)
                 else e for e in spec)


def _gather_data(tree, specs, mesh: Mesh):
    """The tree with each dim its spec puts on the data axes all-gathered
    (``ShardedTrainStep``'s ZeRO gather), packed containers field by
    field; the ``model`` axis' cut stays."""
    def one(leaf, spec):
        if isinstance(leaf, MXTensor):
            return dataclasses.replace(
                leaf, codes=_gather1(leaf.codes, spec.codes, mesh),
                scale_exp=_gather1(leaf.scale_exp, spec.scale_exp, mesh))
        if isinstance(leaf, PackedInt4Leaf):
            return dataclasses.replace(
                leaf, packed=_gather1(leaf.packed, spec.packed, mesh),
                scale_exp=_gather1(leaf.scale_exp, spec.scale_exp, mesh))
        return _gather1(leaf, spec, mesh)
    return tree_map(one, tree, specs)


def _gather1(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    data = _data_spec(spec)
    if all(e is None for e in data):
        return t
    return gather_tree(t, data, mesh)


def _tensor_parallel(cfg, p_spec, mesh: Mesh) -> Optional[TensorParallel]:
    tp = mesh.size(("model",))
    if tp <= 1:
        return None
    rank = mesh.coord("model")
    return TensorParallel(mesh.group_of(("model",)), rank, tp,
                          dims=shard_dims(cfg, p_spec, rank, tp))


def _packed_weights(api, qat, bits, mesh, device, fake):
    """This rank's packed serving tree: a fake (or real) anchor of the
    whole tree at MXINT8 (B6), at ``bits`` 4 Slice-and-Scaled and split-N
    packed (B5), repacked per ``model`` shard and cut, as the engine builds
    it; with the specs it was cut by. Its launches are the cell's setup."""
    cfg = api.cfg
    whole = tree_map(lambda t: _empty(t.shape, torch.float32, device, fake),
                     abstract_params(api))
    anchor = make_anchor(whole, qat, get_format("mxint8", qat.block_size),
                         device=device)
    packed = make_packed_params(
        anchor, target_fmt="mxint4" if bits == 4 else None,
        dtype=cfg.compute_dtype)
    specs = packed_param_specs(packed, param_axes(cfg), mesh)
    model_specs = tree_map(lambda _, s: _map_spec(_model_spec, s), packed,
                           specs)
    packed = repack_splitn_for_tp(packed, model_specs, mesh)
    return local_shard(packed, specs, mesh), specs


def _rules(rules_override: Optional[dict]) -> LogicalRules:
    table = dict(DEFAULT_RULES)
    table.update(rules_override or {})
    return LogicalRules(table)


def trace_cell(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
               variant: str = "baseline",
               rules_override: Optional[dict] = None, device="cuda",
               fake: bool = True,
               before_step: Optional[Callable[[], None]] = None
               ) -> Dict[str, Any]:
    """The cost record of this process's step of one cell on ``mesh`` (an
    initialised group of the mesh's size; ``make_mesh``): ``{"status":
    "ok", ...}`` with ``measure``'s fields, or ``{"status": "refused",
    "reason"}`` when the ``model`` axis cannot cut the config. ``fake``:
    on fake tensors on ``trace_device(device)``; else on real zeros on
    ``device``. ``variant`` as the module docstring maps it.
    ``before_step`` is called once the cell is built, just before its step
    (``chip_smoke.py`` resets the card's peak statistics there)."""
    cfg, microbatch, bits, rules_override, note = variant_setup(
        cfg, variant, rules_override)
    qat = QATConfig(formats=TRAIN_FORMATS_MXINT, block_size=32)
    api = get_model(cfg, qat)
    tp = mesh.size(("model",))
    try:
        if tp > 1:
            _check_model_axis(api, tp)
    except ValueError as e:
        return {"status": "refused", "reason": f"ValueError: {e}"}
    dev = trace_device(device) if fake else torch.device(device)
    mode = _fake_mode() if fake and dev.type != "meta" \
        else contextlib.nullcontext()
    t0 = time.perf_counter()
    setup_before = _launch_counts()
    with use_rules(mesh, _rules(rules_override)), mode:
        with kernel_common.shape_only_launches() as setup_records:
            if shape.kind == "train":
                fn, args = _train_cell(api, cfg, shape, mesh, microbatch,
                                       dev, fake)
            else:
                fn, args = _serve_cell(api, cfg, qat, shape, mesh, bits,
                                       dev, fake)
        setup_launches = _launches(setup_before, setup_records)
        if before_step is not None:
            before_step()
        rec = measure(fn, args)
    rec["compile_s"] = time.perf_counter() - t0
    rec["setup_kernels"] = _kernel_summary(setup_records)
    rec["setup_launches"] = setup_launches
    rec["trace_device"] = str(dev) if fake else None
    if note:
        rec["note"] = note
    return {"status": "ok", **rec}


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    # constants made inside the trace (torch.tensor) stay real CPU
    # tensors: let them mix with the fake ones
    return FakeTensorMode(allow_non_fake_inputs=True)


def _train_cell(api, cfg, shape, mesh, microbatch, dev, fake):
    """The sharded step of this rank, its state and batch shards. The
    format index is the first MXINT format's: every format costs alike."""
    opt_cfg = AdamWConfig(moment_dtype=torch.bfloat16
                          if "jamba" in cfg.name else torch.float32)
    shapes = {k: s for k, (s, _) in batch_specs(cfg, shape, "train").items()}
    step, specs = make_sharded_train_step(api, mesh, opt_cfg, shapes,
                                          microbatch=microbatch)
    params = _local_params(api, specs.params, mesh, torch.float32, dev,
                           fake)
    state = TrainState(params, init_opt_state(params, opt_cfg), 0)
    batch = _local_batch(cfg, shape, "train", mesh, dev, fake)
    return (lambda s, b: step(s, b, 0)), (state, batch)


def _serve_cell(api, cfg, qat, shape, mesh, bits, dev, fake):
    """Prefill or ``serve_step`` of this rank's tensor-parallel model, on
    its weights (bf16, or packed at ``bits``) gathered over the data axes
    inside the step, its batch shard and its kv heads' cache."""
    p_spec = state_shardings(api, mesh)[0]
    sapi = get_model(cfg, qat, tp=_tensor_parallel(cfg, p_spec, mesh))
    if bits is None:
        params = _local_params(api, p_spec, mesh, torch.bfloat16, dev, fake)
        specs = p_spec
    else:
        params, specs = _packed_weights(api, qat, bits, mesh, dev, fake)
        sapi = sapi.with_serving(make_qmm("kernel"))
    kind = shape.kind
    batch = _local_batch(cfg, shape, kind, mesh, dev, fake)
    b = batch["tokens"].shape[0]
    alloc = shape.seq_len if kind == "prefill" else decode_alloc(cfg, shape)
    cache = sapi.init_cache(b, alloc, device=dev)
    if kind == "prefill":
        def fn(p, bt, c):
            return sapi.prefill(_gather_data(p, specs, mesh), bt, c)
        return fn, (params, batch, cache)
    cache_len = _empty((b,), torch.int32, dev, fake)

    def step(p, bt, c, n):
        return sapi.serve_step(_gather_data(p, specs, mesh), bt, c, n)
    return step, (params, batch, cache, cache_len)


def mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "16x16"


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               variant: str = "baseline",
               rules_override: Optional[dict] = None,
               device="cuda") -> Dict[str, Any]:
    """Trace one cell on the production mesh over a fake world of its size
    and return the record (the reference's schema, the port's extra fields
    after it): ``"ok"``, ``"refused"`` (the ``model`` axis cannot cut the
    config, with the guard's message) or ``"skipped"`` (a full-attention
    arch at 500k). Raises on anything else (``main`` records it)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not applicable(cfg, shape):
        return {"status": "skipped", "reason": "full-attention arch at 500k"}
    dims, _ = PRODUCTION_MESHES[multi_pod]
    with fake_world(math.prod(dims)):
        mesh = make_production_mesh(multi_pod=multi_pod)
        got = trace_cell(cfg, shape, mesh, variant, rules_override, device)
    head = {"status": got.pop("status"), "arch": arch, "shape": shape_name,
            "mesh": mesh_tag(multi_pod), "variant": variant}
    if head["status"] != "ok":
        return {**head, **got}
    got.pop("collective_records")
    return {**head, "compile_s": got.pop("compile_s"),
            "flops": got.pop("flops"),
            "bytes_accessed": got.pop("bytes_accessed"),
            "collectives": got.pop("collectives"),
            "memory": got.pop("memory"),
            "n_devices": int(math.prod(dims)), **got}


@contextlib.contextmanager
def _time_limit(seconds: float) -> Iterator[None]:
    """Make the ops of a trace under it raise ``TimeoutError`` once
    ``seconds`` have passed (``MemoryTracker`` checks at every op: a signal
    raised inside a finalizer or a GC callback would be lost)."""
    _DEADLINE[0] = (time.monotonic() + seconds, seconds)
    try:
        yield
    finally:
        _DEADLINE[0] = None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="baseline",
                    help="one of VARIANTS, or several, comma-separated")
    ap.add_argument("--out", default="out/dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    for variant in args.variant.split(","):
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    _main_cell(args, arch, shape, mp, variant)
    return 0


def _main_cell(args, arch: str, shape: str, multi_pod: bool,
               variant: str) -> None:
    tag = mesh_tag(multi_pod)
    path = os.path.join(args.out, f"{arch}__{shape}__{tag}__{variant}.json")
    if os.path.exists(path) and not args.force:
        print(f"skip (exists): {path}")
        return
    print(f"=== {arch} x {shape} x {tag} x {variant} ===", flush=True)
    try:
        with _time_limit(TRACE_LIMIT_S):
            rec = lower_cell(arch, shape, multi_pod, variant=variant)
    except Exception as e:  # record failures: they are bugs
        rec = {"status": "error", "arch": arch, "shape": shape, "mesh": tag,
               "variant": variant, "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items() if k != "trace"})[:600],
          flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
