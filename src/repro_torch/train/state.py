"""The training state and the train step (forward, backward, AdamW).

Counterpart of ``repro/train/state.py``. ``TrainState`` holds the parameter
tree, the AdamW state and the step; ``build_train_step`` returns
``(state, batch, fmt_idx) -> (state, metrics)`` on one device, with
gradients from autograd through the model's straight-through fake-quant
and optional accumulation over microbatches.

The sharded half: ``state_shardings`` / ``batch_shardings`` give the spec
trees the reference's ``NamedSharding``s carry (``sharding/rules.py`` on a
``launch/mesh.py::Mesh``; the AdamW moments follow the params, the step is
replicated, a batch leaf is ``("batch", None, ...)``), and
``make_sharded_train_step`` returns a step that every process of the mesh
calls on its own shard of the state and of the batch (one process per
shard, ``torch.distributed``), where the reference jits one program with
those shardings. What GSPMD derives, the step does explicitly:

- the data axes (``pod``, ``data``): each parameter dim that resolves to
  them (``fsdp``) is all-gathered before the forward (ZeRO-3), and its
  gradient is summed over the processes that hold other rows of the batch
  and cut back to this process's shard (an all-reduce and a slice: the
  reduce-scatter's sum, and a collective gloo has); a leaf those axes
  replicate gets the sum whole. The loss is the whole batch's: the
  cross entropy's masked sum and count, and the MoE balance fractions, are
  summed over the batch's shards inside the model (``DataParallel``);
- the ``model`` axis: every family's tensor-parallel forward
  (``get_model(cfg, tp=...)``), told what this process holds by the
  resolved spec tree (``models/__init__.py::shard_dims``: heads, kv
  heads, Mamba's d_inner, RWKV heads, and of each MoE layer whether the
  rules gave ``model`` to its experts or to its d_ff), whose collectives
  carry the gradients (``models/common.py``);
- the global gradient norm AdamW clips by: each leaf's squares counted
  once, by the process at coordinate 0 of every axis that replicates it,
  then summed over the mesh.

``shard_state`` and ``gather_state`` move between a whole state and this
process's; ``train/loop.py::run_training`` checkpoints the whole one, so
the format on disk is the single device's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import flatten_paths, tree_map, unflatten_paths
from repro_torch.launch.mesh import Mesh
from repro_torch.models import get_model
from repro_torch.models import param_axes as model_param_axes
from repro_torch.models import param_shapes, shard_dims
from repro_torch.models.common import DataParallel, TensorParallel
from repro_torch.models.transformer import (ModelApi, ffn_kind, mixer_kind,
                                            param_leaves)
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.serve.packed_params import local_shard
from repro_torch.sharding.rules import param_specs, spec_for_axes

DATA_AXES = ("pod", "data")


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


# =============================================================================
# Sharding
# =============================================================================
def abstract_params(api: ModelApi):
    """The parameter tree as meta tensors: shapes only, nothing allocated."""
    cfg = api.cfg
    return unflatten_paths({
        path: torch.empty(shape, device="meta") for path, (shape, _) in
        param_leaves(cfg, param_shapes(cfg))})


def state_shardings(api: ModelApi, mesh: Mesh):
    """(param specs, opt specs): the params' specs from their logical axes,
    the AdamW moments following them, the step replicated (``()``)."""
    p_spec = param_specs(model_param_axes(api.cfg), abstract_params(api),
                         mesh)
    return p_spec, {"step": (), "m": p_spec, "v": p_spec}


def batch_shardings(batch_shapes: Dict, mesh: Mesh) -> Dict:
    """{name: spec} of a batch: dim 0 over ``batch``, the rest replicated.
    ``batch_shapes`` holds shapes, or anything with a ``.shape``."""
    def one(s):
        shape = tuple(getattr(s, "shape", s))
        return spec_for_axes(shape, ("batch",) + (None,) * (len(shape) - 1),
                             mesh)
    return {k: one(v) for k, v in batch_shapes.items()}


def _axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _data_spec(spec) -> Tuple:
    """``spec`` with only its entries over the data axes (the dims a ZeRO
    gather restores); an entry mixing them with another axis is refused."""
    out = []
    for entry in spec:
        axes = _axes(entry)
        data = [a for a in axes if a in DATA_AXES]
        if data and len(data) != len(axes):
            raise ValueError(f"spec entry {entry!r} mixes the data axes "
                             "with others; the sharded step gathers them "
                             "apart")
        out.append(entry if data else None)
    return tuple(out)


def _gather_dim(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_tree(tree, specs, mesh: Mesh):
    """The whole tree from every process's shard (``local_shard``'s
    inverse): each sharded dim all-gathered over its axes' group, in
    order. A concatenation, so bit for bit. Every process must call it."""
    def one(t, spec):
        for dim, entry in enumerate(spec):
            axes = _axes(entry)
            n = mesh.size(axes)
            if n > 1:
                t = _gather_dim(t, dim, mesh.group_of(axes), n)
        return t
    return tree_map(one, tree, specs)


def shard_state(state: TrainState, specs: TrainState,
                mesh: Mesh) -> TrainState:
    """The shard of a whole ``state`` that this process holds under the
    state's spec tree."""
    def cut(tree, spec):
        return local_shard(tree, spec, mesh)
    return TrainState(cut(state.params, specs.params),
                      {"step": state.opt["step"],
                       "m": cut(state.opt["m"], specs.opt["m"]),
                       "v": cut(state.opt["v"], specs.opt["v"])},
                      state.step)


def gather_state(local: TrainState, specs: TrainState,
                 mesh: Mesh) -> TrainState:
    """The whole state from every process's ``local`` one (every process
    must call it; each gets the whole state)."""
    return TrainState(gather_tree(local.params, specs.params, mesh),
                      {"step": local.opt["step"],
                       "m": gather_tree(local.opt["m"], specs.opt["m"], mesh),
                       "v": gather_tree(local.opt["v"], specs.opt["v"],
                                        mesh)},
                      local.step)


def _check_model_axis(api: ModelApi, tp: int) -> None:
    """A ``model`` axis above 1 cuts, in every family, the dims its
    tensor-parallel forward splits: each must divide by ``tp`` (the rules
    would otherwise leave its leaves whole; the kv heads may instead
    divide ``tp``), and under MF-QAT each row-parallel shard must be whole
    MX blocks, so that its fake-quant is its slice of the whole weight's.
    Refused loudly, naming the dims."""
    cfg = api.cfg
    kinds = {("attn", "mlp")} if cfg.family == "encdec" else \
        {(mixer_kind(cfg, j), ffn_kind(cfg, j))
         for j in range(cfg.scan_group)}
    mixers, ffns = {m for m, _ in kinds}, {f for _, f in kinds}
    heads, rows = {}, {}         # dim: size (split by tp / by bs * tp)
    kv_ok = True
    if "attn" in mixers:
        heads["n_heads"] = cfg.n_heads
        rows["n_heads*head_dim"] = cfg.n_heads * cfg.hd
        # kv heads split, or (an axis that outnumbers them) each process
        # gathers its query heads' kv head: ShardDims.kv_gather
        kv_ok = cfg.n_kv_heads % tp == 0 or (
            tp % cfg.n_kv_heads == 0 and cfg.n_kv_heads * cfg.hd % tp == 0)
    if "mamba" in mixers:
        rows["d_inner"] = cfg.mamba_d_inner
    if "rwkv" in mixers:
        heads["rwkv heads"] = cfg.d_model // cfg.rwkv_head_dim
        rows["d_model"] = cfg.d_model
    if ffns & {"mlp", "cmix"}:
        rows["d_ff"] = cfg.d_ff
    bs = api.qat.block_size if api.qat is not None and api.qat.enabled \
        else 1
    bad = {k: v for k, v in heads.items() if v % tp}
    if not kv_ok:
        bad["n_kv_heads"] = cfg.n_kv_heads
    bad.update({k: v for k, v in rows.items() if v % (bs * tp)})
    if "moe" in ffns and cfg.moe_experts % tp and cfg.d_ff % (bs * tp):
        # the rules give ``model`` to the experts where it divides them,
        # else to each expert's d_ff (w_down then row-parallel)
        bad.update({"moe_experts": cfg.moe_experts, "expert d_ff": cfg.d_ff})
    if bad:
        raise ValueError(f"mesh 'model' axis size {tp} cannot shard this "
                         f"config: {bad} not divisible (block_size={bs})")


class ShardedTrainStep:
    """The step of one process of a mesh: ``step(state, batch, fmt_idx) ->
    (state, metrics)`` on this process's shard of the state (``specs``)
    and of the batch (``batch_specs``); every process of the mesh calls it
    together. ``metrics``: the whole batch's loss and the global gradient
    norm, alike in every process."""

    def __init__(self, api: ModelApi, mesh: Mesh, opt_cfg: AdamWConfig,
                 batch_shapes: Dict, lr_schedule=None, microbatch: int = 1):
        tp = mesh.size(("model",))
        if tp > 1:
            _check_model_axis(api, tp)
        p_spec, opt_spec = state_shardings(api, mesh)
        self.api, self.mesh, self.opt_cfg = api, mesh, opt_cfg
        self.lr_schedule, self.microbatch = lr_schedule, microbatch
        self.specs = TrainState(p_spec, opt_spec, ())
        self.batch_specs = batch_shardings(batch_shapes, mesh)
        self._data_specs = tree_map(lambda _, s: _data_spec(s),
                                    abstract_params(api), p_spec)
        # this process's place on the model axis and what it holds there
        self.tensor_parallel: Optional[TensorParallel] = None
        if tp > 1:
            rank = mesh.coord("model")
            self.tensor_parallel = TensorParallel(
                mesh.group_of(("model",)), rank, tp,
                dims=shard_dims(api.cfg, p_spec, rank, tp))
        self._apis: Dict[Tuple[str, ...], ModelApi] = {}

    # ---- state and batch placement ------------------------------------
    def shard_state(self, state: TrainState) -> TrainState:
        return shard_state(state, self.specs, self.mesh)

    def gather_state(self, local: TrainState) -> TrainState:
        return gather_state(local, self.specs, self.mesh)

    def shard_batch(self, batch: Dict) -> Dict:
        """This process's rows of a whole batch."""
        return local_shard(batch, self.batch_specs, self.mesh)

    @property
    def is_writer(self) -> bool:
        """The process at coordinate 0 of every axis (the one that writes
        what every process holds alike)."""
        return self.mesh.index(self.mesh.axis_names) == 0

    def any(self, flag: bool) -> bool:
        """True in every process when ``flag`` is in one (a collective)."""
        import torch.distributed as dist
        group = self.mesh.group_of(self.mesh.axis_names)
        if group is None:
            return bool(flag)
        dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
        t = torch.tensor([int(bool(flag))], device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return bool(t.item())

    # ---- the step ------------------------------------------------------
    def _batch_axes(self, specs: Dict) -> Tuple[str, ...]:
        axes = {_axes(s[0]) for s in specs.values()}
        if len(axes) != 1:
            raise ValueError(f"batch leaves shard their rows differently: "
                             f"{specs}")
        return axes.pop()

    def _api(self, batch_axes: Tuple[str, ...]) -> ModelApi:
        """The model that runs this process's shard: the ``model`` axis'
        collectives and shard dims, the batch axes' group."""
        if batch_axes not in self._apis:
            n = self.mesh.size(batch_axes)
            dp = DataParallel(self.mesh.group_of(batch_axes),
                              self.mesh.index(batch_axes), n) \
                if n > 1 else None
            self._apis[batch_axes] = get_model(
                self.api.cfg, qat=self.api.qat, dp=dp,
                tp=self.tensor_parallel)
        return self._apis[batch_axes]

    def _grads_of(self, api: ModelApi, params, batch, fmt_idx):
        flat = flatten_paths(params)
        leaves = [p.detach().requires_grad_(True) for _, p in flat]
        tree = unflatten_paths({k: p for (k, _), p in zip(flat, leaves)})
        loss, _ = api.train_loss(tree, batch, fmt_idx)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), unflatten_paths(
            {k: g for (k, _), g in zip(flat, grads)})

    @torch.no_grad()
    def loss(self, params, batch, fmt_idx: int):
        """``train_loss`` of the whole batch, ``(loss, {"ce", "aux"})``,
        at local ``params`` and local ``batch`` (no gradients)."""
        whole = gather_tree(params, self._data_specs, self.mesh)
        return self._api(self._batch_axes(self.batch_specs)).train_loss(
            whole, batch, fmt_idx)

    def loss_and_grads(self, params, batch, fmt_idx: int):
        """(the whole batch's loss, this process's shard of the
        gradients) at local ``params`` and local ``batch``."""
        import torch.distributed as dist
        with torch.no_grad():
            whole = gather_tree(params, self._data_specs, self.mesh)
        if self.microbatch <= 1:
            axes = self._batch_axes(self.batch_specs)
            loss, grads = self._grads_of(self._api(axes), whole, batch,
                                         fmt_idx)
        else:
            # the reference's microbatch i is rows [i*mb, (i+1)*mb) of the
            # whole batch: gather the (integer) batch and shard each slice
            full = gather_tree(batch, self.batch_specs, self.mesh)
            rows = next(iter(full.values())).shape[0] // self.microbatch
            mb_specs = batch_shardings(
                {k: (rows,) + tuple(v.shape[1:]) for k, v in full.items()},
                self.mesh)
            axes = self._batch_axes(mb_specs)
            grads, loss = None, 0.0
            for i in range(self.microbatch):
                part = local_shard({k: v[i * rows:(i + 1) * rows]
                                    for k, v in full.items()},
                                   mb_specs, self.mesh)
                l, g = self._grads_of(self._api(axes), whole, part, fmt_idx)
                g = tree_map(lambda t: t.to(torch.float32), g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / self.microbatch, grads)
            loss = loss / self.microbatch
        group = self.mesh.group_of(axes)
        if group is not None:
            # every process of the group holds a part of each whole
            # gradient: sum them (the gradient of a leaf the batch axes
            # replicate is whole after it)
            def reduce(g):
                buf = g.contiguous()
                dist.all_reduce(buf, group=group)
                return buf
            grads = tree_map(reduce, grads)
        return loss, local_shard(grads, self._data_specs, self.mesh)

    def global_norm(self, grads) -> torch.Tensor:
        """The norm of the whole gradient tree from this process's shard:
        each leaf's squares counted by one process of those that hold the
        same piece, summed over the mesh."""
        import torch.distributed as dist
        sizes = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        total = None
        for _, g, spec in with_specs(grads, self.specs.params):
            sharded = {a for e in spec for a in _axes(e)}
            owner = all(self.mesh.coord(a) == 0 for a, n in sizes.items()
                        if n > 1 and a not in sharded)
            sq = torch.sum(torch.square(g.to(torch.float32)))
            sq = sq if owner else torch.zeros_like(sq)
            total = sq if total is None else total + sq
        group = self.mesh.group_of(self.mesh.axis_names)
        if group is not None:
            total = total.contiguous()
            dist.all_reduce(total, group=group)
        return torch.sqrt(total)

    def __call__(self, state: TrainState, batch, fmt_idx: int):
        loss, grads = self.loss_and_grads(state.params, batch, fmt_idx)
        gnorm = self.global_norm(grads)
        lr_scale = self.lr_schedule(state.step) if self.lr_schedule else 1.0
        params, opt, om = adamw_update(state.params, grads, state.opt,
                                       self.opt_cfg, lr_scale, gnorm=gnorm)
        return TrainState(params, opt, state.step + 1), {"loss": loss, **om}


def with_specs(tree, specs, prefix: str = ""):
    """(keystr path, leaf, spec) of a tree and its spec tree, in
    ``flatten_paths``' order (a spec is a tuple, so ``flatten_paths`` of
    the spec tree alone would walk into it)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from with_specs(tree[k], specs[k], f"{prefix}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, (t, s) in enumerate(zip(tree, specs)):
            yield from with_specs(t, s, f"{prefix}[{i}]")
    else:
        yield prefix, tree, specs


def make_sharded_train_step(api: ModelApi, mesh: Mesh, opt_cfg: AdamWConfig,
                            batch_shapes: Dict, lr_schedule=None,
                            microbatch: int = 1):
    """(step, state spec tree): the train step of this process of ``mesh``
    (``ShardedTrainStep``), computing what ``build_train_step`` computes on
    the whole state and batch, and the ``TrainState`` of specs its state
    is sharded by, for every family on any mesh whose ``model`` axis
    divides the dims its forward cuts (``_check_model_axis``)."""
    step = ShardedTrainStep(api, mesh, opt_cfg, batch_shapes, lr_schedule,
                            microbatch)
    return step, step.specs
