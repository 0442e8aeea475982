"""The sharded training step over ``torch.distributed`` against JAX's.

The reference jits one step with ``NamedSharding``s on a mesh; the port
runs one process per shard (``train/state.py::make_sharded_train_step``),
here two gloo processes on the host (``tests/_torch_dist.py``). JAX's own
sharded step runs on this JAX on the (1, 2) and (2, 1) host meshes the
root conftest gives (two host devices), and the reference states that it
computes the single-device step; so the oracle of the numbers is JAX's
single-device step (``build_train_step`` under ``jax.jit``, one compile
per config, with ``value_and_grad`` for the gradients), and one case holds
JAX's sharded step to it as well.

- ``param_axes`` of all ten configs, and the spec trees of
  ``state_shardings`` / ``batch_shardings``, equal to the ``.spec`` of
  JAX's ``NamedSharding``s on the (1, 2) and (2, 1) host meshes, and to the
  reference's ``spec_for_axes`` on a (2, 2, 2) pod description (resolution
  only: the host has two devices).
- Reduced qwen3-4b (qk_norm, an untied vocab-sharded head) at (1, 2) and
  (2, 1), and at (2, 1) with ``microbatch=2``: loss, CE, grad norm,
  gathered gradients, the first moment and the updated parameters after a
  step, and a second step's loss and grad norm, against JAX. The first
  batch's masks differ between the two row shards, so a mean of per-shard
  means would miss. Tolerances: rtol 1e-4 and atol 1e-6 * max|x| per leaf
  (``tests/test_torch_train.py``'s, summation order). The updated
  parameters take that gradient tolerance through AdamW's first step,
  which moves each weight by lr * g / (|g| + eps): an element's
  tolerance grows by lr * eps * tol_g / (|g| + eps)^2 (at most 2 lr), so a
  near-zero gradient's last-place difference is allowed to show (JAX's
  own sharded step differs from its single-device step there).
- Reduced mixtral-8x7b at (2, 1) with the same batch: the Switch balance
  loss is a product of batch means, so it is compared term by term.
- ``gather_state(shard_state(s)) == s`` bit for bit, each process holding
  about half the state; every config's step built at ``model`` = 2 (the
  numbers of the other families' tensor-parallel steps:
  ``tests/test_torch_tp_train_*.py``); two processes write a checkpoint
  through ``run_training`` and one process resumes it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jreduced
from repro.core.formats import TRAIN_FORMATS_MXINT
from repro.core.qat import QATConfig as JQAT
from repro.launch.mesh import make_debug_mesh as jmesh
from repro.models import get_model as jget_model
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import adamw_update as jadamw_update
from repro.optim.adamw import init_opt_state as jinit_opt
from repro.sharding.rules import spec_for_axes as jspec
from repro.train.state import TrainState as JTrainState
from repro.train.state import batch_shardings as jbatch_shardings
from repro.train.state import build_train_step as jbuild
from repro.train.state import make_sharded_train_step as jsharded_step
from repro.train.state import state_shardings as jstate_shardings
from repro_torch.configs import get_reduced, list_archs
from repro_torch.core.qat import QATConfig
from repro_torch.core.tree import flatten_paths
from repro_torch.data.pipeline import DataConfig, LMDataset
from repro_torch.launch.mesh import Mesh
from repro_torch.models import get_model, param_axes
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.state import (batch_shardings,
                                     make_sharded_train_step,
                                     state_shardings)
from _torch_dist import run_ranks, sharded_loop_worker, sharded_step_worker

DENSE, MOE = "qwen3-4b", "mixtral-8x7b"
LAYOUTS = ((1, 2), (2, 1))
B, S, LR, FMT_IDX = 4, 64, 1e-3, 1
FRAMES = 32            # the encoder-decoder's frame embeddings a row
POD = ((2, 2, 2), ("pod", "data", "model"))


def _flat(tree):
    return {jax.tree_util.keystr(p).replace('"', "'"): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, tuple))[0]}


def _port_flat(tree, prefix=""):
    """``flatten_paths`` with tuples (axes, specs) as leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_flat(tree[k], f"{prefix}['{k}']")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _port_flat(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _desc(shape, names=("data", "model")):
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), names)


class _FakeMesh:
    """What the reference's ``spec_for_axes`` reads of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def _jspecs(shardings):
    return {jax.tree_util.keystr(p).replace('"', "'"): tuple(v.spec)
            for p, v in jax.tree_util.tree_flatten_with_path(shardings)[0]}


# ---- logical axes and spec trees -------------------------------------------
@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_param_axes_equal_jax(arch):
    want = _flat(jget_model(jreduced(arch)).param_axes())
    assert dict(_port_flat(param_axes(get_reduced(arch)))) == \
        {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_state_shardings_equal_jax(arch):
    japi, cfg = jget_model(jreduced(arch)), get_reduced(arch)
    api = get_model(cfg)
    for shape in LAYOUTS:
        jp, jopt = jstate_shardings(japi, jmesh(*shape))
        p, opt = state_shardings(api, _desc(shape))
        assert dict(_port_flat(p)) == _jspecs(jp)
        assert dict(_port_flat(opt["m"])) == _jspecs(jopt["m"]) \
            == dict(_port_flat(opt["v"]))
        assert opt["step"] == () == tuple(jopt["step"].spec)
    # the pod description: the reference's resolution of its own axes
    shapes = jax.eval_shape(japi.init_params, jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(
        lambda ax, s: jspec(s.shape, ax, _FakeMesh(*POD)),
        japi.param_axes(), shapes,
        is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x))
    got = dict(_port_flat(state_shardings(api, _desc(*POD))[0]))
    assert got == {
        jax.tree_util.keystr(p).replace('"', "'"): tuple(v)
        for p, v in jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, tuple))[0]}
    assert any(isinstance(e, tuple) for s in got.values() for e in s)


@pytest.mark.parametrize("rows", [4, 3, 8])
def test_batch_shardings_equal_jax(rows):
    shapes = {"tokens": (rows, S), "labels": (rows, S), "mask": (rows, S),
              "vision_embeds": (rows, 8, 64)}
    jshapes = {k: jax.ShapeDtypeStruct(v, jnp.float32)
               for k, v in shapes.items()}
    for shape in LAYOUTS:
        want = {k: tuple(v.spec) for k, v in
                jbatch_shardings(jshapes, jmesh(*shape)).items()}
        assert batch_shardings(shapes, _desc(shape)) == want
    pod = {k: tuple(jspec(v, ("batch",) + (None,) * (len(v) - 1),
                          _FakeMesh(*POD))) for k, v in shapes.items()}
    assert batch_shardings({k: torch.empty(v, device="meta") for k, v in
                            shapes.items()}, _desc(*POD)) == pod


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_model_axis_refuses_a_non_dense_family(arch):
    """No family is refused any more: every config's step builds at (1, 2)
    (tensor parallelism; seen from process 0, the group a stand-in: no
    collective runs), its spec tree equal to the ``.spec`` of JAX's
    ``state_shardings`` on the (1, 2) host mesh, and at (2, 1) (FSDP;
    its spec tree: ``test_state_shardings_equal_jax``)."""
    api, built = get_model(get_reduced(arch)), {}
    for shape in ((1, 2), (2, 1)):
        mesh = Mesh(np.arange(2).reshape(shape), ("data", "model"),
                    group="model axis", coords={"data": 0, "model": 0})
        step, built[shape] = make_sharded_train_step(
            api, mesh, AdamWConfig(), {"tokens": (B, S)})
        assert built[shape].opt["m"] is built[shape].params
        assert (step.tensor_parallel is None) == (shape == (2, 1))
    jp, _ = jstate_shardings(jget_model(jreduced(arch)), jmesh(1, 2))
    assert dict(_port_flat(built[1, 2].params)) == _jspecs(jp)


# ---- the numbers against JAX ------------------------------------------------
def _batches(cfg):
    """Two batches of ``cfg`` (a JAX config): tokens, labels, masks, and
    the vision prefix or the frame embeddings the family reads."""
    rng = np.random.default_rng(11)

    def one(mask):
        t = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        out = {"tokens": t, "labels": np.roll(t, -1, axis=1), "mask": mask}
        if cfg.vision_tokens:
            out["vision_embeds"] = rng.standard_normal(
                (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            out["frame_embeds"] = rng.standard_normal(
                (B, FRAMES, cfg.d_model)).astype(np.float32)
        return out

    differ = np.ones((B, S), np.float32)
    differ[:B // 2, S // 4:] = 0.0     # the first row shard mostly masked
    differ[B // 2, :3] = 0.0
    return [one(differ), one(np.ones((B, S), np.float32))]


def _jax_case(arch, microbatch2, over=None):
    """The JAX api, its initial params, the batches and the results of one
    jitted function: value_and_grad of train_loss and the single-device
    step (microbatch 1, and 2 when asked) from a state, per batch.
    ``over``: fields of the reduced config replaced (``dataclasses.
    replace``)."""
    cfg = dataclasses.replace(jreduced(arch), **(over or {}))
    japi = jget_model(cfg, JQAT(formats=TRAIN_FORMATS_MXINT))
    params = jax.jit(japi.init_params)(jax.random.PRNGKey(0))
    opt = JAdamW(lr=LR)
    steps = [jbuild(japi, opt)] + ([jbuild(japi, opt, microbatch=2)]
                                   if microbatch2 else [])

    @jax.jit
    def fn(state, batch, idx):
        (loss, terms), grads = jax.value_and_grad(
            lambda p: japi.train_loss(p, batch, idx), has_aux=True)(
            state.params)
        return loss, terms, grads, [s(state, batch, idx) for s in steps]

    state = JTrainState(params, jinit_opt(params, opt), jnp.int32(0))
    batches = _batches(japi.cfg)
    jb = [jax.tree_util.tree_map(jnp.asarray, b) for b in batches]
    idx = jnp.int32(FMT_IDX)
    loss, terms, grads, outs = fn(state, jb[0], idx)
    want = {}
    for k, (st1, m1) in enumerate(outs):
        second = fn(st1, jb[1], idx)[3][k][1]
        want[k + 1] = {"loss": float(m1["loss"]),
                       "grad_norm": float(m1["grad_norm"]),
                       "params": _flat(st1.params),
                       "m": _flat(st1.opt["m"]),
                       "second": (float(second["loss"]),
                                  float(second["grad_norm"]))}
    want["terms"] = {k: float(v) for k, v in terms.items()}
    want["loss"] = float(loss)
    want["grads"] = _flat(grads)
    return japi, params, batches, want


def _jax_setup(arch, over=None, formats=TRAIN_FORMATS_MXINT):
    """The JAX api of the reduced ``arch`` (``over``: fields replaced;
    MF-QAT over ``formats``), its initial params and the batches. The
    params are made strongly typed (a constant init is weakly typed), so
    the state after a step has the same types and a second call reuses
    the compile."""
    cfg = dataclasses.replace(jreduced(arch), **(over or {}))
    japi = jget_model(cfg, JQAT(formats=formats))
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x)),
        jax.jit(japi.init_params)(jax.random.PRNGKey(0)))
    return japi, params, _batches(japi.cfg)


def _jax_oracle(japi, params, batches, fmt_idx=FMT_IDX):
    """``_jax_case``'s results at microbatch 1 from one jitted function
    per config: ``build_train_step``'s own body (``value_and_grad`` of
    ``train_loss``, then ``adamw_update``) returning the gradients and the
    loss terms beside the new state, so XLA compiles one forward and
    backward (a jit of ``value_and_grad`` beside ``build_train_step``
    compiles two, in twice the time or more)."""
    opt = JAdamW(lr=LR)

    @jax.jit
    def fn(state, batch, idx):
        (loss, terms), grads = jax.value_and_grad(
            lambda p: japi.train_loss(p, batch, idx), has_aux=True)(
            state.params)
        new_p, new_opt, om = jadamw_update(state.params, grads, state.opt,
                                           opt, 1.0)
        return (loss, terms, grads, JTrainState(new_p, new_opt,
                                                state.step + 1),
                {"loss": loss, **om})

    state = JTrainState(params, jinit_opt(params, opt), jnp.int32(0))
    jb = [jax.tree_util.tree_map(jnp.asarray, b) for b in batches]
    idx = jnp.int32(fmt_idx)
    loss, terms, grads, st1, m1 = fn(state, jb[0], idx)
    second = fn(st1, jb[1], idx)[4]
    return {"loss": float(loss), "grads": _flat(grads),
            "terms": {k: float(v) for k, v in terms.items()},
            1: {"loss": float(m1["loss"]),
                "grad_norm": float(m1["grad_norm"]),
                "params": _flat(st1.params), "m": _flat(st1.opt["m"]),
                "second": (float(second["loss"]),
                           float(second["grad_norm"]))}}


@pytest.fixture(scope="module")
def dense():
    japi, params, batches, want = _jax_case(DENSE, True)
    got = run_ranks(sharded_step_worker, 2, DENSE,
                    [(s, 1) for s in LAYOUTS] + [((2, 1), 2)],
                    _flat(params), batches, FMT_IDX, LR)
    return japi, params, batches, want, got


@pytest.fixture(scope="module")
def moe():
    japi, params, batches, want = _jax_case(MOE, False)
    got = run_ranks(sharded_step_worker, 2, MOE, [((2, 1), 1)],
                    _flat(params), batches, FMT_IDX, LR)
    return japi, params, batches, want, got


def _close_leaves(got, want, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6 * scale,
                                   err_msg=f"{what} {k}")


def _close_params(got, w, what):
    """Parameters after AdamW's first step: the gradient tolerance
    (rtol 1e-4, atol 1e-6 * max|g|) propagated through lr * g / (|g| +
    eps), per element; the clipped gradient is the first moment / (1 -
    b1)."""
    opt = AdamWConfig()
    assert set(got) == set(w["params"]), what
    for k, p in w["params"].items():
        g = np.abs(w["m"][k].astype(np.float64)) / (1 - opt.b1)
        tol_g = 1e-4 * g + 1e-6 * g.max()
        amp = np.minimum(2.0, opt.eps * tol_g / (g + opt.eps) ** 2)
        err = np.abs(got[k].astype(np.float64) - p)
        bound = 1e-4 * np.abs(p) + 1e-6 * np.abs(p).max() + LR * amp
        assert (err <= bound).all(), (
            f"{what} {k}: {int((err > bound).sum())} elements beyond the "
            f"propagated tolerance, worst {float((err - bound).max()):.3g}")


def _check_case(rec, want, microbatch):
    w = want[microbatch]
    np.testing.assert_allclose(rec["losses"][0], w["loss"], rtol=1e-4)
    np.testing.assert_allclose(rec["grad_norms"][0], w["grad_norm"],
                               rtol=1e-4)
    np.testing.assert_allclose([rec["losses"][1], rec["grad_norms"][1]],
                               w["second"], rtol=1e-4)
    _close_params(rec["params"], w, "params")
    _close_leaves(rec["m"], w["m"], "first moment")
    assert rec["step"] == (1, 1)


@pytest.mark.parametrize("shape", LAYOUTS)
def test_dense_step_equals_jax(dense, shape):
    _, _, _, want, got = dense
    for rank, out in enumerate(got):
        rec = out[shape, 1]
        np.testing.assert_allclose(rec["losses"][0], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(rec["terms"]["ce"], want["terms"]["ce"],
                                   rtol=1e-4)
        _close_leaves(rec["grads"], want["grads"], f"rank {rank} grads")
        _check_case(rec, want, 1)


def test_tensor_parallel_gradients_equal_the_single_device(dense):
    """The (1, 2) step's gradients come from ``train_loss`` under tensor
    parallelism: differentiable collectives or the sums are wrong (a
    non-differentiable all-reduce drops each shard's part of the residual
    stream's gradient, the head's all-gather the other shard's logits)."""
    _, _, _, want, got = dense
    g = got[0][(1, 2), 1]["grads"]
    for k in ("['embed']", "['blocks'][0]['attn']['q_norm']",
              "['blocks'][0]['mixer_norm']", "['final_norm']",
              "['lm_head']"):
        scale = float(np.abs(want["grads"][k]).max())
        assert scale > 0
        np.testing.assert_allclose(g[k], want["grads"][k], rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=k)
    assert got[0][(1, 2), 1]["grads"].keys() == got[1][(1, 2), 1][
        "grads"].keys()


def test_microbatched_step_equals_jax(dense):
    _, _, _, want, got = dense
    for out in got:
        _check_case(out[(2, 1), 2], want, 2)


def test_masks_that_differ_between_shards(dense):
    """The first batch's masks differ between the (2, 1) row shards: the
    loss is one global masked mean, not a mean of the shards' means."""
    _, _, batches, want, got = dense
    m = batches[0]["mask"]
    cnt = m.reshape(2, -1).sum(axis=1)
    assert cnt[0] < cnt[1] / 2                      # the shards differ
    for out in got:
        np.testing.assert_allclose(out[(2, 1), 1]["terms"]["ce"],
                                   want["terms"]["ce"], rtol=1e-4)


def test_state_roundtrip_and_bytes(dense):
    _, _, _, _, got = dense
    for out in got:
        for key, rec in out.items():
            assert rec["roundtrip"], key
            local, whole = rec["bytes"]
            assert 0.5 <= local / whole < 0.51, key


def test_moe_fsdp_step_equals_jax(moe):
    _, _, _, want, got = moe
    assert want["terms"]["aux"] > 0
    for rank, out in enumerate(got):
        rec = out[(2, 1), 1]
        for term in ("ce", "aux"):
            np.testing.assert_allclose(rec["terms"][term],
                                       want["terms"][term], rtol=1e-4,
                                       err_msg=term)
        _close_leaves(rec["grads"], want["grads"], f"rank {rank} grads")
        _check_case(rec, want, 1)


def test_jax_sharded_step_equals_its_single_device_step(dense):
    """The reference's own sharded step runs here at (2, 1) and computes
    its single-device step (so the port is held to both)."""
    japi, params, batches, want, _ = dense
    opt = JAdamW(lr=LR)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    fn, _ = jsharded_step(japi, jmesh(2, 1), opt,
                          {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                           for k, v in jb.items()}, donate=False)
    state = JTrainState(params, jinit_opt(params, opt), jnp.int32(0))
    st, m = fn(state, jb, jnp.int32(FMT_IDX))
    np.testing.assert_allclose([float(m["loss"]), float(m["grad_norm"])],
                               [want[1]["loss"], want[1]["grad_norm"]],
                               rtol=1e-5)
    _close_params(_flat(st.params), want[1], "JAX's sharded step")


# ---- checkpoints written by a mesh, resumed by one process -----------------
def test_sharded_run_training_checkpoint_resumes_on_one_process(tmp_path):
    arch, steps, seq, batch = "smollm-135m", 2, 32, 4
    ckpt = str(tmp_path / "ckpt")
    sharded = run_ranks(sharded_loop_worker, 2, arch, (1, 2), ckpt, steps,
                        seq, batch, LR)
    assert sharded[0] == sharded[1]
    cfg = get_reduced(arch)
    api = get_model(cfg, QATConfig(formats=TRAIN_FORMATS_MXINT))
    data = LMDataset(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                global_batch=batch))
    opt = AdamWConfig(lr=LR)
    whole = run_training(api, data, opt, LoopConfig(total_steps=2 * steps),
                         device="cpu")
    resumed = run_training(api, data, opt,
                           LoopConfig(total_steps=2 * steps, ckpt_dir=ckpt),
                           device="cpu")
    want = [h["loss"] for h in whole["history"]]
    assert [h["step"] for h in resumed["history"]] == [2, 3]
    np.testing.assert_allclose(sharded[0], want[:steps], rtol=1e-4)
    np.testing.assert_allclose([h["loss"] for h in resumed["history"]],
                               want[steps:], rtol=1e-4)
    for (k, a), (_, b) in zip(flatten_paths(resumed["state"].params),
                              flatten_paths(whole["state"].params)):
        assert a.shape == b.shape, k
