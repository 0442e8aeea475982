"""The port's MF-QAT training path held against the JAX package.

Reduced smollm-135m (tied head) and qwen3-4b (qk_norm, untied head), f32,
the same numpy initial weights and the same synthetic batches in both:

- ``train_loss`` and its gradients against ``jax.value_and_grad`` of the
  JAX ``train_loss``, direct and anchored QAT, pass-through included:
  rtol 1e-4, atol 1e-6 * max|g| per leaf. Why not exact: summation order
  and JAX's chunked flash attention against the port's plain softmax.
- the losses of 4 ``run_training`` steps (sequential schedule, and the
  anchored interleaved one): rtol 1e-4. Why: after AdamW steps an f32
  difference in the last place can flip one code at a rounding boundary.
- ``make_schedule`` and ``batch_at(step)``: identical arrays.
- a restart from the port's own checkpoint: exact; a JAX-written training
  checkpoint resumed in the port: the next steps' losses within rtol 1e-4,
  and the port's checkpoint restores in JAX.
- microbatch accumulation against the full batch.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jckpt
from repro.configs import get_reduced as jreduced
from repro.core.formats import TRAIN_FORMATS_MXINT
from repro.core.qat import QATConfig as JQAT
from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import LMDataset as JDataset
from repro.models import get_model as jget_model
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import init_opt_state as jinit_opt
from repro.train.loop import LoopConfig as JLoop
from repro.train.loop import make_schedule as jmake_schedule
from repro.train.loop import run_training as jrun
from repro.train.state import TrainState as JTrainState
from repro.train.state import build_train_step as jbuild
from repro_torch.configs import get_reduced
from repro_torch.core.qat import QATConfig
from repro_torch.core.tree import flatten_paths
from repro_torch.data.pipeline import DataConfig, LMDataset
from repro_torch.interop import params_from_numpy, train_state_from_numpy
from repro_torch.models.transformer import make_model
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.train.loop import LoopConfig, make_schedule, run_training
from repro_torch.train.state import (TrainState, build_train_step,
                                     state_arrays)

ARCHS = ("smollm-135m", "qwen3-4b")
VARIANTS = {"direct": None, "anchored": "mxint8"}
SEQ, BATCH, LR = 128, 2, 1e-3


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


_MODELS = {}


def _models(arch, variant):
    """(JAX api, port api, JAX init params, their numpy flat) per case."""
    key = (arch, variant)
    if key not in _MODELS:
        anchor = VARIANTS[variant]
        japi = jget_model(jreduced(arch), JQAT(formats=TRAIN_FORMATS_MXINT,
                                               anchor=anchor))
        tapi = make_model(get_reduced(arch),
                          qat=QATConfig(formats=TRAIN_FORMATS_MXINT,
                                        anchor=anchor))
        params = jax.jit(japi.init_params)(jax.random.PRNGKey(0))
        _MODELS[key] = (japi, tapi, params, _flat(params))
    return _MODELS[key]


def _data(vocab=512):
    cfg = dict(vocab=vocab, seq_len=SEQ, global_batch=BATCH)
    return JDataset(JData(**cfg)), LMDataset(DataConfig(**cfg))


def _tbatch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


_JGRADS = {}


def _jgrad(arch, variant):
    """The jitted JAX value_and_grad of train_loss (the format index is
    traced, so one compile serves every index)."""
    key = (arch, variant)
    if key not in _JGRADS:
        japi = _models(arch, variant)[0]
        _JGRADS[key] = jax.jit(jax.value_and_grad(
            lambda p, b, i: japi.train_loss(p, b, i)[0]))
    return _JGRADS[key]


@pytest.mark.parametrize("variant,idx", [("direct", 0), ("direct", 3),
                                         ("direct", 4), ("anchored", 1),
                                         ("anchored", 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_jax(arch, variant, idx):
    japi, tapi, params, flat = _models(arch, variant)
    batch = _data()[0].batch_at(3)
    loss_j, grads_j = _jgrad(arch, variant)(
        params, jax.tree_util.tree_map(jnp.asarray, batch), jnp.int32(idx))
    tparams = params_from_numpy(flat, tapi.cfg, device="cpu")
    leaves = [(k, p.requires_grad_(True)) for k, p in flatten_paths(tparams)]
    loss_t, aux = tapi.train_loss(tparams, _tbatch(batch), idx)
    grads_t = torch.autograd.grad(loss_t, [p for _, p in leaves])
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    assert float(aux["aux"]) == 0.0
    want = _flat(grads_j)
    assert set(want) == {k for k, _ in leaves}
    for (k, _), g in zip(leaves, grads_t):
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=k)


_JSTEPS = {}


def _jstep(arch, variant):
    """One jitted JAX train step per case, shared by every JAX run."""
    key = (arch, variant)
    if key not in _JSTEPS:
        _JSTEPS[key] = jax.jit(jbuild(_models(arch, variant)[0],
                                      JAdamW(lr=LR)))
    return _JSTEPS[key]


def _jax_history(arch, variant, schedule, steps, ckpt_dir=None):
    out = jrun(_models(arch, variant)[0], _data()[0], JAdamW(lr=LR),
               JLoop(total_steps=steps, schedule=schedule, ckpt_dir=ckpt_dir),
               step_fn=_jstep(arch, variant), seed=0)
    return out["history"]


def _jax_init_checkpoint(root, arch, variant):
    """The JAX initial state as a step-0 training checkpoint: the port
    starts from the same weights by resuming it."""
    params = _models(arch, variant)[2]
    jckpt.save(str(root), 0, JTrainState(params,
                                         jinit_opt(params, JAdamW(lr=LR)),
                                         jnp.zeros((), jnp.int32)))
    return str(root)


def _port_run(arch, variant, schedule, steps, ckpt_dir):
    tapi = _models(arch, variant)[1]
    return run_training(tapi, _data()[1], AdamWConfig(lr=LR),
                        LoopConfig(total_steps=steps, schedule=schedule,
                                   ckpt_dir=ckpt_dir), device="cpu")


@pytest.mark.parametrize("arch,variant,schedule", [
    ("smollm-135m", "direct", "multiformat"),
    ("smollm-135m", "anchored", "interleaved"),
    ("qwen3-4b", "direct", "multiformat"),
    ("qwen3-4b", "anchored", "interleaved")])
def test_four_steps_match_jax(arch, variant, schedule, tmp_path):
    want = _jax_history(arch, variant, schedule, 4)
    got = _port_run(arch, variant, schedule, 4, _jax_init_checkpoint(
        tmp_path, arch, variant))["history"]
    assert [h["fmt_idx"] for h in got] == [h["fmt_idx"] for h in want]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=1e-4)
    np.testing.assert_allclose([h["grad_norm"] for h in got],
                               [h["grad_norm"] for h in want], rtol=1e-4)
    assert got[-1]["loss"] < got[0]["loss"]


@pytest.mark.parametrize("kind", ["multiformat", "interleaved", "fp",
                                  "single:2"])
@pytest.mark.parametrize("n,total", [(4, 8), (4, 2), (3, 10), (1, 3)])
def test_make_schedule_matches_jax(kind, n, total):
    np.testing.assert_array_equal(make_schedule(kind, n, total),
                                  jmake_schedule(kind, n, total))


@pytest.mark.parametrize("n_examples", [None, 5])
def test_batches_match_jax(n_examples):
    cfg = dict(vocab=1000, seq_len=33, global_batch=3, seed=2,
               n_examples=n_examples)
    jd, td = JDataset(JData(**cfg)), LMDataset(DataConfig(**cfg))
    for step in (0, 1, 7, 700):
        want, got = jd.batch_at(step), td.batch_at(step)
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


def test_checkpoint_restart_is_exact(tmp_path):
    case = ("smollm-135m", "anchored", "interleaved")
    straight = _port_run(*case, 4, _jax_init_checkpoint(
        tmp_path / "straight", *case[:2]))
    split = _jax_init_checkpoint(tmp_path / "split", *case[:2])
    first = _port_run(*case, 2, split)
    assert os.path.isdir(os.path.join(split, "step_000000002"))
    resumed = _port_run(*case, 4, split)
    assert [h["step"] for h in resumed["history"]] == [2, 3]
    assert [h["loss"] for h in first["history"] + resumed["history"]] == \
        [h["loss"] for h in straight["history"]]
    a, b = resumed["state"], straight["state"]
    assert (a.step, a.opt["step"]) == (b.step, b.opt["step"]) == (4, 4)
    for (k, x), (_, y) in zip(flatten_paths([a.params, a.opt["m"],
                                             a.opt["v"]]),
                              flatten_paths([b.params, b.opt["m"],
                                             b.opt["v"]])):
        assert torch.equal(x, y), k


def test_resumes_a_jax_training_checkpoint(tmp_path):
    """JAX trains 2 steps and checkpoints; the port resumes at step 2 and
    its steps 2 and 3 match JAX's uninterrupted run. The port's step-4
    checkpoint then restores in JAX."""
    arch, variant, schedule = "qwen3-4b", "direct", "multiformat"
    want = _jax_history(arch, variant, schedule, 4)
    _jax_history(arch, variant, schedule, 2, ckpt_dir=str(tmp_path))
    got = _port_run(arch, variant, schedule, 4, str(tmp_path))
    assert [h["step"] for h in got["history"]] == [2, 3]
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want[2:]], rtol=1e-4)
    japi, _, params, _ = _models(arch, variant)
    template = JTrainState(params, jinit_opt(params, JAdamW(lr=LR)),
                           jnp.zeros((), jnp.int32))
    state, manifest = jckpt.restore(str(tmp_path), template)
    assert int(manifest["step"]) == 4 and int(state.step) == 4
    port = dict(flatten_paths(got["state"].params))
    for k, x in _flat(state.params).items():
        np.testing.assert_array_equal(x, port[k].numpy())


def test_train_state_carries_across():
    arch = "smollm-135m"
    _, tapi, params, _ = _models(arch, "direct")
    opt = jinit_opt(params, JAdamW())
    opt = dict(opt, step=jnp.int32(7),
               m=jax.tree_util.tree_map(lambda p: p * 0.5, params))
    flat = _flat(JTrainState(params, opt, jnp.int32(9)))
    state = train_state_from_numpy(flat, tapi.cfg, device="cpu")
    assert (state.step, state.opt["step"]) == (9, 7)
    back = state_arrays(state)
    assert set(back) == set(flat)
    for k, x in flat.items():
        y = back[k]
        np.testing.assert_array_equal(
            x, y.numpy() if isinstance(y, torch.Tensor) else y)


def test_bf16_moments_round_trip_through_a_checkpoint(tmp_path):
    from repro_torch.checkpoint import io as tckpt
    _, tapi, _, flat = _models("smollm-135m", "direct")
    params = params_from_numpy(flat, tapi.cfg, device="cpu")
    opt = init_opt_state(params, AdamWConfig(moment_dtype=torch.bfloat16))
    opt["m"] = {**opt["m"], "embed": params["embed"].to(torch.bfloat16)}
    tckpt.save(str(tmp_path), 1, state_arrays(TrainState(params, opt, 1)))
    arrays, manifest = tckpt.restore(str(tmp_path))
    assert manifest["keys"][".opt['m']['embed']"]["dtype"] == "bfloat16"
    state = train_state_from_numpy(arrays, tapi.cfg, device="cpu")
    assert state.opt["m"]["embed"].dtype == torch.bfloat16
    assert torch.equal(state.opt["m"]["embed"], opt["m"]["embed"])


@pytest.mark.parametrize("variant", ["direct", "anchored"])
def test_microbatch_accumulation_equals_the_full_batch(variant):
    _, tapi, _, flat = _models("smollm-135m", variant)
    params = params_from_numpy(flat, tapi.cfg, device="cpu")
    cfg = AdamWConfig(lr=LR, grad_clip=None)
    batch = _tbatch(LMDataset(DataConfig(vocab=512, seq_len=SEQ,
                                         global_batch=4)).batch_at(1))
    outs = []
    for micro in (1, 2, 4):
        state = TrainState(params, init_opt_state(params, cfg), 0)
        outs.append(build_train_step(tapi, cfg, microbatch=micro)(
            state, batch, 1))
    (s1, m1) = outs[0]
    for s, m in outs[1:]:
        np.testing.assert_allclose(float(m["loss"]), float(m1["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(m1["grad_norm"]), rtol=1e-5)
        for (k, a), (_, b) in zip(flatten_paths(s.opt["m"]),
                                  flatten_paths(s1.opt["m"])):
            torch.testing.assert_close(a, b, rtol=1e-4,
                                       atol=1e-6 * float(b.abs().max()),
                                       msg=k)


def test_cosine_schedule_matches_jax():
    from repro.optim.adamw import cosine_schedule as jcosine
    from repro_torch.optim.adamw import cosine_schedule
    want, got = jcosine(100, warmup=10, floor=0.2), cosine_schedule(
        100, warmup=10, floor=0.2)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(got(step), float(want(jnp.int32(step))),
                                   rtol=1e-6)


def test_launcher_trains_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-135m", "--steps", "3", "--seq", "32", "--batch", "2",
         "--anchor", "mxint8", "--schedule", "interleaved", "--device",
         "cpu"], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "finished at step 3" in out.stdout
