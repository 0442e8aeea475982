"""The sequence-parallel residual stream (``ModelConfig.seq_sharding``,
``models/transformer.py::forward_hidden``) against JAX's and against the
port's own step with the flag off.

Under tensor parallelism over ``model`` the reference constrains the
residual stream at the end of each layer group to ``("batch", "seq_sp",
None)``, and ``seq_sp`` resolves to ``model`` where that axis divides S:
each process keeps its slice of the sequence of each group's saved input.
The port cuts the stream to this process's slice between groups and
gathers it at the start of each group (``TensorParallel.cut_seq`` /
``gather_seq``): bytes move, no arithmetic, so the step is the flag-off
step bit for bit.

- Reduced qwen3-4b at (1, 2) over two gloo processes
  (``tests/_torch_dist.py``), ``seq_sharding=True``: loss, CE, grad norm,
  gathered gradients, the first moment and the parameters after a step and
  a second step's loss and grad norm against JAX's single-device step, at
  ``tests/test_torch_sharded_train.py``'s tolerances (rtol 1e-4, atol
  1e-6 * max|x| per leaf); JAX's own sharded step with the flag on, on the
  (1, 2) host mesh, against the same oracle.
- Bit-identical to the port's flag-off step: reduced qwen3-4b, mixtral-8x7b
  (MoE) and rwkv6-7b (recurrent) at S 64, and qwen3-4b at S 63 (2 does not
  divide it) and S 1, where the flag is a no-op.
- The dry run over a fake world: at ``sp`` a rank's temp bytes fall by
  (tp - 1) / tp of the saved group inputs (the cut owns its storage), the
  extra all-gathers are three a group and two at the stack's ends, and at
  S 63 the trace issues the baseline's collectives; the ``sp`` trace's
  collectives, FLOPs and memory equal a real gloo step's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

from repro.configs import get_reduced as jreduced
from repro.core.formats import TRAIN_FORMATS_MXINT
from repro.core.qat import QATConfig as JQAT
from repro.launch.mesh import make_debug_mesh as jmesh
from repro.models import get_model as jget_model
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import init_opt_state as jinit_opt
from repro.train.state import TrainState as JTrainState
from repro.train.state import make_sharded_train_step as jsharded_step
from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.tree import flatten_paths
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import get_model
from _torch_dist import dryrun_cells_worker, sharded_jobs_worker, start_ranks
from test_torch_sharded_train import (FMT_IDX, LR, _check_case,
                                      _close_leaves, _close_params, _flat,
                                      _jax_oracle, _jax_setup)

DENSE, MOE, RECURRENT = "qwen3-4b", "mixtral-8x7b", "rwkv6-7b"
TP = ((1, 2), 1)
SP, OFF = {"seq_sharding": True}, {"seq_sharding": False}
# (name, arch, seq): the cases held bit for bit against the flag off
BIT_CASES = (("dense", DENSE, 64), ("moe", MOE, 64),
             ("recurrent", RECURRENT, 64), ("odd", DENSE, 63),
             ("one", DENSE, 1))


def _port_params(arch):
    """{path: numpy} of the port's seeded initial parameters."""
    api = get_model(get_reduced(arch))
    return {k: v.numpy() for k, v in
            flatten_paths(api.init_params(0, device="cpu"))}


def _batches(arch, s, b=4):
    """Two seeded batches of S ``s``, the first with masks that differ
    between the row halves."""
    cfg = get_reduced(arch)
    rng = np.random.default_rng(17)
    out = []
    for i in range(2):
        t = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        mask = np.ones((b, s), np.float32)
        if i == 0:
            mask[:b // 2, s // 2:] = 0.0
        out.append({"tokens": t, "labels": np.roll(t, -1, axis=1),
                    "mask": mask})
    return out


@pytest.fixture(scope="module")
def runs():
    """One gloo spawn for every port step (flag on and off per case) and
    one for the ``sp`` dry-run cell on real tensors, running while JAX's
    oracle and its sharded SP step compile here."""
    japi, jparams, jbatches = _jax_setup(DENSE)
    jobs = [(DENSE, [TP], _flat(jparams), jbatches, FMT_IDX, LR, None, SP)]
    for _, arch, s in BIT_CASES:
        flat = _flat(jparams) if (arch, s) == (DENSE, 64) \
            else _port_params(arch)
        batches = jbatches if (arch, s) == (DENSE, 64) else _batches(arch, s)
        jobs += [(arch, [TP], flat, batches, FMT_IDX, LR, None, over)
                 for over in (SP, OFF)]
    wait_steps = start_ranks(sharded_jobs_worker, 2, jobs)
    wait_dry = start_ranks(dryrun_cells_worker, 2, [(DENSE, "train", 64, 4)],
                           "sp")
    want = _jax_oracle(japi, jparams, jbatches)
    sp_api = jget_model(dataclasses.replace(jreduced(DENSE),
                                            seq_sharding=True),
                        JQAT(formats=TRAIN_FORMATS_MXINT))
    opt = JAdamW(lr=LR)
    jb = {k: jnp.asarray(v) for k, v in jbatches[0].items()}
    fn, _ = jsharded_step(sp_api, jmesh(1, 2), opt,
                          {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                           for k, v in jb.items()}, donate=False)
    st, m = fn(JTrainState(jparams, jinit_opt(jparams, opt), jnp.int32(0)),
               jb, jnp.int32(FMT_IDX))
    jax_sp = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
              "params": _flat(st.params)}
    steps = wait_steps()
    named = {"jax": [r[0] for r in steps]}
    for i, (name, _, _) in enumerate(BIT_CASES):
        named[name] = [(r[1 + 2 * i], r[2 + 2 * i]) for r in steps]
    return want, jax_sp, named, wait_dry()[0][0]


def test_sp_step_equals_jax_single_device(runs):
    want, _, named, _ = runs
    for rank, out in enumerate(named["jax"]):
        rec = out[TP]
        np.testing.assert_allclose(rec["losses"][0], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(rec["terms"]["ce"], want["terms"]["ce"],
                                   rtol=1e-4)
        _close_leaves(rec["grads"], want["grads"], f"rank {rank} grads")
        _check_case(rec, want, 1)


def test_jax_sharded_sp_step_equals_its_single_device_step(runs):
    """The reference's sharded step with ``seq_sharding`` on the (1, 2)
    host mesh, the port's other oracle."""
    want, jax_sp, named, _ = runs
    np.testing.assert_allclose([jax_sp["loss"], jax_sp["grad_norm"]],
                               [want[1]["loss"], want[1]["grad_norm"]],
                               rtol=1e-5)
    _close_params(jax_sp["params"], want[1], "JAX's sharded SP step")
    rec = named["jax"][0][TP]
    np.testing.assert_allclose([rec["losses"][0], rec["grad_norms"][0]],
                               [jax_sp["loss"], jax_sp["grad_norm"]],
                               rtol=1e-4)


@pytest.mark.parametrize("case", [c[0] for c in BIT_CASES])
def test_sp_step_is_bit_identical_to_the_flag_off(runs, case):
    """The gather and the cut move bytes only: every number of the step
    equals the flag-off step's bit for bit, in both processes (at S 63
    and S 1 the flag is a no-op)."""
    for on_rank, off_rank in runs[2][case]:
        on, off = on_rank[TP], off_rank[TP]
        assert on["losses"] == off["losses"]
        assert on["grad_norms"] == off["grad_norms"]
        assert on["terms"] == off["terms"]
        for part in ("grads", "params", "m"):
            assert on[part].keys() == off[part].keys()
            for k, v in on[part].items():
                np.testing.assert_array_equal(v, off[part][k],
                                              err_msg=f"{part} {k}")


def _traces(arch, s, layers=None, variants=("baseline", "sp")):
    cfg = get_reduced(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    with dryrun.fake_world(2):
        mesh = make_debug_mesh(1, 2)
        out = {v: dryrun.trace_cell(cfg, ShapeSpec("train", s, 4, "train"),
                                    mesh, v, device="cpu")
               for v in variants}
    assert not dist.is_initialized()
    return cfg, out


def _gathers(rec):
    return sum(c["kind"] == "all-gather" for c in rec["collective_records"])


def test_sp_trace_saves_the_group_inputs_share():
    """qwen3-4b reduced to d 64 at 8 layers, 4 x 256: the saved group
    inputs are 8 x 4 x 256 x 64 f32, and at ``sp`` a rank keeps half of
    each. The tracked peak falls by that half within 2 % (it falls by
    exactly that here: the peak is the backward's first recompute, with
    every saved input alive); a cut that kept a view of the whole
    sequence would save nothing."""
    cfg, rec = _traces(DENSE, 256, layers=8)
    saved = cfg.n_groups * 4 * 256 * cfg.d_model * 4
    drop = rec["baseline"]["memory"]["temp_size_in_bytes"] - \
        rec["sp"]["memory"]["temp_size_in_bytes"]
    assert abs(drop - saved / 2) <= 0.02 * saved / 2, (drop, saved / 2)
    # a gather at the start of each group, again in its recompute, and the
    # cut's backward per group; the cut before the stack's backward and
    # the gather after it
    assert _gathers(rec["sp"]) - _gathers(rec["baseline"]) == \
        3 * cfg.n_groups + 2
    assert rec["sp"]["flops"] == rec["baseline"]["flops"]


def test_sp_trace_is_the_baseline_where_2_does_not_divide_s():
    _, rec = _traces(DENSE, 63)
    assert rec["sp"]["collective_records"] == \
        rec["baseline"]["collective_records"]
    assert rec["sp"]["memory"] == rec["baseline"]["memory"]


def test_sp_collectives_equal_a_gloo_step(runs):
    real = runs[3]
    _, fake = _traces(DENSE, 64, variants=("sp",))
    fake = fake["sp"]
    assert fake["collective_records"] == real["collective_records"]
    assert _gathers(fake) > 4
    assert fake["flops"] == real["flops"]
    assert fake["memory"] == real["memory"]
