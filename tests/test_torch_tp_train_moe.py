"""Tensor-parallel training of the MoE family (mixtral) against JAX.

The port runs one process per shard (``train/state.py::
make_sharded_train_step``; gloo processes on the host through
``tests/_torch_dist.py``), its MoE layer routed by every process over the
global experts (``models/layers.py::moe_block``). The oracle is JAX's
single-device step of the same reduced config from the same weights
(``test_torch_sharded_train.py::_jax_oracle``: ``value_and_grad`` of
``train_loss`` and ``build_train_step``'s update, one compile per config),
and JAX's own sharded step on the (1, 2) host mesh is held to the port's as
well. Tolerances are those of ``test_torch_sharded_train.py`` (rtol 1e-4,
atol 1e-6 x max|x| per leaf; the updated parameters through AdamW's first
step).

- reduced mixtral-8x7b at (1, 2): 4 experts, 2 a process (expert-parallel,
  ``experts`` on ``model``);
- the same at (2, 2) in 4 processes: the Switch fractions summed over
  ``data`` and not over ``model``;
- ``moe_experts=3, n_kv_heads=1`` (``dataclasses.replace`` in both
  packages) at (1, 2): 3 experts do not divide 2, so the rules give
  ``model`` to each expert's d_ff (FFN-parallel, ``w_down``
  row-parallel), and each process holds half of the one kv head's
  columns (gathered: ``ShardDims.kv_gather``), the regime mixtral's 8
  experts and 8 kv heads meet on the production mesh's ``model`` axis of
  16;
- loss, CE, aux, the gathered gradients, the first moment and the updated
  parameters after one step, a second step's loss and grad norm, and every
  leaf of the state that ``model`` replicates bit-equal across the model
  ranks after the step;
- the shard dims the resolved specs give the published configs on meshes
  of ``model`` 2 to 16 (mixtral-8x7b's 8 experts expert-parallel up to 8,
  FFN-parallel at 16; jamba's 16 expert-parallel at 16; 8 kv heads
  gathered at 16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.launch.mesh import make_debug_mesh as jmesh
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import init_opt_state as jinit_opt
from repro.train.state import TrainState as JTrainState
from repro.train.state import make_sharded_train_step as jsharded_step
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models import get_model, shard_dims
from repro_torch.train.state import state_shardings
from _torch_dist import sharded_jobs_worker, start_ranks
from test_torch_sharded_train import (FMT_IDX, LR, _close_leaves,
                                      _close_params, _flat, _jax_oracle,
                                      _jax_setup)

MOE = "mixtral-8x7b"
CASES = {"expert-parallel": (None, (1, 2)),
         "ffn-parallel": ({"moe_experts": 3, "n_kv_heads": 1}, (1, 2)),
         "data x expert": (None, (2, 2))}


@pytest.fixture(scope="module")
def moe():
    """Every case's JAX oracle and the port's records: the (1, 2) cases in
    one spawn of two processes, the (2, 2) one in a spawn of four, both
    running while JAX compiles."""
    setups = {k: _jax_setup(MOE, over) for k, (over, _) in CASES.items()
              if k != "data x expert"}
    setups["data x expert"] = setups["expert-parallel"]

    def job(name):
        over, shape = CASES[name]
        _, params, batches = setups[name]
        return (MOE, [(shape, 1)], _flat(params), batches, FMT_IDX, LR,
                None, over)

    two = start_ranks(sharded_jobs_worker, 2,
                      [job("expert-parallel"), job("ffn-parallel")])
    four = start_ranks(sharded_jobs_worker, 4, [job("data x expert")])
    want = {k: _jax_oracle(*setups[k]) for k in ("expert-parallel",
                                                 "ffn-parallel")}
    want["data x expert"] = want["expert-parallel"]
    got2, got4 = two(), four()
    got = {"expert-parallel": [r[0] for r in got2],
           "ffn-parallel": [r[1] for r in got2],
           "data x expert": [r[0] for r in got4]}
    return setups, want, got


def _rec(out, name):
    return out[CASES[name][1], 1]


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_tensor_parallel_step_equals_jax(moe, name):
    _, want, got = moe
    w = want[name]
    assert w["terms"]["aux"] > 0
    for rank, out in enumerate(got[name]):
        rec = _rec(out, name)
        np.testing.assert_allclose(rec["losses"][0], w["loss"], rtol=1e-4)
        for term in ("ce", "aux"):
            np.testing.assert_allclose(rec["terms"][term], w["terms"][term],
                                       rtol=1e-4, err_msg=term)
        _close_leaves(rec["grads"], w["grads"], f"{name} rank {rank} grads")
        np.testing.assert_allclose(rec["grad_norms"][0], w[1]["grad_norm"],
                                   rtol=1e-4)
        np.testing.assert_allclose([rec["losses"][1], rec["grad_norms"][1]],
                                   w[1]["second"], rtol=1e-4)
        _close_params(rec["params"], w[1], f"{name} params")
        _close_leaves(rec["m"], w[1]["m"], f"{name} first moment")
        assert rec["step"] == (1, 1)


def test_switch_fractions_summed_over_data_not_model(moe):
    """At (2, 2) each process holds half the rows and half the experts:
    the balance loss is a product of the whole batch's means, each mean
    taken over ``data`` only (over ``model`` too it would be 4x)."""
    _, want, got = moe
    aux = [_rec(out, "data x expert")["terms"]["aux"]
           for out in got["data x expert"]]
    np.testing.assert_allclose(aux, [want["data x expert"]["terms"]["aux"]]
                               * 4, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(CASES))
def test_replicated_leaves_bit_equal_across_model_ranks(moe, name):
    """Every leaf of the state that ``model`` replicates (the router, the
    norms, their moments) is bit-equal across the model ranks after a
    step: a missing ``copy_in`` leaves each rank its own part of such a
    gradient, and AdamW would move the replicas apart silently."""
    _, _, got = moe
    recs = [_rec(out, name)["replicated"] for out in got[name]]
    assert any("['router']" in k for k in recs[0])
    n_model = CASES[name][1][1]
    for rank, rec in enumerate(recs):
        peer = recs[rank - rank % n_model]      # the row's model rank 0
        assert rec.keys() == peer.keys()
        for k, v in rec.items():
            assert np.array_equal(v, peer[k]), (name, rank, k)


def test_jax_sharded_step_equals_the_port(moe):
    """JAX's own sharded step on the (1, 2) host mesh (GSPMD cuts the
    experts over ``model``) computes what the port's (1, 2) step does."""
    setups, want, got = moe
    japi, params, batches = setups["expert-parallel"]
    opt = JAdamW(lr=LR)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    fn, _ = jsharded_step(japi, jmesh(1, 2), opt,
                          {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                           for k, v in jb.items()}, donate=False)
    state = JTrainState(params, jinit_opt(params, opt), jnp.int32(0))
    st, m = fn(state, jb, jnp.int32(FMT_IDX))
    rec = _rec(got["expert-parallel"][0], "expert-parallel")
    np.testing.assert_allclose([float(m["loss"]), float(m["grad_norm"])],
                               [rec["losses"][0], rec["grad_norms"][0]],
                               rtol=1e-4)
    _close_params(rec["params"], {**want["expert-parallel"][1],
                                  "params": _flat(st.params)},
                  "the port against JAX's sharded step")


def _shard_dims(arch, n_model, rank=0):
    mesh = Mesh(np.arange(n_model).reshape(1, n_model), ("data", "model"))
    cfg = get_config(arch)
    return shard_dims(cfg, state_shardings(get_model(cfg), mesh)[0], rank,
                      n_model)


@pytest.mark.parametrize("arch,n_model,moe_axis,experts", [
    ("mixtral-8x7b", 2, "experts", 4), ("mixtral-8x7b", 4, "experts", 2),
    ("mixtral-8x7b", 8, "experts", 1), ("mixtral-8x7b", 16, "mlp", 8),
    ("mixtral-8x22b", 16, "mlp", 8),
    ("jamba-1.5-large-398b", 16, "experts", 1)])
def test_published_moe_cut_follows_the_rules(arch, n_model, moe_axis,
                                            experts):
    """The rules give ``model`` to the experts where it divides them, else
    to each expert's d_ff; the last process's experts start at its rank's
    offset."""
    last = _shard_dims(arch, n_model, rank=n_model - 1)
    assert (last.moe, last.experts) == (moe_axis, experts)
    assert last.expert_offset == (
        (n_model - 1) * experts if moe_axis == "experts" else 0)
    cfg = get_config(arch)
    assert last.n_heads * n_model == cfg.n_heads
    assert last.kv_gather == (n_model > cfg.n_kv_heads)
    assert last.n_kv_heads == max(1, cfg.n_kv_heads // n_model)
    assert last.kv_offset == ((n_model - 1) * cfg.n_kv_heads // n_model
                              if last.kv_gather else 0)
