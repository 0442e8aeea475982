"""Tensor-parallel training of jamba, rwkv6-7b, llava and seamless against
JAX.

The port's sharded step (``train/state.py::make_sharded_train_step``) at
(1, 2) in two gloo processes (``tests/_torch_dist.py``), on each reduced
config with MF-QAT at mxint4 alone, against JAX's single-device step of
the same config from the same weights (``test_torch_sharded_train.py::
_jax_oracle``, one compile per config; jamba's takes tens of seconds here
even cut to two layers, so no JAX sharded step is compiled in this file).
The first batch's masks differ between the two row halves. Tolerances as
``test_torch_sharded_train.py``'s.

- jamba (two layers, as its published layers 3-4: Mamba + MoE, attention
  + MLP): the Mamba block with ``d_inner`` on ``model`` (the fused
  ``in_proj`` gathered and both halves' channels taken, ``x_proj`` /
  ``out_proj`` row-parallel), the attention layer and the expert-parallel
  MoE layer;
- rwkv6-7b: heads on ``model`` (the time mix's WKV per local head, the
  channel mix's receptance gathered);
- llava: the vision prefix ahead of the sharded stack, the loss over the
  text positions;
- seamless: both stacks and the cross attention on local heads;
- loss, CE, aux, the gathered gradients, the first moment and the updated
  parameters after one step, a second step's loss and grad norm; every
  leaf of the state that ``model`` replicates bit-equal across the two
  ranks after the step; the shard dims each process ran; and the guard
  that refuses a ``model`` axis a cut dim does not divide, naming it.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.core.formats import TRAIN_FORMATS_MXINT
from repro_torch.core.qat import QATConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models import get_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.state import make_sharded_train_step
from _torch_dist import sharded_jobs_worker, start_ranks
from test_torch_sharded_train import (LR, _close_leaves, _close_params,
                                      _flat, _jax_oracle, _jax_setup)

ARCHS = ("jamba-1.5-large-398b", "rwkv6-7b", "llava-next-mistral-7b",
         "seamless-m4t-large-v2")
SHAPE = (1, 2)
# jamba's reduced stack cut to one group of two layers, as its published
# layers 3-4 run (Mamba + MoE, then attention + MLP): every kind of layer,
# in half the reduced config's compile (``dataclasses.replace`` in both
# packages)
OVER = {"jamba-1.5-large-398b": dict(n_layers=2, scan_group=2, attn_every=2,
                                     attn_offset=1, moe_every=2,
                                     moe_offset=0)}
# MF-QAT over one format (JAX traces a branch of its format switch per
# format and projection; the sharded forward's fake-quant does not depend
# on which format it runs)
FORMATS = ("mxint4",)


@pytest.fixture(scope="module")
def families():
    """Each family's JAX oracle and the two processes' records, the
    processes running every family in one spawn while JAX compiles."""
    setups = {a: _jax_setup(a, OVER.get(a), FORMATS) for a in ARCHS}
    wait = start_ranks(sharded_jobs_worker, 2, [
        (a, [(SHAPE, 1)], _flat(setups[a][1]), setups[a][2], 0, LR, None,
         OVER.get(a), FORMATS) for a in ARCHS])
    want = {a: _jax_oracle(*setups[a], fmt_idx=0) for a in ARCHS}
    got = wait()
    return setups, want, {a: [out[i][SHAPE, 1] for out in got]
                          for i, a in enumerate(ARCHS)}


@pytest.mark.parametrize("arch", ARCHS)
def test_family_tensor_parallel_step_equals_jax(families, arch):
    setups, want, got = families
    w = want[arch]
    m = setups[arch][2][0]["mask"]
    half = m.reshape(2, -1).sum(axis=1)
    assert half[0] < half[1] / 2            # the row halves' masks differ
    for rank, rec in enumerate(got[arch]):
        np.testing.assert_allclose(rec["losses"][0], w["loss"], rtol=1e-4)
        for term, val in w["terms"].items():
            np.testing.assert_allclose(rec["terms"][term], val, rtol=1e-4,
                                       err_msg=term)
        _close_leaves(rec["grads"], w["grads"], f"{arch} rank {rank} grads")
        np.testing.assert_allclose(rec["grad_norms"][0], w[1]["grad_norm"],
                                   rtol=1e-4)
        np.testing.assert_allclose([rec["losses"][1], rec["grad_norms"][1]],
                                   w[1]["second"], rtol=1e-4)
        _close_params(rec["params"], w[1], f"{arch} params")
        _close_leaves(rec["m"], w[1]["m"], f"{arch} first moment")
        assert rec["step"] == (1, 1)


# a leaf each family replicates over ``model`` that feeds per-rank work
# through ``copy_in`` (or, the norms, through replicated work only)
REPLICATED = {"jamba-1.5-large-398b": "['moe']['router']",
              "rwkv6-7b": "['rwkv']['decay_w1']",
              "llava-next-mistral-7b": "['mixer_norm']",
              "seamless-m4t-large-v2": "['encoder']['final_norm']"}


@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_leaves_bit_equal_across_model_ranks(families, arch):
    """After the step, every leaf of the state that ``model`` replicates
    (RWKV's ``mix_*``, ``decay_w1``, ``ln_scale``; the routers, the norms;
    their moments) is bit-equal in both processes."""
    _, _, got = families
    a, b = (rec["replicated"] for rec in got[arch])
    assert any(REPLICATED[arch] in k for k in a)
    assert a.keys() == b.keys()
    for k, v in a.items():
        assert np.array_equal(v, b[k]), k


def _mesh(n_model):
    """A (1, n_model) mesh seen from its process 0; the step is built, no
    collective runs (the group is a stand-in)."""
    return Mesh(np.arange(n_model).reshape(1, n_model), ("data", "model"),
                group="model axis", coords={"data": 0, "model": 0})


@pytest.mark.parametrize("arch,want", [
    ("jamba-1.5-large-398b", dict(n_heads=2, n_kv_heads=1, d_inner=64,
                                  experts=2, moe="experts")),
    ("rwkv6-7b", dict(rwkv_heads=2)),
    ("llava-next-mistral-7b", dict(n_heads=2, n_kv_heads=1)),
    ("seamless-m4t-large-v2", dict(n_heads=2, n_kv_heads=2))])
def test_shard_dims_from_the_resolved_specs(arch, want):
    step, _ = make_sharded_train_step(get_model(get_reduced(arch)), _mesh(2),
                                      AdamWConfig(), {"tokens": (4, 64)})
    dims = dataclasses.asdict(step.tensor_parallel.dims)
    assert {k: dims[k] for k in want} == want


@pytest.mark.parametrize("arch,over,n_model,named", [
    ("rwkv6-7b", {}, 3, "rwkv heads"),
    ("jamba-1.5-large-398b", {"d_model": 48}, 2, "d_inner"),
    ("mixtral-8x7b", {"moe_experts": 3, "d_ff": 96}, 2, "moe_experts"),
    ("seamless-m4t-large-v2", {"n_kv_heads": 3, "n_heads": 3,
                               "head_dim": 16}, 2, "n_kv_heads")])
def test_model_axis_refuses_an_indivisible_dim(arch, over, n_model, named):
    """A dim the forward cuts that ``model`` does not divide, or whose
    row-parallel shard is not whole MX blocks of 32 (jamba's d_inner 96
    over 2; mixtral's 3 experts over 2 with each expert's d_ff 96 over 2),
    is refused by name."""
    api = get_model(dataclasses.replace(get_reduced(arch), **over),
                    QATConfig(formats=TRAIN_FORMATS_MXINT))
    with pytest.raises(ValueError, match=named):
        make_sharded_train_step(api, _mesh(n_model), AdamWConfig(),
                                {"tokens": (4, 64)})


# the published configs the production mesh's ``model`` axis of 16 cannot
# cut, and the dims that stop it
AT_16_REFUSED = {"qwen2-72b": "d_ff", "smollm-135m": "n_heads",
                 "starcoder2-3b": "n_heads"}


@pytest.mark.parametrize("arch", list_archs())
def test_production_model_axis_of_16(arch):
    """The reference's production mesh's ``model`` axis of 16
    (``repro/launch/mesh.py::make_production_mesh``, (16, 16)):
    every published config whose cut dims it divides builds the sharded
    step (the kv heads of the 8-kv-head configs gathered), the rest are
    refused by name."""
    api = get_model(get_config(arch), QATConfig(formats=TRAIN_FORMATS_MXINT))
    if arch in AT_16_REFUSED:
        with pytest.raises(ValueError, match=AT_16_REFUSED[arch]):
            make_sharded_train_step(api, _mesh(16), AdamWConfig(),
                                    {"tokens": (16, 64)})
        return
    step, _ = make_sharded_train_step(api, _mesh(16), AdamWConfig(),
                                      {"tokens": (16, 64)})
    assert step.tensor_parallel.dims.kv_gather == (
        api.cfg.family != "ssm" and api.cfg.n_kv_heads < 16)
