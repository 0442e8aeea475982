"""The port's evaluation harness (``train/harness.py``) against the
reference's (``benchmarks/_qat_harness.py``), for the reduced smollm-135m
and qwen3-4b.

The JAX harness runs in a temporary working directory, where its
``pretrained_base`` reads ``out/bench_base/<key>``, written here with the
reference's initial weights as the base (it takes the place of JAX's
pretraining run, a compile that tests nothing of the port); the port's
reads the same checkpoint (``cache_dir``), so both fine-tune the same
base. Then:

- ``train_variant``'s loss histories for plain multi-format MXINT (both
  archs) and for the interleaved mxfp8-anchored MXFP variant (smollm-135m,
  the arch the card runs it at: each JAX variant is a compile of its own)
  agree within rtol 1e-4 (the tolerance ``tests/test_torch_train.py``
  holds a few AdamW steps to);
- with JAX's trained weights carried in (``interop.params_from_numpy``),
  ``eval_ppl`` at each format, by PTQ and by anchor + Slice-and-Scale, and
  of the FP weights, agrees within rtol 1e-5, and PTQ at the anchor format
  equals the anchor route (the same weight values);
- ``eval_accuracy`` agrees within one token of the eval set;
- the port's own pretraining run writes its base under ``cache_dir`` and
  reads it back.
"""
import os
import sys

import jax
import numpy as np
import pytest

from repro.checkpoint import io as jckpt
from repro.configs import get_reduced as jget_reduced
from repro.models import get_model as jget_model
from repro_torch.core.tree import flatten_paths
from repro_torch.interop import params_from_numpy
from repro_torch.train import harness

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "benchmarks"))
import _qat_harness as jh  # noqa: E402

SMALL = dict(pretrain_steps=2, n_examples=8, seq_len=16, batch=4,
             n_eval_batches=2)
MXFP = dict(train_formats=("mxfp4", "mxfp6", "mxfp8"), anchor="mxfp8")
ARCHS = ("smollm-135m", "qwen3-4b")
MXFP_ARCH = "smollm-135m"
CASES = [(a, "mxint") for a in ARCHS] + [(MXFP_ARCH, "mxfp")]


def _flat(params):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per arch: each package's MXINT variant (and MXFP variant, for
    MXFP_ARCH) and the base."""
    out = {}
    for arch in ARCHS:
        root = tmp_path_factory.mktemp(arch)
        hc = jh.HarnessConfig(arch=arch, **SMALL)
        key = hc.cache_key()
        jh._BASE_CACHE.pop(key, None)
        init = jax.jit(jget_model(jget_reduced(arch)).init_params)(
            jax.random.PRNGKey(hc.seed))
        jckpt.save(str(root / "out" / "bench_base" / key),
                   hc.pretrain_steps, init, keep_n=1)
        cwd = os.getcwd()
        os.chdir(root)
        try:
            jint = jh.train_variant(jh.HarnessConfig(arch=arch, **SMALL),
                                    "multiformat")
            jfp = jh.train_variant(jh.HarnessConfig(
                arch=arch, **SMALL, **MXFP), "interleaved") \
                if arch == MXFP_ARCH else None
        finally:
            os.chdir(cwd)
        cache = str(root / "out" / "bench_base")
        harness._BASE_CACHE.clear()
        tint = harness.train_variant(
            harness.HarnessConfig(arch=arch, **SMALL), "multiformat",
            cache_dir=cache, device="cpu")
        tfp = harness.train_variant(
            harness.HarnessConfig(arch=arch, **SMALL, **MXFP),
            "interleaved", cache_dir=cache, device="cpu") \
            if arch == MXFP_ARCH else None
        out[arch] = {"mxint": (jint, tint), "mxfp": (jfp, tfp),
                     "base": (jh._BASE_CACHE[key], cache)}
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_base_comes_from_the_reference_checkpoint(runs, arch):
    jbase, cache = runs[arch]["base"]
    hc = harness.HarnessConfig(arch=arch, **SMALL)
    assert os.path.isdir(os.path.join(cache, hc.cache_key()))
    got = harness.pretrained_base(hc, cache_dir=cache, device="cpu")
    want = params_from_numpy(_flat(jbase), hc.model_config(), device="cpu")
    for (p, a), (q, b) in zip(flatten_paths(got), flatten_paths(want)):
        assert p == q and bool((a == b).all()), p


@pytest.mark.parametrize("arch,kind", CASES)
def test_train_variant_losses_match_the_reference(runs, arch, kind):
    j, t = runs[arch][kind]
    assert len(t["history"]) == len(j["history"]) == \
        2 * (4 if kind == "mxint" else 3)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in t["history"]],
                                   [h[key] for h in j["history"]],
                                   rtol=1e-4, err_msg=key)


def _hcs(arch, kind):
    extra = MXFP if kind == "mxfp" else {}
    return (jh.HarnessConfig(arch=arch, **SMALL, **extra),
            harness.HarnessConfig(arch=arch, **SMALL, **extra))


@pytest.mark.parametrize("arch,fmt", [
    (a, f) for a in ARCHS
    for f in [None, "mxint2", "mxint4", "mxint6", "mxint8"]] + [
    (MXFP_ARCH, f) for f in ["mxfp4", "mxfp6", "mxfp8"]])
def test_eval_ppl_matches_the_reference(runs, arch, fmt):
    kind = "mxfp" if fmt and fmt.startswith("mxfp") else "mxint"
    j, t = runs[arch][kind]
    jhc, thc = _hcs(arch, kind)
    params = params_from_numpy(_flat(j["params"]), t["cfg"], device="cpu")
    # both packages evaluate through their plain MXINT variant's api (its
    # train_loss(..., None) is the pass-through branch): one jitted CE per
    # arch on the JAX side
    japi, tapi = (a["api"] for a in runs[arch]["mxint"])
    for ss in ((False,) if fmt is None else (False, True)):
        want = jh.eval_ppl(j["cfg"], japi, j["params"], fmt, jhc,
                           use_anchor_ss=ss)
        got = harness.eval_ppl(t["cfg"], tapi, params, fmt, thc,
                               use_anchor_ss=ss)
        assert np.isfinite(got) and got > 1.0
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=str(ss))
    if fmt in ("mxint8", "mxfp8"):
        ptq = harness.eval_ppl(t["cfg"], t["api"], params, fmt, thc)
        ss = harness.eval_ppl(t["cfg"], t["api"], params, fmt, thc,
                              use_anchor_ss=True)
        assert abs(ptq - ss) <= 1e-6 * ptq


@pytest.mark.parametrize("fmt", [None, "mxint4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_eval_accuracy_matches_the_reference(runs, arch, fmt):
    j, t = runs[arch]["mxint"]
    jhc, thc = _hcs(arch, "mxint")
    params = params_from_numpy(_flat(j["params"]), t["cfg"], device="cpu")
    want = jh.eval_accuracy(j["cfg"], j["api"], j["params"], fmt, jhc)
    got = harness.eval_accuracy(t["cfg"], t["api"], params, fmt, thc)
    one_token = 1.0 / (thc.n_eval_batches * thc.batch * thc.seq_len)
    assert 0.0 <= got <= 1.0 and abs(got - want) <= one_token


def test_port_pretraining_writes_and_reads_its_base(tmp_path):
    hc = harness.HarnessConfig(arch="smollm-135m", pretrain_steps=1,
                               seq_len=16)
    harness._BASE_CACHE.clear()
    trained = harness.pretrained_base(hc, cache_dir=str(tmp_path),
                                      device="cpu")
    harness._BASE_CACHE.clear()
    again = harness.pretrained_base(hc, cache_dir=str(tmp_path),
                                    device="cpu")
    assert os.listdir(tmp_path) == [hc.cache_key()]
    for (p, a), (q, b) in zip(flatten_paths(trained), flatten_paths(again)):
        assert p == q and bool((a == b).all()), p
