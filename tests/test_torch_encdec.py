"""The port's encoder-decoder family (``models/encdec.py``,
seamless-m4t-large-v2 reduced to 2 + 2 layers) against the JAX package.

The same numpy weights and ``frame_embeds`` in both, float32:

- ``train_loss`` (encoder over 24 frames, decoder over 32 tokens with
  cross attention) and every gradient, under direct MF-QAT at mxint2 and
  anchored at mxint4: rtol 1e-4 on the loss, rtol 1e-4 and atol 1e-6 *
  max|g| per leaf (``tests/test_torch_train.py``'s);
- ``prefill`` and three ``serve_step``s, and ``prefill_slot`` into slot 1
  of a two-slot cache, on the dense tree and on the packed mxint8 / mxint4
  trees through the dequant-GEMM dispatch (B1/B2's plain versions here),
  against the JAX package's densify serving (ROADMAP C.12: the reference
  has no qmm hook for the family): rtol 1e-4 / atol 1e-5;
- the anchor of the same weights, codes and scales bit-exact; the parameter
  tree's paths and shapes; the configs;
- the refusals: a paged cache says what the reference says; the port's
  engine refuses the config when it is built (ROADMAP C.12), where the
  reference's fused engine raises and its densify engine fails at the
  first admission with ``KeyError: 'frame_embeds'``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jreduced
from repro.core.anchor import make_anchor as jmake
from repro.core.anchor import materialize as jmaterialize
from repro.core.formats import TRAIN_FORMATS_MXINT
from repro.core.qat import QATConfig as JQAT
from repro.models import get_model as jget_model
from repro.serve.engine import ElasticEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve.packed_params import make_packed_fn
from repro.serve.packed_params import make_packed_params as jpacked
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.anchor import (AnchorModel, make_anchor,
                                     materialize)
from repro_torch.core.formats import get_format
from repro_torch.core.mx import MXTensor
from repro_torch.core.qat import QATConfig
from repro_torch.core.tree import flatten_paths
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.dispatch import make_qmm
from repro_torch.models import encdec, get_model
from repro_torch.serve.engine import ElasticEngine
from repro_torch.serve.packed_params import make_packed_params

ARCH = "seamless-m4t-large-v2"
SE = 24
TOL = dict(rtol=1e-4, atol=1e-5)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _to_port(j) -> AnchorModel:
    q = {k: MXTensor(codes=torch.from_numpy(np.array(t.codes)),
                     scale_exp=torch.from_numpy(np.array(t.scale_exp)),
                     fmt=get_format(t.fmt.name, t.fmt.block_size),
                     block_axis=t.block_axis)
         for k, t in j.quantized.items()}
    raw = {k: torch.from_numpy(np.array(w)) for k, w in j.raw.items()}
    return AnchorModel(quantized=q, raw=raw, fmt_name=j.fmt_name)


_MODELS = {}


def _model(qat=None):
    """(JAX api, JAX params, the JAX MXINT8 anchor) of reduced seamless,
    the head x 10 so the logits spread."""
    if qat not in _MODELS:
        api = jget_model(jreduced(ARCH), qat)
        params = jax.jit(api.init_params)(jax.random.PRNGKey(2))
        params = dict(params, lm_head=params["lm_head"] * 10)
        anc = jax.jit(lambda p: jmake(p, JQAT(anchor="mxint8")))(params)
        _MODELS[qat] = (api, params, anc)
    return _MODELS[qat]


def _frames(b, seed=5):
    return np.random.default_rng(seed).normal(
        size=(b, SE, 64)).astype(np.float32)


def test_configs_match_the_reference():
    for get, jget in ((get_config, jget_config), (get_reduced, jreduced)):
        mine, ref = get(ARCH), jget(ARCH)
        for f in dataclasses.fields(mine):
            if f.name == "compute_dtype":
                assert str(mine.compute_dtype).split(".")[-1] == \
                    jnp.dtype(ref.compute_dtype).name
            else:
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name


def test_param_tree_and_anchor_match_jax():
    _, params, ja = _model()
    cfg = get_reduced(ARCH)
    want = {k: v.shape for k, v in _flat(params).items()}
    tparams = params_from_numpy(_flat(params), cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in flatten_paths(tparams)} == want
    mine = {k: tuple(v.shape) for k, v in flatten_paths(
        get_model(cfg).init_params(0, device="cpu"))}
    assert mine == want
    assert "['decoder']['blocks'][0]['cross_attn']['wq']" in want
    assert "['encoder']['blocks'][0]['attn']['wo']" in want
    ta = make_anchor(tparams, QATConfig(anchor="mxint8"), device="cpu")
    assert set(ta.quantized) == set(ja.quantized)
    assert set(ta.raw) == set(ja.raw)
    assert len(ta.quantized) == 6 + 10      # no bias, gelu MLPs
    for k, j in ja.quantized.items():
        t = ta.quantized[k]
        np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes),
                                      err_msg=k)
        np.testing.assert_array_equal(t.scale_exp.numpy(),
                                      np.asarray(j.scale_exp), err_msg=k)


@pytest.mark.parametrize("idx,anchor", [(0, None), (1, "mxint8")])
def test_train_loss_and_grads_match_jax(idx, anchor):
    jqat = JQAT(formats=TRAIN_FORMATS_MXINT, anchor=anchor)
    japi, params, _ = _model(jqat)
    tapi = get_model(get_reduced(ARCH),
                     qat=QATConfig(formats=TRAIN_FORMATS_MXINT,
                                   anchor=anchor))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 512, size=(2, 32)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
             "frame_embeds": _frames(2)}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, b, i: japi.train_loss(p, b, i)[0]))(
        params, jax.tree_util.tree_map(jnp.asarray, batch), jnp.int32(idx))
    tparams = params_from_numpy(_flat(params), tapi.cfg, device="cpu")
    leaves = [(k, p.requires_grad_(True)) for k, p in flatten_paths(tparams)]
    loss_t, parts = tapi.train_loss(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, idx)
    grads_t = torch.autograd.grad(loss_t, [p for _, p in leaves])
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    assert parts["ce"] is loss_t
    want = _flat(grads_j)
    assert set(want) == {k for k, _ in leaves}
    for (k, _), g in zip(leaves, grads_t):
        np.testing.assert_allclose(
            g.numpy(), want[k], rtol=1e-4,
            atol=1e-6 * float(np.abs(want[k]).max()), err_msg=k)


@pytest.mark.parametrize("fmt", ["bf16", "mxint8", "mxint4"])
def test_prefill_and_decode_logits_match_jax(fmt):
    """Two 16-token prompts over 24 frames each, then three decode steps;
    then one request into slot 1 of a fresh two-slot cache."""
    japi, jparams, ja = _model()
    cfg = get_reduced(ARCH)
    api = get_model(cfg)
    ta = _to_port(ja)
    if fmt == "bf16":
        jw = jmaterialize(ja, jparams, dtype=jnp.float32)
        jpre, jstep = jax.jit(japi.prefill), jax.jit(japi.serve_step)
        jslot = jax.jit(japi.prefill_slot, static_argnums=3)
        tw, tapi = materialize(ta, dtype=torch.float32), api
    else:
        jw = jpacked(ja, jparams, target_fmt=fmt, dtype=jnp.float32)
        jpre = jax.jit(make_packed_fn(japi, japi.prefill))
        jstep = jax.jit(make_packed_fn(japi, japi.serve_step))
        jslot = jax.jit(make_packed_fn(japi, japi.prefill_slot),
                        static_argnums=3)
        tw = make_packed_params(ta, target_fmt=fmt, dtype=torch.float32)
        tapi = api.with_serving(make_qmm())
    rng = np.random.default_rng(2)
    b, s, max_len = 2, 16, 40
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    frames = _frames(b)
    jl, jc, jlen = jpre(jw, {"tokens": jnp.asarray(tokens),
                             "frame_embeds": jnp.asarray(frames)},
                        japi.init_cache(b, max_len, s_enc=SE))
    tc = tapi.init_cache(b, max_len, s_enc=SE, device="cpu")
    assert tc["blocks"][0]["ck"].shape == (2, b, SE, 4, 16)
    tl, tc, tlen = tapi.prefill(tw, {"tokens": torch.from_numpy(tokens),
                                     "frame_embeds": torch.from_numpy(frames)},
                                tc)
    np.testing.assert_array_equal(np.asarray(jlen), tlen.numpy())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = jstep(jw, {"tokens": jnp.asarray(nxt)}, jc, jlen)
        tl, tc = tapi.serve_step(tw, {"tokens": torch.from_numpy(nxt)}, tc,
                                 tlen)
        jlen, tlen = jlen + 1, tlen + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    one = {"tokens": tokens[1:], "frame_embeds": frames[1:]}
    jl1, _, jlen1 = jslot(jw, jax.tree_util.tree_map(jnp.asarray, one),
                          japi.init_cache(2, max_len, s_enc=SE), 1)
    tc = tapi.init_cache(2, max_len, s_enc=SE, device="cpu")
    tl1, tc, tlen1 = tapi.prefill_slot(
        tw, {k: torch.from_numpy(v) for k, v in one.items()}, tc, 1)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), **TOL)
    assert int(tlen1) == int(jlen1) == s
    assert not tc["blocks"][0]["k"][:, 0].any()
    with pytest.raises(ValueError, match="s_enc"):
        tapi.prefill(tw, {"tokens": torch.from_numpy(tokens),
                          "frame_embeds": torch.from_numpy(frames)},
                     tapi.init_cache(b, max_len, device="cpu"))


def test_refusals():
    japi, jparams, ja = _model()
    cfg = get_reduced(ARCH)
    with pytest.raises(ValueError) as mine:
        get_model(cfg).init_cache(1, 32, kv_layout="paged", device="cpu")
    with pytest.raises(ValueError) as ref:
        japi.init_cache(1, 32, kv_layout="paged")
    assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError, match="C.12"):
        ElasticEngine(get_model(cfg), _to_port(ja), batch_slots=2,
                      max_len=32, device="cpu")
    with pytest.raises(ValueError, match="no qmm hook"):
        JEngine(japi, ja, fused=True, param_template=jparams,
                batch_slots=2, max_len=32)
    jeng = JEngine(japi, ja, fused=False, param_template=jparams,
                   batch_slots=2, max_len=32)
    with pytest.raises(KeyError, match="frame_embeds"):
        jeng.generate([JRequest(0, np.arange(4, dtype=np.int32), 2)])
    assert encdec.make_model(cfg).mixed_step is None
