"""The port's MoE family (``models/layers.py::moe_block``, the mixtral
configs, 4-D expert leaves) against the JAX package.

Reduced configs, float32, the same numpy weights in both:

- ``moe_block`` at capacity 8.0 (no drop) and 0.5 (drops) against JAX's on
  the same inputs, output and aux loss: rtol 2e-5, atol 2e-5, the
  reference's own tolerance in ``tests/test_moe.py``;
- planted ties in both top-k's (the router's logits and the per-expert
  capacity pick, where every token routed elsewhere ties at gate 0): the
  lower index first, as ``jax.lax.top_k``, token for token equal picks;
- prefill and three decode steps of reduced mixtral-8x7b and mixtral-8x22b
  (window 32, prompts of 48 tokens so the window bites) on the dense
  tree and packed at mxint8 / mxint4 through the dispatch: rtol 1e-4, atol
  1e-5, as ``tests/test_torch_model.py``;
- prefill of s + 1 tokens equals prefill of s then one decode step at a
  no-drop capacity (the reference's ``test_decode_consistency_with_prefill``
  tolerance, rtol 1e-4 / atol 1e-4);
- ``train_loss``, its aux term and every gradient, the router's included,
  under direct and anchored MF-QAT: rtol 1e-4 on the loss, rtol 1e-4 and
  atol 1e-6 * max|g| per leaf on the gradients, as
  ``tests/test_torch_train.py``;
- the anchor's 4-D expert codes and scales, their Slice-and-Scale
  conversions (mxint8 -> mxint6 / mxint4 split-N, mxfp8 -> mxfp4) and the
  packed serving tree: bit-exact;
- the dispatch contract on one expert's 2-D slice: the kernel mode's plain
  version against densify, rtol 1e-5 / atol 1e-4 (``tests/test_kernels_
  dispatch.py``'s);
- the cost model's MoE terms equal the reference's for both configs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jreduced
from repro.core.anchor import convert as jconvert
from repro.core.anchor import make_anchor as jmake
from repro.core.anchor import materialize as jmaterialize
from repro.core.formats import TRAIN_FORMATS_MXINT
from repro.core.formats import get_format as jget_format
from repro.core.qat import QATConfig as JQAT
from repro.launch import costmodel as jcm
from repro.models import get_model as jget_model
from repro.models.common import ModelConfig as JConfig
from repro.models.common import QuantCtx as JCtx
from repro.models.layers import moe_block as jmoe
from repro.serve.packed_params import make_packed_fn
from repro.serve.packed_params import make_packed_params as jpacked
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.core.anchor import AnchorModel, convert, make_anchor
from repro_torch.core.anchor import materialize
from repro_torch.core.formats import get_format
from repro_torch.core.mx import MXTensor
from repro_torch.core.qat import QATConfig
from repro_torch.core.tree import flatten_paths
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.dispatch import make_qmm, qmatmul
from repro_torch.launch import costmodel as cm
from repro_torch.models.common import ModelConfig, QuantCtx
from repro_torch.models.layers import moe_block
from repro_torch.models.transformer import make_model, param_shapes
from repro_torch.serve.packed_params import (PackedInt4Leaf, layer_slice,
                                             make_packed_params)

ARCHS = ("mixtral-8x7b", "mixtral-8x22b")
TOL = dict(rtol=1e-4, atol=1e-5)
EXPERTS = ("['w_gate']", "['w_up']", "['w_down']")


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


def _model(arch, qat=None, anchor="mxint8"):
    """(JAX api, JAX params, the JAX anchor at ``anchor``)."""
    key = (arch, qat, anchor)
    if key not in _MODELS:
        api = jget_model(jreduced(arch), qat)
        params = jax.jit(api.init_params)(jax.random.PRNGKey(1))
        anc = jax.jit(lambda p: jmake(p, JQAT(anchor=anchor)))(params)
        _MODELS[key] = (api, params, anc)
    return _MODELS[key]


# =============================================================================
# moe_block
# =============================================================================
def _block_cfgs(cf):
    kw = dict(name="t", family="moe", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab=64, moe_experts=4, moe_topk=2,
              capacity_factor=cf)
    return (ModelConfig(compute_dtype=torch.float32, **kw),
            JConfig(compute_dtype=jnp.float32, **kw))


def _block_params(seed=0, e=4, d=32, f=64):
    rng = np.random.default_rng(seed)
    return {"router": (rng.normal(size=(d, e)) * 0.1).astype(np.float32),
            "experts": {
                "w_gate": (rng.normal(size=(e, d, f)) * 0.1).astype(
                    np.float32),
                "w_up": (rng.normal(size=(e, d, f)) * 0.1).astype(np.float32),
                "w_down": (rng.normal(size=(e, f, d)) * 0.1).astype(
                    np.float32)}}


def _both(p, x, cf):
    cfg, jcfg = _block_cfgs(cf)
    tp = jax.tree_util.tree_map(torch.from_numpy, p)
    got, aux = moe_block(QuantCtx(), torch.from_numpy(x), tp, cfg, "moe")
    want, jaux = jmoe(JCtx(), jnp.asarray(x),
                      jax.tree_util.tree_map(jnp.asarray, p), jcfg, "moe")
    return got, aux, np.asarray(want), float(jaux)


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_block_matches_jax(cf):
    """No drop (8.0) and drops (0.5): output and aux loss."""
    p = _block_params()
    x = np.random.default_rng(1).normal(size=(3, 16, 32)).astype(np.float32)
    got, aux, want, jaux = _both(p, x, cf)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(aux.item(), jaux, rtol=2e-5, atol=2e-5)
    assert aux.item() > 0


def test_moe_block_drops_tokens_at_low_capacity():
    """At capacity 0.5 some routed tokens are dropped: the output differs
    from the no-drop one, in both packages alike."""
    p = _block_params()
    x = np.random.default_rng(2).normal(size=(2, 32, 32)).astype(np.float32)
    low, _, want_low, _ = _both(p, x, 0.5)
    full, _, _, _ = _both(p, x, 8.0)
    assert not np.allclose(low.numpy(), full.numpy())
    np.testing.assert_allclose(low.numpy(), want_low, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("cf", [8.0, 1.0, 0.5])
def test_planted_ties_keep_the_lower_index_first(cf):
    """Rows of x that repeat give equal router logits and gates, and a
    router with two equal columns gives equal logits within a token: both
    top-k's see ties, and the capacity pick sees every token routed
    elsewhere tie at gate 0. Outputs equal JAX's to the tolerance, and the
    picks are the same tokens."""
    p = _block_params(seed=3)
    p["router"][:, 2] = p["router"][:, 1]          # expert 1 ties expert 2
    rng = np.random.default_rng(4)
    base = rng.normal(size=(2, 4, 32)).astype(np.float32)
    x = np.repeat(base, 4, axis=1)                 # each token 4 times
    got, aux, want, jaux = _both(p, x, cf)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(aux.item(), jaux, rtol=2e-5, atol=2e-5)
    # the picks themselves, against jax.lax.top_k
    from repro_torch.models.layers import _topk_stable
    logits = x @ p["router"]
    vals, idx = _topk_stable(torch.from_numpy(logits), 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(logits), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    prio = np.zeros((2, 4, 16), np.float32)
    prio[:, 1, ::3] = 0.5                          # ties at 0.5 and at 0
    _, tidx = _topk_stable(torch.from_numpy(prio), 6)
    _, jtidx = jax.lax.top_k(jnp.asarray(prio), 6)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jtidx))


# =============================================================================
# The mixtral configs and their trees
# =============================================================================
def test_configs_match_the_reference():
    assert {"mixtral-8x7b", "mixtral-8x22b"} <= set(list_archs())
    assert len(list_archs()) == 10
    for arch in ARCHS:
        for get, jget in ((get_config, jget_config),
                          (get_reduced, jreduced)):
            mine, ref = get(arch), jget(arch)
            for f in dataclasses.fields(mine):
                if f.name == "compute_dtype":
                    assert str(mine.compute_dtype).split(".")[-1] == \
                        jnp.dtype(ref.compute_dtype).name
                else:
                    assert getattr(mine, f.name) == getattr(ref, f.name), \
                        (arch, f.name)
    assert get_reduced("mixtral-8x7b").sliding_window == 32


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(arch):
    _, params, _ = _model(arch)
    want = {k: v.shape for k, v in _flat(params).items()}
    tparams = params_from_numpy(_flat(params), get_reduced(arch),
                                device="cpu")
    assert {k: tuple(v.shape) for k, v in flatten_paths(tparams)} == want
    moe = param_shapes(get_reduced(arch))["blocks"][0]["moe"]
    assert moe["router"] == ((2, 64, 4), 0.02)
    assert moe["experts"]["w_down"] == ((2, 4, 128, 64), 0.02 / 2 ** 0.5)


@pytest.mark.parametrize("fmt", ["bf16", "mxint8", "mxint4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch, fmt):
    """Prefill of two right-padded 48-token prompts (the window of 32
    bites), then three decode steps, against JAX."""
    japi, jparams, ja = _model(arch)
    cfg = get_reduced(arch)
    api = make_model(cfg)
    ta = _to_port(ja)
    if fmt == "bf16":
        jw = jmaterialize(ja, jparams, dtype=jnp.float32)
        jpre, jstep = jax.jit(japi.prefill), jax.jit(japi.serve_step)
        tw, tapi = materialize(ta, dtype=torch.float32), api
    else:
        jw = jpacked(ja, jparams, target_fmt=fmt, dtype=jnp.float32)
        jpre = jax.jit(make_packed_fn(japi, japi.prefill))
        jstep = jax.jit(make_packed_fn(japi, japi.serve_step))
        tw = make_packed_params(ta, target_fmt=fmt, dtype=torch.float32)
        tapi = api.with_qmm(make_qmm())
    rng = np.random.default_rng(2)
    b, s, max_len = 2, 48, 64
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    lengths = np.array([s, 37], np.int32)
    jl, jc, jlen = jpre(jw, {"tokens": jnp.asarray(tokens),
                             "lengths": jnp.asarray(lengths)},
                        japi.init_cache(b, max_len))
    tl, tc, tlen = tapi.prefill(
        tw, {"tokens": torch.from_numpy(tokens),
             "lengths": torch.from_numpy(lengths)},
        tapi.init_cache(b, max_len, device="cpu"))
    np.testing.assert_array_equal(np.asarray(jlen), tlen.numpy())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = jstep(jw, {"tokens": jnp.asarray(nxt)}, jc, jlen)
        tl, tc = tapi.serve_step(tw, {"tokens": torch.from_numpy(nxt)}, tc,
                                 tlen)
        jlen, tlen = jlen + 1, tlen + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_forward_logits_match_jax():
    """The training forward's loss at the pass-through branch (no QAT):
    the logits of every position enter the cross entropy."""
    japi, jparams, _ = _model("mixtral-8x7b")
    tapi = make_model(get_reduced("mixtral-8x7b"))
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, 512, size=(2, 40)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    jloss, jparts = jax.jit(japi.train_loss)(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    with torch.no_grad():
        loss, parts = tapi.train_loss(
            params_from_numpy(_flat(jparams), tapi.cfg, device="cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(parts["aux"].item(), float(jparts["aux"]),
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_consistency_with_prefill(arch):
    """prefill(s + 1) == prefill(s) then decode(token s), at no-drop
    capacity (capacity depends on the token count)."""
    cfg = dataclasses.replace(get_reduced(arch), capacity_factor=4.0)
    api = make_model(cfg)
    params = api.init_params(4, device="cpu")
    rng = np.random.default_rng(5)
    b, s = 2, 40
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(b, s + 1))
                            .astype(np.int32))
    _, c1, len1 = api.prefill(params, {"tokens": toks[:, :s]},
                              api.init_cache(b, s + 4, device="cpu"))
    inc, _ = api.serve_step(params, {"tokens": toks[:, s:]}, c1, len1)
    full, _, _ = api.prefill(params, {"tokens": toks},
                             api.init_cache(b, s + 4, device="cpu"))
    np.testing.assert_allclose(inc.numpy(), full.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("idx,anchor", [(0, None), (1, "mxint8")])
def test_train_loss_aux_and_grads_match_jax(idx, anchor):
    """Direct MF-QAT at mxint2 (index 0) and anchored at mxint4 (1, Slice-
    and-Scale from the mxint8 anchor): the loss, its aux term and every
    gradient."""
    arch = "mixtral-8x7b"
    jqat = JQAT(formats=TRAIN_FORMATS_MXINT, anchor=anchor)
    japi, params, _ = _model(arch, jqat)
    tapi = make_model(get_reduced(arch),
                      qat=QATConfig(formats=TRAIN_FORMATS_MXINT,
                                    anchor=anchor))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 512, size=(2, 64)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p, b, i: (lambda r: (r[0], r[1]["aux"]))(
            japi.train_loss(p, b, i)), has_aux=True))(
        params, jax.tree_util.tree_map(jnp.asarray, batch), jnp.int32(idx))
    tparams = params_from_numpy(_flat(params), tapi.cfg, device="cpu")
    leaves = [(k, p.requires_grad_(True)) for k, p in flatten_paths(tparams)]
    loss_t, parts = tapi.train_loss(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, idx)
    grads_t = torch.autograd.grad(loss_t, [p for _, p in leaves])
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    np.testing.assert_allclose(parts["aux"].item(), float(aux_j), rtol=1e-4)
    assert parts["aux"].item() > 0
    want = _flat(grads_j)
    assert set(want) == {k for k, _ in leaves}
    assert any("['router']" in k for k in want)
    for (k, _), g in zip(leaves, grads_t):
        np.testing.assert_allclose(
            g.numpy(), want[k], rtol=1e-4,
            atol=1e-6 * float(np.abs(want[k]).max()), err_msg=k)


# =============================================================================
# 4-D leaves: anchor, conversion, packing, dispatch
# =============================================================================
@pytest.mark.parametrize("anchor", ["mxint8", "mxfp8"])
def test_anchor_and_conversions_are_bit_exact_on_expert_leaves(anchor):
    arch = "mixtral-8x7b"
    _, params, ja = _model(arch, anchor=anchor)
    ta = make_anchor(params_from_numpy(_flat(params), get_reduced(arch),
                                       device="cpu"),
                     QATConfig(anchor=anchor), device="cpu")
    assert set(ta.quantized) == set(ja.quantized)
    assert set(ta.raw) == set(ja.raw)
    four_d = [k for k in ja.quantized if k.endswith(EXPERTS)]
    assert len(four_d) == 3 and "['blocks'][0]['moe']['router']" in ja.raw
    lows = ("mxint6", "mxint4") if anchor == "mxint8" else ("mxfp4",)
    pairs = [(ta, ja)] + [(convert(ta, get_format(lo)),
                           jconvert(ja, jget_format(lo))) for lo in lows]
    for t_anchor, j_anchor in pairs:
        for k in four_d:
            t, j = t_anchor.quantized[k], j_anchor.quantized[k]
            assert t.codes.ndim == 4
            np.testing.assert_array_equal(t.codes.numpy(),
                                          np.asarray(j.codes), err_msg=k)
            np.testing.assert_array_equal(t.scale_exp.numpy(),
                                          np.asarray(j.scale_exp), err_msg=k)


@pytest.mark.parametrize("fmt", ["mxint8", "mxint6", "mxint4"])
def test_packed_tree_is_bit_exact_on_expert_leaves(fmt):
    arch = "mixtral-8x7b"
    _, params, ja = _model(arch)
    tw = dict(flatten_paths(make_packed_params(_to_port(ja), target_fmt=fmt,
                                               dtype=torch.float32)))
    jw = jpacked(ja, params, target_fmt=fmt, dtype=jnp.float32)
    jflat = dict(jax.tree_util.tree_flatten_with_path(
        jw, is_leaf=lambda x: hasattr(x, "scale_exp"))[0])
    jflat = {jax.tree_util.keystr(p): v for p, v in jflat.items()}
    for k in (k for k in jflat if k.endswith(EXPERTS)):
        t, j = tw[k], jflat[k]
        if fmt == "mxint4":
            assert isinstance(t, PackedInt4Leaf) and t.layout == "splitn"
            np.testing.assert_array_equal(t.packed.numpy(),
                                          np.asarray(j.packed), err_msg=k)
            assert t.shape == tuple(j.shape)
        else:
            np.testing.assert_array_equal(t.codes.numpy(),
                                          np.asarray(j.codes), err_msg=k)
        np.testing.assert_array_equal(t.scale_exp.numpy(),
                                      np.asarray(j.scale_exp), err_msg=k)


@pytest.mark.parametrize("fmt", ["mxint8", "mxint4"])
def test_dispatch_on_an_expert_slice_matches_densify(fmt):
    """One layer's, one expert's 2-D slice of a 4-D packed leaf through
    ``qmatmul``: the kernel mode (its plain version here) against the
    densify contract."""
    _, _, ja = _model("mixtral-8x7b")
    tw = make_packed_params(_to_port(ja), target_fmt=fmt,
                            dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(5, 64))
                         .astype(np.float32))
    for name in ("w_gate", "w_down"):
        leaf = tw["blocks"][0]["moe"]["experts"][name]
        sl = layer_slice(layer_slice(leaf, 1), 2)
        xin = x if name == "w_gate" else torch.cat([x, x], 1)
        got = qmatmul(xin, sl, mode="kernel")
        want = qmatmul(xin, sl, mode="densify")
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_cost_model_moe_terms_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    terms = cm.layer_param_macs(cfg, 0)
    assert terms == jcm.layer_param_macs(jcfg, 0)
    assert set(terms) == {"attn", "router", "moe_active", "moe_total"}
    assert cm.total_params(cfg) == jcm.total_params(jcfg)
    for fmt in ("mxint4", "mxint8", "bf16"):
        assert cm.serve_weight_stream_bytes(cfg, fmt) == \
            jcm.serve_weight_stream_bytes(jcfg, fmt)
