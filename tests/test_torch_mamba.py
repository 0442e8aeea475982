"""The port's Mamba block (``models/ssm.py``) and the hybrid jamba config
against the JAX package.

Float32, the same seeded numpy inputs in both:

- ``_causal_conv1d`` from zeros and from a carried state, ``selective_scan``
  at S = 1, 7, 12, 256 and 300 (one token, a prime, a chunk that does not
  fill 256, exactly one chunk, and 300 = 75 chunks of 4 by the reference's
  halving rule) from zeros and from a carried state, and ``mamba_block``'s
  output and state: rtol 2e-5, atol 2e-5 (``tests/test_torch_moe.py``'s
  block tolerance). The port scans a chunk by doubling where JAX's
  associative scan pairs differently, so sums round in another order;
- decode: a block run over S - 1 tokens, then one token from the carried
  (h, conv), against JAX doing the same, and against the last position of
  the block over all S tokens;
- reduced jamba: prefill and three decode steps on the dense tree and on
  the packed mxint8 / mxint4 trees through the dispatch (A_log packed,
  densified where used), rtol 1e-4 / atol 1e-5 (``tests/test_torch_
  model.py``'s);
- ``train_loss`` and every gradient under direct and anchored MF-QAT:
  rtol 1e-4 on the loss, rtol 1e-4 and atol 1e-6 * max|g| per leaf
  (``tests/test_torch_train.py``'s);
- the anchor, ``A_log``'s MXINT8 codes included, its Slice-and-Scale to
  mxint6 and the packed mxint4 tree (split-N ``A_log``): bit-exact;
- the parameter tree: ``params_from_numpy`` paths and shapes (each
  in-group position its own keys), the init's fixed leaves, the configs.
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
from repro.core.formats import TRAIN_FORMATS_MXINT
from repro.core.formats import get_format as jget_format
from repro.core.qat import QATConfig as JQAT
from repro.models import get_model as jget_model
from repro.models import ssm as jssm
from repro.models.common import ModelConfig as JConfig
from repro.models.common import QuantCtx as JCtx
from repro.serve.packed_params import make_packed_fn
from repro.serve.packed_params import make_packed_params as jpacked
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.anchor import AnchorModel, convert, make_anchor
from repro_torch.core.formats import get_format
from repro_torch.core.mx import MXTensor
from repro_torch.core.qat import QATConfig
from repro_torch.core.tree import flatten_paths
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.dispatch import make_qmm
from repro_torch.models import ssm
from repro_torch.models.common import ModelConfig, QuantCtx
from repro_torch.models.transformer import (make_model, mixer_kind,
                                            param_shapes, projections)
from repro_torch.serve.packed_params import (PackedInt4Leaf,
                                             make_packed_params)

ARCH = "jamba-1.5-large-398b"
BLK = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-4, atol=1e-5)
MAMBA = "['mamba']"


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


def _model(qat=None, anchor="mxint8"):
    """(JAX api, JAX params, the JAX anchor at ``anchor``) of reduced
    jamba."""
    key = (qat, anchor)
    if key not in _MODELS:
        api = jget_model(jreduced(ARCH), qat)
        params = jax.jit(api.init_params)(jax.random.PRNGKey(1))
        anc = jax.jit(lambda p: jmake(p, JQAT(anchor=anchor)))(params)
        _MODELS[key] = (api, params, anc)
    return _MODELS[key]


# =============================================================================
# The block's pieces
# =============================================================================
def _cfgs(n_state=4):
    kw = dict(name="t", family="hybrid", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab=64, attn_every=2,
              mamba_d_state=n_state)
    return (ModelConfig(compute_dtype=torch.float32, **kw),
            JConfig(compute_dtype=jnp.float32, **kw))


def _mamba_params(cfg, seed=0):
    """Weights around the init's scales, dt large enough (softplus(0.5))
    that the recurrence carries information across the chunk."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, init) in ssm.mamba_param_shapes(cfg, 1).items():
        shape = shape[1:]
        if init == "a_log":
            v = np.log(np.tile(np.arange(1, shape[1] + 1), (shape[0], 1)))
            v = v + rng.normal(size=shape) * 0.1
        elif isinstance(init, float):
            v = rng.normal(size=shape) * max(init, 0.1)
        else:
            v = 0.5 + rng.normal(size=shape) * 0.1
        out[name] = v.astype(np.float32)
    return out


def test_causal_conv1d_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 16)).astype(np.float32)
    w = rng.normal(size=(4, 16)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 16)).astype(np.float32)
    for state in (None, st):
        y, new = ssm._causal_conv1d(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
            None if state is None else torch.from_numpy(state))
        jy, jnew = jssm._causal_conv1d(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            None if state is None else jnp.asarray(state))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **BLK)
        np.testing.assert_allclose(new.numpy(), np.asarray(jnew), **BLK)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("s", [1, 7, 12, 256, 300])
def test_selective_scan_matches_jax(s, carried):
    rng = np.random.default_rng(s)
    b, di, n = 2, 8, 4
    dt = np.log1p(np.exp(rng.normal(size=(b, s, di)))).astype(np.float32)
    a_log = np.log(rng.uniform(0.5, 4, size=(di, n))).astype(np.float32)
    bi = rng.normal(size=(b, s, n)).astype(np.float32)
    ci = rng.normal(size=(b, s, n)).astype(np.float32)
    xi = rng.normal(size=(b, s, di)).astype(np.float32)
    h0 = rng.normal(size=(b, di, n)).astype(np.float32) if carried else None
    t = lambda v: None if v is None else torch.from_numpy(v)
    j = lambda v: None if v is None else jnp.asarray(v)
    y, h = ssm.selective_scan(t(dt), t(a_log), t(bi), t(ci), t(xi), t(h0))
    jy, jh = jssm.selective_scan(j(dt), j(a_log), j(bi), j(ci), j(xi), j(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **BLK)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **BLK)
    assert ssm._chunk_len(s) == {1: 1, 7: 7, 12: 12, 256: 256, 300: 4}[s]


def _block(cfg, jcfg, p, x, state=None):
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    out, (h, conv) = ssm.mamba_block(
        QuantCtx(), torch.from_numpy(x), tp, cfg, "m",
        None if state is None else tuple(torch.from_numpy(np.asarray(v))
                                         for v in state))
    jout, (jh, jconv) = jssm.mamba_block(
        JCtx(), jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
        jcfg, "m", None if state is None else tuple(jnp.asarray(v)
                                                    for v in state))
    return (out.numpy(), h.numpy(), conv.numpy()), \
        (np.asarray(jout), np.asarray(jh), np.asarray(jconv))


@pytest.mark.parametrize("s", [7, 40])
def test_mamba_block_and_decode_match_jax(s):
    """The block over S tokens from zeros; then over S - 1 tokens and one
    decode token from the carried state: equal to JAX's, and the decode
    output equal to the whole block's last position."""
    cfg, jcfg = _cfgs()
    p = _mamba_params(cfg)
    x = np.random.default_rng(1).normal(size=(2, s, 32)).astype(np.float32)
    got, want = _block(cfg, jcfg, p, x)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **BLK)
    pre, jpre = _block(cfg, jcfg, p, x[:, :-1])
    dec, jdec = _block(cfg, jcfg, p, x[:, -1:], state=jpre[1:])
    for a, b in zip(dec, jdec):
        np.testing.assert_allclose(a, b, **BLK)
    np.testing.assert_allclose(dec[0][:, 0], got[0][:, -1], **BLK)
    np.testing.assert_allclose(dec[1], got[1], **BLK)


# =============================================================================
# reduced jamba
# =============================================================================
def test_configs_match_the_reference():
    for get, jget in ((get_config, jget_config), (get_reduced, jreduced)):
        mine, ref = get(ARCH), jget(ARCH)
        for f in dataclasses.fields(mine):
            if f.name == "compute_dtype":
                assert str(mine.compute_dtype).split(".")[-1] == \
                    jnp.dtype(ref.compute_dtype).name
            else:
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert mine.dt_rank == ref.dt_rank
        assert mine.mamba_d_inner == ref.mamba_d_inner
        assert [mine.is_attn_layer(j) for j in range(mine.scan_group)] == \
            [ref.is_attn_layer(j) for j in range(ref.scan_group)]
    cfg = get_reduced(ARCH)
    assert [mixer_kind(cfg, j) for j in range(4)] == \
        ["mamba", "mamba", "attn", "mamba"]


def test_param_tree_and_init_match_jax():
    _, params, _ = _model()
    cfg = get_reduced(ARCH)
    want = {k: v.shape for k, v in _flat(params).items()}
    tparams = params_from_numpy(_flat(params), cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in flatten_paths(tparams)} == want
    assert "['blocks'][2]['attn']['wq']" in want
    assert "['blocks'][0]['mamba']['A_log']" in want
    assert not any(k.startswith("['blocks'][2]['mamba']") for k in want)
    bad = dict(_flat(params))
    bad.pop("['blocks'][1]['mamba']['D']")
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(bad, cfg, device="cpu")
    # the init's fixed leaves, as JAX sets them
    mine = dict(flatten_paths(make_model(cfg).init_params(0, device="cpu")))
    jflat = _flat(params)
    for k in ("A_log", "dt_bias", "D", "conv_b"):
        path = f"['blocks'][0]['mamba']['{k}']"
        np.testing.assert_allclose(mine[path].numpy(), jflat[path],
                                   rtol=1e-6, err_msg=k)
    assert np.std(mine["['blocks'][1]['mamba']['conv_w']"].numpy()) > 0.05
    shapes = param_shapes(cfg)["blocks"][0]["mamba"]
    assert shapes["out_proj"] == ((1, 128, 64), 0.02 / 2.0)
    assert projections(cfg, 0) == {
        "mamba": ("in_proj", "x_proj", "out_proj"),
        "mlp": ("w_gate", "w_up", "w_down")}
    assert projections(cfg, 2)["attn"] == ("wq", "wk", "wv", "wo")


@pytest.mark.parametrize("fmt", ["bf16", "mxint8", "mxint4"])
def test_prefill_and_decode_logits_match_jax(fmt):
    """Prefill of two 40-token prompts, then three decode steps from the
    Mamba state in the cache, against JAX; packed trees keep ``A_log``
    packed (densified where the scan uses it)."""
    japi, jparams, ja = _model()
    cfg = get_reduced(ARCH)
    api = make_model(cfg)
    ta = _to_port(ja)
    if fmt == "bf16":
        from repro.core.anchor import materialize as jmaterialize
        from repro_torch.core.anchor import materialize
        jw = jmaterialize(ja, jparams, dtype=jnp.float32)
        jpre, jstep = jax.jit(japi.prefill), jax.jit(japi.serve_step)
        tw, tapi = materialize(ta, dtype=torch.float32), api
    else:
        jw = jpacked(ja, jparams, target_fmt=fmt, dtype=jnp.float32)
        jpre = jax.jit(make_packed_fn(japi, japi.prefill))
        jstep = jax.jit(make_packed_fn(japi, japi.serve_step))
        tw = make_packed_params(ta, target_fmt=fmt, dtype=torch.float32)
        tapi = api.with_qmm(make_qmm())
        leaf = tw["blocks"][0]["mamba"]["A_log"]
        assert isinstance(leaf, PackedInt4Leaf if fmt == "mxint4"
                          else MXTensor)
    rng = np.random.default_rng(2)
    b, s, max_len = 2, 40, 48
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    jl, jc, jlen = jpre(jw, {"tokens": jnp.asarray(tokens)},
                        japi.init_cache(b, max_len))
    tc = tapi.init_cache(b, max_len, device="cpu")
    assert tc["blocks"][0]["h"].shape == (1, b, 128, 4)
    assert tc["blocks"][0]["conv"].shape == (1, b, 3, 128)
    tl, tc, tlen = tapi.prefill(tw, {"tokens": torch.from_numpy(tokens)}, tc)
    np.testing.assert_array_equal(np.asarray(jlen), tlen.numpy())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = jstep(jw, {"tokens": jnp.asarray(nxt)}, jc, jlen)
        tl, tc = tapi.serve_step(tw, {"tokens": torch.from_numpy(nxt)}, tc,
                                 tlen)
        jlen, tlen = jlen + 1, tlen + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["blocks"][0]["h"].numpy(),
                               np.asarray(jc["blocks"][0]["h"]), **TOL)


@pytest.mark.parametrize("idx,anchor", [(0, None), (1, "mxint8")])
def test_train_loss_and_grads_match_jax(idx, anchor):
    """Direct MF-QAT at mxint2 (index 0) and anchored at mxint4 (1): the
    loss, its aux term (the MoE layers) and every gradient, the Mamba
    block's raw leaves (A_log, D, conv, dt) included."""
    jqat = JQAT(formats=TRAIN_FORMATS_MXINT, anchor=anchor)
    japi, params, _ = _model(jqat)
    tapi = make_model(get_reduced(ARCH),
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
    want = _flat(grads_j)
    assert set(want) == {k for k, _ in leaves}
    assert any(k.endswith("['A_log']") for k in want)
    for (k, _), g in zip(leaves, grads_t):
        np.testing.assert_allclose(
            g.numpy(), want[k], rtol=1e-4,
            atol=1e-6 * float(np.abs(want[k]).max()), err_msg=k)


def test_anchor_and_conversion_are_bit_exact_a_log_included():
    """The port's anchor of the same weights: the same quantized and raw
    paths (A_log quantized: ``DEFAULT_EXCLUDE``'s ``A_log`` never matches
    the lowercased path; D, conv, dt raw), codes and scales equal, and
    equal after Slice-and-Scale to mxint6."""
    _, params, ja = _model()
    ta = make_anchor(params_from_numpy(_flat(params), get_reduced(ARCH),
                                       device="cpu"),
                     QATConfig(anchor="mxint8"), device="cpu")
    assert set(ta.quantized) == set(ja.quantized)
    assert set(ta.raw) == set(ja.raw)
    mamba_q = sorted(k.split("'")[-2] for k in ja.quantized
                     if k.startswith("['blocks'][0]['mamba']"))
    assert mamba_q == ["A_log", "in_proj", "out_proj", "x_proj"]
    for pair in ((ta, ja), (convert(ta, get_format("mxint6")),
                            jconvert(ja, jget_format("mxint6")))):
        for k in (k for k in ja.quantized if MAMBA in k):
            t, j = pair[0].quantized[k], pair[1].quantized[k]
            np.testing.assert_array_equal(t.codes.numpy(),
                                          np.asarray(j.codes), err_msg=k)
            np.testing.assert_array_equal(t.scale_exp.numpy(),
                                          np.asarray(j.scale_exp), err_msg=k)


def test_packed_mxint4_tree_is_bit_exact_a_log_split_n():
    _, params, ja = _model()
    tw = dict(flatten_paths(make_packed_params(_to_port(ja),
                                               target_fmt="mxint4",
                                               dtype=torch.float32)))
    jw = jpacked(ja, params, target_fmt="mxint4", dtype=jnp.float32)
    jflat = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_flatten_with_path(
                 jw, is_leaf=lambda x: hasattr(x, "scale_exp"))[0]}
    keys = [k for k in jflat if MAMBA in k and hasattr(jflat[k], "packed")]
    assert any(k.endswith("['A_log']") for k in keys)
    for k in keys:
        t, j = tw[k], jflat[k]
        assert isinstance(t, PackedInt4Leaf) and t.layout == "splitn"
        np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed),
                                      err_msg=k)
        np.testing.assert_array_equal(t.scale_exp.numpy(),
                                      np.asarray(j.scale_exp), err_msg=k)
    assert tuple(tw["['blocks'][0]['mamba']['A_log']"].packed.shape) == \
        (1, 128, 2)
