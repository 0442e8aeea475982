"""The port's RWKV6 block (``models/rwkv.py``) and the rwkv6-7b config
against the JAX package.

Float32, the same seeded numpy inputs in both:

- ``_wkv_chunked`` at S = 1, 7, 64, 65 and 128 (one token, a prime, one
  whole chunk, 65 one-token chunks by the reference's halving rule, two
  chunks) from zeros and from a carried state, the time mix and the channel
  mix over S tokens and then one decode token from the carried state:
  rtol 2e-5, atol 2e-5 (``tests/test_torch_mamba.py``'s block tolerance).
  Decays stay in (0.3, 0.99): a decay that underflows below 1e-38 is left
  out, since XLA on the CPU flushes the subnormal clamp the log takes and
  torch does not;
- reduced rwkv6-7b: prefill and three decode steps on the dense tree and on
  the packed mxint8 / mxint4 trees through the dispatch, at 2 layers and at
  32 (the ``mix_*`` leaves then quantized along the layer axis, ROADMAP
  C.11; JAX densifies the whole tree), rtol 1e-4 / atol 1e-5
  (``tests/test_torch_model.py``'s);
- ``train_loss`` and every gradient under direct and anchored MF-QAT:
  rtol 1e-4 on the loss, rtol 1e-4 and atol 1e-6 * max|g| per leaf
  (``tests/test_torch_train.py``'s);
- the anchor at 32 layers, the seven (32, d) ``mix_*`` leaves included, its
  Slice-and-Scale to mxint6 and the packed mxint4 tree: bit-exact; a
  ``layer_slice`` of such a leaf is its densified row;
- the parameter tree: ``params_from_numpy`` paths and shapes, the init's
  fixed leaves, the configs.
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
from repro.models import get_model as jget_model
from repro.models import rwkv as jrwkv
from repro.models.common import ModelConfig as JConfig
from repro.models.common import QuantCtx as JCtx
from repro.serve.packed_params import make_packed_fn
from repro.serve.packed_params import make_packed_params as jpacked
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.anchor import (AnchorModel, convert, make_anchor,
                                     materialize)
from repro_torch.core.formats import get_format
from repro_torch.core.mx import MXTensor
from repro_torch.core.qat import QATConfig
from repro_torch.core.tree import flatten_paths
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.dispatch import make_qmm
from repro_torch.models import rwkv
from repro_torch.models.common import ModelConfig, QuantCtx
from repro_torch.models.transformer import (make_model, mixer_kind,
                                            param_shapes, projections)
from repro_torch.serve.packed_params import (PackedInt4Leaf, densify_leaf,
                                             layer_slice, make_packed_params)

ARCH = "rwkv6-7b"
BLK = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-4, atol=1e-5)
MIX = ("['rwkv']['mix_r']", "['rwkv']['mix_k']", "['rwkv']['mix_v']",
       "['rwkv']['mix_g']", "['rwkv']['mix_w']", "['cmix']['mix_k']",
       "['cmix']['mix_r']")


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


def _cfgs(layers=2):
    """(port, JAX) reduced rwkv6-7b at ``layers`` layers."""
    return (dataclasses.replace(get_reduced(ARCH), n_layers=layers),
            dataclasses.replace(jreduced(ARCH), n_layers=layers))


_MODELS = {}


def _model(qat=None, layers=2):
    """(JAX api, JAX params, the JAX MXINT8 anchor) of reduced rwkv6-7b,
    with every lerp weight drawn around 0.5 so the token shift matters."""
    key = (qat, layers)
    if key not in _MODELS:
        api = jget_model(_cfgs(layers)[1], qat)
        params = jax.jit(api.init_params)(jax.random.PRNGKey(1))
        rng = np.random.default_rng(layers)
        blk = params["blocks"][0]
        for sub in ("rwkv", "cmix"):
            blk[sub] = dict(blk[sub], **{
                k: jnp.asarray(rng.uniform(0.1, 0.9, v.shape), jnp.float32)
                for k, v in blk[sub].items() if k.startswith("mix_")})
        anc = jax.jit(lambda p: jmake(p, JQAT(anchor="mxint8")))(params)
        _MODELS[key] = (api, params, anc)
    return _MODELS[key]


# =============================================================================
# The block's pieces
# =============================================================================
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("s", [1, 7, 64, 65, 128])
def test_wkv_chunked_matches_jax(s, carried):
    rng = np.random.default_rng(s)
    b, h, hd = 2, 2, 8
    r, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.3, 0.99, size=(b, s, h, hd)).astype(np.float32)
    u = rng.normal(size=(h, hd)).astype(np.float32) * 0.1
    s0 = rng.normal(size=(b, h, hd, hd)).astype(np.float32) \
        if carried else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    j = lambda a: None if a is None else jnp.asarray(a)
    y, st = rwkv._wkv_chunked(*map(t, (r, k, v, w, u, s0)))
    jy, jst = jrwkv._wkv_chunked(*map(j, (r, k, v, w, u, s0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **BLK)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **BLK)
    assert rwkv._chunk_len(s) == {1: 1, 7: 7, 64: 64, 65: 1, 128: 64}[s]


def _mix_params(cfg, seed=0):
    """One layer's time-mix and channel-mix leaves around the init's
    scales; the decay base at -1 so the state decays within a chunk."""
    rng = np.random.default_rng(seed)
    out = {}
    for sub, leaves in rwkv.rwkv_param_shapes(cfg, 1).items():
        out[sub] = {}
        for name, (shape, init) in leaves.items():
            shape = shape[1:]
            if name.startswith("mix_"):
                v = rng.uniform(0.1, 0.9, shape)
            elif name == "decay_base":
                v = -1.0 + rng.normal(size=shape) * 0.3
            elif name == "ln_scale":
                v = 1.0 + rng.normal(size=shape) * 0.1
            else:
                v = rng.normal(size=shape) * max(init, 0.05)
            out[sub][name] = v.astype(np.float32)
    return out


def _mix_cfgs():
    kw = dict(name="t", family="ssm", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=4, d_ff=64, vocab=64, rwkv_head_dim=8)
    return (ModelConfig(compute_dtype=torch.float32, **kw),
            JConfig(compute_dtype=jnp.float32, **kw))


def _mixes(cfg, jcfg, p, x, state=None):
    """Both packages' time mix then channel mix on x: (outputs, states)
    as numpy, port first."""
    tp = {s: {k: torch.from_numpy(v) for k, v in d.items()}
          for s, d in p.items()}
    jp = {s: {k: jnp.asarray(v) for k, v in d.items()} for s, d in p.items()}
    ts = js = (None, None, None)
    if state is not None:
        ts = tuple(torch.from_numpy(np.asarray(a)) for a in state)
        js = tuple(jnp.asarray(a) for a in state)
    out, (sh, wkv) = rwkv.rwkv_time_mix(QuantCtx(), torch.from_numpy(x),
                                        tp["rwkv"], cfg, "t",
                                        None if state is None else ts[:2])
    cout, shc = rwkv.rwkv_channel_mix(QuantCtx(), torch.from_numpy(x),
                                      tp["cmix"], cfg, "c", ts[2])
    jout, (jsh, jwkv) = jrwkv.rwkv_time_mix(JCtx(), jnp.asarray(x),
                                            jp["rwkv"], jcfg, "t",
                                            None if state is None
                                            else js[:2])
    jcout, jshc = jrwkv.rwkv_channel_mix(JCtx(), jnp.asarray(x), jp["cmix"],
                                         jcfg, "c", js[2])
    return ([a.numpy() for a in (out, cout, sh, wkv, shc)],
            [np.asarray(a) for a in (jout, jcout, jsh, jwkv, jshc)])


@pytest.mark.parametrize("s", [7, 40])
def test_time_and_channel_mix_and_decode_match_jax(s):
    """Both mixes over S tokens from zeros; then over S - 1 tokens and one
    decode token from the carried (shift, wkv, shift): equal to JAX's,
    and the decode output equal to the whole run's last position."""
    cfg, jcfg = _mix_cfgs()
    p = _mix_params(cfg)
    x = np.random.default_rng(1).normal(size=(2, s, 32)).astype(np.float32)
    got, want = _mixes(cfg, jcfg, p, x)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **BLK)
    _, pre = _mixes(cfg, jcfg, p, x[:, :-1])
    dec, jdec = _mixes(cfg, jcfg, p, x[:, -1:], state=pre[2:])
    for a, b in zip(dec, jdec):
        np.testing.assert_allclose(a, b, **BLK)
    np.testing.assert_allclose(dec[0][:, 0], got[0][:, -1], **BLK)
    np.testing.assert_allclose(dec[1][:, 0], got[1][:, -1], **BLK)
    np.testing.assert_allclose(dec[3], got[3], **BLK)


# =============================================================================
# reduced rwkv6-7b
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
        assert not any(mine.is_attn_layer(j) for j in range(4))
    cfg = get_reduced(ARCH)
    assert mixer_kind(cfg, 0) == "rwkv"
    assert projections(cfg, 0) == {
        "rwkv": ("wr", "wk", "wv", "wg", "wo"),
        "cmix": ("w_key", "w_value", "w_recept")}


def test_param_tree_and_init_match_jax():
    _, params, _ = _model()
    cfg = get_reduced(ARCH)
    want = {k: v.shape for k, v in _flat(params).items()}
    tparams = params_from_numpy(_flat(params), cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in flatten_paths(tparams)} == want
    assert "['blocks'][0]['rwkv']['decay_w1']" in want
    assert "['blocks'][0]['cmix']['w_recept']" in want
    bad = dict(_flat(params))
    bad.pop("['blocks'][0]['rwkv']['bonus']")
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(bad, cfg, device="cpu")
    # the init's fixed leaves, as JAX sets them (the lerp weights at 0.5:
    # the fixture redraws them)
    mine = dict(flatten_paths(make_model(cfg).init_params(0, device="cpu")))
    jinit = _flat(jax.jit(jget_model(jreduced(ARCH)).init_params)(
        jax.random.PRNGKey(1)))
    for k in ("['rwkv']['mix_w']", "['rwkv']['decay_base']",
              "['rwkv']['ln_scale']", "['cmix']['mix_r']"):
        path = "['blocks'][0]" + k
        np.testing.assert_array_equal(mine[path].numpy(), jinit[path],
                                      err_msg=k)
    for k in ("['rwkv']['decay_w1']", "['rwkv']['bonus']", "['rwkv']['wo']"):
        path = "['blocks'][0]" + k
        assert np.std(mine[path].numpy()) == pytest.approx(
            np.std(jinit[path]), rel=0.3), k
    assert param_shapes(cfg)["blocks"][0]["rwkv"]["bonus"] == \
        ((2, 4, 16), 0.1)


@pytest.mark.parametrize("layers,fmt", [(2, "bf16"), (2, "mxint8"),
                                        (2, "mxint4"), (32, "mxint8"),
                                        (32, "mxint4")])
def test_prefill_and_decode_logits_match_jax(layers, fmt):
    """Prefill of two 40-token prompts, then three decode steps from the
    state in the cache, against JAX (at 32 layers the ``mix_*`` leaves are
    packed along the layer axis and densified before the layer loop)."""
    japi, jparams, ja = _model(layers=layers)
    cfg = _cfgs(layers)[0]
    api = make_model(cfg)
    ta = _to_port(ja)
    assert (("['blocks'][0]" + MIX[0]) in ja.quantized) == (layers == 32)
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
    b, s, max_len = 2, 40, 48
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    jl, jc, jlen = jpre(jw, {"tokens": jnp.asarray(tokens)},
                        japi.init_cache(b, max_len))
    tc = tapi.init_cache(b, max_len, device="cpu")
    assert tc["blocks"][0]["wkv"].shape == (layers, b, 4, 16, 16)
    assert tc["blocks"][0]["shift_t"].shape == (layers, b, 1, 64)
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
    for k in ("shift_t", "wkv", "shift_c"):
        np.testing.assert_allclose(tc["blocks"][0][k].numpy(),
                                   np.asarray(jc["blocks"][0][k]), **TOL)


@pytest.mark.parametrize("idx,anchor", [(0, None), (1, "mxint8")])
def test_train_loss_and_grads_match_jax(idx, anchor):
    """Direct MF-QAT at mxint2 (index 0) and anchored at mxint4 (1): the
    loss and every gradient, the raw decay LoRA, bonus and lerp weights
    included, over 96 tokens (a 64-token chunk and a 32-token one)."""
    jqat = JQAT(formats=TRAIN_FORMATS_MXINT, anchor=anchor)
    japi, params, _ = _model(jqat)
    tapi = make_model(get_reduced(ARCH),
                      qat=QATConfig(formats=TRAIN_FORMATS_MXINT,
                                    anchor=anchor))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 512, size=(2, 96)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, b, i: japi.train_loss(p, b, i)[0]))(
        params, jax.tree_util.tree_map(jnp.asarray, batch), jnp.int32(idx))
    tparams = params_from_numpy(_flat(params), tapi.cfg, device="cpu")
    leaves = [(k, p.requires_grad_(True)) for k, p in flatten_paths(tparams)]
    loss_t, _ = tapi.train_loss(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, idx)
    grads_t = torch.autograd.grad(loss_t, [p for _, p in leaves])
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    want = _flat(grads_j)
    assert set(want) == {k for k, _ in leaves}
    for (k, _), g in zip(leaves, grads_t):
        assert np.abs(want[k]).max() > 0, k
        np.testing.assert_allclose(
            g.numpy(), want[k], rtol=1e-4,
            atol=1e-6 * float(np.abs(want[k]).max()), err_msg=k)


def test_anchor_and_conversion_are_bit_exact_at_32_layers():
    """At 32 stacked layers the anchor quantizes the seven (32, d) lerp
    leaves along the layer axis (``time_`` never matches their paths);
    the port's anchor of the same weights holds the same quantized and raw
    paths, codes and scales, also after Slice-and-Scale to mxint6 and
    packed at mxint4; a layer's slice of a lerp leaf is its densified
    row."""
    _, params, ja = _model(layers=32)
    cfg = _cfgs(32)[0]
    ta = make_anchor(params_from_numpy(_flat(params), cfg, device="cpu"),
                     QATConfig(anchor="mxint8"), device="cpu")
    assert set(ta.quantized) == set(ja.quantized)
    assert set(ta.raw) == set(ja.raw)
    mix = ["['blocks'][0]" + m for m in MIX]
    assert set(mix) <= set(ja.quantized)
    assert {k for k in ja.raw if "['rwkv']" in k} == {
        "['blocks'][0]['rwkv']['" + n + "']"
        for n in ("decay_base", "decay_w1", "decay_w2", "bonus",
                  "ln_scale")}
    for pair in ((ta, ja), (convert(ta, get_format("mxint6")),
                            jconvert(ja, jget_format("mxint6")))):
        for k in ja.quantized:
            t, j = pair[0].quantized[k], pair[1].quantized[k]
            np.testing.assert_array_equal(t.codes.numpy(),
                                          np.asarray(j.codes), err_msg=k)
            np.testing.assert_array_equal(t.scale_exp.numpy(),
                                          np.asarray(j.scale_exp), err_msg=k)
    tw = dict(flatten_paths(make_packed_params(ta, target_fmt="mxint4",
                                               dtype=torch.float32)))
    jw = jpacked(ja, params, target_fmt="mxint4", dtype=jnp.float32)
    jflat = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_flatten_with_path(
                 jw, is_leaf=lambda x: hasattr(x, "scale_exp"))[0]}
    for k in mix:
        t, j = tw[k], jflat[k]
        assert isinstance(t, PackedInt4Leaf) and t.layout == "splitn"
        np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed),
                                      err_msg=k)
        np.testing.assert_array_equal(t.scale_exp.numpy(),
                                      np.asarray(j.scale_exp), err_msg=k)
    dense = jmaterialize(ja, params, dtype=jnp.float32)
    dflat = _flat(dense)
    for leaf in (ta.quantized[mix[0]], tw[mix[0]]):
        full = densify_leaf(leaf, None, torch.float32).numpy()
        for g in (0, 5, 31):
            row = layer_slice(leaf, g)
            assert isinstance(row, torch.Tensor) and row.shape == (64,)
            np.testing.assert_array_equal(row.numpy(), full[g])
    np.testing.assert_array_equal(
        densify_leaf(ta.quantized[mix[0]], None, torch.float32).numpy(),
        dflat[mix[0]])
