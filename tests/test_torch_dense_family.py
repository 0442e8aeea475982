"""starcoder2-3b (gelu MLP, q/k/v and MLP biases) and qwen2-72b (q/k/v
biases) in the port, against the JAX package.

Reduced configs, float32, the same numpy weights in both, with every bias
leaf replaced by seeded nonzero values (zero-initialised biases would hide a
missing bias add):

- prefill and two decode steps, dense weights and packed at mxint8 / mxint4:
  rtol 1e-4, atol 1e-5, the tolerance of ``tests/test_torch_model.py`` (f32
  in both; summation order and transcendentals differ);
- greedy streams of the port engine against the JAX engine (``fused=False``)
  on the dense and the paged layout: identical tokens;
- ``train_loss`` and its gradients, bias leaves included (fake-quant never
  touches a bias): rtol 1e-4, atol 1e-6 * max|g| per leaf, as in
  ``tests/test_torch_train.py``, where a leaf's max|g| is floored at a
  thousandth of the tree's largest: attention is invariant to a key bias
  but for RoPE, so bk's gradient (~1e-3 of the tree's) is a cancellation
  residue whose smallest entries differ in their third digit;
- the anchor's split of quantized and raw leaves equals JAX's at G = 2, 30,
  32 and 80 stacked layers. A (G, n) bias leaf stays raw only because its
  block axis is G and G % 32 != 0 (the exclude regex ``bias`` does not
  match ``['bq']``): the reference's rule, pinned here at both sides of it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.core.anchor import AnchorModel, make_anchor, materialize
from repro_torch.core.formats import get_format
from repro_torch.core.mx import MXTensor
from repro_torch.core.qat import QATConfig
from repro_torch.core.tree import flatten_paths
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.dispatch import make_qmm
from repro_torch.models.transformer import (PROJECTIONS, make_model,
                                            param_shapes)
from repro_torch.serve.engine import ElasticEngine, Request, RequestStatus
from repro_torch.serve.packed_params import make_packed_params

ARCHS = ("starcoder2-3b", "qwen2-72b")
TOL = dict(rtol=1e-4, atol=1e-5)
BIASES = ("['bq']", "['bk']", "['bv']", "['b_up']", "['b_down']")


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _with_biases(params, seed):
    """``params`` with every bias leaf replaced by seeded N(0, 0.1²)."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        if jax.tree_util.keystr(path).endswith(BIASES):
            return jnp.asarray(rng.normal(0.0, 0.1, x.shape)
                               .astype(np.float32))
        return x

    return jax.tree_util.tree_map_with_path(fill, params)


def _to_port(j) -> AnchorModel:
    q = {k: MXTensor(codes=torch.from_numpy(np.array(t.codes)),
                     scale_exp=torch.from_numpy(np.array(t.scale_exp)),
                     fmt=get_format(t.fmt.name, t.fmt.block_size),
                     block_axis=t.block_axis)
         for k, t in j.quantized.items()}
    raw = {k: torch.from_numpy(np.array(w)) for k, w in j.raw.items()}
    return AnchorModel(quantized=q, raw=raw, fmt_name=j.fmt_name)


_MODELS = {}


def _model(arch, qat=None):
    """(JAX api, JAX params with random biases, the JAX mxint8 anchor)."""
    key = (arch, qat)
    if key not in _MODELS:
        api = jget_model(jreduced(arch), qat)
        params = _with_biases(jax.jit(api.init_params)(
            jax.random.PRNGKey(1)), seed=7)
        anchor = jax.jit(lambda p: jmake(p, JQAT(anchor="mxint8")))(params)
        _MODELS[key] = (api, params, anchor)
    return _MODELS[key]


def test_configs_match_the_reference():
    from repro.configs import get_config as jget_config
    assert {"starcoder2-3b", "qwen2-72b"} <= set(list_archs())
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


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(arch):
    """Paths and shapes of the port's tree equal the JAX init's, biases
    and the gelu MLP's two weights included."""
    api, params, _ = _model(arch)
    want = {k: v.shape for k, v in _flat(params).items()}
    tparams = params_from_numpy(_flat(params), get_reduced(arch),
                                device="cpu")
    assert {k: tuple(v.shape) for k, v in flatten_paths(tparams)} == want
    mlp = param_shapes(get_reduced(arch))["blocks"][0]["mlp"]
    assert ("w_gate" in mlp) == (get_reduced(arch).act == "swiglu")


@pytest.mark.parametrize("fmt", ["bf16", "mxint8", "mxint4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch, fmt):
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
    for k in ("['blocks'][0]['attn']['bq']", "['blocks'][0]['mlp']['b_down']"):
        if k in ta.raw:
            assert float(ta.raw[k].abs().max()) > 0.05    # biases are live
    rng = np.random.default_rng(2)
    b, s, max_len = 2, 16, 32
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    lengths = np.array([s, 11], np.int32)
    jl, jc, jlen = jpre(jw, {"tokens": jnp.asarray(tokens),
                             "lengths": jnp.asarray(lengths)},
                        japi.init_cache(b, max_len))
    tl, tc, tlen = tapi.prefill(
        tw, {"tokens": torch.from_numpy(tokens),
             "lengths": torch.from_numpy(lengths)},
        tapi.init_cache(b, max_len, device="cpu"))
    np.testing.assert_array_equal(np.asarray(jlen), tlen.numpy())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for _ in range(2):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = jstep(jw, {"tokens": jnp.asarray(nxt)}, jc, jlen)
        tl, tc = tapi.serve_step(tw, {"tokens": torch.from_numpy(nxt)}, tc,
                                 tlen)
        jlen, tlen = jlen + 1, tlen + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for j_blk, t_blk in zip(jc["blocks"], tc["blocks"]):
        np.testing.assert_allclose(t_blk["v"].numpy(), np.asarray(j_blk["v"]),
                                   **TOL)


ENGINE_KW = {"dense": {},
             "paged": dict(kv_layout="paged", kv_page_size=8,
                           attn_impl="paged_kernel", prefill_chunk=8)}


@pytest.mark.parametrize("layout", sorted(ENGINE_KW))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_jax(arch, layout):
    japi, jparams, ja = _model(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32)
               for n in (13, 4, 21)]
    kw = dict(batch_slots=2, max_len=40, **ENGINE_KW[layout])
    fmt = "mxint4" if layout == "dense" else "mxint8"
    jeng = JEngine(japi, ja, fused=False, param_template=jparams, **kw)
    want = jeng.generate([JRequest(i, p, 5) for i, p in enumerate(prompts)],
                         fmt_override=fmt)
    eng = ElasticEngine(make_model(get_reduced(arch)), _to_port(ja),
                        device="cpu", **kw)
    got = eng.generate([Request(i, p, 5) for i, p in enumerate(prompts)],
                       fmt_override=fmt)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.status is RequestStatus.COMPLETED for r in got)
    assert eng.stats()["attn_tokens_read"] == jeng.stats["attn_tokens_read"]


@pytest.mark.parametrize("idx", [0, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_jax(arch, idx):
    """Direct MF-QAT at mxint4 (index 0) and the pass-through (4): the
    loss and every gradient, the bias leaves' included. The port's
    attention here is ``prefill_attention`` under autograd
    (``flash_vjp=False``), the path this elementwise bound was set on:
    the flash backward's ``ds = p * (dp - delta)`` leaves rounding noise
    in the rows' sums that the biased keys turn into wk / bk gradient
    residues of ~2e-6 of the leaf's largest, independently in each
    package (in JAX alone, flash against plain reaches 0.45 of this
    bound). The default flash path is held against JAX in
    ``tests/test_torch_flash_vjp.py``."""
    jqat = JQAT(formats=TRAIN_FORMATS_MXINT)
    japi, params, _ = _model(arch, jqat)
    tapi = make_model(dataclasses.replace(get_reduced(arch), flash_vjp=False),
                      qat=QATConfig(formats=TRAIN_FORMATS_MXINT))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 512, size=(2, 64)).astype(np.int32)
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
    assert any(k.endswith(BIASES) for k in want)
    top = max(float(np.abs(v).max()) for v in want.values())
    for (k, _), g in zip(leaves, grads_t):
        scale = max(float(np.abs(want[k]).max()), 1e-3 * top)
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=k)


def test_fake_quant_lists_weights_only():
    for act, subs in PROJECTIONS.items():
        names = [n for ns in subs.values() for n in ns]
        assert all(n.startswith("w") for n in names), act
    assert PROJECTIONS["gelu"]["mlp"] == ("w_up", "w_down")


@pytest.mark.parametrize("groups", [2, 30, 32, 80])
@pytest.mark.parametrize("arch", ARCHS)
def test_anchor_bias_leaves_follow_the_reference_rule(arch, groups):
    """Quantized and raw path sets equal JAX's at G stacked layers; the
    biases are raw at G = 2, 30, 80 and quantized at G = 32, in both."""
    jcfg = dataclasses.replace(jreduced(arch), n_layers=groups)
    cfg = dataclasses.replace(get_reduced(arch), n_layers=groups)
    japi = jget_model(jcfg)
    params = jax.jit(japi.init_params)(jax.random.PRNGKey(0))
    ja = jmake(params, JQAT(anchor="mxint8"))
    ta = make_anchor(params_from_numpy(_flat(params), cfg, device="cpu"),
                     QATConfig(anchor="mxint8"), device="cpu")
    assert set(ta.quantized) == set(ja.quantized)
    assert set(ta.raw) == set(ja.raw)
    biases = {k for k in list(ta.quantized) + list(ta.raw)
              if k.endswith(BIASES)}
    assert biases
    assert (biases <= set(ta.quantized)) == (groups % 32 == 0)
    assert (biases <= set(ta.raw)) == (groups % 32 != 0)
