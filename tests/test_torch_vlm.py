"""The port's vision-prefixed backbone (llava-next-mistral-7b, reduced to 2
layers and a 24-token prefix) against the JAX package.

The same numpy weights and ``vision_embeds`` in both, float32:

- ``train_loss`` with a batch carrying ``vision_embeds`` (the loss over the
  text positions only) and every gradient, under direct MF-QAT at mxint4:
  rtol 1e-4 on the loss, rtol 1e-4 and atol 1e-6 * max|g| per leaf
  (``tests/test_torch_train.py``'s); and at 24 + 77 positions, which the
  chunk of 64 does not divide (the reference halves its chunk to 1, the
  port pads to 128 and skips the causally empty pairs), at the same
  tolerances;
- ``prefill`` with and without ``lengths`` (``cache_len`` counts the
  prefix), then three ``serve_step``s, on the dense cache and on the paged
  one (pages of 8, the gather read path and B3's plain version), on the
  dense tree and packed at mxint8: rtol 1e-4 / atol 1e-5;
- the refusals: chunked prefill, the mixed tick and the verify say what the
  reference says; the port's engine refuses the config when it is built
  (ROADMAP C.10), where the reference's fails with ``KeyError:
  'vision_embeds'`` at its first admission.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jreduced
from repro.core.anchor import make_anchor as jmake
from repro.core.formats import TRAIN_FORMATS_MXINT
from repro.core.qat import QATConfig as JQAT
from repro.models import get_model as jget_model
from repro.serve.engine import ElasticEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve.packed_params import make_packed_fn
from repro.serve.packed_params import make_packed_params as jpacked
from repro_torch.configs import get_reduced
from repro_torch.core.anchor import AnchorModel
from repro_torch.core.formats import get_format
from repro_torch.core.mx import MXTensor
from repro_torch.core.qat import QATConfig
from repro_torch.core.tree import flatten_paths
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.dispatch import make_qmm
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import ElasticEngine
from repro_torch.serve.packed_params import make_packed_params

ARCH = "llava-next-mistral-7b"
V = 24
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


@pytest.fixture(scope="module")
def served():
    api = jget_model(jreduced(ARCH))
    params = jax.jit(api.init_params)(jax.random.PRNGKey(4))
    anchor = jax.jit(lambda p: jmake(p, JQAT(anchor="mxint8")))(params)
    return api, params, anchor


def _embeds(b, seed=0):
    return (np.random.default_rng(seed).normal(size=(b, V, 64)) * 0.5) \
        .astype(np.float32)


def test_config_and_cache_carry_the_prefix():
    cfg = get_reduced(ARCH)
    assert (cfg.family, cfg.vision_tokens, cfg.n_layers) == ("vlm", V, 2)
    api = make_model(cfg)
    assert api.init_cache(2, 40, device="cpu")["blocks"][0]["k"].shape[2] \
        == 40 + V
    assert api.init_cache(2, 40, device="cpu", kv_layout="paged",
                          page_size=8)["block_table"].shape == (2, 8)


def _train_loss_and_grads(served, text_len):
    """(port loss, port gradients by path, JAX loss, JAX gradients, the
    port's api, params and batch) of reduced llava at mxint4 over a batch
    of two rows of ``text_len`` tokens behind the 24-token prefix."""
    jqat = JQAT(formats=TRAIN_FORMATS_MXINT)
    japi = jget_model(jreduced(ARCH), jqat)
    params = served[1]
    tapi = make_model(get_reduced(ARCH),
                      qat=QATConfig(formats=TRAIN_FORMATS_MXINT))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 512, size=(2, text_len)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
             "vision_embeds": _embeds(2)}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: japi.train_loss(p, b, jnp.int32(1))[0]))(
        params, jax.tree_util.tree_map(jnp.asarray, batch))
    tparams = params_from_numpy(_flat(params), tapi.cfg, device="cpu")
    leaves = [(k, p.requires_grad_(True)) for k, p in flatten_paths(tparams)]
    loss_t, _ = tapi.train_loss(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, 1)
    grads_t = torch.autograd.grad(loss_t, [p for _, p in leaves])
    return (loss_t, {k: g for (k, _), g in zip(leaves, grads_t)},
            float(loss_j), _flat(grads_j), tapi, tparams, batch)


def _check_grads(loss_t, grads_t, loss_j, want):
    np.testing.assert_allclose(loss_t.item(), loss_j, rtol=1e-4)
    assert set(want) == set(grads_t)
    for k, g in grads_t.items():
        np.testing.assert_allclose(
            g.numpy(), want[k], rtol=1e-4,
            atol=1e-6 * float(np.abs(want[k]).max()), err_msg=k)


def test_train_loss_and_grads_match_jax(served):
    loss_t, grads_t, loss_j, want, tapi, tparams, batch = \
        _train_loss_and_grads(served, 40)
    _check_grads(loss_t, grads_t, loss_j, want)
    # the prefix moves the loss: it is not dropped before the stack
    with torch.no_grad():
        other, _ = tapi.train_loss(
            tparams, {k: torch.from_numpy(v) for k, v in
                      dict(batch, vision_embeds=_embeds(2, 9)).items()}, 1)
    assert other.item() != loss_t.item()


def test_train_at_a_length_the_chunk_does_not_divide_matches_jax(served):
    """24 + 77 = 101 positions: the reference's flash attention halves its
    chunk of 64 down to 1 (101 is odd), the port's pads to 128 and walks
    two chunks of 64, so the sums run in another order; the tolerances
    stay the same."""
    from repro_torch.models.flash_vjp import _plan
    assert _plan(V + 77, V + 77, True, None, 64)[:4] == (64, 64, 128, 128)
    loss_t, grads_t, loss_j, want, *_ = _train_loss_and_grads(served, 77)
    _check_grads(loss_t, grads_t, loss_j, want)


@pytest.mark.parametrize("fmt", ["bf16", "mxint8"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("lengths", [False, True])
def test_prefill_then_decode_match_jax(served, layout, fmt, lengths):
    japi, jparams, ja = served
    cfg = get_reduced(ARCH)
    api = make_model(cfg)
    if fmt == "bf16":
        jw, tw = jparams, params_from_numpy(_flat(jparams), cfg,
                                            device="cpu")
        jpre, jstep = japi.prefill, japi.serve_step
        tapi = api
    else:
        jw = jpacked(ja, jparams, target_fmt=fmt, dtype=jnp.float32)
        jpre = make_packed_fn(japi, japi.prefill)
        jstep = make_packed_fn(japi, japi.serve_step)
        tw = make_packed_params(_to_port(ja), target_fmt=fmt,
                                dtype=torch.float32)
        tapi = api.with_qmm(make_qmm())
    if layout == "paged":
        tapi = tapi.with_serving(make_qmm() if fmt != "bf16" else None,
                                 "paged_kernel")
    rng = np.random.default_rng(5)
    b, s, max_len = 2, 16, 40              # 64 positions: 8 pages
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    batch = {"tokens": tokens, "vision_embeds": _embeds(b, 1)}
    if lengths:
        batch["lengths"] = np.array([s, 11], np.int32)
    kw = dict(kv_layout="paged", page_size=8) if layout == "paged" else {}
    jc = japi.init_cache(b, max_len, **kw)
    tc = tapi.init_cache(b, max_len, device="cpu", **kw)
    if layout == "paged":
        # each row its own pages, 1..8 and 9..16
        bt = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
        jc = dict(jc, block_table=jnp.asarray(bt))
        tc["block_table"].copy_(torch.from_numpy(bt))
    jl, jc, jlen = jpre(jw, jax.tree_util.tree_map(jnp.asarray, batch), jc)
    tl, tc, tlen = tapi.prefill(
        tw, {k: torch.from_numpy(v) for k, v in batch.items()}, tc)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert tlen.tolist() == ([s + V, 11 + V] if lengths else [s + V] * 2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = jstep(jw, {"tokens": jnp.asarray(nxt)}, jc, jlen)
        tl, tc = tapi.serve_step(tw, {"tokens": torch.from_numpy(nxt)}, tc,
                                 tlen)
        jlen, tlen = jlen + 1, tlen + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def _message(fn, exc=ValueError):
    with pytest.raises(exc) as ei:
        fn()
    return str(ei.value)


@pytest.mark.parametrize("entry", ["prefill_chunk", "mixed_step",
                                   "verify_step"])
def test_model_refusals_say_what_the_reference_says(served, entry):
    japi, jparams, _ = served
    cfg = get_reduced(ARCH)
    tapi = make_model(cfg)
    tparams = params_from_numpy(_flat(jparams), cfg, device="cpu")
    toks = np.zeros((1, 8), np.int32)
    extra = np.array([8], np.int32)
    key = "lengths" if entry == "prefill_chunk" else "q_len"
    batch = {"tokens": toks, key: extra}
    last = 0 if entry == "prefill_chunk" else np.zeros(1, np.int32)
    want = _message(lambda: getattr(japi, entry)(
        jparams, batch, japi.init_cache(1, 16), last))
    got = _message(lambda: getattr(tapi, entry)(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
        tapi.init_cache(1, 16, device="cpu"),
        last if entry == "prefill_chunk" else torch.from_numpy(last)))
    assert got == want


def test_engine_refuses_at_construction(served):
    """The reference engine is built and fails at its first admission (its
    prefill reads ``batch["vision_embeds"]``, which a request cannot
    carry); the port's refuses when it is built, naming ROADMAP C.10."""
    japi, jparams, ja = served
    jeng = JEngine(japi, ja, fused=False, param_template=jparams,
                   batch_slots=2, max_len=32)
    msg = _message(lambda: jeng.generate(
        [JRequest(0, np.arange(8, dtype=np.int32), 2)]), KeyError)
    assert "vision_embeds" in msg
    got = _message(lambda: ElasticEngine(
        make_model(get_reduced(ARCH)), _to_port(ja), batch_slots=2,
        max_len=32, device="cpu"))
    assert "ROADMAP C.10" in got and "vision_embeds" in got
