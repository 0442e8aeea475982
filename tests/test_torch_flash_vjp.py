"""The port's flash attention with the O(S)-memory backward
(``models/flash_vjp.py``) and remat (``models/transformer.py``) against the
JAX package.

- ``flash_attention_vjp`` values and (dq, dk, dv) against
  ``repro.models.flash_vjp.flash_attention_vjp`` on the same inputs:
  window None and 24, chunk 16 and 32, G = 2, seq 64, and lengths the
  chunk does not divide, where the reference halves the chunk and the
  port pads to a multiple of it (96, 200 at 64; 97 at 32); rtol 2e-5,
  atol 2e-5, the reference's own tolerance (``tests/test_attention.py``);
- ``layers.flash_attention`` without causality, Sq != Skv, neither a
  multiple of the chunk (the padded keys masked), against JAX's;
- the causal skip of kv chunks past a q chunk is bit-exact against the
  full walk, and a length the chunk divides (or at most the chunk) keeps
  the reference's plan with no padding;
- what the forward saves for the backward has O(S) elements, never
  Sq x Skv (``torch.autograd.graph.saved_tensors_hooks``), in the function
  and in a model's training loss, where autograd through
  ``prefill_attention`` saves H x S x S;
- reduced qwen3-4b ``train_loss`` and gradients with ``flash_vjp`` on
  against JAX (rtol 1e-4; atol 1e-6 * max|g| per leaf, as
  ``tests/test_torch_train.py``) and against the port with it off (the
  same tolerance);
- remat on and off give bit-identical gradients on the CPU, equal to
  JAX's; ``remat_inner`` at ``scan_group=2`` likewise; under ``no_grad``
  (serving) and with a cache nothing is checkpointed;
- starcoder2-3b and qwen2-72b with seeded nonzero biases through the
  flash path: the loss at rtol 1e-4 and each leaf's gradient within 1e-4
  of JAX's in norm (the biased keys' wk / bk gradients carry
  package-specific rounding residues elementwise; see the test).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jreduced
from repro.core.formats import TRAIN_FORMATS_MXINT
from repro.core.qat import QATConfig as JQAT
from repro.models import get_model as jget_model
from repro.models.flash_vjp import _chunk_len as jchunk_len
from repro.models.flash_vjp import flash_attention_vjp as jflash
from repro.models.layers import flash_attention as jflash_plain
from repro_torch.configs import get_reduced
from repro_torch.core.qat import QATConfig
from repro_torch.core.tree import flatten_paths
from repro_torch.interop import params_from_numpy
from repro_torch.models import flash_vjp as FV
from repro_torch.models import transformer as T
from repro_torch.models.flash_vjp import _chunk_len, flash_attention_vjp
from repro_torch.models.layers import flash_attention

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(sq, seed=0, b=2, h=4, hkv=2, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sq, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sq, hkv, d)).astype(np.float32)
    ct = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, ct


@pytest.mark.parametrize("sq,chunk", [(64, 16), (64, 32), (96, 64),
                                      (200, 64), (97, 32)])
@pytest.mark.parametrize("window", [None, 24])
def test_values_and_grads_match_jax(sq, chunk, window):
    q, k, v, ct = _qkv(sq)
    kw = dict(causal=True, window=window, chunk=chunk)
    want = jflash(q, k, v, **kw)
    jgrads = jax.grad(lambda *a: jnp.sum(jflash(*a, **kw) * ct),
                      (0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = flash_attention_vjp(tq, tk, tv, **kw)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for t, j in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **TOL)


def test_flash_attention_not_causal_pads_and_masks_keys():
    """The encoder-decoder's cross attention: Sq 100 over Skv 70 at chunk
    32, both padded (to 128 / 96); the padded keys must be masked."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 100, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 70, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 70, 2, 16)).astype(np.float32)
    assert FV._plan(100, 70, False, None, 32)[:4] == (32, 32, 128, 96)
    want = jflash_plain(q, k, v, causal=False, chunk=32)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=False, chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _values_and_grads(sq, chunk, window, causal=True):
    q, k, v, ct = _qkv(sq)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash_attention_vjp(tq, tk, tv, causal=causal, window=window,
                              chunk=chunk)
    (out * torch.from_numpy(ct)).sum().backward()
    return [out.detach(), tq.grad, tk.grad, tv.grad]


@pytest.mark.parametrize("sq,chunk", [(64, 16), (64, 32), (96, 64),
                                      (200, 64), (97, 32)])
@pytest.mark.parametrize("window", [None, 24])
def test_causal_skip_is_bit_exact(monkeypatch, sq, chunk, window):
    """Skipping the kv chunks that causality masks whole changes no bit of
    the values or the gradients (the skipped blocks add exact zeros)."""
    skip = _values_and_grads(sq, chunk, window)
    monkeypatch.setattr(FV, "SKIP_MASKED_CHUNKS", False)
    full = _values_and_grads(sq, chunk, window)
    for a, b in zip(skip, full):
        assert torch.equal(a, b)


def test_plan_pads_only_where_the_chunk_does_not_divide():
    """Where ``chunk`` divides S or S <= ``chunk`` the plan is the
    reference's (``_chunk_len``, no padding): every served bucket and
    published training length keeps its numerics. Elsewhere the chunk
    stays whole and S is padded up to a multiple of it."""
    for s, chunk in ((64, 16), (64, 64), (40, 64), (4096, 1024),
                     (32768, 1024), (1, 1024), (7, 1024)):
        cq, ck, sq_p, skv_p, banded, band, kv_len = FV._plan(
            s, s, True, None, chunk)
        assert (cq, ck, sq_p, skv_p, kv_len) == (
            _chunk_len(s, chunk), _chunk_len(s, chunk), s, s, None)
    assert FV._plan(6976, 6976, True, None, 1024)[:4] == (1024, 1024, 7168,
                                                          7168)
    assert FV._plan(35648, 35648, True, 4096, 1024)[:6] == (
        1024, 1024, 35840, 35840, True, 5120)
    assert FV._plan(96, 96, False, None, 64)[6] == 96
    # causal: 4 chunks of 16 walk 1, 2, 3, 4 kv chunks
    assert [FV._live_chunks(qi, 16, 16, 4, True) for qi in range(4)] == \
        [1, 2, 3, 4]
    assert FV._live_chunks(0, 16, 16, 4, False) == 4


def test_chunk_len_halves_like_the_reference():
    for total, chunk in ((96, 64), (4608, 1024), (64, 64), (80, 64),
                         (7, 4), (1, 1024)):
        assert _chunk_len(total, chunk) == jchunk_len(total, chunk)
    assert _chunk_len(96, 64) == 32 and _chunk_len(4608, 1024) == 512


def test_bf16_inputs_give_bf16_out_and_f32_inside():
    """The output comes back in q's dtype, the gradients in each input's;
    a bf16 cotangent is cast to f32 before the backward, as JAX's astype
    VJP does."""
    q, k, v, ct = _qkv(64)
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16).requires_grad_(True)
                  for a in (q, k, v))
    out = flash_attention_vjp(tq, tk, tv, window=24, chunk=16)
    assert out.dtype == torch.bfloat16
    (out * torch.from_numpy(ct).to(torch.bfloat16)).sum().backward()
    assert tq.grad.dtype == tk.grad.dtype == torch.bfloat16
    ref = flash_attention_vjp(*(t.detach().float() for t in (tq, tk, tv)),
                              window=24, chunk=16)
    np.testing.assert_allclose(out.float().detach().numpy(), ref.numpy(),
                               rtol=1e-2, atol=1e-2)


def _largest_saved(fn):
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return max(sizes)


@pytest.mark.parametrize("window", [None, 64])
def test_forward_saves_nothing_of_size_sq_by_skv(window):
    b, sq, h, hkv, d = 1, 512, 4, 2, 16
    q, k, v, _ = _qkv(sq, b=b, h=h, hkv=hkv, d=d)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    largest = _largest_saved(lambda: flash_attention_vjp(
        tq, tk, tv, window=window, chunk=64))
    assert largest <= b * sq * h * d          # q / out: O(S)
    assert largest < sq * sq


@pytest.mark.parametrize("flash", [True, False])
def test_training_loss_saves_no_score_matrix_with_flash_vjp(flash):
    """A reduced qwen3-4b training loss at S = 256 (remat off, so the
    saved tensors are the forward's own): with flash_vjp the largest saved
    tensor is O(S) (the f32 logits chunk of the loss, 64 x vocab per row);
    without it autograd through prefill_attention saves B x H x S x S."""
    cfg = dataclasses.replace(get_reduced("qwen3-4b"), flash_vjp=flash,
                              remat=False)
    api = T.make_model(cfg)
    params = api.init_params(0, device="cpu")
    for _, p in flatten_paths(params):
        p.requires_grad_(True)
    b, s = 1, 256
    toks = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator()
                         .manual_seed(0))
    largest = _largest_saved(lambda: api.train_loss(
        params, {"tokens": toks, "labels": toks}))
    scores = b * cfg.n_heads * s * s
    if flash:
        assert largest < scores
        assert largest <= b * cfg.seq_chunk * cfg.vocab
    else:
        assert largest >= scores


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


_JAX = {}


def _jax_grads(arch, idx, **over):
    """(batch, JAX params, JAX loss, JAX grads) of a reduced config with
    ``over`` replaced, under direct MF-QAT."""
    key = (arch, idx, tuple(sorted(over.items())))
    if key not in _JAX:
        jcfg = dataclasses.replace(jreduced(arch), **over)
        japi = jget_model(jcfg, JQAT(formats=TRAIN_FORMATS_MXINT))
        params = jax.jit(japi.init_params)(jax.random.PRNGKey(3))
        rng = np.random.default_rng(4)
        tokens = rng.integers(0, 512, size=(2, 64)).astype(np.int32)
        batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b, i: japi.train_loss(p, b, i)[0]))(
            params, jax.tree_util.tree_map(jnp.asarray, batch),
            jnp.int32(idx))
        _JAX[key] = (batch, params, float(loss), _flat(grads))
    return _JAX[key]


def _port_grads(arch, idx, params, batch, **over):
    cfg = dataclasses.replace(get_reduced(arch), **over)
    api = T.make_model(cfg, qat=QATConfig(formats=TRAIN_FORMATS_MXINT))
    tparams = params_from_numpy(_flat(params), cfg, device="cpu")
    leaves = [(k, p.requires_grad_(True)) for k, p in flatten_paths(tparams)]
    loss, _ = api.train_loss(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, idx)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    return loss.item(), {k: g.numpy() for (k, _), g in zip(leaves, grads)}


def _close(got, want):
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(
            g, want[k], rtol=1e-4,
            atol=1e-6 * float(np.abs(want[k]).max()), err_msg=k)


@pytest.mark.parametrize("idx", [1, 4])
def test_train_loss_and_grads_with_flash_vjp_match_jax_and_the_plain_path(
        idx):
    """Reduced qwen3-4b at mxint4 (index 1) and the pass-through (4)."""
    batch, params, loss_j, want = _jax_grads("qwen3-4b", idx)
    loss, got = _port_grads("qwen3-4b", idx, params, batch, flash_vjp=True)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-4)
    _close(got, want)
    loss_p, plain = _port_grads("qwen3-4b", idx, params, batch,
                                flash_vjp=False)
    np.testing.assert_allclose(loss, loss_p, rtol=1e-4)
    _close(got, plain)


@pytest.mark.parametrize("over", [{}, {"scan_group": 2, "remat_inner": True}],
                         ids=["groups", "inner"])
def test_remat_grads_are_bit_identical_and_equal_jax(over):
    """Remat recomputes each group (and with remat_inner each layer) in
    the backward: the same ops on the same inputs, so the same bits."""
    arch = "qwen3-4b"
    batch, params, loss_j, want = _jax_grads(arch, 1, **over)
    loss_on, on = _port_grads(arch, 1, params, batch, remat=True, **over)
    loss_off, off = _port_grads(arch, 1, params, batch, remat=False, **over)
    assert loss_on == loss_off
    for k in on:
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)
    np.testing.assert_allclose(loss_on, loss_j, rtol=1e-4)
    _close(on, want)


def test_remat_wraps_only_training(monkeypatch):
    """Groups are checkpointed under grad with no cache (training), and
    each layer too under remat_inner; under no_grad or with a cache
    (serving) nothing is."""
    calls = []
    real = T.checkpoint

    def counting(fn, *a, **kw):
        calls.append(fn)
        return real(fn, *a, **kw)

    monkeypatch.setattr(T, "checkpoint", counting)
    cfg = dataclasses.replace(get_reduced("qwen3-4b"), n_layers=4,
                              scan_group=2, remat_inner=True)
    api = T.make_model(cfg)
    params = api.init_params(0, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    for _, p in flatten_paths(params):
        p.requires_grad_(True)
    loss, _ = api.train_loss(params, batch)
    assert len(calls) == cfg.n_groups * (1 + cfg.scan_group)
    calls.clear()
    loss.backward()          # the recompute runs the inner layers again
    assert len(calls) == cfg.n_groups * cfg.scan_group
    calls.clear()
    with torch.no_grad():
        api.train_loss(params, batch)
    api.prefill(params, {"tokens": toks}, api.init_cache(1, 16, device="cpu"))
    assert calls == []


@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen2-72b"])
def test_dense_family_flash_grads_match_jax(arch, idx=0):
    """The biased dense configs (q/k/v biases, seeded nonzero) through
    the default flash path against JAX's, at mxint2 (index 0, where the
    elementwise residues are largest): the loss at rtol 1e-4, and each
    leaf's gradient within 1e-4 of JAX's in norm, ||g - g_jax|| / ||g_jax||.
    Elementwise, the biased keys' wk / bk gradients carry rounding residues
    of the flash backward's row sums (~2e-6 of the leaf's largest,
    different in each package), so they are held in norm here and
    elementwise on the plain path
    (``tests/test_torch_dense_family.py``)."""
    japi = jget_model(jreduced(arch), JQAT(formats=TRAIN_FORMATS_MXINT))
    bias_rng = np.random.default_rng(7)

    def with_bias(path, x):         # zero-initialised biases hide a bug
        if jax.tree_util.keystr(path).endswith(("['bq']", "['bk']",
                                                "['bv']", "['b_up']",
                                                "['b_down']")):
            return jnp.asarray(bias_rng.normal(0.0, 0.1, x.shape)
                               .astype(np.float32))
        return x

    params = jax.tree_util.tree_map_with_path(
        with_bias, jax.jit(japi.init_params)(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 512, size=(2, 64)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, b, i: japi.train_loss(p, b, i)[0]))(
        params, jax.tree_util.tree_map(jnp.asarray, batch), jnp.int32(idx))
    loss, got = _port_grads(arch, idx, params, batch)
    np.testing.assert_allclose(loss, float(loss_j), rtol=1e-4)
    want = _flat(grads_j)
    assert set(got) == set(want)
    for k, g in got.items():
        rel = np.linalg.norm(g - want[k]) / max(np.linalg.norm(want[k]),
                                               1e-30)
        assert rel <= 1e-4, (k, rel)
