"""The port's MX quantize, fake-quant and Slice-and-Scale (the plain versions
of B6, B7 and B5) and its straight-through fake-quant, held against the JAX
package.

Same numpy inputs through both. The plain versions must equal the JAX
core's bit for bit at every format of ``EVAL_FORMATS_MXINT`` /
``EVAL_FORMATS_MXFP``, block sizes 16/32/64, blocks along axis 0, along
the last axis, and along axis 1 of a stacked (G, K, N) leaf; and the Pallas
kernels in interpret mode on data where the Pallas helpers and the core
agree (normal values: for a block whose scale clips to -127, core
dequantizes to zeros and the Pallas ``pow2i`` saturates at 2^-126; the
Pallas fake-quant also gives +0 where core gives -0).
Subnormal inputs are left out of the comparisons with JAX: XLA on the CPU
flushes them to zero, the port keeps them (IEEE); the card tests hold the
kernels against the plain versions on subnormal blocks.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mx as jmx
from repro.core import qat as jqat
from repro.core import slice_scale as jss
from repro.core.formats import (EVAL_FORMATS_MXFP, EVAL_FORMATS_MXINT,
                                get_format as jformat)
from repro.kernels import ops as jops
from repro_torch.core import fake_quant as tfq
from repro_torch.core import qat as tqat
from repro_torch.core.formats import get_format as tformat
from repro_torch.core.mx import MXTensor, quantize, quantize_dequantize
from repro_torch.core.slice_scale import slice_and_scale
from repro_torch.core.tree import flatten_paths
from repro_torch.kernels import fake_quant as tkfq
from repro_torch.kernels import mx_quantize as tkmq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ss_convert as tkss

# the module, not the function ``repro.core`` exports under the same name
jfq = importlib.import_module("repro.core.fake_quant")

FORMATS = EVAL_FORMATS_MXINT + EVAL_FORMATS_MXFP
# name -> (shape, block axis): a (K, N) weight blocked along K, blocks
# along the last axis, a stacked (G, K, N) leaf blocked along K
LAYOUTS = {"axis0": ((128, 24), 0), "last": ((12, 128), -1),
           "stacked": ((3, 64, 20), 1)}
SS_PAIRS = [("mxint8", f"mxint{b}") for b in range(2, 8)] \
    + [("mxfp8", f"mxfp{b}") for b in range(4, 8)] \
    + [("mxint6", "mxint3"), ("mxfp6", "mxfp4")]

_jquantize = jax.jit(jmx.quantize, static_argnums=(1, 2))


@functools.lru_cache(maxsize=None)
def _jcore(name: str, bs: int):
    """One jitted JAX-core pass over every layout at (format, bs): the
    codes, scales and fake-quant values of each (one compile, not three)."""
    fmt = jformat(name, bs)
    axes = [ax % len(shape) for shape, ax in LAYOUTS.values()]

    def run(vs):
        return [(jmx.quantize(v, fmt, ax), jmx.quantize_dequantize(v, fmt, ax))
                for v, ax in zip(vs, axes)]
    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _jss(high: str, low: str, bs: int):
    """Jitted JAX-core quantize to ``high`` then Slice-and-Scale to ``low``
    over every layout."""
    fh, fl = jformat(high, bs), jformat(low, bs)
    axes = [ax % len(shape) for shape, ax in LAYOUTS.values()]

    def run(vs):
        out = []
        for v, ax in zip(vs, axes):
            t = jmx.quantize(v, fh, ax)
            out.append((t, jss.slice_and_scale(t, fl)))
        return out
    return jax.jit(run)


def _values(shape, axis, bs, seed=0, tiny_block=False):
    """Normals scaled over 8 decades per block column, an all-zero block,
    signed zeros, and a block of exact powers of two and halfway values;
    ``tiny_block`` adds a block of normal values with max in
    [2^-126, 2^-120), whose 8-bit scale clips to -127."""
    rng = np.random.default_rng(seed)
    moved = list(shape)
    k = moved.pop(axis % len(shape))
    m = int(np.prod(moved))
    flat = rng.normal(size=(m, k)) * 10.0 ** rng.uniform(-4, 4, size=(m, 1))
    flat = flat.astype(np.float32)
    flat[0, :bs] = 0.0
    flat[1, :bs // 2] = -0.0
    flat[2, :bs] = (2.0 ** rng.integers(-8, 2, size=bs)
                    * rng.choice([1.0, 1.5, 1.25, 2.5, 3.5], size=bs))
    if tiny_block:
        flat[3, :bs] = (rng.choice([-1.0, 1.0], size=bs) * 2.0 ** -126
                        * rng.uniform(1.0, 32.0, size=bs))
    out = flat.reshape(*moved, k)
    return np.ascontiguousarray(np.moveaxis(out, -1, axis % len(shape)))


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _same_bits(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                  b.numpy().view(np.int32))


def _port(j) -> MXTensor:
    return MXTensor(codes=torch.from_numpy(np.array(j.codes)),
                    scale_exp=torch.from_numpy(np.array(j.scale_exp)),
                    fmt=tformat(j.fmt.name, j.fmt.block_size),
                    block_axis=j.block_axis)


# ---------------------------------------------------------------------------
# Plain B6 / B7 / B5 against JAX core
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bs", [16, 32, 64])
@pytest.mark.parametrize("name", FORMATS)
def test_plain_quantize_and_fake_quant_match_jax_core(name, bs):
    vs = [_values(shape, ax, bs, tiny_block=True)
          for shape, ax in LAYOUTS.values()]
    for v, (shape, axis), (j, jq) in zip(
            vs, LAYOUTS.values(), _jcore(name, bs)([jnp.asarray(v)
                                                    for v in vs])):
        t = quantize(torch.from_numpy(v), tformat(name, bs), axis=axis)
        _same(j.codes, t.codes)
        _same(j.scale_exp, t.scale_exp)
        assert t.block_axis == j.block_axis
        _same_bits(jq, quantize_dequantize(torch.from_numpy(v),
                                           tformat(name, bs), axis=axis))


@pytest.mark.parametrize("bs", [16, 32, 64])
@pytest.mark.parametrize("high,low", SS_PAIRS)
def test_plain_slice_and_scale_matches_jax_core(high, low, bs):
    vs = [_values(shape, ax, bs, seed=1, tiny_block=True)
          for shape, ax in LAYOUTS.values()]
    for j, jl in _jss(high, low, bs)([jnp.asarray(v) for v in vs]):
        t = slice_and_scale(_port(j), tformat(low, bs))
        _same(jl.codes, t.codes)
        _same(jl.scale_exp, t.scale_exp)


# ---------------------------------------------------------------------------
# Plain B6 / B7 / B5 against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------
PALLAS_CASES = [(n, 32, lay) for n in FORMATS for lay in sorted(LAYOUTS)] \
    + [(n, bs, "axis0") for n in ("mxint8", "mxint4", "mxfp8", "mxfp4")
       for bs in (16, 64)]


@pytest.mark.parametrize("name,bs,layout", PALLAS_CASES)
def test_plain_quantize_and_fake_quant_match_pallas(name, bs, layout):
    shape, axis = LAYOUTS[layout]
    v = _values(shape, axis, bs, seed=2)
    jf = jformat(name, bs)
    pj = jops.mx_quantize(jnp.asarray(v), jf, axis, interpret=True)
    t = quantize(torch.from_numpy(v), tformat(name, bs), axis=axis)
    _same(pj.codes, t.codes)
    _same(pj.scale_exp, t.scale_exp)
    # equal values; the Pallas kernel dequantizes the int codes, so a
    # rounded-to-zero negative value is +0 there and -0 in the core
    _same(jops.fake_quant(jnp.asarray(v), jf, axis, interpret=True),
          quantize_dequantize(torch.from_numpy(v), tformat(name, bs),
                              axis=axis))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("high,low", SS_PAIRS)
def test_plain_slice_and_scale_matches_pallas(high, low, layout):
    shape, axis = LAYOUTS[layout]
    v = _values(shape, axis, 32, seed=3)
    j = _jquantize(jnp.asarray(v), jformat(high, 32), axis % len(shape))
    pj = jops.ss_convert(j, jformat(low, 32), interpret=True)
    t = slice_and_scale(_port(j), tformat(low, 32))
    _same(pj.codes, t.codes)
    _same(pj.scale_exp, t.scale_exp)


def test_wrappers_take_the_plain_path_on_the_cpu():
    """On CPU tensors the wrappers compute the plain versions and launch
    nothing."""
    v = torch.from_numpy(_values((64, 40), 0, 32, seed=4))
    fmt, low = tformat("mxint8", 32), tformat("mxint4", 32)
    before = (dict(tkmq.launches), dict(tkfq.launches), dict(tkss.launches))
    t = tops.mx_quantize(v, fmt, axis=0)
    want = quantize(v, fmt, axis=0)
    assert torch.equal(t.codes, want.codes)
    assert torch.equal(t.scale_exp, want.scale_exp)
    got = tops.ss_convert(t, low)
    assert torch.equal(got.codes, slice_and_scale(want, low).codes)
    assert torch.equal(tops.fake_quant(v, fmt, 0),
                       quantize_dequantize(v, fmt, axis=0))
    assert tops.fake_quant(v, fmt, 0, out_dtype=torch.bfloat16).dtype \
        == torch.bfloat16
    assert (dict(tkmq.launches), dict(tkfq.launches),
            dict(tkss.launches)) == before


# ---------------------------------------------------------------------------
# The straight-through fake-quant
# ---------------------------------------------------------------------------
TRAIN_INT = ("mxint2", "mxint4", "mxint6", "mxint8")
TRAIN_FP = ("mxfp4", "mxfp6", "mxfp8")


def _weight(seed=5):
    w = _values((64, 48), 0, 32, seed=seed)
    w[5, 7] = -0.0                    # the pass-through branch's STE value
    return w


def _forward_and_grad(fn, w_np, out_dtype=None):
    """Port value and the gradient a random cotangent brings back."""
    w = torch.from_numpy(w_np).requires_grad_(True)
    out = fn(w)
    assert out.dtype == (out_dtype or torch.float32)
    g = torch.from_numpy(np.random.default_rng(6).normal(
        size=w_np.shape).astype(np.float32)).to(out.dtype)
    out.backward(g)
    assert w.grad.dtype == torch.float32
    torch.testing.assert_close(w.grad, g.to(torch.float32), rtol=0, atol=0)
    return out.detach()


@pytest.mark.parametrize("name", TRAIN_INT + TRAIN_FP)
def test_ste_fake_quant_matches_jax(name):
    w = _weight()
    want = jfq.fake_quant(jnp.asarray(w), jformat(name), axis=0)
    got = _forward_and_grad(
        lambda x: tfq.fake_quant(x, tformat(name), axis=0), w)
    _same_bits(want, got)


@pytest.mark.parametrize("anchor,target", [("mxint8", "mxint4"),
                                           ("mxint8", "mxint2"),
                                           ("mxint8", "mxint8"),
                                           ("mxfp8", "mxfp4")])
def test_ste_fake_quant_anchored_matches_jax(anchor, target):
    w = _weight(seed=7)
    want = jfq.fake_quant_anchored(jnp.asarray(w), jformat(anchor),
                                   jformat(target), axis=0)
    got = _forward_and_grad(lambda x: tfq.fake_quant_anchored(
        x, tformat(anchor), tformat(target), axis=0), w)
    _same_bits(want, got)


@pytest.mark.parametrize("anchored", [False, True])
@pytest.mark.parametrize("idx", range(len(TRAIN_INT) + 1))
def test_ste_switch_matches_jax_pass_through_included(idx, anchored):
    w = _weight(seed=8)
    jf = tuple(jformat(n) for n in TRAIN_INT)
    tf = tuple(tformat(n) for n in TRAIN_INT)
    if anchored:
        want = jfq.fake_quant_anchored_switch(
            jnp.asarray(w), jformat("mxint8"), jf, jnp.int32(idx), axis=0)
        fn = lambda x: tfq.fake_quant_anchored_switch(  # noqa: E731
            x, tformat("mxint8"), tf, idx, axis=0)
    else:
        want = jfq.fake_quant_switch(jnp.asarray(w), jf, jnp.int32(idx),
                                     axis=0)
        fn = lambda x: tfq.fake_quant_switch(x, tf, idx, axis=0)  # noqa
    _same_bits(want, _forward_and_grad(fn, w))


def test_ste_casts_to_the_compute_dtype_with_an_f32_gradient():
    w = _weight(seed=9)
    got = _forward_and_grad(lambda x: tfq.fake_quant(
        x, tformat("mxint4"), axis=0, out_dtype=torch.bfloat16), w,
        out_dtype=torch.bfloat16)
    want = jfq.fake_quant(jnp.asarray(w), jformat("mxint4"), axis=0) \
        .astype(jnp.bfloat16)
    _same(np.asarray(want.astype(jnp.float32)), got.to(torch.float32))


@pytest.mark.parametrize("path", ["['blocks'][0]['mlp']['w_up']",
                                  "['embed']", "blk0.attn.wq",
                                  "['blocks'][0]['attn']['q_norm']"])
@pytest.mark.parametrize("anchor", [None, "mxint8"])
def test_qat_config_apply_matches_jax(anchor, path):
    w = _weight(seed=10)
    jc = jqat.QATConfig(formats=TRAIN_INT, anchor=anchor)
    tc = tqat.QATConfig(formats=TRAIN_INT, anchor=anchor)
    assert tc.enabled and tc.format_objs() == tuple(
        tformat(n) for n in TRAIN_INT)
    for idx in (0, 2, 4):
        _same_bits(jc.apply(jnp.asarray(w), path, jnp.int32(idx)),
                   tc.apply(torch.from_numpy(w), path, idx))


def test_qat_config_keeps_the_serving_keyword_calls():
    c = tqat.QATConfig(anchor="mxint8", block_size=16)
    assert not c.enabled and c.anchor_obj() == tformat("mxint8", 16)
    assert c.block_axis == 0 and c.formats == ()


@pytest.mark.parametrize("n,per,total", [(4, 3, 12), (3, 1, 7), (1, 5, 5)])
def test_schedules_match_jax(n, per, total):
    np.testing.assert_array_equal(jqat.sequential_schedule(n, per),
                                  tqat.sequential_schedule(n, per))
    np.testing.assert_array_equal(jqat.interleaved_schedule(n, total),
                                  tqat.interleaved_schedule(n, total))
    np.testing.assert_array_equal(jqat.fp_schedule(total, n),
                                  tqat.fp_schedule(total, n))
    np.testing.assert_array_equal(jqat.single_format_schedule(n - 1, total),
                                  tqat.single_format_schedule(n - 1, total))


@functools.lru_cache(maxsize=None)
def _reduced_params():
    from repro.configs import get_reduced
    from repro.models import get_model
    api = get_model(get_reduced("qwen3-4b"))
    params = jax.jit(api.init_params)(jax.random.PRNGKey(3))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return params, {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}


@pytest.mark.parametrize("name", ["mxint4", "mxfp6"])
def test_ptq_pytree_matches_jax(name):
    from repro_torch.configs import get_reduced
    from repro_torch.interop import params_from_numpy
    params, flat = _reduced_params()
    want = jax.tree_util.tree_flatten_with_path(jqat.ptq_pytree(
        params, jqat.QATConfig(), jformat(name)))[0]
    got = dict(flatten_paths(tqat.ptq_pytree(
        params_from_numpy(flat, get_reduced("qwen3-4b"), device="cpu"),
        tqat.QATConfig(), tformat(name))))
    for p, x in want:
        _same_bits(x, got[jax.tree_util.keystr(p)])
