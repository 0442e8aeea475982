"""Slice-and-Scale as a byte table, its fused split-N packing, and the packed
serving tree built one leaf at a time, held against the JAX package.

B5 on the card converts every code by a 256-entry table built from the
code byte alone. These tests show on the CPU why that is exact:
  - every one of the 256 code bytes (and every int8 scale) goes through
    JAX ``core/slice_scale.py::slice_and_scale`` and the port's plain
    version, bit for bit, for every down-conversion pair and bs 16/32/64;
  - the port's plain version of any quantized tensor equals a lookup of its
    codes in the table that the 256 codes give (a code needs neither its
    neighbours nor its block's scale).
The fused mode's plain version, ``ops.ss_convert_int4_splitn``, equals JAX
``pack_leaf_int4`` of JAX ``slice_and_scale``; and ``make_packed_params``,
which converts each whole (stacked) leaf at once, equals JAX's packed tree
leaf for leaf: codes, packed bytes, scales and metadata.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mx as jmx
from repro.core import slice_scale as jss
from repro.core.anchor import AnchorModel as JAnchor
from repro.core.formats import get_format as jformat
from repro.serve.packed_params import (PackedInt4Leaf as JPacked4,
                                       make_packed_params as jpacked,
                                       pack_leaf_int4 as jpack4)
from repro_torch.core.anchor import AnchorModel
from repro_torch.core.formats import get_format as tformat
from repro_torch.core.mx import MXTensor
from repro_torch.core.packed import splitn_ok
from repro_torch.core.slice_scale import slice_and_scale
from repro_torch.core.tree import flatten_paths
from repro_torch.kernels import ops
from repro_torch.kernels import mx_quantize as tkmq
from repro_torch.kernels import ss_convert as tkss
from repro_torch.serve.packed_params import (PackedInt4Leaf, convert_leaf,
                                             make_packed_params,
                                             pack_leaf_int4)

SS_PAIRS = [("mxint8", f"mxint{b}") for b in range(2, 8)] \
    + [("mxfp8", f"mxfp{b}") for b in range(4, 8)] \
    + [("mxint6", "mxint3"), ("mxint6", "mxint4"), ("mxfp6", "mxfp4"),
       ("mxfp7", "mxfp5")]


def _all_codes(high: str, bs: int):
    """(256, 2) codes holding every byte value twice, blocked along axis 0,
    and (2, 256 / bs) scales running over the int8 range (both ends)."""
    u = np.concatenate([np.arange(256), np.arange(256)[::-1]]).astype(
        np.uint8).reshape(2, 256).T.copy()
    codes = u.view(np.int8) if high.startswith("mxint") else u
    nb = 256 // bs
    scales = np.linspace(-128, 127, 2 * nb).round().astype(np.int8)
    return codes, scales.reshape(2, nb)


def _both(codes, scales, name, bs, axis=0):
    j = jmx.MXTensor(codes=jnp.asarray(codes), scale_exp=jnp.asarray(scales),
                     fmt=jformat(name, bs), block_axis=axis)
    t = MXTensor(codes=torch.from_numpy(codes.copy()),
                 scale_exp=torch.from_numpy(scales.copy()),
                 fmt=tformat(name, bs), block_axis=axis)
    return j, t


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("bs", [16, 32, 64])
@pytest.mark.parametrize("high,low", SS_PAIRS)
def test_all_256_codes_match_jax(high, low, bs):
    j, t = _both(*_all_codes(high, bs), high, bs)
    want = jss.slice_and_scale(j, jformat(low, bs))
    got = slice_and_scale(t, tformat(low, bs))
    _same(want.codes, got.codes)
    _same(want.scale_exp, got.scale_exp)
    assert got.codes.dtype == (torch.int8 if high.startswith("mxint")
                               else torch.uint8)


@pytest.mark.parametrize("high,low", SS_PAIRS)
def test_conversion_is_a_lookup_of_the_code_byte(high, low):
    """The plain version on a quantized tensor (scales of every size, codes
    beside any neighbours) equals its codes looked up in the table of the
    256 codes."""
    codes, scales = _all_codes(high, 32)
    _, t = _both(codes, scales, high, 32)
    table = slice_and_scale(t, tformat(low, 32)).codes.view(torch.uint8)
    table = table.T.reshape(-1)[:256]            # code byte c -> table[c]
    rng = np.random.default_rng(1)
    v = (rng.normal(size=(3, 128, 24)) * 10.0 ** rng.uniform(
        -6, 6, size=(3, 1, 24))).astype(np.float32)
    q = jmx.quantize(jnp.asarray(v), jformat(high, 32), 1)
    _, tq = _both(np.asarray(q.codes), np.asarray(q.scale_exp), high, 32, 1)
    got = slice_and_scale(tq, tformat(low, 32))
    looked_up = table[tq.codes.view(torch.uint8).long()]
    assert torch.equal(got.codes.view(torch.uint8), looked_up)


# (shape, block axis): a (K, N) weight, a stacked (G, K, N) leaf, a stacked
# leaf whose N/2 is not a multiple of 16
SPLITN = [((128, 64), 0), ((3, 64, 96), 1), ((2, 64, 40), 1)]


@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("shape,axis", SPLITN)
@pytest.mark.parametrize("high", ["mxint8", "mxint6"])
def test_fused_splitn_plain_matches_jax_pack(high, shape, axis, bs):
    rng = np.random.default_rng(2)
    v = rng.normal(size=shape).astype(np.float32)
    j = jmx.quantize(jnp.asarray(v), jformat(high, bs), axis)
    _, t = _both(np.asarray(j.codes), np.asarray(j.scale_exp), high, bs, axis)
    want = jpack4(jss.slice_and_scale(j, jformat("mxint4", bs)))
    assert want.layout == "splitn"
    before = dict(tkss.launches)
    packed, scales = ops.ss_convert_int4_splitn(t, tformat("mxint4", bs))
    assert dict(tkss.launches) == before             # plain on the CPU
    _same(want.packed, packed)
    _same(want.scale_exp, scales)
    ref = pack_leaf_int4(slice_and_scale(t, tformat("mxint4", bs)))
    assert torch.equal(ref.packed, packed)
    assert torch.equal(ref.scale_exp, scales)


@pytest.mark.parametrize("shape,axis", [((2, 64, 7), 1), ((2, 32, 64), 2)])
def test_fused_splitn_refuses_what_splitn_cannot_hold(shape, axis):
    """An odd last axis, or blocks along the last axis: the fused mode
    raises, and ``convert_leaf`` takes the split-K fallback as JAX does."""
    assert not splitn_ok(shape, axis)
    rng = np.random.default_rng(3)
    v = rng.normal(size=shape).astype(np.float32)
    j = jmx.quantize(jnp.asarray(v), jformat("mxint8", 32), axis)
    _, t = _both(np.asarray(j.codes), np.asarray(j.scale_exp), "mxint8", 32,
                 axis)
    with pytest.raises(ValueError):
        ops.ss_convert_int4_splitn(t, tformat("mxint4", 32))
    want = jpack4(jss.slice_and_scale(j, jformat("mxint4", 32)))
    got = convert_leaf(t, tformat("mxint4", 32))
    assert want.layout == got.layout == "splitk"
    _same(want.packed, got.packed)
    _same(want.scale_exp, got.scale_exp)


def test_fused_splitn_takes_only_4_bit_mxint():
    codes, scales = _all_codes("mxint8", 32)
    _, t = _both(codes, scales, "mxint8", 32)
    with pytest.raises(ValueError):
        ops.ss_convert_int4_splitn(t, tformat("mxint6", 32))


# A small anchor: stacked and 2D projection leaves blocked along K, a leaf
# with odd N and one blocked along its last axis (split-K at 4 bits), and a
# float leaf.
LEAVES = {"['blocks']['attn']['wq']": ((3, 64, 96), 1),
          "['blocks']['mlp']['w_down']": ((3, 128, 40), 1),
          "['head']": ((64, 32), 0),
          "['odd']": ((2, 64, 7), 1),
          "['last']": ((2, 32, 64), 2)}


def _anchors(name: str, bs: int):
    rng = np.random.default_rng(4)
    jq, tq = {}, {}
    for path, (shape, axis) in LEAVES.items():
        v = (rng.normal(size=shape) * 0.05).astype(np.float32)
        jq[path] = jmx.quantize(jnp.asarray(v), jformat(name, bs), axis)
        tq[path] = _both(np.asarray(jq[path].codes),
                         np.asarray(jq[path].scale_exp), name, bs, axis)[1]
    norm = rng.normal(size=(3, 96)).astype(np.float32)
    j = JAnchor(quantized=jq, raw={"['norm']": jnp.asarray(norm)},
                fmt_name=jformat(name, bs).name)
    t = AnchorModel(quantized=tq, raw={"['norm']": torch.from_numpy(norm)},
                    fmt_name=tformat(name, bs).name)
    z = jnp.zeros(())
    template = {"head": z, "odd": z, "last": z, "norm": z,
                "blocks": {"attn": {"wq": z}, "mlp": {"w_down": z}}}
    return j, t, template


@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("anchor,target", [
    ("mxint8", "mxint8"), ("mxint8", "mxint6"), ("mxint8", "mxint4"),
    ("mxint8", "mxint2"), ("mxfp8", "mxfp8"), ("mxfp8", "mxfp6"),
    ("mxfp8", "mxfp4")])
def test_packed_tree_matches_jax_leaf_for_leaf(anchor, target, bs):
    j, t, template = _anchors(anchor, bs)
    jt = jpacked(j, template, target_fmt=target, dtype=jnp.float32)
    tt = make_packed_params(t, target_fmt=target, dtype=torch.float32)
    is_c = lambda x: hasattr(x, "scale_exp")                # noqa: E731
    jl = {jax.tree_util.keystr(p): v for p, v in
          jax.tree_util.tree_flatten_with_path(jt, is_leaf=is_c)[0]}
    tl = dict(flatten_paths(tt))
    assert set(jl) == set(tl)
    for k, jv in jl.items():
        tv = tl[k]
        if isinstance(jv, JPacked4):
            assert isinstance(tv, PackedInt4Leaf)
            assert (tv.shape, tv.block_axis, tv.layout, tv.fmt_name) == \
                (jv.shape, jv.block_axis, jv.layout, jv.fmt_name)
            _same(jv.packed, tv.packed)
            _same(jv.scale_exp, tv.scale_exp)
        elif is_c(jv):
            assert isinstance(tv, MXTensor)
            assert (tv.block_axis, tv.fmt.name) == (jv.block_axis,
                                                     jv.fmt.name)
            _same(jv.codes, tv.codes)
            _same(jv.scale_exp, tv.scale_exp)
        else:
            _same(jv, tv)


@pytest.mark.parametrize("name", ["mxint8", "mxint4", "mxfp8", "mxfp6",
                                  "mxfp4"])
def test_plain_quantize_of_inf_blocks_matches_jax(name):
    """A block holding +-inf: frexp gives inf the exponent 0 in both
    packages, so its scale is -1 - emax and inf saturates. B6 and B7 on the
    card follow the port's plain version here (their card tests plant
    +-inf). No value of these blocks scales to an f32 subnormal, which XLA
    on the CPU would flush."""
    rng = np.random.default_rng(5)
    v = rng.uniform(-1, 1, size=(64, 6)).astype(np.float32)
    v[3, 0], v[40, 1] = np.inf, -np.inf
    v[:32, 3] = np.inf
    fmt = jformat(name, 32)
    want = jmx.quantize(jnp.asarray(v), fmt, 0)
    before = dict(tkmq.launches)
    got = ops.mx_quantize(torch.from_numpy(v), tformat(name, 32), 0)
    assert dict(tkmq.launches) == before                # plain on the CPU
    _same(want.codes, got.codes)
    _same(want.scale_exp, got.scale_exp)
