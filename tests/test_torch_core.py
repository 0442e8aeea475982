"""MX numerics of the PyTorch port held bit-exact against the JAX package.

Same numpy inputs through both: block quantize / dequantize, MXFP
encode / decode, Slice-and-Scale for every same-kind down-conversion, the
checkpoint bit packing and the split-N int4 layout, at block sizes 32 and
16. Every integer result (codes, scales, packed bytes) and every dequantized
value must be identical.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mx as jmx
from repro.core import packed as jpacked
from repro.core import slice_scale as jss
from repro.core.formats import REGISTRY, get_format as jformat
from repro.kernels import common as jcommon
from repro_torch.core import mx as tmx
from repro_torch.core import packed as tpacked
from repro_torch.core import slice_scale as tss
from repro_torch.core.formats import get_format as tformat
from repro_torch.kernels import common as tcommon

# jitted (one compile per format) rather than eager (one per op): same
# integer results, a fraction of the test time
_jquantize = jax.jit(jmx.quantize, static_argnums=(1, 2))
_jss = jax.jit(jss.slice_and_scale, static_argnums=1)

FORMATS = sorted({f.name for f in REGISTRY.values()})
FP_FORMATS = [n for n in FORMATS if n.startswith("mxfp")]
DOWN_PAIRS = [(h, lo) for h in FORMATS for lo in FORMATS
              if jformat(h).kind == jformat(lo).kind
              and jformat(lo).bits < jformat(h).bits]


def _values(shape=(64, 96), seed=0):
    """Normal values scaled per row over 8 decades, with an all-zero block,
    a signed zero and exact powers of two (the rounding edge cases)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=shape) * 10.0 ** rng.uniform(-4, 4, size=(shape[0],
                                                                  1))
    v = v.astype(np.float32)
    v[:32, 3] = 0.0
    v[40, :32] = 0.0
    v[41, 0] = -0.0
    v[42, :8] = 2.0 ** np.arange(-4, 4)
    return v


@functools.lru_cache(maxsize=None)
def _pair(name, bs, axis):
    """(JAX MXTensor, port MXTensor) of the same input."""
    v = _values()
    return (_jquantize(jnp.asarray(v), jformat(name, bs), axis),
            tmx.quantize(torch.from_numpy(v), tformat(name, bs), axis=axis))


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("bs", [32, 16])
@pytest.mark.parametrize("name", FORMATS)
def test_quantize_dequantize_bit_exact(name, bs):
    for axis in (0, 1):
        j, t = _pair(name, bs, axis)
        _same(j.codes, t.codes)
        _same(j.scale_exp, t.scale_exp)
        assert t.codes.dtype == (torch.int8 if name.startswith("mxint")
                                 else torch.uint8)
        _same(jmx.dequantize(j), tmx.dequantize(t))
        _same(jmx.compute_scale_exp(jnp.asarray(_values()), j.fmt, axis),
              tmx.compute_scale_exp(torch.from_numpy(_values()), t.fmt,
                                    axis))


@pytest.mark.parametrize("bs", [32, 16])
@pytest.mark.parametrize("high,low", DOWN_PAIRS)
def test_slice_and_scale_bit_exact(high, low, bs):
    j, t = _pair(high, bs, 0)
    a = _jss(j, jformat(low, bs))
    b = tss.slice_and_scale(t, tformat(low, bs))
    _same(a.codes, b.codes)
    _same(a.scale_exp, b.scale_exp)
    assert b.fmt.name == tformat(low).name and b.fmt.block_size == bs


@pytest.mark.parametrize("name", FP_FORMATS)
def test_fp_encode_decode_bit_exact(name):
    jf, tf = jformat(name), tformat(name)
    codes = np.arange(256, dtype=np.uint8)
    # LUT decode of every byte, NaN pattern included (E4M3 0x7F / 0xFF)
    np.testing.assert_array_equal(
        np.asarray(jmx.decode_fp(jnp.asarray(codes), jf)),
        tmx.decode_fp(torch.from_numpy(codes), tf).numpy())
    # arithmetic decode (kernel numerics): E4M3 0x7F decodes to 480 here
    np.testing.assert_array_equal(
        np.asarray(jcommon.decode_fp_arith(jnp.asarray(codes), jf)),
        tcommon.decode_fp_arith(torch.from_numpy(codes), tf).numpy())
    # encode of every valid value (both zeros included)
    vals = np.asarray(jmx.decode_fp(jnp.asarray(codes[:1 << jf.bits]), jf))
    vals = vals[np.isfinite(vals)]
    _same(jmx.encode_fp(jnp.asarray(vals), jf),
          tmx.encode_fp(torch.from_numpy(vals), tf))
    # round-to-nearest-even into the value set, saturating
    y = _values((64, 64), seed=3) / 1e3
    _same(jmx.quantize_fp_element_value(jnp.asarray(y), jf),
          tmx.quantize_fp_element_value(torch.from_numpy(y), tf))


def test_pow2i_matches_jax_over_the_int8_range():
    e = np.arange(-140, 140, dtype=np.int32)
    _same(jcommon.pow2i(jnp.asarray(e)), tcommon.pow2i(torch.from_numpy(e)))
    # the core's 2^e (ldexp in JAX): exact powers in the normal range, and
    # zero below it, as XLA flushes the subnormal range
    _same(jmx._exp2i(jnp.asarray(e)), tmx._exp2i(torch.from_numpy(e)))


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
def test_pack_np_matches_jax(bits):
    rng = np.random.default_rng(bits)
    lim = 2 ** (bits - 1) - 1
    for signed in (True, False):
        for shape in ((7, 13), (64, 32), (5,)):
            codes = (rng.integers(-lim, lim + 1, size=shape).astype(np.int8)
                     if signed else
                     rng.integers(0, 2 ** bits, size=shape).astype(np.uint8))
            buf_j, shp_j = jpacked.pack_np(codes, bits)
            buf_t, shp_t = tpacked.pack_np(codes, bits)
            np.testing.assert_array_equal(buf_j, buf_t)
            assert shp_j == shp_t
            back = tpacked.unpack_np(buf_t, bits, shp_t, signed)
            np.testing.assert_array_equal(back, codes)
            assert back.dtype == codes.dtype


def test_int4_nibble_layouts_match_jax():
    rng = np.random.default_rng(7)
    codes = rng.integers(-7, 8, size=(3, 64, 46)).astype(np.int8)
    tc = torch.from_numpy(codes)
    _same(jpacked.pack_int4_splitn_jnp(jnp.asarray(codes)),
          tpacked.pack_int4_splitn(tc))
    _same(jpacked.pack_int4_jnp(jnp.asarray(codes)), tpacked.pack_int4(tc))
    np.testing.assert_array_equal(
        tpacked.unpack_int4_splitn(tpacked.pack_int4_splitn(tc)).numpy(),
        codes)
    np.testing.assert_array_equal(
        tpacked.unpack_int4(tpacked.pack_int4(tc)).numpy(), codes)
