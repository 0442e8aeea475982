"""The port's qmatmul against the JAX dispatch layer's Pallas kernels.

On the CPU the port's kernel mode computes each kernel's plain version
(``kernels/ref.py``); the JAX side runs ``dispatch.qmatmul(mode="pallas")``,
i.e. the Pallas kernels in interpret mode, on the same numpy inputs. The
tolerance is the reference's own (``tests/test_kernels_dispatch.py``):
rtol 1e-5, atol 1e-4, both in f32. The kernels themselves are held against
these plain versions on the card (``tests/test_torch_kernels_gpu.py`` and
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import get_format as jformat
from repro.core.mx import quantize as jquantize
from repro.kernels import dispatch as jdispatch
from repro.serve.packed_params import pack_leaf_int4 as jpack4
from repro_torch.core.formats import get_format
from repro_torch.core.mx import MXTensor, quantize
from repro_torch.kernels import dispatch, mx_matmul
from repro_torch.serve.packed_params import pack_leaf_int4

FORMATS = ["mxint8", "mxfp8", "mxint6", "mxint4", "mxfp6", "mxfp4"]
# (M, K, N): M below a tile, odd N, K needing padding on the TPU side;
# then M > 16, the shapes of the card's tiled body (67: the mixed tick's
# live tokens).
SHAPES = [(3, 96, 80), (8, 128, 130), (5, 160, 46), (67, 256, 96),
          (128, 160, 130)]


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _leaves(w, name):
    jt = jquantize(jnp.asarray(w), jformat(name, 32), axis=0)
    tt = quantize(torch.from_numpy(w), get_format(name, 32), axis=0)
    if name == "mxint4":
        return jpack4(jt), pack_leaf_int4(tt)
    return jt, tt


@pytest.mark.parametrize("mkn", SHAPES)
@pytest.mark.parametrize("name", FORMATS)
def test_qmatmul_matches_jax_pallas_dispatch(name, mkn):
    m, k, n = mkn
    x, w = _np((m, k), 1), _np((k, n), 2)
    jleaf, tleaf = _leaves(w, name)
    want = np.asarray(jdispatch.qmatmul(jnp.asarray(x), jleaf, mode="pallas"))
    before = dict(mx_matmul.launches)
    got = dispatch.qmatmul(torch.from_numpy(x), tleaf)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    # CPU tensors take the plain version: no kernel launch is counted
    assert mx_matmul.launches == before


@pytest.mark.parametrize("name", ["mxint8", "mxint4"])
def test_densify_mode_matches_kernel_mode(name):
    x, w = _np((2, 3, 64), 3), _np((64, 96), 4)
    _, leaf = _leaves(w, name)
    a = dispatch.qmatmul(torch.from_numpy(x), leaf)
    b = dispatch.qmatmul(torch.from_numpy(x), leaf, mode="densify")
    assert a.shape == (2, 3, 96)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    low = dispatch.qmatmul(torch.from_numpy(x).to(torch.bfloat16), leaf)
    assert low.dtype == torch.bfloat16


def test_wrong_axis_leaf_raises():
    w = torch.from_numpy(_np((64, 96), 5))
    bad = quantize(w, get_format("mxint8", 32), axis=1)   # blocks along N
    with pytest.raises(ValueError, match="serving layout"):
        dispatch.qmatmul(torch.zeros(2, 64), bad)
    with pytest.raises(ValueError, match="serving layout"):
        dispatch.qmatmul(torch.zeros(2, 64), bad, mode="densify")


def test_kernel_mode_refuses_what_it_cannot_take():
    """No silent densify: a leaf the kernels cannot read raises."""
    t = quantize(torch.from_numpy(_np((64, 96), 6)), get_format("mxint4", 32),
                 axis=0)
    splitk = pack_leaf_int4(t, layout="splitk")
    with pytest.raises(ValueError, match="split-K"):
        dispatch.qmatmul(torch.zeros(2, 64), splitk)
    stacked = MXTensor(codes=t.codes[None], scale_exp=t.scale_exp[None],
                       fmt=t.fmt, block_axis=1)
    with pytest.raises(ValueError, match="3D"):
        dispatch.qmatmul(torch.zeros(2, 64), stacked)
    with pytest.raises(ValueError, match="unknown qmatmul mode"):
        dispatch.qmatmul(torch.zeros(2, 64), t, mode="pallas")
    # the densify contract takes the split-K leaf
    y = dispatch.qmatmul(torch.ones(2, 64), splitk, mode="densify")
    assert y.shape == (2, 96)


def test_int4_block_size_comes_from_the_leaf():
    x, w = _np((4, 64), 7), _np((64, 48), 8)
    t = quantize(torch.from_numpy(w), get_format("mxint4", 16), axis=0)
    leaf = pack_leaf_int4(t)
    want = torch.from_numpy(x) @ dispatch.densify_leaf(
        leaf, None, torch.float32, serving_axis=True)
    np.testing.assert_allclose(dispatch.qmatmul(torch.from_numpy(x),
                                                leaf).numpy(),
                               want.numpy(), rtol=1e-5, atol=1e-5)


QWEN_KN = [(2560, 4096), (2560, 1024), (4096, 2560), (2560, 9728),
           (9728, 2560)]


@pytest.mark.parametrize("bs", [32, 16])
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("kn", QWEN_KN)
def test_decode_plan_fills_the_card_at_every_qwen3_projection(kn, int4, bs):
    """At M = 4 the decode body launches at least two blocks per SM of the
    H100; its strips tile the code row, in 16-byte steps, and its clusters
    stay at the portable 8 unless 16-byte strips alone fall short."""
    k, n = kn
    plan = mx_matmul.decode_plan(4, k, n, bs, int4)
    width = n // 2 if int4 else n
    assert plan.blocks >= mx_matmul.DECODE_MIN_BLOCKS
    assert plan.m_tiles == 1 and plan.strip % 16 == 0
    assert (plan.strips - 1) * plan.strip < width <= plan.strips * plan.strip
    assert plan.cluster <= 8 or plan.strip == 16
    assert plan.cluster <= k // bs
    assert mx_matmul.decode_plan(16, k, n, bs, int4).m_tiles == \
        (4 if int4 else 2)


@pytest.mark.parametrize("bs", [32, 16])
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("kn", QWEN_KN)
@pytest.mark.parametrize("m", [32, 64, 128, 256])
def test_tiled_plan_fills_the_card_at_every_qwen3_projection(m, kn, int4,
                                                             bs):
    """Above DECODE_MAX_M the tiled body launches at least one block per
    SM of the H100; its tiles cover M and N, its clusters stay within 16
    and split K into whole K-blocks, each rank's range non-empty and the
    ranges covering K exactly once, in order."""
    k, n = kn
    plan = mx_matmul.tiled_plan(m, k, n, bs, int4)
    assert plan.blocks >= mx_matmul.SMS
    assert 1 <= plan.cluster <= 16
    assert plan.bm in (64, 128)
    assert (plan.m_tiles - 1) * plan.bm < m <= plan.m_tiles * plan.bm
    bn = mx_matmul.TILED_BN
    assert (plan.n_tiles - 1) * bn < n <= plan.n_tiles * bn
    ranges = plan.k_ranges()
    assert plan.k_blocks == k // bs and len(ranges) == plan.cluster
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.k_blocks
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
