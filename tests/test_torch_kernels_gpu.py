"""The two Hopper dequant-GEMM kernels against their plain versions, on the
card.

Needs a CUDA device (and nvcc to build the kernels); each test decides that
inside itself and skips on a host without one, so every pytest worker
collects the same tests. Run on a machine with a card:

    PYTHONPATH=src python -m pytest tests/test_torch_kernels_gpu.py -q

Tolerance: f32 accumulation in both, only the summation order differs —
rtol 1e-4 and atol 1e-4 * max|plain|.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.formats import get_format
from repro_torch.core.mx import quantize
from repro_torch.kernels import mx_matmul, ref
from repro_torch.serve.packed_params import pack_leaf_int4

pytestmark = pytest.mark.gpu

# (M, K, N): decode and prefill rows, ragged M and N, a qwen3-4b shape.
SHAPES = [(4, 2560, 1024), (64, 256, 96), (3, 96, 80), (13, 160, 130),
          (9, 128, 4)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode "
                    "(their plain versions are tested on the CPU)")
    return torch.device("cuda")


def _operands(m, k, n, name, bs, dev, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(dev)
    return x.to(torch.bfloat16), quantize(w, get_format(name, bs), axis=0)


def _close(got, want):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("name", ["mxint8", "mxfp8", "mxint6", "mxfp4"])
@pytest.mark.parametrize("mkn", SHAPES)
def test_mx_matmul_matches_plain(name, mkn):
    dev = _card()
    x, t = _operands(*mkn, name, 32, dev)
    before = mx_matmul.launches["mx_matmul"]
    got = mx_matmul.mx_matmul(x, t.codes, t.scale_exp, t.fmt)
    torch.cuda.synchronize()
    assert mx_matmul.launches["mx_matmul"] == before + 1
    _close(got, ref.ref_mx_matmul(x, t.codes, t.scale_exp, t.fmt))


@pytest.mark.parametrize("bs", [32, 16])
@pytest.mark.parametrize("mkn", SHAPES)
def test_mx_matmul_int4_matches_plain(bs, mkn):
    dev = _card()
    m, k, n = mkn
    x, t = _operands(m, k, n, "mxint4", bs, dev, seed=1)
    leaf = pack_leaf_int4(t)
    before = mx_matmul.launches["mx_matmul_int4"]
    got = mx_matmul.mx_matmul_int4(x, leaf.packed, leaf.scale_exp, t.fmt)
    torch.cuda.synchronize()
    assert mx_matmul.launches["mx_matmul_int4"] == before + 1
    _close(got, ref.ref_mx_matmul_int4(x, leaf.packed, leaf.scale_exp, t.fmt))


def test_stacked_leaf_slice_is_read_in_place():
    """A layer slice of a stacked (G, K, N) leaf is a view at an offset;
    the kernel must read it where it lies."""
    dev = _card()
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.normal(size=(3, 64, 48)).astype(np.float32))
    fmt = get_format("mxint8", 32)
    t = quantize(w.to(dev), fmt, axis=1)
    x = torch.from_numpy(rng.normal(size=(5, 64)).astype(np.float32)).to(dev)
    for g in range(3):
        got = mx_matmul.mx_matmul(x, t.codes[g], t.scale_exp[g], fmt)
        _close(got, ref.ref_mx_matmul(x, t.codes[g], t.scale_exp[g], fmt))
