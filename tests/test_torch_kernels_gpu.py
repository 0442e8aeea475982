"""The Hopper kernels against their plain versions, on the card: the two
dequant-GEMM kernels (B1/B2) and the two paged-attention kernels (B3/B4).

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
from repro_torch.kernels import mx_matmul, paged_attention, ref
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


# ---------------------------------------------------------------------------
# B3 / B4: paged attention
# ---------------------------------------------------------------------------
def _paged_case(dev, spans, ps, hkv, g, d, c=1, dtype=torch.bfloat16,
                seed=0, stack=1):
    """q (B, C, H, D) and pools (stack, P, ps, Hkv, D) with a disjoint
    random block table mapping the pages of spans[i] tokens; page 0 is
    scratch."""
    rng = np.random.default_rng(seed)
    b, mp = len(spans), max(-(-n // ps) for n in spans) + 1
    n_pages = b * mp + 1
    q = torch.from_numpy(rng.normal(size=(b, c, hkv * g, d))
                         .astype(np.float32)).to(dev, dtype)
    pools = [torch.from_numpy(rng.normal(size=(stack, n_pages, ps, hkv, d))
                              .astype(np.float32)).to(dev, dtype)
             for _ in range(2)]
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((b, mp), np.int32)
    for i, n in enumerate(spans):
        k = -(-n // ps)
        bt[i, :k] = perm[i * mp:i * mp + k]
    return q, pools[0], pools[1], torch.from_numpy(bt).to(dev)


def _poisoned(kp, vp, bt, spans, ps):
    """NaN in every page no row maps (page 0 included) and past each row's
    frontier inside its last page."""
    kp, vp = kp.clone(), vp.clone()
    used = set(bt.flatten().tolist()) - {0}
    for pg in range(kp.shape[0]):
        if pg not in used:
            kp[pg] = float("nan")
            vp[pg] = float("nan")
    for i, n in enumerate(spans):
        pg, off = n // ps, n % ps
        if off and bt[i, pg] != 0:
            kp[bt[i, pg], off:] = float("nan")
            vp[bt[i, pg], off:] = float("nan")
    return kp, vp


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("spans,ps,hkv,g,d", [
    ([200, 200, 200, 200], 16, 8, 4, 128),      # qwen3-4b decode
    ([1, 16, 17, 511], 16, 8, 4, 128),          # ragged, page edges
    ([0, 5, 33], 8, 2, 1, 16),                  # cache_len 0, MHA, tiny D
    ([7, 40], 32, 4, 8, 64),
    ([100, 37], 64, 2, 2, 128),                 # pages too big to prefetch
])
def test_paged_attention_matches_plain(spans, ps, hkv, g, d, dtype, window):
    dev = _card()
    q, kp, vp, bt = _paged_case(dev, spans, ps, hkv, g, d, dtype=dtype)
    cl = torch.tensor(spans, dtype=torch.int32, device=dev)
    before = paged_attention.launches["paged_attention"]
    got = paged_attention.paged_attention(q[:, 0], kp[0], vp[0], bt, cl,
                                          window)
    torch.cuda.synchronize()
    assert paged_attention.launches["paged_attention"] == before + 1
    _close(got, ref.ref_paged_attention(q[:, 0], kp[0], vp[0], bt, cl,
                                        window))
    kp_p, vp_p = _poisoned(kp[0], vp[0], bt.cpu().numpy(), spans, ps)
    dirty = paged_attention.paged_attention(q[:, 0], kp_p, vp_p, bt, cl,
                                            window)
    assert torch.equal(got, dirty)                 # bit-identical
    for i, n in enumerate(spans):
        if n == 0:
            assert (got[i] == 0).all()


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("rows,c,ps,hkv,g,d", [
    ([(200, 1), (150, 1), (17, 1), (128, 64)], 64, 16, 8, 4, 128),
    ([(16, 8), (17, 5), (15, 8), (29, 1), (0, 7)], 8, 8, 2, 2, 16),
    ([(0, 40), (63, 1)], 40, 16, 4, 8, 64),
])
def test_paged_attention_mq_matches_plain(rows, c, ps, hkv, g, d, window):
    dev = _card()
    spans = [qo + ql for qo, ql in rows]
    q, kp, vp, bt = _paged_case(dev, spans, ps, hkv, g, d, c=c, seed=1)
    qo = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=dev)
    ql = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
    before = paged_attention.launches["paged_attention_mq"]
    got = paged_attention.paged_attention_mq(q, kp[0], vp[0], bt, qo, ql,
                                             window)
    torch.cuda.synchronize()
    assert paged_attention.launches["paged_attention_mq"] == before + 1
    _close(got, ref.ref_paged_attention_mq(q, kp[0], vp[0], bt, qo, ql,
                                           window))
    kp_p, vp_p = _poisoned(kp[0], vp[0], bt.cpu().numpy(), spans, ps)
    dirty = paged_attention.paged_attention_mq(q, kp_p, vp_p, bt, qo, ql,
                                               window)
    assert torch.equal(got, dirty)
    for i, (_, n) in enumerate(rows):
        assert (got[i, n:] == 0).all()             # dead lanes


def test_paged_attention_mq_with_q_len_one_collapses_to_b3():
    dev = _card()
    rows = [(199, 1), (15, 1), (16, 1), (300, 1)]
    q, kp, vp, bt = _paged_case(dev, [o + n for o, n in rows], 16, 8, 4, 128,
                                c=16, seed=2)
    qo = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=dev)
    ql = torch.ones(4, dtype=torch.int32, device=dev)
    mq = paged_attention.paged_attention_mq(q, kp[0], vp[0], bt, qo, ql)
    sq = paged_attention.paged_attention(q[:, 0].contiguous(), kp[0], vp[0],
                                         bt, qo + 1)
    _close(mq[:, 0], sq)
    assert (mq[:, 1:] == 0).all()


def test_layer_slice_of_stacked_pool_is_read_in_place():
    """A layer's pool is the view pool[g] of the stacked (G, P, ps, Hkv, D)
    tensor; the kernels read it at its data pointer."""
    dev = _card()
    spans = [40, 3, 77]
    q, kp, vp, bt = _paged_case(dev, spans, 16, 2, 4, 64, c=4, seed=3,
                                stack=3)
    cl = torch.tensor(spans, dtype=torch.int32, device=dev)
    ql = torch.tensor([4, 1, 2], dtype=torch.int32, device=dev)
    q1 = q[:, 0].contiguous()
    for g in range(3):
        _close(paged_attention.paged_attention(q1, kp[g], vp[g], bt, cl),
               ref.ref_paged_attention(q1, kp[g], vp[g], bt, cl))
        _close(paged_attention.paged_attention_mq(q, kp[g], vp[g], bt,
                                                  cl - ql, ql),
               ref.ref_paged_attention_mq(q, kp[g], vp[g], bt, cl - ql, ql))
