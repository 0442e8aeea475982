"""The Hopper kernels against their plain versions, on the card: the two
dequant-GEMM kernels (B1/B2), the two paged-attention kernels (B3/B4), and
the MX quantize, fake-quant and Slice-and-Scale kernels (B6, B7, B5).

Needs a CUDA device (and nvcc to build the kernels); each test decides that
inside itself and skips on a host without one, so every pytest worker
collects the same tests. Run on a machine with a card:

    PYTHONPATH=src python -m pytest tests/test_torch_kernels_gpu.py -q

Tolerance: B1–B4 accumulate in f32 in both, only the summation order
differs — rtol 1e-4 and atol 1e-4 * max|plain|. B5–B7 do the same
elementwise arithmetic as their plain versions: bit-identical, including
all-zero blocks, subnormal blocks and blocks whose scale clips to -127.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.anchor import AnchorModel
from repro_torch.core.formats import get_format
from repro_torch.core.mx import MXTensor, quantize
from repro_torch.core.slice_scale import slice_and_scale
from repro_torch.kernels import fake_quant, mx_matmul, mx_quantize, ops
from repro_torch.kernels import paged_attention, ref, ss_convert
from repro_torch.core.tree import flatten_paths
from repro_torch.serve.packed_params import (PackedInt4Leaf,
                                             make_packed_params,
                                             pack_leaf_int4)

pytestmark = pytest.mark.gpu

# (M, K, N): decode and prefill rows, ragged M and N, a qwen3-4b shape.
SHAPES = [(4, 2560, 1024), (64, 256, 96), (3, 96, 80), (13, 160, 130),
          (9, 128, 4)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode "
                    "(their plain versions are tested on the CPU)")
    return torch.device("cuda")


def _operands(m, k, n, name, bs, dev, seed=0, x_dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(dev)
    return x.to(x_dtype), quantize(w, get_format(name, bs), axis=0)


def _close(got, want):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("name", ["mxint8", "mxfp8", "mxint6", "mxfp6",
                                  "mxfp4"])
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
    for m in (5, 40):                   # the decode body, the tiled body
        x = torch.from_numpy(rng.normal(size=(m, 64)).astype(np.float32)
                             ).to(dev)
        for g in range(3):
            got = mx_matmul.mx_matmul(x, t.codes[g], t.scale_exp[g], fmt)
            _close(got, ref.ref_mx_matmul(x, t.codes[g], t.scale_exp[g], fmt))


# B1 / B2 decode body (M <= 16) at every qwen3-4b projection shape; M = 17
# runs the other body.
QWEN_KN = [(2560, 4096), (2560, 1024), (4096, 2560), (2560, 9728),
           (9728, 2560)]


def _b1(x, t):
    return mx_matmul.mx_matmul(x, t.codes, t.scale_exp, t.fmt)


def _b2(x, leaf, fmt):
    return mx_matmul.mx_matmul_int4(x, leaf.packed, leaf.scale_exp, fmt)


@pytest.mark.parametrize("name", ["mxint8", "mxfp8", "mxint6", "mxfp6",
                                  "mxfp4"])
@pytest.mark.parametrize("kn", QWEN_KN)
@pytest.mark.parametrize("m", [1, 4, 16, 17])
def test_mx_matmul_decode_shapes_match_plain(m, kn, name):
    dev = _card()
    x, t = _operands(m, *kn, name, 32, dev, seed=m)
    _close(_b1(x, t), ref.ref_mx_matmul(x, t.codes, t.scale_exp, t.fmt))


@pytest.mark.parametrize("bs", [32, 16])
@pytest.mark.parametrize("kn", QWEN_KN)
@pytest.mark.parametrize("m", [1, 4, 16, 17])
def test_mx_matmul_int4_decode_shapes_match_plain(m, kn, bs):
    dev = _card()
    x, t = _operands(m, *kn, "mxint4", bs, dev, seed=m)
    leaf = pack_leaf_int4(t)
    _close(_b2(x, leaf, t.fmt),
           ref.ref_mx_matmul_int4(x, leaf.packed, leaf.scale_exp, t.fmt))


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t whose first byte sits one past a 16-byte
    boundary (a leaf read where it lies, off the vector path)."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("m", [4, 17, 67])
def test_unaligned_leaf_takes_the_scalar_path(m):
    """Codes, and x, that lie off the 16-byte grid are read by the scalar
    edge paths."""
    dev = _card()
    x, t = _operands(m, 256, 96, "mxint8", 32, dev, seed=5)
    codes, xu = _unaligned(t.codes), _unaligned(x)
    assert codes.data_ptr() % 16 and xu.data_ptr() % 16
    want = ref.ref_mx_matmul(x, t.codes, t.scale_exp, t.fmt)
    _close(mx_matmul.mx_matmul(x, codes, t.scale_exp, t.fmt), want)
    _close(mx_matmul.mx_matmul(xu, t.codes, t.scale_exp, t.fmt), want)
    x, t = _operands(m, 256, 96, "mxint4", 32, dev, seed=6)
    leaf = pack_leaf_int4(t)
    packed, xu = _unaligned(leaf.packed), _unaligned(x)
    want = ref.ref_mx_matmul_int4(x, leaf.packed, leaf.scale_exp, t.fmt)
    _close(mx_matmul.mx_matmul_int4(x, packed, leaf.scale_exp, t.fmt), want)
    _close(mx_matmul.mx_matmul_int4(xu, leaf.packed, leaf.scale_exp, t.fmt),
           want)


@pytest.mark.parametrize("case", ["mxint8", "mxfp8", "mxint4"])
@pytest.mark.parametrize("kn", [(2560, 1024), (9728, 2560)])
def test_decode_body_bit_identical_eager_and_in_a_cuda_graph(kn, case):
    """The cluster reduction runs in rank order: a repeated call and two
    replays of a captured one are bit-identical."""
    dev = _card()
    x, t = _operands(4, *kn, case, 32, dev, seed=9)
    if case == "mxint4":
        leaf = pack_leaf_int4(t)
        _identical_eager_and_in_a_graph(lambda: _b2(x, leaf, t.fmt))
    else:
        _identical_eager_and_in_a_graph(lambda: _b1(x, t))


# B1 / B2 tiled body (M > 16): the prefill buckets, the mixed tick's live
# tokens (67: 3 decode rows and a 64-token chunk, ragged) and its M = 256.
@pytest.mark.parametrize("name", ["mxint8", "mxfp8", "mxint6", "mxfp6",
                                  "mxfp4"])
@pytest.mark.parametrize("kn", QWEN_KN)
@pytest.mark.parametrize("m", [32, 67, 128, 256])
def test_mx_matmul_tiled_shapes_match_plain(m, kn, name):
    dev = _card()
    x, t = _operands(m, *kn, name, 32, dev, seed=m)
    _close(_b1(x, t), ref.ref_mx_matmul(x, t.codes, t.scale_exp, t.fmt))


@pytest.mark.parametrize("bs", [32, 16])
@pytest.mark.parametrize("kn", QWEN_KN)
@pytest.mark.parametrize("m", [32, 67, 128, 256])
def test_mx_matmul_int4_tiled_shapes_match_plain(m, kn, bs):
    dev = _card()
    x, t = _operands(m, *kn, "mxint4", bs, dev, seed=m)
    leaf = pack_leaf_int4(t)
    _close(_b2(x, leaf, t.fmt),
           ref.ref_mx_matmul_int4(x, leaf.packed, leaf.scale_exp, t.fmt))


@pytest.mark.parametrize("m,k,n", [(67, 160, 130), (33, 96, 80),
                                   (129, 320, 262), (40, 64, 36)])
@pytest.mark.parametrize("name", ["mxint8", "mxfp8", "mxint4"])
def test_tiled_body_ragged_edges(name, m, k, n):
    """Ragged M, N and K ranges (K not a multiple of the 64-row stage,
    N / 2 off the 16-byte grid at int4) are zero-filled in the tiles."""
    dev = _card()
    x, t = _operands(m, k, n, name, 32, dev, seed=k)
    if name == "mxint4":
        leaf = pack_leaf_int4(t)
        _close(_b2(x, leaf, t.fmt),
               ref.ref_mx_matmul_int4(x, leaf.packed, leaf.scale_exp, t.fmt))
    else:
        _close(_b1(x, t), ref.ref_mx_matmul(x, t.codes, t.scale_exp, t.fmt))


@pytest.mark.parametrize("m", [4, 67])
@pytest.mark.parametrize("name", ["mxint8", "mxfp8", "mxint4"])
def test_f32_x_and_block_size_64(name, m):
    """f32 x (the tiled body splits it into bf16 hi + lo) and 64-element
    blocks, on both bodies."""
    dev = _card()
    for bs, dtype in ((32, torch.float32), (64, torch.bfloat16),
                      (64, torch.float32)):
        x, t = _operands(m, 2560, 1024, name, bs, dev, seed=bs,
                         x_dtype=dtype)
        if name == "mxint4":
            leaf = pack_leaf_int4(t)
            _close(_b2(x, leaf, t.fmt), ref.ref_mx_matmul_int4(
                x, leaf.packed, leaf.scale_exp, t.fmt))
        else:
            _close(_b1(x, t),
                   ref.ref_mx_matmul(x, t.codes, t.scale_exp, t.fmt))


@pytest.mark.parametrize("body", ["decode", "tiled"])
@pytest.mark.parametrize("m", [4, 16, 32])
def test_either_body_at_any_m(m, body):
    """The measurement that sets DECODE_MAX_M forces one body or the other;
    both hold to the plain version on either side of the crossover."""
    dev = _card()
    x, t = _operands(m, 2560, 1024, "mxint8", 32, dev, seed=3)
    _close(mx_matmul.mx_matmul(x, t.codes, t.scale_exp, t.fmt, body=body),
           ref.ref_mx_matmul(x, t.codes, t.scale_exp, t.fmt))
    x, t = _operands(m, 2560, 1024, "mxint4", 32, dev, seed=4)
    leaf = pack_leaf_int4(t)
    _close(mx_matmul.mx_matmul_int4(x, leaf.packed, leaf.scale_exp, t.fmt,
                                    body=body),
           ref.ref_mx_matmul_int4(x, leaf.packed, leaf.scale_exp, t.fmt))


@pytest.mark.parametrize("case", ["mxint8", "mxfp8", "mxint4"])
@pytest.mark.parametrize("kn", [(2560, 1024), (2560, 9728), (9728, 2560)])
def test_tiled_body_bit_identical_eager_and_in_a_cuda_graph(kn, case):
    """At M = 256 the K split meets in rank order: a repeated call and two
    replays of a captured one are bit-identical."""
    dev = _card()
    x, t = _operands(256, *kn, case, 32, dev, seed=10)
    if case == "mxint4":
        leaf = pack_leaf_int4(t)
        _identical_eager_and_in_a_graph(lambda: _b2(x, leaf, t.fmt))
    else:
        _identical_eager_and_in_a_graph(lambda: _b1(x, t))


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
    ([200, 1, 37, 511], 16, 3, 3, 64),          # smollm-135m: G 3, D 64
    ([200, 17, 0, 300], 16, 2, 12, 128),        # starcoder2-3b: G 12
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
    ([(200, 1), (37, 1), (128, 64)], 64, 16, 3, 3, 64),       # G 3, D 64
    ([(150, 1), (0, 64), (63, 1), (17, 0)], 64, 16, 2, 12, 128),  # G 12
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


def _identical_eager_and_in_a_graph(fn):
    """fn() twice eagerly, then captured in a CUDA graph and replayed twice:
    every output bit-identical with the first (partials merge in a fixed
    order; B3/B4's ticket counters are back at zero after every launch)."""
    first, second = fn(), fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    torch.cuda.synchronize()
    once = captured.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(once, first) and torch.equal(captured, first)


@pytest.mark.parametrize("window", [None, 70, 1000])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_long_context_many_splits(dtype, window):
    """cache_len up to 4096 over 257-page table rows: many splits per
    (slot, kv head), two tiles per split; a window of 70 starts inside a
    split, one of 1000 leaves whole splits empty."""
    dev = _card()
    spans = [4096, 3001, 17, 4000]
    q, kp, vp, bt = _paged_case(dev, spans, 16, 8, 4, 128, dtype=dtype,
                                seed=4)
    plan = paged_attention.split_plan(4, 1, 32, 8, 128, 16, bt.shape[1],
                                      q.element_size())
    assert bt.shape[1] >= 256 and plan.splits > 8
    q1 = q[:, 0].contiguous()
    cl = torch.tensor(spans, dtype=torch.int32, device=dev)
    got = paged_attention.paged_attention(q1, kp[0], vp[0], bt, cl, window)
    _close(got, ref.ref_paged_attention(q1, kp[0], vp[0], bt, cl, window))
    kp_p, vp_p = _poisoned(kp[0], vp[0], bt.cpu().numpy(), spans, 16)
    assert torch.equal(got, paged_attention.paged_attention(
        q1, kp_p, vp_p, bt, cl, window))
    assert torch.equal(got, paged_attention.paged_attention(
        q1, kp[0], vp[0], bt, cl, window))


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("cursor", [0, 448])
def test_paged_attention_mq_chunk_at_cursor(cursor, window):
    """A 64-token chunk at cursor 0 and at 448 beside decode rows."""
    dev = _card()
    rows = [(cursor, 64), (200, 1), (17, 1), (511, 1)]
    spans = [qo + ql for qo, ql in rows]
    q, kp, vp, bt = _paged_case(dev, spans, 16, 8, 4, 128, c=64, seed=5)
    qo = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=dev)
    ql = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
    got = paged_attention.paged_attention_mq(q, kp[0], vp[0], bt, qo, ql,
                                             window)
    _close(got, ref.ref_paged_attention_mq(q, kp[0], vp[0], bt, qo, ql,
                                           window))
    kp_p, vp_p = _poisoned(kp[0], vp[0], bt.cpu().numpy(), spans, 16)
    assert torch.equal(got, paged_attention.paged_attention_mq(
        q, kp_p, vp_p, bt, qo, ql, window))
    for i, (_, n) in enumerate(rows):
        assert (got[i, n:] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_kernels_bit_identical_eager_and_in_a_cuda_graph(dtype):
    dev = _card()
    spans = [1000, 700, 33, 0]
    q, kp, vp, bt = _paged_case(dev, spans, 16, 8, 4, 128, c=64,
                                dtype=dtype, seed=6)
    cl = torch.tensor(spans, dtype=torch.int32, device=dev)
    q1 = q[:, 0].contiguous()
    _identical_eager_and_in_a_graph(lambda: paged_attention.paged_attention(
        q1, kp[0], vp[0], bt, cl, 300))
    qo = torch.tensor([936, 699, 32, 0], dtype=torch.int32, device=dev)
    ql = torch.tensor([64, 1, 1, 0], dtype=torch.int32, device=dev)
    _identical_eager_and_in_a_graph(
        lambda: paged_attention.paged_attention_mq(q, kp[0], vp[0], bt, qo,
                                                   ql))


# Which epilogue the row whose live page holds NaN goes through: the single
# walk (one key slice per warp: more than 32 query rows, G 64), the warps'
# merge (G 4, a short row in one split) or the cross-split merge (a row of
# 4096 positions). (Hkv, G, D, spans, victim row).
NAN_CASES = {
    "single-walk": (1, 64, 64, [200, 40, 17, 100], 1),
    "warp-merge": (8, 4, 128, [200, 40, 17, 100], 1),
    "split-merge": (8, 4, 128, [4096, 300, 40, 3001], 0),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(NAN_CASES))
@pytest.mark.parametrize("kernel", ["B3", "B4"])
def test_nan_in_a_live_page_gives_zeros_in_that_row(kernel, case, dtype):
    """NaN in the first page of one row, which every live query of the row
    sees: the row's sum is NaN, and the kernel writes exact zeros in all
    its heads (lanes), as the plain version and the Pallas kernels do
    (where(l > 0, out, 0)); every other row is bit-identical to the clean
    run and within tolerance of the plain version."""
    dev = _card()
    hkv, g, d, spans, victim = NAN_CASES[case]
    ps, c = 16, 5
    q, kp, vp, bt = _paged_case(dev, spans, ps, hkv, g, d, c=c, dtype=dtype,
                                seed=8)
    kp_n, vp_n = kp[0].clone(), vp[0].clone()
    kp_n[bt[victim, 0]] = float("nan")
    vp_n[bt[victim, 0]] = float("nan")
    if kernel == "B3":
        q1 = q[:, 0].contiguous()
        cl = torch.tensor(spans, dtype=torch.int32, device=dev)

        def run(kpool, vpool, fn=paged_attention.paged_attention):
            return fn(q1, kpool, vpool, bt, cl)
        plain = ref.ref_paged_attention
        lanes, rows = 1, g
    else:
        qo = torch.tensor([n - c for n in spans], dtype=torch.int32,
                          device=dev)
        ql = torch.full((len(spans),), c, dtype=torch.int32, device=dev)

        def run(kpool, vpool, fn=paged_attention.paged_attention_mq):
            return fn(q, kpool, vpool, bt, qo, ql)
        plain = ref.ref_paged_attention_mq
        tq = min(c, max(1, paged_attention.QBLOCK_ROWS // g))
        lanes, rows = c, tq * g
    # the case reaches the epilogue it names
    plan = paged_attention.split_plan(len(spans), lanes, hkv * g, hkv, d, ps,
                                      bt.shape[1], q.element_size())
    first, last = paged_attention.walk(spans[victim] - lanes, lanes, 0,
                                       plan.tq, lanes, ps, bt.shape[1])
    n_splits = sum(1 for s in range(plan.splits) if paged_attention
                   .split_pages(plan, first, last, s, rows))
    assert (n_splits > 1) == (case == "split-merge")
    assert (rows > 32) == (case == "single-walk")
    assert first == 0 and spans[victim] - lanes >= ps   # all lanes see it

    clean = run(kp[0], vp[0])
    got = run(kp_n, vp_n)
    want = run(kp_n, vp_n, fn=plain)
    torch.cuda.synchronize()
    assert torch.equal(got[victim], torch.zeros_like(got[victim]))
    assert torch.equal(want[victim], torch.zeros_like(want[victim]))
    others = [i for i in range(len(spans)) if i != victim]
    assert torch.equal(got[others], clean[others])
    _close(got[others], want[others])


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


# ---------------------------------------------------------------------------
# B6 / B7 / B5: quantize, fake-quant, Slice-and-Scale
# ---------------------------------------------------------------------------
QUANT_FORMATS = ["mxint8", "mxint6", "mxint4", "mxint2", "mxfp8", "mxfp6",
                 "mxfp4"]
SS_PAIRS = [("mxint8", "mxint6"), ("mxint8", "mxint4"), ("mxint8", "mxint2"),
            ("mxint6", "mxint3"), ("mxfp8", "mxfp6"), ("mxfp8", "mxfp4"),
            ("mxfp6", "mxfp5")]
# (shape, block axis): a weight blocked along K, blocks along the last
# axis, a stacked (G, K, N) leaf, a ragged inner width
QUANT_CASES = [((256, 96), 0), ((40, 128), -1), ((3, 128, 80), 1),
               ((64, 7), 0)]


def edge_values(shape, axis, bs, seed=0):
    """Normal weights (std 0.02), and along the block axis: an all-zero
    block, a subnormal block, a block with max in [2^-126, 2^-120) (its
    scale clips to -127 at 8 bits), signed zeros and a block of exact
    powers of two and halfway values (round half to even)."""
    rng = np.random.default_rng(seed)
    moved = list(shape)
    k = moved.pop(axis % len(shape))
    flat = (rng.normal(size=(int(np.prod(moved)), k)) * 0.02).astype(
        np.float32)
    tiny = np.float32(2.0 ** -123)
    flat[0, :bs] = 0.0
    flat[1, :bs] = (rng.normal(size=bs) * 1e-40).astype(np.float32)
    flat[2, :bs] = (rng.uniform(-1, 1, size=bs) * tiny).astype(np.float32)
    flat[2, 0] = 2.0 ** -121
    flat[3, :bs // 2] = -0.0
    flat[4, :bs] = (2.0 ** rng.integers(-8, 2, size=bs)
                    * rng.choice([1.0, 1.5, 1.25, 2.5, 3.5], size=bs)
                    ).astype(np.float32)
    out = flat.reshape(*moved, k)
    return np.ascontiguousarray(np.moveaxis(out, -1, axis))


def _values(shape, axis, bs, dtype, dev, seed=0):
    return torch.from_numpy(edge_values(shape, axis, bs, seed)).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,axis", QUANT_CASES)
@pytest.mark.parametrize("bs", [32, 16, 64])
@pytest.mark.parametrize("name", QUANT_FORMATS)
def test_mx_quantize_bit_identical_with_plain(name, bs, shape, axis, dtype):
    dev = _card()
    if shape[axis] % bs:
        pytest.skip("block axis not a multiple of the block size")
    v = _values(shape, axis, bs, dtype, dev)
    fmt = get_format(name, bs)
    before = mx_quantize.launches["mx_quantize"]
    got = ops.mx_quantize(v, fmt, axis=axis)
    torch.cuda.synchronize()
    assert mx_quantize.launches["mx_quantize"] == before + 1
    want = quantize(v, fmt, axis=axis)
    assert torch.equal(got.codes, want.codes)
    assert torch.equal(got.scale_exp, want.scale_exp)
    assert got.block_axis == want.block_axis


@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("ste", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,axis", QUANT_CASES)
@pytest.mark.parametrize("name", QUANT_FORMATS)
def test_fake_quant_bit_identical_with_plain(name, shape, axis, dtype, ste,
                                             out_dtype):
    dev = _card()
    v = _values(shape, axis, 32, dtype, dev, seed=1)
    fmt = get_format(name, 32)
    before = fake_quant.launches["fake_quant"]
    got = ops.fake_quant(v, fmt, axis, out_dtype=out_dtype, ste=ste)
    torch.cuda.synchronize()
    assert fake_quant.launches["fake_quant"] == before + 1
    want = ops.fake_quant_plain(v, fmt, axis, out_dtype=out_dtype, ste=ste)
    assert got.dtype == want.dtype
    assert torch.equal(got.view(torch.int16 if got.dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if want.dtype == torch.bfloat16
                                 else torch.int32))


@pytest.mark.parametrize("shape,axis", QUANT_CASES)
@pytest.mark.parametrize("high,low", SS_PAIRS)
def test_ss_convert_bit_identical_with_plain(high, low, shape, axis):
    dev = _card()
    v = _values(shape, axis, 32, torch.float32, dev, seed=2)
    t = quantize(v, get_format(high, 32), axis=axis)
    before = ss_convert.launches["ss_convert"]
    got = ops.ss_convert(t, get_format(low, 32))
    torch.cuda.synchronize()
    assert ss_convert.launches["ss_convert"] == before + 1
    want = slice_and_scale(t, get_format(low, 32))
    assert torch.equal(got.codes, want.codes)
    assert torch.equal(got.scale_exp, want.scale_exp)


def test_ss_convert_reads_a_layer_slice_in_place():
    dev = _card()
    v = _values((3, 128, 80), 1, 32, torch.float32, dev, seed=3)
    t = quantize(v, get_format("mxint8", 32), axis=1)
    low = get_format("mxint4", 32)
    for g in range(3):
        part = type(t)(codes=t.codes[g], scale_exp=t.scale_exp[g], fmt=t.fmt,
                       block_axis=0)
        got, want = ops.ss_convert(part, low), slice_and_scale(part, low)
        assert torch.equal(got.codes, want.codes)
        assert torch.equal(got.scale_exp, want.scale_exp)


def test_same_format_launches_nothing():
    dev = _card()
    t = quantize(_values((64, 32), 0, 32, torch.float32, dev),
                 get_format("mxint8", 32), axis=0)
    before = ss_convert.launches["ss_convert"]
    assert ops.ss_convert(t, get_format("mxint8", 32)) is t
    assert ss_convert.launches["ss_convert"] == before


QWEN3_KN = [(2560, 4096), (2560, 1024), (4096, 2560), (2560, 9728),
            (9728, 2560)]


def _as_bytes(*ts):
    """The tensors' bytes in one flat uint8 tensor (for bit comparisons)."""
    return torch.cat([t.contiguous().view(torch.uint8).reshape(-1)
                      for t in ts])


def _all_codes(high, dev, rows=256):
    """(rows, 512) codes: column j of row r holds byte (j + r) % 256, so every
    code byte meets every other at distance N/2 (every split-N nibble pair);
    (512, rows / 32) scales running over the int8 range."""
    r = np.arange(rows)[:, None]
    u = ((np.arange(512)[None, :] * (1 + (np.arange(512) >= 256)) + r)
         % 256).astype(np.uint8)
    codes = torch.from_numpy(u).to(dev)
    if high.startswith("mxint"):
        codes = codes.view(torch.int8)
    scales = torch.from_numpy((np.arange(512 * rows // 32) % 256 - 128)
                              .astype(np.int8).reshape(512, rows // 32))
    return MXTensor(codes=codes, scale_exp=scales.to(dev),
                    fmt=get_format(high, 32), block_axis=0)


def _off_grid(t, offset):
    """``t`` with codes and scales copied ``offset`` bytes into larger
    buffers (views off the 16-byte grid)."""
    c = torch.zeros(t.codes.numel() + offset, dtype=t.codes.dtype,
                    device=t.codes.device)
    c[offset:] = t.codes.reshape(-1)
    sc = torch.zeros(t.scale_exp.numel() + offset, dtype=torch.int8,
                     device=t.codes.device)
    sc[offset:] = t.scale_exp.reshape(-1)
    return MXTensor(codes=c[offset:].view(t.codes.shape),
                    scale_exp=sc[offset:].view(t.scale_exp.shape),
                    fmt=t.fmt, block_axis=t.block_axis)


@pytest.mark.parametrize("high,low", SS_PAIRS)
def test_ss_convert_all_256_codes(high, low):
    """Every code byte and every int8 scale through the table kernel."""
    dev = _card()
    t = _all_codes(high, dev)
    got = ops.ss_convert(t, get_format(low, 32))
    want = slice_and_scale(t, get_format(low, 32))
    assert torch.equal(got.codes, want.codes)
    assert torch.equal(got.scale_exp, want.scale_exp)


@pytest.mark.parametrize("high", ["mxint8", "mxint6"])
def test_ss_convert_int4_splitn_all_code_pairs(high):
    """Every (code j, code j + N/2) pair of bytes through the fused mode."""
    dev = _card()
    t = _all_codes(high, dev)
    low = get_format("mxint4", 32)
    before = ss_convert.launches["ss_convert"]
    packed, scales = ops.ss_convert_int4_splitn(t, low)
    torch.cuda.synchronize()
    assert ss_convert.launches["ss_convert"] == before + 1
    want = pack_leaf_int4(slice_and_scale(t, low))
    assert torch.equal(packed, want.packed)
    assert torch.equal(scales, want.scale_exp)


def _splitn_case(shape, dev, offset=0, seed=11):
    """An mxint8 leaf of ``shape`` blocked along ndim-2; with ``offset`` its
    codes and scales are views that many bytes into larger buffers (off the
    16-byte grid)."""
    axis = len(shape) - 2
    t = quantize(_values(shape, axis, 32, torch.float32, dev, seed=seed),
                 get_format("mxint8", 32), axis=axis)
    return _off_grid(t, offset) if offset else t


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [*QWEN3_KN, (3, 2560, 1024),
                                   (2, 128, 40), (128, 130), (4, 64, 2)])
def test_ss_convert_int4_splitn_matches_plain(shape, offset):
    """Every qwen3-4b shape, a stacked leaf, N/2 off the 16-byte grid (40,
    130, 2) and buffers off it: one launch, the plain version's bytes."""
    dev = _card()
    t = _splitn_case(shape, dev, offset)
    low = get_format("mxint4", 32)
    before = ss_convert.launches["ss_convert"]
    packed, scales = ops.ss_convert_int4_splitn(t, low)
    torch.cuda.synchronize()
    assert ss_convert.launches["ss_convert"] == before + 1
    want = pack_leaf_int4(slice_and_scale(t, low))
    assert packed.shape == want.packed.shape
    assert torch.equal(packed, want.packed)
    assert torch.equal(scales, want.scale_exp)


@pytest.mark.parametrize("high,low", [("mxint8", "mxint4"),
                                      ("mxfp8", "mxfp4")])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_ss_convert_off_the_vector_grid(high, low, offset):
    """Codes and scales that start off the 16-byte grid, with ragged
    tails: the byte path of the same kernel."""
    dev = _card()
    t = _off_grid(quantize(_values((3, 96, 37), 1, 32, torch.float32, dev,
                                   seed=12), get_format(high, 32), axis=1),
                  offset)
    got = ops.ss_convert(t, get_format(low, 32))
    want = slice_and_scale(t, get_format(low, 32))
    assert torch.equal(got.codes, want.codes)
    assert torch.equal(got.scale_exp, want.scale_exp)


def test_ss_convert_bit_identical_eager_and_in_a_cuda_graph():
    dev = _card()
    t = _splitn_case((3, 2560, 1024), dev)
    low = get_format("mxint4", 32)
    _identical_eager_and_in_a_graph(
        lambda: _as_bytes(*ops.ss_convert_int4_splitn(t, low)))

    def unfused():
        out = ops.ss_convert(t, low)
        return _as_bytes(out.codes, out.scale_exp)
    _identical_eager_and_in_a_graph(unfused)


def test_packed_build_launches_once_per_leaf():
    """make_packed_params converts each stacked leaf by one launch into its
    final buffers; the tree equals the per-layer build (each layer slice
    converted, then packed, then stacked) leaf for leaf."""
    dev = _card()
    fmt = get_format("mxint8", 32)
    leaves = {"['a']": (3, 256, 96), "['b']": (3, 96, 256), "['c']": (64, 32),
              "['odd']": (2, 64, 7)}
    anchor = AnchorModel(
        quantized={k: quantize(_values(s, len(s) - 2, 32, torch.float32, dev,
                                       seed=i), fmt, axis=len(s) - 2)
                   for i, (k, s) in enumerate(leaves.items())},
        raw={"['n']": torch.ones(3, 96, device=dev)}, fmt_name=fmt.name)
    for target in ("mxint4", "mxint6"):
        low = get_format(target, 32)
        before = ss_convert.launches["ss_convert"]
        tree = dict(flatten_paths(make_packed_params(anchor,
                                                     target_fmt=target)))
        torch.cuda.synchronize()
        assert ss_convert.launches["ss_convert"] == before + len(leaves)
        for k, t in anchor.quantized.items():
            slices = [t] if t.codes.ndim == 2 else [
                MXTensor(codes=t.codes[g], scale_exp=t.scale_exp[g], fmt=fmt,
                         block_axis=t.block_axis - 1)
                for g in range(t.codes.shape[0])]
            conv = [slice_and_scale(p, low) for p in slices]
            if target == "mxint4":
                conv = [pack_leaf_int4(p) for p in conv]
                parts = [(p.packed, p.scale_exp) for p in conv]
                assert isinstance(tree[k], PackedInt4Leaf)
                assert tree[k].layout == conv[0].layout
                got = (tree[k].packed, tree[k].scale_exp)
            else:
                parts = [(p.codes, p.scale_exp) for p in conv]
                got = (tree[k].codes, tree[k].scale_exp)
            for g_t, parts_t in zip(got, zip(*parts)):
                want = parts_t[0] if t.codes.ndim == 2 \
                    else torch.stack(parts_t)
                assert torch.equal(g_t, want)


def _planted(shape, axis, bs, dtype, dev, seed=0):
    """Edge values plus, in blocks of their own: +-inf beside normal
    values, and +-the dtype's largest finite value."""
    v = _values(shape, axis, bs, torch.float32, dev, seed)
    vm = torch.movedim(v, axis, -1)
    rows = vm.reshape(-1, vm.shape[-1])
    n = rows.shape[0]
    big = torch.finfo(dtype).max
    rows[5 % n, :bs] = torch.linspace(-1, 1, bs, device=dev)
    rows[5 % n, 1] = float("inf")
    rows[5 % n, bs - 2] = float("-inf")
    rows[6 % n, bs - bs // 2:bs] = big
    rows[6 % n, 0] = -big
    out = torch.movedim(rows.reshape(vm.shape), -1, axis).contiguous()
    return out.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,axis", [((256, 96), 0), ((40, 128), -1),
                                        ((3, 128, 80), 1), ((64, 7), 0)])
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
@pytest.mark.parametrize("name", ["mxint8", "mxfp8", "mxfp4"])
def test_mx_quantize_planted_inf_and_max(name, bs, shape, axis, dtype):
    """bs 8-64, every layout and both dtypes, with +-inf and +-max blocks
    planted (a block holding inf takes frexp's exponent of inf, as the
    plain version does)."""
    dev = _card()
    if shape[axis] % bs:
        pytest.skip("block axis not a multiple of the block size")
    v = _planted(shape, axis, bs, dtype, dev)
    fmt = get_format(name, bs)
    got = ops.mx_quantize(v, fmt, axis=axis)
    want = quantize(v, fmt, axis=axis)
    assert torch.equal(got.codes, want.codes)
    assert torch.equal(got.scale_exp, want.scale_exp)


@pytest.mark.parametrize("offset", [1, 2])
def test_mx_quantize_off_the_vector_grid(offset):
    """Values that start off the 16-byte grid take the one-column path."""
    dev = _card()
    v = _planted((3, 128, 80), 1, 32, torch.float32, dev, seed=13)
    buf = torch.empty(v.numel() + offset, device=dev)
    buf[offset:] = v.reshape(-1)
    v = buf[offset:].view(v.shape)
    fmt = get_format("mxfp8", 32)
    got = ops.mx_quantize(v, fmt, axis=1)
    want = quantize(v, fmt, axis=1)
    assert torch.equal(got.codes, want.codes)
    assert torch.equal(got.scale_exp, want.scale_exp)


def test_mx_quantize_bit_identical_eager_and_in_a_cuda_graph():
    dev = _card()
    v = _planted((3, 2560, 1024), 1, 32, torch.float32, dev, seed=14)
    for name in ("mxint8", "mxfp8"):
        fmt = get_format(name, 32)

        def quant():
            out = ops.mx_quantize(v, fmt, 1)
            return _as_bytes(out.codes, out.scale_exp)
        _identical_eager_and_in_a_graph(quant)


@pytest.mark.parametrize("ste", [False, True])
@pytest.mark.parametrize("name", ["mxint4", "mxfp4", "mxfp8"])
def test_fake_quant_planted_inf_and_max(name, ste):
    dev = _card()
    v = _planted((3, 128, 80), 1, 32, torch.float32, dev, seed=15)
    fmt = get_format(name, 32)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = ops.fake_quant(v, fmt, 1, out_dtype=out_dtype, ste=ste)
        want = ops.fake_quant_plain(v, fmt, 1, out_dtype=out_dtype, ste=ste)
        assert torch.equal(_as_bytes(got), _as_bytes(want))


def test_kernels_refuse_what_they_do_not_take():
    """A CUDA tensor the kernels do not take raises; it never falls back to
    the plain version."""
    dev = _card()
    fmt = get_format("mxint8", 32)
    v = _values((64, 32), 0, 32, torch.float32, dev)
    with pytest.raises(ValueError):
        ops.mx_quantize(v.to(torch.float16), fmt, axis=0)
    with pytest.raises(ValueError):
        ops.fake_quant(v.t(), fmt, axis=1)              # not contiguous
    with pytest.raises(ValueError):
        ops.fake_quant(v, get_format("mxint8", 48), axis=1)
    with pytest.raises(ValueError):
        ops.fake_quant(v, fmt, axis=0, out_dtype=torch.float16)
    t = quantize(v, fmt, axis=0)
    bad = type(t)(codes=t.codes.to(torch.uint8), scale_exp=t.scale_exp,
                  fmt=fmt, block_axis=0)
    with pytest.raises(ValueError):
        ops.ss_convert(bad, get_format("mxint4", 32))
    with pytest.raises(ValueError):
        ops.ss_convert(t, get_format("mxfp4", 32))
    with pytest.raises(ValueError):
        ops.ss_convert_int4_splitn(t, get_format("mxint6", 32))
    with pytest.raises(ValueError):                     # odd N
        ops.ss_convert_int4_splitn(
            quantize(_values((64, 7), 0, 32, torch.float32, dev),
                     fmt, axis=0), get_format("mxint4", 32))


def test_paged_kernels_refuse_what_they_do_not_take():
    """Shapes outside the kernel's plan raise ValueError on the card; they
    never fall back to the plain version."""
    dev = _card()
    bt = torch.ones((2, 4), dtype=torch.int32, device=dev)
    cl = torch.tensor([3, 5], dtype=torch.int32, device=dev)
    for (h, hkv, d, ps) in ((8, 2, 48, 16),       # D not a power of two
                            (8, 2, 64, 128),      # pages over 64 keys
                            (128, 1, 64, 16)):    # 128 heads per kv head
        q = torch.zeros((2, h, d), dtype=torch.bfloat16, device=dev)
        kp = torch.zeros((5, ps, hkv, d), dtype=torch.bfloat16, device=dev)
        before = dict(paged_attention.launches)
        with pytest.raises(ValueError):
            paged_attention.paged_attention(q, kp, kp, bt, cl)
        with pytest.raises(ValueError):
            paged_attention.paged_attention_mq(q[:, None], kp, kp, bt, cl,
                                               torch.ones_like(cl))
        assert paged_attention.launches == before


# ---- jamba's shapes ----------------------------------------------------------
# x_proj 16384 -> 544 (dt_rank 512 + 2 x d_state 16): N is a multiple of
# neither 64 nor 128, so the last N tile is ragged; at decode (4), a
# prefill bucket (256) and llava's monolithic prefill M (3008).
@pytest.mark.parametrize("m", [4, 256, 3008])
@pytest.mark.parametrize("name", ["mxint8", "mxint4"])
def test_jamba_x_proj_shape_matches_plain(name, m):
    dev = _card()
    x, t = _operands(m, 16384, 544, name, 32, dev, seed=21)
    if name == "mxint4":
        leaf = pack_leaf_int4(t)
        assert leaf.packed.shape == (16384, 272)
        got = mx_matmul.mx_matmul_int4(x, leaf.packed, leaf.scale_exp, t.fmt)
        want = ref.ref_mx_matmul_int4(x, leaf.packed, leaf.scale_exp, t.fmt)
    else:
        got = mx_matmul.mx_matmul(x, t.codes, t.scale_exp, t.fmt)
        want = ref.ref_mx_matmul(x, t.codes, t.scale_exp, t.fmt)
    _close(got, want)


def test_ss_convert_int4_splitn_a_log_leaf():
    """B5 on an A_log-shaped stacked leaf (1, 16384, 16), mxint8 -> mxint4
    split-N (the anchor quantizes jamba's A_log, ROADMAP C.9): one launch,
    8 bytes per row, the plain version's bytes."""
    dev = _card()
    a = torch.log(torch.arange(1, 17, dtype=torch.float32, device=dev))
    a = a.expand(1, 16384, 16) + 0.01 * torch.randn(
        (1, 16384, 16), generator=torch.Generator(device=dev).manual_seed(5),
        device=dev)
    t = quantize(a.contiguous(), get_format("mxint8", 32), axis=1)
    low = get_format("mxint4", 32)
    before = ss_convert.launches["ss_convert"]
    packed, scales = ops.ss_convert_int4_splitn(t, low)
    torch.cuda.synchronize()
    assert ss_convert.launches["ss_convert"] == before + 1
    want = pack_leaf_int4(slice_and_scale(t, low))
    assert packed.shape == want.packed.shape == (1, 16384, 8)
    assert torch.equal(packed, want.packed)
    assert torch.equal(scales, want.scale_exp)
