"""The port's paged attention (plain B3/B4, paged writes, page counts)
against the JAX package's.

Inputs are made by numpy from a seed and handed to both: the JAX Pallas
kernels run in interpret mode (as the JAX package's own tests run them on
the CPU), the port's wrappers take their plain versions on CPU tensors.
Tolerance: rtol 1e-5, atol 1e-5 (the JAX kernel tests' own; both reduce in
f32, the Pallas kernel page by page, the plain version in one softmax).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro.models import layers as jL
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.models import layers as L

HKV, D = 2, 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _pools(rng, n_pages, ps):
    kp = rng.normal(size=(n_pages, ps, HKV, D)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, HKV, D)).astype(np.float32)
    return kp, vp


def _table(rng, spans, mp, ps, n_pages):
    """A disjoint block table: row i maps the pages covering spans[i]
    tokens from a random permutation; page 0 is scratch."""
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((len(spans), mp), np.int32)
    for i, n in enumerate(spans):
        k = -(-int(n) // ps)
        bt[i, :k] = perm[i * mp:i * mp + k]
    return bt


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _poison(kp, vp, bt, spans, ps):
    """NaN / 1e9 in every page no row maps (scratch page 0 included) and in
    the tail past each row's frontier inside its last page."""
    kp, vp = kp.copy(), vp.copy()
    used = set(bt.flatten().tolist()) - {0}
    for pg in range(kp.shape[0]):
        if pg not in used:
            kp[pg] = np.nan
            vp[pg] = np.nan if pg % 2 == 0 else 1e9
    for i, n in enumerate(spans):
        pg, off = n // ps, n % ps
        if off and pg < bt.shape[1] and bt[i, pg] != 0:
            kp[bt[i, pg], off:] = np.nan
            vp[bt[i, pg], off:] = np.nan
    return kp, vp


# ---------------------------------------------------------------------------
# B3
# ---------------------------------------------------------------------------
def _b3_case(seed, b, g, ps, mp=4, lens=None):
    rng = np.random.default_rng(seed)
    n_pages = b * mp + 1
    q = rng.normal(size=(b, HKV * g, D)).astype(np.float32)
    kp, vp = _pools(rng, n_pages, ps)
    if lens is None:
        lens = [0, ps, mp * ps][:b] if b > 1 else [ps + 1]
    bt = _table(rng, lens, mp, ps, n_pages)
    return q, kp, vp, bt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("window", [None, 10])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("b", [1, 3])
def test_plain_b3_matches_the_jax_kernel(b, g, ps, window):
    """cache_len at 0, at a page boundary and at the full table."""
    q, kp, vp, bt, cl = _b3_case(0, b, g, ps)
    want = np.asarray(jpa.paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(cl), window=window, interpret=True))
    before = dict(pa.launches)
    got = pa.paged_attention(*_t(q, kp, vp, bt, cl), window=window)
    assert got.dtype == torch.float32 and pa.launches == before
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("window", [None, 10])
def test_plain_b3_ignores_poisoned_pages(window):
    q, kp, vp, bt, cl = _b3_case(1, 3, 2, 8, lens=[0, 9, 29])
    clean = pa.paged_attention(*_t(q, kp, vp, bt, cl), window=window)
    kp_p, vp_p = _poison(kp, vp, bt, cl.tolist(), 8)
    dirty = pa.paged_attention(*_t(q, kp_p, vp_p, bt, cl), window=window)
    assert torch.equal(clean, dirty)              # bit-identical
    assert torch.isfinite(dirty).all()
    assert (dirty[0] == 0).all()                  # cache_len 0: exact zeros


# ---------------------------------------------------------------------------
# B4
# ---------------------------------------------------------------------------
PS, CHUNK = 8, 8
# cursors at cursor % ps in {0, 1, ps-1}; a decode row; a first chunk
ROWS = [(PS, CHUNK), (PS + 1, CHUNK - 3), (PS - 1, CHUNK), (2 * PS - 3, 1),
        (0, CHUNK - 1)]


def _b4_case(seed, rows, c=CHUNK, g=2, ps=PS):
    rng = np.random.default_rng(seed)
    spans = [qo + ql for qo, ql in rows]
    mp = max(-(-n // ps) for n in spans)
    n_pages = len(rows) * mp + 1
    q = rng.normal(size=(len(rows), c, HKV * g, D)).astype(np.float32)
    kp, vp = _pools(rng, n_pages, ps)
    bt = _table(rng, spans, mp, ps, n_pages)
    qo = np.asarray([r[0] for r in rows], np.int32)
    ql = np.asarray([r[1] for r in rows], np.int32)
    return q, kp, vp, bt, qo, ql


@pytest.mark.parametrize("tq", [None, 4])
@pytest.mark.parametrize("window", [None, 10])
def test_plain_b4_matches_the_jax_kernel(window, tq):
    q, kp, vp, bt, qo, ql = _b4_case(0, ROWS)
    want = np.asarray(jpa.paged_attention_pallas_mq(
        *[jnp.asarray(a) for a in (q, kp, vp, bt, qo, ql)], window=window,
        tq=tq, interpret=True))
    got = pa.paged_attention_mq(*_t(q, kp, vp, bt, qo, ql), window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for i, (_, n) in enumerate(ROWS):
        assert (got[i, n:] == 0).all()            # dead lanes: exact zeros


@pytest.mark.parametrize("window", [None, 10])
def test_plain_b4_ignores_poisoned_pages(window):
    q, kp, vp, bt, qo, ql = _b4_case(3, ROWS)
    clean = pa.paged_attention_mq(*_t(q, kp, vp, bt, qo, ql), window=window)
    kp_p, vp_p = _poison(kp, vp, bt, (qo + ql).tolist(), PS)
    dirty = pa.paged_attention_mq(*_t(q, kp_p, vp_p, bt, qo, ql),
                                  window=window)
    assert torch.equal(clean, dirty)
    assert torch.isfinite(dirty).all()


@pytest.mark.parametrize("window", [None, 12])
def test_b4_q_len_one_collapses_to_b3(window):
    rows = [(8, 1), (23, 1), (16, 1)]
    q, kp, vp, bt, qo, ql = _b4_case(1, rows, c=4)
    mq = pa.paged_attention_mq(*_t(q, kp, vp, bt, qo, ql), window=window)
    sq = pa.paged_attention(*_t(q[:, 0], kp, vp, bt, qo + 1), window=window)
    torch.testing.assert_close(mq[:, 0], sq, rtol=1e-6, atol=1e-6)
    assert (mq[:, 1:] == 0).all()


def test_kernel_and_gather_modes_agree():
    """The dispatch's two contracts read the same values at every live
    position (gather relies on finite pools; these are)."""
    q, kp, vp, bt, qo, ql = _b4_case(2, ROWS)
    tq, tk, tv, tb, to, tl = _t(q, kp, vp, bt, qo, ql)
    got = pa.paged_mixed_attention(tq, tk, tv, tb, to, tl, mode="kernel")
    want = pa.paged_mixed_attention(tq, tk, tv, tb, to, tl, mode="gather")
    torch.testing.assert_close(got, want, **TOL)
    dq = tq[:, :1]
    got = pa.paged_decode_attention(dq, tk, tv, tb, to + 1, mode="kernel")
    want = pa.paged_decode_attention(dq, tk, tv, tb, to + 1, mode="gather")
    torch.testing.assert_close(got, want, **TOL)
    with pytest.raises(ValueError, match="unknown paged-attention mode"):
        pa.paged_decode_attention(dq, tk, tv, tb, to + 1, mode="pallas")


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q, kp, vp, bt, qo, ql = _t(*_b4_case(4, ROWS))
    with pytest.raises(ValueError, match="block_table must be int32"):
        pa.paged_attention_mq(q, kp, vp, bt.long(), qo, ql)
    with pytest.raises(ValueError, match="lengths must be int32"):
        pa.paged_attention(q[:, 0], kp, vp, bt, qo.long())
    with pytest.raises(ValueError, match="do not fit pools"):
        pa.paged_attention(q[:, 0, :3], kp, vp, bt, qo)
    with pytest.raises(ValueError, match=r"q must be \(B, H, D\)"):
        pa.paged_attention(q, kp, vp, bt, qo)


# ---------------------------------------------------------------------------
# Page counts and paged writes
# ---------------------------------------------------------------------------
def test_page_counts_equal_the_jax_mirror():
    for ps in (8, 16):
        for window in (None, 10, 64):
            for n in (0, 1, 7, 8, 9, 31, 32, 40, 200):
                assert pa.pages_read(n, ps, window) == \
                    jpa.pages_read(n, ps, window)
                for ql in (1, 3, 8, 16):
                    assert pa.pages_read_mq(n, ql, ps, window) == \
                        jpa.pages_read_mq(n, ql, ps, window)


def test_paged_writes_round_trip_like_jax():
    """prefill at a page-aligned cursor, a decode append, a ragged mixed
    append: the port writes in place what JAX returns as copies."""
    rng = np.random.default_rng(5)
    ps, mp, b = 4, 6, 3
    n_pages = b * mp + 1
    pool = np.zeros((n_pages, ps, HKV, D), np.float32)
    bt = _table(rng, [mp * ps] * b, mp, ps, n_pages)
    bt[2, 3:] = 0                                   # an unmapped tail
    jpool, tpool = jnp.asarray(pool), torch.from_numpy(pool.copy())
    jbt, tbt = jnp.asarray(bt), torch.from_numpy(bt)

    kv = rng.normal(size=(b, 6, HKV, D)).astype(np.float32)
    jpool = jL.paged_prefill_update(jpool, jnp.asarray(kv), jbt, start_pos=4)
    L.paged_prefill_update(tpool, torch.from_numpy(kv), tbt, start_pos=4)
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))

    tok = rng.normal(size=(b, 1, HKV, D)).astype(np.float32)
    cl = np.asarray([5, 11, 9], np.int32)
    jpool = jL.paged_decode_append(jpool, jnp.asarray(tok), jbt,
                                   jnp.asarray(cl))
    L.paged_decode_append(tpool, torch.from_numpy(tok), tbt,
                          torch.from_numpy(cl))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))

    kv = rng.normal(size=(b, 5, HKV, D)).astype(np.float32)
    cl = np.asarray([12, 3, 10], np.int32)
    ql = np.asarray([1, 5, 4], np.int32)
    jpool = jL.paged_mixed_update(jpool, jnp.asarray(kv), jbt,
                                  jnp.asarray(cl), jnp.asarray(ql))
    L.paged_mixed_update(tpool, torch.from_numpy(kv), tbt,
                         torch.from_numpy(cl), torch.from_numpy(ql))
    # page 0 is scratch: colliding writes land there in any order
    np.testing.assert_array_equal(tpool.numpy()[1:], np.asarray(jpool)[1:])
    # and the block table reads each row's positions back in logical order
    mapped = np.repeat(bt != 0, ps, axis=1)
    np.testing.assert_array_equal(
        L.paged_gather(tpool, tbt).numpy()[mapped],
        np.asarray(jL.paged_gather(jpool, jbt))[mapped])


def test_dense_mixed_append_drops_pad_lanes_like_jax():
    rng = np.random.default_rng(6)
    cache = rng.normal(size=(3, 12, HKV, D)).astype(np.float32)
    kv = rng.normal(size=(3, 4, HKV, D)).astype(np.float32)
    cl = np.asarray([11, 2, 5], np.int32)
    ql = np.asarray([1, 4, 2], np.int32)
    want = jL.mixed_cache_update(jnp.asarray(cache), jnp.asarray(kv),
                                 jnp.asarray(cl), jnp.asarray(ql))
    got = torch.from_numpy(cache.copy())
    L.mixed_cache_update(got, torch.from_numpy(kv), torch.from_numpy(cl),
                         torch.from_numpy(ql))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_versions_are_the_cpu_path():
    q, kp, vp, bt, cl = _b3_case(7, 3, 2, 8)
    args = _t(q, kp, vp, bt, cl)
    assert torch.equal(pa.paged_attention(*args),
                       ref.ref_paged_attention(*args))


# ---------------------------------------------------------------------------
# The split plan: how the kernel cuts each walk across blocks, from shapes
# ---------------------------------------------------------------------------
def _covered(plan, first, last, rows):
    """The pages the plan's splits read of walk [first, last] for a q block
    of ``rows`` live rows, in split order. Each split stays inside its own
    run of pages, except that a folded walk (more than FOLD_ROWS rows over
    at most FOLD_TILES tiles) is read whole by the split of its first
    page."""
    pages = []
    pps = plan.pages_per_split
    fold = rows > pa.FOLD_ROWS \
        and last - first < pa.FOLD_TILES * plan.tile_pages
    for s in range(plan.splits):
        part = list(pa.split_pages(plan, first, last, s, rows))
        if fold:
            assert not part or s == first // pps
        else:
            assert all(s * pps <= p < (s + 1) * pps for p in part)
        pages += part
    return pages


@pytest.mark.parametrize("mp", [32, 256])
@pytest.mark.parametrize("window", [None, 10, 64])
@pytest.mark.parametrize("ps", [8, 16])
def test_split_plan_covers_the_b3_walk_exactly_once(ps, window, mp):
    """Every page of the clamped walk is read by exactly one split, no split
    reads outside it, and the walk is what pages_read (and JAX) count."""
    plan = pa.split_plan(4, 1, 32, 8, 128, ps, mp)
    assert plan.tq == 1 and plan.nq == 1
    for n in range(512):
        first, last = pa.walk(n - 1, 1, 0, plan.tq, 1, ps, mp, window)
        assert _covered(plan, first, last, 4) == list(range(first,
                                                           last + 1))
        if n <= mp * ps:
            assert last - first + 1 == pa.pages_read(n, ps, window) \
                == jpa.pages_read(n, ps, window)
        else:                              # longer than the table holds
            assert last == mp - 1


@pytest.mark.parametrize("q_len", [1, 3, 16, 64])
@pytest.mark.parametrize("mp", [32, 256])
@pytest.mark.parametrize("window", [None, 10, 64])
@pytest.mark.parametrize("ps", [8, 16])
def test_split_plan_covers_the_b4_walks_exactly_once(ps, window, mp, q_len):
    """For every q block of a 64-lane chunk at every cursor, the splits read
    each page of that block's walk once; the q blocks' walks together are
    the row's pages_read_mq (and JAX's), and a block with no live lane
    reads nothing."""
    c = 64
    plan = pa.split_plan(4, c, 32, 8, 128, ps, mp)
    for qo in range(512):
        union = set()
        for qb in range(plan.nq):
            w = pa.walk(qo, q_len, qb, plan.tq, c, ps, mp, window)
            if w is None:
                assert qb * plan.tq >= q_len
                continue
            first, last = w
            rows = 4 * pa.live_lanes(q_len, qb, plan.tq, c)
            assert _covered(plan, first, last, rows) == list(range(first,
                                                                  last + 1))
            union.update(range(first, last + 1))
        if qo + q_len <= mp * ps:
            want = pa.pages_read_mq(qo, q_len, ps, window)
            assert want == jpa.pages_read_mq(qo, q_len, ps, window)
            assert len(union) == want
            assert union == set(range(min(union), max(union) + 1))
        else:
            assert max(union) == mp - 1


@pytest.mark.parametrize("b,c,h,hkv,d,ps,mp,itemsize", [
    (4, 1, 32, 8, 128, 16, 32, 2),          # qwen3-4b decode (B3)
    (4, 64, 32, 8, 128, 16, 32, 2),         # qwen3-4b mixed tick (B4)
    (4, 1, 32, 8, 128, 16, 257, 2),         # long context: many splits
    (4, 64, 9, 3, 64, 16, 32, 2),           # smollm-135m, G = 3
    (3, 40, 32, 4, 64, 16, 4, 4),           # f32, G = 8, one split
    (2, 8, 64, 1, 256, 8, 300, 4),          # f32 at D 256: one stage
])
def test_split_plan_sizes_match_the_launch(b, c, h, hkv, d, ps, mp,
                                           itemsize):
    """The grid covers every (slot, kv head, q block) and split, the
    splits cover the table, and the buffers the wrapper allocates hold
    every partial the kernel can write."""
    plan = pa.split_plan(b, c, h, hkv, d, ps, mp, itemsize)
    g = h // hkv
    assert plan.grid == (plan.splits, hkv, b * plan.nq)
    assert plan.groups == b * hkv * plan.nq
    assert plan.rows == plan.tq * g <= pa.ROWS
    assert plan.tq * (plan.nq - 1) < c <= plan.tq * plan.nq
    assert plan.tile_pages * ps <= pa.TILE_KEYS
    pps = plan.pages_per_split
    assert (plan.splits - 1) * pps < mp <= plan.splits * pps
    assert plan.smem_bytes <= pa.MAX_SMEM
    # two tiles in flight wherever a block may walk more than one: a split
    # of several tiles, or a folded walk of a q block of many rows
    multi = plan.tiles_per_split > 1 or plan.rows > pa.FOLD_ROWS
    assert plan.stages == (2 if multi
                           and pa._smem(d, itemsize, 2) <= pa.MAX_SMEM
                           else 1)
    assert plan.splits <= pa.MAX_SPLITS
    # the warps' merge reuses q and one stage: 64 rows x (D + 8) f32 and
    # 3 x 64
    ld = d + 16 // itemsize
    assert 4 * (pa.ROWS * (d + 8) + 3 * pa.ROWS) \
        <= itemsize * (pa.ROWS + 2 * pa.TILE_KEYS) * ld
    acc, ml, tickets = pa.launch_buffers(plan, torch.device("cpu"))
    assert acc.dtype == ml.dtype == torch.float32
    assert tickets.dtype == torch.int32 and (tickets == 0).all()
    assert tickets.numel() >= plan.groups
    if plan.splits == 1:                    # blocks write the output
        assert acc.numel() == ml.numel() == 0
    else:                                   # the last index each can take
        last = plan.groups * plan.splits - 1
        assert acc.numel() == (last * plan.rows + plan.rows - 1) * d + d
        assert ml.numel() == (2 * last + 1) * plan.rows + plan.rows


def test_split_plan_refuses_what_the_kernel_does_not_take():
    for d in (24, 48, 96, 512):
        with pytest.raises(ValueError, match="power of two"):
            pa.split_plan(2, 1, 8, 2, d, 16, 8)
    with pytest.raises(ValueError, match="page sizes"):
        pa.split_plan(2, 1, 8, 2, 64, 128, 8)
    with pytest.raises(ValueError, match="query rows a block holds"):
        pa.split_plan(2, 1, 128, 1, 64, 16, 8)
    with pytest.raises(ValueError, match="block table needs a column"):
        pa.split_plan(2, 1, 8, 2, 64, 16, 0)
    with pytest.raises(ValueError, match="fewer than 2"):
        pa.split_plan(2, 1, 8, 2, 64, 16, 1 << 16)
