"""The engine's decode and mixed ticks as CUDA graphs (``serve/tick_graph.py``).

A captured tick reads and writes its tensors where they lay at capture, so
the engine keeps the KV cache, ``cache_len``, the tokens, the block table
and each mixed-tick width's buffers in one storage for its lifetime. On the
CPU (reduced qwen3-4b, 2 layers, 2 slots) these tests hold:

- that storage, at every step call of two waves on one engine and of a
  third wave preempted and resumed on it (``resume`` copies the snapshot
  into the buffers in place), on both KV layouts, monolithic and chunked,
  under both schedulers;
- the greedy streams and the tick trace of two consecutive waves on one
  engine against two waves of the JAX ``ElasticEngine`` (the second wave
  starts from the zeroed persistent cache);
- ``mixed_cache_update``, now free of data-dependent shapes, against JAX on
  ragged rows;
- the engine's graph path with a stand-in for the CUDA graph whose replay
  reruns the step captured at the first tick — with the tensors that step
  read then — and writes garbage over every other graph's static output:
  the streams, traces and path counts must equal the eager engine's, for
  greedy waves, sampled waves (the batch draw's graph and the slots' key,
  temperature and top-p lanes), a chaos wave (an in-place NaN pool
  page, step crashes, a failed allocation, a cancellation), speculative
  waves (draft steps against the draft cursor, verifies per width) and
  resumed waves (on the engine whose graphs are captured, and on a fresh
  one);
- ``cuda_graphs=True`` refused on the CPU.

The ``gpu`` cases run the same engines on the card, graph against eager,
greedy, sampled and under chaos (the JAX package is not needed there);
they skip on a host without one.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs import get_reduced
from repro_torch.core.anchor import make_anchor
from repro_torch.core.qat import QATConfig
from repro_torch.kernels import dispatch, mx_matmul
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import layers as L
from repro_torch.models.transformer import init_params, make_model
from repro_torch.runtime.fault import FaultInjector, PreemptionGuard
from repro_torch.serve import tick_graph
from repro_torch.serve.engine import ElasticEngine, Request, RequestStatus
from repro_torch.serve.policy import SpecConfig

SLOTS, MAX_LEN, MAX_NEW, PS = 2, 48, 5, 8
PAGED = dict(kv_layout="paged", kv_page_size=PS, attn_impl="paged_kernel")
CONFIGS = {
    "dense-monolithic": {},
    "dense-chunk-mixed": dict(prefill_chunk=8),
    "paged-monolithic": PAGED,
    "paged-chunk-mixed": dict(PAGED, prefill_chunk=8),
    "paged-chunk-sequential": dict(PAGED, prefill_chunk=8,
                                   scheduler="sequential"),
}
WAVES = ((3, (21, 5, 13, 30)), (4, (9, 17, 3)))    # (seed, prompt lengths)


def _prompts(vocab, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _requests(prompts, max_new=MAX_NEW):
    return [Request(i, p, max_new) for i, p in enumerate(prompts)]


def _trace(tick_trace):
    return [(t["prefill_tokens"], t["decode"], t["execs"]) for t in tick_trace]


@pytest.fixture(scope="module")
def cpu_anchor():
    cfg = get_reduced("qwen3-4b")
    params = init_params(cfg, 0, device="cpu")
    return cfg, make_anchor(params, QATConfig(anchor="mxint8"), device="cpu")


def _engine(cfg, anchor, device="cpu", **kw):
    kw.setdefault("batch_slots", SLOTS)
    kw.setdefault("max_len", MAX_LEN)
    return ElasticEngine(make_model(cfg), anchor, device=device, **kw)


# ---------------------------------------------------------------------------
# Storage: what a captured tick reads keeps its place
# ---------------------------------------------------------------------------
def _cache_tensors(cache):
    out = [t for c in cache["blocks"] for t in c.values()]
    if "block_table" in cache:
        out.append(cache["block_table"])
    return out


class _Spy:
    """Wraps the engine's serving entry points and keeps every tensor they
    were handed (kept alive, no address can be handed out twice)."""

    def __init__(self, eng):
        self.seen = {}
        api = eng._packed_api
        eng._packed_api = dataclasses.replace(
            api, serve_step=self._wrap("serve_step", api.serve_step),
            mixed_step=self._wrap("mixed_step", api.mixed_step),
            verify_step=self._wrap("verify_step", api.verify_step),
            prefill_slot=self._wrap("prefill_slot", api.prefill_slot),
            prefill_chunk_slot=self._wrap("prefill_chunk_slot",
                                          api.prefill_chunk_slot))

    def _wrap(self, name, fn):
        def spy(params, batch, cache, *rest):
            rec = {"cache": _cache_tensors(cache)}
            if name in ("serve_step", "mixed_step", "verify_step"):
                rec["cache_len"] = rest[0]
                rec["batch"] = dict(batch)
            self.seen.setdefault(name, []).append(rec)
            return fn(params, batch, cache, *rest)
        return spy

    def ptrs(self, name, what):
        return {tuple(t.data_ptr() for t in r[what]) if what == "cache"
                else r[what].data_ptr() for r in self.seen.get(name, [])}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tick_buffers_keep_their_storage_across_waves(cpu_anchor, name,
                                                      tmp_path):
    cfg, anchor = cpu_anchor
    eng = _engine(cfg, anchor, **CONFIGS[name])
    spy = _Spy(eng)
    for seed, lens in WAVES:
        reqs = eng.generate(_requests(_prompts(cfg.vocab, seed, lens)),
                            fmt_override="mxint8")
        assert all(r.status is RequestStatus.COMPLETED for r in reqs)
    # a third wave, preempted at tick 3 and resumed on this engine: the
    # snapshot goes back into the same buffers, and the streams are the
    # uninterrupted eager engine's
    prompts = _prompts(cfg.vocab, *WAVES[0])
    want = _engine(cfg, anchor, **CONFIGS[name]).generate(
        _requests(prompts), fmt_override="mxint8")
    eng._fault_injector = FaultInjector(preempt_at=3)
    cut = eng.generate(_requests(prompts), fmt_override="mxint8",
                       guard=PreemptionGuard(), snapshot_dir=str(tmp_path))
    assert not all(r.done for r in cut)
    eng._fault_injector = None
    got = eng.resume(str(tmp_path))
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    cache = {tuple(t.data_ptr() for t in _cache_tensors(eng._cache))}
    for entry in spy.seen:
        assert spy.ptrs(entry, "cache") == cache, entry
    steps = [r for e in ("serve_step", "mixed_step")
             for r in spy.seen.get(e, [])]
    assert steps
    assert {r["cache_len"].data_ptr() for r in steps} == \
        {eng._cache_len.data_ptr()}
    assert {r["batch"]["tokens"].data_ptr()
            for r in spy.seen.get("serve_step", [])} <= \
        {eng._tokens.data_ptr()}
    mixed = spy.seen.get("mixed_step", [])
    assert bool(mixed) == (CONFIGS[name].get("prefill_chunk") is not None
                           and eng.scheduler == "mixed")
    for r in mixed:
        buf = eng._mixed_bufs[r["batch"]["tokens"].shape[1]]
        assert r["batch"]["tokens"].data_ptr() == buf["tokens"].data_ptr()
        assert r["batch"]["q_len"].data_ptr() == buf["q_len"].data_ptr()
    if mixed:
        assert len(eng._mixed_bufs) == len({r["batch"]["tokens"].shape[1]
                                            for r in mixed})


# ---------------------------------------------------------------------------
# Two waves on one engine against two waves of the JAX engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_served(tmp_path_factory):
    jax = pytest.importorskip("jax")
    from repro.checkpoint.anchor_ckpt import save_anchor as jsave
    from repro.configs import get_reduced as jreduced
    from repro.core.anchor import make_anchor as jmake
    from repro.core.qat import QATConfig as JQAT
    from repro.models import get_model as jget_model
    from repro_torch.checkpoint.anchor_ckpt import load_anchor
    api = jget_model(jreduced("qwen3-4b"))
    params = jax.jit(api.init_params)(jax.random.PRNGKey(0))
    anchor = jax.jit(lambda p: jmake(p, JQAT(anchor="mxint8")))(params)
    path = str(tmp_path_factory.mktemp("anchor") / "anchor")
    jsave(path, anchor)
    return api, params, anchor, load_anchor(path, device="cpu")


@pytest.mark.parametrize("fmt", ["mxint8", "mxint4"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_two_waves_on_one_engine_equal_the_jax_engine(jax_served, name, fmt):
    from repro.serve.engine import ElasticEngine as JEngine
    from repro.serve.engine import Request as JRequest
    api, params, janchor, anchor = jax_served
    kw = dict(CONFIGS[name], batch_slots=SLOTS, max_len=MAX_LEN)
    jeng = JEngine(api, janchor, fused=False, param_template=params, **kw)
    eng = _engine(get_reduced("qwen3-4b"), anchor, **CONFIGS[name])
    for seed, lens in WAVES:
        prompts = _prompts(api.cfg.vocab, seed, lens)
        want = jeng.generate([JRequest(i, p, MAX_NEW)
                              for i, p in enumerate(prompts)],
                             fmt_override=fmt)
        got = eng.generate(_requests(prompts), fmt_override=fmt)
        assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
        assert _trace(eng.tick_trace) == _trace(jeng.tick_trace)
        assert all(r.status is RequestStatus.COMPLETED for r in got)
    st = eng.stats()
    assert st["kv_pages_alloc"] == st["kv_pages_freed"]
    assert st["cuda_graphs"] is False and st["graph_captures"] == 0


# ---------------------------------------------------------------------------
# The dense mixed-tick KV write without data-dependent shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("smax,c,cache_len,q_len", [
    # a row at the last position, a full row, a q_len 0 row, a row whose
    # live lanes run past Smax, a row at capacity (cache_len == Smax)
    (12, 4, [11, 2, 5, 10, 12], [1, 4, 0, 4, 3]),
    (6, 8, [0, 3, 6], [8, 5, 2]),             # C > Smax
    (9, 9, [0, 4, 9, 1], [9, 2, 9, 0]),       # C == Smax
])
def test_dense_mixed_append_matches_jax_on_ragged_rows(smax, c, cache_len,
                                                       q_len):
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import layers as jL
    rng = np.random.default_rng(smax + c)
    b = len(cache_len)
    cache = rng.normal(size=(b, smax, 2, 16)).astype(np.float32)
    kv = rng.normal(size=(b, c, 2, 16)).astype(np.float32)
    cl, ql = np.asarray(cache_len, np.int32), np.asarray(q_len, np.int32)
    want = jL.mixed_cache_update(jnp.asarray(cache), jnp.asarray(kv),
                                 jnp.asarray(cl), jnp.asarray(ql))
    got = torch.from_numpy(cache.copy())
    L.mixed_cache_update(got, torch.from_numpy(kv), torch.from_numpy(cl),
                         torch.from_numpy(ql))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The graph path, with a stand-in for the CUDA graph
# ---------------------------------------------------------------------------
class _ReplayedStep:
    """A CUDA graph's stand-in: ``replay`` reruns the step it was captured
    from (the closure of the first tick of its key, holding the tensors
    that tick read) into the static output, as a graph reruns its kernels
    on the pointers it captured, and sets back the counts the rerun moved
    (a replay runs no Python). It then writes garbage over every other
    graph's static output (NaN, or -1 in an integer one: a sampled tick's
    draw), as a replay in a shared pool may."""

    def __init__(self, step, static, graphs):
        self.step, self.static, self.graphs = step, static, graphs
        graphs.append(self)

    def replay(self):
        before = [m.snapshot() for m in tick_graph.COUNTERS]
        self.static.copy_(self.step())
        for m, b in zip(tick_graph.COUNTERS, before):
            m.credit({k: b[k] - n for k, n in m.snapshot().items()})
        for g in self.graphs:
            if g is not self:
                g.static.fill_(float("nan") if g.static.is_floating_point()
                               else -1)


@pytest.fixture
def stand_in_graphs(monkeypatch):
    graphs = []
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(
        tick_graph, "capture",
        lambda step, pool: (lambda s: (_ReplayedStep(step, s, graphs), s))(
            step()))
    return graphs


def _counts():
    return {**dispatch.stats(), **pa.stats()}


def _wave(eng, cfg, seed, lens, fmt):
    before = _counts()
    reqs = eng.generate(_requests(_prompts(cfg.vocab, seed, lens)),
                        fmt_override=fmt)
    after = _counts()
    return ([r.out_tokens for r in reqs], [r.status for r in reqs],
            _trace(eng.tick_trace),
            {k: after[k] - before[k] for k in after})


@pytest.mark.parametrize("name", ["dense-monolithic", "dense-chunk-mixed",
                                  "paged-chunk-mixed",
                                  "paged-chunk-sequential"])
def test_graph_path_equals_eager_with_a_stand_in_graph(cpu_anchor,
                                                       stand_in_graphs, name):
    cfg, anchor = cpu_anchor
    eager = _engine(cfg, anchor, **CONFIGS[name])
    graphed = _engine(cfg, anchor, **CONFIGS[name])
    graphed._graphs = tick_graph.TickGraphs()
    for i, (seed, lens) in enumerate(WAVES + WAVES[:1]):
        fmt = ("mxint8", "mxint4")[i % 2]
        want = _wave(eager, cfg, seed, lens, fmt)
        captures = graphed._graphs.captures
        got = _wave(graphed, cfg, seed, lens, fmt)
        assert got == want
        if i == 2:                    # the first wave's keys again
            assert graphed._graphs.captures == captures
    st = graphed.stats()
    # one decode or mixed step per decode-carrying tick (no guard replay):
    # the first of each key captured, every other one replayed
    assert st["graph_captures"] == len(stand_in_graphs) >= 2
    assert st["graph_replays"] + st["graph_captures"] == st["ticks"]
    assert st["graph_replays"] > st["graph_captures"]


def test_poisoned_wave_escalates_once_with_a_stand_in_graph(
        cpu_anchor, stand_in_graphs):
    cfg, anchor = cpu_anchor
    runs = {}
    for mode in ("eager", "graph"):
        eng = _engine(cfg, anchor, fault_injector=FaultInjector(
            poison_logits={2: 0}))
        if mode == "graph":
            eng._graphs = tick_graph.TickGraphs()
        reqs = eng.generate(_requests(_prompts(cfg.vocab, *WAVES[0])),
                            fmt_override="mxint4")
        st = eng.stats()
        runs[mode] = ([r.out_tokens for r in reqs],
                      [r.status for r in reqs], _trace(eng.tick_trace),
                      [(e["tick"], e["from"], e["to"])
                       for e in st["escalation_events"]])
    assert runs["graph"] == runs["eager"]
    assert runs["graph"][3] == [(2, "mxint4", "mxint6")]


SAMPLED = dict(seed=1, temperature=0.8, top_p=0.95)
CHAOS = dict(kv_layout="paged", kv_page_size=PS, attn_impl="gather",
             prefill_chunk=8)
# tick 6 is the wave's first decode-carrying tick: the eager tick before
# its key's capture
CHAOS_PLAN = dict(poison_pool={3: 1}, raise_in_step=(6, 8),
                  cancel_at={5: 3}, fail_allocs=(1,))


def _graphed(eng):
    """``eng`` on the graph path: its ticks and its sampled draw."""
    eng._graphs = tick_graph.TickGraphs()
    eng._draw_graphs = tick_graph.TickGraphs()
    return eng


def _sampled_requests(prompts):
    reqs = _requests(prompts)
    reqs[1].temperature = 1.3               # per-request lanes
    reqs[2].top_p = 0.7
    return reqs


@pytest.mark.parametrize("name", ["dense-monolithic", "paged-chunk-mixed",
                                  "paged-chunk-sequential"])
def test_sampled_waves_equal_eager_with_a_stand_in_graph(cpu_anchor,
                                                         stand_in_graphs,
                                                         name):
    """The batch draw's graph reads the slots' keys, temperatures and
    top-p values where they lay at its capture: the stand-in reruns the
    captured closure, so a rebinding would change the streams. Three
    sampled waves on one engine equal the eager engine's, the lanes keep
    their storage, and the draw is captured once."""
    cfg, anchor = cpu_anchor
    eager = _engine(cfg, anchor, **SAMPLED, **CONFIGS[name])
    graphed = _graphed(_engine(cfg, anchor, **SAMPLED, **CONFIGS[name]))
    lanes = [t.data_ptr() for t in (graphed._keys, graphed._temps,
                                    graphed._tops)]
    for i, (seed, lens) in enumerate(WAVES + WAVES[:1]):
        fmt = ("mxint8", "mxint4")[i % 2]
        runs = []
        for eng in (eager, graphed):
            reqs = eng.generate(_sampled_requests(
                _prompts(cfg.vocab, seed, lens)), greedy=False,
                fmt_override=fmt)
            runs.append(([r.out_tokens for r in reqs],
                         [r.status for r in reqs], _trace(eng.tick_trace)))
        assert runs[1] == runs[0]
        assert all(s is RequestStatus.COMPLETED for s in runs[1][1])
        assert [t.data_ptr() for t in (graphed._keys, graphed._temps,
                                       graphed._tops)] == lanes
    assert torch.equal(graphed._keys, eager._keys)
    st = graphed.stats()
    assert st["draw_graph_captures"] == 1
    assert st["draw_graph_replays"] + 1 == st["ticks"]      # no replays
    greedy = eager.generate(_requests(_prompts(cfg.vocab, *WAVES[0])),
                            fmt_override="mxint8")
    sampled = graphed.generate(_sampled_requests(
        _prompts(cfg.vocab, *WAVES[0])), greedy=False, fmt_override="mxint8")
    assert [r.out_tokens for r in sampled] != [r.out_tokens for r in greedy]
    assert graphed.stats()["draw_graph_captures"] == 1


def test_chaos_wave_equals_eager_with_a_stand_in_graph(cpu_anchor,
                                                       stand_in_graphs):
    """A NaN page written into the pools in place (the captured ticks read
    them where they lie), a step crash on the first tick of a graph key
    and another later, a failed allocation and a cancellation: the graph
    path retires, retries and streams exactly as the eager engine, and the
    pools keep their storage."""
    cfg, anchor = cpu_anchor
    runs = {}
    for mode in ("eager", "graph"):
        eng = _engine(cfg, anchor, fault_injector=FaultInjector(**CHAOS_PLAN),
                      **CHAOS)
        if mode == "graph":
            _graphed(eng)
        before = _counts()
        reqs = eng.generate(_requests(_prompts(cfg.vocab, *WAVES[0])),
                            fmt_override="mxint4")
        after = _counts()
        st = eng.stats()
        runs[mode] = ([r.out_tokens for r in reqs], [r.status for r in reqs],
                      [r.error for r in reqs], _trace(eng.tick_trace),
                      eng._fault_injector.events, st["escalation_events"],
                      st["ticks_replayed"], st["admission_requeues"],
                      {k: after[k] - before[k] for k in after})
        assert st["kv_pages_alloc"] == st["kv_pages_freed"]
        if mode == "graph":
            assert st["graph_captures"] == len(stand_in_graphs)
            assert min(i for i, t in enumerate(eng.tick_trace)
                       if t["decode"]) == 6
            assert st["graph_captures"] + st["graph_replays"] == \
                sum(t["execs"] for t in eng.tick_trace if t["decode"])
            pools = [t.data_ptr() for t in _cache_tensors(eng._cache)]
            eng._fault_injector = FaultInjector(**CHAOS_PLAN)
            eng.generate(_requests(_prompts(cfg.vocab, *WAVES[0])),
                         fmt_override="mxint4")
            assert [t.data_ptr() for t in _cache_tensors(eng._cache)] == pools
    assert runs["graph"] == runs["eager"]
    statuses = runs["graph"][1]
    assert statuses[3] is RequestStatus.CANCELLED
    assert RequestStatus.FAILED_NUMERIC in statuses      # the poisoned page
    assert {e["kind"] for e in runs["graph"][4]} == {
        "poison_pool", "raise_in_step", "cancel", "fail_alloc"}


SPEC = SpecConfig(draft_fmt="mxint4", k=4)


@pytest.mark.parametrize("name", ["dense-monolithic", "paged-monolithic",
                                  "paged-chunk-mixed"])
def test_speculative_waves_equal_eager_with_a_stand_in_graph(
        cpu_anchor, stand_in_graphs, name):
    """Draft steps read the draft cursor and tokens, verifies their own
    per-width buffers: the stand-in reruns the closures captured at the
    first tick of each key, so a rebinding would change the streams. Two
    speculative waves on one engine equal the eager engine's (traces,
    spec counters and path counts included) and plain decode's; the draft
    buffers and the verify buffers keep their storage; the draft graph is
    keyed apart from the committed serve_step's."""
    cfg, anchor = cpu_anchor
    eager = _engine(cfg, anchor, speculative=SPEC, **CONFIGS[name])
    graphed = _graphed(_engine(cfg, anchor, speculative=SPEC,
                               **CONFIGS[name]))
    plain = _engine(cfg, anchor, **CONFIGS[name])
    spy = _Spy(graphed)
    for seed, lens in WAVES:
        want = _wave(eager, cfg, seed, lens, "mxint8")
        got = _wave(graphed, cfg, seed, lens, "mxint8")
        assert got == want
        assert got[0] == _wave(plain, cfg, seed, lens, "mxint8")[0]
    st, est = graphed.stats(), eager.stats()
    for key in ("spec_ticks", "spec_accepted", "spec_rejected", "ticks"):
        assert st[key] == est[key], key
    assert st["spec_ticks"] > 0
    assert [(t["draft_execs"], t["verify_execs"])
            for t in graphed.tick_trace] == \
        [(t["draft_execs"], t["verify_execs"]) for t in eager.tick_trace]
    keys = set(graphed._graphs._entries)
    assert ("draft_step", "mxint4", graphed.kv_layout, 1) in keys
    assert any(k[0] == "verify_step" for k in keys)
    drafts = [r for r in spy.seen["serve_step"]
              if r["cache_len"].data_ptr() != graphed._cache_len.data_ptr()]
    assert drafts
    assert {r["cache_len"].data_ptr() for r in drafts} == \
        {graphed._draft_len.data_ptr()}
    assert {r["batch"]["tokens"].data_ptr() for r in drafts} == \
        {graphed._draft_tok.data_ptr()}
    for r in spy.seen["verify_step"]:
        buf = graphed._verify_bufs[r["batch"]["tokens"].shape[1]]
        assert r["batch"]["tokens"].data_ptr() == buf["tokens"].data_ptr()
        assert r["batch"]["q_len"].data_ptr() == buf["q_len"].data_ptr()
        assert r["cache_len"].data_ptr() == graphed._cache_len.data_ptr()


@pytest.mark.parametrize("name,preempt_at", [("dense-monolithic", 2),
                                             ("paged-chunk-mixed", 9)])
def test_resumed_waves_equal_eager_with_a_stand_in_graph(
        cpu_anchor, stand_in_graphs, name, preempt_at, tmp_path):
    """A graphed engine preempted mid-wave (tick 9 of the chunked wave
    leaves a slot mid-prefill) resumes its own snapshot with its graphs
    captured — no new capture for the keys it holds, every buffer in its
    storage — and a fresh graphed engine resumes the same snapshot: both
    finish with the uninterrupted eager engine's streams."""
    cfg, anchor = cpu_anchor
    prompts = _prompts(cfg.vocab, *WAVES[0])
    want = [r.out_tokens for r in _engine(cfg, anchor, **CONFIGS[name])
            .generate(_requests(prompts), fmt_override="mxint8")]
    graphed = _graphed(_engine(cfg, anchor, **CONFIGS[name]))
    graphed.generate(_requests(prompts), fmt_override="mxint8")
    ptrs = [t.data_ptr() for t in _cache_tensors(graphed._cache)
            + [graphed._cache_len, graphed._tokens]]
    keys = set(graphed._graphs._entries)
    captures = graphed._graphs.captures
    graphed._fault_injector = FaultInjector(preempt_at=preempt_at)
    cut = graphed.generate(_requests(prompts), fmt_override="mxint8",
                           guard=PreemptionGuard(),
                           snapshot_dir=str(tmp_path))
    assert not all(r.done for r in cut)
    if name == "paged-chunk-mixed":
        _, manifest = ckpt_io.restore(str(tmp_path))
        assert manifest["meta"]["filling"] is not None   # mid-prefill
    graphed._fault_injector = None
    got = [r.out_tokens for r in graphed.resume(str(tmp_path))]
    assert got == want
    assert set(graphed._graphs._entries) == keys
    assert graphed._graphs.captures == captures
    assert [t.data_ptr() for t in _cache_tensors(graphed._cache)
            + [graphed._cache_len, graphed._tokens]] == ptrs
    fresh = _graphed(_engine(cfg, anchor, **CONFIGS[name]))
    assert [r.out_tokens for r in fresh.resume(str(tmp_path))] == want
    st = fresh.stats()
    assert st["resumes"] == 1 and st["graph_replays"] > 0
    assert st["kv_pages_alloc"] == st["kv_pages_freed"]


# ---------------------------------------------------------------------------
# The switch
# ---------------------------------------------------------------------------
def test_cuda_graphs_on_the_cpu_is_refused(cpu_anchor):
    cfg, anchor = cpu_anchor
    with pytest.raises(ValueError, match="cuda_graphs=True needs a CUDA"):
        _engine(cfg, anchor, cuda_graphs=True)
    assert _engine(cfg, anchor).stats()["cuda_graphs"] is False
    assert _engine(cfg, anchor, cuda_graphs=False).stats()["cuda_graphs"] \
        is False


# ---------------------------------------------------------------------------
# On the card: CUDA graphs against eager launches
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def card_anchor():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ticks run as CUDA graphs only "
                    "there (the stand-in cases above hold the graph path's "
                    "logic on the CPU)")
    cfg = get_reduced("qwen3-4b")
    params = init_params(cfg, 0, device="cuda")
    return cfg, make_anchor(params, QATConfig(anchor="mxint8"),
                            device="cuda")


def _card_wave(eng, cfg, seed, lens, fmt):
    mx_matmul.reset_launches()
    pa.reset_launches()
    reqs = eng.generate(_requests(_prompts(cfg.vocab, seed, lens)),
                        fmt_override=fmt)
    torch.cuda.synchronize()
    st = eng.stats()
    return ([r.out_tokens for r in reqs], [r.status for r in reqs],
            _trace(eng.tick_trace), st["kernel_launches"],
            [(e["tick"], e["from"], e["to"])
             for e in st["escalation_events"]])


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["mxint8", "mxint4"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_graph_and_eager_engines_agree_on_the_card(card_anchor, name, fmt):
    cfg, anchor = card_anchor
    runs = {}
    for graphs in (False, True):
        eng = _engine(cfg, anchor, device="cuda", cuda_graphs=graphs,
                      **CONFIGS[name])
        runs[graphs] = _card_wave(eng, cfg, *WAVES[0], fmt)
        st = eng.stats()
        assert st["cuda_graphs"] is graphs
        if graphs:
            assert st["graph_captures"] + st["graph_replays"] == st["ticks"]
            assert st["graph_replays"] > st["graph_captures"] >= 1
        else:
            assert st["graph_captures"] == st["graph_replays"] == 0
    assert runs[True] == runs[False]
    assert sum(runs[True][3].values()) > 0


@pytest.mark.gpu
def test_poisoned_wave_escalates_once_under_graphs_on_the_card(card_anchor):
    cfg, anchor = card_anchor
    runs = {}
    for graphs in (False, True):
        eng = _engine(cfg, anchor, device="cuda", cuda_graphs=graphs,
                      fault_injector=FaultInjector(poison_logits={2: 0}),
                      **CONFIGS["paged-chunk-mixed"])
        runs[graphs] = _card_wave(eng, cfg, *WAVES[0], "mxint4")
    assert runs[True] == runs[False]
    assert runs[True][4] == [(2, "mxint4", "mxint6")]
    assert all(s is RequestStatus.COMPLETED for s in runs[True][1])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dense-monolithic", "paged-chunk-mixed"])
def test_sampled_graph_and_eager_engines_agree_on_the_card(card_anchor,
                                                           name):
    cfg, anchor = card_anchor
    runs = {}
    for graphs in (False, True):
        eng = _engine(cfg, anchor, device="cuda", cuda_graphs=graphs,
                      **SAMPLED, **CONFIGS[name])
        for seed, lens in WAVES:
            reqs = eng.generate(_sampled_requests(
                _prompts(cfg.vocab, seed, lens)), greedy=False,
                fmt_override="mxint4")
        torch.cuda.synchronize()
        st = eng.stats()
        runs[graphs] = ([r.out_tokens for r in reqs],
                        [r.status for r in reqs], _trace(eng.tick_trace),
                        eng._keys.cpu().tolist())
        assert st["draw_graph_captures"] == (1 if graphs else 0)
    assert runs[True] == runs[False]


@pytest.mark.gpu
def test_chaos_wave_graph_and_eager_agree_on_the_card(card_anchor):
    cfg, anchor = card_anchor
    runs = {}
    for graphs in (False, True):
        eng = _engine(cfg, anchor, device="cuda", cuda_graphs=graphs,
                      fault_injector=FaultInjector(**CHAOS_PLAN), **CHAOS)
        reqs = eng.generate(_requests(_prompts(cfg.vocab, *WAVES[0])),
                            fmt_override="mxint4")
        st = eng.stats()
        runs[graphs] = ([r.out_tokens for r in reqs],
                        [r.status for r in reqs], _trace(eng.tick_trace),
                        st["escalation_events"])
        assert st["kv_pages_alloc"] == st["kv_pages_freed"]
    assert runs[True] == runs[False]
    assert runs[True][1][3] is RequestStatus.CANCELLED


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dense-monolithic", "paged-chunk-mixed"])
def test_a_second_wave_replays_without_capturing_on_the_card(card_anchor,
                                                             name):
    cfg, anchor = card_anchor
    eng = _engine(cfg, anchor, device="cuda", **CONFIGS[name])
    first = _card_wave(eng, cfg, *WAVES[0], "mxint8")
    st = eng.stats()
    again = _card_wave(eng, cfg, *WAVES[0], "mxint8")
    st2 = eng.stats()
    assert again == first
    assert st2["graph_captures"] == st["graph_captures"] >= 1
    assert st2["graph_replays"] - st["graph_replays"] == \
        st2["ticks"] - st["ticks"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dense-monolithic", "paged-monolithic"])
def test_speculative_graph_and_eager_engines_agree_on_the_card(card_anchor,
                                                               name):
    """Pinned mxint8, drafting at mxint4: the graph engine's streams,
    traces and spec counters equal the eager engine's, and pages
    balance."""
    cfg, anchor = card_anchor
    runs = {}
    for graphs in (False, True):
        eng = _engine(cfg, anchor, device="cuda", cuda_graphs=graphs,
                      speculative=SPEC, **CONFIGS[name])
        wave = _card_wave(eng, cfg, *WAVES[0], "mxint8")
        st = eng.stats()
        runs[graphs] = (wave[:3], [(t["draft_execs"], t["verify_execs"])
                                   for t in eng.tick_trace],
                        [st[k] for k in ("spec_ticks", "spec_accepted",
                                         "spec_rejected")])
        assert st["kv_pages_alloc"] == st["kv_pages_freed"]
        assert st["spec_ticks"] > 0
    assert runs[True] == runs[False]


@pytest.mark.gpu
def test_resume_on_the_card(card_anchor, tmp_path):
    """A paged graph engine runs a wave, then the same wave preempted
    mid-prefill: a fresh graph engine's resume, and the original engine's
    (every key captured by the first wave: no new capture), finish with
    the uninterrupted graph wave's streams."""
    cfg, anchor = card_anchor
    kw = dict(device="cuda", **CONFIGS["paged-chunk-mixed"])
    prompts = _prompts(cfg.vocab, *WAVES[0])
    eng = _engine(cfg, anchor, **kw)
    want = [r.out_tokens for r in eng.generate(_requests(prompts),
                                               fmt_override="mxint8")]
    eng._fault_injector = FaultInjector(preempt_at=9)
    cut = eng.generate(_requests(prompts), fmt_override="mxint8",
                       guard=PreemptionGuard(), snapshot_dir=str(tmp_path))
    assert not all(r.done for r in cut)
    fresh = _engine(cfg, anchor, **kw)
    assert [r.out_tokens for r in fresh.resume(str(tmp_path))] == want
    captures = eng.stats()["graph_captures"]
    eng._fault_injector = None
    assert [r.out_tokens for r in eng.resume(str(tmp_path))] == want
    st = eng.stats()
    assert st["graph_captures"] == captures
    assert st["kv_pages_alloc"] == st["kv_pages_freed"]
