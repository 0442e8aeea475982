"""The port's self-speculative decoding against the JAX engine's.

The setting is the reference's speculative suite
(``tests/test_speculative.py``): a reduced smollm-135m, an MXINT8 anchor
trained for mxint4/6/8 at block size 32, two slots, max_len 32, the paged
layout with pages of 8 tokens. The JAX package writes the anchor; the JAX
``ElasticEngine`` and the port's (``device="cpu"``, where B1/B2/B4 run
their plain versions) serve the same requests with
``speculative=SpecConfig(...)``. On every configuration the port's streams
must equal the JAX spec engine's and the port's own plain streams, and its
tick trace (with the draft / verify split), ``spec_*`` counters, page and
attention-read accounting must equal JAX's. ``verify_step``'s logits, the
acceptance rule, the policy's veto and the page rewind are held against
the reference functions directly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.anchor_ckpt import save_anchor as jsave
from repro.configs import get_reduced as jreduced
from repro.core.anchor import make_anchor as jmake
from repro.core.qat import QATConfig as JQAT
from repro.models import get_model as jget_model
from repro.models.common import spec_accept_counts as jaccept
from repro.runtime.fault import FaultInjector as JFault
from repro.serve.engine import ElasticEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve.packed_params import make_packed_params as jpacked
from repro.serve.packed_params import make_packed_verify_step
from repro.serve.policy import FormatPolicy as JPolicy
from repro.serve.policy import SpecConfig as JSpec
from repro_torch.checkpoint.anchor_ckpt import load_anchor
from repro_torch.configs import get_reduced
from repro_torch.kernels.dispatch import make_qmm
from repro_torch.models.common import spec_accept_counts
from repro_torch.models.transformer import make_model
from repro_torch.runtime.fault import FaultInjector
from repro_torch.serve.engine import ElasticEngine, Request, RequestStatus
from repro_torch.serve.packed_params import make_packed_params
from repro_torch.serve.policy import FormatPolicy, SpecConfig

PS = 8
SPEC = dict(draft_fmt="mxint4", k=4)
COUNTERS = ("spec_ticks", "spec_accepted", "spec_rejected", "spec_aborts",
            "spec_acceptance_rate", "speculative", "ticks", "tokens_out",
            "kv_pages_alloc", "kv_pages_freed", "kv_pages_hwm",
            "attn_tokens_read", "faults_detected", "fmt_escalations",
            "ticks_replayed", "quarantined_formats", "escalation_events",
            "request_statuses")
# a draft rung that is NaN at every tick (the adversarial acceptance ~ 0)
POISONED_DRAFTS = dict(poison_logits={t: None for t in range(256)},
                       poison_fmt="mxint4")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    api = jget_model(jreduced("smollm-135m"))
    params = jax.jit(api.init_params)(jax.random.PRNGKey(0))
    qat = JQAT(formats=("mxint4", "mxint6", "mxint8"), anchor="mxint8",
               block_size=32)
    anchor = jax.jit(lambda p: jmake(p, qat))(params)
    path = str(tmp_path_factory.mktemp("anchor") / "anchor")
    jsave(path, anchor)
    return api, params, anchor, load_anchor(path, device="cpu")


def _kw(kw):
    kw = dict(kw)
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("kv_layout", "paged")
    if kw["kv_layout"] == "paged":
        kw.setdefault("kv_page_size", PS)
        kw.setdefault("attn_impl", "gather")    # the JAX engine's on a CPU
    kw.setdefault("fused", False)
    return kw


def _port(served, spec=None, plan=None, **kw):
    return ElasticEngine(
        make_model(get_reduced("smollm-135m")), served[3], device="cpu",
        speculative=None if spec is None else SpecConfig(**spec),
        fault_injector=None if plan is None else FaultInjector(**plan),
        **_kw(kw))


def _jax(served, spec=None, plan=None, **kw):
    api, params, anchor, _ = served
    return JEngine(api, anchor, param_template=params,
                   speculative=None if spec is None else JSpec(**spec),
                   fault_injector=None if plan is None else JFault(**plan),
                   **_kw(kw))


def _prompts(vocab, n, plen=8, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=plen).astype(np.int32)
            for _ in range(n)]


def _trace(tick_trace):
    return [(t["prefill_tokens"], t["decode"], t["execs"],
             t["draft_execs"], t["verify_execs"]) for t in tick_trace]


def _serve(served, spec, *, n=3, max_new=6, fmt="mxint8", plan=None,
           seed=7, **kw):
    """The same requests through the JAX engine and the port's; both
    must agree on everything speculation decides. Returns (port engine,
    port streams)."""
    prompts = _prompts(served[0].cfg.vocab, n, seed=seed)
    jeng = _jax(served, spec, plan, **kw)
    want = jeng.generate([JRequest(i, p, max_new)
                          for i, p in enumerate(prompts)],
                         fmt_override=fmt)
    eng = _port(served, spec, plan, **kw)
    got = eng.generate([Request(i, p, max_new)
                        for i, p in enumerate(prompts)], fmt_override=fmt)
    streams = [r.out_tokens for r in got]
    assert streams == [r.out_tokens for r in want]
    assert [r.status.value for r in got] == [r.status.value for r in want]
    assert _trace(eng.tick_trace) == _trace(jeng.tick_trace)
    st, js = eng.stats(), jeng.stats
    for key in COUNTERS:
        assert st[key] == js[key], key
    assert st["kv_pages_alloc"] == st["kv_pages_freed"]       # no page leak
    return eng, streams


def _plain(served, *, n=3, max_new=6, fmt="mxint8", seed=7, **kw):
    eng = _port(served, **kw)
    reqs = eng.generate([Request(i, p, max_new) for i, p in enumerate(
        _prompts(served[0].cfg.vocab, n, seed=seed))], fmt_override=fmt)
    return eng, [r.out_tokens for r in reqs]


# ---- streams: the JAX spec engine's, and plain decode's ---------------------
@pytest.mark.parametrize("kw", [
    dict(fused=False, attn_impl="gather"),
    dict(fused=True, attn_impl="paged_kernel"),
    dict(kv_layout="dense"),
    dict(prefill_chunk=8, scheduler="mixed", attn_impl="paged_kernel",
         kv_num_pages=4 * 7 + 1),
], ids=["densify-gather", "fused-paged_kernel", "dense", "mixed"])
def test_spec_streams_equal_jax_and_plain(served, kw):
    eng, spec = _serve(served, SPEC, **kw)
    _, plain = _plain(served, **kw)
    assert spec == plain
    st = eng.stats()
    assert st["spec_ticks"] > 0
    assert st["speculative"] == {"draft_fmt": "mxint4", "k": 4,
                                 "min_acceptance": 0.0, "window": 16}
    for t in eng.tick_trace:
        if t["prefill_chunks"] and "prefill_chunk" in kw:
            assert t["draft_execs"] == 0        # chunk ticks never draft
        if t["draft_execs"]:
            assert 1 <= t["draft_execs"] <= 4 and t["verify_execs"] >= 1
            # a pure spec tick runs exactly its drafts and verifies
            assert t["execs"] == t["draft_execs"] + t["verify_execs"] \
                + t["prefill_chunks"]


def test_spec_takes_fewer_ticks_when_accepting(served):
    eng_p, plain = _plain(served)
    eng_s, spec = _serve(served, SPEC)
    assert spec == plain
    assert eng_s.stats()["ticks"] < eng_p.stats()["ticks"]
    assert eng_s.stats()["spec_accepted"] > 0
    assert all(t["draft_execs"] == t["verify_execs"] == 0
               for t in eng_p.tick_trace)


def test_poisoned_drafts_with_the_guard_off_keep_the_streams(served):
    """Every draft NaN (guard off, so the garbage flows into the verify):
    acceptance collapses, and the streams are still plain decode's."""
    eng, spec = _serve(served, SPEC, plan=POISONED_DRAFTS, logit_guard=False)
    _, plain = _plain(served, logit_guard=False)
    assert spec == plain
    st = eng.stats()
    assert st["spec_ticks"] > 0 and st["spec_rejected"] > 0
    assert st["spec_acceptance_rate"] < 0.5


def test_policy_disables_speculation_on_low_acceptance(served):
    kw = dict(logit_guard=False, max_new=12, max_len=48)
    spec = dict(draft_fmt="mxint4", k=2, min_acceptance=0.9, window=2)
    eng, streams = _serve(served, spec, plan=POISONED_DRAFTS, **kw)
    _, plain = _plain(served, **kw)
    assert streams == plain
    st = eng.stats()
    assert 2 <= st["spec_ticks"] < st["ticks"]


def test_a_draft_rung_equal_to_the_pinned_format_never_drafts(served):
    eng, spec = _serve(served, dict(draft_fmt="mxint8", k=4))
    assert spec == _plain(served)[1]
    assert eng.stats()["spec_ticks"] == 0


# ---- speculation under the failure model -----------------------------------
def test_verify_poison_escalates_without_a_double_commit(served):
    """A batch-wide NaN on every verify at mxint6: the verify replays at
    mxint8 without re-running the drafts."""
    plan = dict(poison_logits={t: None for t in range(2, 64)},
                poison_fmt="mxint6")
    kw = dict(max_len=48, prefill_chunk=PS, n=2, max_new=8, fmt="mxint6")
    eng, spec = _serve(served, SPEC, plan=plan, **kw)
    _, plain = _serve(served, None, plan=plan, **kw)
    assert spec == plain and all(len(s) == 8 for s in spec)
    replayed = [t for t in eng.tick_trace if t["verify_execs"] >= 2]
    assert len(replayed) == 1 and 1 <= replayed[0]["draft_execs"] <= 4


def test_a_sick_draft_rung_is_quarantined_and_decode_goes_plain(served):
    eng, spec = _serve(served, SPEC, plan=dict(poison_logits={2: None},
                                               poison_fmt="mxint4"),
                       max_len=48, n=2, max_new=16)
    assert spec == _plain(served, max_len=48, n=2, max_new=16)[1]
    st = eng.stats()
    assert "mxint4" in st["quarantined_formats"]
    assert st["spec_aborts"] == 1 and st["fmt_escalations"] == 0
    last = max(i for i, t in enumerate(eng.tick_trace) if t["draft_execs"])
    assert all(t["draft_execs"] == 0 for t in eng.tick_trace[last + 1:])


def test_a_draft_step_crash_abandons_the_burst(served):
    """An injected crash in the first draft step of tick 1 drops the burst;
    the plain tick that follows runs clean."""
    eng, spec = _serve(served, SPEC, plan=dict(raise_in_step=(1,)))
    assert spec == _plain(served)[1]
    assert eng.stats()["spec_aborts"] == 1


def test_page_starvation_gives_the_draft_pages_back(served):
    """A pool too small for the draft-ahead pages: the burst hands them
    back and the tick runs plain; decode starvation then retires the
    largest page-holder, as the JAX engine does."""
    kw = dict(kv_num_pages=6, max_len=48, max_new=12)
    eng, spec = _serve(served, SPEC, **kw)
    assert eng.stats()["spec_aborts"] >= 1
    assert eng.stats()["spec_ticks"] >= 1


# ---- the refusals ------------------------------------------------------------
def _message(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    return str(ei.value)


@pytest.mark.parametrize("what", ["sampled", "k0", "bf16", "family"])
def test_refusals_say_what_the_reference_says(served, what):
    api, params, anchor, port_anchor = served
    if what == "sampled":
        got = _message(lambda: _port(served, SPEC).generate(
            [Request(0, np.arange(4, dtype=np.int32), 2)], greedy=False))
        want = _message(lambda: _jax(served, SPEC).generate(
            [JRequest(0, np.arange(4, dtype=np.int32), 2)], greedy=False))
    elif what == "family":
        cfg = dataclasses.replace(get_reduced("smollm-135m"), family="ssm")
        got = _message(lambda: ElasticEngine(
            make_model(cfg), port_anchor, device="cpu",
            speculative=SpecConfig(**SPEC)))
        want = ("speculative decoding requires a pure-attention text stack; "
                "family 'ssm' cannot rewind recurrent state (or prepends "
                "vision embeds)")
    else:
        spec = dict(draft_fmt="mxint4", k=0) if what == "k0" \
            else dict(draft_fmt="bf16")
        got = _message(lambda: _port(served, spec))
        want = _message(lambda: _jax(served, spec))
    assert got == want


# ---- the pieces against the reference functions ------------------------------
def test_spec_accept_counts_equal_the_reference():
    rng = np.random.default_rng(5)
    for _ in range(200):
        b, k = int(rng.integers(1, 6)), int(rng.integers(1, 6))
        anchor = rng.integers(0, 4, size=(b, k + 1))
        drafts = np.where(rng.random((b, k)) < 0.7, anchor[:, :k],
                          rng.integers(0, 4, size=(b, k)))
        budgets = rng.integers(0, k + 3, size=b)
        np.testing.assert_array_equal(
            spec_accept_counts(drafts, anchor, budgets),
            jaccept(drafts, anchor, budgets))
    with pytest.raises(ValueError):
        spec_accept_counts(np.zeros((2, 3)), np.zeros((2, 3)), [1, 1])


def test_allow_speculation_equals_the_reference():
    cases = [("mxint4", "mxint8", None, 0.0), ("mxint8", "mxint8", None, 0.0),
             ("mxint4", "mxint8", 0.1, 0.5), ("mxint4", "mxint8", None, 0.5),
             ("mxint4", "mxint8", 0.5, 0.5), ("mxint6", "mxint4", 0.9, 0.5)]
    for quarantine in (None, "mxint4"):
        pol, jpol = FormatPolicy("mxint8"), JPolicy("mxint8")
        if quarantine:
            pol.quarantine(quarantine)
            jpol.quarantine(quarantine)
        for case in cases:
            assert pol.allow_speculation(*case) == \
                jpol.allow_speculation(*case), (quarantine, case)
    assert dataclasses.asdict(SpecConfig()) == dataclasses.asdict(JSpec())


@pytest.mark.parametrize("fmt", ["mxint8", "mxint4"])
def test_verify_step_logits_equal_jax(served, fmt):
    """All-positions logits of one paged verify over ragged rows (q_len
    5, 5, and a masked row at 1) through the fused packed contract: the
    port's plain B1/B2/B4 against the reference's interpret-mode kernels,
    on the same seeded page pools."""
    api, params, janchor, anchor = served
    cfg = get_reduced("smollm-135m")
    rng = np.random.default_rng(2)
    c, n_pages = 5, 10
    lens = np.asarray([11, 16, 3], np.int32)
    q_len = np.asarray([c, c, 1], np.int32)
    toks = rng.integers(0, cfg.vocab, size=(3, c)).astype(np.int32)
    bt = np.zeros((3, 4), np.int32)
    bt[:, :3] = rng.permutation(np.arange(1, n_pages)).reshape(3, 3)
    shape = (cfg.n_groups, n_pages, PS, cfg.n_kv_heads, cfg.hd)
    pools = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]

    port = make_model(cfg).with_serving(make_qmm(mode="kernel"),
                                        "paged_kernel")
    cache = port.init_cache(3, 32, device="cpu", kv_layout="paged",
                            page_size=PS, num_pages=n_pages)
    cache["block_table"].copy_(torch.from_numpy(bt))
    for name, pool in zip(("k_pages", "v_pages"), pools):
        cache["blocks"][0][name].copy_(torch.from_numpy(pool))
    got, _ = port.verify_step(
        make_packed_params(anchor, target_fmt=fmt, dtype=cfg.compute_dtype),
        {"tokens": torch.from_numpy(toks), "q_len": torch.from_numpy(q_len)},
        cache, torch.from_numpy(lens))

    jcache = api.init_cache(3, 32, kv_layout="paged", page_size=PS,
                            num_pages=n_pages)
    jcache["block_table"] = jnp.asarray(bt)
    jcache["blocks"][0] = {"k_pages": jnp.asarray(pools[0]),
                           "v_pages": jnp.asarray(pools[1])}
    verify = make_packed_verify_step(api, 32, fused=True,
                                     attn_impl="paged_kernel")
    want, _ = verify(jpacked(janchor, params, target_fmt=fmt,
                             dtype=api.cfg.compute_dtype),
                     {"tokens": jnp.asarray(toks),
                      "q_len": jnp.asarray(q_len)}, jcache,
                     jnp.asarray(lens))
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape == (3, c, cfg.vocab)
    for row, lanes in ((0, c), (1, c), (2, 1)):
        np.testing.assert_allclose(got[row, :lanes], want[row, :lanes],
                                   rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
        np.testing.assert_array_equal(got[row, :lanes].argmax(-1),
                                      want[row, :lanes].argmax(-1))


def _rollback_case(eng, rows, frontier, slot):
    bt = np.array(rows, np.int32)
    before = bt.copy()
    free = []
    freed0 = eng._kv_pages_freed
    eng._rollback_slot_pages(free, bt, slot, frontier)
    keep = -(-frontier // PS)
    drop = [int(p) for p in before[slot, keep:] if p != 0]
    assert sorted(free) == sorted(drop)
    assert eng._kv_pages_freed - freed0 == len(drop)
    assert bt[slot, :keep].tolist() == before[slot, :keep].tolist()
    assert not bt[slot, keep:].any()
    others = [i for i in range(bt.shape[0]) if i != slot]
    assert bt[others].tolist() == before[others].tolist()
    return free


def test_rollback_frees_exactly_the_pages_past_the_frontier(served):
    eng, jeng = _port(served), _jax(served)
    rng = np.random.default_rng(11)
    for _ in range(50):
        nrows, width = int(rng.integers(1, 5)), int(rng.integers(1, 6))
        rows = np.zeros((nrows, width), np.int64)
        for i in range(nrows):
            held = int(rng.integers(0, width + 1))
            rows[i, :held] = rng.choice(np.arange(1, 64), size=held,
                                        replace=False)
        slot = int(rng.integers(0, nrows))
        frontier = int(rng.integers(0, width * PS + 1))
        free = _rollback_case(eng, rows.tolist(), frontier, slot)
        jbt, jfree = np.array(rows, np.int32), []
        jeng._rollback_slot_pages(jfree, jbt, slot, frontier)
        assert free == jfree


def test_free_list_exact_over_seeded_waves(served):
    """Random wave shapes, clean and poisoned drafts: every wave drains
    with alloc == freed, JAX's counters, and plain decode's streams."""
    rng = np.random.default_rng(3)
    for wave in range(3):
        n = int(rng.integers(2, 5))
        max_new = int(rng.integers(3, 10))
        k = int(rng.integers(1, 5))
        seed = int(rng.integers(0, 1 << 16))
        plan = POISONED_DRAFTS if wave % 2 else None
        eng, spec = _serve(served, dict(draft_fmt="mxint4", k=k), plan=plan,
                           n=n, max_new=max_new, seed=seed,
                           logit_guard=False)
        _, plain = _plain(served, n=n, max_new=max_new, seed=seed,
                          logit_guard=False)
        assert spec == plain, (wave, k)
        assert eng.stats()["spec_ticks"] > 0
        assert all(r == RequestStatus.COMPLETED.value
                   for r in eng.stats()["request_statuses"])
