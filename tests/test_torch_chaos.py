"""The port's per-request failure model against the JAX engine's.

The setting is the reference's chaos suite (``tests/test_chaos.py``): a
reduced smollm-135m, an MXINT8 anchor trained for mxint4/6/8 at block size
32, two slots, the paged layout with pages of 8 tokens. The JAX package
writes the anchor; the JAX ``ElasticEngine`` and the port's
(``device="cpu"``) serve the same requests under the same ``FaultInjector``
plan — step crashes and their retry budget, NaN-filled pool pages, failed
page allocations, deadlines and cancellations, a ``random_plan`` storm —
and must agree on every request's status, error (up to the measured times
a deadline error quotes), token stream and format, the injector's events,
the counters, the failures, the tick trace and the page accounting.
"""
import re

import jax
import numpy as np
import pytest

from repro.checkpoint.anchor_ckpt import save_anchor as jsave
from repro.configs import get_reduced as jreduced
from repro.core.anchor import make_anchor as jmake
from repro.core.qat import QATConfig as JQAT
from repro.models import get_model as jget_model
from repro.runtime.fault import FaultInjector as JFault
from repro.runtime.fault import InjectedFault as JInjectedFault
from repro.runtime.fault import random_plan as jrandom_plan
from repro.serve.engine import ElasticEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch.checkpoint.anchor_ckpt import load_anchor
from repro_torch.configs import get_reduced
from repro_torch.models.transformer import make_model
from repro_torch.runtime.fault import FaultInjector, InjectedFault, random_plan
from repro_torch.serve.engine import ElasticEngine, Request, RequestStatus

PS = 8
KEYS = ("faults_detected", "fmt_escalations", "ticks_replayed",
        "quarantined_formats", "request_statuses", "kv_pages_alloc",
        "kv_pages_freed", "kv_pages_hwm", "tokens_out", "ticks",
        "admission_requeues", "escalation_events")


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


def _prompts(vocab, n, plen=8, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, plen).astype(np.int32) for _ in range(n)]


def _engines(served, plan, **kw):
    api, params, janchor, anchor = served
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("kv_layout", "paged")
    if kw["kv_layout"] == "paged":
        kw.setdefault("kv_page_size", PS)
        kw.setdefault("attn_impl", "gather")
    jfi = plan if isinstance(plan, JFault) else JFault(**plan)
    fi = FaultInjector(**{f: getattr(jfi, f) for f in (
        "poison_logits", "poison_fmt", "fail_allocs", "raise_in_step",
        "poison_pool", "cancel_at")})
    jeng = JEngine(api, janchor, param_template=params, fault_injector=jfi,
                   **kw)
    eng = ElasticEngine(make_model(get_reduced("smollm-135m")), anchor,
                        fault_injector=fi, device="cpu", **kw)
    return jeng, jfi, eng, fi


def _serve(served, prompts, max_new, plan, fmt="mxint8", setup=None, **kw):
    """The same requests and plan through both engines; ``setup(reqs)``
    edits each side's requests first (deadlines, cancellations)."""
    jeng, jfi, eng, fi = _engines(served, plan, **kw)
    want = [JRequest(i, p, max_new) for i, p in enumerate(prompts)]
    got = [Request(i, p, max_new) for i, p in enumerate(prompts)]
    if setup is not None:
        setup(want)
        setup(got)
    jeng.generate(want, fmt_override=fmt)
    eng.generate(got, fmt_override=fmt)
    return jeng, jfi, want, eng, fi, got


def _untimed(err):
    return None if err is None else re.sub(r"\d+\.\d{3}s", "<t>s", err)


def _agree(jeng, jfi, want, eng, fi, got):
    """Everything the failure model decides is the JAX engine's; returns
    the port's stats."""
    js, st = jeng.stats, eng.stats()
    assert [r.status.value for r in got] == [r.status.value for r in want]
    assert [_untimed(r.error) for r in got] == \
        [_untimed(r.error) for r in want]
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert [r.fmt_used for r in got] == [r.fmt_used for r in want]
    assert fi.events == jfi.events
    for key in KEYS:
        assert st[key] == js[key], key
    assert [(f["rid"], f["status"], _untimed(f["error"]))
            for f in st["failures"]] == \
        [(f["rid"], f["status"], _untimed(f["error"]))
         for f in js["failures"]]
    assert [(t["prefill_tokens"], t["decode"], t["execs"])
            for t in eng.tick_trace] == \
        [(t["prefill_tokens"], t["decode"], t["execs"])
         for t in jeng.tick_trace]
    for r in got:
        assert r.done and r.status.terminal, (r.rid, r.status)
        assert (r.error is None) == (r.status is RequestStatus.COMPLETED)
    assert st["kv_pages_alloc"] == st["kv_pages_freed"]       # no page leak
    return st


def _clean(served, prompts, max_new, **kw):
    out = _serve(served, prompts, max_new, {}, **kw)
    _agree(*out)
    return [r.out_tokens for r in out[5]]


# ---- step crashes -----------------------------------------------------------
@pytest.mark.parametrize("chunk", [None, PS], ids=["monolithic", "mixed"])
def test_transient_step_crash_retries_at_the_same_format(served, chunk):
    vocab = served[0].cfg.vocab
    base = _clean(served, _prompts(vocab, 3), 5, prefill_chunk=chunk)
    out = _serve(served, _prompts(vocab, 3), 5,
                 dict(raise_in_step=(1, 3)), prefill_chunk=chunk)
    st = _agree(*out)
    assert [r.out_tokens for r in out[5]] == base
    assert all(r.status is RequestStatus.COMPLETED for r in out[5])
    assert st["ticks_replayed"] >= 2 and st["fmt_escalations"] == 0


def test_step_crash_beyond_the_retry_budget_escapes(served):
    jeng, jfi, eng, fi = _engines(served, dict(raise_in_step=(2,)),
                                  max_step_retries=0)
    prompts = _prompts(served[0].cfg.vocab, 2)
    with pytest.raises(JInjectedFault):
        jeng.generate([JRequest(i, p, 5) for i, p in enumerate(prompts)],
                      fmt_override="mxint8")
    with pytest.raises(InjectedFault, match="tick 2"):
        eng.generate([Request(i, p, 5) for i, p in enumerate(prompts)],
                     fmt_override="mxint8")
    assert isinstance(InjectedFault("x"), RuntimeError)
    assert fi.events == jfi.events
    assert eng.stats()["faults_detected"] == jeng.stats["faults_detected"]
    # the engine serves the next wave from a clean state
    reqs = eng.generate([Request(i, p, 5) for i, p in enumerate(prompts)],
                        fmt_override="mxint8")
    assert all(r.status is RequestStatus.COMPLETED for r in reqs)


# ---- injected pool corruption ---------------------------------------------
@pytest.mark.parametrize("attn_impl", ["gather", "paged_kernel"])
def test_pool_poison_of_an_unmapped_page_is_harmless(served, attn_impl):
    vocab = served[0].cfg.vocab
    base = _clean(served, _prompts(vocab, 3), 5)
    last = ElasticEngine(make_model(get_reduced("smollm-135m")), served[3],
                         batch_slots=2, max_len=32, kv_layout="paged",
                         kv_page_size=PS, device="cpu"
                         ).stats()["kv_total_pages"] - 1
    out = _serve(served, _prompts(vocab, 3), 5, dict(poison_pool={1: last}),
                 attn_impl=attn_impl)
    _agree(*out)
    assert [r.out_tokens for r in out[5]] == base
    assert all(r.status is RequestStatus.COMPLETED for r in out[5])


@pytest.mark.parametrize("attn_impl", ["gather", "paged_kernel"])
def test_pool_poison_of_a_live_page_retires_its_row(served, attn_impl):
    """Page 1 is slot 0's prompt page. Through the gather path a replay
    reads its NaN again, so at the anchor that row retires FAILED_NUMERIC;
    the page goes back to the free list, and rid 2, which maps it next,
    reads NaN left at positions past its frontier (0 * NaN in P.V, in
    both packages). The paged kernel's plain version, like the reference
    kernel it mirrors, ends a row whose live positions hold NaN as zeros
    (``l > 0`` is false for NaN): nothing reaches the logits."""
    vocab = served[0].cfg.vocab
    base = _clean(served, _prompts(vocab, 3), 5)
    out = _serve(served, _prompts(vocab, 3), 5, dict(poison_pool={2: 1}),
                 attn_impl=attn_impl)
    _agree(*out)
    got = out[5]
    want = RequestStatus.FAILED_NUMERIC if attn_impl == "gather" \
        else RequestStatus.COMPLETED
    assert got[0].status is want
    assert got[1].status is RequestStatus.COMPLETED
    assert got[1].out_tokens == base[1]


def test_pool_poison_escalates_before_it_retires(served):
    """At mxint4 a live poisoned page climbs the ladder first (a replay
    reads the NaN again at every rung), then retires its row at the
    anchor; the other row completes at the anchor."""
    out = _serve(served, _prompts(served[0].cfg.vocab, 3), 5,
                 dict(poison_pool={2: 3}), fmt="mxint4")
    st = _agree(*out)
    assert [e["to"] for e in st["escalation_events"]] == ["mxint6", "mxint8"]
    assert out[5][1].status is RequestStatus.FAILED_NUMERIC
    assert out[5][0].status is RequestStatus.COMPLETED


# ---- capacity faults -------------------------------------------------------
@pytest.mark.parametrize("call", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("chunk", [None, PS], ids=["monolithic", "chunked"])
def test_injected_allocation_failure_takes_the_real_paths(served, call,
                                                          chunk):
    """Call 0 is the first admission's allocation; later calls land on
    other admissions, chunks and decode-page mappings (12 new tokens cross
    a page), whichever path each takes: requeue, or a victim's
    FAILED_CAPACITY."""
    out = _serve(served, _prompts(served[0].cfg.vocab, 3), 12,
                 dict(fail_allocs=(call,)), prefill_chunk=chunk)
    st = _agree(*out)
    assert out[4].events == [{"kind": "fail_alloc", "call": call}]
    if call == 0:
        assert st["admission_requeues"] >= 1
        assert all(r.status is RequestStatus.COMPLETED for r in out[5])


# ---- deadlines and cancellation ---------------------------------------------
def test_deadline_and_cancel_are_per_request(served):
    vocab = served[0].cfg.vocab
    base = _clean(served, _prompts(vocab, 3), 5)

    def setup(reqs):
        reqs[1].deadline_s = 0.0

    out = _serve(served, _prompts(vocab, 3), 5, dict(cancel_at={0: 2}),
                 setup=setup)
    st = _agree(*out)
    got = out[5]
    assert got[0].status is RequestStatus.COMPLETED
    assert got[0].out_tokens == base[0]
    assert got[1].status is RequestStatus.TIMED_OUT
    assert "deadline" in got[1].error
    assert got[2].status is RequestStatus.CANCELLED
    assert st["request_statuses"] == {"completed": 1, "timed_out": 1,
                                      "cancelled": 1}


def test_client_cancel_before_the_wave(served):
    out = _serve(served, _prompts(served[0].cfg.vocab, 2), 5, {},
                 setup=lambda reqs: reqs[0].cancel())
    _agree(*out)
    assert out[5][0].status is RequestStatus.CANCELLED
    assert out[5][0].out_tokens == []
    assert out[5][1].status is RequestStatus.COMPLETED


@pytest.mark.parametrize("tick,kw", [
    (3, {}),                                            # decoding
    (3, dict(prefill_chunk=PS)),                        # decoding, mixed
    (1, dict(prefill_chunk=PS, batch_slots=1)),         # mid-prefill
    (2, dict(prefill_chunk=PS, scheduler="sequential")),
], ids=["decoding", "decoding-mixed", "mid-prefill", "sequential"])
def test_cancel_mid_flight_frees_its_pages(served, tick, kw):
    rng = np.random.default_rng(3)
    vocab = served[0].cfg.vocab
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in (20, 8, 13)]
    out = _serve(served, prompts, 6, dict(cancel_at={tick: 0}), **kw)
    _agree(*out)
    got = out[5]
    assert got[0].status is RequestStatus.CANCELLED
    assert got[0].error == "cancelled by client"
    assert all(r.status is RequestStatus.COMPLETED for r in got[1:])


# ---- chaos storm ------------------------------------------------------------
def test_random_plan_is_the_references():
    for seed in (0, 13):
        got = random_plan(seed=seed, rate=0.3, horizon=30, slots=2,
                          kinds=("poison_row", "poison_all", "raise_step",
                                 "fail_alloc"))
        want = jrandom_plan(seed=seed, rate=0.3, horizon=30, slots=2,
                            kinds=("poison_row", "poison_all", "raise_step",
                                   "fail_alloc"))
        for f in ("poison_logits", "raise_in_step", "fail_allocs"):
            assert getattr(got, f) == getattr(want, f), f
    with pytest.raises(ValueError, match="unknown chaos kind"):
        random_plan(seed=0, rate=1.0, horizon=1, slots=2, kinds=("bogus",))


@pytest.mark.parametrize("kw", [{}, dict(prefill_chunk=PS)],
                         ids=["monolithic", "mixed"])
def test_seeded_chaos_storm_matches_the_reference(served, kw):
    plan = jrandom_plan(seed=13, rate=0.25, horizon=40, slots=2,
                        kinds=("poison_row", "raise_step", "fail_alloc"))
    out = _serve(served, _prompts(served[0].cfg.vocab, 8), 6, plan, **kw)
    st = _agree(*out)
    assert sum(st["request_statuses"].values()) == 8
    assert len(st["failures"]) == sum(
        r.status is not RequestStatus.COMPLETED for r in out[5])
    assert out[4].events                                # faults fired
