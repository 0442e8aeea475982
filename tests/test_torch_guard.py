"""The port's logit guard against the JAX engine's, on one anchor checkpoint.

The setting is the reference's chaos suite (``tests/test_chaos.py``): a
reduced smollm-135m, an MXINT8 anchor trained for mxint4/6/8 at block size
32, two slots, the paged layout with pages of 8 tokens. The JAX package
writes the anchor; the JAX ``ElasticEngine`` and the port's
(``device="cpu"``) serve the same requests with the same ``FaultInjector``
plan, and must agree on everything the guard decides: every request's
status, error text and token stream, the escalation events, the quarantine,
the counters, the failures, the tick trace and the page accounting.
"""
import jax
import numpy as np
import pytest

from repro.checkpoint.anchor_ckpt import save_anchor as jsave
from repro.configs import get_reduced as jreduced
from repro.core.anchor import make_anchor as jmake
from repro.core.qat import QATConfig as JQAT
from repro.models import get_model as jget_model
from repro.runtime.fault import FaultInjector as JFault
from repro.serve.engine import ElasticEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch.checkpoint.anchor_ckpt import load_anchor
from repro_torch.configs import get_reduced
from repro_torch.models.transformer import make_model
from repro_torch.runtime.fault import FaultInjector
from repro_torch.serve.engine import ElasticEngine, Request, RequestStatus

PS = 8
GUARD_KEYS = ("faults_detected", "fmt_escalations", "ticks_replayed",
              "quarantined_formats", "request_statuses", "kv_pages_alloc",
              "kv_pages_freed", "kv_pages_hwm", "tokens_out")


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


def _pair(served, prompts, max_new, fmt, plan, **kw):
    """The same requests and fault plan through both engines."""
    api, params, janchor, anchor = served
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("kv_layout", "paged")
    if kw["kv_layout"] == "paged":
        kw.setdefault("kv_page_size", PS)
        kw.setdefault("attn_impl", "gather")
    jeng = JEngine(api, janchor, param_template=params,
                   fault_injector=JFault(**plan), **kw)
    want = jeng.generate([JRequest(i, p, max_new)
                          for i, p in enumerate(prompts)], fmt_override=fmt)
    eng = ElasticEngine(make_model(get_reduced("smollm-135m")), anchor,
                        fault_injector=FaultInjector(**plan), device="cpu",
                        **kw)
    got = eng.generate([Request(i, p, max_new)
                        for i, p in enumerate(prompts)], fmt_override=fmt)
    return jeng, want, eng, got


def _agree(jeng, want, eng, got):
    """Everything the guard decides is the JAX engine's; returns the port's
    stats."""
    js, st = jeng.stats, eng.stats()
    assert [r.status.value for r in got] == [r.status.value for r in want]
    assert [r.error for r in got] == [r.error for r in want]
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert [r.fmt_used for r in got] == [r.fmt_used for r in want]
    for key in GUARD_KEYS:
        assert st[key] == js[key], key
    assert st["escalation_events"] == js["escalation_events"]
    assert [(f["rid"], f["status"], f["error"]) for f in st["failures"]] \
        == [(f["rid"], f["status"], f["error"]) for f in js["failures"]]
    assert [(t["prefill_tokens"], t["decode"], t["execs"])
            for t in eng.tick_trace] == \
        [(t["prefill_tokens"], t["decode"], t["execs"])
         for t in jeng.tick_trace]
    assert st["kv_pages_alloc"] == st["kv_pages_freed"]       # no page leak
    assert all(r.done for r in got)
    return st


def test_row_poison_at_the_anchor_retires_that_request(served):
    cfg = served[0].cfg
    out = _pair(served, _prompts(cfg.vocab, 3), 5, "mxint8",
                dict(poison_logits={2: 0}))
    st = _agree(*out)
    got = out[3]
    assert got[0].status is RequestStatus.FAILED_NUMERIC
    assert "anchor rung" in got[0].error
    assert st["request_statuses"]["failed_numeric"] == 1
    assert [f["rid"] for f in st["failures"]] == [0]


def test_bad_rung_escalates_and_is_quarantined(served):
    cfg = served[0].cfg
    out = _pair(served, _prompts(cfg.vocab, 3), 5, "mxint4",
                dict(poison_logits={2: None}, poison_fmt="mxint4"))
    st = _agree(*out)
    assert all(r.status is RequestStatus.COMPLETED for r in out[3])
    assert [(e["tick"], e["from"], e["to"])
            for e in st["escalation_events"]] == [(2, "mxint4", "mxint6")]
    assert st["quarantined_formats"] == ["mxint4"]
    assert st["ticks_replayed"] == 1
    assert out[2].policy.pick(queue_depth=64) != "mxint4"


def test_double_escalation_reaches_the_anchor(served):
    cfg = served[0].cfg
    out = _pair(served, _prompts(cfg.vocab, 3), 5, "mxint4",
                dict(poison_logits={2: None},
                     poison_fmt=("mxint4", "mxint6")))
    st = _agree(*out)
    assert all(r.status is RequestStatus.COMPLETED for r in out[3])
    assert [e["to"] for e in st["escalation_events"]] == ["mxint6", "mxint8"]
    assert st["quarantined_formats"] == ["mxint4", "mxint6"]
    assert out[3][0].fmt_used == "mxint8"


def test_exhausted_escalation_retires_rows_not_the_wave(served):
    cfg = served[0].cfg
    out = _pair(served, _prompts(cfg.vocab, 3), 5, "mxint8",
                dict(poison_logits={2: None}, poison_fmt="mxint8"))
    st = _agree(*out)
    assert [r.status for r in out[3]] == [RequestStatus.FAILED_NUMERIC] * 2 \
        + [RequestStatus.COMPLETED]
    assert st["fmt_escalations"] == 0


@pytest.mark.parametrize("scheduler", ["sequential", "mixed"])
def test_final_chunk_poison_at_the_anchor_fails_that_admission(served,
                                                               scheduler):
    cfg = served[0].cfg
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, 20).astype(np.int32),
               rng.integers(0, cfg.vocab, 8).astype(np.int32)]
    out = _pair(served, prompts, 3, "mxint8",
                dict(poison_logits={2: None}, poison_fmt="mxint8"),
                batch_slots=1, prefill_chunk=PS, scheduler=scheduler)
    _agree(*out)
    got = out[3]
    assert got[0].status is RequestStatus.FAILED_NUMERIC
    assert "final chunk" in got[0].error and got[0].out_tokens == []
    assert got[1].status is RequestStatus.COMPLETED


def test_mixed_scheduler_survives_a_row_poison(served):
    """The mixed tick (through the paged-attention kernels' plain versions
    in the port, the Pallas kernels in interpret mode in JAX) with a row
    poisoned at the anchor."""
    cfg = served[0].cfg
    out = _pair(served, _prompts(cfg.vocab, 3), 6, "mxint8",
                dict(poison_logits={4: 0}), prefill_chunk=PS,
                attn_impl="paged_kernel")
    _agree(*out)
    assert any(r.status is RequestStatus.FAILED_NUMERIC for r in out[3])
    assert sum(t["decode"] and t["prefill_chunks"]
               for t in out[2].tick_trace) > 0          # mixed ticks ran


@pytest.mark.parametrize("plan", [
    dict(poison_logits={2: 0}, poison_fmt="mxint4"),   # escalates
    dict(poison_logits={3: 1}),                        # retires one row
], ids=["escalates", "retires"])
def test_dense_layout_guard(served, plan):
    cfg = served[0].cfg
    fmt = "mxint4" if plan.get("poison_fmt") else "mxint8"
    out = _pair(served, _prompts(cfg.vocab, 3), 5, fmt, plan,
                kv_layout="dense")
    st = _agree(*out)
    assert st["faults_detected"] == 1
