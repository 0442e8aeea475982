"""The port's SLO serving against the JAX engine's (``repro/serve/engine.py``
with ``serve/slo.py``): arrival-gated admission with idle ticks, tiered
admission order, the wave's cost-model pick, the cost model's calibration,
and snapshot / resume of the new request fields.

A reduced smollm-135m, an MXINT8 anchor trained for mxint4/6/8 (written by
the JAX package, loaded by the port), two slots, max_len 48. One wave of
seven requests in three tiers arrives over ticks 0-6 with a burst; under
``"fifo"`` and ``"slo"``, dense and paged-chunked, the port must admit each
request at the JAX engine's tick, end it in the same status with the same
stream, and run the same per-tick work. Timings differ between the packages
and never enter a comparison: the calibration is held by its tick counts
and byte terms, and the cost-model pick is taken before any tick ran.
"""
import jax
import numpy as np
import pytest

from repro.checkpoint import io as jio
from repro.checkpoint.anchor_ckpt import save_anchor as jsave
from repro.configs import get_reduced as jreduced
from repro.core.anchor import make_anchor as jmake
from repro.core.qat import QATConfig as JQAT
from repro.models import get_model as jget_model
from repro.runtime.fault import FaultInjector as JFault
from repro.runtime.fault import PreemptionGuard as JGuard
from repro.serve import slo as jslo
from repro.serve.engine import ElasticEngine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve.policy import FormatPolicy as JPolicy
from repro_torch.checkpoint import io
from repro_torch.checkpoint.anchor_ckpt import load_anchor
from repro_torch.configs import get_reduced
from repro_torch.models.transformer import make_model
from repro_torch.runtime.fault import FaultInjector, PreemptionGuard
from repro_torch.serve import slo
from repro_torch.serve.engine import ElasticEngine, Request, RequestStatus
from repro_torch.serve.policy import FormatPolicy

FMTS = ("mxint4", "mxint6", "mxint8")
HBM = 1e12
LAYOUTS = {"dense": {},
           "paged-chunked": dict(kv_layout="paged", kv_page_size=8,
                                 attn_impl="gather", prefill_chunk=8)}
# (rid, tier, arrival tick, prompt length): a burst of four at tick 3
WAVE = ((0, "best_effort", 2, 9), (1, "throughput", 2, 6),
        (2, "best_effort", 3, 12), (3, "throughput", 3, 5),
        (4, "latency", 3, 7), (5, "latency", 3, 10), (6, "latency", 6, 4))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    api = jget_model(jreduced("smollm-135m"))
    params = jax.jit(api.init_params)(jax.random.PRNGKey(0))
    qat = JQAT(formats=FMTS, anchor="mxint8", block_size=32)
    anchor = jax.jit(lambda p: jmake(p, qat))(params)
    path = str(tmp_path_factory.mktemp("anchor") / "anchor")
    jsave(path, anchor)
    return api, params, anchor, load_anchor(path, device="cpu")


def _slo(mod, tier):
    return {"latency": mod.SLOClass.latency(ttft_ms=1e4, tpot_ms=1e4),
            "throughput": mod.SLOClass.throughput(ttft_ms=5e4),
            "best_effort": None}[tier]


def _requests(mod, req_cls, vocab, max_new=3):
    rng = np.random.default_rng(17)
    return [req_cls(rid, rng.integers(0, vocab, size=n).astype(np.int32),
                    max_new, slo=_slo(mod, tier), tenant=f"t{rid % 2}",
                    arrival_tick=tick)
            for rid, tier, tick, n in WAVE]


def _engines(served, port_kw=None, jax_kw=None, **kw):
    api, params, janchor, anchor = served
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_len", 48)
    jeng = JEngine(api, janchor, fused=False, param_template=params,
                   **kw, **(jax_kw or {}))
    eng = ElasticEngine(make_model(get_reduced("smollm-135m")), anchor,
                        device="cpu", **kw, **(port_kw or {}))
    return jeng, eng


def _trace(tick_trace):
    return [(t["prefill_tokens"], t["decode"], t["execs"]) for t in tick_trace]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("order", ["fifo", "slo"])
def test_arrivals_and_admission_order_match_jax(served, order, layout):
    jeng, eng = _engines(served, admission_order=order, **LAYOUTS[layout])
    vocab = served[0].cfg.vocab
    want = jeng.generate(_requests(jslo, JRequest, vocab),
                         fmt_override="mxint8")
    got = eng.generate(_requests(slo, Request, vocab), fmt_override="mxint8")
    assert [r.admitted_tick for r in got] == [r.admitted_tick for r in want]
    assert [r.status.value for r in got] == [r.status.value for r in want]
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert _trace(eng.tick_trace) == _trace(jeng.tick_trace)
    assert all(r.status is RequestStatus.COMPLETED for r in got)
    # nothing arrives before tick 2: two idle ticks open the wave
    assert _trace(eng.tick_trace)[:2] == [(0, 0, 0), (0, 0, 0)]
    for r in got:
        assert r.admitted_tick >= r.arrival_tick
        assert r.arrival_s is not None and r.ttft_s >= r.arrival_s
    if order == "slo":
        # among requests that had arrived by a tick, none of a lower tier
        # is admitted at it while a higher tier waits
        for r in got:
            waiting = [q for q in got if q.arrival_tick <= r.admitted_tick
                       and q.admitted_tick > r.admitted_tick]
            assert all(slo.tier_rank(q.slo) >= slo.tier_rank(r.slo)
                       for q in waiting), r.rid
    st = eng.stats()
    assert st["admission_order"] == order and st["cost_model"] is None


def test_cost_model_calibration_matches_jax(served):
    """``from_roofline`` attached, two waves pinned at mxint8 then mxint4:
    each format build re-seeds its weight term from the cached tree's
    bytes (base_s x hbm == weight_bytes, up to the last place of one
    division and one product), and the same ticks are folded in on both
    sides (a format's first clean decode tick skipped)."""
    cfg = get_reduced("smollm-135m")
    kw = dict(max_len=48, hbm_bytes_per_s=HBM)
    jeng, eng = _engines(
        served,
        port_kw=dict(policy=FormatPolicy(
            cost=slo.CostModel.from_roofline(cfg, FMTS, **kw))),
        jax_kw=dict(policy=JPolicy(
            cost=jslo.CostModel.from_roofline(jreduced("smollm-135m"), FMTS,
                                              **kw))),
        admission_order="slo")
    vocab = served[0].cfg.vocab
    for fmt in ("mxint8", "mxint4"):
        jeng.generate(_requests(jslo, JRequest, vocab, max_new=6),
                      fmt_override=fmt)
        eng.generate(_requests(slo, Request, vocab, max_new=6),
                     fmt_override=fmt)
    got, want = eng.stats(), jeng.stats
    assert got["weight_bytes"] == want["weight_bytes"]
    for fmt in FMTS:
        g, w = got["cost_model"][fmt], want["cost_model"][fmt]
        assert g["ticks_observed"] == w["ticks_observed"], fmt
        assert g["base_s"] == w["base_s"] and g["per_row_s"] == w["per_row_s"]
    for fmt in ("mxint8", "mxint4"):
        term = got["cost_model"][fmt]
        assert term["base_s"] * HBM == pytest.approx(
            got["weight_bytes"][fmt], rel=1e-15)
        assert term["ticks_observed"] >= 2 and term["factor"] > 0
        assert eng.policy.cost.measured(fmt)
    assert got["cost_model"]["mxint6"]["ticks_observed"] == 0


def _measured(mod):
    """mxint8 measured at 3x its raw roofline, mxint6 and mxint4 seeded."""
    cm = mod.CostModel(hbm_bytes_per_s=1e9, min_ticks=1)
    for i, f in enumerate(reversed(FMTS)):
        cm.seed(f, (3 - i) * 1e6, 1e4)
    cm.observe("mxint8", 1, 3 * cm.raw_predict_s("mxint8", 1))
    return cm


@pytest.mark.parametrize("budget", [None, 7.0, 5.0, 1.0])
def test_the_wave_pick_uses_the_tightest_budget(served, budget):
    """The drained engine picks from the ARRIVED requests' tightest TPOT
    budget and expected decode rows: predicted 9.06 / 6.06 / 3.06 ms for
    mxint8 / 6 / 4, so a 7 ms budget takes mxint6, 5 ms mxint4, 1 ms
    (none fits) the fastest, and no budget the threshold table's anchor.
    A later-arriving request's tighter budget does not enter the pick."""
    def reqs(mod, cls):
        late = mod.SLOClass.latency(ttft_ms=1e4, tpot_ms=0.5)
        first = None if budget is None else mod.SLOClass.latency(
            ttft_ms=1e4, tpot_ms=budget)
        rng = np.random.default_rng(3)
        return [cls(0, rng.integers(0, 512, 6).astype(np.int32), 2,
                    slo=first),
                cls(1, rng.integers(0, 512, 6).astype(np.int32), 2),
                cls(2, rng.integers(0, 512, 6).astype(np.int32), 2,
                    slo=late, arrival_tick=50)]

    jeng, eng = _engines(
        served, port_kw=dict(policy=FormatPolicy(cost=_measured(slo))),
        jax_kw=dict(policy=JPolicy(cost=_measured(jslo))))
    want = jeng.generate(reqs(jslo, JRequest))
    got = eng.generate(reqs(slo, Request))
    expect = {None: "mxint8", 7.0: "mxint6", 5.0: "mxint4",
              1.0: "mxint4"}[budget]
    assert eng.policy.history[0] == jeng.policy.history[0] == expect
    assert got[0].fmt_used == want[0].fmt_used == expect
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]


def test_snapshot_resume_carries_slo_fields(served, tmp_path):
    """Preempted mid-wave under ``"slo"``: the snapshot's request records
    carry slo, tenant and the arrival fields as the JAX engine's do, and a
    fresh engine's resume finishes with the uninterrupted streams."""
    vocab = served[0].cfg.vocab
    kw = dict(admission_order="slo", **LAYOUTS["paged-chunked"])
    _, base_eng = _engines(served, **kw)
    base = base_eng.generate(_requests(slo, Request, vocab),
                             fmt_override="mxint8")
    jeng, eng = _engines(served, port_kw=dict(
        fault_injector=FaultInjector(preempt_at=5)),
        jax_kw=dict(fault_injector=JFault(preempt_at=5)), **kw)
    jeng.generate(_requests(jslo, JRequest, vocab), fmt_override="mxint8",
                  guard=JGuard(), snapshot_dir=str(tmp_path / "jax"))
    reqs = eng.generate(_requests(slo, Request, vocab),
                        fmt_override="mxint8", guard=PreemptionGuard(),
                        snapshot_dir=str(tmp_path / "port"))
    assert not all(r.done for r in reqs)
    _, mine = io.restore(str(tmp_path / "port"))
    _, ref = jio.restore_flat(str(tmp_path / "jax"))
    keys = ("rid", "slo", "tenant", "arrival_tick", "admitted_tick",
            "status")
    for a, b in zip(mine["meta"]["requests"], ref["meta"]["requests"]):
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
        assert (a["arrival_s"] is None) == (b["arrival_s"] is None)
    _, fresh = _engines(served, **kw)
    done = fresh.resume(str(tmp_path / "port"))
    assert [r.out_tokens for r in done] == [r.out_tokens for r in base]
    assert all(r.status is RequestStatus.COMPLETED for r in done)
    for r, b in zip(done, base):
        assert (r.slo, r.tenant, r.arrival_tick, r.admitted_tick) == \
            (b.slo, b.tenant, b.arrival_tick, b.admitted_tick)
        assert isinstance(r.arrival_s, float)
    st = fresh.stats()
    assert st["kv_pages_alloc"] == st["kv_pages_freed"]
