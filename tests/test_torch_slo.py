"""The port's SLO classes, serving cost model and format policy against the
JAX package's (``repro/serve/slo.py``, ``repro/serve/policy.py``).

All host arithmetic, so everything is held to exact equality: the same
calls on both packages give the same floats, the same picks and the same
history. ``from_roofline`` is compared at an explicit bandwidth, since the
defaults differ by design (the port's is the H100's, ``launch/mesh.py``).
"""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.serve import slo as jslo
from repro.serve.policy import FormatPolicy as JPolicy
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.launch import mesh
from repro_torch.serve import slo
from repro_torch.serve.policy import FormatPolicy

FMTS = ("mxint4", "mxint6", "mxint8")
HBM = 1.7e12            # any explicit bandwidth, the same on both sides


def test_slo_class_validation_rank_and_tiers():
    assert slo.TIERS == jslo.TIERS
    assert slo.SLOClass.latency().rank < slo.SLOClass.throughput().rank \
        < slo.SLOClass.best_effort().rank
    assert slo.SLOClass().tier == "best_effort"
    for kw in ({"tier": "platinum"}, {"ttft_ms": 0.0}, {"tpot_ms": -1.0}):
        with pytest.raises(ValueError):
            slo.SLOClass(**kw)
        with pytest.raises(ValueError):
            jslo.SLOClass(**kw)
    for tier in slo.TIERS:
        assert slo.SLOClass(tier=tier).rank == jslo.SLOClass(tier=tier).rank


@pytest.mark.parametrize("make", [
    lambda m: m.SLOClass.latency(ttft_ms=120.0, tpot_ms=9.0),
    lambda m: m.SLOClass.latency(),
    lambda m: m.SLOClass.throughput(ttft_ms=500.0),
    lambda m: m.SLOClass.best_effort()])
def test_slo_class_dict_round_trip_across_packages(make):
    mine, ref = make(slo), make(jslo)
    assert mine.to_dict() == ref.to_dict()
    assert slo.SLOClass.from_dict(ref.to_dict()) == mine
    assert jslo.SLOClass.from_dict(mine.to_dict()) == ref


def test_tier_rank_matches():
    assert slo.tier_rank(None) == jslo.tier_rank(None) \
        == slo.TIERS.index("best_effort")
    for tier in slo.TIERS:
        assert slo.tier_rank(slo.SLOClass(tier=tier)) == \
            jslo.tier_rank(jslo.SLOClass(tier=tier))


def _script(seed, n=60):
    """A seeded sequence of CostModel calls: (method, args)."""
    rng = np.random.default_rng(seed)
    fmts = FMTS + ("bf16", "mxfp8")
    calls = []
    for _ in range(n):
        f = str(rng.choice(fmts))
        op = rng.integers(0, 4)
        if op == 0:
            calls.append(("seed", (f, float(rng.uniform(1e5, 1e9)),
                                   float(rng.uniform(0, 1e6)))))
        elif op == 1:
            per_row = float(rng.uniform(0, 1e6)) if rng.random() < 0.5 \
                else None
            calls.append(("observe", (f, int(rng.integers(0, 9)),
                                      float(rng.uniform(-1e-3, 5e-2)),
                                      per_row)))
        elif op == 2:
            calls.append(("predict_ms", (f, int(rng.integers(-1, 9)))))
        else:
            calls.append(("raw_predict_s", (f, int(rng.integers(0, 9)))))
    return calls


def _run(cm, calls):
    out = []
    for name, args in calls:
        out.append(getattr(cm, name)(*args))
        out.append((cm.any_measured(),
                    tuple(cm.measured(f) for f in FMTS),
                    tuple(cm.has_estimate(f) for f in FMTS),
                    cm._prior_factor()))
    out.append(cm.snapshot())
    return out


@pytest.mark.parametrize("ema,min_ticks", [(0.25, 2), (1.0, 1), (0.1, 3)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cost_model_call_sequence_matches_jax(seed, ema, min_ticks):
    calls = _script(seed)
    got = _run(slo.CostModel(HBM, ema=ema, min_ticks=min_ticks), calls)
    want = _run(jslo.CostModel(HBM, ema=ema, min_ticks=min_ticks), calls)
    assert got == want


def test_cost_model_validation_and_default_bandwidth():
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError):
            slo.CostModel(HBM, ema=bad)
    assert slo.CostModel().hbm_bytes_per_s == mesh.HBM_BW == 3.35e12
    assert mesh.PEAK_FLOPS_BF16 == 989e12


@pytest.mark.parametrize("n_model", [1, 2])
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("arch", list_archs())
def test_from_roofline_matches_jax(arch, width, layout, n_model):
    cfg, jcfg = (get_reduced(arch), jget_reduced(arch)) if width == \
        "reduced" else (get_config(arch), jget_config(arch))
    kw = dict(max_len=512, kv_layout=layout, kv_page_size=16,
              n_model=n_model, hbm_bytes_per_s=HBM)
    fmts = FMTS + ("bf16",)
    got = slo.CostModel.from_roofline(cfg, fmts, **kw).snapshot()
    want = jslo.CostModel.from_roofline(jcfg, fmts, **kw).snapshot()
    assert got == want
    assert set(got) == set(fmts)


def test_from_roofline_refuses_a_bad_mesh():
    with pytest.raises(ValueError, match="n_model"):
        slo.CostModel.from_roofline(get_reduced("qwen3-4b"), FMTS,
                                    max_len=64, n_model=0)


# ---------------------------------------------------------------- policy

def _measured(mod, min_ticks=2, walls=(3e-3, 2e-3, 1e-3)):
    cm = mod.CostModel(hbm_bytes_per_s=1e9, min_ticks=min_ticks)
    for i, f in enumerate(FMTS):
        cm.seed(f, (i + 1) * 1e6, 1e5)
    for f, wall in zip(FMTS, walls):
        for _ in range(min_ticks):
            cm.observe(f, 1, wall)
    return cm


def _policies(cost_kind):
    """(port policy, JAX policy) with identical cost models."""
    out = []
    for mod, pol in ((slo, FormatPolicy), (jslo, JPolicy)):
        cm = None
        if cost_kind == "measured":
            cm = _measured(mod)
        elif cost_kind == "seeded":
            cm = mod.CostModel(hbm_bytes_per_s=1e9)
            for i, f in enumerate(FMTS):
                cm.seed(f, (i + 1) * 1e6, 1e5)
        elif cost_kind == "mxint8-only":
            cm = mod.CostModel(hbm_bytes_per_s=1e9, min_ticks=1)
            for i, f in enumerate(FMTS):
                cm.seed(f, (i + 1) * 1e6, 0.0)
            cm.observe("mxint8", 1, 3e-3)
        out.append(pol(cost=cm))
    return out


@pytest.mark.parametrize("cost_kind",
                         [None, "seeded", "measured", "mxint8-only"])
def test_pick_matches_jax_on_a_seeded_grid(cost_kind):
    """(load, prefill tokens, budget, rows, quarantine, override) drawn
    from one seed; the same picks and the same history, step by step."""
    mine, ref = _policies(cost_kind)
    rng = np.random.default_rng(11)
    for step in range(200):
        if rng.random() < 0.05:
            f = str(rng.choice(FMTS))
            mine.quarantine(f)
            ref.quarantine(f)
        kw = dict(
            queue_depth=int(rng.integers(0, 50)),
            active=int(rng.integers(0, 4)),
            prefill_tokens=int(rng.integers(0, 4096)),
            tpot_budget_ms=[None, 0.5, 2.0, 3.5, 50.0][rng.integers(0, 5)],
            decode_rows=[None, 0, 1, 4, 16][rng.integers(0, 5)],
            override=str(rng.choice(FMTS + ("bf16",)))
            if rng.random() < 0.1 else None)
        assert mine.pick(**kw) == ref.pick(**kw), (step, kw)
        assert mine.quarantined == ref.quarantined
        assert (mine._last, mine._stable) == (ref._last, ref._stable)
    assert mine.history == ref.history
    assert mine._cost_pick(2.0, 1) == ref._cost_pick(2.0, 1)


def test_cost_pick_degrades_to_threshold_table():
    """No model, no budget, or nothing measured: the threshold table
    decides pick for pick, hysteresis included (tests/test_policy.py)."""
    loads = [0, 2, 40, 41, 42, 9, 9, 1, 0, 33, 0, 0]

    def trajectory(pol, **kw):
        return [pol.pick(q, prefill_tokens=16 * q, **kw) for q in loads]

    baseline = trajectory(FormatPolicy())
    assert baseline == trajectory(JPolicy())
    seeded_only = slo.CostModel(hbm_bytes_per_s=1e9)
    for i, f in enumerate(FMTS):
        seeded_only.seed(f, (i + 1) * 1e6, 1e5)
    assert not seeded_only.any_measured()
    assert trajectory(FormatPolicy(cost=seeded_only),
                      tpot_budget_ms=1.0, decode_rows=4) == baseline
    assert trajectory(FormatPolicy(cost=_measured(slo)),
                      tpot_budget_ms=None, decode_rows=4) == baseline
    assert trajectory(FormatPolicy(), tpot_budget_ms=1.0,
                      decode_rows=4) == baseline


def test_cost_pick_takes_over_once_measured():
    cm = slo.CostModel(hbm_bytes_per_s=1e9, min_ticks=1)
    for i, f in enumerate(FMTS):
        cm.seed(f, (i + 1) * 1e6, 0.0)
    assert FormatPolicy(cost=cm).pick(
        64, tpot_budget_ms=100.0, decode_rows=1) == "mxint4"
    cm.observe("mxint8", 1, 3e-3)
    # measured + a roomy budget: the same deep queue picks the anchor
    assert FormatPolicy(cost=cm).pick(
        64, tpot_budget_ms=100.0, decode_rows=1) == "mxint8"


def test_cost_pick_widest_feasible_else_fastest_and_quarantine():
    """Predicted 3 / 2 / 1 ms for mxint8 / 6 / 4: a 2.5 ms budget takes
    mxint6, 0.5 ms none (the fastest, mxint4); quarantining mxint4 leaves
    the fastest eligible rung; the anchor stays eligible when
    quarantined; an override wins and leaves hysteresis untouched."""
    def fresh():
        return FormatPolicy(cost=_measured(slo, walls=(1e-3, 2e-3, 3e-3)),
                            hysteresis=1)

    pol = fresh()
    assert pol.pick(0, tpot_budget_ms=2.5, decode_rows=1) == "mxint6"
    assert pol.pick(0, tpot_budget_ms=0.5, decode_rows=1) == "mxint4"
    pol.quarantine("mxint4")
    assert pol.pick(0, tpot_budget_ms=0.5, decode_rows=1) == "mxint6"
    pol.quarantine("mxint8")
    assert "mxint8" not in pol.quarantined
    state = (pol._last, pol._stable)
    assert pol.pick(0, tpot_budget_ms=0.5, override="bf16") == "bf16"
    assert (pol._last, pol._stable) == state
    assert pol.history == ["mxint6", "mxint4", "mxint6", "bf16"]


def test_policy_fields_match_the_reference():
    mine = {f.name for f in dataclasses.fields(FormatPolicy)}
    ref = {f.name for f in dataclasses.fields(JPolicy)}
    assert mine == ref
