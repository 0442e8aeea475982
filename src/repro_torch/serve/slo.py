"""Per-request SLO classes and the measured serving cost model.

Counterpart of ``repro/serve/slo.py``; the same floats for the same calls.

``SLOClass``
    A per-request service objective: a TTFT budget, a TPOT (per-output-
    token) budget, and a tier. Tiers order admission when the engine runs
    with ``admission_order="slo"`` — ``latency`` ahead of ``throughput``
    ahead of ``best_effort`` — and the tightest TPOT budget of a wave is
    what the policy holds the predicted tick time against.

``CostModel``
    Per-format decode-tick cost, *seeded* from the analytic roofline terms
    of ``launch/costmodel.py`` (weight bytes streamed per tick, attention
    bytes read per live row) and *calibrated* online from the engine's
    observed tick walls and byte counters::

        predict_s(fmt, rows) = (weight_bytes + rows * attn_bytes_per_row)
                               / hbm_bytes_per_s * factor

    ``factor`` is a per-format EWMA of observed / raw-predicted tick time:
    the seed gives the shape (which rung streams fewer bytes, how cost
    grows with occupancy), the factor what the card delivers. The default
    bandwidth is the H100's (``launch/mesh.py``). ``measured(fmt)`` is
    False until ``min_ticks`` clean observations exist, and
    ``FormatPolicy.pick`` keeps its threshold table until a rung is
    measured.

Everything here is host arithmetic: the cost model decides which format a
wave pins, never what a pinned format computes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.launch.costmodel import serve_roofline_terms
from repro_torch.launch.mesh import HBM_BW

TIERS = ("latency", "throughput", "best_effort")


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A per-request service-level objective.

    ``ttft_ms`` bounds time-to-first-token (admission wait + prefill),
    ``tpot_ms`` bounds time-per-output-token (decode tick cadence);
    ``None`` means "no budget on this axis".  ``tier`` ranks the request
    for tiered admission and for per-tier attainment reports.  Budgets
    are *objectives the scheduler optimises for*, not deadlines — a missed budget shows up as attainment < 1.0, it never
    kills the request (``Request.deadline_s`` remains the kill switch).
    """

    ttft_ms: Optional[float] = None
    tpot_ms: Optional[float] = None
    tier: str = "best_effort"

    def __post_init__(self) -> None:
        if self.tier not in TIERS:
            raise ValueError(
                f"tier must be one of {TIERS}, got {self.tier!r}")
        for name in ("ttft_ms", "tpot_ms"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive, got {v}")

    @property
    def rank(self) -> int:
        """Admission priority: lower is served first."""
        return TIERS.index(self.tier)

    @classmethod
    def latency(cls, ttft_ms: float = 200.0,
                tpot_ms: float = 50.0) -> "SLOClass":
        return cls(ttft_ms=ttft_ms, tpot_ms=tpot_ms, tier="latency")

    @classmethod
    def throughput(cls, ttft_ms: Optional[float] = None,
                   tpot_ms: Optional[float] = None) -> "SLOClass":
        return cls(ttft_ms=ttft_ms, tpot_ms=tpot_ms, tier="throughput")

    @classmethod
    def best_effort(cls) -> "SLOClass":
        return cls()

    def to_dict(self) -> dict:
        return {"ttft_ms": self.ttft_ms, "tpot_ms": self.tpot_ms,
                "tier": self.tier}

    @classmethod
    def from_dict(cls, d: dict) -> "SLOClass":
        return cls(ttft_ms=d.get("ttft_ms"), tpot_ms=d.get("tpot_ms"),
                   tier=d.get("tier", "best_effort"))


def tier_rank(slo: Optional[SLOClass]) -> int:
    """Admission rank of a request's SLO; no SLO ranks as best-effort."""
    return slo.rank if slo is not None else TIERS.index("best_effort")


@dataclasses.dataclass
class _FmtTerm:
    """One format's roofline terms, in seconds (bytes / hbm_bytes_per_s
    at seed time; refreshed when the engine measures the real bytes)."""

    base_s: float              # weight stream, once per tick
    per_row_s: float           # attention read, per live decode row
    factor: float = 1.0        # EWMA of observed / raw-predicted
    ticks_observed: int = 0
    last_wall_s: float = 0.0   # diagnostics only


class CostModel:
    """Measured per-format decode-tick cost (see module docstring).

    Thread-unsafe by design — it lives inside one engine's scheduler
    loop.  All quantities are plain Python floats; nothing here touches
    a device.
    """

    def __init__(self, hbm_bytes_per_s: Optional[float] = None,
                 ema: float = 0.25, min_ticks: int = 2) -> None:
        if hbm_bytes_per_s is None:
            hbm_bytes_per_s = HBM_BW
        if not (0.0 < ema <= 1.0):
            raise ValueError(f"ema must be in (0, 1], got {ema}")
        self.hbm_bytes_per_s = float(hbm_bytes_per_s)
        self.ema = float(ema)
        self.min_ticks = int(min_ticks)
        self.terms: Dict[str, _FmtTerm] = {}

    # -- seeding ---------------------------------------------------------
    def seed(self, fmt: str, weight_bytes: float,
             attn_bytes_per_row: float) -> None:
        """Install (or re-shape) a format's analytic terms.  Preserves an
        existing calibration factor — the engine calls this again with
        *measured* byte counts once a format's packed tree is cached."""
        term = self.terms.get(fmt)
        base = weight_bytes / self.hbm_bytes_per_s
        per_row = attn_bytes_per_row / self.hbm_bytes_per_s
        if term is None:
            self.terms[fmt] = _FmtTerm(base_s=base, per_row_s=per_row)
        else:
            term.base_s, term.per_row_s = base, per_row

    @classmethod
    def from_roofline(cls, cfg, formats, *, max_len: int,
                      kv_layout: str = "dense", kv_page_size: int = 16,
                      block_size: int = 32, n_model: int = 1,
                      hbm_bytes_per_s: Optional[float] = None,
                      ema: float = 0.25, min_ticks: int = 2) -> "CostModel":
        """Seed from ``launch.costmodel.serve_roofline_terms`` for every
        format name in ``formats`` (include ``"bf16"`` for the dense
        pseudo-format).

        ``n_model``: tensor-parallel shards — scales both byte terms to
        the per-card stream (``HBM_BW`` is a per-card bandwidth).
        """
        cm = cls(hbm_bytes_per_s=hbm_bytes_per_s, ema=ema,
                 min_ticks=min_ticks)
        for fmt, t in serve_roofline_terms(
                cfg, formats, max_len=max_len, kv_layout=kv_layout,
                kv_page_size=kv_page_size, block_size=block_size,
                n_model=n_model).items():
            cm.seed(fmt, t["weight_bytes"], t["attn_bytes_per_row"])
        return cm

    # -- queries ---------------------------------------------------------
    def has_estimate(self, fmt: str) -> bool:
        return fmt in self.terms

    def measured(self, fmt: str) -> bool:
        """True once ``fmt`` has enough clean tick observations for its
        calibration factor to be trusted."""
        t = self.terms.get(fmt)
        return t is not None and t.ticks_observed >= self.min_ticks

    def any_measured(self) -> bool:
        return any(self.measured(f) for f in self.terms)

    def raw_predict_s(self, fmt: str, rows: int) -> Optional[float]:
        """Uncalibrated roofline time for a decode tick with ``rows``
        live rows, or None for an unseeded format."""
        t = self.terms.get(fmt)
        if t is None:
            return None
        return t.base_s + max(0, int(rows)) * t.per_row_s

    def _prior_factor(self) -> float:
        """Calibration prior for not-yet-measured formats: the median
        factor of the measured ones (1.0 with no measurements). Without
        this, a measured rung's calibrated prediction would compete
        against an unmeasured rung's raw roofline — on backends far from
        the roofline (CPU: dispatch-dominated) that mismatch spans orders
        of magnitude and the comparison means nothing."""
        fs = sorted(t.factor for t in self.terms.values()
                    if t.ticks_observed >= self.min_ticks)
        if not fs:
            return 1.0
        return fs[len(fs) // 2]

    def predict_ms(self, fmt: str, rows: int) -> Optional[float]:
        """Calibrated predicted decode-tick time in milliseconds; an
        unmeasured format borrows ``_prior_factor()``."""
        raw = self.raw_predict_s(fmt, rows)
        if raw is None:
            return None
        t = self.terms[fmt]
        factor = t.factor if t.ticks_observed else self._prior_factor()
        return raw * factor * 1e3

    # -- online update ---------------------------------------------------
    def observe(self, fmt: str, rows: int, wall_s: float,
                attn_bytes_per_row: Optional[float] = None) -> None:
        """Fold one clean decode tick into ``fmt``'s calibration.

        ``wall_s`` is the tick's wall time, ``rows`` its live decode
        rows.  Pass ``attn_bytes_per_row`` when the engine's byte
        counters measured the real attention read — it refreshes the raw
        per-row term so the factor stays a pure backend-efficiency
        ratio.  An unseeded format bootstraps a flat (rows-independent)
        term from the observation itself; seeding first is what buys the
        occupancy slope.
        """
        if wall_s <= 0:
            return
        t = self.terms.get(fmt)
        if t is None:
            t = _FmtTerm(base_s=wall_s, per_row_s=0.0)
            self.terms[fmt] = t
        if attn_bytes_per_row is not None:
            t.per_row_s = attn_bytes_per_row / self.hbm_bytes_per_s
        raw = t.base_s + max(0, int(rows)) * t.per_row_s
        if raw > 0:
            ratio = wall_s / raw
            if t.ticks_observed == 0:
                t.factor = ratio
            else:
                t.factor = (1.0 - self.ema) * t.factor + self.ema * ratio
        t.ticks_observed += 1
        t.last_wall_s = wall_s

    # -- introspection ---------------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Plain-dict dump for ``stats()``."""
        return {
            fmt: {
                "base_s": t.base_s,
                "per_row_s": t.per_row_s,
                "factor": t.factor,
                "ticks_observed": t.ticks_observed,
                "predict_1row_ms": self.predict_ms(fmt, 1),
            }
            for fmt, t in self.terms.items()
        }
