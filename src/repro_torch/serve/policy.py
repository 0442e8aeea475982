"""Runtime precision-selection policy for elastic inference.

Counterpart of ``repro/serve/policy.py``: load (queue depth plus queued
prompt tokens over ``prefill_token_unit``) maps to a format ladder — deeper
queues pick lower-precision formats, an idle server the anchor — with
hysteresis against thrashing. ``escalate`` walks one rung toward the anchor
and ``quarantine`` bars a misbehaving rung from ``pick``; the anchor is
exempt from both. ``SpecConfig`` and ``allow_speculation`` decide
self-speculative decoding.

With a ``cost`` model attached (``serve/slo.py::CostModel``) the threshold
table becomes the fallback: when the wave carries a TPOT budget and at
least one rung has measured cost, ``pick`` chooses the widest
(highest-precision) non-quarantined rung whose predicted decode-tick time
fits the wave's tightest budget, else the fastest predicted rung. With no
budget in the wave, or nothing measured yet, the table decides exactly as
without a cost model.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Set, Tuple

from repro_torch.serve.slo import CostModel


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Self-speculative decoding knobs.

    ``draft_fmt`` names the cheap rung that drafts ``k`` tokens per decode
    tick; the batch-pinned format verifies them in one multi-query step.
    Both come from the same anchor checkpoint by Slice-and-Scale: no
    separate weights, no separate KV cache. Speculation never changes
    tokens (the engine commits only the verify format's own greedy
    choices); ``allow_speculation`` turns it off when the measured draft
    acceptance rate falls below ``min_acceptance``, judged only after
    ``window`` speculative ticks.
    """

    draft_fmt: str = "mxint4"
    k: int = 4
    min_acceptance: float = 0.0    # 0 = never disable on acceptance rate
    window: int = 16               # spec ticks before the rate is trusted


@dataclasses.dataclass
class FormatPolicy:
    anchor: str = "mxint8"
    # (queue_depth threshold, format) — checked top-down, first match wins
    ladder: Tuple[Tuple[int, str], ...] = (
        (32, "mxint4"),
        (8, "mxint6"),
        (0, "mxint8"),
    )
    hysteresis: int = 2
    # One queued request "counts double" per this many pending prompt tokens
    # — the ladder thresholds stay in queue-depth units.
    prefill_token_unit: int = 64
    # Measured per-format tick cost (serve/slo.py). None = pure threshold
    # policy; attached, it decides whenever a wave carries a TPOT budget
    # and at least one rung is measured.
    cost: Optional[CostModel] = None
    _last: str = dataclasses.field(default="", init=False)
    _stable: int = dataclasses.field(default=0, init=False)
    history: List[str] = dataclasses.field(default_factory=list, init=False)
    quarantined: Set[str] = dataclasses.field(default_factory=set,
                                              init=False)

    def escalate(self, fmt: str) -> Optional[str]:
        """One rung toward the anchor on the degradation ladder, or None
        when ``fmt`` is already the anchor / unknown to the ladder (there
        is nowhere safer to go). The ladder is ordered
        deepest-queue (lowest precision) first, so "up" is the next entry.
        """
        if fmt == self.anchor:
            return None
        fmts = [f for _, f in self.ladder]
        try:
            i = fmts.index(fmt)
        except ValueError:
            return None
        return fmts[i + 1] if i + 1 < len(fmts) else None

    def quarantine(self, fmt: str) -> None:
        """Bar ``fmt`` from future ``pick``s. The anchor is exempt: it is the
        checkpoint's native precision and the ladder's terminal rung."""
        if fmt != self.anchor:
            self.quarantined.add(fmt)

    def allow_speculation(self, draft_fmt: str, pinned_fmt: str,
                          acceptance_rate: Optional[float] = None,
                          min_acceptance: float = 0.0) -> bool:
        """Should the engine draft at ``draft_fmt`` this tick? Three
        vetoes: a quarantined draft rung (it would poison every draft), a
        draft rung equal to the pinned format (nothing cheaper to draft
        with), and a measured ``acceptance_rate`` below ``min_acceptance``
        (None while the sample is too small to judge). A veto runs plain
        pinned-format decode: the streams are the same, only speed
        changes."""
        if draft_fmt in self.quarantined or draft_fmt == pinned_fmt:
            return False
        return acceptance_rate is None or acceptance_rate >= min_acceptance

    def _cost_pick(self, tpot_budget_ms: Optional[float],
                   decode_rows: Optional[int]) -> Optional[str]:
        """Cost-model rung choice, or None when the threshold table must
        decide (no model, no budget in the wave, or nothing measured yet).

        Among non-quarantined rungs with a cost estimate (the anchor always
        eligible), the widest whose predicted tick time at ``decode_rows``
        fits the budget; if none fits, the fastest predicted rung. The
        ladder runs narrowest first, so "widest" is the last match.
        """
        cost = self.cost
        if cost is None or tpot_budget_ms is None:
            return None
        if not cost.any_measured():
            return None
        rows = 1 if decode_rows is None else max(1, int(decode_rows))
        fmts = [f for _, f in self.ladder]          # narrow -> wide
        cands = [f for f in fmts
                 if cost.has_estimate(f)
                 and (f not in self.quarantined or f == self.anchor)]
        if not cands:
            return None
        feasible = [f for f in cands
                    if cost.predict_ms(f, rows) <= tpot_budget_ms]
        if feasible:
            return feasible[-1]
        return min(cands, key=lambda f: cost.predict_ms(f, rows))

    def pick(self, queue_depth: int, active: int = 0,
             prefill_tokens: int = 0, *,
             tpot_budget_ms: Optional[float] = None,
             decode_rows: Optional[int] = None,
             override: Optional[str] = None) -> str:
        """Choose the next batch wave's pinned format.

        ``override`` is operator intent (``generate(fmt_override=...)``):
        it wins over load, cost, quarantine and hysteresis, and leaves the
        hysteresis state untouched. ``tpot_budget_ms`` is the tightest
        per-token budget among the wave's requests (None when none carries
        one), ``decode_rows`` the expected live decode rows (the occupancy
        term of the prediction). ``active`` is accepted for the reference's
        signature and does not enter the load.
        """
        if override is not None:
            self.history.append(override)
            return override
        target = self._cost_pick(tpot_budget_ms, decode_rows)
        if target is None:
            load = queue_depth + prefill_tokens // self.prefill_token_unit
            target = self.anchor
            for thresh, fmt in self.ladder:
                if load >= thresh:
                    target = fmt
                    break
        while target in self.quarantined:
            target = self.escalate(target) or self.anchor
        if self._last and target != self._last:
            self._stable += 1
            if self._stable < self.hysteresis:
                target = self._last
            else:
                self._stable = 0
        else:
            self._stable = 0
        self._last = target
        self.history.append(target)
        return target
