"""Fault tolerance: preemption handling, a watchdog heartbeat and a
straggler monitor for the training loop, and the serving engine's chaos
plan.

The classes are the port's copies of ``repro/runtime/fault.py``'s;
``FaultInjector`` carries every primitive of the reference's chaos plan.
  - PreemptionGuard: SIGTERM/SIGINT -> set a flag; the train loop checks it
    every step and checkpoints-then-exits cleanly, and the serving engine
    at every tick boundary, where it snapshots the wave and returns it
    (``ElasticEngine.generate(guard=, snapshot_dir=)``, then
    ``resume()``). Re-entry resumes from LATEST.
  - Watchdog: a step-duration heartbeat; if a step exceeds `timeout_s`, the
    registered callback fires. ``on_timeout`` runs on the watchdog's daemon
    thread, never on the caller's; the default callback records a
    ``TimeoutError``, which ``heartbeat()`` / ``stop()`` re-raise on the
    calling thread.
  - StragglerMonitor: rolling per-step stats; steps slower than
    `threshold x median` are flagged and recorded in ``events``.
"""
from __future__ import annotations

import collections
import dataclasses
import signal
import statistics
import threading
import time
from typing import (Callable, Dict, FrozenSet, List, Optional, Tuple,
                    Union)

import numpy as np
import torch


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._flag = threading.Event()
        self._prev = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:   # non-main thread (tests)
                pass
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False

    def _handler(self, signum, frame):
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def trigger(self):      # for tests / manual drain
        self._flag.set()


class Watchdog:
    """Fires `on_timeout` if heartbeat() isn't called within timeout_s.

    ``on_timeout`` runs on the watchdog's daemon thread (see the module
    docstring for the callback-thread contract). With the default
    callback, a timeout is recorded and re-raised as ``TimeoutError`` from
    the *next* ``heartbeat()`` or from ``stop()`` — i.e. on the thread
    that owns the watched loop, where it can actually abort it.
    """

    def __init__(self, timeout_s: float,
                 on_timeout: Optional[Callable[[], None]] = None):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout or self._default
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._timeout_exc: Optional[TimeoutError] = None
        self.fired = False

    def _default(self):
        # Runs on the watchdog thread: raising here would kill only that
        # thread (the pre-fix bug), so record and let the caller's next
        # heartbeat()/stop() re-raise where it can abort the loop.
        self._timeout_exc = TimeoutError(
            f"watchdog: step exceeded the {self.timeout_s:.1f}s heartbeat "
            "timeout (raised at the next heartbeat on the caller's thread; "
            "the timeout itself fired on the watchdog thread)")

    def _reraise(self):
        if self._timeout_exc is not None:
            exc, self._timeout_exc = self._timeout_exc, None
            raise exc

    def start(self):
        self._last = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def heartbeat(self):
        self._reraise()
        self._last = time.monotonic()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1)
        self._reraise()

    def _run(self):
        while not self._stop.wait(min(self.timeout_s / 4, 1.0)):
            if time.monotonic() - self._last > self.timeout_s:
                self.fired = True
                try:
                    self.on_timeout()
                finally:
                    return


class StragglerMonitor:
    def __init__(self, window: int = 50, threshold: float = 2.0):
        self.times = collections.deque(maxlen=window)
        self.threshold = threshold
        self.events: List[dict] = []

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if len(self.times) >= 8:
            med = statistics.median(self.times)
            if seconds > self.threshold * med:
                is_straggler = True
                self.events.append({
                    "step": step, "seconds": seconds, "median": med,
                    "action": "flag-host-for-reschedule",
                })
        self.times.append(seconds)
        return is_straggler

    @property
    def median(self) -> Optional[float]:
        return statistics.median(self.times) if self.times else None


class InjectedFault(RuntimeError):
    """An injector-raised fault. A ``RuntimeError`` on purpose: an injected
    page-allocation failure rides the engine's real pool-exhaustion paths
    (requeue, victim retirement), and an injected step crash is caught by
    the tick's retry loop — chaos drives the production error paths."""


@dataclasses.dataclass
class FaultInjector:
    """Deterministic chaos plan for ``ElasticEngine(fault_injector=...)``.

    Keyed by the engine's per-``generate`` scheduler tick (0-based loop
    iterations, not decode ticks), except ``fail_allocs``, keyed by the
    0-based index of the page-allocation call since the engine was built.
    Each primitive fires once per key and is recorded in ``events``, except
    a logit poison restricted by ``poison_fmt``, which fires again on every
    replay still running a listed format: the fault follows the format, so
    escalation, not replay, clears it.

      - ``poison_logits``: {tick: row} — overwrite one row's (row None:
        every row's) logits with NaN after the step runs.
      - ``poison_fmt``: restrict the poison to these serving formats.
      - ``poison_pool``: {tick: physical page} — the engine fills that page
        of every layer's K/V pool with NaN before the tick (persistent:
        a replay reads it again).
      - ``fail_allocs``: allocation-call indices that raise
        ``InjectedFault`` out of the page allocator.
      - ``raise_in_step``: ticks whose decode or mixed step raises
        ``InjectedFault`` before dispatch (transient: the retry runs clean).
      - ``cancel_at``: {tick: rid} — cancel that request at the tick.
      - ``preempt_at``: the tick at which to ``trigger()`` the guard passed
        to ``generate`` — mid-tick, so the engine acts on it at the next
        tick boundary.
    """
    poison_logits: Dict[int, Optional[int]] = \
        dataclasses.field(default_factory=dict)
    poison_fmt: Union[str, Tuple[str, ...], FrozenSet[str], None] = None
    fail_allocs: Tuple[int, ...] = ()
    raise_in_step: Tuple[int, ...] = ()
    preempt_at: Optional[int] = None
    poison_pool: Dict[int, int] = dataclasses.field(default_factory=dict)
    cancel_at: Dict[int, int] = dataclasses.field(default_factory=dict)
    events: List[dict] = dataclasses.field(default_factory=list, init=False)
    _fired: set = dataclasses.field(default_factory=set, init=False)

    def _fmts(self) -> Optional[FrozenSet[str]]:
        if self.poison_fmt is None:
            return None
        if isinstance(self.poison_fmt, str):
            return frozenset((self.poison_fmt,))
        return frozenset(self.poison_fmt)

    def _record(self, kind: str, **kw) -> None:
        self.events.append({"kind": kind, **kw})

    # ---- engine hooks ------------------------------------------------------
    def on_alloc(self, call_index: int) -> None:
        """Raises for allocation-call indices listed in ``fail_allocs``."""
        if call_index in self.fail_allocs \
                and ("alloc", call_index) not in self._fired:
            self._fired.add(("alloc", call_index))
            self._record("fail_alloc", call=call_index)
            raise InjectedFault(
                f"injected page-allocation failure (call {call_index})")

    def maybe_raise_step(self, tick: int) -> None:
        """Raises once per tick listed in ``raise_in_step``; the retry of
        the same tick runs clean."""
        if tick in self.raise_in_step and ("step", tick) not in self._fired:
            self._fired.add(("step", tick))
            self._record("raise_in_step", tick=tick)
            raise InjectedFault(f"injected step-fn crash at tick {tick}")

    def maybe_poison_logits(self, tick: int, fmt: str,
                            logits: torch.Tensor) -> torch.Tensor:
        """This tick's attempt's logits, poisoned if the plan says so (a
        copy; the step's own output is left as it is)."""
        if tick not in self.poison_logits:
            return logits
        fmts = self._fmts()
        if fmts is not None:
            if fmt not in fmts:
                return logits       # escalated past the bad rung(s): clean
        elif ("logits", tick) in self._fired:
            return logits           # transient: fires once, replay is clean
        self._fired.add(("logits", tick))
        row = self.poison_logits[tick]
        self._record("poison_logits", tick=tick, row=row, fmt=fmt)
        if row is None:
            return torch.full_like(logits, float("nan"))
        out = logits.clone()
        out[row] = float("nan")
        return out

    def pool_poison_page(self, tick: int) -> Optional[int]:
        """Physical page to NaN-fill before this tick (None = no-op)."""
        if tick in self.poison_pool and ("pool", tick) not in self._fired:
            self._fired.add(("pool", tick))
            page = self.poison_pool[tick]
            self._record("poison_pool", tick=tick, page=page)
            return page
        return None

    def maybe_preempt(self, tick: int, guard) -> None:
        """Triggers ``guard`` once, at tick ``preempt_at``."""
        if self.preempt_at == tick and guard is not None \
                and ("preempt", tick) not in self._fired:
            self._fired.add(("preempt", tick))
            self._record("preempt", tick=tick)
            guard.trigger()

    def cancel_rid(self, tick: int) -> Optional[int]:
        """The rid to cancel at this tick (None = no-op)."""
        if tick in self.cancel_at and ("cancel", tick) not in self._fired:
            self._fired.add(("cancel", tick))
            rid = self.cancel_at[tick]
            self._record("cancel", tick=tick, rid=rid)
            return rid
        return None


def random_plan(seed: int, rate: float, horizon: int, slots: int,
                kinds: Tuple[str, ...] = ("poison_row", "raise_step",
                                          "fail_alloc")) -> FaultInjector:
    """A reproducible ``FaultInjector`` from (seed, rate): each tick in
    ``[0, horizon)`` draws a fault with probability ``rate``, its kind
    uniformly from ``kinds`` and its row from ``slots`` (numpy's
    ``default_rng``, as the reference draws it, so one (seed, rate,
    horizon, slots) gives the same plan in both packages)."""
    rng = np.random.default_rng(seed)
    poison: Dict[int, Optional[int]] = {}
    raises: List[int] = []
    allocs: List[int] = []
    for t in range(horizon):
        if rng.random() >= rate:
            continue
        kind = kinds[int(rng.integers(len(kinds)))]
        if kind == "poison_row":
            poison[t] = int(rng.integers(slots))
        elif kind == "poison_all":
            poison[t] = None
        elif kind == "raise_step":
            raises.append(t)
        elif kind == "fail_alloc":
            allocs.append(t)        # alloc-call indices, not ticks
        else:
            raise ValueError(f"unknown chaos kind {kind!r}")
    return FaultInjector(poison_logits=poison,
                         raise_in_step=tuple(raises),
                         fail_allocs=tuple(allocs))
