"""Serving cells: the program's ``ElasticEngine.generate`` under a traffic
mix, with a window closed by the engine's own tick-boundary hook.

Set-up makes the weights on the device from the seed, quantizes them to the
anchor format leaf by leaf (``make_anchor``), builds the engine, and runs a
warm wave of the cell's own shapes (every final-chunk width the mix can
produce, each alone and beside decoding rows, so every eager shape has run
and every CUDA graph key is captured). The timed wave then runs on the
same engine with ``guard=Window(...)``: the engine reads ``guard.preempted``
at every tick boundary, which is where the window opens (the cell's
``window.opens``: every slot live, or a tick count) and, ``seconds`` later,
closes; generate then returns with the wave unfinished.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bench.harness import check as checks
from bench.harness import traffic, weights
from bench.harness.model_config import port_config


def _bucket(n: int, cap: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return min(b, cap)


def chunks_of(plen: int, chunk: int) -> List[tuple]:
    """(start, take, padded) of each chunk of a prompt, as the engine cuts
    it (bucketed final chunk)."""
    out, start = [], 0
    while start < plen:
        take = min(chunk, plen - start)
        final = start + take >= plen
        out.append((start, take, _bucket(take, chunk) if final else chunk))
        start += take
    return out


class Window:
    """The tick-boundary hook. ``preempted`` is read once per tick, before
    the tick's work: it records the decoding rows' positions for that tick,
    opens the window when the cell's condition first holds, and turns true
    at the first boundary ``seconds`` after the opening."""

    def __init__(self, engine, requests, seconds: float, opens: Dict,
                 on_open=None, on_close=None):
        self.eng, self.reqs, self.seconds = engine, requests, seconds
        self.opens = opens
        self.on_open, self.on_close = on_open, on_close
        self.live: List = []
        self.cursor = 0
        self.decode_pos: List[np.ndarray] = []
        self.t_wave0: Optional[float] = None
        self.t_open = self.t_close = None
        self.tick_open = self.tick_close = None
        self.tokens_open = None
        self.open_cost = 0.0

    def _refresh(self):
        from repro_torch.serve.engine import RequestStatus
        while self.cursor < len(self.reqs) and \
                self.reqs[self.cursor].status != RequestStatus.QUEUED:
            self.live.append(self.reqs[self.cursor])
            self.cursor += 1
        self.live = [r for r in self.live
                     if r.status == RequestStatus.RUNNING]

    @property
    def preempted(self) -> bool:
        now = time.perf_counter()
        if self.t_wave0 is None:
            self.t_wave0 = now
        tick = len(self.eng.tick_trace)
        self._refresh()
        self.decode_pos.append(np.asarray(
            [r.prompt.size + len(r.out_tokens) - 1 for r in self.live
             if r.out_tokens], np.int64))
        if self.t_open is None:
            if self.opens.get("kind") == "slots_full":
                ready = len(self.live) >= self.eng.slots
            else:
                ready = tick >= int(self.opens["tick"])
            if ready:
                self.tokens_open = sum(len(r.out_tokens) for r in self.reqs)
                if self.on_open is not None:
                    self.on_open()
                self.t_open, self.tick_open = time.perf_counter(), tick
                # the first tick's wall starts before this hook: what the
                # hook spent opening (the profiler's start) is not the tick's
                self.open_cost = self.t_open - now
            return False
        if now - self.t_open < self.seconds:
            return False
        self.t_close, self.tick_close = now, tick
        if self.on_close is not None:
            self.on_close()
        return True


def _requests(specs, cls) -> List:
    return [cls(rid=i, prompt=s["prompt"], max_new=s["max_new"],
                arrival_tick=s["arrival_tick"]) for i, s in enumerate(specs)]


def build(cell: Dict, seed: int, device, fmt: str):
    """(engine, port config): weights from the seed, the anchor made leaf
    by leaf so that one float32 leaf at a time lives beside it."""
    from repro_torch.core.anchor import AnchorModel, make_anchor
    from repro_torch.core.qat import QATConfig
    from repro_torch.models import get_model
    from repro_torch.serve.engine import ElasticEngine
    cfg = cell["config"]
    pcfg = port_config(cfg)
    qat = QATConfig(anchor=cell["anchor"])
    q, raw = {}, {}
    for i, (name, shape, kind, std) in enumerate(weights.leaves(cfg)):
        leaf = weights.make_leaf(seed, i, shape, kind, std, device)
        part = make_anchor(weights.nest(name, leaf), qat, device=device)
        q.update(part.quantized)
        raw.update(part.raw)
        del leaf, part
    anchor = AnchorModel(quantized=q, raw=raw, fmt_name=cell["anchor"])
    eng = ElasticEngine(get_model(pcfg), anchor, device=device,
                        **cell["engine"])
    eng.weights_for(fmt)
    return eng, pcfg


def warm(eng, cell: Dict, fmt: str) -> None:
    """Every final-chunk width the mix can produce, first one request at a
    time (each chunk alone, eager), then all at once (chunks beside
    decoding rows: the mixed graphs)."""
    from repro_torch.serve.engine import Request
    ch = eng.prefill_chunk
    mix = cell["traffic"]
    lo, hi = mix["prompt"]["min"], mix["prompt"]["max"]
    widths, w = [], 8
    while w <= ch:
        widths.append(w)
        w *= 2
    lens = sorted({min(max(ch + w, lo), hi) for w in widths}
                  | {min(max(w, lo), hi) for w in widths})
    rng = np.random.Generator(np.random.PCG64(0))
    vocab = cell["config"]["vocab_size"]
    for spaced in (True, False):
        reqs = [Request(rid=i, prompt=rng.integers(0, vocab, n,
                                                   dtype=np.int32),
                        max_new=8, arrival_tick=40 * i if spaced else 0)
                for i, n in enumerate(lens)]
        eng.generate(reqs, fmt_override=fmt)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()


def run(cell: Dict, seed: int, seconds: float, tracer, device, t_start: float,
        fmt: Optional[str] = None) -> Dict:
    """One timed wave. Returns the run's record (``rec``) and, under
    ``rec["check_inputs"]``, what the correctness check needs."""
    from repro_torch.serve.engine import Request, RequestStatus
    fmt = fmt or cell["format"]
    eng, pcfg = build(cell, seed, device, fmt)
    warm(eng, cell, fmt)
    specs = traffic.generate(cell["traffic"], seed,
                             cell["config"]["vocab_size"])
    reqs = _requests(specs, Request)
    cuda = eng.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    win = Window(eng, reqs, seconds, cell["window"],
                 on_open=tracer.start if tracer else None,
                 on_close=tracer.stop if tracer else None)
    eng.generate(reqs, fmt_override=fmt, guard=win)
    if win.t_close is None:
        raise RuntimeError(
            f"the wave ended before the window closed (opened: "
            f"{win.t_open is not None}); the mix needs more requests")
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rec = record(cell, eng, reqs, win, fmt)
    rec["setup_s"] = win.t_open - t_start
    rec["memory_peak_bytes"] = int(peak)
    rec["check_inputs"] = [
        (r.prompt, list(r.out_tokens), r.rid) for r in reqs
        if r.status == RequestStatus.COMPLETED]
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return rec


def check(cell: Dict, seed: int, inputs: List, device) -> Dict:
    """The numbers ``correct`` compares (``harness/check.py``) over a
    sample of the completed requests; every limit fails where the run
    completed none."""
    c = cell["check"]
    picked = checks.sample(inputs, seed, c["min_tokens"], c["max_requests"])
    if not picked:
        return {k: float("inf") for k in c["limits"]}
    return checks.widest_gap(cell, seed, picked, device, cell["format"])


def record(cell: Dict, eng, reqs, win: Window, fmt: str) -> Dict:
    """What the metric readers read: the window's ticks with their work,
    the requests due in it, and the tokens it emitted."""
    ch = eng.prefill_chunk
    seq = [c for r in reqs if r.admitted_tick is not None
           for c in chunks_of(r.prompt.size, ch)]
    trace = eng.tick_trace
    ticks, k = [], 0
    for t, tt in enumerate(trace[:win.tick_close]):
        chunk = None
        if tt["prefill_chunks"]:
            chunk = seq[k] if k < len(seq) else None
            if chunk is not None and chunk[2] != tt["prefill_tokens"]:
                raise RuntimeError(f"tick {t}: chunk {chunk} does not match "
                                   f"the trace's {tt['prefill_tokens']}")
            k += 1
        if t < win.tick_open:
            continue
        pos = win.decode_pos[t] if tt["decode"] else np.zeros(0, np.int64)
        wall = tt["wall_s"] - (win.open_cost if t == win.tick_open else 0.0)
        ticks.append({"wall_s": wall, "decode": tt["decode"],
                      "decode_rows": tt["decode_rows"], "decode_pos": pos,
                      "chunk": chunk, "execs": tt["execs"]})
    t0 = win.t_wave0
    open_s, close_s = win.t_open - t0, win.t_close - t0
    due = []
    for r in reqs:
        if r.arrival_s is None or not open_s <= r.arrival_s < close_s:
            continue
        first = r.ttft_s if r.ttft_s is not None and r.ttft_s <= close_s \
            else None
        due.append({"wait_s": (first if first is not None else close_s)
                    - r.arrival_s, "first": first is not None,
                    "queue_ticks": (r.admitted_tick if r.admitted_tick
                                    is not None else win.tick_close)
                    - r.arrival_tick})
    tokens = sum(len(r.out_tokens) for r in reqs) - win.tokens_open
    return {"kind": "serve", "cfg": cell["config"], "fmt": fmt,
            "slots": eng.slots, "scheduler": eng.scheduler,
            "chunk": ch, "window_s": win.t_close - win.t_open,
            "ticks": ticks, "due": due, "tokens_out": tokens,
            "attempted": sum(1 for r in reqs
                             if r.arrival_tick <= win.tick_close),
            "failed": sum(1 for r in reqs if r.status.terminal
                          and r.status.value != "completed")}
