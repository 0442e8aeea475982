"""Run one cell once with changed settings, for sizing and debugging; not
part of any measured run.

    python3 bench/tools/trial.py --workload <cell> --seed <n> --seconds <s>
        [--trace 1] [--fmt mxint3] [--set engine.scheduler='"mixed"' ...]

``--set`` takes a dotted key of the cell file and a JSON value. Prints one
JSON line: the metrics, the checks, the set-up, the window's tick walls
by kind (decode alone, chunk alone, both), and what the host did in the
window (``host``): the process's CPU seconds and involuntary context
switches, the garbage collector's pauses, and the machine's steal and
busy shares of its CPUs from ``/proc/stat``, where it advances.
``--roots`` and ``--benchmark`` take a folder laid out like ``bench/``
and its benchmark file (the test fixtures, for a CPU rehearsal).
"""
import argparse
import gc
import json
import pathlib
import resource
import statistics
import sys
import time

T0 = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import run as R  # noqa: E402
from bench.harness import serve, spec  # noqa: E402


def _stat():
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None


class HostProbe:
    """Snapshots of the host at the window's opening and closing."""

    def __init__(self):
        self.snaps = {}
        self.gc_s, self.gc_n, self._t = 0.0, 0, None
        gc.callbacks.append(self._gc)

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n += 1

    def snap(self, key):
        self.snaps[key] = (time.perf_counter(),
                           resource.getrusage(resource.RUSAGE_SELF),
                           _stat(), self.gc_s, self.gc_n)

    def window(self):
        if set(self.snaps) != {"open", "close"}:
            return None
        (t0, r0, s0, g0, n0), (t1, r1, s1, g1, n1) = (
            self.snaps["open"], self.snaps["close"])
        out = {"wall_s": t1 - t0,
               "cpu_s": (r1.ru_utime + r1.ru_stime)
               - (r0.ru_utime + r0.ru_stime),
               "involuntary_switches": r1.ru_nivcsw - r0.ru_nivcsw,
               "gc_s": g1 - g0, "gc_collections": n1 - n0}
        d = [b - a for a, b in zip(s0 or (), s1 or ())]
        total = sum(d[:8])
        # a sandbox whose /proc/stat does not advance reads as not read
        out["steal_share"] = d[7] / total if total and len(d) > 7 else None
        out["busy_share"] = 1 - (d[3] + d[4]) / total if total else None
        return out

    def wrap(self):
        """Snapshot at every ``serve.Window``'s opening and closing."""
        init = serve.Window.__init__
        probe = self

        def wrapped(win, *a, on_open=None, on_close=None, **k):
            def opened():
                probe.snap("open")
                if on_open is not None:
                    on_open()

            def closed():
                if on_close is not None:
                    on_close()
                probe.snap("close")
            init(win, *a, on_open=opened, on_close=closed, **k)
        serve.Window.__init__ = wrapped


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--fmt")
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--roots", nargs="*", default=None)
    ap.add_argument("--benchmark")
    a = ap.parse_args()
    bench = spec.load_benchmark(a.benchmark)
    cell = spec.load_cell(a.workload, a.roots)
    for kv in a.set:
        key, val = kv.split("=", 1)
        node = cell
        *path, last = key.split(".")
        for p in path:
            node = node[p]
        node[last] = json.loads(val)
    probe = HostProbe()
    probe.wrap()
    rec = R.run_cell(cell, a.seed, a.seconds, bool(a.trace), a.device,
                     fmt=a.fmt, roots=a.roots, t_start=T0, benchmark=bench)
    kinds = {}
    for t in rec.get("ticks", []):
        k = ("chunk+" if t["chunk"] else "") + ("decode" if t["decode"]
                                               else "alone")
        kinds.setdefault(k, []).append(t["wall_s"] * 1e3)
    walls = {k: {"n": len(v), "median_ms": statistics.median(v),
                 "mean_ms": statistics.fmean(v), "sum_s": sum(v) / 1e3,
                 "max_ms": max(v)} for k, v in kinds.items()}
    import torch
    peak = rec.get("memory_peak_bytes")
    out = {"cell": a.workload, "seed": a.seed, "fmt": a.fmt, "set": a.set,
           "correct": rec["correct"], "metrics": rec["metrics"],
           "checks": rec["checks"], "check_detail": rec["check_detail"],
           "setup_s": rec.get("setup_s"), "check_s": rec["check_s"],
           "window_s": rec.get("window_s"), "ticks": walls,
           "due": len(rec.get("due", [])), "peak_bytes": peak,
           "attempted": rec["attempted"], "failed": rec["failed"],
           "counters": spec.read_metrics(
               spec.cell_metrics(bench, a.workload)[1], rec, a.roots),
           "host": probe.window(), "tokens_out": rec.get("tokens_out")}
    if rec.get("trace"):
        out["trace"] = {k: v for k, v in rec["trace"].items()}
    if torch.cuda.is_available():
        out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out, default=str), flush=True)


if __name__ == "__main__":
    main()
