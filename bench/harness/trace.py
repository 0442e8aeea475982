"""The traced run's reduction: ``torch.profiler`` over the window, read back
as device time by kernel, the device's busy time, and the longest idle gaps
named by what the host was doing in them.

The window is the span of the engine's ``ElasticEngine.tick`` ranges the
trace holds. ``busy_s`` is the union of every device activity (kernels,
copies, sets) inside it; kernels are also summed by name and by the class
the metric readers use: B1 / B2 (``mx_mm_*_kernel`` with the int or the
packed-int4 mode) and paged attention (B3 / B4).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np

_MM = re.compile(r"mx_mm_\w+_kernel<(\d+)")
STEP_RANGES = ("ElasticEngine.tick",)
# what the host does in a gap: its ops, ranges and CUDA calls (not the
# profiler's own buffer handling)
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
              "python_function")
PROFILER_OWN = ("Activity Buffer Request", "Buffer Flush")


def short(name: str) -> str:
    """A kernel's name without its parameter list and namespaces."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name[:160]


def kernel_class(name: str) -> Optional[str]:
    m = _MM.search(name)
    if m:
        return "mx_matmul_int4" if m.group(1) == "2" else "mx_matmul"
    if "paged_attention_kernel" in name:
        return "paged_attention"
    return None


class Tracer:
    def __init__(self):
        self.prof = None
        self.result: Optional[Dict] = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self):
        import torch
        torch.cuda.synchronize()
        self.prof.stop()

    def reduce(self) -> Dict:
        if self.result is None:
            self.result = reduce_events(
                self.prof.profiler.kineto_results.events())
            self.prof = None
        return self.result


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged [start, end) intervals of an (n, 2) array."""
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    last = np.append(idx[1:] - 1, len(iv) - 1)
    return np.stack([starts, ends[last]], 1)


def reduce_events(events) -> Dict:
    dev, host, steps = [], [], []
    names: Dict[str, float] = {}
    for e in events:
        t0, dur = e.start_ns(), e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            if e.is_user_annotation():      # a range's mirror on the device
                continue
            dev.append((t0, t0 + dur))
            n = e.name()
            names[n] = names.get(n, 0.0) + dur * 1e-9
        else:
            n = e.name()
            if n in STEP_RANGES:
                steps.append((t0, t0 + dur))
            kind = e.activity_type() if hasattr(e, "activity_type") \
                else "cpu_op"
            if kind in HOST_KINDS and n not in PROFILER_OWN:
                host.append((t0, t0 + dur, n))
    if not steps:
        raise RuntimeError("the trace holds no step range")
    lo = min(s for s, _ in steps)
    hi = max(e for _, e in steps)
    iv = np.asarray(dev, np.int64).reshape(-1, 2)
    iv = _union(np.clip(iv, lo, hi))
    iv = iv[iv[:, 1] > iv[:, 0]]
    busy = float((iv[:, 1] - iv[:, 0]).sum()) * 1e-9
    # gaps between device activity inside the window
    edges = np.concatenate([[lo], iv.ravel(), [hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    order = np.argsort(gaps[:, 0] - gaps[:, 1])[:10]
    hs = np.asarray([(a, b) for a, b, _ in host], np.int64).reshape(-1, 2)
    hn = [n for _, _, n in host]
    idle: List = []
    for g in gaps[order]:
        mid = (g[0] + g[1]) // 2
        inside = np.flatnonzero((hs[:, 0] <= mid) & (hs[:, 1] >= mid))
        if len(inside):
            j = inside[np.argmin(hs[inside, 1] - hs[inside, 0])]
            what = hn[j]
        else:
            what = "no host range"
        idle.append([what, float(g[1] - g[0]) * 1e-9])
    classes: Dict[str, float] = {}
    for n, s in names.items():
        c = kernel_class(n)
        if c is not None:
            classes[c] = classes.get(c, 0.0) + s
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": (hi - lo) * 1e-9,
            "classes": classes, "device_ops": [[short(n), s] for n, s in top],
            "idle_gaps": idle, "steps": len(steps)}
