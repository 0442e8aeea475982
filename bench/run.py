"""Run one cell of the benchmark once, on the CUDA device it finds.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number compared
with its limit. The same numbers are the last lines of standard error.
Exits non-zero with no result where there is no CUDA device, too few of
them, or the program cannot be imported, or where ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
# caches at fixed paths inside the checkout; no library of the port may
# pull in JAX by itself
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(BUILD / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD / "triton"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def run_cell(name, seed: int, seconds: float, trace: bool, device,
             fmt=None, roots=None, t_start=None, benchmark=None):
    """The run's record, with ``checks`` and ``correct``. ``name`` is a
    cell's name or the loaded cell; its metrics are those ``benchmark``
    (``BENCHMARK.json`` by default) lists for it. ``fmt`` serves at another
    format than the cell's (the control); the reference always holds the
    cell's. The cell's ``kind`` names the harness module that runs and
    checks it (``bench/harness/<kind>.py``: ``run`` and ``check``)."""
    import importlib

    import torch
    from bench.harness import spec
    from bench.harness.trace import Tracer
    cell = spec.load_cell(name, roots) if isinstance(name, str) else name
    harness = importlib.import_module("bench.harness." + cell["kind"])
    e2e, per_layer = spec.cell_metrics(
        spec.load_benchmark() if benchmark is None else benchmark,
        cell["name"])
    tracer = Tracer() if trace else None
    rec = harness.run(cell, seed, seconds, tracer, device,
                      T_START if t_start is None else t_start, fmt=fmt)
    if tracer is not None:
        rec["trace"] = tracer.reduce()
    rec["metrics"] = spec.read_metrics(per_layer if trace else e2e, rec,
                                       roots)
    t_check = time.perf_counter()
    got = harness.check(cell, seed, rec.pop("check_inputs"), device)
    limits = cell["check"]["limits"]
    rec["checks"] = {k: {"value": got[k], "limit": v}
                     for k, v in limits.items()}
    rec["check_detail"] = {k: v for k, v in got.items() if k not in limits}
    rec["correct"] = all(x["value"] <= x["limit"]
                         for x in rec["checks"].values())
    rec["check_s"] = time.perf_counter() - t_check
    if isinstance(device, str) and device.startswith("cuda") or \
            getattr(device, "type", "") == "cuda":
        torch.cuda.synchronize()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from bench.harness import spec
    benchmark = spec.load_benchmark()
    chips = spec.workload(benchmark, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the program under test must import)
    spec.load_cell(args.workload)
    rec = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", benchmark=benchmark)
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in this process after the window: {bad}",
              file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": rec["memory_peak_bytes"],
           "power_limit_w": power_limit()}
    out = {"correct": rec["correct"], "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": rec["metrics"], "device": dev}
    if args.trace:
        tr = rec["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["check_detail"] = rec["check_detail"]
    out["checks"] = rec["checks"]
    print(json.dumps({"setup_s": rec.get("setup_s"),
                      "check_s": rec["check_s"]}), file=sys.stderr)
    for k, v in rec["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
