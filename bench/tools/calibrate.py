"""Readings that the limits of ``correct`` are set from: the program on
many seeds, and the control (the program one format below the cell's,
judged against the reference at the cell's format) on a few, all in one
process (the readings need no long window).

    python3 bench/tools/calibrate.py --workload <cell> --seconds 4 \
        --seeds 101 102 ... [--control-seeds 201 202 203]

Prints one JSON line a run: seed, side, the numbers compared and their
detail.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import run as R  # noqa: E402
from bench.harness import spec  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    a = ap.parse_args()
    cell = spec.load_cell(a.workload)
    runs = [(s, None) for s in a.seeds] + \
        [(s, cell["control_format"]) for s in a.control_seeds]
    for seed, fmt in runs:
        t0 = time.perf_counter()
        rec = R.run_cell(cell, seed, a.seconds, False, "cuda", fmt=fmt,
                         t_start=t0)
        print(json.dumps({
            "cell": a.workload, "seed": seed,
            "side": "control" if fmt else "program", "fmt": fmt or
            cell["format"], "checks": rec["checks"],
            "detail": rec["check_detail"], "metrics": rec["metrics"],
            "check_s": rec["check_s"],
            "run_s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
