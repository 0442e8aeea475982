"""Spreads of a cell's runs, as the bounds are set from: for each set and
metric the median and the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median.

    python3 bench/tools/spread.py <runs.jsonl> [...]
"""
import json
import statistics
import sys
from collections import defaultdict


def main(paths):
    runs = [json.loads(x) for p in paths for x in open(p) if x.strip()]
    sets = defaultdict(lambda: defaultdict(list))
    for r in runs:
        line = r.get("line")
        if not line or r.get("set") == "first" or r.get("trace"):
            continue
        for k, v in line["metrics"].items():
            sets[r["set"]][k].append(v["value"])
        sets[r["set"]]["correct"].append(float(line["correct"]))
        for k, v in line["checks"].items():
            sets[r["set"]]["check." + k].append(v["value"])
    out = {}
    for s, ms in sorted(sets.items()):
        for k, vals in ms.items():
            med = statistics.median(vals)
            q = statistics.quantiles(vals, n=4) if len(vals) > 1 else [med] * 3
            out.setdefault(k, {})[s] = {
                "n": len(vals), "median": med,
                "spread": (q[2] - q[0]) / med if med else 0.0,
                "min": min(vals), "max": max(vals)}
    for k, by in out.items():
        widest = max(v["spread"] for v in by.values())
        print(json.dumps({"metric": k, "widest_spread": widest,
                          "bound_5x": 5 * widest, "sets": by}))


if __name__ == "__main__":
    main(sys.argv[1:])
