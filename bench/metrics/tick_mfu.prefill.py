"""The window's ticks' share of the chip's peak: for each tick the larger of
its model operations over the bf16 peak and its weight and KV bytes over
the HBM bandwidth (``bench/harness/work.py``, real tokens only), summed over
the window's ticks, over their wall time. H100 SXM peaks at 700 W."""
from bench.harness import work

UNIT = "%"


def read(rec):
    if rec.get("kind") != "serve" or not rec["ticks"]:
        return None
    wall = sum(t["wall_s"] for t in rec["ticks"])
    return 100.0 * work.bound_sum(rec, "model") / wall
