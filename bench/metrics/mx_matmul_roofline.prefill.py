"""B1 (mx_matmul, MXINT8): the least time the chip needs for every launch in the traced
window (each launch's operations over the bf16 peak or its bytes over the
HBM bandwidth, whichever is larger, from the cell's shapes and each tick's
rows: ``bench/harness/work.py``) over the device time of the kernels
of that class in the trace."""
from bench.harness import work

UNIT = "%"


def read(rec):
    tr = rec.get("trace")
    if not tr or rec.get("kind") != "serve":
        return None
    dev = tr["classes"].get("mx_matmul")
    if not dev:
        return None
    return 100.0 * work.bound_sum(rec, "gemm") / dev
