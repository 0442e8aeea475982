"""90th percentile of the ticks a request due in the window waited from
``arrival_tick`` to ``admitted_tick`` (to the window's close, if not yet
admitted). Nearest rank."""
import math

UNIT = "ticks"


def read(rec):
    due = rec.get("due") or []
    if not due:
        return None
    q = sorted(d["queue_ticks"] for d in due)
    return float(q[math.ceil(0.9 * len(q)) - 1])
