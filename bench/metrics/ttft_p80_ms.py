"""80th percentile of time to first token over every request that came due
in the window, counted from when it came due (``ttft_s - arrival_s``); a
request with no first token when the window closes counts its wait so far.
Nearest rank."""
import math

UNIT = "ms"


def read(rec):
    due = rec.get("due") or []
    if not due:
        return None
    waits = sorted(d["wait_s"] for d in due)
    return waits[math.ceil(0.8 * len(waits)) - 1] * 1e3
