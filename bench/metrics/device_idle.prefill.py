"""Share of the traced window in which no device activity ran
(``torch.profiler``: the union of kernels, copies and sets over the span of
the step ranges)."""
UNIT = "%"


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
