"""Mean live decoding rows over the slots, over the window's ticks that ran
a decode (or mixed) step (the engine's ``tick_trace``)."""
UNIT = "%"


def read(rec):
    if rec.get("kind") != "serve":
        return None
    rows = [t["decode_rows"] for t in rec["ticks"] if t["decode"]]
    if not rows:
        return None
    return 100.0 * sum(rows) / len(rows) / rec["slots"]
