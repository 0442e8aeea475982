"""Ticks in the window (a fixture: a metric added as a file of its own)."""
UNIT = "ticks"


def read(rec):
    return len(rec["ticks"]) if rec.get("ticks") else None
