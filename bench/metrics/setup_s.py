"""Process start to the window's first tick (host clock): weights, the
anchor, the engine, the warm-up of every shape the cell uses, and what the
traffic needs before the window opens."""
UNIT = "s"


def read(rec):
    return rec.get("setup_s")
