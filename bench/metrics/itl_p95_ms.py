"""95th percentile of the gap between output tokens: every output token
after a request's first, each taking the wall time of the tick that
produced it (host clock), so the tick walls weighted by their decoding
rows. Nearest rank over the window's tokens."""
import math

UNIT = "ms"


def read(rec):
    if rec.get("kind") != "serve":
        return None
    pairs = sorted((t["wall_s"], t["decode_rows"]) for t in rec["ticks"]
                   if t["decode_rows"])
    total = sum(n for _, n in pairs)
    if not total:
        return None
    rank = math.ceil(0.95 * total)
    seen = 0
    for wall, n in pairs:
        seen += n
        if seen >= rank:
            return wall * 1e3
