"""Output tokens emitted in the window, every one, over the window's length
(host clock)."""
UNIT = "tokens/s"


def read(rec):
    if rec.get("kind") != "serve" or rec["window_s"] <= 0:
        return None
    return rec["tokens_out"] / rec["window_s"]
