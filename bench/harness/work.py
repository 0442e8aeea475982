"""The work of one serving tick, from the cell's shapes and the tick's rows,
in the frozen arithmetic of ``bench/costs.py``.

A tick runs one executable (a decode step over every slot, a prompt chunk
alone, or under the mixed scheduler one step that pads every slot's row to
the chunk's width) or, under the sequential scheduler, a chunk and then a
decode step. Each is counted as launched: every quantized projection of
every layer at the executable's rows (a sparse layer's experts at the rows
its capacity rule gives each), and attention over the rows that hold
queries. Decode and mixed steps attend through the paged kernels (B3 /
B4: ``attn``); a chunk that runs alone attends through PyTorch over the
gathered cache view (``models/layers.py::prefill_attention``), which is
no paged kernel's work. The model's own work (``model``) counts only real
tokens: decode rows and the chunk's tokens, with the weights streamed once
an executable.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from bench import costs


def _cap(cfg: Dict, s: int) -> int:
    e = cfg.get("num_local_experts", 0)
    if not e:
        return s
    return max(1, min(s, int(cfg["capacity_factor"] * s
                             * cfg["num_experts_per_tok"] / e)))


def executables(rec: Dict, tick: Dict) -> List[Tuple[int, int, list,
                                                     list]]:
    """[(rows, expert rows, paged-kernel attention rows, other attention
    rows)], attention rows as (cursor, queries)."""
    b = rec["slots"]
    dec = [(int(p), 1) for p in tick["decode_pos"]]
    ch = tick["chunk"]
    cfg = rec["cfg"]
    out = []
    if ch is not None:
        start, take, padded = ch
        if tick["decode"] and rec["scheduler"] == "mixed":
            return [(b * padded, b * _cap(cfg, padded),
                     dec + [(start, take)], [])]
        out.append((padded, _cap(cfg, padded), [], [(start, take)]))
    if tick["decode"]:
        out.append((b, b * _cap(cfg, 1), dec, []))
    return out


def tick_work(rec: Dict, tick: Dict) -> Dict[str, Tuple[float, float]]:
    """{"gemm", "attn", "model"}: (operations, bytes) of the tick."""
    cfg, fmt = rec["cfg"], rec["fmt"]
    layers = cfg["num_hidden_layers"]
    g = [0.0, 0.0]
    a = [0.0, 0.0]
    other = [0.0, 0.0]
    ex = executables(rec, tick)
    for rows, erows, paged, plain in ex:
        fl, by = costs.layer_gemms(cfg, fmt, rows, erows)
        g[0] += layers * fl
        g[1] += layers * by
        for acc, arows in ((a, paged), (other, plain)):
            fl, by = costs.attn_launch(cfg, arows)
            acc[0] += layers * fl
            acc[1] += layers * by
    tokens = len(tick["decode_pos"]) + (tick["chunk"][1] if tick["chunk"]
                                        else 0)
    model_fl = 2.0 * costs.active_params(cfg) * tokens + a[0] + other[0]
    model_by = costs.stream_bytes(cfg, fmt) * len(ex) + a[1] + other[1]
    return {"gemm": tuple(g), "attn": tuple(a), "model": (model_fl,
                                                         model_by)}


def bound_sum(rec: Dict, part: str) -> float:
    """Seconds the chip needs at least for ``part`` over the window."""
    return sum(costs.bound_s(*tick_work(rec, t)[part]) for t in rec["ticks"])
