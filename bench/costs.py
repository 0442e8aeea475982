"""The benchmark's yardstick: one H100's peaks, and the operations and bytes
of each piece of work, from shapes alone.

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit: a
share of them is reported with the card's power limit beside it, since a
card set lower runs slower. The arithmetic is a frozen copy of what the
program's ``launch/costmodel.py`` computes (2 operations a multiply-add;
weights, activations and the KV cache each read once), kept here so that no
change to the program moves the yardstick.

Byte counts: an MXINT-b weight is b / 8 bytes an element plus one E8M0 byte
a block of 32; activations are bf16 in and f32 out of the quantized GEMM
(B1/B2); the KV cache is bf16.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

HBM_BYTES_S = 3.35e12       # bytes/s
PEAK_BF16 = 989e12          # dense bf16 tensor-core operations/s
BLOCK = 32
ACT_IN, ACT_OUT, KV = 2, 4, 2


def fmt_bits(fmt: str) -> int:
    return int(fmt[len("mxint"):])


def weight_bytes(k: int, n: int, fmt: str) -> float:
    return k * n * fmt_bits(fmt) / 8 + k * n / BLOCK


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16, nbytes / HBM_BYTES_S)


def dims(cfg: Dict) -> Tuple[int, int, int, int, int, int]:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return (d, h, cfg["num_key_value_heads"], d // h,
            cfg["intermediate_size"], cfg["vocab_size"])


def projections(cfg: Dict) -> List[Tuple[str, int, int, int]]:
    """[(name, K, N, copies)] of one layer's quantized projections;
    ``copies`` counts the experts of a sparse layer."""
    d, h, hkv, hd, f, _ = dims(cfg)
    out = [("wq", d, h * hd, 1), ("wk", d, hkv * hd, 1),
           ("wv", d, hkv * hd, 1), ("wo", h * hd, d, 1)]
    e = cfg.get("num_local_experts", 0)
    if e:
        return out + [("w_gate", d, f, e), ("w_up", d, f, e),
                      ("w_down", f, d, e)]
    if cfg["act"] == "swiglu":
        out.append(("w_gate", d, f, 1))
    return out + [("w_up", d, f, 1), ("w_down", f, d, 1)]


def gemm_launch(m: int, k: int, n: int, fmt: str) -> Tuple[float, float]:
    """(operations, bytes) of one quantized GEMM launch of M rows."""
    return 2.0 * m * k * n, weight_bytes(k, n, fmt) + m * k * ACT_IN \
        + m * n * ACT_OUT


def layer_gemms(cfg: Dict, fmt: str, rows: int, expert_rows: int
                ) -> Tuple[float, float]:
    """One layer's B1/B2 launches: every projection at ``rows`` rows; a
    sparse layer's experts each at ``expert_rows``."""
    fl = by = 0.0
    for _, k, n, copies in projections(cfg):
        m = expert_rows if copies > 1 else rows
        for _ in range(copies):
            a, b = gemm_launch(m, k, n, fmt)
            fl, by = fl + a, by + b
    return fl, by


def attended(pos: int, window) -> int:
    """Keys a query at position ``pos`` reads (its own included)."""
    return pos + 1 if not window else min(pos + 1, window)


def _pairs(a: int, b: int, w) -> float:
    """sum of min(n, w) for n = a .. b (w None: no window)."""
    m = b if not w else min(b, w)
    s = (a + m) * (m - a + 1) / 2 if m >= a else 0.0
    if w and b > w:
        s += (b - max(a - 1, w)) * w
    return s


def attn_launch(cfg: Dict, rows: Iterable[Tuple[int, int]]
                ) -> Tuple[float, float]:
    """One layer's paged attention over ``rows`` of (cursor, queries): the
    queries sit at positions cursor .. cursor + queries - 1. Each row reads
    the K/V its queries attend to once (the union of their windows), its
    queries and writes its outputs."""
    d, h, hkv, hd, _, _ = dims(cfg)
    w = cfg.get("sliding_window")
    fl = by = 0.0
    for cur, q in rows:
        last = cur + q - 1
        lo = 0 if not w else max(0, cur - w + 1)
        keys = last + 1 - lo
        pairs = _pairs(cur + 1, cur + q, w)
        fl += 4.0 * h * hd * pairs
        by += 2 * keys * hkv * hd * KV + 2 * q * h * hd * ACT_IN
    return fl, by


def active_params(cfg: Dict) -> float:
    """Parameters a token's forward multiplies by: every projection of a
    dense layer (k of the experts of a sparse one, and its router), and the
    head."""
    d, _, _, _, f, v = dims(cfg)
    per = 0.0
    e = cfg.get("num_local_experts", 0)
    for _, k, n, copies in projections(cfg):
        per += k * n * (cfg["num_experts_per_tok"] if copies > 1 else 1)
    if e:
        per += d * e
    return cfg["num_hidden_layers"] * per + d * v


def stream_bytes(cfg: Dict, fmt: str) -> float:
    """Bytes of weights a serving step reads once: every quantized
    projection at ``fmt``, every expert included, and the f32 head."""
    d, _, _, _, _, v = dims(cfg)
    w = sum(weight_bytes(k, n, fmt) * c for _, k, n, c in projections(cfg))
    return cfg["num_hidden_layers"] * w + d * v * 4

