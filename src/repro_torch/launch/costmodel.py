"""Analytic serving roofline: the terms the serving cost model is seeded
from.

Counterpart of the parameter counting of every family and the serving
terms of ``repro/launch/costmodel.py`` (``layer_param_macs``,
``stack_macs_per_token``, ``total_params``, ``_attn_layers``,
``mixer_state_macs``, the recurrent-state term of ``hbm_decode``,
``serve_weight_stream_bytes``, ``serve_attn_read_span``,
``serve_attn_bytes_per_row``, ``serve_roofline_terms``), with the same
floats for the same config. They are a tested contract: the engine's
measured ``stats()["weight_bytes"]`` and ``attn_read_bytes`` agree with
them (``tests/test_torch_costmodel.py``). The training, dry-run and
collective terms are not ported yet (ROADMAP A.10).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.formats import get_format
from repro_torch.models.common import ModelConfig


WKV_CHUNK = 64       # models/rwkv.py
DECAY_LORA = 64


def layer_param_macs(cfg: ModelConfig, j: int) -> Dict[str, float]:
    """MAC-relevant weight sizes (= params in matmuls) of in-group layer
    ``j``: attention, or a Mamba block's in_proj, x_proj, dt_w and
    out_proj; then the MLP (SwiGLU: gate, up, down; gelu: up, down) or the
    MoE layer's router, active experts (top-k) and all experts. An RWKV
    layer (family "ssm"): the time mix's five projections and decay LoRA,
    the channel mix's three projections."""
    d, hd = cfg.d_model, cfg.hd
    if cfg.family == "ssm":
        return {"rwkv_time": 5 * d * d + 2 * d * DECAY_LORA,
                "rwkv_channel": 2 * d * cfg.d_ff + d * d}
    if cfg.is_attn_layer(j):
        out = {"attn": d * (cfg.n_heads * hd) * 2
               + d * (cfg.n_kv_heads * hd) * 2}
    else:
        di, n, dtr = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.dt_rank
        out = {"mamba": d * 2 * di + di * (dtr + 2 * n) + dtr * di + di * d}
    if cfg.is_moe_layer(j):
        out["router"] = d * cfg.moe_experts
        out["moe_active"] = cfg.moe_topk * 3 * d * cfg.d_ff
        out["moe_total"] = cfg.moe_experts * 3 * d * cfg.d_ff
    else:
        out["mlp"] = (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff
    return out


def _cross_params(cfg: ModelConfig) -> float:
    """One encoder-decoder decoder layer's cross-attention K/V and
    (``total_params``) its query and output, per the reference."""
    return cfg.d_model * cfg.n_heads * cfg.hd \
        + 2 * cfg.d_model * cfg.n_kv_heads * cfg.hd


def stack_macs_per_token(cfg: ModelConfig, active: bool = True) -> float:
    """Matmul MACs per token over the stack (active experts only unless
    ``active=False`` drops them); an encoder-decoder's decoder layers add
    their cross attention, its encoder counted apart by the callers."""
    per_group = 0.0
    for j in range(cfg.scan_group):
        for k, v in layer_param_macs(cfg, j).items():
            if k == "moe_total" or (k == "moe_active" and not active):
                continue
            per_group += v
    total = per_group * cfg.n_groups
    if cfg.family == "encdec":
        total += cfg.n_layers * _cross_params(cfg)
    return total


def total_params(cfg: ModelConfig) -> float:
    """Every matmul weight of the stack (every expert) plus the embeddings
    (and the head when untied); an encoder-decoder adds its encoder and
    its decoder layers' cross attention."""
    per_group = 0.0
    for j in range(cfg.scan_group):
        for k, v in layer_param_macs(cfg, j).items():
            if k == "moe_active":
                continue
            per_group += v
    stack = per_group * cfg.n_groups
    if cfg.family == "encdec":
        d = cfg.d_model
        enc = cfg.enc_layers * (2 * d * cfg.n_heads * cfg.hd
                                + 2 * d * cfg.n_kv_heads * cfg.hd
                                + 2 * d * cfg.d_ff)
        cross = cfg.n_layers * (d * cfg.n_heads * cfg.hd * 2
                                + 2 * d * cfg.n_kv_heads * cfg.hd)
        stack += enc + cross
    embed = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return stack + embed


def _attn_layers(cfg: ModelConfig) -> int:
    return sum(1 for j in range(cfg.scan_group)
               if cfg.is_attn_layer(j)) * cfg.n_groups


def mixer_state_macs(cfg: ModelConfig, s: int, batch: int) -> float:
    """The Mamba scan's or the RWKV WKV recurrence's MACs beyond the
    weight products for one pass over ``s`` tokens of ``batch`` rows."""
    total = 0.0
    if cfg.family == "hybrid":
        n_mamba = (cfg.scan_group - sum(
            1 for j in range(cfg.scan_group) if cfg.is_attn_layer(j))) \
            * cfg.n_groups
        total += 5.0 * batch * s * cfg.mamba_d_inner * cfg.mamba_d_state \
            * n_mamba
    if cfg.family == "ssm":
        per_tok = cfg.d_model * (4 * cfg.rwkv_head_dim + 3 * WKV_CHUNK)
        total += batch * s * per_tok * cfg.n_layers
    return total


def decode_state_bytes(cfg: ModelConfig, b_local: float,
                       n_model: int = 1) -> float:
    """The recurrent-state term of the reference's ``hbm_decode``: bytes a
    decode step reads and writes of the f32 state (RWKV's WKV matrices,
    a hybrid's Mamba ``h``) for ``b_local`` rows; 0 for attention-only
    stacks. The reference counts no shift or conv state."""
    if cfg.family == "ssm":
        hh = cfg.d_model // cfg.rwkv_head_dim
        return cfg.n_layers * hh * cfg.rwkv_head_dim ** 2 * 4 * b_local * 2
    if cfg.family == "hybrid":
        n_mamba = cfg.n_layers - _attn_layers(cfg)
        return n_mamba * cfg.mamba_d_inner * cfg.mamba_d_state * 4 \
            * b_local * 2 / n_model
    return 0.0


def _itemsize(cfg: ModelConfig) -> int:
    return torch.empty((), dtype=cfg.compute_dtype).element_size()


def serve_weight_stream_bytes(cfg: ModelConfig, fmt_name: str,
                              block_size: int = 32) -> float:
    """Bytes one decode tick streams for the packed serving tree at
    ``fmt_name``: codes and E8M0 scales for the quantized stack, raw
    embeddings at ``cfg.compute_dtype`` (the ``"bf16"`` pseudo-format is
    the dense tree). Norm vectors and biases are dropped: O(d_model). A MoE
    layer counts every expert (decode's capacity of 1 runs each expert on
    every row) and its router at the code width, as the reference does; so
    does a Mamba block's ``dt_w``, which the tree keeps raw, and its
    packed ``A_log`` (d_inner x N per layer) is not counted: both are
    under 0.1% of a jamba layer's bytes."""
    item = _itemsize(cfg)
    embed = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    stack = total_params(cfg) - embed
    if fmt_name == "bf16":
        return (stack + embed) * item
    fmt = get_format(fmt_name, block_size)
    code_bytes = 0.5 if (fmt.kind == "int" and fmt.bits == 4) else 1.0
    return stack * (code_bytes + 1.0 / block_size) + embed * item


def mamba_leaf_bytes(cfg: ModelConfig, fmt_name: str,
                     block_size: int = 32) -> float:
    """The bytes of a hybrid stack's Mamba leaves that
    ``serve_weight_stream_bytes`` (the reference's term, kept equal to it)
    does not count as the served tree holds them: the raw ``conv_w``,
    ``conv_b``, ``dt_bias`` and ``D``, ``dt_w`` at its raw width less the
    code width the term gives it, and the packed ``A_log`` (codes and
    scales); 0 with no Mamba layer. The engine's measured weight bytes
    are the sum of the two (``tests/test_torch_costmodel.py``)."""
    n_mamba = sum(not cfg.is_attn_layer(j)
                  for j in range(cfg.scan_group)) * cfg.n_groups
    if cfg.family != "hybrid" or fmt_name == "bf16":
        return 0.0
    item = _itemsize(cfg)
    di, n, kc, dtr = cfg.mamba_d_inner, cfg.mamba_d_state, \
        cfg.mamba_d_conv, cfg.dt_rank
    fmt = get_format(fmt_name, block_size)
    code_bytes = 0.5 if (fmt.kind == "int" and fmt.bits == 4) else 1.0
    per_code = code_bytes + 1.0 / block_size
    per_layer = (kc * di + 3 * di) * item + dtr * di * (item - per_code) \
        + di * n * per_code
    return per_layer * n_mamba


def rwkv_leaf_bytes(cfg: ModelConfig, fmt_name: str,
                    block_size: int = 32) -> float:
    """The bytes of an RWKV stack's leaves that
    ``serve_weight_stream_bytes`` (the reference's term, kept equal to it)
    does not count as the served tree holds them: the raw decay LoRA at
    its raw width less the code width the term gives it, the raw
    ``decay_base``, ``bonus`` and ``ln_scale``, and the seven ``mix_*``
    lerp vectors, raw or, when the layer count is a multiple of the block
    (rwkv6-7b's 32, ROADMAP C.11), packed along the layer axis; 0 for
    other families. The engine's measured weight bytes are the sum of the
    two (``tests/test_torch_costmodel.py``)."""
    if cfg.family != "ssm" or fmt_name == "bf16":
        return 0.0
    item = _itemsize(cfg)
    d = cfg.d_model
    fmt = get_format(fmt_name, block_size)
    code_bytes = 0.5 if (fmt.kind == "int" and fmt.bits == 4) else 1.0
    per_code = code_bytes + 1.0 / block_size
    mix = per_code if cfg.n_groups % block_size == 0 else item
    per_layer = 2 * d * DECAY_LORA * (item - per_code) + 3 * d * item \
        + 7 * d * mix
    return per_layer * cfg.n_layers


def serve_attn_read_span(cfg: ModelConfig, max_len: int,
                         kv_layout: str = "dense",
                         kv_page_size: int = 16) -> int:
    """KV tokens one gather-path decode read spans per batch row:
    ``max_len`` plus the vision prefix on the dense layout, the block
    table's page span over both on the paged one (the paged kernels read
    only the live pages; the engine counts those)."""
    logical = max_len + cfg.vision_tokens
    if kv_layout == "paged":
        return -(-logical // kv_page_size) * kv_page_size
    return logical


def serve_attn_bytes_per_row(cfg: ModelConfig, span_tokens: int) -> float:
    """Bytes one decode row's attention reads per tick over ``span_tokens``
    KV positions: K and V at ``cfg.compute_dtype`` in every attention
    layer (the engine's ``attn_read_bytes`` multiplier)."""
    return float(span_tokens) * _attn_layers(cfg) * 2 \
        * cfg.n_kv_heads * cfg.hd * _itemsize(cfg)


def serve_roofline_terms(cfg: ModelConfig, formats,
                         *, max_len: int, kv_layout: str = "dense",
                         kv_page_size: int = 16, block_size: int = 32,
                         n_model: int = 1) -> Dict[str, Dict[str, float]]:
    """``{fmt: {"weight_bytes", "attn_bytes_per_row"}}`` per decode tick:
    the weights stream once per tick, the attention read grows with the
    live rows. ``n_model`` tensor-parallel shards divide both terms (the
    roofline is per card)."""
    if n_model < 1:
        raise ValueError(f"n_model ({n_model}) must be >= 1")
    span = serve_attn_read_span(cfg, max_len, kv_layout, kv_page_size)
    attn = serve_attn_bytes_per_row(cfg, span) / n_model
    return {f: {"weight_bytes":
                serve_weight_stream_bytes(cfg, f, block_size) / n_model,
                "attn_bytes_per_row": attn}
            for f in formats}
