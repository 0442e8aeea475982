"""Analytic per-(arch x shape x mesh) cost model: the roofline's terms,
and the serving terms the serving cost model is seeded from.

Counterpart of ``repro/launch/costmodel.py``, with the same floats for the
same config, the reference's approximations included (the fake-quant
overhead of ``flops_train`` counts four MXINT formats whatever the
schedule; the ``logits`` term of ``collectives_decode`` and the MoE
all-to-all of ``collectives_train`` are not zero on one card):

- parameter counting of every family: ``layer_param_macs``,
  ``stack_macs_per_token``, ``total_params``, ``active_params``;
- the entry points' flops (``flops_train`` / ``_prefill`` / ``_decode``,
  from ``attn_score_macs`` and ``mixer_state_macs``), HBM bytes per card
  (``hbm_train`` / ``_prefill`` / ``_decode``), collective bytes per card
  (``collectives_train`` / ``_decode`` / ``_prefill``) over a ``MeshDesc``,
  and ``roofline``, which divides them by the H100's constants
  (``launch/mesh.py``);
- the serving terms: ``serve_weight_stream_bytes``,
  ``serve_attn_read_span``, ``serve_attn_bytes_per_row``,
  ``serve_roofline_terms``. They are a tested contract: the engine's
  measured ``stats()["weight_bytes"]`` and ``attn_read_bytes`` agree with
  them (``tests/test_torch_costmodel.py``).

Conventions, as the reference's: FLOPs count multiply + add as 2; a
training step is ``TRAIN_MM_FACTOR`` (8: forward, backward at twice the
forward, and remat's second forward) over 2 times one forward's flops;
flash attention costs the full S x S_kv rectangle (the banded sliding
window S x min(S, W + chunk)). The dry run's records
(``launch/dryrun.py``) are put beside these terms by
``tools/dryrun_table.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.shapes import ShapeSpec, decode_cache_len
from repro_torch.core.formats import get_format
from repro_torch.models.common import ModelConfig


WKV_CHUNK = 64       # models/rwkv.py
DECAY_LORA = 64
TRAIN_MM_FACTOR = 8.0     # fwd + bwd(2x) + remat refwd
FWD_ONLY = 2.0            # fwd matmul flops = 2 * MACs; factor on MACs
ACT_BYTES_PER_LAYER_CONST = 14   # resid/norm/qkv/attnout/mlp traffic, bf16


@dataclasses.dataclass(frozen=True)
class MeshDesc:
    pod: int = 1
    data: int = 16
    model: int = 16

    @property
    def chips(self) -> int:
        return self.pod * self.data * self.model

    @property
    def dp(self) -> int:
        return self.pod * self.data


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


def active_params(cfg: ModelConfig) -> float:
    """The weights one token runs through (top-k experts, no encoder or
    cross attention, as the reference counts them) plus the embeddings."""
    per_group = 0.0
    for j in range(cfg.scan_group):
        for k, v in layer_param_macs(cfg, j).items():
            if k == "moe_total":
                continue
            per_group += v
    stack = per_group * cfg.n_groups
    embed = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return stack + embed


def _attn_layers(cfg: ModelConfig) -> int:
    return sum(1 for j in range(cfg.scan_group)
               if cfg.is_attn_layer(j)) * cfg.n_groups


def attn_score_macs(cfg: ModelConfig, sq: int, skv: int, batch: int) -> float:
    """Score and P.V MACs for one pass over all attention layers: ``sq``
    queries against ``skv`` keys (the sliding window's band where it
    bites)."""
    if cfg.family == "ssm":
        return 0.0
    if cfg.sliding_window is not None and skv > cfg.sliding_window:
        skv_eff = min(skv, cfg.sliding_window + min(cfg.seq_chunk, sq))
    else:
        skv_eff = skv
    per_layer = 2.0 * batch * cfg.n_heads * sq * skv_eff * cfg.hd
    return per_layer * _attn_layers(cfg)


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


def _encoder_macs(cfg: ModelConfig, b: int, se: int) -> float:
    return cfg.enc_layers * (2 * cfg.d_model * cfg.n_heads * cfg.hd
                             + 2 * cfg.d_model * cfg.n_kv_heads * cfg.hd
                             + 2 * cfg.d_model * cfg.d_ff) * b * se


def flops_train(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, float]:
    """One training step's flops: ``total`` (forward, backward and remat's
    second forward, plus the fake-quant pass), ``forward`` and
    ``model_flops`` (6 x active params x tokens)."""
    b, s = shape.global_batch, shape.seq_len
    tokens = b * s
    mm = stack_macs_per_token(cfg, active=True) * tokens
    if cfg.family == "encdec":
        se = s // max(cfg.audio_downsample, 1)
        mm += _encoder_macs(cfg, b, se)
        attn = attn_score_macs(cfg, s, s, b) \
            + attn_score_macs(cfg, se, se, b) \
            + 2.0 * b * cfg.n_heads * s * se * cfg.hd * cfg.n_layers
    elif cfg.family == "vlm":
        s_tot = s + cfg.vision_tokens
        mm = stack_macs_per_token(cfg) * b * s_tot
        attn = attn_score_macs(cfg, s_tot, s_tot, b)
    else:
        attn = attn_score_macs(cfg, s, s, b)
    head = cfg.d_model * cfg.vocab * tokens
    mixer = mixer_state_macs(cfg, s, b)
    fwd2 = FWD_ONLY * (mm + attn + head + mixer)      # flops of one forward
    total = TRAIN_MM_FACTOR / FWD_ONLY * fwd2
    qat_overhead = 10.0 * active_params(cfg) * len(
        ("mxint2", "mxint4", "mxint6", "mxint8")) / 4.0   # fake-quant pass
    model_flops = 6.0 * active_params(cfg) * tokens
    return {"total": total + qat_overhead, "forward": fwd2,
            "model_flops": model_flops}


def flops_prefill(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, float]:
    """A prefill of ``global_batch`` prompts of ``seq_len`` tokens (the
    head at the last position only)."""
    b, s = shape.global_batch, shape.seq_len
    tokens = b * s
    mm = stack_macs_per_token(cfg) * tokens
    if cfg.family == "vlm":
        s_tot = s + cfg.vision_tokens
        mm = stack_macs_per_token(cfg) * b * s_tot
        attn = attn_score_macs(cfg, s_tot, s_tot, b)
    elif cfg.family == "encdec":
        se = s // max(cfg.audio_downsample, 1)
        mm += _encoder_macs(cfg, b, se)
        attn = attn_score_macs(cfg, s, s, b) + attn_score_macs(cfg, se, se, b)\
            + 2.0 * b * cfg.n_heads * s * se * cfg.hd * cfg.n_layers
    else:
        attn = attn_score_macs(cfg, s, s, b)
    head = cfg.d_model * cfg.vocab * b            # last position only
    mixer = mixer_state_macs(cfg, s, b)
    total = FWD_ONLY * (mm + attn + head + mixer)
    return {"total": total,
            "model_flops": 2.0 * active_params(cfg) * tokens}


def flops_decode(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, float]:
    """One decode step of ``global_batch`` rows against the cache."""
    b = shape.global_batch
    cache = decode_cache_len(cfg, shape)
    mm = stack_macs_per_token(cfg) * b            # 1 token
    attn = attn_score_macs(cfg, 1, cache, b)
    head = cfg.d_model * cfg.vocab * b
    mixer = mixer_state_macs(cfg, 1, b)
    total = FWD_ONLY * (mm + attn + head + mixer)
    return {"total": total,
            "model_flops": 2.0 * active_params(cfg) * b}


def hbm_train(cfg: ModelConfig, shape: ShapeSpec, mesh: MeshDesc) -> float:
    """HBM bytes per card of one training step: the f32 master read, the
    fake-quant write and read, the gradient, AdamW's moments and remat's
    weight re-read, plus the activations forward and backward."""
    p_local = total_params(cfg) / mesh.chips
    param_traffic = p_local * (4 + 2 + 2 + 4 + 16 + 2)
    tokens_local = shape.global_batch * shape.seq_len / mesh.dp
    d_model_local = cfg.d_model    # activations replicated over model axis
    act = tokens_local * d_model_local * cfg.n_layers * \
        ACT_BYTES_PER_LAYER_CONST * 2   # fwd+bwd
    return param_traffic + act


def hbm_prefill(cfg: ModelConfig, shape: ShapeSpec, mesh: MeshDesc) -> float:
    """HBM bytes per card of a prefill: bf16 weights once, activations."""
    p_local = total_params(cfg) * 2 / mesh.chips     # bf16 serve weights
    tokens_local = shape.global_batch * shape.seq_len / mesh.dp
    act = tokens_local * cfg.d_model * cfg.n_layers * ACT_BYTES_PER_LAYER_CONST
    return p_local + act


def hbm_decode(cfg: ModelConfig, shape: ShapeSpec, mesh: MeshDesc,
               weight_bits: int = 16, weight_stationary: bool = False) -> float:
    """HBM bytes per card of a decode step: every local weight at
    ``weight_bits`` (sharded over every card, or over the model axis only
    when weight-stationary), this batch's KV shard and the recurrent
    state (``decode_state_bytes``)."""
    if weight_stationary:
        p_local = active_params(cfg) * weight_bits / 8 / mesh.model
    else:
        p_local = active_params(cfg) * weight_bits / 8 / mesh.chips
    cache = decode_cache_len(cfg, shape)
    b_local = max(shape.global_batch / mesh.dp, 1)
    kv = 2 * _attn_layers(cfg) * cfg.n_kv_heads * cfg.hd * cache * 2 \
        * b_local / mesh.model
    return p_local + kv + decode_state_bytes(cfg, b_local, mesh.model)


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


def collectives_train(cfg: ModelConfig, shape: ShapeSpec,
                      mesh: MeshDesc) -> Dict[str, float]:
    """Per-card cross-card bytes of a training step (ring estimates): the
    FSDP weight all-gathers and gradient reduce-scatter, the tensor-
    parallel activation all-reduces, the vocab-parallel loss's, and the
    MoE all-to-all where the experts divide the model axis."""
    p = total_params(cfg)
    fsdp_shards = mesh.dp
    ag = 3 * (p / mesh.model) * 2 * (fsdp_shards - 1) / fsdp_shards
    rs = (p / mesh.model) * 4 * (fsdp_shards - 1) / fsdp_shards
    tokens_local = shape.global_batch * shape.seq_len / mesh.dp
    tp_ar = 2 * cfg.n_layers * tokens_local * cfg.d_model * 2 * 3 \
        * 2 * (mesh.model - 1) / mesh.model
    ce = tokens_local * (8 + cfg.d_model * 4) * 2 * (mesh.model - 1) \
        / mesh.model
    a2a = 0.0
    if cfg.moe_experts and cfg.moe_experts % mesh.model == 0:
        n_moe = sum(1 for j in range(cfg.scan_group)
                    if cfg.is_moe_layer(j)) * cfg.n_groups
        a2a = 3 * n_moe * tokens_local * cfg.moe_topk * cfg.d_model * 2
    return {"all_gather": ag, "reduce_scatter": rs, "tp_allreduce": tp_ar,
            "ce": ce, "all_to_all": a2a,
            "total": ag + rs + tp_ar + ce + a2a}


def collectives_decode(cfg: ModelConfig, shape: ShapeSpec,
                       mesh: MeshDesc, weight_stationary: bool = False,
                       weight_bits: int = 16) -> Dict[str, float]:
    """Per-card cross-card bytes of a decode step: tensor-parallel
    activation all-reduces, the sequence-sharded attention's partials,
    the logits, and (FSDP layout) the per-layer partial sums over the data
    axis with a MoE's expert-operand gathers."""
    b_local = max(shape.global_batch / mesh.dp, 1)
    tp_ar = 2 * cfg.n_layers * b_local * cfg.d_model * 2 \
        * 2 * (mesh.model - 1) / mesh.model
    attn_ar = _attn_layers(cfg) * b_local * (cfg.n_heads * cfg.hd * 4 + 8) \
        * 2 * (mesh.model - 1) / mesh.model
    logits = b_local * cfg.vocab * 4 / mesh.model * 2
    fsdp_ar = 0.0
    if not weight_stationary and mesh.dp > 1:
        per_layer_acts = b_local * cfg.d_model * 4        # f32 partials
        matmuls_per_layer = 4 if cfg.moe_experts else 3
        fsdp_ar = cfg.n_layers * matmuls_per_layer * per_layer_acts \
            * 2 * (mesh.dp - 1) / mesh.dp
        if cfg.moe_experts:
            cap = max(1, int(cfg.capacity_factor * cfg.moe_topk
                             / cfg.moe_experts))
            fsdp_ar += cfg.n_layers * cfg.moe_experts * b_local * cap \
                * cfg.d_model * 4
    return {"tp_allreduce": tp_ar, "attn_psum": attn_ar, "logits": logits,
            "fsdp_allreduce": fsdp_ar,
            "total": tp_ar + attn_ar + logits + fsdp_ar}


def collectives_prefill(cfg: ModelConfig, shape: ShapeSpec,
                        mesh: MeshDesc) -> Dict[str, float]:
    """Per-card cross-card bytes of a prefill: tensor-parallel activation
    all-reduces and the bf16 weights' all-gather over the data axis."""
    tokens_local = shape.global_batch * shape.seq_len / mesh.dp
    tp_ar = 2 * cfg.n_layers * tokens_local * cfg.d_model * 2 \
        * 2 * (mesh.model - 1) / mesh.model
    wgt_ag = (total_params(cfg) / mesh.model) * 2 \
        * (mesh.dp - 1) / mesh.dp
    return {"tp_allreduce": tp_ar, "weight_allgather": wgt_ag,
            "total": tp_ar + wgt_ag}


def roofline(cfg: ModelConfig, shape: ShapeSpec, mesh: MeshDesc,
             weight_bits_decode: int = 16,
             weight_stationary: bool = False) -> Dict[str, float]:
    """The entry point of ``shape.kind`` on ``mesh``: its flops, bytes and
    collective bytes, and their times on H100s (``launch/mesh.py``):
    ``step_time_lower_bound`` is the largest of the three, ``dominant``
    names it."""
    from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
    if shape.kind == "train":
        fl = flops_train(cfg, shape)
        hbm = hbm_train(cfg, shape, mesh)
        coll = collectives_train(cfg, shape, mesh)
    elif shape.kind == "prefill":
        fl = flops_prefill(cfg, shape)
        hbm = hbm_prefill(cfg, shape, mesh)
        coll = collectives_prefill(cfg, shape, mesh)
    else:
        fl = flops_decode(cfg, shape)
        hbm = hbm_decode(cfg, shape, mesh, weight_bits_decode,
                         weight_stationary=weight_stationary)
        coll = collectives_decode(cfg, shape, mesh,
                                  weight_stationary=weight_stationary,
                                  weight_bits=weight_bits_decode)
    t_comp = fl["total"] / mesh.chips / PEAK_FLOPS_BF16
    t_mem = hbm / HBM_BW
    t_coll = coll["total"] / LINK_BW
    dominant = max(("compute", t_comp), ("memory", t_mem),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    bound = max(t_comp, t_mem, t_coll)
    return {
        "flops_global": fl["total"],
        "model_flops": fl.get("model_flops", 0.0),
        "useful_ratio": fl.get("model_flops", 0.0) / max(fl["total"], 1.0),
        "hbm_bytes_per_dev": hbm,
        "coll_bytes_per_dev": coll["total"],
        "coll_breakdown": coll,
        "t_compute": t_comp, "t_memory": t_mem, "t_collective": t_coll,
        "dominant": dominant,
        "roofline_fraction": t_comp / bound if bound > 0 else 0.0,
        "step_time_lower_bound": bound,
    }
