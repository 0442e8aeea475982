"""Reduced same-family configs for CPU tests (the widths and rules of
``repro/configs/_reduce.py``, in float32): MoE configs keep 4 experts, the
hybrid one 4 layers in one scan group (attention at position 2, MoE at the
odd positions, d_state 4), the RWKV one 4 heads of 16, the
encoder-decoder one 2 + 2 layers of 4 K/V heads, the vision-language one a
24-token prefix, and a config with a sliding window gets a window of 32."""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig


def _reduce(cfg: ModelConfig) -> ModelConfig:
    upd = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
               vocab=512, compute_dtype=torch.float32, seq_chunk=64,
               n_layers=2)
    if cfg.family == "moe":
        upd.update(moe_experts=4)
    elif cfg.family == "hybrid":
        upd.update(moe_experts=4, moe_every=2, moe_offset=1, attn_every=4,
                   attn_offset=2, scan_group=4, n_layers=4, mamba_d_state=4)
    elif cfg.family == "ssm":
        upd.update(n_kv_heads=4, rwkv_head_dim=16)
    elif cfg.family == "encdec":
        upd.update(enc_layers=2, n_kv_heads=4)
    elif cfg.family == "vlm":
        upd.update(vision_tokens=24)
    if cfg.sliding_window is not None:
        upd["sliding_window"] = 32
    return dataclasses.replace(cfg, **upd)
