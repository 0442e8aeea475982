"""Reduced same-family configs for CPU tests (the widths of
``repro/configs/_reduce.py``, in float32)."""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig


def _reduce(cfg: ModelConfig) -> ModelConfig:
    if cfg.family != "dense":
        raise ValueError(f"the port serves the dense family only, got "
                         f"{cfg.family!r}")
    return dataclasses.replace(
        cfg, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        vocab=512, compute_dtype=torch.float32, seq_chunk=64, n_layers=2)
