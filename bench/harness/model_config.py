"""A configuration file as the program's model config.

The file's keys are the published ``config.json``'s, as run (``reduced``
names those that differ from the source), plus the keys every part of the
benchmark reads: ``act`` ("gelu" or "swiglu"), ``qkv_bias``, ``mlp_bias``,
``norm_eps`` and, for sparse experts, ``capacity_factor``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


def port_config(cfg: Dict):
    from repro_torch.configs import get_config
    base = get_config(cfg["port_arch"])
    upd = dict(n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
               n_heads=cfg["num_attention_heads"],
               n_kv_heads=cfg["num_key_value_heads"], head_dim=0,
               d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
               rope_theta=float(cfg["rope_theta"]),
               sliding_window=cfg.get("sliding_window"),
               norm_eps=cfg["norm_eps"], act=cfg["act"],
               qkv_bias=cfg["qkv_bias"], mlp_bias=cfg["mlp_bias"],
               scan_group=1)
    if "compute_dtype" in cfg:
        import torch
        upd["compute_dtype"] = getattr(torch, cfg["compute_dtype"])
    if cfg.get("num_local_experts"):
        upd.update(moe_experts=cfg["num_local_experts"],
                   moe_topk=cfg["num_experts_per_tok"],
                   capacity_factor=float(cfg["capacity_factor"]),
                   router_aux_coef=float(cfg["router_aux_loss_coef"]))
    return dataclasses.replace(base, **upd)
