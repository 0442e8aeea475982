"""Seeded float32 weights of a configuration file, made on the device.

Each leaf is stacked over the layers and drawn in one call from a
``torch.Generator`` on the device, seeded from the run's seed and the leaf's
index, so a leaf can be made again alone (the reference does, after the
program's state is freed). Projections are normal with std 0.02 (the output
projections 0.02 / sqrt(layers)), biases normal with std 0.02, norm scales
1 + 0.1·normal. Names are dotted paths of the program's parameter tree, in
which every block leaf is stacked over the layers (one layer group).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def leaves(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """[(dotted name, shape, kind, std)]: kind "normal" or "scale"."""
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, f, v = d // h, cfg["intermediate_size"], cfg["vocab_size"]
    down = 0.02 / L ** 0.5
    out = [("embed", (v, d), "normal", 0.02),
           ("blocks.mixer_norm", (L, d), "scale", 0.1),
           ("blocks.ffn_norm", (L, d), "scale", 0.1),
           ("blocks.attn.wq", (L, d, h * hd), "normal", 0.02),
           ("blocks.attn.wk", (L, d, hkv * hd), "normal", 0.02),
           ("blocks.attn.wv", (L, d, hkv * hd), "normal", 0.02),
           ("blocks.attn.wo", (L, h * hd, d), "normal", down)]
    if cfg["qkv_bias"]:
        out += [("blocks.attn.bq", (L, h * hd), "normal", 0.02),
                ("blocks.attn.bk", (L, hkv * hd), "normal", 0.02),
                ("blocks.attn.bv", (L, hkv * hd), "normal", 0.02)]
    e = cfg.get("num_local_experts", 0)
    if e:
        out += [("blocks.moe.router", (L, d, e), "normal", 0.02),
                ("blocks.moe.experts.w_gate", (L, e, d, f), "normal", 0.02),
                ("blocks.moe.experts.w_up", (L, e, d, f), "normal", 0.02),
                ("blocks.moe.experts.w_down", (L, e, f, d), "normal", down)]
    elif cfg["act"] == "gelu":
        out += [("blocks.mlp.w_up", (L, d, f), "normal", 0.02),
                ("blocks.mlp.w_down", (L, f, d), "normal", down),
                ("blocks.mlp.b_up", (L, f), "normal", 0.02),
                ("blocks.mlp.b_down", (L, d), "normal", 0.02)]
    else:
        out += [("blocks.mlp.w_gate", (L, d, f), "normal", 0.02),
                ("blocks.mlp.w_up", (L, d, f), "normal", 0.02),
                ("blocks.mlp.w_down", (L, f, d), "normal", down)]
    out += [("final_norm", (d,), "scale", 0.1),
            ("lm_head", (d, v), "normal", 0.02)]
    return out


def make_leaf(seed: int, index: int, shape, kind: str, std: float,
              device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + index) % (2 ** 63))
    t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    t.mul_(std)
    if kind == "scale":
        t.add_(1.0)
    return t


def make(cfg: Dict, seed: int, device, names=None) -> Dict[str, torch.Tensor]:
    """{dotted name: float32 leaf} (only ``names``, when given)."""
    return {n: make_leaf(seed, i, s, k, std, device)
            for i, (n, s, k, std) in enumerate(leaves(cfg))
            if names is None or n in names}


def nest(name: str, t) -> Dict:
    """A dotted name as the program's tree: ``blocks`` is a list of one
    layer group."""
    parts = name.split(".")
    node = t
    for p in reversed(parts[1:]):
        node = {p: node}
    if parts[0] == "blocks":
        return {"blocks": [node]}
    return {parts[0]: node}
