"""jamba-1.5-large-398b — the assigned config of
``repro/configs/jamba_1_5_large_398b.py``: periods of 8 layers, attention
at in-period position 4 and Mamba blocks elsewhere, a 16-expert MoE at
every odd layer."""
from repro_torch.configs._reduce import _reduce
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536,
    moe_experts=16, moe_topk=2, moe_every=2, moe_offset=1,
    attn_every=8, attn_offset=4, scan_group=8,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
)


def reduced() -> ModelConfig:
    """Tiny same-family config for CPU tests."""
    return _reduce(CONFIG)
