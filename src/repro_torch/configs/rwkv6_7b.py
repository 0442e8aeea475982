"""rwkv6-7b — the assigned config of ``repro/configs/rwkv6_7b.py``: 32
RWKV6 layers (time mix of 64 heads of 64, channel mix of 14336)."""
from repro_torch.configs._reduce import _reduce
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
    d_ff=14336, vocab=65536,
    rwkv_head_dim=64,
)


def reduced() -> ModelConfig:
    """Tiny same-family config for CPU tests."""
    return _reduce(CONFIG)
