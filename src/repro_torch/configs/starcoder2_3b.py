"""starcoder2-3b — the assigned config of ``repro/configs/starcoder2_3b.py``."""
from repro_torch.configs._reduce import _reduce
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab=49152,
    act="gelu", qkv_bias=True, mlp_bias=True, rope_theta=1e5,
)


def reduced() -> ModelConfig:
    """Tiny same-family config for CPU tests."""
    return _reduce(CONFIG)
