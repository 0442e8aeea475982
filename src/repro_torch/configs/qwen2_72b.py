"""qwen2-72b — the assigned config of ``repro/configs/qwen2_72b.py``."""
from repro_torch.configs._reduce import _reduce
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064,
    qkv_bias=True, rope_theta=1e6,
)


def reduced() -> ModelConfig:
    """Tiny same-family config for CPU tests."""
    return _reduce(CONFIG)
