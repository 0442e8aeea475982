"""qwen3-4b — the assigned config of ``repro/configs/qwen3_4b.py``."""
from repro_torch.configs._reduce import _reduce
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab=151936,
    head_dim=128, qk_norm=True, rope_theta=1e6,
)


def reduced() -> ModelConfig:
    """Tiny same-family config for CPU tests."""
    return _reduce(CONFIG)
