"""mixtral-8x22b — the assigned config of ``repro/configs/mixtral_8x22b.py``."""
from repro_torch.configs._reduce import _reduce
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768,
    moe_experts=8, moe_topk=2, sliding_window=4096,
    rope_theta=1e6,
)


def reduced() -> ModelConfig:
    """Tiny same-family config for CPU tests."""
    return _reduce(CONFIG)
