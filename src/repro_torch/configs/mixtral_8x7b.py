"""mixtral-8x7b — the assigned config of ``repro/configs/mixtral_8x7b.py``."""
from repro_torch.configs._reduce import _reduce
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000,
    moe_experts=8, moe_topk=2, sliding_window=4096,
    rope_theta=1e6,
)


def reduced() -> ModelConfig:
    """Tiny same-family config for CPU tests."""
    return _reduce(CONFIG)
