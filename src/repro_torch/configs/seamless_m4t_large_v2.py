"""seamless-m4t-large-v2 — the assigned config of
``repro/configs/seamless_m4t_large_v2.py``: a 24-layer bidirectional
encoder over frame embeddings and a 24-layer decoder with cross attention,
gelu MLPs."""
from repro_torch.configs._reduce import _reduce
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206,
    act="gelu", enc_layers=24, audio_downsample=4,
)


def reduced() -> ModelConfig:
    """Tiny same-family config for CPU tests."""
    return _reduce(CONFIG)
