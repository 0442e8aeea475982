"""llava-next-mistral-7b — the assigned config of
``repro/configs/llava_next_mistral_7b.py``: the mistral-7b backbone behind a
prefix of 2,880 image embeddings (anyres: 5 tiles x 576 patch embeds; the
vision frontend is a stub, so a batch carries the embeddings)."""
from repro_torch.configs._reduce import _reduce
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000,
    vision_tokens=2880,
    rope_theta=1e6,
)


def reduced() -> ModelConfig:
    """Tiny same-family config for CPU tests."""
    return _reduce(CONFIG)
