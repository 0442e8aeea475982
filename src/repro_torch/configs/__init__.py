"""Model configs the port serves; ``get_config(id)`` / ``get_reduced(id)``.

Same ids, widths and reduced test widths as ``repro/configs``.
"""
import importlib
from typing import List

from repro_torch.models.common import ModelConfig

_MODULES = {
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen2-72b": "qwen2_72b",
    "qwen3-4b": "qwen3_4b",
    "rwkv6-7b": "rwkv6_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "smollm-135m": "smollm_135m",
    "starcoder2-3b": "starcoder2_3b",
}


def list_archs() -> List[str]:
    return sorted(_MODULES)


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{list_archs()}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _mod(name).reduced()
