"""The model families: ``get_model(cfg)`` picks the encoder-decoder stack
(``models/encdec.py``) for family ``"encdec"`` and the decoder-only stack
(``models/transformer.py``) for the others, as ``repro/models`` does;
``param_shapes(cfg)`` is the chosen family's parameter tree and
``param_axes(cfg)`` its leaves' logical axes."""
from typing import Callable, Dict, Optional

from repro_torch.core.qat import QATConfig
from repro_torch.models.common import ModelConfig


def get_model(cfg: ModelConfig, qat: Optional[QATConfig] = None,
              qmm: Optional[Callable] = None, dp=None):
    if cfg.family == "encdec":
        from repro_torch.models import encdec
        return encdec.make_model(cfg, qmm, qat=qat, dp=dp)
    from repro_torch.models import transformer
    return transformer.make_model(cfg, qmm, qat=qat, dp=dp)


def param_shapes(cfg: ModelConfig) -> Dict:
    if cfg.family == "encdec":
        from repro_torch.models import encdec
        return encdec.param_shapes(cfg)
    from repro_torch.models import transformer
    return transformer.param_shapes(cfg)


def param_axes(cfg: ModelConfig) -> Dict:
    if cfg.family == "encdec":
        from repro_torch.models import encdec
        return encdec.param_axes(cfg)
    from repro_torch.models import transformer
    return transformer.param_axes(cfg)
