"""The parts of the MF-QAT configuration that serving needs (paper §3.2).

Counterpart of ``repro/core/qat.py`` limited to which weights are quantized
and along which axis; fake-quantization and training schedules belong to the
training path.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

from repro_torch.core.formats import MXFormat, get_format

# Anything that is not a >=2D matmul weight, plus embeddings/lm_head
# (paper §3.2) and modality frontends.
DEFAULT_EXCLUDE = (
    r"embed", r"lm_head", r"norm", r"bias", r"scale", r"rope",
    r"router",          # MoE router stays fp (standard practice)
    r"conv",            # mamba conv1d (tiny, sensitive)
    r"A_log", r"\bD\b", r"dt_",   # mamba SSM params
    r"time_", r"decay", r"bonus", r"token_shift",   # rwkv ddlerp vectors
    r"vision", r"frontend",
)


@dataclasses.dataclass(frozen=True)
class QATConfig:
    """anchor: anchor format name (§3.5); block_size: MX block size;
    exclude: regexes of param paths NOT quantized. (Training formats and
    schedules belong to the training path.)"""

    anchor: Optional[str] = None
    block_size: int = 32
    exclude: Tuple[str, ...] = DEFAULT_EXCLUDE

    def anchor_obj(self) -> Optional[MXFormat]:
        return get_format(self.anchor, self.block_size) if self.anchor else None

    def is_quantized_path(self, path: str) -> bool:
        low = path.lower()
        return not any(re.search(p, low) for p in self.exclude)


def pytree_block_axis(w) -> int:
    """Contraction axis of a (possibly stacked) weight leaf: always ndim-2
    (2D (d_in, d_out) weights stacked over layer groups)."""
    return max(w.ndim - 2, 0)
