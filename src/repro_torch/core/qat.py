"""Multi-format QAT configuration, schedules and tree wiring (paper §3.2).

Counterpart of ``repro/core/qat.py``. The paper's protocol:
  - weight-only quantization of decoder-stack matmul weights (embeddings,
    lm_head, norms, biases and small vector params excluded),
  - sequential schedule in increasing bit order (2→4→6→8), one epoch per
    format; for >2B models one total epoch with formats given equal step
    budgets inside it,
  - the anchor-storage variant cycles target formats uniformly per step.

A schedule is an int32 array ``format_ids[num_steps]`` indexing the static
tuple of formats; the train step takes ``format_ids[step]`` as a host int
and runs that format's branch.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.fake_quant import (fake_quant_anchored_switch,
                                         fake_quant_switch)
from repro_torch.core.formats import MXFormat, get_format
from repro_torch.core.tree import flatten_paths, unflatten_paths
from repro_torch.kernels import ops

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
    """Quantization-aware-training configuration attached to a model.

    anchor:      anchor format name for the §3.5 pipeline (None = direct QAT)
    block_size:  MX scaling block size
    exclude:     regexes of param path fragments NOT quantized
    formats:     static tuple of format names in the training set
    block_axis:  which axis of a (d_in, d_out) weight blocks run along (0,
                 the contraction axis)
    """

    anchor: Optional[str] = None
    block_size: int = 32
    exclude: Tuple[str, ...] = DEFAULT_EXCLUDE
    formats: Tuple[str, ...] = ()
    block_axis: int = 0

    @property
    def enabled(self) -> bool:
        return len(self.formats) > 0

    def format_objs(self) -> Tuple[MXFormat, ...]:
        return tuple(get_format(n, self.block_size) for n in self.formats)

    def anchor_obj(self) -> Optional[MXFormat]:
        return get_format(self.anchor, self.block_size) if self.anchor else None

    def is_quantized_path(self, path: str) -> bool:
        low = path.lower()
        return not any(re.search(p, low) for p in self.exclude)

    def apply(self, w, path: str, fmt_idx, axis: Optional[int] = None,
              out_dtype=None):
        """Fake-quantize one weight according to the config (STE), in
        ``out_dtype`` (default ``w.dtype``). ``axis`` (default
        ``block_axis``) lets a stacked (G, d_in, d_out) leaf be quantized
        in one call, at ``block_axis + 1``."""
        axis = self.block_axis if axis is None else axis
        if (not self.enabled or not self.is_quantized_path(path) or w.ndim < 2
                or w.shape[axis] % self.block_size != 0):
            return w if out_dtype is None else w.to(out_dtype)
        fmts = self.format_objs()
        if self.anchor is not None:
            return fake_quant_anchored_switch(w, self.anchor_obj(), fmts,
                                              fmt_idx, axis, out_dtype)
        return fake_quant_switch(w, fmts, fmt_idx, axis, out_dtype)


# =============================================================================
# Schedules
# =============================================================================
def sequential_schedule(num_formats: int, steps_per_format: int) -> np.ndarray:
    """Paper default: one 'epoch' (steps_per_format) per format, in order
    (``formats.TRAIN_FORMATS_*`` are sorted by increasing bits)."""
    return np.repeat(np.arange(num_formats, dtype=np.int32), steps_per_format)


def interleaved_schedule(num_formats: int, total_steps: int) -> np.ndarray:
    """>2B-model variant: equal per-format step counts inside one epoch,
    cycled uniformly (also the anchor-storage §3.5 training schedule)."""
    return (np.arange(total_steps, dtype=np.int32)) % num_formats


def fp_schedule(total_steps: int, num_formats: int) -> np.ndarray:
    """Full-precision fine-tuning baseline: index == len(formats) selects the
    pass-through branch."""
    return np.full(total_steps, num_formats, dtype=np.int32)


def single_format_schedule(fmt_pos: int, total_steps: int) -> np.ndarray:
    """Single-format QAT baseline at format position ``fmt_pos``."""
    return np.full(total_steps, fmt_pos, dtype=np.int32)


# =============================================================================
# Tree-level PTQ (eval / export time)
# =============================================================================
def pytree_block_axis(w) -> int:
    """Contraction axis of a (possibly stacked) weight leaf: always ndim-2
    (2D (d_in, d_out) weights stacked over layer groups)."""
    return max(w.ndim - 2, 0)


def ptq_pytree(params, cfg: QATConfig, fmt: MXFormat):
    """Post-training-quantize every quantizable leaf (quant→dequant values,
    B7 on a CUDA tensor)."""
    out = {}
    for path, w in flatten_paths(params):
        ax = pytree_block_axis(w)
        if (w.ndim >= 2 and cfg.is_quantized_path(path)
                and w.shape[ax] % fmt.block_size == 0):
            w = ops.fake_quant(w, fmt, axis=ax)
        out[path] = w
    return unflatten_paths(out)
