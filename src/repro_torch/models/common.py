"""Shared model infrastructure: the config and the quantization context.

Counterpart of ``repro/models/common.py``. Every projection weight flows
through ``QuantCtx.dense``: with a ``qmm`` hook a packed MX leaf goes
straight to the dequant-GEMM dispatch (``kernels/dispatch.py``); without one
it is dequantized at its point of use. MF-QAT training fake-quantizes the
stacked projection leaves before the layer loop
(``models/transformer.py::fake_quant_blocks``), so ``dense`` sees them
already quantized. Weights are (d_in, d_out) with MX blocks along d_in, the
contraction axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.serve.packed_params import densify_leaf, is_packed_leaf


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters of the dense decoder-only family as the
    port serves it (SwiGLU MLP, no biases): the fields of
    ``repro/models/common.py::ModelConfig`` that qwen3-4b and smollm-135m
    set, and ``sliding_window`` (None for both: full attention)."""

    name: str
    family: str                     # the port serves "dense"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    qk_norm: bool = False
    sliding_window: Optional[int] = None    # attention sees the last W
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    compute_dtype: Any = torch.bfloat16
    scan_group: int = 1             # layers per stacked group
    seq_chunk: int = 1024           # loss chunking along the sequence

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.scan_group == 0
        return self.n_layers // self.scan_group


@dataclasses.dataclass
class QuantCtx:
    """``qmm``: the serving matmul hook ``(x, packed_leaf, name) -> y``."""

    qmm: Optional[Any] = None

    def dense(self, x: torch.Tensor, w, name: str,
              ) -> torch.Tensor:
        """y = x @ w in the activation dtype."""
        if self.qmm is not None and is_packed_leaf(w):
            y = self.qmm(x, w, name)
        else:
            if is_packed_leaf(w):
                w = densify_leaf(w, None, x.dtype, serving_axis=True)
            y = torch.matmul(x, w.to(x.dtype))
        return y


def is_paged_cache(cache) -> bool:
    """True for the paged KV layout (shared page pools + per-slot block
    table): its pool leaves have no batch axis, so slot surgery goes
    through the block table instead."""
    return isinstance(cache, dict) and "block_table" in cache
