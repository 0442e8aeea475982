"""Quantized-matmul dispatch: packed MX weight leaves straight to the GEMM.

Counterpart of ``repro/kernels/dispatch.py``. ``qmatmul(x, leaf)`` is the
serving path's GEMM entry point for the packed containers the weight caches
hold — ``MXTensor`` (codes (K, N), scales (N, K/bs)) and split-N
``PackedInt4Leaf`` (packed (K, N/2)):

  mode "kernel"   (default) B1 ``mx_matmul`` / B2 ``mx_matmul_int4`` from
                  ``kernels/mx_matmul.py``: the CUDA kernel on a CUDA tensor,
                  its plain PyTorch version on a CPU tensor.
  mode "densify"  dequantize the leaf, then ``torch.matmul`` — the dense
                  reference contract. Only a caller who asks gets it: a leaf
                  the kernels cannot take raises in "kernel" mode instead of
                  silently densifying.

Unlike the TPU wrapper there is no padding and no tile table: the kernels
mask ragged M/N edges themselves with compile-time tiles, and read the
leaf's own (N, K/bs) scales, so no weight-sized tensor is copied per call.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core.formats import get_format
from repro_torch.core.mx import MXTensor
from repro_torch.kernels import mx_matmul as _mm
from repro_torch.serve.packed_params import (PackedInt4Leaf, densify_leaf,
                                             leaf_block_size)

MODES = ("kernel", "densify")

_stats: Dict[str, int] = {"kernel": 0, "kernel_int4": 0, "densify": 0}


def stats() -> Dict[str, int]:
    """Host-side counts of which path each qmatmul call took."""
    return dict(_stats)


def reset_stats() -> None:
    for k in _stats:
        _stats[k] = 0


def snapshot() -> Dict[str, int]:
    """The path counts as they stand; the difference of two snapshots is
    what ``credit`` takes (``serve/tick_graph.py`` credits a CUDA graph's
    at each replay, where no Python runs)."""
    return dict(_stats)


def credit(delta: Dict[str, int]) -> None:
    for k, v in delta.items():
        _stats[k] += v


def resolve_mode(mode: Optional[str]) -> str:
    mode = mode or "kernel"
    if mode not in MODES:
        raise ValueError(f"unknown qmatmul mode {mode!r}; one of {MODES}")
    return mode


def _check_serving_layout(leaf) -> None:
    """Reject 2D MXTensor leaves whose scales aren't in the serving layout.

    The contract is codes (K, N) with scale_exp (N, K/bs). A leaf quantized
    along the wrong axis has scale_exp (K, N/bs), which for non-square
    weights is caught here loudly; square K == N is shape-ambiguous.
    """
    if isinstance(leaf, MXTensor) and leaf.codes.ndim == 2:
        k, n = leaf.codes.shape
        bs = leaf.fmt.block_size
        want = (n, k // bs)
        if k % bs == 0 and tuple(leaf.scale_exp.shape) != want:
            raise ValueError(
                f"MXTensor leaf violates the serving layout: codes "
                f"{(k, n)} expect scale_exp {want}, got "
                f"{tuple(leaf.scale_exp.shape)} — was it quantized along "
                "the wrong axis?")


def _kernel_unsupported(leaf) -> Optional[str]:
    if isinstance(leaf, MXTensor):
        if leaf.codes.ndim != 2:
            return (f"{leaf.codes.ndim}D MXTensor (slice stacked leaves, "
                    "and expert leaves, to one 2-D weight first)")
        if leaf.codes.shape[0] % leaf.fmt.block_size:
            return "K not a multiple of the block size"
        return None
    if isinstance(leaf, PackedInt4Leaf):
        if leaf.layout != "splitn":
            return "split-K int4 layout (densify-only)"
        if leaf.packed.ndim != 2:
            return f"{leaf.packed.ndim}D PackedInt4Leaf"
        return None
    return f"not a packed MX leaf ({type(leaf).__name__})"


def qmatmul(x: torch.Tensor, leaf, *, mode: Optional[str] = None,
            out_dtype=None) -> torch.Tensor:
    """y = x @ dequant(leaf). x (..., K) -> (..., N) in ``out_dtype``
    (default x.dtype); the kernels accumulate and return f32."""
    out_dtype = out_dtype or x.dtype
    _check_serving_layout(leaf)
    if resolve_mode(mode) == "densify":
        _stats["densify"] += 1
        w = densify_leaf(leaf, None, out_dtype, serving_axis=True)
        return torch.matmul(x.to(out_dtype), w)
    why = _kernel_unsupported(leaf)
    if why is not None:
        raise ValueError(f"qmatmul(mode='kernel') cannot take this leaf: "
                         f"{why}; densify it explicitly (mode='densify')")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(leaf, MXTensor):
        _stats["kernel"] += 1
        out = _mm.mx_matmul(x2, leaf.codes, leaf.scale_exp, leaf.fmt)
    else:
        _stats["kernel_int4"] += 1
        # block size from the leaf's own shapes, not the registry default
        fmt = get_format(leaf.fmt_name, leaf_block_size(leaf))
        out = _mm.mx_matmul_int4(x2, leaf.packed, leaf.scale_exp, fmt)
    return out.reshape(*lead, out.shape[-1]).to(out_dtype)


def make_qmm(mode: Optional[str] = None) -> Callable:
    """A ``QuantCtx.qmm`` hook: (x, leaf, name, out_dtype=None) -> y at a
    fixed mode."""
    resolved = resolve_mode(mode)

    def qmm(x, leaf, name=None, out_dtype=None):
        del name
        return qmatmul(x, leaf, mode=resolved, out_dtype=out_dtype)

    return qmm
