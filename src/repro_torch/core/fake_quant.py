"""Straight-through-estimator fake quantization for QAT (paper §3.2 / §3.5).

Counterpart of ``repro/core/fake_quant.py``. Two forward operators:

  direct:    W_t = Q_t(W_fp)                       (plain QAT, one format)
  anchored:  W_A = Q_A(W_fp);  W_t = Q_{A→t}(W_A)  (anchor-storage pipeline)

The forward value is JAX's ``w + stop_gradient(w_q - w)`` in ``w``'s dtype,
then cast to ``out_dtype`` (the layer's compute dtype, as ``dense`` casts
it); the gradient is the identity (Yin et al., 2019). On a CUDA tensor the
direct operator is one B7 launch with the straight-through epilogue and the
cast fused in; the anchored one is B6, then B5 (unless the target is the
anchor), then the plain dequantize. On a CPU tensor they are the plain
versions.

JAX's ``lax.switch`` over a traced format index has no counterpart: the
``*_switch`` variants take the schedule's int on the host and run one
branch. ``idx == len(formats)`` is the pass-through branch (the
full-precision baseline; for anchored training, the anchor itself).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.formats import MXFormat
from repro_torch.core.mx import dequantize
from repro_torch.kernels import ops


class _Ste(torch.autograd.Function):
    """Value ``value_fn(w)``, computed without a graph; gradient identity,
    returned in ``w``'s dtype (the cast's backward)."""

    @staticmethod
    def forward(ctx, w: torch.Tensor, value_fn: Callable) -> torch.Tensor:
        ctx.dtype = w.dtype
        return value_fn(w)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.to(ctx.dtype), None


def _ste_value(w: torch.Tensor, w_q: torch.Tensor, out_dtype) -> torch.Tensor:
    return (w + (w_q.to(w.dtype) - w)).to(out_dtype or w.dtype)


def fake_quant(w: torch.Tensor, fmt: MXFormat, axis: int = -1,
               out_dtype=None) -> torch.Tensor:
    """Direct STE fake-quant: value dequant(quant(w)), gradient identity."""
    return _Ste.apply(w, lambda x: ops.fake_quant(
        x, fmt, axis, out_dtype=out_dtype, ste=True))


def _anchored_value(w: torch.Tensor, anchor: MXFormat, target, axis: int,
                    out_dtype) -> torch.Tensor:
    """Q_{A→t}(Q_A(w)) through the packed domain; ``target=None`` is the
    anchor itself."""
    t = ops.mx_quantize(w, anchor, axis=axis)
    if target is not None:
        t = ops.ss_convert(t, target)
    return _ste_value(w, dequantize(t, dtype=w.dtype), out_dtype)


def fake_quant_anchored(w: torch.Tensor, anchor: MXFormat, target: MXFormat,
                        axis: int = -1, out_dtype=None) -> torch.Tensor:
    """Anchored STE fake-quant (paper Eq. 7): W_t = Q_{A→t}(Q_A(W))."""
    return _Ste.apply(w, lambda x: _anchored_value(x, anchor, target, axis,
                                                   out_dtype))


def _branch(idx, n: int) -> int:
    return min(max(int(idx), 0), n)


def fake_quant_switch(w: torch.Tensor, formats: Sequence[MXFormat], idx,
                      axis: int = -1, out_dtype=None) -> torch.Tensor:
    """STE fake-quant at ``formats[idx]``; ``idx == len(formats)`` passes
    the weight through (JAX's f32 round trip, then the STE)."""
    i = _branch(idx, len(formats))
    if i < len(formats):
        return fake_quant(w, formats[i], axis, out_dtype)
    return _Ste.apply(w, lambda x: _ste_value(
        x, x.to(torch.float32).to(x.dtype), out_dtype))


def fake_quant_anchored_switch(w: torch.Tensor, anchor: MXFormat,
                               targets: Sequence[MXFormat], idx,
                               axis: int = -1, out_dtype=None
                               ) -> torch.Tensor:
    """Anchored STE fake-quant at ``targets[idx]``; ``idx == len(targets)``
    is the anchor itself."""
    i = _branch(idx, len(targets))
    target = targets[i] if i < len(targets) else None
    return _Ste.apply(w, lambda x: _anchored_value(x, anchor, target, axis,
                                                   out_dtype))
