"""MX gradient compression with error feedback for cross-pod data parallelism.

Counterpart of ``repro/train/compression.py``. A pod's gradient leaf is
quantized to MX blocks (MXINT8 by default, with E8M0 scales), the *packed*
codes and scales are all-gathered across the pods (about 4x fewer bytes
than an f32 all-reduce), dequantized and summed locally, and the
quantization residual is kept as error feedback so the compression bias
vanishes over steps (EF-SGD).

The quantize is ``kernels/ops.py::mx_quantize`` (B6 on a CUDA tensor, the
plain ``core/mx.py::quantize`` on the CPU) and the dequantize
``core/mx.py::dequantize``. The reference runs ``compressed_pod_allreduce``
inside ``shard_map`` over a ``pod`` mesh axis; here the pods are the
processes of a ``torch.distributed`` group and the all-gather is
``dist.all_gather`` over it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.formats import MXFormat, get_format
from repro_torch.core.mx import MXTensor, dequantize
from repro_torch.core.tree import flatten_paths, tree_map, unflatten_paths
from repro_torch.kernels.ops import mx_quantize

PAD = 128   # flatten-pad multiple (>= block size, lane aligned)


def _flatten_pad(g: torch.Tensor, bs: int) -> Tuple[torch.Tensor, int]:
    flat = g.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    pad = (-n) % max(bs, PAD)
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(1, -1), n


def ef_compress_leaf(g: torch.Tensor, err: torch.Tensor, fmt: MXFormat):
    """(grad, error state) -> (MXTensor of the flattened, padded corrected
    gradient (1, L), new error state of ``g``'s shape)."""
    corrected = g.to(torch.float32) + err.to(torch.float32)
    flat, n = _flatten_pad(corrected, fmt.block_size)
    t = mx_quantize(flat.contiguous(), fmt, axis=-1)
    deq = dequantize(t).reshape(-1)[:n].reshape(g.shape)
    new_err = corrected - deq
    return t, new_err.to(err.dtype)


def ef_decompress_sum(gathered_codes: torch.Tensor,
                      gathered_scales: torch.Tensor, fmt: MXFormat, shape,
                      n: int) -> torch.Tensor:
    """Sum the dequantized per-pod contributions: codes (npod, 1, L)."""
    t = MXTensor(codes=gathered_codes, scale_exp=gathered_scales, fmt=fmt,
                 block_axis=gathered_codes.ndim - 1)
    deq = dequantize(t)                      # (npod, 1, L)
    return torch.sum(deq, dim=0).reshape(-1)[:n].reshape(shape)


def init_error_state(grads_or_params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), grads_or_params)


def compressed_pod_allreduce(grads, err_state, fmt_name: str = "mxint8",
                             group=None, mean: bool = True):
    """EF-compress every leaf, all-gather the codes and scales over
    ``group`` (None: the default group; no default group: a pod of one),
    dequantize and sum locally. Returns (reduced grads, new error state),
    each a tree like ``grads``."""
    import torch.distributed as dist
    fmt = get_format(fmt_name)
    dist_on = dist.is_available() and dist.is_initialized()
    npod = dist.get_world_size(group) if dist_on else 1

    def gather(x):
        if npod == 1:
            return x[None]
        parts = [torch.empty_like(x) for _ in range(npod)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.stack(parts)

    red, new_err = {}, {}
    errs = dict(flatten_paths(err_state))
    for path, g in flatten_paths(grads):
        t, new_err[path] = ef_compress_leaf(g, errs[path], fmt)
        s = ef_decompress_sum(gather(t.codes), gather(t.scale_exp), fmt,
                              g.shape, g.numel())
        if mean:
            s = s / npod
        red[path] = s.to(g.dtype)
    return unflatten_paths(red), unflatten_paths(new_err)


def compressed_bytes(params, fmt_name: str = "mxint8") -> int:
    """Cross-pod bytes per step with compression (vs 4 bytes a param)."""
    fmt = get_format(fmt_name)
    total = 0
    for _, p in flatten_paths(params):
        n = p.numel()
        npad = n + ((-n) % max(fmt.block_size, PAD))
        total += npad * fmt.bits // 8 + npad // fmt.block_size
    return total
