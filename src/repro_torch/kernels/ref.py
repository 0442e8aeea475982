"""Plain PyTorch versions of the two dequant-GEMM kernels.

Each computes exactly what its CUDA kernel in ``csrc/mx_matmul.cu``
computes, with the same operand layouts — codes (K, N) [or split-N packed
(K, N/2)], scales in the serving layout (N, K/bs) — so ``chip_smoke.py`` can
hold a kernel against it on the same card tensors. The CPU tests use them as
the wrappers' CPU path; on the main path with a card nothing calls them.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import MXFormat
from repro_torch.core.packed import unpack_int4_splitn
from repro_torch.kernels.common import decode_fp_arith, pow2i


def dequant_weight(codes: torch.Tensor, scales_nk: torch.Tensor,
                   fmt: MXFormat) -> torch.Tensor:
    """codes (K, N), scales (N, K/bs) -> f32 weight (K, N); blocks along K."""
    vals = codes.to(torch.float32) if fmt.kind == "int" \
        else decode_fp_arith(codes, fmt)
    scale = pow2i(scales_nk.to(torch.int32)).t()          # (K/bs, N)
    return vals * torch.repeat_interleave(scale, fmt.block_size, dim=0)


def ref_mx_matmul(x: torch.Tensor, codes: torch.Tensor,
                  scales_nk: torch.Tensor, fmt: MXFormat) -> torch.Tensor:
    """x (M, K) @ dequant(codes (K, N), scales (N, K/bs)) -> (M, N) f32."""
    return x.to(torch.float32) @ dequant_weight(codes, scales_nk, fmt)


def ref_mx_matmul_int4(x: torch.Tensor, packed: torch.Tensor,
                       scales_nk: torch.Tensor,
                       fmt: MXFormat) -> torch.Tensor:
    """Split-N int4: packed (K, N/2) uint8, byte j = column j (low nibble)
    and column j + N/2 (high nibble)."""
    return ref_mx_matmul(x, unpack_int4_splitn(packed), scales_nk, fmt)
