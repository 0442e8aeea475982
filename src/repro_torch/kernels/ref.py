"""Plain PyTorch versions of the port's kernels.

Each computes exactly what its CUDA kernel computes, with the same operand
layouts, so ``chip_smoke.py`` can hold a kernel against it on the same card
tensors. The CPU tests use them as the wrappers' CPU path; on the main path
with a card nothing calls them.

  ``csrc/mx_matmul.cu``        B1/B2: codes (K, N) [or split-N packed
                               (K, N/2)], scales in the serving layout
                               (N, K/bs).
  ``csrc/paged_attention.cu``  B3/B4: attention read through a block table
                               from page pools (P, ps, Hkv, D), in f32, with
                               total masking.

The plain versions of B5–B7 (``csrc/ss_convert.cu``, ``mx_quantize.cu``,
``fake_quant.cu``) are the core functions themselves —
``core/slice_scale.py::slice_and_scale``, ``core/mx.py::quantize`` and
``core/mx.py::quantize_dequantize`` — which ``kernels/ops.py`` calls on the
CPU.
"""
from __future__ import annotations

from typing import Optional

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


# ---------------------------------------------------------------------------
# Paged attention (B3, B4)
# ---------------------------------------------------------------------------
def _paged_attend(q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, block_table: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """q (B, C, H, D) over each row's logical view of the pools; ``mask``
    (B, C, T) says which positions each query sees. Masking is total: dead
    scores are -inf before the max, dead probabilities are selected to 0
    after the exp, and V rows that no query of the row sees are selected to
    0, so NaN anywhere outside the mask never reaches the output; a query
    with no live position gives exact zeros. Returns f32 (B, C, H, D)."""
    b, c, h, d = q.shape
    hkv = k_pages.shape[2]
    t = block_table.shape[1] * k_pages.shape[1]
    k = k_pages[block_table.long()].reshape(b, t, hkv, d).to(torch.float32)
    v = v_pages[block_table.long()].reshape(b, t, hkv, d).to(torch.float32)
    v = torch.where(mask.any(dim=1)[..., None, None], v, 0.0)
    qg = q.reshape(b, c, hkv, h // hkv, d).to(torch.float32)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k) * (1.0 / d ** 0.5)
    m4 = mask[:, None, None]                               # (B, 1, 1, C, T)
    s = torch.where(m4, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m4, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1)                                      # (B, Hkv, G, C)
    acc = torch.einsum("bkgqt,btkd->bkgqd", p, v)
    out = torch.where((l > 0)[..., None],
                      acc / torch.clamp(l, min=1e-30)[..., None], 0.0)
    return out.permute(0, 3, 1, 2, 4).reshape(b, c, h, d)


def ref_paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_table: torch.Tensor,
                        cache_len: torch.Tensor,
                        window: Optional[int] = None) -> torch.Tensor:
    """B3: single-query attention q (B, H, D) over pools (P, ps, Hkv, D)
    through block_table (B, mp); row b sees positions < cache_len[b] (and
    >= cache_len[b] - window). Returns f32 (B, H, D)."""
    t = block_table.shape[1] * k_pages.shape[1]
    pos = torch.arange(t, device=q.device)
    cl = cache_len.to(torch.int64)[:, None]
    mask = pos[None, :] < cl
    if window is not None:
        mask &= pos[None, :] >= cl - window
    return _paged_attend(q[:, None], k_pages, v_pages, block_table,
                         mask[:, None])[:, 0]


def ref_paged_attention_mq(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           q_offset: torch.Tensor, q_len: torch.Tensor,
                           window: Optional[int] = None) -> torch.Tensor:
    """B4: ragged multi-query attention q (B, C, H, D); query i of row b
    sits at position q_offset[b] + i and is live iff i < q_len[b]; it sees
    positions <= its own, below the frontier q_offset + q_len, within the
    window. Dead lanes give zeros. Returns f32 (B, C, H, D)."""
    c = q.shape[1]
    t = block_table.shape[1] * k_pages.shape[1]
    pos = torch.arange(t, device=q.device)
    lane = torch.arange(c, device=q.device)
    qo = q_offset.to(torch.int64)[:, None, None]
    ql = q_len.to(torch.int64)[:, None, None]
    qpos = qo + lane[None, :, None]                        # (B, C, 1)
    mask = (pos <= qpos) & (pos < qo + ql) & (lane[None, :, None] < ql)
    if window is not None:
        mask &= qpos - pos < window
    return _paged_attend(q, k_pages, v_pages, block_table, mask)
