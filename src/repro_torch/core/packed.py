"""Bit packing for sub-byte MX element codes.

Two consumers:
  - checkpoint serialization (numpy path): true 2/4/6-bit storage on disk,
    byte-identical to ``repro/core/packed.py`` so either package reads the
    other's anchors,
  - the serving path (torch path): int4 nibble-packed weights halve the
    device bytes of the decode-critical GEMMs vs. unpacked int8.

Packing layouts (little-endian within a byte, along the last axis):
  2-bit: 4 codes/byte      4-bit: 2 codes/byte      6-bit: 4 codes / 3 bytes
  8-bit: identity          3/5/7-bit: stored at the next packable width
         (3->4, 5->6, 7->8); the *format* stays exact — only storage rounds up.

The serving-side int4 nibble layouts: split-N (what the int4 dequant-GEMM
kernel reads) and legacy split-K (densify-only).
"""
from __future__ import annotations

from typing import Tuple

import torch
import numpy as np

_PACK_WIDTH = {2: 2, 3: 4, 4: 4, 5: 6, 6: 6, 7: 8, 8: 8}


def storage_bits(bits: int) -> int:
    return _PACK_WIDTH[bits]


def _to_unsigned(codes: np.ndarray, bits: int) -> np.ndarray:
    return (codes.astype(np.int16) & ((1 << bits) - 1)).astype(np.uint8)


def _from_unsigned(u: np.ndarray, bits: int, signed: bool) -> np.ndarray:
    u = u.astype(np.int16)
    if signed:
        sign = 1 << (bits - 1)
        u = (u ^ sign) - sign
        return u.astype(np.int8)
    return u.astype(np.uint8)


def pack_np(codes: np.ndarray, bits: int) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """Pack int8/uint8 codes (numpy) -> (uint8 packed buffer, original shape)."""
    shape = codes.shape
    w = storage_bits(bits)
    # Mask at the *storage* width so sign-extension from w bits round-trips
    # (e.g. a 3-bit code stored in a 4-bit slot keeps its sign bit at bit 3).
    flat = _to_unsigned(codes.reshape(-1), w)
    if w == 8:
        return flat.astype(np.uint8), shape
    if w == 2:
        pad = (-flat.size) % 4
        f = np.pad(flat, (0, pad))
        f = f.reshape(-1, 4)
        out = (f[:, 0] | (f[:, 1] << 2) | (f[:, 2] << 4) | (f[:, 3] << 6))
        return out.astype(np.uint8), shape
    if w == 4:
        pad = (-flat.size) % 2
        f = np.pad(flat, (0, pad)).reshape(-1, 2)
        return (f[:, 0] | (f[:, 1] << 4)).astype(np.uint8), shape
    if w == 6:
        pad = (-flat.size) % 4
        f = np.pad(flat, (0, pad)).reshape(-1, 4).astype(np.uint32)
        word = f[:, 0] | (f[:, 1] << 6) | (f[:, 2] << 12) | (f[:, 3] << 18)
        out = np.stack([word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0xFF],
                       axis=1).reshape(-1)
        return out.astype(np.uint8), shape
    raise ValueError(w)


def unpack_np(buf: np.ndarray, bits: int, shape: Tuple[int, ...],
              signed: bool) -> np.ndarray:
    """Inverse of pack_np."""
    w = storage_bits(bits)
    n = int(np.prod(shape)) if shape else 1
    if w == 8:
        u = buf[:n]
    elif w == 2:
        b = buf.astype(np.uint8)
        u = np.stack([b & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3],
                     axis=1).reshape(-1)[:n]
    elif w == 4:
        b = buf.astype(np.uint8)
        u = np.stack([b & 0xF, (b >> 4) & 0xF], axis=1).reshape(-1)[:n]
    elif w == 6:
        b = buf.reshape(-1, 3).astype(np.uint32)
        word = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        u = np.stack([word & 63, (word >> 6) & 63, (word >> 12) & 63,
                      (word >> 18) & 63], axis=1).reshape(-1)[:n]
    else:
        raise ValueError(w)
    # Sign-extend from the storage width: an n<w bit signed code stored as its
    # low-w-bit two's-complement pattern round-trips exactly.
    return _from_unsigned(np.asarray(u, np.uint8), w, signed).reshape(shape)


# =============================================================================
# torch nibble packing (serving path; int4 only)
# =============================================================================
def _nibbles(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7] -> their low-nibble bit patterns (uint8)."""
    return codes.to(torch.int8).view(torch.uint8) & 0xF


def _sign_extend4(nib: torch.Tensor, dtype) -> torch.Tensor:
    return ((nib.to(torch.int16) ^ 8) - 8).to(dtype)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes -> uint8 nibble pairs of ADJACENT codes along the last axis
    (split-K layout when the block axis was moved last)."""
    if codes.shape[-1] % 2 != 0:
        raise ValueError("last axis must be even for int4 packing")
    u = _nibbles(codes)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_int4(packed: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """Inverse of pack_int4: (..., L) uint8 -> (..., 2L) codes."""
    lo = _sign_extend4(packed & 0xF, dtype)
    hi = _sign_extend4(packed >> 4, dtype)
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1],
                                                  packed.shape[-1] * 2)


def splitn_ok(shape, block_axis: int) -> bool:
    """Whether int4 codes of ``shape`` blocked along ``block_axis`` take the
    split-N layout: the last axis is the GEMM's output (not the block axis)
    and even."""
    return block_axis % len(shape) != len(shape) - 1 and shape[-1] % 2 == 0


def pack_int4_splitn(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes (..., N) -> uint8 (..., N/2), split-half layout.

    Byte j carries code j in the low nibble and code j + N/2 in the high
    nibble — the layout the int4 dequant-GEMM kernel reads when the last
    axis is the GEMM's output (N) dimension.
    """
    if codes.shape[-1] % 2 != 0:
        raise ValueError("last axis must be even for int4 packing")
    half = codes.shape[-1] // 2
    u = _nibbles(codes)
    return u[..., :half] | (u[..., half:] << 4)


def unpack_int4_splitn(packed: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """Inverse of pack_int4_splitn: (..., N/2) uint8 -> (..., N) codes."""
    return torch.cat([_sign_extend4(packed & 0xF, dtype),
                      _sign_extend4(packed >> 4, dtype)], dim=-1)
