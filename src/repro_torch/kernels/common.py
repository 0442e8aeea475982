"""Shared numerics of the MX dequant-GEMM kernels, as plain PyTorch, and
what every ctypes launch of the port's kernels shares.

Counterpart of ``repro/kernels/common.py``. ``csrc/mx_matmul.cu`` implements
the same two functions per element (``pow2i``, ``decode_fp``); these are
what the kernels' plain versions in ``ref.py`` use. ``MxFmt`` is the format
struct the quantize, fake-quant and Slice-and-Scale kernels take by value
(``csrc/mx_numerics.cuh``).

Shape-only launches (the dry run, ``launch/dryrun.py``): a tensor that holds
no data — a ``FakeTensor``, or one on the ``meta`` device — takes each
wrapper's card branch (``on_card``), and the launch function, finding it
``shape_only``, builds nothing and calls no C function: it leaves the
outputs its caller allocated as they are and hands ``record_shape_only``
the kernel's name, its operations and the bytes it would read and write,
computed from the operand shapes. It bumps no launch counter: those count
kernels that ran. A real CUDA tensor never reaches that branch, and a real
CPU tensor still takes the plain version.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Iterator, List

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.core.formats import MXFormat


class MxFmt(ctypes.Structure):
    """``struct MxFmt`` of ``csrc/mx_numerics.cuh``, field for field."""

    _fields_ = [("fp", ctypes.c_int), ("bits", ctypes.c_int),
                ("ebits", ctypes.c_int), ("mbits", ctypes.c_int),
                ("bias", ctypes.c_int), ("emin", ctypes.c_int),
                ("emax", ctypes.c_int), ("maxq", ctypes.c_int),
                ("fp_max", ctypes.c_float)]


def mx_fmt(fmt: MXFormat) -> MxFmt:
    fp = fmt.kind == "fp"
    return MxFmt(int(fp), fmt.bits, fmt.ebits, fmt.mbits,
                 fmt.fp_bias if fp else 0, fmt.emin if fp else 0, fmt.emax,
                 0 if fp else fmt.int_maxq, fmt.fp_max if fp else 0.0)


def shape_only(t: torch.Tensor) -> bool:
    """True for a tensor that holds no data: a ``FakeTensor`` or a tensor
    on the ``meta`` device."""
    return isinstance(t, FakeTensor) or t.is_meta


def on_card(t: torch.Tensor) -> bool:
    """A wrapper's card branch: a CUDA tensor, or a ``meta`` one, which
    stands for a card's tensor in a trace (its launch is shape-only)."""
    return t.is_cuda or t.is_meta


_RECORDERS: List[List[Dict]] = []


@contextlib.contextmanager
def shape_only_launches() -> Iterator[List[Dict]]:
    """The shape-only launches made inside the block, in order: {"name",
    "flops", "bytes_read", "bytes_written"} each."""
    out: List[Dict] = []
    _RECORDERS.append(out)
    try:
        yield out
    finally:
        _RECORDERS.remove(out)


def record_shape_only(name: str, flops: float, bytes_read: int,
                      bytes_written: int) -> None:
    """One shape-only launch of kernel ``name``, for every open
    ``shape_only_launches`` block."""
    rec = {"name": name, "flops": float(flops),
           "bytes_read": int(bytes_read), "bytes_written": int(bytes_written)}
    for out in _RECORDERS:
        out.append(dict(rec))


# The f32 operations B6 and B7 do per element, as the bound of PERF.md's
# kernel table reckons them (a few dozen; B5 does none: a table lookup).
QUANT_OPS_PER_ELEMENT = 32


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s card, as a ctypes pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on(rc: int, name: str) -> None:
    """Raise on the CUDA error code a C launch function returned."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def pow2i(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e for integer e, clamped to [-126, 127], from f32 exponent
    bits. e < -126 saturates to 2^-126; MX scale exponents of -127 only
    occur for all-zero blocks, whose elements are 0 anyway."""
    e = torch.clamp(e.to(torch.int32), -126, 127)
    return ((e + 127) << 23).view(torch.float32)


def decode_fp_arith(codes: torch.Tensor, fmt: MXFormat) -> torch.Tensor:
    """MXFP uint8 bit patterns -> f32 values (arithmetic, no LUT).

    The E4M3 pattern 0x7F / 0xFF decodes to ±480 here (the LUT in
    ``core/mx.py`` says NaN); quantizers never produce it.
    """
    c = codes.to(torch.int32)
    s = (c >> (fmt.bits - 1)) & 1
    e = (c >> fmt.mbits) & ((1 << fmt.ebits) - 1)
    mf = (c & ((1 << fmt.mbits) - 1)).to(torch.float32) * (2.0 ** -fmt.mbits)
    mag = torch.where(e > 0, (1.0 + mf) * pow2i(e - fmt.fp_bias),
                      mf * (2.0 ** fmt.emin))
    return torch.where(s == 1, -mag, mag)
