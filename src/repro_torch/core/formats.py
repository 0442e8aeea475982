"""MX (microscaling) format definitions — OCP MX spec + the paper's extensions.

A microscaling format is defined by (Rouhani et al., 2023a):
  (i)   the scale-factor data type  (E8M0: power-of-two exponent stored in int8),
  (ii)  the element data type and precision (signed int for MXINT, small float for
        MXFP),
  (iii) the scaling block size (k values share one scale).

This module is pure metadata + scalar helpers; array math lives in ``mx.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# E8M0 scale exponent range (OCP): int8 biased-127, value NaN at 0xFF.
SCALE_EXP_MIN = -127
SCALE_EXP_MAX = 127

# OCP default block size; the paper's MSE/PPL figures use 64.
DEFAULT_BLOCK_SIZE = 32


@dataclasses.dataclass(frozen=True)
class MXFormat:
    """A microscaling numeric format.

    kind:        'int' (MXINT) or 'fp' (MXFP)
    bits:        total element bits (sign included)
    ebits/mbits: exponent / mantissa bits for MXFP (0 for MXINT)
    block_size:  number of elements sharing one E8M0 scale
    """

    name: str
    kind: str
    bits: int
    ebits: int = 0
    mbits: int = 0
    block_size: int = DEFAULT_BLOCK_SIZE

    def __post_init__(self):
        if self.kind not in ("int", "fp"):
            raise ValueError(f"bad kind {self.kind}")
        if self.kind == "fp" and 1 + self.ebits + self.mbits != self.bits:
            raise ValueError(f"{self.name}: 1+{self.ebits}+{self.mbits} != {self.bits}")
        if self.kind == "int" and self.bits < 2:
            raise ValueError("MXINT needs >= 2 bits (sign + >=1 magnitude)")

    # ---- element-format properties ----------------------------------------
    @property
    def emax(self) -> int:
        """Exponent of the largest normal number in the element format.

        MXINT-b: largest element is 2^(b-1)-1, floor(log2) = b-2  (paper §3.3:
        Δe = e_max(b_h) − e_max(b_l) = b_h − b_l, consistent with b-2).
        MXFP(η,μ): bias = 2^(η-1)-1; max exponent field = 2^η − 1 (no inf/nan
        reserved per OCP FP6/FP4; E4M3 reserves only mantissa-all-ones) so
        emax = (2^η − 1) − bias = 2^(η-1).
        """
        if self.kind == "int":
            return self.bits - 2
        return 2 ** (self.ebits - 1)

    @property
    def fp_bias(self) -> int:
        assert self.kind == "fp"
        return 2 ** (self.ebits - 1) - 1

    @property
    def emin(self) -> int:
        """Exponent of the smallest *normal* MXFP number."""
        assert self.kind == "fp"
        return 1 - self.fp_bias

    @property
    def int_maxq(self) -> int:
        """Largest MXINT element magnitude (symmetric: we clip to ±(2^(b-1)-1))."""
        assert self.kind == "int"
        return 2 ** (self.bits - 1) - 1

    @property
    def fp_max(self) -> float:
        """Largest-magnitude MXFP element value."""
        assert self.kind == "fp"
        if self.ebits == 4 and self.mbits == 3:
            # E4M3 (OCP FP8): S.1111.111 is NaN -> max mantissa is 1.75, not 1.875
            return 448.0
        mant = 2.0 - 2.0 ** (-self.mbits)
        return mant * 2.0 ** self.emax

    @property
    def storage_bits(self) -> int:
        """Element bits as stored after packing (== bits; packing is exact)."""
        return self.bits

    def with_block_size(self, block_size: int) -> "MXFormat":
        return dataclasses.replace(self, block_size=block_size)

    def __str__(self) -> str:  # pragma: no cover
        return self.name


def _mk_int(b: int, bs: int = DEFAULT_BLOCK_SIZE) -> MXFormat:
    return MXFormat(name=f"mxint{b}", kind="int", bits=b, block_size=bs)


def _mk_fp(e: int, m: int, bs: int = DEFAULT_BLOCK_SIZE) -> MXFormat:
    return MXFormat(name=f"mxfp{1 + e + m}_e{e}m{m}", kind="fp", bits=1 + e + m,
                    ebits=e, mbits=m, block_size=bs)


# ---- registry ---------------------------------------------------------------
# MXINT 2..8 (paper trains {2,4,6,8}, evals {2..8}).
MXINT: Dict[int, MXFormat] = {b: _mk_int(b) for b in range(2, 9)}

# MXFP per paper §3.2: 4(E2M1), 5(E2M2), 6(E3M2), 7(E3M3), 8(E4M3).
MXFP: Dict[int, MXFormat] = {
    4: _mk_fp(2, 1),
    5: _mk_fp(2, 2),
    6: _mk_fp(3, 2),
    7: _mk_fp(3, 3),
    8: _mk_fp(4, 3),
}

REGISTRY: Dict[str, MXFormat] = {}
for _f in list(MXINT.values()) + list(MXFP.values()):
    REGISTRY[_f.name] = _f
# Friendly aliases (paper naming).
for _b, _f in MXFP.items():
    REGISTRY[f"mxfp{_b}"] = _f

TRAIN_FORMATS_MXINT: Tuple[str, ...] = ("mxint2", "mxint4", "mxint6", "mxint8")
EVAL_FORMATS_MXINT: Tuple[str, ...] = tuple(f"mxint{b}" for b in range(2, 9))
TRAIN_FORMATS_MXFP: Tuple[str, ...] = ("mxfp4", "mxfp6", "mxfp8")
EVAL_FORMATS_MXFP: Tuple[str, ...] = tuple(f"mxfp{b}" for b in range(4, 9))

ANCHOR_MXINT = "mxint8"
ANCHOR_MXFP = "mxfp8"


def get_format(name: str, block_size: int | None = None) -> MXFormat:
    """Look up a format by name, e.g. 'mxint4', 'mxfp6', 'mxfp6_e3m2'."""
    key = name.lower()
    if key not in REGISTRY:
        raise KeyError(f"unknown MX format {name!r}; known: {sorted(REGISTRY)}")
    fmt = REGISTRY[key]
    if block_size is not None and block_size != fmt.block_size:
        fmt = fmt.with_block_size(block_size)
    return fmt


def delta_e(high: MXFormat, low: MXFormat) -> int:
    """Δe of the Slice-and-Scale transform (paper Eqs. 4/6)."""
    if high.kind != low.kind:
        raise ValueError("slice-and-scale requires same-kind formats")
    de = high.emax - low.emax
    if de < 0:
        raise ValueError(f"{high.name} -> {low.name} is not a down-conversion")
    return de
