"""Hardware constants of the card the port serves on.

Counterpart of the constants in ``repro/launch/mesh.py``, for the NVIDIA
H100 SXM 80 GB (HBM3) instead of a TPU: the serving cost model
(``serve/slo.py::CostModel``) divides bytes by ``HBM_BW``. The mesh builders
of the reference are not ported yet (ROADMAP A.9).
"""
from __future__ import annotations

# NVIDIA H100 SXM 80 GB HBM3: peak memory bandwidth, bytes/s per card.
HBM_BW = 3.35e12
# NVIDIA H100 SXM 80 GB: dense bf16 tensor-core peak, flop/s per card.
PEAK_FLOPS_BF16 = 989e12
