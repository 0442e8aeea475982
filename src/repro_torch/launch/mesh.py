"""Hardware constants of the card the port serves on.

Counterpart of the constants in ``repro/launch/mesh.py``, for the NVIDIA
H100 SXM 80 GB (HBM3) instead of a TPU: the serving cost model
(``serve/slo.py::CostModel``) divides bytes by ``HBM_BW``, and
``launch/costmodel.py::roofline`` divides flops by ``PEAK_FLOPS_BF16``,
bytes by ``HBM_BW`` and collective bytes by ``LINK_BW``. The mesh builders
of the reference are not ported yet (ROADMAP A.9).
"""
from __future__ import annotations

# NVIDIA H100 SXM 80 GB HBM3: peak memory bandwidth, bytes/s per card.
HBM_BW = 3.35e12
# NVIDIA H100 SXM 80 GB: dense bf16 tensor-core peak, flop/s per card.
PEAK_FLOPS_BF16 = 989e12
# NVIDIA H100 SXM: NVLink 4, 900 GB/s per card in both directions together,
# 450 GB/s per direction (the public spec; the reference's ICI_BW is its
# per-link rate). A published figure, not a measurement.
LINK_BW = 450e9
