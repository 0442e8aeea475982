"""PyTorch/CUDA port of MF-QAT: multi-format QAT training, anchor export and
elastic serving.

Mirrors the module layout of the JAX package ``repro`` (``core/``,
``checkpoint/``, ``data/``, ``kernels/``, ``models/``, ``optim/``,
``runtime/``, ``serve/``, ``train/``, ``configs/``) so each module has an
obvious counterpart, but imports only ``torch``, ``numpy`` and the standard
library. Its seven kernels are CUDA C++ for Hopper (``csrc/*.cu``), built on
first use.
"""
