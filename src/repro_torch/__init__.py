"""PyTorch/CUDA port of the MF-QAT elastic-inference serving path.

Mirrors the module layout of the JAX package ``repro`` (``core/``,
``checkpoint/``, ``kernels/``, ``models/``, ``serve/``, ``configs/``) so each
module has an obvious counterpart, but imports only ``torch``, ``numpy`` and
the standard library. The two MX dequant-GEMM kernels are CUDA C++ for
Hopper (``csrc/mx_matmul.cu``), built on first use.
"""
