"""Fused M2XFP dequant-GEMM on Hopper: x (M, K) bf16 @ Sg-EM-packed W.

Port of the TPU kernel ``repro/kernels/m2xfp_matmul.py::m2xfp_matmul_kernel``
as hand-written CUDA C++ for ``sm_90a`` (``csrc/m2xfp_matmul.cu``; design
notes in ``csrc/mx_dequant_gemm.cuh``). The weight streams are decoded in
registers as ``fp4 * (1 + meta/4) * 2^(scale-127)`` and never exist as a
dense weight in device memory. The plain PyTorch version of the same
function is ``repro_torch.kernels.ref.m2xfp_matmul_ref``.

``KERNEL.launches`` counts the launches of this process.
"""
from __future__ import annotations

from ._build import CudaKernel

__all__ = ["KERNEL"]

KERNEL = CudaKernel("m2xfp_matmul", ("codes", "scales", "meta"))
