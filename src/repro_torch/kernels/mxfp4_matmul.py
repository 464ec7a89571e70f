"""MXFP4 dequant-GEMM on Hopper: x (M, K) bf16 @ MXFP4-packed W.

Port of the TPU kernel ``repro/kernels/mxfp4_matmul.py::mxfp4_matmul_kernel``
as hand-written CUDA C++ for ``sm_90a`` (``csrc/mxfp4_matmul.cu``, sharing
``csrc/mx_dequant_gemm.cuh`` with the M2XFP kernel): the paper's baseline
format, decoded in registers as ``fp4 * 2^(scale-127)``. The plain PyTorch
version is ``repro_torch.kernels.ref.mxfp4_matmul_ref``.

``KERNEL.launches`` counts the launches of this process.
"""
from __future__ import annotations

from ._build import CudaKernel

__all__ = ["KERNEL"]

KERNEL = CudaKernel("mxfp4_matmul", ("codes", "scales"))
