"""The M2XFP GEMMs on Hopper (the reference's ``kernels/m2xfp_matmul.py``
holds both):

  * ``KERNEL`` -- fused dequant-GEMM, x (M, K) bf16 @ Sg-EM-packed W: port
    of ``m2xfp_matmul_kernel`` (``csrc/m2xfp_matmul.cu``; design notes in
    ``csrc/mx_dequant_gemm.cuh``). The weight streams are decoded in
    registers as ``fp4 * (1 + meta/4) * 2^(scale-127)`` and never exist as a
    dense weight in device memory. Plain version:
    ``repro_torch.kernels.ref.m2xfp_matmul_ref``.
  * ``QKERNEL`` -- the fully packed W4A4 GEMM, Elem-EM-packed X (K-major) @
    Sg-EM-packed W: port of ``m2xfp_qmatmul_kernel``
    (``csrc/m2xfp_qmatmul.cu``), the dequant-GEMM's template with X decoded
    through the Top-1 Decode Unit into its bf16 operand and the same split
    plan, so it equals ``KERNEL`` on the decoded X bit for bit. Plain
    version: ``repro_torch.kernels.ref.m2xfp_qmatmul_ref``.

``KERNEL.launches`` and ``QKERNEL.launches`` count the launches of this
process.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import Binding, CudaKernel, check_k, check_stream, split_k

__all__ = ["KERNEL", "QKERNEL"]

STREAMS = ("codes", "scales", "meta")


class QMatmulKernel(Binding):
    """``int m2xfp_qmatmul(x_codes, x_scales, x_meta, w_codes, w_scales,
    w_meta, out, M, K, N, S, stream)``; ``S`` is :func:`split_k`, as for
    the dequant-GEMMs."""

    def __init__(self):
        super().__init__("m2xfp_qmatmul",
                         [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4)

    def __call__(self, x_packed: dict, w_packed: dict) -> torch.Tensor:
        """Elem-EM X streams (K-major, M columns) @ Sg-EM W streams (N
        columns), all on one CUDA device -> f32 (M, N)."""
        xc = x_packed["codes"]
        if not xc.is_cuda:
            raise ValueError(f"{self.name}: X streams must be CUDA tensors, "
                             f"got {xc.device}")
        if xc.dim() != 2:
            raise ValueError(f"{self.name}: X codes must be (K/2, M), got "
                             f"shape {tuple(xc.shape)}")
        k, m = 2 * xc.shape[0], xc.shape[1]
        check_k(self.name, k)
        n = w_packed["codes"].shape[1]
        for s in STREAMS:
            rows = k // CudaKernel.ROW_DIV[s]
            check_stream(self.name, f"x {s}", x_packed[s], (rows, m),
                         xc.device)
            check_stream(self.name, f"w {s}", w_packed[s], (rows, n),
                         xc.device)
        out = torch.empty((m, n), dtype=torch.float32, device=xc.device)
        if m == 0 or n == 0:
            return out
        self.launch(xc.device, *(x_packed[s].data_ptr() for s in STREAMS),
                    *(w_packed[s].data_ptr() for s in STREAMS),
                    out.data_ptr(), m, k, n, split_k(k, n),
                    where=f"M={m} K={k} N={n}")
        return out


KERNEL = CudaKernel("m2xfp_matmul", STREAMS)
QKERNEL = QMatmulKernel()
