"""The online M2XFP quantization engine on Hopper: activations x (M, K) ->
Elem-EM-top1 streams in the K-major kernel layout.

Port of the TPU kernel ``repro/kernels/m2xfp_quantize.py::m2xfp_quantize_kernel``
as hand-written CUDA C++ for ``sm_90a`` (``csrc/m2xfp_quantize.cu``; bit
helpers in ``csrc/mx_bits.cuh``). It reads x as it lies, bf16 or f32, and
writes codes u8 (K/2, M), scales u8 (K/32, M) and meta u8 (K/32, M),
byte-identical to the plain version ``repro_torch.kernels.ref.
m2xfp_quantize_ref`` (``layout.pack_x_elem_em``). It takes any M and any
K % 32 == 0; the TPU kernel's blocks and divisibility rules have no
counterpart.

``KERNEL.launches`` counts the launches of this process.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import Binding, check_cuda, check_k

__all__ = ["KERNEL"]


class QuantizeKernel(Binding):
    """``int m2xfp_quantize(x, x_is_f32, codes, scales, meta, M, K, stream)``."""

    def __init__(self):
        super().__init__("m2xfp_quantize",
                         [ctypes.c_void_p, ctypes.c_int]
                         + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2)

    def __call__(self, x: torch.Tensor) -> dict:
        """x (M, K) bf16 or f32 on a CUDA device -> dict(codes, scales, meta)."""
        check_cuda(self.name, "x", x, (torch.bfloat16, torch.float32), 2)
        m, k = x.shape
        check_k(self.name, k)
        u8 = dict(dtype=torch.uint8, device=x.device)
        out = {"codes": torch.empty((k // 2, m), **u8),
               "scales": torch.empty((k // 32, m), **u8),
               "meta": torch.empty((k // 32, m), **u8)}
        if m == 0 or k == 0:
            return out
        self.launch(x.device, x.data_ptr(), int(x.dtype == torch.float32),
                    out["codes"].data_ptr(), out["scales"].data_ptr(),
                    out["meta"].data_ptr(), m, k, where=f"M={m} K={k}")
        return out


KERNEL = QuantizeKernel()
