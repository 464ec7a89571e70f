"""Matmul dtype policy (port of repro.models.numerics).

Operands are bf16 (or bf16-exact) and products accumulate in f32:

  * on the card, ``torch.mm(..., out_dtype=torch.float32)`` -- a bf16
    tensor-core product with f32 accumulation and output, as on the TPU;
  * on the CPU, float64 accumulation rounded to f32 (``kernels.ref``),
    which keeps a row's result independent of how many rows share the
    product, so chunked prefill stays bit-identical to sequential decode.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import dot_f64acc

__all__ = ["dot_f32acc"]


def dot_f32acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) -> f32 (..., N), accumulated in f32 or wider."""
    if x.device.type == "cpu":
        return dot_f64acc(x, w)
    out = torch.mm(x.reshape(-1, x.shape[-1]).to(torch.bfloat16),
                   w.to(torch.bfloat16), out_dtype=torch.float32)
    return out.reshape(*x.shape[:-1], w.shape[-1])
