"""Matmul dtype policy (port of repro.models.numerics).

Products accumulate in f32 and keep the operands' exact values:

  * on the card, bf16 (or bf16-exact) operands go through
    ``torch.mm(..., out_dtype=torch.float32)`` -- a bf16 tensor-core product
    with f32 accumulation and output, as on the TPU; f32 operands (nvfp4's
    decoded weight, exact in f32 only) go through an f32 ``torch.mm`` with
    TF32 off for the call, so neither operand is rounded;
  * on the CPU, float64 accumulation rounded to f32 (``kernels.ref``),
    which keeps a row's result independent of how many rows share the
    product, so chunked prefill stays bit-identical to sequential decode.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels.ref import dot_f64acc

__all__ = ["dot_f32acc"]


@contextlib.contextmanager
def _ieee_f32_matmul():
    """f32 products in IEEE f32 (no TF32) inside the block, whatever the
    process-wide setting; the setting is restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def dot_f32acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) -> f32 (..., N), accumulated in f32 or wider.
    An f32 ``w`` keeps f32 operands; any other is taken as bf16-exact."""
    if x.device.type == "cpu":
        return dot_f64acc(x, w)
    x2 = x.reshape(-1, x.shape[-1])
    if w.dtype == torch.float32:
        with _ieee_f32_matmul():
            out = torch.mm(x2.to(torch.float32), w)
    else:
        out = torch.mm(x2.to(torch.bfloat16), w.to(torch.bfloat16),
                       out_dtype=torch.float32)
    return out.reshape(*x.shape[:-1], w.shape[-1])
