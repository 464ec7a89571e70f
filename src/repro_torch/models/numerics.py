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

``einsum_f32acc`` carries the same rule to the two-operand contractions of
the mixture-of-experts FFN (dispatch, the per-expert products, combine):
on the card as one batched bf16 product with f32 accumulation and output.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels.ref import dot_f64acc

__all__ = ["dot_f32acc", "einsum_f32acc"]


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


def _bmm_f32acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, M, K) @ (B, K, N) -> f32: float64 accumulation on the CPU, a bf16
    tensor-core product with f32 accumulation and output on the card."""
    if a.device.type == "cpu":
        return torch.bmm(a.to(torch.float64), b.to(torch.float64)).to(
            torch.float32)
    return torch.bmm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                     out_dtype=torch.float32)


def einsum_f32acc(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` of bf16-exact operands, accumulated in f32
    or wider (see the module docstring), f32 out. ``eq`` names each axis
    once per operand (no repeats within one, no ellipsis); an axis in both
    operands and the output is a batch axis, in both but not the output is
    summed."""
    lhs, out = eq.replace(" ", "").split("->")
    ia, ib = lhs.split(",")
    size = dict(zip(ia, a.shape)) | dict(zip(ib, b.shape))
    batch = [c for c in ia if c in ib and c in out]
    summed = [c for c in ia if c in ib and c not in out]
    free_a = [c for c in ia if c not in ib]
    free_b = [c for c in ib if c not in ia]

    def prod(axes):
        n = 1
        for c in axes:
            n *= size[c]
        return n

    a3 = a.permute(*[ia.index(c) for c in batch + free_a + summed]).reshape(
        prod(batch), prod(free_a), prod(summed))
    b3 = b.permute(*[ib.index(c) for c in batch + summed + free_b]).reshape(
        prod(batch), prod(summed), prod(free_b))
    res = _bmm_f32acc(a3, b3).reshape([size[c] for c in
                                       batch + free_a + free_b])
    order = batch + free_a + free_b
    return res.permute(*[order.index(c) for c in out])
