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
the mixture-of-experts FFN (dispatch, the per-expert products, combine)
and of the training attention: on the card as one batched product, bf16
with f32 accumulation and output (f32 operands when the second is f32).

Gradients (training): on the CPU, autograd differentiates the float64
product and each cast, so a bf16 operand's gradient is the float64
product of the f32 cotangent, rounded to bf16 where the forward cast it,
as JAX's transpose of ``astype`` rounds it. On the card, a product that
needs a gradient runs through ``_CardProduct``, whose backward takes both
products in IEEE f32 (no TF32) from the f32 cotangent and the operands'
f32 values, then casts each gradient to its operand's dtype: the same
rounding points, with f32 in place of float64 accumulation.
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


def _card_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N), or batched (B, M, K) @ (B, K, N), on the card
    -> f32: an f32 ``b`` keeps f32 operands (IEEE, no TF32); any other is
    taken as bf16-exact, a bf16 product with f32 accumulation and output."""
    mm = torch.mm if a.dim() == 2 else torch.bmm
    if b.dtype == torch.float32:
        with _ieee_f32_matmul():
            return mm(a.to(torch.float32), b)
    return mm(a.to(torch.bfloat16), b.to(torch.bfloat16),
              out_dtype=torch.float32)


class _CardProduct(torch.autograd.Function):
    """``_card_product`` with a backward of IEEE f32 products: grad_a =
    g @ b^T and grad_b = a^T @ g from the f32 cotangent ``g`` and the
    operands' f32 values, each cast to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _card_product(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        with _ieee_f32_matmul():
            if ctx.needs_input_grad[0]:
                ga = torch.matmul(g, b.to(torch.float32).transpose(-1, -2))
                ga = ga.to(a.dtype)
            if ctx.needs_input_grad[1]:
                gb = torch.matmul(a.to(torch.float32).transpose(-1, -2), g)
                gb = gb.to(b.dtype)
        return ga, gb


def _f32acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) or (B, M, K) @ (B, K, N) -> f32: float64
    accumulation on the CPU, ``_card_product`` on the card (through
    ``_CardProduct`` when a gradient is wanted)."""
    if a.device.type == "cpu":
        return dot_f64acc(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _CardProduct.apply(a, b)
    return _card_product(a, b)


def dot_f32acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) -> f32 (..., N), accumulated in f32 or wider.
    An f32 ``w`` keeps f32 operands; any other is taken as bf16-exact."""
    if x.device.type == "cpu":
        return dot_f64acc(x, w)
    out = _f32acc(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


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
    res = _f32acc(a3, b3).reshape([size[c] for c in
                                       batch + free_a + free_b])
    order = batch + free_a + free_b
    return res.permute(*[order.index(c) for c in out])
