"""Public entry points of the packed GEMMs and the quantize engine (port of
repro.kernels.ops).

Dispatch is by the device of the activations, and nothing else:

  * a CUDA tensor launches the hand-written kernel, or raises (wrong dtype,
    K % 32 != 0, a non-contiguous operand) -- there is no fallback, shape
    rule or switch that sends the card to the plain version;
  * a CPU tensor runs the plain PyTorch version of ``kernels.ref``.

The kernels take any M and N (the row and column edges are masked inside
the kernel), so unlike the reference nothing here pads rows, picks a TPU
block or requires blocks to divide M, N or K.

``packed_matmul`` -- the model's one entry into a packed GEMM -- runs
inside ``product_scope(x, w_packed, n)`` when a step counter sets it
(``repro_torch.analysis.step_cost``): the counter takes the product as
one operation, whatever runs inside (the kernel, which it cannot see, or
the plain version's decode and product). A "meta" x (a step counted on
shapes alone) gives the (M, N) f32 output without computing it.
"""
from __future__ import annotations

import contextlib

import torch

from . import ref
from .m2xfp_matmul import KERNEL as M2XFP_KERNEL
from .m2xfp_matmul import QKERNEL as QMATMUL_KERNEL
from .m2xfp_quantize import KERNEL as QUANTIZE_KERNEL
from .mxfp4_matmul import KERNEL as MXFP4_KERNEL

__all__ = [
    "m2xfp_matmul", "m2xfp_qmatmul", "m2xfp_quantize", "mxfp4_matmul",
    "packed_matmul",
]


def _dispatch(x: torch.Tensor, args: tuple, kernel, plain_fn):
    """The kernel and the plain version each check their own operands."""
    if x.is_cuda:
        return kernel(*args)
    if x.device.type == "cpu":
        return plain_fn(*args)
    raise ValueError(f"no kernel for device {x.device}")


def m2xfp_matmul(x: torch.Tensor, w_packed: dict) -> torch.Tensor:
    """x (M, K) @ Sg-EM-packed W (K, N) -> f32 (M, N)."""
    return _dispatch(x, (x, w_packed), M2XFP_KERNEL, ref.m2xfp_matmul_ref)


def mxfp4_matmul(x: torch.Tensor, w_packed: dict) -> torch.Tensor:
    """x (M, K) @ MXFP4-packed W (K, N) -> f32 (M, N)."""
    return _dispatch(x, (x, w_packed), MXFP4_KERNEL, ref.mxfp4_matmul_ref)


def m2xfp_qmatmul(x_packed: dict, w_packed: dict) -> torch.Tensor:
    """Fully packed W4A4 GEMM: Elem-EM X (K-major) @ Sg-EM W -> f32 (M, N)."""
    return _dispatch(x_packed["codes"], (x_packed, w_packed), QMATMUL_KERNEL,
                     ref.m2xfp_qmatmul_ref)


def m2xfp_quantize(x: torch.Tensor) -> dict:
    """Online Elem-EM quantize of activations x (M, K) -> packed streams in
    the K-major kernel layout (feeds m2xfp_qmatmul)."""
    return _dispatch(x, (x,), QUANTIZE_KERNEL,
                     lambda x: ref.m2xfp_quantize_ref(x.T))


# set by a step counter: called as product_scope(x, w_packed, n), it gives
# the context each packed product runs in (module docstring)
product_scope = None


def packed_matmul(x: torch.Tensor, w_packed: dict, fmt: str) -> torch.Tensor:
    """Codec-dispatched packed GEMM: x (M, K) @ ``fmt``-packed W -> f32."""
    from repro_torch.core.codecs import get_codec, kernel_codecs
    codec = get_codec(fmt)
    if codec.kernel is None:
        raise ValueError(f"codec {fmt!r} has no serve kernel; kernel-backed "
                         f"codecs: {', '.join(kernel_codecs())}")
    n = w_packed["codes"].shape[-1]
    scope = contextlib.nullcontext() if product_scope is None \
        else product_scope(x, w_packed, n)
    with scope:
        if x.is_meta:
            return torch.empty((x.shape[0], n), dtype=torch.float32,
                               device="meta")
        return codec.kernel(x, w_packed)
