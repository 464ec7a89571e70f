"""Public entry points of the serve GEMMs (port of repro.kernels.ops).

Dispatch is by the device of the activations, and nothing else:

  * a CUDA tensor launches the codec's hand-written kernel, or raises
    (wrong dtype, K % 32 != 0, a non-contiguous operand) -- there is no
    fallback, shape rule or switch that sends the card to the plain version;
  * a CPU tensor runs the plain PyTorch version of ``kernels.ref``.

The kernels take any M and N (the row and column edges are masked inside
the kernel), so unlike the reference nothing here pads rows or picks a
TPU row block.
"""
from __future__ import annotations

import torch

from . import ref
from .m2xfp_matmul import KERNEL as M2XFP_KERNEL
from .mxfp4_matmul import KERNEL as MXFP4_KERNEL

__all__ = ["m2xfp_matmul", "mxfp4_matmul", "packed_matmul"]


def _dispatch(x: torch.Tensor, w_packed: dict, kernel, plain_fn):
    """The kernel and the plain version each check their own operands."""
    if x.is_cuda:
        return kernel(x, w_packed)
    if x.device.type == "cpu":
        return plain_fn(x, w_packed)
    raise ValueError(f"no serve GEMM for device {x.device}")


def m2xfp_matmul(x: torch.Tensor, w_packed: dict) -> torch.Tensor:
    """x (M, K) @ Sg-EM-packed W (K, N) -> f32 (M, N)."""
    return _dispatch(x, w_packed, M2XFP_KERNEL, ref.m2xfp_matmul_ref)


def mxfp4_matmul(x: torch.Tensor, w_packed: dict) -> torch.Tensor:
    """x (M, K) @ MXFP4-packed W (K, N) -> f32 (M, N)."""
    return _dispatch(x, w_packed, MXFP4_KERNEL, ref.mxfp4_matmul_ref)


def packed_matmul(x: torch.Tensor, w_packed: dict, fmt: str) -> torch.Tensor:
    """Codec-dispatched packed GEMM: x (M, K) @ ``fmt``-packed W -> f32."""
    from repro_torch.core.codecs import get_codec, kernel_codecs
    codec = get_codec(fmt)
    if codec.kernel is None:
        raise ValueError(f"codec {fmt!r} has no serve kernel; kernel-backed "
                         f"codecs: {', '.join(kernel_codecs())}")
    return codec.kernel(x, w_packed)
