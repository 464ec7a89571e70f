"""Plain PyTorch versions of the two serve kernels (port of repro.kernels.ref).

Each decodes the packed streams exactly and takes the product of the
bf16-rounded activations with the decoded weight. They are the oracles of
the CUDA kernels: the CPU tests use them, ``chip_smoke.py`` compares the
kernels with them on the card, and the serve dispatch runs them for tensors
that lie on the CPU.

Accumulation: the product is taken in float64 and rounded to f32. Every
operand is bf16-exact, so each product is exact in float64 and the rounded
sum is row-independent in practice, where an f32 ``torch.matmul`` on the
CPU is not (its blocking depends on M, so a row of a 1-row product can
differ bit-wise from the same row of a 64-row product). Chunked prefill
relies on row independence to stay bit-identical to sequential decode.
"""
from __future__ import annotations

import torch

from repro_torch.core.dtypes import fp4_code_to_value
from repro_torch.core.scaling import e8m0_decode
from .layout import GROUP, N_SUB, SUBGROUP, interleave_unpack

__all__ = [
    "dot_f64acc", "decode_w_sgem_ref", "decode_w_mxfp4_ref",
    "m2xfp_matmul_ref", "mxfp4_matmul_ref",
]


def dot_f64acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) with float64 accumulation, rounded to f32."""
    return torch.matmul(x.to(torch.float64), w.to(torch.float64)).to(
        torch.float32)


def _signed_mag(codes: torch.Tensor) -> torch.Tensor:
    mag = fp4_code_to_value(codes & 7)
    return torch.where((codes & 8) != 0, -mag, mag)


def _group_scales(scales: torch.Tensor) -> torch.Tensor:
    """u8 (K/32, N) -> f32 2^(s-127) broadcastable over (K/32, 32, N)."""
    return e8m0_decode(scales)[:, None, :]


def decode_w_sgem_ref(packed: dict) -> torch.Tensor:
    """Sg-EM packed weight streams -> dense f32 (K, N), exact:
    fp4 * (1 + meta/4) * 2^(scale-127)."""
    codes = interleave_unpack(packed["codes"])
    k, n = codes.shape
    meta = packed["meta"].to(torch.int32)
    fields = torch.stack([(meta >> (2 * j)) & 0x3 for j in range(N_SUB)],
                         dim=1).to(torch.float32)          # (K/32, 4, N)
    mult = (1.0 + fields / 4.0).repeat_interleave(SUBGROUP, dim=1)
    w = _signed_mag(codes).reshape(k // GROUP, GROUP, n) * mult \
        * _group_scales(packed["scales"])
    return w.reshape(k, n)


def decode_w_mxfp4_ref(packed: dict) -> torch.Tensor:
    """MXFP4 packed weight streams -> dense f32 (K, N): fp4 * 2^(scale-127)."""
    codes = interleave_unpack(packed["codes"])
    k, n = codes.shape
    w = _signed_mag(codes).reshape(k // GROUP, GROUP, n) \
        * _group_scales(packed["scales"])
    return w.reshape(k, n)


def _check_k(x: torch.Tensor) -> None:
    k = x.shape[-1]
    if k % GROUP:
        raise ValueError(f"K={k} is not a multiple of the {GROUP}-element "
                         f"quantization group")


def m2xfp_matmul_ref(x: torch.Tensor, w_packed: dict) -> torch.Tensor:
    """bf16(x) (M, K) @ Sg-EM-packed W (K, N) -> f32 (M, N)."""
    _check_k(x)
    return dot_f64acc(x.to(torch.bfloat16), decode_w_sgem_ref(w_packed))


def mxfp4_matmul_ref(x: torch.Tensor, w_packed: dict) -> torch.Tensor:
    """bf16(x) (M, K) @ MXFP4-packed W (K, N) -> f32 (M, N)."""
    _check_k(x)
    return dot_f64acc(x.to(torch.bfloat16), decode_w_mxfp4_ref(w_packed))
