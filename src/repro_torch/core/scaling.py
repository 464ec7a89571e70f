"""E8M0 shared-scale rule of the MX formats (port of repro.core.scaling).

The slice needs the OCP default only, the floor rule
``E = floor(log2(amax / P))`` with P = 4, the largest power of two of FP4.
E is clamped to [-126, 127] so every scale is a normal f32; amax == 0
gives E = 0 (S = 1).
"""
from __future__ import annotations

import torch

from .dtypes import FP4_E2M1, exp2int, floor_log2

__all__ = ["shared_scale_exponent", "e8m0_encode", "e8m0_decode"]

_E8M0_MIN, _E8M0_MAX = -126, 127


def shared_scale_exponent(amax: torch.Tensor) -> torch.Tensor:
    """int32 exponent E of the shared scale 2^E per group (floor rule)."""
    amax = amax.to(torch.float32)
    safe = amax.clamp_min(1e-30)
    e = floor_log2(safe / FP4_E2M1.max_pow2)
    e = torch.where(amax == 0, 0, e)
    return e.to(torch.int32).clamp(_E8M0_MIN, _E8M0_MAX)


def e8m0_encode(e: torch.Tensor) -> torch.Tensor:
    """Exponent -> biased u8 byte (bias 127)."""
    return (e.clamp(_E8M0_MIN, _E8M0_MAX) + 127).to(torch.uint8)


def e8m0_decode(b: torch.Tensor) -> torch.Tensor:
    """Biased u8 byte -> scale 2^E as f32 (exact)."""
    return exp2int(b.to(torch.int32) - 127)
