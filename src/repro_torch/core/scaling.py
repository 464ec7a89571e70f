"""Shared-scale (E8M0) rules of the MX formats (port of repro.core.scaling).

The shared scale of a group is S = 2^E derived from the block maximum
``amax``. Five rules from the paper (Sec. 6.4, Tbl. 8):

  floor : E = floor(log2(amax / P))   (OCP default; P = 4, FP4's largest PoT)
  ceil  : E = ceil (log2(amax / M))   (M = 6, FP4's largest value)
  rtn1  : E = round(log2(amax / M))
  rtn2  : E = round(log2(amax / P))
  rtne  : rounds amax in value space then floors; for FP4 (M = 1.5 P) this
          is identical to ``ceil`` (paper Sec. 6.4), as implemented here.

floor and ceil are exact (``floor_log2``). rtn1 and rtn2 round a log2
correctly rounded to f32 (``log2_f32``): the same on the CPU and the card,
where XLA's f32 log2 is a few ulps off, so a value within a few ulps of a
half-integer can round the other way in the reference (ROADMAP, queue C).
E is clamped to [-126, 127] so every scale is a normal f32; amax == 0
gives E = 0 (S = 1).
"""
from __future__ import annotations

import torch

from .dtypes import (
    FP4_E2M1, FloatSpec, div_const, exp2int, floor_log2, log2_f32,
)

__all__ = ["SCALE_RULES", "shared_scale_exponent", "e8m0_encode",
           "e8m0_decode"]

SCALE_RULES = ("floor", "ceil", "rtn1", "rtn2", "rtne")

_E8M0_MIN, _E8M0_MAX = -126, 127


def _ceil_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact ceil(log2(x)) for x > 0."""
    fl = floor_log2(x)
    return torch.where(x == exp2int(fl), fl, fl + 1)


def shared_scale_exponent(amax: torch.Tensor, rule: str = "floor",
                          spec: FloatSpec = FP4_E2M1) -> torch.Tensor:
    """int32 exponent E of the shared scale 2^E per group, by ``rule``."""
    amax = amax.to(torch.float32)
    safe = amax.clamp_min(1e-30)
    # a division by the power of two P is exact on every device; one by M
    # goes through div_const
    if rule == "floor":
        e = floor_log2(safe / spec.max_pow2)
    elif rule in ("ceil", "rtne"):
        e = _ceil_log2(div_const(safe, spec.max_value))
    elif rule == "rtn1":
        e = torch.round(log2_f32(div_const(safe, spec.max_value)))
    elif rule == "rtn2":
        e = torch.round(log2_f32(safe / spec.max_pow2))
    else:
        raise ValueError(f"unknown scale rule {rule!r}; one of {SCALE_RULES}")
    e = torch.where(amax == 0, 0, e.to(torch.int32))
    return e.clamp(_E8M0_MIN, _E8M0_MAX)


def e8m0_encode(e: torch.Tensor) -> torch.Tensor:
    """Exponent -> biased u8 byte (bias 127)."""
    return (e.clamp(_E8M0_MIN, _E8M0_MAX) + 127).to(torch.uint8)


def e8m0_decode(b: torch.Tensor) -> torch.Tensor:
    """Biased u8 byte -> scale 2^E as f32 (exact)."""
    return exp2int(b.to(torch.int32) - 127)
