"""Baseline MX-family quantizers, fake-quant: quantize then dequantize
(port of repro.core.formats).

All work group-wise along the last axis and return a tensor of the input's
shape and dtype. They are the paper's comparison formats (Fig. 3, Tbl. 2/3):

  fp4_fp16scale : group FP4 with an exact (FP16-precision) scale amax/6
  mxfp4         : OCP MXFP4 -- group 32, E8M0 shared scale (rule
                  configurable)
  nvfp4         : NVIDIA NVFP4 -- group 16, FP8 E4M3 scale + f32 tensor
                  scale
  smx4          : Shared Microexponents (SMX4) -- group 16, INT3 elements,
                  a 1-bit micro-exponent per pair of elements

Every operation runs in the order the reference's code states it. A
division by a constant that is not a power of two goes through
``div_const``, so it is a division on the card as on the CPU (the
reference's jit multiplies by the reciprocal instead: ROADMAP, queue C).
"""
from __future__ import annotations

import torch

from .dtypes import (
    FP4_E2M1, FP8_E4M3, div_const, exp2int, log2_f32, round_to_grid,
)
from .packing import group_reshape, group_unreshape
from .scaling import shared_scale_exponent

__all__ = [
    "quantize_fp4_fp16scale", "quantize_mxfp4", "quantize_nvfp4",
    "quantize_smx4", "mxfp4_components", "nvfp4_scales",
]


def _group_amax(xg: torch.Tensor) -> torch.Tensor:
    return xg.abs().amax(dim=-1, keepdim=True)


def quantize_fp4_fp16scale(x: torch.Tensor, group: int = 32) -> torch.Tensor:
    """Group FP4 with a precise scale s = amax / 6 (the 'FP4' line of
    Fig. 3)."""
    xg = group_reshape(x.to(torch.float32), group)
    s = div_const(_group_amax(xg), FP4_E2M1.max_value)
    s = torch.where(s == 0, 1.0, s)
    q = round_to_grid(xg / s, FP4_E2M1)
    return group_unreshape(q * s).to(x.dtype)


def mxfp4_components(x: torch.Tensor, group: int = 32, rule: str = "floor"):
    """MXFP4 split into (unscaled FP4 grid values (..., ng, group), scale
    exponent (..., ng, 1)); the dequantized tensor is fp4 * 2^E."""
    xg = group_reshape(x.to(torch.float32), group)
    e = shared_scale_exponent(_group_amax(xg), rule)
    return round_to_grid(xg / exp2int(e), FP4_E2M1), e


def quantize_mxfp4(x: torch.Tensor, group: int = 32,
                   rule: str = "floor") -> torch.Tensor:
    """OCP MXFP4 fake-quant: E8M0 shared scale (default floor rule), FP4
    E2M1 elements."""
    q, e = mxfp4_components(x, group, rule)
    return group_unreshape(q * exp2int(e)).to(x.dtype)


def nvfp4_scales(x: torch.Tensor, group: int):
    """NVFP4's scales of ``x`` (groups along the last axis): (groups
    (..., ng, group) f32, E4M3 group scales s8 (..., ng, 1), per-tensor f32
    scale t (0-dim), element scales s8 * t (..., ng, 1), 1 where 0).

      t  = amax_tensor / (448 * 6)   (1 if 0)
      s8 = RTNE_e4m3(amax_group / (6 t))
    """
    xf = x.to(torch.float32)
    xg = group_reshape(xf, group)
    t = div_const(xf.abs().amax(), FP8_E4M3.max_value * FP4_E2M1.max_value)
    t = torch.where(t == 0, 1.0, t)
    s8 = round_to_grid(_group_amax(xg) / (FP4_E2M1.max_value * t), FP8_E4M3)
    s = s8 * t
    return xg, s8, t, torch.where(s == 0, 1.0, s)


def quantize_nvfp4(x: torch.Tensor, group: int = 16) -> torch.Tensor:
    """NVFP4 fake-quant: FP8 (E4M3) group scale times an f32 per-tensor
    scale, FP4 elements (``nvfp4_scales``)."""
    xg, _, _, s = nvfp4_scales(x, group)
    q = round_to_grid(xg / s, FP4_E2M1)
    return group_unreshape(q * s).to(x.dtype)


def quantize_smx4(x: torch.Tensor, group: int = 16,
                  pair: int = 2) -> torch.Tensor:
    """SMX4 (Shared Microexponents): two-level block floating point.

    A group of 16 shares an 8-bit scale 2^E with E = ceil(log2(amax / 3)),
    so the group max maps into [-3, 3]; each pair of neighbours shares a
    1-bit micro-exponent b selecting the finer scale 2^(E-1) when the pair
    still fits. Elements are symmetric INT3 (range [-3, 3])."""
    int3_max = 3.0
    xg = group_reshape(x.to(torch.float32), group)
    amax = _group_amax(xg)
    safe = amax.clamp_min(1e-30)
    e = torch.ceil(log2_f32(div_const(safe, int3_max)))
    e = torch.where(amax == 0, 0.0, e)
    s = exp2int(e.to(torch.int32))
    xp = xg.reshape(*xg.shape[:-1], group // pair, pair)
    pmax = xp.abs().amax(dim=-1, keepdim=True)
    b = (pmax <= int3_max * s[..., None] / 2).to(torch.int32)
    sp = s[..., None] * exp2int(-b)
    q = torch.round(xp / sp).clamp(-int3_max, int3_max)
    return group_unreshape((q * sp).reshape(xg.shape)).to(x.dtype)
