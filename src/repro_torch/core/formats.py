"""OCP MXFP4, the paper's baseline format (port of the MXFP4 part of
repro.core.formats): groups of 32 along the last axis share an E8M0 scale
(floor rule) and every element rounds to FP4 E2M1."""
from __future__ import annotations

import torch

from .dtypes import FP4_E2M1, exp2int, round_to_grid
from .packing import group_reshape, group_unreshape
from .scaling import shared_scale_exponent

__all__ = ["quantize_mxfp4", "mxfp4_components"]


def mxfp4_components(x: torch.Tensor):
    """MXFP4 split into (unscaled FP4 grid values (..., ng, group), scale
    exponent (..., ng, 1)); the dequantized tensor is fp4 * 2^E."""
    xg = group_reshape(x.to(torch.float32), 32)
    e = shared_scale_exponent(xg.abs().amax(dim=-1, keepdim=True))
    return round_to_grid(xg / exp2int(e), FP4_E2M1), e


def quantize_mxfp4(x: torch.Tensor) -> torch.Tensor:
    """MXFP4 fake-quant (quantize then dequantize), in ``x``'s dtype."""
    q, e = mxfp4_components(x)
    return group_unreshape(q * exp2int(e)).to(x.dtype)
