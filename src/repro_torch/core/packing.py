"""Group reshapes and the KV pages' bit packing (port of
repro.core.packing).

The nibble and meta packers are the packed KV cache's own layout: codes are
paired along the last axis, even index in the low nibble; the 2-bit fields
of four subgroups share a byte, subgroup j in bits 2j..2j+1. They are not
the weight layout's group-half interleave (``kernels/layout.py``).
"""
from __future__ import annotations

import torch

__all__ = [
    "group_reshape", "group_unreshape", "pack_nibbles", "unpack_nibbles",
    "pack_meta2", "unpack_meta2",
]


def group_reshape(x: torch.Tensor, group: int) -> torch.Tensor:
    """(..., n) -> (..., n // group, group). n must divide evenly."""
    n = x.shape[-1]
    if n % group:
        raise ValueError(f"last dim {n} not divisible by group {group}")
    return x.reshape(*x.shape[:-1], n // group, group)


def group_unreshape(x: torch.Tensor) -> torch.Tensor:
    """(..., n_groups, group) -> (..., n)."""
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """int 4-bit codes (..., n) with n even -> u8 (..., n // 2)."""
    c = codes.to(torch.uint8) & 0xF
    return c[..., 0::2] | (c[..., 1::2] << 4)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """u8 (..., n // 2) -> int32 4-bit codes (..., n)."""
    lo = (packed & 0xF).to(torch.int32)
    hi = (packed >> 4).to(torch.int32)
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)


def pack_meta2(meta: torch.Tensor) -> torch.Tensor:
    """2-bit fields (..., n_sub) with n_sub a multiple of 4 -> u8
    (..., n_sub // 4). The fields are ORed, so no order of summation
    enters."""
    m = (meta.to(torch.uint8) & 0x3).reshape(*meta.shape[:-1], -1, 4)
    return m[..., 0] | (m[..., 1] << 2) | (m[..., 2] << 4) | (m[..., 3] << 6)


def unpack_meta2(packed: torch.Tensor, n_sub: int) -> torch.Tensor:
    """u8 (..., n_sub // 4) -> int32 2-bit fields (..., n_sub)."""
    fields = torch.stack([(packed >> s) & 0x3 for s in (0, 2, 4, 6)],
                         dim=-1)
    return fields.reshape(*packed.shape[:-1], n_sub).to(torch.int32)
