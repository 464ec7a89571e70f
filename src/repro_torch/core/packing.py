"""Group reshapes of the MX layouts (port of repro.core.packing)."""
from __future__ import annotations

import torch

__all__ = ["group_reshape", "group_unreshape"]


def group_reshape(x: torch.Tensor, group: int) -> torch.Tensor:
    """(..., n) -> (..., n // group, group). n must divide evenly."""
    n = x.shape[-1]
    if n % group:
        raise ValueError(f"last dim {n} not divisible by group {group}")
    return x.reshape(*x.shape[:-1], n // group, group)


def group_unreshape(x: torch.Tensor) -> torch.Tensor:
    """(..., n_groups, group) -> (..., n)."""
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
