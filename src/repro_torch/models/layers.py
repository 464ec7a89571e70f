"""Shared model layers: norms, rotary embeddings, logit soft-capping, MLP,
embedding table (port of repro.models.layers). bf16 rounds at the
reference's points: the norm, the rotation and the soft-cap compute in f32
and cast back to the input dtype, and ``silu`` runs in f32 before the cast
to bf16.

The norm's sum of squares is folded in halves with elementwise adds, in an
order fixed by the width alone. A library reduction on the card picks its
order from the number of rows, so a row normed among B*T rows in chunked
prefill could differ by an ulp from the same row normed among B in decode,
and one ulp can flip an m2xfp top-1 and an FP4 rounding downstream."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dtypes import div_const
from .quant import init_linear, quantized_matmul

__all__ = [
    "rms_norm", "rope_freqs", "apply_rope", "softcap", "init_mlp",
    "mlp_apply", "init_embedding",
]


def _sum_halves(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, keeping it: fold the axis in halves
    (``x[..., :h] + x[..., h:2h]``) until one element is left; an odd length
    carries its last element into the next fold. Each fold is elementwise,
    so a row's sum has the same bits however many rows share the call."""
    while x.shape[-1] > 1:
        n, h = x.shape[-1], x.shape[-1] // 2
        folded = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([folded, x[..., 2 * h:]], dim=-1) if n % 2 else folded
    return x


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = _sum_halves(xf * xf) / xf.shape[-1]
    out = xf * torch.rsqrt(var + eps) * w.to(torch.float32)
    return out.to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device="cuda") -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, D); positions: (B, S) int."""
    inv = rope_freqs(x.shape[-1], theta, x.device)            # (D/2,)
    ang = positions[..., None].to(torch.float32) * inv        # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma2-style logit soft-capping: ``cap * tanh(x / cap)`` in f32,
    cast back to ``x``'s dtype; ``cap`` None returns ``x``. The division is
    ``div_const``'s, so the card divides as the CPU does."""
    if cap is None:
        return x
    return (cap * torch.tanh(div_const(x.to(torch.float32), cap))).to(
        x.dtype)


def init_mlp(gen: torch.Generator, d: int, ff: int, device="cuda") -> dict:
    return {
        "gate": init_linear(gen, d, ff, device),
        "up": init_linear(gen, d, ff, device),
        "down": init_linear(gen, ff, d, device),
    }


def mlp_apply(p: dict, x: torch.Tensor, quant: str = "none") -> torch.Tensor:
    """SwiGLU: down(silu(gate(x)) * up(x))."""
    g = quantized_matmul(x, p["gate"], quant)
    u = quantized_matmul(x, p["up"], quant)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    return quantized_matmul(h, p["down"], quant)


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   device="cuda") -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                        device=device) * 0.02).to(torch.bfloat16)
