"""AdamW, the warmup-cosine schedule and global-norm clipping, from
scratch (port of repro.train.optimizer; explicit tensor arithmetic on the
leaves, no ``torch.optim``).

Layout: parameters are kept in f32 ("master"); the forward pass casts
matrix leaves to bf16 (``repro_torch.train.trainer.cast_for_compute``).
The moments m and v are f32 and mirror the parameter tree. A tree here is
a dict / list nesting of tensors (the port's parameter layout: per-layer
dicts in a list under "layers"), walked by ``repro_torch.tree``.

Scalar arithmetic follows the reference's f32 rounding points: Python
constants are rounded to f32 where they meet a tensor, the step is an f32
value, and a division by a constant goes through ``div_const`` (PyTorch's
CUDA division by a Python scalar multiplies by its reciprocal). The
bias-correction power ``b ** step`` and the schedule's cosine are taken
in float64 on f32 arguments and rounded once to f32, and the global norm
sums each leaf's f32 squares in float64, so the card and the CPU give the
same bits; against XLA's f32 ``pow``, ``cos`` and sums they may differ by
an ulp (``tests/test_torch_train.py`` states by how much).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.core.dtypes import div_const
from repro_torch.tree import tree_leaves, tree_map

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
    "warmup_cosine", "global_norm",
]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000


def _f32_of_f64(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of f32 ``x`` taken in float64, rounded once to f32."""
    return fn(x.to(torch.float64)).to(torch.float32)


def warmup_cosine(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (int tensor) -> learning rate (f32): linear warmup over
    ``warmup_steps``, then a cosine from ``lr`` to a tenth of it at
    ``total_steps``."""
    def sched(step):
        step = step.to(torch.float32)
        warm = div_const(step, max(cfg.warmup_steps, 1))
        t = div_const(step - cfg.warmup_steps,
                      max(cfg.total_steps - cfg.warmup_steps, 1))
        t = t.clamp(0.0, 1.0)
        cos = 0.5 * (1.0 + _f32_of_f64(torch.cos, math.pi * t))
        return cfg.lr * torch.where(step < cfg.warmup_steps, warm,
                                    0.1 + 0.9 * cos)
    return sched


def adamw_init(params) -> dict:
    def zeros(tree):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), tree)
    leaf = tree_leaves(params)[0]
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares (f32 squares, summed in
    float64, rounded to f32 before the root)."""
    sums = [x.to(torch.float32).square().sum(dtype=torch.float64)
            for x in tree_leaves(tree)]
    return torch.stack(sums).sum().to(torch.float32).sqrt()


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / max(norm, 1e-12)), norm)."""
    norm = global_norm(grads)
    scale = (norm.new_full((), max_norm) / norm.clamp_min(1e-12)).clamp_max(
        1.0)
    return tree_map(lambda g: g * scale, grads), norm


def adamw_update(params, grads, opt_state, cfg: AdamWConfig,
                 schedule=None):
    """One AdamW step. Decoupled weight decay on matrix (ndim >= 2) leaves.
    Returns (new_params, new_opt_state, metrics {"grad_norm", "lr"})."""
    step = opt_state["step"] + 1
    lr = (schedule or warmup_cosine(cfg))(step)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)

    b1, b2 = cfg.b1, cfg.b2
    step_f = step.to(torch.float32)

    def correction(b):                    # 1 - b ** step, b rounded to f32
        base = step_f.new_full((), b)
        return 1.0 - _f32_of_f64(lambda s: base.to(torch.float64) ** s,
                                 step_f)
    bc1, bc2 = correction(b1), correction(b2)

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m_new, v_new

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])

    def pick(i):                          # out's leaves are (p, m, v)
        return tree_map(lambda o: o[i], out)
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
