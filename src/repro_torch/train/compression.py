"""Gradient compression with error feedback (port of
repro.train.compression): top-k sparsification (keep the entries of the
k largest magnitudes of a leaf) and int8 quantization (a symmetric
per-leaf scale), applied to ``gradient + carried error``; what a step
drops is carried into the next.

``compress_decompress`` is the single-leaf transform. The reference's
``compressed_psum`` reduces compressed gradients across the pods of a
multi-pod mesh inside ``shard_map``; the port has no mesh, and it raises.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.dtypes import div_const
from repro_torch.tree import tree_map

__all__ = ["CompressionConfig", "init_error_feedback", "compress_decompress",
           "compressed_psum"]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = False
    int8: bool = True
    topk_density: float = 1.0       # 1.0 = no sparsification
    axis: str = "pod"               # mesh axis carrying the slow links


def init_error_feedback(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def _quant_int8(x: torch.Tensor):
    """int8 codes of ``x`` and their f32 scale max|x| / 127 (1 for an
    all-zero ``x``); codes are round-half-even, clipped to +-127."""
    scale = div_const(x.abs().amax(), 127.0)
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _topk_mask(x: torch.Tensor, density: float) -> torch.Tensor:
    """True where |x| is at least the k-th largest magnitude, k =
    max(1, int(x.numel() * density)), so ties at the threshold are all
    kept (``lax.top_k``'s k-th value, as in the reference)."""
    if density >= 1.0:
        return torch.ones_like(x, dtype=torch.bool)
    flat = x.abs().reshape(-1)
    k = max(1, int(flat.shape[0] * density))
    thresh = torch.topk(flat, k).values[-1]
    return x.abs() >= thresh


def compress_decompress(g: torch.Tensor, err: torch.Tensor,
                        cfg: CompressionConfig):
    """Single-leaf compress -> decompress with error feedback: returns
    (decompressed, new_err)."""
    x = g.to(torch.float32) + err
    kept = torch.where(_topk_mask(x, cfg.topk_density), x, 0.0)
    if cfg.int8:
        q, s = _quant_int8(kept)
        deq = q.to(torch.float32) * s
    else:
        deq = kept
    return deq, x - deq


def compressed_psum(grads, err_state, cfg: CompressionConfig,
                    axis_name: str, n_pods: int):
    """The reference's cross-pod mean of compressed gradients needs a
    multi-pod mesh, which the port does not have (ROADMAP A11)."""
    raise NotImplementedError(
        "compressed_psum reduces across the 'pod' axis of a multi-pod "
        "mesh; the torch port has no mesh yet (ROADMAP A11)")
