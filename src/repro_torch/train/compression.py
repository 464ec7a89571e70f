"""Gradient compression with error feedback (port of
repro.train.compression): top-k sparsification (keep the entries of the
k largest magnitudes of a leaf) and int8 quantization (a symmetric
per-leaf scale), applied to ``gradient + carried error``; what a step
drops is carried into the next.

``compress_decompress`` is the single-leaf transform. ``compressed_psum``
is the cross-pod mean of compressed gradients: every rank of the 'pod'
mesh dim calls it with its own gradients, over that dim's process group
(the reference runs it inside ``shard_map`` over the 'pod' axis).

A leaf here is a leaf of the reference's layout: the per-layer leaves that
the reference stacks on axis 0 (one path under a ``convert.STACKED`` list)
share one top-k threshold and one int8 scale, as the stacked leaf does
there.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.convert import STACKED
from repro_torch.core.dtypes import div_const
from repro_torch.tree import tree_leaves, tree_map

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


def _reference_leaves(tree) -> list:
    """Groups of ``tree``'s leaves (lists of tensors, in ``tree_leaves``
    order of their first member) that form one leaf of the reference's
    layout: the blocks of a ``STACKED`` list at one path, or one leaf."""
    if not isinstance(tree, dict):
        return [[t] for t in tree_leaves(tree)]
    groups = []
    for k, v in tree.items():
        if k in STACKED and isinstance(v, list) and v:
            per_block = [tree_leaves(b) for b in v]
            groups.extend([list(g) for g in zip(*per_block)])
        else:
            groups.extend([[t] for t in tree_leaves(v)])
    return groups


def _topk_mask_group(xs: list, density: float) -> list:
    """``_topk_mask`` over the concatenation of ``xs``, split back."""
    if density >= 1.0 or len(xs) == 1:
        return [_topk_mask(x, density) for x in xs]
    flat = torch.cat([x.abs().reshape(-1) for x in xs])
    k = max(1, int(flat.shape[0] * density))
    thresh = torch.topk(flat, k).values[-1]
    return [x.abs() >= thresh for x in xs]


def compressed_psum(grads, err_state, cfg: CompressionConfig, group,
                    n_pods: int):
    """Cross-pod mean of gradients with compression and error feedback.

    Every rank of the pod dim calls it with its own ``grads`` and
    ``err_state`` (trees of the same structure); ``group`` is the pod dim's
    process group (``mesh.get_group("pod")``; the reference's
    ``axis_name``), of ``n_pods`` ranks. Per leaf of the reference's
    layout: x = g + err, top-k kept; with int8, the scale is the pods'
    largest |kept| (one ``all_reduce(MAX)`` of every leaf's local amax) /
    127, the int8 codes are summed as int32 (one ``all_reduce(SUM)``,
    exact for <= 2^23 pods) and rescaled, ``/ n_pods``. Returns (the mean,
    new error feedback = x - what this pod sent); with one pod the mean is
    ``compress_decompress``'s output, bit for bit."""
    flat_g, flat_e = tree_leaves(grads), tree_leaves(err_state)
    pos = {id(t): i for i, t in enumerate(flat_g)}
    xs = [g.to(torch.float32) + e for g, e in zip(flat_g, flat_e)]
    kept = [None] * len(xs)
    groups = [[pos[id(t)] for t in members]
              for members in _reference_leaves(grads)]
    for members in groups:
        masks = _topk_mask_group([xs[i] for i in members],
                                 cfg.topk_density)
        for i, m in zip(members, masks):
            kept[i] = torch.where(m, xs[i], 0.0)
    if cfg.int8:
        amax = torch.stack([torch.stack([kept[i].abs().amax()
                                         for i in members]).amax()
                            for members in groups])
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scales = torch.where(amax == 0, 1.0, div_const(amax, 127.0))
        scale = [None] * len(xs)
        for j, members in enumerate(groups):
            for i in members:
                scale[i] = scales[j]
        qs = [torch.clamp(torch.round(k / s), -127, 127).to(torch.int8)
              for k, s in zip(kept, scale)]
        summed = torch.cat([q.to(torch.int32).reshape(-1) for q in qs])
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        reduced, sent, at = [], [], 0
        for q, s in zip(qs, scale):
            n = q.numel()
            part = summed[at:at + n].reshape(q.shape)
            at += n
            reduced.append(div_const(part.to(torch.float32) * s, n_pods))
            sent.append(q.to(torch.float32) * s)
    else:
        summed = torch.cat([k.reshape(-1) for k in kept])
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        reduced, at = [], 0
        for k in kept:
            reduced.append(div_const(summed[at:at + k.numel()].reshape(
                k.shape), n_pods))
            at += k.numel()
        sent = kept
    red = tree_map(lambda g: reduced[pos[id(g)]].to(g.dtype), grads)
    new_err = tree_map(lambda g: xs[pos[id(g)]] - sent[pos[id(g)]], grads)
    return red, new_err
