"""GPipe-style pipeline over a 'pipe' mesh dim (port of
repro.distributed.pipeline).

Stages hold contiguous layer blocks and microbatches stream through them:
the classic GPipe fill-drain, T = n_micro + n_stages - 1 ticks, bubble
fraction (n_stages - 1) / T. Each rank of the 'pipe' dim runs its stage
once a tick: stage 0 takes microbatch clip(t), every other stage the
output its upstream stage produced the tick before, handed over point to
point (``batch_isend_irecv`` on the pipe dim's process group). The last
stage's outputs for ticks [n_stages - 1, T) are the results; they are
all-reduced over the dim with zeros on the other stages, so every rank
returns them. Forward only, like the reference (``stage_fn`` is a plain
function, not an autograd ``nn.Module`` stage).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map

__all__ = ["pipeline_apply"]


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor,
                   mesh, n_stages: int, axis: str = "pipe") -> torch.Tensor:
    """Run ``stage_fn(params_i, h) -> h`` over ``n_stages`` pipeline
    stages on ``mesh``'s ``axis`` dim (a ``DeviceMesh``; its size must be
    ``n_stages``).

    stage_params: a tree whose leaves have leading dim n_stages (stage i's
    params at index i). x: (n_micro, mb, ...) microbatched input, the same
    on every rank. ``stage_fn`` keeps the microbatch's shape and dtype.
    Returns the (n_micro, mb, ...) outputs after all stages, on every
    rank."""
    group = mesh.get_group(axis)
    if dist.get_world_size(group) != n_stages:
        raise ValueError(f"mesh dim {axis!r} has "
                         f"{dist.get_world_size(group)} ranks for "
                         f"{n_stages} stages")
    idx = mesh.get_local_rank(axis)
    ranks = dist.get_process_group_ranks(group)
    params = tree_map(lambda a: a[idx], stage_params)
    n_micro = x.shape[0]
    ticks = n_micro + n_stages - 1
    h_prev = torch.zeros_like(x[0])           # from upstream, last tick
    outs = []
    for t in range(ticks):
        h_in = x[min(max(t, 0), n_micro - 1)] if idx == 0 else h_prev
        h_out = stage_fn(params, h_in)
        outs.append(h_out)
        ops = []
        if idx + 1 < n_stages:
            ops.append(dist.P2POp(dist.isend, h_out.contiguous(),
                                  ranks[idx + 1], group))
        if idx > 0:
            h_prev = torch.empty_like(x[0])
            ops.append(dist.P2POp(dist.irecv, h_prev, ranks[idx - 1],
                                  group))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
    result = torch.stack(outs[n_stages - 1:])
    if idx != n_stages - 1:
        result = torch.zeros_like(result)
    dist.all_reduce(result, group=group)
    return result
