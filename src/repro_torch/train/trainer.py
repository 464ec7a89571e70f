"""Train step of the port (port of repro.train.trainer's plain path):
AdamW training with optional microbatch accumulation, on one device.

State layout (the reference's, with the port's parameter tree):
  state = {"params": f32 master tree, "opt": {"m", "v", "step"},
           "err": error-feedback tree (only when compression is on)}

The forward pass casts matrix leaves to bf16 (``cast_for_compute``);
gradients and the optimizer's arithmetic are f32. The cast's backward
hands AdamW an f32 gradient holding a bf16 value, as JAX's transpose of
``astype`` does.

Not ported (ROADMAP): the compressed cross-pod step and the mesh
shardings (``train_state_shardings``, ``batch_sharding``) need a
multi-pod mesh (A11); ``publish_train_metrics`` needs the metrics
registry (A7).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.model import init_params, loss_fn
from repro_torch.tree import tree_leaves, tree_map
from .compression import CompressionConfig, init_error_feedback
from .optimizer import AdamWConfig, adamw_init, adamw_update, warmup_cosine

__all__ = ["make_train_state", "make_train_step", "cast_for_compute"]


def cast_for_compute(params):
    """Master f32 -> compute dtypes: floating matrix leaves bf16, the rest
    (vectors) as they are."""
    return tree_map(lambda p: p.to(torch.bfloat16)
                    if p.dim() >= 2 and p.is_floating_point() else p, params)


def make_train_state(gen: torch.Generator, cfg,
                     compression: Optional[CompressionConfig] = None,
                     device="cuda") -> dict:
    """``init_params`` drawn from ``gen`` (a generator on ``device``), as
    f32 master parameters, with AdamW's zero moments (and the error
    feedback when ``compression`` is enabled)."""
    params = tree_map(lambda p: p.to(torch.float32)
                      if p.is_floating_point() else p,
                      init_params(gen, cfg, device))
    state = {"params": params, "opt": adamw_init(params)}
    if compression and compression.enabled:
        state["err"] = init_error_feedback(params)
    return state


def _loss_and_grads(params, cfg, batch):
    """(loss, gradients of ``loss_fn(cast_for_compute(params))`` with
    respect to every leaf of ``params``; zeros for a leaf the loss does not
    reach, as JAX gives)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = loss_fn(cast_for_compute(leaves), cfg, batch)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(zip(flat, grads))

    def take(_):
        p, g = next(it)
        return torch.zeros_like(p) if g is None else g
    return loss.detach(), tree_map(take, leaves)


def _grads_and_loss(params, cfg, batch: dict, num_microbatches: int):
    """Loss and gradients, accumulated over ``num_microbatches`` slices of
    the batch (axis 0) in the reference's order: loss and gradients summed
    microbatch by microbatch from zeros, then times ``1 / n``."""
    if num_microbatches <= 1:
        return _loss_and_grads(params, cfg, batch)
    n = num_microbatches
    loss, grads = 0.0, tree_map(torch.zeros_like, params)
    for i in range(n):
        mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
              for k, v in batch.items()}
        mb_loss, g = _loss_and_grads(params, cfg, mb)
        loss = loss + mb_loss
        grads = tree_map(torch.add, grads, g)
    inv = 1.0 / n
    return loss * inv, tree_map(lambda g: g * inv, grads)


def make_train_step(cfg, opt_cfg: AdamWConfig,
                    compression: Optional[CompressionConfig] = None,
                    num_microbatches: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the
    reference's plain path. ``batch`` is a dict of tensors on the
    parameters' device ({"tokens", "labels"}, or {"embeds", "labels"});
    ``metrics`` holds f32 tensors "loss", "grad_norm" and "lr". An enabled
    ``compression`` needs the multi-pod path, which is not ported."""
    if compression and compression.enabled:
        raise NotImplementedError(
            "the compressed train step reduces gradients across the 'pod' "
            "axis of a multi-pod mesh; the torch port has no mesh yet "
            "(ROADMAP A11)")
    schedule = warmup_cosine(opt_cfg)

    def train_step(state, batch):
        loss, grads = _grads_and_loss(state["params"], cfg, batch,
                                      num_microbatches)
        new_p, new_opt, metrics = adamw_update(
            state["params"], grads, state["opt"], opt_cfg, schedule)
        metrics["loss"] = loss
        new_state = {"params": new_p, "opt": new_opt}
        if "err" in state:
            new_state["err"] = state["err"]
        return new_state, metrics

    return train_step
