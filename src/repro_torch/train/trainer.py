"""Train steps of the port (port of repro.train.trainer): AdamW training
with optional microbatch accumulation on one device, the compressed
cross-pod step, and a sharded (ZeRO-3) step over a ``DeviceMesh``.

State layout (the reference's, with the port's parameter tree):
  state = {"params": f32 master tree, "opt": {"m", "v", "step"},
           "err": error-feedback tree (only when compression is on)}

The forward pass casts to bf16 every floating leaf whose counterpart in
the reference's layer-stacked layout has two or more axes
(``cast_for_compute``); gradients and the optimizer's arithmetic are f32.
The cast's backward hands AdamW an f32 gradient holding a bf16 value, as
JAX's transpose of ``astype`` does.

Meshes: ``train_state_shardings`` places the state (m, v and err mirror
the parameters, step replicated) and ``batch_sharding`` the batch.
``make_train_step(..., compression=..., mesh=...)`` is the reference's
compressed path: each pod rank takes its slice of the batch, the
gradients are reduced across pods by ``compressed_psum``, the loss is
averaged over pods, and every pod applies the same AdamW update.
``make_sharded_train_step`` is the plain path on a mesh; it computes on
each rank's tensor-parallel shards (``repro_torch.distributed.tp``).

``publish_train_metrics`` streams a step's metrics through the
telemetry registry (``REPRO_OBS``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.convert import reference_ndims
from repro_torch.core.dtypes import div_const
from repro_torch.distributed import tp
from repro_torch.distributed.sharding import (NamedSharding, gather_tree,
                                              local_tree, logical_to_spec,
                                              param_shardings, place_tree,
                                              use_sharding)
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models.model import init_params, loss_fn
from repro_torch.tree import tree_leaves, tree_map
from .compression import (CompressionConfig, compressed_psum,
                          init_error_feedback)
from .optimizer import (AdamWConfig, adamw_init, adamw_update, global_norm,
                        warmup_cosine)

__all__ = ["make_train_state", "make_train_step", "cast_for_compute",
           "train_state_shardings", "batch_sharding",
           "make_sharded_train_step", "tp_loss_and_grads",
           "publish_train_metrics"]


def publish_train_metrics(metrics: dict, step: Optional[int] = None) -> None:
    """Stream a train-step metrics dict (loss / grad_norm / lr / ...)
    through the obs registry as ``repro_train_<name>`` gauges plus a
    ``repro_train_steps_total`` counter.

    No-op with REPRO_OBS off. When on, the scalar tensors come to the host
    in one copy, which waits for the step: call it at the logging cadence.
    Entries that are not scalars are skipped."""
    if not obs.enabled():
        return
    names, tensors, values = [], [], {}
    for name, value in metrics.items():
        if isinstance(value, torch.Tensor):
            if value.numel() == 1:
                names.append(name)
                tensors.append(value.detach().reshape(()).to(torch.float64))
            continue
        try:
            values[name] = float(value)
        except (TypeError, ValueError):
            continue                    # non-scalar entry: skip, don't die
    if tensors:
        host = torch.stack([t.to(tensors[0].device) for t in tensors]).cpu()
        values.update(zip(names, host.tolist()))
    for name in metrics:
        if name in values:
            obs.gauge(f"repro_train_{name}",
                      f"latest train-step metric {name!r}").set(values[name])
    obs.counter("repro_train_steps_total",
                "train steps streamed through the registry").inc()
    if step is not None:
        obs.gauge("repro_train_step", "latest published step index").set(
            float(step))


def cast_for_compute(params):
    """Master f32 -> compute dtypes: a floating leaf is cast to bf16 where
    the reference's counterpart has two or more axes
    (``convert.reference_ndims``): inside a stacked group (a key of
    ``convert.STACKED``, where the reference adds axis 0) when it has one
    axis or more, so per-layer norms and biases compute in bf16; elsewhere
    when it has two or more (the final norm and the hybrid's unstacked
    ``shared_attn`` vectors stay f32)."""
    return tree_map(lambda p, ndim: p.to(torch.bfloat16)
                    if ndim >= 2 and p.is_floating_point() else p,
                    params, reference_ndims(params))


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


def train_state_shardings(state, mesh, rules=None):
    """``NamedSharding`` tree for the whole train state: m, v (and err)
    mirror the parameters, step is replicated."""
    ps = param_shardings(state["params"], mesh, rules)
    out = {"params": ps, "opt": {"m": ps, "v": ps,
                                 "step": NamedSharding(mesh, ())}}
    if "err" in state:
        out["err"] = ps
    return out


def batch_sharding(mesh, rules=None) -> NamedSharding:
    """The batch's sharding: axis 0 over the rules' ``batch`` axes."""
    with use_sharding(mesh, rules):
        spec = logical_to_spec(("batch", None))
    return NamedSharding(mesh, spec)


def _local_batch(batch: dict, sharding: NamedSharding) -> dict:
    """This rank's slice of every batch tensor (the same full batch on
    every rank)."""
    return {k: sharding.place(v).to_local() for k, v in batch.items()}


def _loss_and_grads(params, cfg, batch, compute=None):
    """(loss, gradients of ``loss_fn(cast_for_compute(params))`` with
    respect to every leaf of ``params``; zeros for a leaf the loss does not
    reach, as JAX gives). ``compute`` maps the leaves to what the model
    computes on (the tensor-parallel DTensors of a placed state)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        seen = leaves if compute is None else compute(leaves)
        loss = loss_fn(cast_for_compute(seen), cfg, batch)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(zip(flat, grads))

    def take(_):
        p, g = next(it)
        return torch.zeros_like(p) if g is None else g
    return loss.detach(), tree_map(take, leaves)


def _grads_and_loss(params, cfg, batch: dict, num_microbatches: int,
                    compute=None):
    """Loss and gradients, accumulated over ``num_microbatches`` slices of
    the batch (axis 0) in the reference's order: loss and gradients summed
    microbatch by microbatch from zeros, then times ``1 / n``."""
    if num_microbatches <= 1:
        return _loss_and_grads(params, cfg, batch, compute)
    n = num_microbatches
    loss, grads = 0.0, tree_map(torch.zeros_like, params)
    for i in range(n):
        mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
              for k, v in batch.items()}
        mb_loss, g = _loss_and_grads(params, cfg, mb, compute)
        loss = loss + mb_loss
        grads = tree_map(torch.add, grads, g)
    inv = 1.0 / n
    return loss * inv, tree_map(lambda g: g * inv, grads)


def make_train_step(cfg, opt_cfg: AdamWConfig,
                    compression: Optional[CompressionConfig] = None,
                    num_microbatches: int = 1, mesh=None, rules=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``. ``batch``
    is a dict of tensors on the parameters' device ({"tokens", "labels"},
    or {"embeds", "labels"}); ``metrics`` holds f32 tensors "loss",
    "grad_norm" and "lr".

    Plain path (no enabled ``compression``): one process, the whole batch.
    Compressed path: ``mesh`` is a ``DeviceMesh`` with a "pod" dim and the
    state holds "err" (``make_train_state(..., compression)``); every rank
    calls the step with the same full batch and the same state, takes its
    pod's slice of the batch (axis 0 over "pod"), and the pods' gradients
    meet in ``compressed_psum``; the loss is the mean over pods, and every
    pod applies the same AdamW update. Inside a pod every rank computes the
    pod's whole slice: the "data" and "model" dims add no parallelism to
    this step."""
    schedule = warmup_cosine(opt_cfg)

    def plain_step(state, batch):
        loss, grads = _grads_and_loss(state["params"], cfg, batch,
                                      num_microbatches)
        new_p, new_opt, metrics = adamw_update(
            state["params"], grads, state["opt"], opt_cfg, schedule)
        metrics["loss"] = loss
        new_state = {"params": new_p, "opt": new_opt}
        if "err" in state:
            new_state["err"] = state["err"]
        return new_state, metrics

    if not (compression and compression.enabled):
        return plain_step
    sizes = mesh_axis_sizes(mesh) if mesh is not None else {}
    if "pod" not in sizes:
        raise ValueError("the compressed reduction needs a mesh with a "
                         "'pod' dim (the multi-pod mesh)")
    n_pods = sizes["pod"]
    group = mesh.get_group("pod")
    pod_slice = NamedSharding(mesh, ("pod",))

    def compressed_step(state, batch):
        loss, grads = _grads_and_loss(
            state["params"], cfg, _local_batch(batch, pod_slice),
            num_microbatches)
        grads, new_err = compressed_psum(grads, state["err"], compression,
                                         group, n_pods)
        dist.all_reduce(loss, group=group)
        loss = div_const(loss, n_pods)
        new_p, new_opt, metrics = adamw_update(
            state["params"], grads, state["opt"], opt_cfg, schedule)
        metrics["loss"] = loss
        return {"params": new_p, "opt": new_opt, "err": new_err}, metrics

    return compressed_step


def tp_loss_and_grads(params, cfg, batch: dict, mesh, rules=None,
                      num_microbatches: int = 1):
    """Loss and gradients of ``batch`` (this rank's rows) on the
    tensor-parallel model (``repro_torch.distributed.tp``) from placed
    master ``params``: each leaf is gathered along the mesh dims other
    than "model" (the fsdp all-gather) and kept at its "model" shard, the
    forward and backward run on the shards, and each gradient comes out
    as a plain tensor at its leaf's "model" shard (whole along the other
    dims; a replicated leaf's summed over "model")."""
    with use_sharding(mesh, rules):
        mm = tp.tp_mesh()

        def wrap(t, p):
            return tp.wrap(t, tp.model_placement(p), mm)
        return _grads_and_loss(
            tree_map(tp.model_local, params), cfg, batch, num_microbatches,
            lambda leaves: tree_map(wrap, leaves, params))


def _tp_global_norm(grads, params, mesh) -> torch.Tensor:
    """``global_norm`` of the whole gradients from each rank's "model"
    shards (``tp_loss_and_grads``): each leaf's f32 squares summed in
    float64 on the shard, the sums of the leaves sharded over "model"
    all-reduced over it at once (a replicated leaf counted once), then
    summed over the leaves and rounded to f32 before the root, as
    ``global_norm`` does."""
    sums = [g.to(torch.float32).square().sum(dtype=torch.float64)
            for g in tree_leaves(grads)]
    sharded = torch.tensor([tp.model_placement(p).is_shard()
                            for p in tree_leaves(params)],
                           device=sums[0].device)
    sums = torch.stack(sums)
    part = torch.where(sharded, sums, torch.zeros_like(sums))
    dist.all_reduce(part, group=mesh.get_group("model"))
    sums = torch.where(sharded, part, sums)
    return sums.sum().to(torch.float32).sqrt()


def _leaf_shard(g, p):
    """This rank's block of a gradient held at leaf ``p``'s "model" shard
    (whole along the other mesh dims): cut along those dims to ``p``'s
    placements, which moves nothing."""
    from torch.distributed.tensor import DTensor
    mesh = p.device_mesh
    held = [pl if n == "model" else tp.replicate()
            for n, pl in zip(mesh.mesh_dim_names, p.placements)]
    t = DTensor.from_local(g, mesh, held, run_check=False)
    return t.redistribute(mesh, p.placements).to_local()


def make_sharded_train_step(cfg, opt_cfg: AdamWConfig, mesh, rules=None,
                            num_microbatches: int = 1):
    """The plain step on a ``DeviceMesh``, ZeRO-3 in the reference's sense
    (its FSDP rules): master parameters, m and v are DTensor shards at
    ``train_state_shardings`` (``place_tree``).

    Compute: on a mesh with a "model" dim the model of every family is
    tensor-parallel over it (``repro_torch.distributed.tp``): each leaf is
    gathered along the other mesh dims (fsdp) once per step and kept at
    its "model" shard, every product runs on the rank's shard (the
    recurrent cells on the rank's heads), and each leaf's gradient comes
    out at that shard (a replicated leaf's summed over "model" where its
    ranks saw different heads). Without a "model" dim the leaves are
    gathered whole for compute.

    Every rank is called with the same full batch and computes the loss on
    its ``batch_sharding`` slice;
    the loss and gradients are averaged over the batch dims (summed by
    ``all_reduce`` from zeros, then times 1 / n, the plain microbatch
    path's arithmetic), the gradient norm is taken over the averaged
    gradients, and AdamW updates each rank's shards. With n batch ranks
    and no product split over "model" it equals
    ``make_train_step(num_microbatches=n)`` on the whole batch (bit for
    bit at n = 2, where a sum of two does not depend on its order); on a
    1 x 1 mesh, ``make_train_step`` itself.

    The gradients stay at their "model" shards: they are all-reduced over
    the batch dims there (not reduce-scattered: clipping needs the global
    norm first), the norm sums each leaf's squares on its shards with one
    all-reduce over "model" (``_tp_global_norm``: float64 sums, so the
    plain step's arithmetic up to their order), and each is then cut to
    the rank's block along the other dims."""
    schedule = warmup_cosine(opt_cfg)
    bsh = batch_sharding(mesh, rules)
    sizes = mesh_axis_sizes(mesh)
    batch_axes = [a for a in (bsh.spec[0] if isinstance(bsh.spec[0], tuple)
                              else (bsh.spec[0],)) if a is not None]
    n_batch = math.prod(sizes[a] for a in batch_axes)
    groups = [mesh.get_group(a) for a in batch_axes]

    def batch_mean(t):
        t = t.clone()
        for g in groups:
            dist.all_reduce(t, group=g)
        return (torch.zeros_like(t) + t) * (1.0 / n_batch)

    tensor_parallel = "model" in sizes

    def step(state, batch):
        from torch.distributed.tensor import DTensor
        params = state["params"]
        if tensor_parallel:
            loss, grads = tp_loss_and_grads(params, cfg,
                                            _local_batch(batch, bsh), mesh,
                                            rules, num_microbatches)
        else:
            loss, grads = _grads_and_loss(gather_tree(params), cfg,
                                          _local_batch(batch, bsh),
                                          num_microbatches)
        if n_batch > 1:
            loss, grads = batch_mean(loss), tree_map(batch_mean, grads)
        if tensor_parallel:
            gnorm = _tp_global_norm(grads, params, mesh)
            grad_shards = tree_map(_leaf_shard, grads, params)
        else:
            gnorm = global_norm(grads)
            shardings = train_state_shardings(state, mesh, rules)["params"]
            grad_shards = local_tree(place_tree(grads, shardings))
        opt = state["opt"]
        new_p, new_opt, metrics = adamw_update(
            local_tree(params), grad_shards,
            {"m": local_tree(opt["m"]), "v": local_tree(opt["v"]),
             "step": local_tree(opt["step"])},
            opt_cfg, schedule, grad_norm=gnorm)
        metrics["loss"] = loss

        def wrap(local, like):
            return DTensor.from_local(local, like.device_mesh,
                                      like.placements, run_check=False)
        new_state = {"params": tree_map(wrap, new_p, params),
                     "opt": {"m": tree_map(wrap, new_opt["m"], opt["m"]),
                             "v": tree_map(wrap, new_opt["v"], opt["v"]),
                             "step": wrap(new_opt["step"], opt["step"])}}
        if "err" in state:
            new_state["err"] = state["err"]
        return new_state, metrics

    return step
