"""Tensor-parallel compute on weight shards (ROADMAP A13, A13b): the port's
counterpart of what GSPMD makes of the reference's model under a mesh and
its ``constrain`` annotations.

Under ``use_sharding(mesh)`` with a ``DeviceMesh`` that has a "model" dim,
the placed parameters are DTensors at ``param_shardings``' specs. Every
product runs on this rank's shard of its weight. Activations are DTensors
on the mesh's 1-D "model" submesh (``tp_mesh``); their batch rows are this
rank's own (the train step cuts the batch over the batch dims itself), so
no activation is placed along the other mesh dims. DTensor has no sharding
rule for the port's ctypes kernels, so the dispatch of a product onto a
DTensor weight is written out with ``to_local`` / ``from_local`` (what
``torch.distributed.tensor.experimental.local_map`` does), by the weight's
placement along "model":

  column   the weight's N is sharded (q_dim, kv_dim, mlp, vocab and
           expert_mlp on N): the replicated x times the local (K, N/t)
           shard is the Shard(-1) output, and nothing moves (in the
           backward x's gradient is Partial, reduced where x was made);
  row      its K is sharded (wo, down, ff_down): the Shard(-1) x times
           the local (K/t, N) shard is a Partial sum -- rounded to bf16
           under ``REPRO_BF16_TP_REDUCE`` -- that ``constrain`` reduces at
           once (an all-reduce over "model"), then cast to x's dtype;
  expert   an expert stack's E is sharded (the (K, E, N) streams of a
           packed expert weight under the reference's specs): x moves to
           Shard over E and the output stays so;
  replicated  the weight is not sharded over "model" (a dim that does not
           divide): the whole product on every rank.

Along every other mesh dim (fsdp: K on "data") a weight is all-gathered
before its product, as GSPMD does (``model_local``); no weight is gathered
along "model". ``local_apply`` runs any other op of the model on the local
tensors (norms, rope, the attention core, the expert routing).

The recurrent blocks (ROADMAP A13b; ``models/xlstm.py``,
``models/mamba2.py``) use the same dispatch. What moves along "model",
and why (activations only; no weight is gathered along "model"):

  * the outputs of the concatenated column products -- Mamba2's
    ``in_proj`` ([z | x B C | dt], split at din and 2 din + 2 N), the
    mLSTM's ``up`` ([xin | z]) and the sLSTM's ``w`` ([z | i | f | o]) --
    are all-gathered whole (``gathered``): a contiguous column shard is
    not one rank's heads of each part, and the conv, the gates, B and C
    read every channel. The conv and the gates then run whole on every
    rank (elementwise, or a (din, 2H) product), the per-head parts
    (q/k/v on the (H/t, P, P) blocks, the chunkwise cell or the SSD scan,
    the one-step updates of C, n, m and ssm) on this rank's heads
    (``heads_of``), against its head-sharded states;
  * the gated cell output is all-gathered for the norm over din (the
    mLSTM's ``gn``, Mamba2's gated ``rms_norm``), which then runs on the
    whole row with ``layers._sum_halves``' folds: the unsharded port's
    bits, where an all-reduce of per-rank sums of squares would fold in
    another order. ``down`` / ``out_proj`` / ``ff_down`` are then
    row-parallel as above (the K-shard of the whole row is the rank's
    heads when they divide);
  * the sLSTM runs whole on every rank (its c and h are replicated by
    the reference's specs, its n and m, sharded over "heads" by name,
    are gathered for each decode step); ``ff_up`` is column- and
    ``ff_down`` row-parallel.

Cheaper, not built: laying out each concatenated weight's columns per
head at placement ([z_r | x_r | dt_r] on rank r, B and C replicated) would
make those products column-parallel with no gather, but the leaves would
no longer be the reference's (checkpoints and specs are shared); and an
all-reduce of per-rank sums of squares would move 4 bytes a row for the
norm where the gather moves din, at the cost of the unsharded bits.

``on_gemm``, when set, is called with every product dispatch (its kind
and the local shapes of x and the weight; "heads" for the mLSTM's
per-head block-diagonal q/k/v products on this rank's (H/t, P, P)
blocks): the recorder of ``repro_torch.testing.distributed`` sets it.
"""
from __future__ import annotations

import functools
import types
from typing import Optional

import torch

from .sharding import active_mesh, constrain

__all__ = [
    "tp_mesh", "is_dtensor", "model_placement", "gather_weight",
    "model_local", "wrap",
    "unwrap", "to_placement", "record_gemm", "column", "row", "expert",
    "replicated",
    "local_apply", "gathered", "heads_of", "model_whole",
    "like_leaf",
    "full", "tp_rank", "tp_size", "kind_of", "shard", "replicate",
]

# the "model" submeshes: process-wide, as the active mesh is
# (distributed/sharding.py), for the backward's threads
_state = types.SimpleNamespace(submeshes={})

# called as on_gemm(kind, x_shape, w_shape) by every product dispatch
on_gemm = None


def _model_dim(mesh):
    """(the "model" submesh, its size, this rank's index on it) of a
    ``DeviceMesh``, made once per mesh (slicing a mesh costs about a
    millisecond, and every product asks)."""
    key = id(mesh)
    hit = _state.submeshes.get(key)
    if hit is None or hit[0] is not mesh:
        sub = mesh["model"] if len(mesh.mesh_dim_names) > 1 else mesh
        hit = (mesh, sub, sub.size(), sub.get_local_rank())
        _state.submeshes[key] = hit
    return hit[1:]


def tp_mesh():
    """The active ``DeviceMesh``'s 1-D "model" submesh, or None: no mesh,
    a ``LogicalMesh`` (names and sizes only), or no "model" dim."""
    mesh = active_mesh()
    names = getattr(mesh, "mesh_dim_names", None)
    if mesh is None or not hasattr(mesh, "get_group") or not names \
            or "model" not in names:
        return None
    return _model_dim(mesh)[0]


def tp_size() -> int:
    mesh = active_mesh()
    return 1 if tp_mesh() is None else _model_dim(mesh)[1]


def tp_rank() -> int:
    mesh = active_mesh()
    return 0 if tp_mesh() is None else _model_dim(mesh)[2]


@functools.lru_cache(maxsize=None)
def _dtensor_class():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x) -> bool:
    return isinstance(x, _dtensor_class())


def replicate():
    from torch.distributed.tensor import Replicate
    return Replicate()


def model_placement(t):
    """``t``'s placement along "model" (Replicate where its mesh has no
    "model" dim)."""
    names = t.device_mesh.mesh_dim_names or ()
    if "model" not in names:
        return replicate()
    return t.placements[names.index("model")]


def gather_weight(t):
    """DTensor weight ``t`` gathered along every mesh dim but "model" (the
    fsdp all-gather GSPMD does before a product), its placement along
    "model" kept."""
    mesh = t.device_mesh
    target = [p if n == "model" else replicate()
              for n, p in zip(mesh.mesh_dim_names or (), t.placements)]
    if target != list(t.placements):
        t = t.redistribute(mesh, target)
    return t


def model_local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor weight along "model"
    (``gather_weight``'s local tensor); a plain tensor as it is."""
    return gather_weight(t).to_local() if is_dtensor(t) else t


def wrap(local: torch.Tensor, placement, mesh=None):
    """``local`` (this rank's part) as a DTensor on the "model" submesh at
    ``placement`` (even shards only)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh or tp_mesh(), [placement],
                              run_check=False)


def unwrap(x, grad=None) -> torch.Tensor:
    """The local tensor of an activation DTensor (``grad``: its gradient's
    placement, e.g. Partial for a replicated x that meets a column shard);
    a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    return x.to_local(grad_placements=None if grad is None else [grad])


def to_placement(x, placement):
    """Activation ``x`` (a DTensor on the "model" submesh, or a plain
    tensor: the same full value on every rank) at ``placement``."""
    if not is_dtensor(x):
        x = wrap(x, replicate())
    if x.placements[0] != placement:
        x = x.redistribute(x.device_mesh, [placement])
    return x


def full(x):
    """The full value of an activation DTensor on every rank (an
    all-gather where it is sharded, differentiable); a plain tensor as it
    is."""
    return x.full_tensor() if is_dtensor(x) else x


def shard(d: int):
    from torch.distributed.tensor import Shard
    return Shard(d)


def kind_of(placement, n_dim: int, k_dim: int = 0,
            e_dim: Optional[int] = None) -> str:
    """The dispatch kind of a weight whose placement along "model" is
    ``placement``: "column" (its N dim ``n_dim`` sharded), "row" (its K
    dim ``k_dim``), "expert" (its E dim ``e_dim``) or "replicated"."""
    if placement.is_shard():
        d = placement.dim
        if d == n_dim:
            return "column"
        if d == k_dim:
            return "row"
        if d == e_dim:
            return "expert"
    if placement.is_replicate():
        return "replicated"
    raise ValueError(f"no tensor-parallel product for a weight placed "
                     f"{placement} along 'model'")


def record_gemm(kind: str, x_local, w_shape) -> None:
    """Report a product on local shapes to ``on_gemm`` (when set)."""
    if on_gemm is not None:
        on_gemm(kind, tuple(x_local.shape), tuple(w_shape))


def column(x, product, w_shape):
    """Column-parallel product: ``product(x_local)`` of the replicated x
    -> this rank's (..., N/t) columns, a Shard(-1) DTensor."""
    from torch.distributed.tensor import Partial
    xl = unwrap(to_placement(x, replicate()), Partial())
    record_gemm("column", xl, w_shape)
    out = product(xl)
    return wrap(out, shard(out.dim() - 1))


def row(x, product, w_shape, out_dtype, axes, cols=None):
    """Row-parallel product: ``product(x_local)`` of this rank's K-shard of
    x -> an f32 partial sum, rounded to bf16 under
    ``REPRO_BF16_TP_REDUCE``, reduced over "model" by ``constrain`` at
    the logical ``axes`` of the output, then cast to ``out_dtype``.
    ``cols`` (k0, k1) takes x's columns k0 .. k1 - 1 of the replicated x
    instead (a padded row shard whose K-shard splits 32-groups:
    ``models/quant.py::RowPadded``)."""
    from torch.distributed.tensor import Partial
    if cols is None:
        xl = unwrap(to_placement(x, shard(x.dim() - 1)))
    else:
        xl = unwrap(to_placement(x, replicate()), Partial())[
            ..., cols[0]:cols[1]].contiguous()
    record_gemm("row", xl, w_shape)
    part = product(xl)
    from repro_torch.models.numerics import bf16_tp_reduce
    if bf16_tp_reduce():
        part = part.to(torch.bfloat16)
    return constrain(wrap(part, Partial()), axes).to(out_dtype)


def expert(x, product, w_shape, dim: int = 1):
    """Expert-parallel product: x at Shard(``dim``) (its E axis), the
    local experts' products, the output at Shard(``dim``)."""
    xl = unwrap(to_placement(x, shard(dim)))
    record_gemm("expert", xl, w_shape)
    return wrap(product(xl), shard(dim))


def replicated(x, product, w_shape):
    """The whole product on every rank (a weight not sharded over
    "model")."""
    xl = unwrap(to_placement(x, replicate()))
    record_gemm("replicated", xl, w_shape)
    return wrap(product(xl), replicate())


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def local_apply(fn, *args, placement=None):
    """``fn`` on the local tensors of ``args`` (DTensor activations on the
    "model" submesh, weights -- DTensors on the whole mesh, through
    ``model_local`` -- plain tensors and other values as they are; dicts
    and lists of them too). The result (a tensor, or a dict/tuple of them)
    is wrapped at ``placement``: by default that of the first sharded
    activation, else Replicate; a tuple of placements wraps a tuple result
    element by element (None: that element is left local). A replicated
    activation or weight used beside a sharded activation, or for a
    sharded result (``fn`` computes this rank's part of it), gets a
    Partial gradient (each rank's part of its gradient is its shard's).
    Where no argument is a DTensor (unplaced tensors) it is
    ``fn(*args)``."""
    from torch.distributed.tensor import Partial
    found = []
    _map(lambda t: found.append(t) if is_dtensor(t) else None, args)
    if not found:
        return fn(*args)
    mm = tp_mesh()
    sharded = next((t.placements[0] for t in found
                    if t.device_mesh == mm and t.placements[0].is_shard()),
                   None)
    pl = placement or sharded or replicate()
    split = sharded is not None or any(
        p is not None and p.is_shard()
        for p in (pl if isinstance(pl, tuple) else (pl,)))

    def local(t):
        if not is_dtensor(t):
            return t
        if t.device_mesh != mm:
            return model_local(t)
        rep = t.placements[0].is_replicate()
        return t.to_local(grad_placements=[Partial()]
                          if rep and split else None)
    out = fn(*_map(local, args))
    if isinstance(pl, tuple):
        return tuple(o if p is None else _map(lambda t, p=p: wrap(t, p, mm),
                                              o)
                     for o, p in zip(out, pl))
    return _map(lambda t: wrap(t, pl, mm), out)


def gathered(x):
    """Activation ``x`` whole on every rank: a DTensor at Replicate (an
    all-gather along "model" where it is sharded, differentiable); a plain
    tensor as it is."""
    return to_placement(x, replicate()) if is_dtensor(x) else x


def heads_of(n: int) -> tuple:
    """(first, count) of this rank's heads out of ``n``: a contiguous
    1/t of them where ``n`` divides over "model" (the rule that shards a
    per-head weight or state over "heads"), else all of them."""
    t = tp_size()
    if t == 1 or n % t:
        return 0, n
    return tp_rank() * (n // t), n // t


def _whole_along_model(leaf) -> list:
    names = leaf.device_mesh.mesh_dim_names or ()
    return [replicate() if n == "model" else p
            for n, p in zip(names, leaf.placements)]


def model_whole(leaf) -> torch.Tensor:
    """Placed state ``leaf``'s local block along the mesh dims other than
    "model", whole along "model" (an all-gather where it is sharded
    there); a plain tensor as it is."""
    if not is_dtensor(leaf):
        return leaf
    target = _whole_along_model(leaf)
    if target != list(leaf.placements):
        leaf = leaf.redistribute(leaf.device_mesh, target)
    return leaf.to_local()


def like_leaf(leaf, value: torch.Tensor):
    """``value`` stored at state leaf ``leaf``'s placement: a plain tensor
    where ``leaf`` is one; else a DTensor on ``leaf``'s mesh at its
    placements, ``value`` taken as this rank's part when it has the local
    part's shape, else as ``model_whole``'s (each rank keeps its block,
    nothing is sent)."""
    if not is_dtensor(leaf):
        return value
    from torch.distributed.tensor import DTensor
    mesh = leaf.device_mesh
    if tuple(value.shape) == tuple(leaf.to_local().shape):
        return DTensor.from_local(value, mesh, leaf.placements,
                                  run_check=False)
    return DTensor.from_local(value, mesh, _whole_along_model(leaf),
                              run_check=False).redistribute(
        mesh, leaf.placements)
