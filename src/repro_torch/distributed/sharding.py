"""Logical-axis sharding over a mesh (port of repro.distributed.sharding).

A rules table maps *logical* axis names (batch, heads, mlp, fsdp, ...) to
mesh axes; ``logical_to_spec`` turns a tuple of logical names into a spec:
a tuple with one entry per tensor dim, each ``None``, a mesh axis name or a
tuple of names (the reference's ``PartitionSpec``). Outside a
``use_sharding`` context ``constrain`` is a no-op and ``named_sharding``
gives None, so the same code runs on one device and in the dry-run.

The mesh is a ``repro_torch.launch.mesh.LogicalMesh`` (names and sizes:
specs and bytes per rank, no process) or a ``DeviceMesh`` (specs, and
``NamedSharding.place`` puts a tensor at its shard as a DTensor). A spec
maps onto DTensor placements one per *mesh* dim: ``Shard(d)`` where the
mesh axis shards tensor dim d, else ``Replicate()``. When two mesh axes
shard one dim (``batch -> ("pod", "data")``), DTensor splits in mesh-dim
order, major first, which is JAX's order for a tuple whose axes stand in
mesh order; a tuple in any other order raises.

Default rules (the reference's):
  batch    -> ('pod', 'data')   pure DP across pods, DP within pod
  kv_seq   -> 'model' (long_500k overrides to ('data', 'model'))
  heads/kv_heads/mlp/vocab/expert_mlp -> 'model'   (tensor parallelism)
  embed    -> None for activations
  fsdp     -> 'data'            weight & optimizer-state sharding
  expert   -> 'data'            expert parallelism when E % data == 0

Trees: the port keeps a list of per-layer dicts where the reference stacks
the layers on axis 0 (``repro_torch.convert``). A leaf reached through a
list index gets the reference's axes for its stacked counterpart without
their leading None; packed streams (codes, scales, meta, tscale) take
their parent weight's axes, checked for divisibility against the stream's
own shape.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import types
from typing import Optional

import torch

from repro_torch.core.codecs import PackedTensor
from repro_torch.launch.mesh import mesh_axis_sizes

__all__ = [
    "DEFAULT_RULES", "use_sharding", "constrain", "logical_to_spec",
    "named_sharding", "active_mesh", "current_rules", "NamedSharding",
    "infer_logical_axes", "param_shardings", "cache_shardings",
    "map_with_path", "place_tree", "gather_tree", "local_tree",
    "shard_nbytes",
]

# the active mesh and rules: process-wide, not per thread, so that the
# autograd engine's device threads (where a remat'd block is recomputed in
# the backward on the card) see the mesh its forward ran under
_state = types.SimpleNamespace()

DEFAULT_RULES: dict = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": "model",          # decode caches: sequence-sharded over TP
                                # (long_500k overrides to ('data','model'))
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "q_dim": "model",           # fused head*hd projections
    "kv_dim": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "data",           # EP over the data axis (when divisible)
    "expert_mlp": "model",
    "fsdp": "data",             # weight-shard (ZeRO-3) axis
    "conv": None,
    "state": None,
    "seq_sp": None,
    "cache_batch": ("pod", "data"),
}

# activations tolerate padding up to this blow-up factor (40 heads over
# 16-way TP pads to 48 = 1.2x); weights and state never pad
_PAD_WASTE_LIMIT = 1.5
_STREAMS = ("codes", "scales", "meta", "tscale")


def active_mesh():
    return getattr(_state, "mesh", None)


def current_rules() -> dict:
    return getattr(_state, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[dict] = None):
    """Install a mesh and logical rules for the enclosed code; rule
    entries naming a mesh axis the mesh lacks are dropped ('pod' on the
    single-pod mesh)."""
    names = tuple(mesh_axis_sizes(mesh))
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)

    def _filter(v):
        if v is None:
            return None
        if isinstance(v, tuple):
            kept = tuple(a for a in v if a in names)
            return kept or None
        return v if v in names else None
    merged = {k: _filter(v) for k, v in merged.items()}
    prev_mesh = getattr(_state, "mesh", None)
    prev_rules = getattr(_state, "rules", None)
    _state.mesh, _state.rules = mesh, merged
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev_mesh, prev_rules


def _axes_of(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else (entry or ())


def logical_to_spec(axes, shape=None, rules=None, allow_pad=False) -> tuple:
    """Tuple of logical axis names (or None) -> spec tuple.

    With ``shape``, a sharding that does not divide its dim is dropped;
    ``allow_pad`` (activations) keeps it when the padding waste stays
    within ``_PAD_WASTE_LIMIT``. A mesh axis is used at most once: a later
    entry that would reuse one becomes None. Entries are canonical as in
    JAX: ('data',) is 'data'."""
    rules = rules or current_rules()
    mesh = active_mesh()
    sizes = mesh_axis_sizes(mesh) if mesh is not None else None
    out = []
    for i, a in enumerate(axes):
        v = rules.get(a) if a else None
        if v is not None and shape is not None and sizes is not None:
            size = math.prod(sizes[ax] for ax in _axes_of(v))
            if shape[i] % size != 0:
                d = shape[i]
                waste = (-(-d // size) * size) / d
                if not (allow_pad and waste <= _PAD_WASTE_LIMIT):
                    v = None
        out.append(v)
    seen: set = set()
    cleaned = []
    for v in out:
        axes_v = _axes_of(v)
        if any(a in seen for a in axes_v):
            cleaned.append(None)
        else:
            seen.update(axes_v)
            cleaned.append(_canonical(v))
    return tuple(cleaned)


def _canonical(entry):
    """A spec entry as JAX's ``PartitionSpec`` stores it: a tuple of one
    axis is that axis, an empty tuple None."""
    if isinstance(entry, tuple) and len(entry) <= 1:
        return entry[0] if entry else None
    return entry


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``). Entries past
    the spec's end are None, as in JAX."""

    mesh: object
    spec: tuple

    def _entry(self, dim: int):
        return self.spec[dim] if dim < len(self.spec) else None

    def shard_shape(self, shape) -> tuple:
        """The shape of one rank's shard of a tensor of ``shape``."""
        sizes = mesh_axis_sizes(self.mesh)
        out = []
        for d, n in enumerate(shape):
            k = math.prod(sizes[a] for a in _axes_of(self._entry(d)))
            if n % k:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"divide over {self._entry(d)} ({k})")
            out.append(n // k)
        return tuple(out)

    def shard_nbytes(self, shape, dtype) -> int:
        """Bytes of one rank's shard."""
        return math.prod(self.shard_shape(shape)) * _itemsize(dtype)

    def placements(self) -> list:
        """DTensor placements, one per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard
        names = list(mesh_axis_sizes(self.mesh))
        out = [Replicate() for _ in names]
        for d, entry in enumerate(self.spec):
            axes = _axes_of(entry)
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(
                    f"spec entry {entry!r} lists mesh axes out of the "
                    f"mesh's order {tuple(names)}; DTensor shards one dim "
                    f"over several mesh dims major-first in mesh order")
            for j in order:
                out[j] = Shard(d)
        return out

    def place(self, tensor: torch.Tensor):
        """``tensor`` (the same full value on every rank) as a DTensor at
        this sharding; each rank keeps its own shard, nothing is sent."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(tensor, self.mesh, self.placements(),
                                 src_data_rank=None)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype, device="meta").element_size()


def named_sharding(axes, shape=None) -> Optional[NamedSharding]:
    mesh = active_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, logical_to_spec(axes, shape))


def constrain(x: torch.Tensor, axes) -> torch.Tensor:
    """Annotate an activation with logical axes: a no-op without a mesh.
    Inside ``use_sharding`` a DTensor is redistributed to the spec (padded
    shardings kept up to ``_PAD_WASTE_LIMIT``, as uneven shards): a
    DTensor on the active mesh to the spec's placements, one on a submesh
    (the tensor-parallel activations of ``distributed/tp.py`` live on the
    "model" submesh) to the spec's entries for that submesh's dims, so a
    Partial sum is reduced here. A plain tensor is one rank's full value
    and is returned as it is."""
    mesh = active_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    spec = logical_to_spec(axes, tuple(x.shape), allow_pad=True)
    names = tuple(x.device_mesh.mesh_dim_names or ())
    if names == tuple(mesh_axis_sizes(mesh)):
        return x.redistribute(mesh, NamedSharding(mesh, spec).placements())
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for a in _axes_of(entry):
            if a in names:
                out[names.index(a)] = Shard(d)
    return x.redistribute(x.device_mesh, out)


# ---------------------------------------------------------------------------
# Parameter / cache logical axes (path-name driven)
# ---------------------------------------------------------------------------

_STACKED_GROUPS = ("layers", "mlstm", "slstm", "mamba")

_NAME_AXES = {
    # attention projections (D, H*hd) etc.
    "wq": ("fsdp", "q_dim"), "wk": ("fsdp", "kv_dim"), "wv": ("fsdp", "kv_dim"),
    "wo": ("q_dim", "fsdp"),
    "bq": ("q_dim",), "bk": ("kv_dim",), "bv": ("kv_dim",),
    # dense mlp
    "gate": ("fsdp", "mlp"), "up": ("fsdp", "mlp"), "down": ("mlp", "fsdp"),
    # ssm / xlstm projections
    "in_proj": ("fsdp", "mlp"), "out_proj": ("mlp", "fsdp"),
    "w": ("fsdp", "mlp"), "ff_up": ("fsdp", "mlp"), "ff_down": ("mlp", "fsdp"),
    "w_o": ("fsdp", "mlp"), "w_if": ("fsdp", None),
    "router": ("fsdp", None),
    # embeddings
    "embed": ("vocab", "fsdp"), "lm_head": ("fsdp", "vocab"),
}

_MOE_AXES = {  # expert weights (E, K, N)
    "gate": ("expert", "fsdp", "expert_mlp"),
    "up": ("expert", "fsdp", "expert_mlp"),
    "down": ("expert", "expert_mlp", "fsdp"),
}

_MLSTM_BLOCKDIAG = ("wq", "wk", "wv")     # (H, P, P) under 'mlstm'

_CACHE_AXES = {
    "k": (None, "cache_batch", "kv_seq", "kv_heads", None),
    "v": (None, "cache_batch", "kv_seq", "kv_heads", None),
    "pos": (None, None),
    "ssm": (None, "cache_batch", "heads", None, None),
    "conv": (None, "cache_batch", None, None),
    "C": (None, "cache_batch", "heads", None, None),
    "n": (None, "cache_batch", "heads", None),
    "m": (None, "cache_batch", "heads"),
    "c": (None, "cache_batch", None),
    "h": (None, "cache_batch", None),
}


def infer_logical_axes(path_names: tuple, shape: tuple) -> tuple:
    """Logical axes of a parameter leaf of the reference's layout (layers
    stacked on axis 0) from its key path and shape (the reference's
    function)."""
    name = path_names[-1] if path_names else ""
    stacked = int(any(k in _STACKED_GROUPS for k in path_names))
    base_ndim = len(shape) - stacked
    if "mlstm" in path_names and name in _MLSTM_BLOCKDIAG:
        axes = ("heads", None, None)
    elif "ffn" in path_names and name in _MOE_AXES and base_ndim == 3:
        axes = _MOE_AXES[name]
    elif name in _NAME_AXES and base_ndim == len(_NAME_AXES[name]):
        axes = _NAME_AXES[name]
    else:
        axes = (None,) * base_ndim
    return (None,) * stacked + axes


def map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists and PackedTensors
    (whose streams are leaves under their stream names); the path holds
    dict keys, list indices (ints) and stream names. A PackedTensor maps
    to a PackedTensor of the results."""
    if isinstance(tree, PackedTensor):
        return PackedTensor({k: fn(path + (k,), v)
                             for k, v in tree.streams.items()},
                            tree.shape, tree.codec)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _split_path(path: tuple):
    """(names without list indices, whether a list index was crossed: the
    leaf is one block of what the reference stacks on axis 0)."""
    names = tuple(str(p) for p in path if not isinstance(p, int))
    return names, any(isinstance(p, int) for p in path)


def _param_axes(path: tuple, shape: tuple) -> tuple:
    names, stacked = _split_path(path)
    if names and names[-1] in _STREAMS:
        names = names[:-1]
    if stacked:                  # the reference's stacked leaf, minus axis 0
        return infer_logical_axes(names, (1,) + tuple(shape))[1:]
    return infer_logical_axes(names, tuple(shape))


def _cache_axes(path: tuple, ndim: int) -> tuple:
    names, stacked = _split_path(path)
    name = names[-1] if names else ""
    if name in _STREAMS and len(names) >= 2:
        name = names[-2]                # quantized KV streams -> k/v axes
    axes = _CACHE_AXES.get(name)
    if axes is None:
        return (None,) * ndim
    if stacked:
        axes = axes[1:]
    axes = axes[:ndim]
    return axes + (None,) * (ndim - len(axes))


def param_shardings(params, mesh, rules: Optional[dict] = None):
    """``NamedSharding`` tree matching ``params`` (PackedTensor-aware: its
    streams inherit the parent weight's axes)."""
    with use_sharding(mesh, rules):
        return map_with_path(lambda p, leaf: NamedSharding(
            mesh, logical_to_spec(_param_axes(p, leaf.shape), leaf.shape)),
            params)


def cache_shardings(caches, mesh, rules: Optional[dict] = None):
    """``NamedSharding`` tree for decode caches (the port's per-layer
    lists; quantized K/V streams take the k/v axes)."""
    with use_sharding(mesh, rules):
        return map_with_path(lambda p, leaf: NamedSharding(
            mesh, logical_to_spec(_cache_axes(p, leaf.dim()), leaf.shape)),
            caches)


# ---------------------------------------------------------------------------
# Trees at their placements
# ---------------------------------------------------------------------------

def _zip_map(fn, tree, other):
    if isinstance(tree, PackedTensor):
        return PackedTensor({k: fn(v, other.streams[k])
                             for k, v in tree.streams.items()},
                            tree.shape, tree.codec)
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


def place_tree(tree, shardings):
    """Every leaf of ``tree`` as a DTensor at its ``NamedSharding`` of
    ``shardings`` (a tree of the same structure on a ``DeviceMesh``)."""
    return _zip_map(lambda t, s: s.place(t), tree, shardings)


def _leafwise(fn, tree):
    return map_with_path(lambda _, t: fn(t), tree)


def gather_tree(tree):
    """DTensor leaves gathered to their full value on every rank (what the
    model computes on); other leaves as they are."""
    from torch.distributed.tensor import DTensor
    return _leafwise(lambda t: t.full_tensor() if isinstance(t, DTensor)
                     else t, tree)


def local_tree(tree):
    """Each DTensor leaf's local shard; other leaves as they are."""
    from torch.distributed.tensor import DTensor
    return _leafwise(lambda t: t.to_local() if isinstance(t, DTensor)
                     else t, tree)


def shard_nbytes(tree, shardings) -> int:
    """Bytes of one rank's shards of ``tree``'s leaves (tensors, meta
    tensors included), from each leaf's spec and shape: no process group
    is needed."""
    total = []
    _zip_map(lambda t, s: total.append(s.shard_nbytes(tuple(t.shape),
                                                      t.dtype)),
             tree, shardings)
    return sum(total)
