"""Carry parameters across between the JAX package's layout and the port.

``from_jax_tree`` takes a tree in the reference's layout -- the dense tree
of ``init_params`` or the packed tree of ``prequantize_params``, leaves as
numpy arrays or CPU tensors -- and returns the port's parameter dict. The
port never sees a JAX type: a packed leaf arrives flattened as
``{"codec": str, "shape": tuple, "streams": {name: array}}``.
``stack_layers`` is its inverse, and ``flat_leaves`` / ``from_flat_leaves``
map such a tree to and from the leaf paths of the reference's checkpoints
(``repro_torch.checkpoint``). ``from_jax_train_state`` and
``to_jax_train_state`` do the same for a train state
(``{"params", "opt": {"m", "v", "step"}[, "err"]}``: m, v and err mirror
the parameter tree), and ``train_state_leaves`` /
``from_train_state_leaves`` carry one to and from its checkpoint leaves.

Layouts: the reference stacks per-layer leaves (packed streams included) on
axis 0 under ``layers`` (and, for the recurrent families, under ``mlstm``,
``mlstm_norm``, ``slstm``, ``slstm_norm``, ``mamba`` and ``mamba_norm``);
the port keeps a list of per-block dicts (or tensors) under the same key.
A hybrid model's ``shared_attn`` is one block in both, never stacked. bf16
leaves arrive as ``ml_dtypes.bfloat16`` arrays or bf16 tensors and are
carried by bit view (int16), never through a float round trip.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.codecs import PackedTensor
from repro_torch.tree import tree_map

__all__ = ["from_jax_tree", "to_tensor", "stack_layers", "flat_leaves",
           "from_flat_leaves", "from_jax_train_state", "to_jax_train_state",
           "train_state_leaves", "from_train_state_leaves", "STACKED",
           "reference_ndims"]

_TREES = ("params", "err")          # a train state's parameter-shaped trees
# the keys under which the reference stacks blocks on axis 0
STACKED = ("layers", "mlstm", "mlstm_norm", "slstm", "slstm_norm", "mamba",
           "mamba_norm")


def reference_ndims(tree):
    """``tree`` (a parameter-shaped dict of the port) with each tensor leaf
    replaced by the number of axes of its counterpart in the reference's
    layout: one more than its own under a ``STACKED`` key, where the
    reference holds the blocks on axis 0 (a per-layer norm is a vector
    here and a matrix there). The reference's rules that test ``ndim``
    (the compute cast, weight decay) read this."""
    if not isinstance(tree, dict):
        return tree_map(lambda t: t.dim(), tree)
    return {k: tree_map(lambda t, s=int(k in STACKED): t.dim() + s, v)
            for k, v in tree.items()}


def to_tensor(a, device="cuda") -> torch.Tensor:
    """numpy array or tensor -> a new tensor on ``device`` with the same
    bytes (bf16 arrays by int16 view)."""
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True)
    a = np.array(a, order="C")          # a copy; keeps a 0-d array 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _is_packed(node) -> bool:
    return isinstance(node, dict) and set(node) == {"codec", "shape",
                                                    "streams"}


def _convert(node, device, layer=None):
    """Numpy tree -> torch tree; ``layer`` picks one slice of a stacked
    leaf (axis 0)."""
    if _is_packed(node):
        streams = {name: to_tensor(s if layer is None else s[layer], device)
                   for name, s in node["streams"].items()}
        return PackedTensor(streams, tuple(node["shape"]), node["codec"])
    if isinstance(node, dict):
        return {k: _convert(v, device, layer) for k, v in node.items()}
    return to_tensor(node if layer is None else node[layer], device)


def _n_stacked(node) -> int:
    """The length of the stacked axis 0 of a stacked subtree."""
    while not hasattr(node, "shape"):
        node = next(iter((node["streams"] if _is_packed(node)
                          else node).values()))
    return node.shape[0]


def from_jax_tree(tree: dict, cfg, device="cuda") -> dict:
    """Reference parameter tree (numpy leaves) -> the port's parameters on
    ``device``: each ``STACKED`` subtree becomes a list, one block per
    index of its axis 0."""
    return {k: ([_convert(v, device, i) for i in range(_n_stacked(v))]
                if k in STACKED else _convert(v, device))
            for k, v in tree.items()}


def stack_layers(params: dict) -> dict:
    """The port's parameter dict -> the reference's layout: each list of
    blocks (``layers``, the recurrent groups) stacked on axis 0, packed
    leaves as ``{"codec", "shape", "streams"}`` dicts (inverse of
    from_jax_tree)."""
    def plain(node):
        if isinstance(node, PackedTensor):
            return {"codec": node.codec, "shape": node.shape,
                    "streams": dict(node.streams)}
        if isinstance(node, dict):
            return {k: plain(v) for k, v in node.items()}
        return node

    def stack(nodes):
        first = nodes[0]
        if _is_packed(first):
            return {**first,
                    "streams": stack([n["streams"] for n in nodes])}
        if isinstance(first, dict):
            return {k: stack([n[k] for n in nodes]) for k in first}
        return torch.stack(nodes)

    return {k: stack([plain(b) for b in v]) if isinstance(v, list)
            else plain(v) for k, v in params.items()}


def flat_leaves(tree: dict, prefix: str = "") -> dict:
    """Tree in the reference's layout -> {leaf path: leaf} with the
    reference's checkpoint paths and order: dict keys sorted, "/" between
    components, a packed leaf's streams as ``<path>/.<stream>`` in stream
    order."""
    out = {}
    for k in sorted(tree):
        node, path = tree[k], f"{prefix}{k}"
        if _is_packed(node):
            out.update({f"{path}/.{s}": a
                        for s, a in node["streams"].items()})
        elif isinstance(node, dict):
            out.update(flat_leaves(node, path + "/"))
        else:
            out[path] = node
    return out


def _fill(flat: dict, node, prefix: str = ""):
    """``node`` (a tree in the reference's layout) with each leaf replaced
    by ``flat``'s value at its ``flat_leaves`` path."""
    if _is_packed(node):
        return {**node, "streams": {s: flat[f"{prefix}/.{s}"]
                                    for s in node["streams"]}}
    if isinstance(node, dict):
        return {k: _fill(flat, v, f"{prefix}/{k}" if prefix else k)
                for k, v in node.items()}
    return flat[prefix]


def from_flat_leaves(flat: dict, template: dict, cfg,
                     device="cuda") -> dict:
    """{leaf path: array} (``flat_leaves`` paths of ``template``, a tree in
    the reference's layout) -> the port's parameter dict on ``device``."""
    return from_jax_tree(_fill(flat, template), cfg, device)


def from_jax_train_state(state: dict, cfg, device="cuda") -> dict:
    """Reference train state (numpy leaves, layers stacked):
    ``{"params", "opt": {"m", "v", "step"}[, "err"]}`` -> the port's on
    ``device``."""
    out = {k: from_jax_tree(state[k], cfg, device) for k in _TREES
           if k in state}
    opt = state["opt"]
    out["opt"] = {"m": from_jax_tree(opt["m"], cfg, device),
                  "v": from_jax_tree(opt["v"], cfg, device),
                  "step": to_tensor(opt["step"], device)}
    return out


def to_jax_train_state(state: dict) -> dict:
    """The port's train state -> the reference's layout (tensors, layers
    stacked on axis 0; inverse of ``from_jax_train_state``)."""
    out = {k: stack_layers(state[k]) for k in _TREES if k in state}
    opt = state["opt"]
    out["opt"] = {"m": stack_layers(opt["m"]), "v": stack_layers(opt["v"]),
                  "step": opt["step"]}
    return out


def _move(node, device):
    """A copy of a tree of dicts and lists of tensors on ``device`` (fresh
    tensors, also where a leaf is there already)."""
    return tree_map(lambda t: t.detach().to(device, copy=True), node)


def train_state_leaves(state: dict, device="cpu") -> dict:
    """{checkpoint leaf path: tensor on ``device``} of the port's train
    state, in the reference's paths (``flat_leaves`` of
    ``to_jax_train_state``). Each leaf is moved to ``device`` before the
    layers are stacked, so a state on the card is stacked on the host
    ("cpu"), or not at all ("meta": a restore template)."""
    return flat_leaves(to_jax_train_state(_move(state, device)))


def from_train_state_leaves(flat: dict, template: dict, cfg,
                            device="cuda") -> dict:
    """{leaf path: array or tensor} (the ``train_state_leaves`` paths of
    the train state ``template``, whose values are not read) -> the port's
    train state on ``device``."""
    tree = to_jax_train_state(_move(template, "meta"))
    return from_jax_train_state(_fill(flat, tree), cfg, device)
