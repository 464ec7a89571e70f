"""Carry parameters across between the JAX package's layout and the port.

``from_jax_tree`` takes a tree in the reference's layout -- the dense tree
of ``init_params`` or the packed tree of ``prequantize_params``, leaves as
numpy arrays or CPU tensors -- and returns the port's parameter dict. The
port never sees a JAX type: a packed leaf arrives flattened as
``{"codec": str, "shape": tuple, "streams": {name: array}}``.
``stack_layers`` is its inverse, and ``flat_leaves`` / ``from_flat_leaves``
map such a tree to and from the leaf paths of the reference's checkpoints
(``repro_torch.checkpoint``).

Layouts: the reference stacks per-layer leaves (packed streams included) on
axis 0 under ``layers``; the port keeps a list of per-layer dicts. bf16
leaves arrive as ``ml_dtypes.bfloat16`` arrays or bf16 tensors and are
carried by bit view (int16), never through a float round trip.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.codecs import PackedTensor

__all__ = ["from_jax_tree", "to_tensor", "stack_layers", "flat_leaves",
           "from_flat_leaves"]


def to_tensor(a, device="cuda") -> torch.Tensor:
    """numpy array or tensor -> a new tensor on ``device`` with the same
    bytes (bf16 arrays by int16 view)."""
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True)
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


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


def from_jax_tree(tree: dict, cfg, device="cuda") -> dict:
    """Reference parameter tree (numpy leaves) -> the port's parameters on
    ``device``."""
    out = {k: _convert(v, device) for k, v in tree.items() if k != "layers"}
    out["layers"] = [_convert(tree["layers"], device, i)
                     for i in range(cfg.n_layers)]
    return out


def stack_layers(params: dict) -> dict:
    """The port's parameter dict -> the reference's layout: per-layer
    leaves stacked on axis 0 under ``layers``, packed leaves as
    ``{"codec", "shape", "streams"}`` dicts (inverse of from_jax_tree)."""
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

    out = {k: plain(v) for k, v in params.items() if k != "layers"}
    out["layers"] = stack([plain(lp) for lp in params["layers"]])
    return out


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


def from_flat_leaves(flat: dict, template: dict, cfg,
                     device="cuda") -> dict:
    """{leaf path: array} (``flat_leaves`` paths of ``template``, a tree in
    the reference's layout) -> the port's parameter dict on ``device``."""
    def fill(node, prefix):
        if _is_packed(node):
            return {**node, "streams": {s: flat[f"{prefix}/.{s}"]
                                        for s in node["streams"]}}
        if isinstance(node, dict):
            return {k: fill(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in node.items()}
        return flat[prefix]
    return from_jax_tree(fill(template, ""), cfg, device)
