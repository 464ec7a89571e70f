"""Carry parameters across from the JAX package to the port.

``from_jax_tree`` takes the reference's parameter tree with every leaf as a
numpy array -- the dense tree of ``init_params`` or the packed tree of
``prequantize_params`` -- and returns the port's parameter dict. The port
never sees a JAX type: a packed leaf arrives flattened as
``{"codec": str, "shape": tuple, "streams": {name: np.ndarray}}``.

Layouts: the reference stacks per-layer leaves (packed streams included) on
axis 0 under ``layers``; the port keeps a list of per-layer dicts. bf16
leaves arrive as ``ml_dtypes.bfloat16`` arrays and are carried by bit view
(int16), never through a float round trip.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.codecs import PackedTensor

__all__ = ["from_jax_tree", "to_tensor"]


def to_tensor(a: np.ndarray, device="cuda") -> torch.Tensor:
    """numpy array -> tensor with the same bytes (bf16 by int16 view)."""
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
