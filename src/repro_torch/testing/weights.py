"""Seeded values for the attention leaves that ``init_attention`` draws as
constants: the QKV biases (zeros) and the qk-norm weights (ones). A model
served with those constants computes ``q + 0`` and ``rms_norm(q) * 1``, so
a port that dropped the bias or the norm weight, or swapped two of them,
would give the same numbers; with these values it would not."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["attention_extras", "fill_attention_extras"]

# (leaf, standard deviation) of the biases: a different magnitude for each,
# so that swapping bk and bv (one shape) changes the result
_BIAS_STD = (("bq", 0.5), ("bk", 1.0), ("bv", 0.25))
# (leaf, low, high) of the norm weights, around 1 and apart from each other
_NORM_RANGE = (("q_norm", 0.5, 1.5), ("k_norm", 0.25, 0.75))


def attention_extras(cfg, seed: int = 0) -> dict:
    """Leaf name -> f32 numpy array (n_layers, width) for each bias
    (``cfg.qkv_bias``) and norm weight (``cfg.qk_norm``) the configuration
    has; empty when it has neither. The reference's stacked layer tree
    takes these arrays as they are; ``fill_attention_extras`` writes them
    into the port's list of layers."""
    rng = np.random.default_rng(seed)
    n, nh, nkv, hd = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out = {}
    if cfg.qkv_bias:
        widths = {"bq": nh * hd, "bk": nkv * hd, "bv": nkv * hd}
        for name, std in _BIAS_STD:
            out[name] = (rng.standard_normal((n, widths[name]))
                         * std).astype(np.float32)
    if cfg.qk_norm:
        for name, lo, hi in _NORM_RANGE:
            out[name] = rng.uniform(lo, hi, (n, hd)).astype(np.float32)
    return out


def fill_attention_extras(params: dict, cfg, seed: int = 0) -> dict:
    """Write ``attention_extras(cfg, seed)`` into the port's ``params`` in
    place, each leaf cast to its own dtype (bf16 biases, f32 norm
    weights) on its own device. Returns ``params``."""
    for name, values in attention_extras(cfg, seed).items():
        for lp, row in zip(params["layers"], values):
            leaf = lp["attn"][name]
            leaf.copy_(torch.from_numpy(row).to(leaf.dtype))
    return params
