"""Input-shape cells of the dry-run and their tensors on PyTorch's "meta"
device: shapes and dtypes, no memory (port of repro.configs.shapes).

Four shapes per LM arch (seq_len x global_batch):
    train_4k    4,096 x 256    train step
    prefill_32k 32,768 x 32    prefill (forward, cache build)
    decode_32k  32,768 x 128   decode (1 token, 32k cache)
    long_500k   524,288 x 1    decode (1 token, 500k cache) -- only for
                               archs with sub-quadratic / bounded-cache
                               decode (cfg.long_context_ok)

``cache_specs`` are the port's decode caches (``models.model.
init_caches``): per slot, as the engine serves, so each layer's position
track is (batch, window) int32.
"""
from __future__ import annotations

import torch

__all__ = ["SHAPES", "applicable_shapes", "input_specs", "cache_specs"]

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def applicable_shapes(cfg) -> list:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.long_context_ok:
        out.append("long_500k")
    return out


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _tokens_spec(cfg, batch: int, seq: int) -> dict:
    if cfg.input_mode == "embeddings":
        return {"embeds": _meta((batch, seq, cfg.d_model), torch.bfloat16)}
    return {"tokens": _meta((batch, seq), torch.int32)}


def input_specs(cfg, shape_name: str) -> dict:
    """Meta tensors of the *data* inputs of this cell's step."""
    s = SHAPES[shape_name]
    batch, seq = s["batch"], s["seq"]
    if s["kind"] == "train":
        spec = _tokens_spec(cfg, batch, seq)
        spec["labels"] = _meta((batch, seq), torch.int32)
        return spec
    if s["kind"] == "prefill":
        return _tokens_spec(cfg, batch, seq)
    return _tokens_spec(cfg, batch, 1)      # one new token, seq-long cache


def cache_specs(cfg, shape_name: str) -> dict:
    """The decode caches of this cell as meta tensors (no allocation)."""
    from repro_torch.models.model import init_caches
    s = SHAPES[shape_name]
    return init_caches(cfg, s["batch"], s["seq"], "meta")
