"""Dense decoder LM of the serve path (port of the dense family of
repro.models.model, with its attention variants: QKV bias, qk-norm, tied
embeddings, sliding windows, local/global layers and both soft-caps).

Parameters are a dict: ``embed`` (V, d) bf16, ``final_norm`` (d,) f32,
``lm_head`` (d, V) bf16 (absent under ``tie_embeddings``: the head is
``embed.T``) and ``layers``, a list of per-layer dicts
``{attn_norm, attn: {wq, wk, wv, wo[, bq, bk, bv][, q_norm, k_norm]},
ffn_norm, ffn: {gate, up, down}}``.
The reference stacks the layers on a leading axis and scans over them; the
port loops over the list, so each layer can be packed and freed on its own
(``repro_torch.convert`` maps one layout to the other).

Entry points:
  decode_step(...)    one token per slot against the per-slot caches
  prefill_chunk(...)  up to T tokens per slot in one launch, bit-identical
                      per position to feeding them through decode_step
Both update the caches in place and return f32 logits.
"""
from __future__ import annotations

import torch

from repro_torch.core.codecs import get_codec, packed_codecs
from . import attention as attn
from .kvquant import kv_codec
from .layers import init_embedding, init_mlp, mlp_apply, rms_norm, softcap
from .numerics import dot_f32acc
from .quant import pack_serving_weight

__all__ = [
    "init_params", "init_head", "init_layer", "init_caches", "decode_step",
    "prefill_chunk", "pack_layer_for_serving", "pack_params_for_serving",
    "layer_windows",
]

_PACK_KEYS = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for configuration features the port
    has not taken yet (other families, experts, embedding input), and
    ``ValueError`` for a served ``quant_format`` with no packed path
    (naming ``packed_codecs()``) or a ``kv_quant`` codec with no packed KV
    path (naming ``kv_codecs()``), in the reference's words."""
    missing = [name for name, on in (
        (f"family={cfg.family!r}", cfg.family != "dense"),
        ("experts", cfg.is_moe),
        (f"input_mode={cfg.input_mode!r}", cfg.input_mode != "tokens"),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the torch port serves dense attention models "
            f"only; not ported yet: {', '.join(missing)}")
    if cfg.quant == "serve" and not get_codec(cfg.quant_format).packed:
        raise ValueError(
            f"cfg.quant_format={cfg.quant_format!r} has no packed serving "
            f"path; packable codecs: {', '.join(packed_codecs())}")
    if cfg.kv_quant != "none":
        kv_codec(cfg.kv_quant)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_head(gen: torch.Generator, cfg, device="cuda") -> dict:
    """Embedding, final norm and LM head (drawn before the layers); no
    ``lm_head`` under ``tie_embeddings``."""
    check_supported(cfg)
    out = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, device),
        "final_norm": torch.ones(cfg.d_model, dtype=torch.float32,
                                 device=device),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                        device).T.contiguous()
    return out


def init_layer(gen: torch.Generator, cfg, device="cuda") -> dict:
    ones = torch.ones(cfg.d_model, dtype=torch.float32, device=device)
    return {
        "attn_norm": ones,
        "attn": attn.init_attention(gen, cfg, device),
        "ffn_norm": ones.clone(),
        "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, device),
    }


def init_params(gen: torch.Generator, cfg, device="cuda") -> dict:
    """Random dense bf16 parameters drawn from ``gen`` (a generator on
    ``device``). The draws differ from the reference's ``jax.random``."""
    params = init_head(gen, cfg, device)
    params["layers"] = [init_layer(gen, cfg, device)
                        for _ in range(cfg.n_layers)]
    return params


def layer_windows(cfg) -> list:
    """Each layer's window as a plain int, 0 for a global layer (the
    reference's values): under ``local_global`` the even layers are local
    with ``sliding_window or 4096``; with ``sliding_window`` alone every
    layer is windowed; else all are global."""
    if cfg.local_global:
        local = cfg.sliding_window or 4096
        return [local if i % 2 == 0 else 0 for i in range(cfg.n_layers)]
    return [cfg.sliding_window or 0] * cfg.n_layers


def init_caches(cfg, batch: int, max_len: int, device="cuda") -> dict:
    """Per-slot KV caches of every layer (``attention.init_cache``), each a
    ring of ``min(window, max_len)`` positions for its layer's window:
    bf16, or packed in ``cfg.kv_quant``. The reference's local/global
    stacks are this list's even and odd layers."""
    check_supported(cfg)
    return {"layers": [attn.init_cache(cfg, batch, max_len, w, device)
                       for w in layer_windows(cfg)]}


# ---------------------------------------------------------------------------
# Decode / chunked prefill
# ---------------------------------------------------------------------------

def _ffn(lp, h, cfg):
    x = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    return h + mlp_apply(lp["ffn"], x, cfg.quant)


def _logits(params, cfg, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return softcap(dot_f32acc(h, head), cfg.final_softcap)


def decode_step(params: dict, cfg, batch: dict, caches: dict,
                index: torch.Tensor) -> torch.Tensor:
    """One token for every slot. batch: {"tokens": (B, 1)}; ``index`` (B,)
    absolute position of each slot's token. Updates ``caches`` in place and
    returns f32 logits (B, 1, V)."""
    h = params["embed"][batch["tokens"]]
    for lp, cache in zip(params["layers"], caches["layers"]):
        x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        h = h + attn.attention_decode(lp["attn"], x, cfg, cache, index,
                                      cfg.quant)
        h = _ffn(lp, h, cfg)
    return _logits(params, cfg, h)


def prefill_chunk(params: dict, cfg, batch: dict, caches: dict,
                  index: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Chunked prefill: batch {"tokens": (B, T)}; ``index`` (B,) position of
    column 0 per slot; ``lengths`` (B,) valid tokens per row, 0..T (0 =
    idle, caches untouched). Every projection runs once over the chunk.
    Returns f32 logits (B, T, V); ``logits[b, t]`` for t < lengths[b] is
    bit-identical to what ``decode_step`` emits for the same tokens fed one
    at a time, later positions are garbage to discard."""
    h = params["embed"][batch["tokens"]]
    for lp, cache in zip(params["layers"], caches["layers"]):
        x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        h = h + attn.attention_prefill(lp["attn"], x, cfg, cache, index,
                                       lengths, cfg.quant)
        h = _ffn(lp, h, cfg)
    return _logits(params, cfg, h)


# ---------------------------------------------------------------------------
# Serving: pack every GEMM weight
# ---------------------------------------------------------------------------

def pack_layer_for_serving(layer: dict, fmt: str) -> dict:
    """One dense layer -> the same layer with every GEMM weight packed in
    codec ``fmt`` (a weight whose K is not a multiple of 32 stays dense);
    norms stay f32."""
    def convert(name, leaf):
        if isinstance(leaf, dict):
            return {k: convert(k, v) for k, v in leaf.items()}
        if name in _PACK_KEYS and leaf.shape[0] % 32 == 0:
            return pack_serving_weight(leaf.to(torch.float32), fmt)
        return leaf
    return convert("", layer)


def pack_params_for_serving(params: dict, cfg) -> dict:
    """Dense params -> packed streams of ``cfg.quant_format`` for every
    GEMM weight; embedding, LM head, norms and biases stay as they are."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = [pack_layer_for_serving(lp, cfg.quant_format)
                     for lp in params["layers"]]
    return out
