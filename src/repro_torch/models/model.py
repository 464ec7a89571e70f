"""Decoder LM of the serve path (port of the attention families of
repro.models.model -- dense, moe, audio and vlm -- with the attention
variants: QKV bias, qk-norm, tied embeddings, sliding windows, local/global
layers and both soft-caps).

Parameters are a dict: ``embed`` (V, d) bf16, ``final_norm`` (d,) f32,
``lm_head`` (d, V) bf16 (absent under ``tie_embeddings``: the head is
``embed.T``) and ``layers``, a list of per-layer dicts
``{attn_norm, attn: {wq, wk, wv, wo[, bq, bk, bv][, q_norm, k_norm]},
ffn_norm, ffn}``: ``ffn`` is ``{gate, up, down}`` (an MLP), or under
``cfg.is_moe`` ``{router, gate, up, down}`` (``models/moe.py``). A model
with ``input_mode="embeddings"`` (the audio and vlm families, whose
frontends are stubs in the reference) takes its input as embeddings; it
still draws ``embed``, as the reference's ``init_params`` does.
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
from .moe import init_moe, moe_apply
from .numerics import dot_f32acc
from .quant import pack_serving_weight

__all__ = [
    "init_params", "init_head", "init_layer", "init_caches", "decode_step",
    "prefill_chunk", "pack_layer_for_serving", "pack_params_for_serving",
    "layer_windows",
]

_PACK_KEYS = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for the families the port has not
    taken yet (the recurrent ``ssm`` and ``hybrid``), and ``ValueError`` for
    a served ``quant_format`` with no packed path (naming
    ``packed_codecs()``) or a ``kv_quant`` codec with no packed KV path
    (naming ``kv_codecs()``), in the reference's words."""
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the torch port serves the attention families "
            f"(dense, moe, audio, vlm) only; not ported yet: "
            f"family={cfg.family!r}")
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
        "ffn": init_moe(gen, cfg, device) if cfg.is_moe
        else init_mlp(gen, cfg.d_model, cfg.d_ff, device),
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

def _embed_in(params, cfg, batch) -> torch.Tensor:
    """batch {"embeds": (B, T, d) bf16} under ``input_mode="embeddings"``,
    else {"tokens": (B, T)} looked up in ``embed``."""
    if cfg.input_mode == "embeddings":
        return batch["embeds"]
    return params["embed"][batch["tokens"]]


def _ffn(lp, h, cfg):
    x = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    if cfg.is_moe:
        return h + moe_apply(lp["ffn"], x, cfg, cfg.quant)
    return h + mlp_apply(lp["ffn"], x, cfg.quant)


def _logits(params, cfg, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return softcap(dot_f32acc(h, head), cfg.final_softcap)


def decode_step(params: dict, cfg, batch: dict, caches: dict,
                index: torch.Tensor) -> torch.Tensor:
    """One token for every slot. batch: {"tokens": (B, 1)}, or
    {"embeds": (B, 1, d)} under ``input_mode="embeddings"``; ``index`` (B,)
    absolute position of each slot's token. Updates ``caches`` in place and
    returns f32 logits (B, 1, V)."""
    h = _embed_in(params, cfg, batch)
    for lp, cache, window in zip(params["layers"], caches["layers"],
                                 layer_windows(cfg)):
        x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        h = h + attn.attention_decode(lp["attn"], x, cfg, cache, index,
                                      cfg.quant, window)
        h = _ffn(lp, h, cfg)
    return _logits(params, cfg, h)


def prefill_chunk(params: dict, cfg, batch: dict, caches: dict,
                  index: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Chunked prefill: batch {"tokens": (B, T)} (or {"embeds": (B, T, d)});
    ``index`` (B,) position of column 0 per slot; ``lengths`` (B,) valid
    tokens per row, 0..T (0 = idle, caches untouched). Every projection
    runs once over the chunk. Returns f32 logits (B, T, V); ``logits[b, t]``
    for t < lengths[b] is bit-identical to what ``decode_step`` emits for
    the same tokens fed one at a time, later positions are garbage to
    discard -- except under ``cfg.is_moe``, as in the reference: the
    experts route the chunk's B*T tokens (its padding included) as one
    group, whose capacity differs from that of the B tokens of a decode
    step, so a chunk of T > 1 may drop other tokens than decode does."""
    h = _embed_in(params, cfg, batch)
    for lp, cache, window in zip(params["layers"], caches["layers"],
                                 layer_windows(cfg)):
        x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        h = h + attn.attention_prefill(lp["attn"], x, cfg, cache, index,
                                       lengths, cfg.quant, window)
        h = _ffn(lp, h, cfg)
    return _logits(params, cfg, h)


# ---------------------------------------------------------------------------
# Serving: pack every GEMM weight
# ---------------------------------------------------------------------------

def pack_layer_for_serving(layer: dict, fmt: str) -> dict:
    """One dense layer -> the same layer with every GEMM weight packed in
    codec ``fmt``, by the reference's rule: an expert weight (E, K, N) is
    laid out contraction first, (K, E, N), and then, like a (K, N) weight,
    packed only if its second-to-last axis is a multiple of 32 -- for an
    expert weight that axis is E, so experts of a model with E % 32 != 0
    stay dense (E, K, N) bf16. The router, norms and biases stay as they
    are."""
    def convert(name, leaf):
        if isinstance(leaf, dict):
            return {k: convert(k, v) for k, v in leaf.items()}
        if name not in _PACK_KEYS or leaf.dim() < 2:
            return leaf
        # experts (E, K, N) -> contraction first (K, E, N), a view
        w = leaf.permute(1, 0, 2) if leaf.dim() == 3 else leaf
        if w.shape[-2] % 32:
            return leaf
        return pack_serving_weight(w.to(torch.float32), fmt)
    return convert("", layer)


def pack_params_for_serving(params: dict, cfg) -> dict:
    """Dense params -> packed streams of ``cfg.quant_format`` for every
    GEMM weight; embedding, LM head, norms and biases stay as they are."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = [pack_layer_for_serving(lp, cfg.quant_format)
                     for lp in params["layers"]]
    return out
