"""GQA attention over a per-slot bf16 KV cache (port of the decode and
chunked-prefill paths of repro.models.attention).

The cache of one layer is ``{"k": (B, W, nkv, hd), "v": (B, W, nkv, hd),
"pos": (B, W) int32}``: batch row b is request slot b, a ring buffer of W
positions with its own position track (-1 = empty), so each slot is
admitted and evicted independently (continuous batching). Unlike the
reference, which returns a new cache, the port writes the cache in place.

``_attend_one`` is the one inner step: write ONE token's K/V per row at
``index % W`` and attend against the whole page. Decode calls it once;
chunked prefill projects QKV for the whole chunk in one GEMM and then calls
it position by position with the same shapes, so every position's result
is bit-identical to sequential decode. Scores and the probability-weighted
sum run in f32 on bf16-rounded operands, as the reference does. QKV bias,
qk-norm, sliding windows, softcaps and KV quantization are not ported yet.
"""
from __future__ import annotations

import torch

from .layers import apply_rope
from .quant import init_linear, quantized_matmul

NEG_INF = -2.0e38

__all__ = [
    "init_attention", "attention_decode", "attention_prefill", "init_cache",
]


def init_attention(gen: torch.Generator, cfg, device="cuda") -> dict:
    d, hd, nh, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": init_linear(gen, d, nh * hd, device),
        "wk": init_linear(gen, d, nkv * hd, device),
        "wv": init_linear(gen, d, nkv * hd, device),
        "wo": init_linear(gen, nh * hd, d, device),
    }


def _project_qkv(p, x, cfg, positions, quant):
    b, s, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = quantized_matmul(x, p["wq"], quant).reshape(b, s, nh, hd)
    k = quantized_matmul(x, p["wk"], quant).reshape(b, s, nkv, hd)
    v = quantized_matmul(x, p["wv"], quant).reshape(b, s, nkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend_one(q, k_new, v_new, out_dtype, cfg, cache, index, valid=None):
    """Write one token's K/V per slot and attend ``q`` against the page.

    q (B,1,nh,hd); k_new/v_new (B,1,nkv,hd); ``index`` (B,) absolute
    positions; ``valid`` (B,) bool or None -- rows where it is False leave
    their cache untouched and return garbage context for the caller to
    discard. Updates ``cache`` in place; returns ctx (B,1,nh*hd)."""
    b = q.shape[0]
    w = cache["k"].shape[1]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rows = torch.arange(b, device=q.device)
    slot = torch.remainder(index, w)
    for name, new in (("k", k_new[:, 0]), ("v", v_new[:, 0]),
                      ("pos", index.to(torch.int32))):
        buf = cache[name]
        new = new.to(buf.dtype)
        if valid is not None:
            keep = valid.reshape((-1,) + (1,) * (new.dim() - 1))
            new = torch.where(keep, new, buf[rows, slot])
        buf[rows, slot] = new
    k, v, pos = cache["k"], cache["v"], cache["pos"]

    g = nh // nkv
    qh = q.reshape(b, nkv, g, hd).to(torch.bfloat16).to(torch.float32)
    sc = torch.einsum("bkgd,bwkd->bkgw", qh,
                      k.to(torch.float32)) * (hd ** -0.5)
    idx = index[:, None]
    valid_kv = (pos >= 0) & (pos <= idx)                         # (B, W)
    sc = torch.where(valid_kv[:, None, None, :], sc, NEG_INF)
    probs = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgw,bwkd->bkgd",
                       probs.to(torch.bfloat16).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, 1, nh * hd).to(out_dtype)


def attention_decode(p: dict, x: torch.Tensor, cfg, cache: dict,
                     index: torch.Tensor, quant: str = "none"):
    """One-token decode for every slot: x (B,1,d), ``index`` (B,) absolute
    positions. Updates ``cache`` in place; returns out (B,1,d)."""
    q, k_new, v_new = _project_qkv(p, x, cfg, index[:, None], quant)
    ctx = _attend_one(q, k_new, v_new, x.dtype, cfg, cache, index)
    return quantized_matmul(ctx, p["wo"], quant)


def attention_prefill(p: dict, x: torch.Tensor, cfg, cache: dict,
                      index: torch.Tensor, lengths: torch.Tensor,
                      quant: str = "none"):
    """Chunked prefill: up to T tokens per slot in one call. x (B,T,d); row
    b's valid tokens are ``x[b, :lengths[b]]`` at positions ``index[b]``
    onward (``lengths`` may be 0 for idle rows). The QKV and output
    projections run once over the chunk; the cache write and attend run
    position by position through ``_attend_one``. Returns out (B,T,d)."""
    t = x.shape[1]
    offs = torch.arange(t, dtype=index.dtype, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, index[:, None] + offs, quant)
    ctxs = [
        _attend_one(q[:, i:i + 1], k_new[:, i:i + 1], v_new[:, i:i + 1],
                    x.dtype, cfg, cache, index + i, valid=i < lengths)
        for i in range(t)]
    return quantized_matmul(torch.cat(ctxs, dim=1), p["wo"], quant)


def init_cache(cfg, batch: int, max_len: int, device="cuda") -> dict:
    """Empty bf16 per-slot cache of ``max_len`` positions for ``batch``
    slots."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                          device=device),
    }
