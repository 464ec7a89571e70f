"""GQA attention over a per-slot KV cache, bf16 or packed (port of the
decode and chunked-prefill paths of repro.models.attention), with the
reference's variants: QKV bias (qwen2), qk-norm (qwen3), sliding windows
and a tanh soft-cap on the scores (gemma2).

The cache of one layer is ``{"k": (B, W, nkv, hd), "v": (B, W, nkv, hd),
"pos": (B, W) int32}``: batch row b is request slot b, a ring buffer of W
positions with its own position track (-1 = empty), so each slot is
admitted and evicted independently (continuous batching). A windowed
layer's ring holds ``min(window, max_len)`` positions, and the ring width
is the window: a query writes its own K/V before it attends, so the page
holds exactly the last W positions of its slot (an admit resets the rest
to -1), and no key ``window`` or more positions back is ever in it. Layers
of one model may have rings of different W. With
``cfg.kv_quant`` set to a codec of ``kv_codecs()``, "k" and "v" are each a
dict of that codec's u8 streams with the same leading (B, W, nkv) axes
(``models/kvquant.py``): new tokens are encoded as they are written and the
whole page is decoded to bf16 before the scores. Unlike the reference,
which returns a new cache, the port writes the cache in place.

``_attend_one`` is the one inner step: write ONE token's K/V per row at
``index % W`` and attend against the whole page. Decode calls it once;
chunked prefill projects QKV (and encodes packed K/V) for the whole chunk
at once and then calls it position by position with the same shapes, so
every position's result is bit-identical to sequential decode, also
where a window is narrower than the chunk (the ring's overwrite order is
decode's). Scores and the probability-weighted sum run in f32 on
bf16-rounded operands, as the reference does.
"""
from __future__ import annotations

import torch

from .kvquant import kv_cache_spec, kv_decode, kv_encode, kv_page_write
from .layers import apply_rope, rms_norm, softcap
from .quant import init_linear, quantized_matmul

NEG_INF = -2.0e38

__all__ = [
    "init_attention", "attention_decode", "attention_prefill", "init_cache",
]


def init_attention(gen: torch.Generator, cfg, device="cuda") -> dict:
    """Projections, plus the bf16 QKV biases (zeros) under ``qkv_bias``
    and the f32 per-head-dim q/k norm weights (ones) under ``qk_norm``."""
    d, hd, nh, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": init_linear(gen, d, nh * hd, device),
        "wk": init_linear(gen, d, nkv * hd, device),
        "wv": init_linear(gen, d, nkv * hd, device),
        "wo": init_linear(gen, nh * hd, d, device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", nh * hd), ("bk", nkv * hd), ("bv", nkv * hd)):
            p[name] = torch.zeros(n, dtype=torch.bfloat16, device=device)
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = torch.ones(hd, dtype=torch.float32, device=device)
    return p


def _project_qkv(p, x, cfg, positions, quant):
    b, s, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = quantized_matmul(x, p["wq"], quant)
    k = quantized_matmul(x, p["wk"], quant)
    v = quantized_matmul(x, p["wv"], quant)
    if cfg.qkv_bias:                       # bf16 + bf16, one rounding
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, nh, hd)
    k = k.reshape(b, s, nkv, hd)
    v = v.reshape(b, s, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _cache_rows(k: torch.Tensor, v: torch.Tensor, cfg) -> dict:
    """New K and V (B, T, nkv, hd) as the cache stores them: bf16 rows, or
    the packed streams of ``cfg.kv_quant``. The encode works token by token
    (groups along hd), so a chunk's T tokens encode in one call with the
    bytes of T one-token calls."""
    if cfg.kv_quant == "none":
        return {"k": k, "v": v}
    return {"k": kv_encode(k, cfg.kv_quant), "v": kv_encode(v, cfg.kv_quant)}


def _attend_one(q, rows, out_dtype, cfg, cache, index, valid=None,
                window=0):
    """Write one token's K/V per slot and attend ``q`` against the page.

    q (B,1,nh,hd); ``rows`` = ``_cache_rows`` of one token per slot
    (leading (B, 1)); ``index`` (B,) absolute positions; ``valid`` (B,)
    bool or None -- rows where it is False leave their cache untouched and
    return garbage context for the caller to discard. The page's width is
    the layer's window (module docstring), so the window mask (a key at
    most ``window - 1`` positions back; 0 = global) removes nothing from a
    valid row; it shapes only the garbage of a row past its chunk length,
    as in the reference (a mixture-of-experts layer routes those rows with
    the valid ones). The scores are scaled by ``hd**-0.5``, then
    soft-capped by ``cfg.attn_softcap``. Updates ``cache`` in place;
    returns ctx (B,1,nh*hd)."""
    b = q.shape[0]
    fmt = cfg.kv_quant
    w = cache["pos"].shape[1]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    slot = torch.remainder(index, w)
    kv_page_write(cache, {"pos": index[:, None]}, slot, valid)
    if fmt != "none":
        for name in ("k", "v"):
            kv_page_write(cache[name], rows[name], slot, valid)
        k, v = kv_decode(cache["k"], fmt), kv_decode(cache["v"], fmt)
    else:
        kv_page_write(cache, rows, slot, valid)
        k, v = cache["k"], cache["v"]
    pos = cache["pos"]

    g = nh // nkv
    qh = q.reshape(b, nkv, g, hd).to(torch.bfloat16).to(torch.float32)
    sc = torch.einsum("bkgd,bwkd->bkgw", qh,
                      k.to(torch.float32)) * (hd ** -0.5)
    sc = softcap(sc, cfg.attn_softcap)
    idx = index[:, None]
    valid_kv = (pos >= 0) & (pos <= idx)                         # (B, W)
    if window:
        valid_kv = valid_kv & (idx - pos < window)
    sc = torch.where(valid_kv[:, None, None, :], sc, NEG_INF)
    probs = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgw,bwkd->bkgd",
                       probs.to(torch.bfloat16).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, 1, nh * hd).to(out_dtype)


def attention_decode(p: dict, x: torch.Tensor, cfg, cache: dict,
                     index: torch.Tensor, quant: str = "none",
                     window: int = 0):
    """One-token decode for every slot: x (B,1,d), ``index`` (B,) absolute
    positions, ``window`` the layer's (0 = global). Updates ``cache`` in
    place; returns out (B,1,d)."""
    q, k_new, v_new = _project_qkv(p, x, cfg, index[:, None], quant)
    ctx = _attend_one(q, _cache_rows(k_new, v_new, cfg), x.dtype, cfg, cache,
                      index, window=window)
    return quantized_matmul(ctx, p["wo"], quant)


def attention_prefill(p: dict, x: torch.Tensor, cfg, cache: dict,
                      index: torch.Tensor, lengths: torch.Tensor,
                      quant: str = "none", window: int = 0):
    """Chunked prefill: up to T tokens per slot in one call. x (B,T,d); row
    b's valid tokens are ``x[b, :lengths[b]]`` at positions ``index[b]``
    onward (``lengths`` may be 0 for idle rows). The QKV and output
    projections and the K/V encode run once over the chunk; the cache write
    and attend run position by position through ``_attend_one``. Returns
    out (B,T,d)."""
    t = x.shape[1]
    offs = torch.arange(t, dtype=index.dtype, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, index[:, None] + offs, quant)
    rows = _cache_rows(k_new, v_new, cfg)

    def at(node, i):
        if isinstance(node, dict):
            return {key: at(val, i) for key, val in node.items()}
        return node[:, i:i + 1]
    ctxs = [_attend_one(q[:, i:i + 1], at(rows, i), x.dtype, cfg, cache,
                        index + i, valid=i < lengths, window=window)
            for i in range(t)]
    return quantized_matmul(torch.cat(ctxs, dim=1), p["wo"], quant)


def init_cache(cfg, batch: int, max_len: int, window: int = 0,
               device="cuda") -> dict:
    """Empty per-slot cache for ``batch`` slots, a ring of
    ``min(window, max_len)`` positions (``max_len`` when ``window`` is 0,
    global): bf16 pages, or zeroed packed pages of ``cfg.kv_quant``."""
    w = min(window, max_len) if window else max_len
    shape = (batch, w, cfg.n_kv_heads, cfg.hd)

    def page():
        if cfg.kv_quant != "none":
            return kv_cache_spec(*shape, cfg.kv_quant, device)
        return torch.zeros(shape, dtype=torch.bfloat16, device=device)
    return {
        "k": page(),
        "v": page(),
        "pos": torch.full((batch, w), -1, dtype=torch.int32,
                          device=device),
    }
