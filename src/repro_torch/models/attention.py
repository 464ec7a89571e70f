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

``attention_forward`` is the full-sequence attention of training (and of
the reference's prefill): QKV for every position, then
``_chunked_attention``, the reference's flash-style streaming attention --
q tiles of ``Q_TILE`` positions, each against KV chunks of ``KV_CHUNK``
with a running (max, normaliser, accumulator) -- in the reference's order
of operations, so the chunking fixes the summation order as there. It is
plain PyTorch, differentiable by autograd (the reference's has no custom
gradient either), and uses no cache.
"""
from __future__ import annotations

import torch

from .kvquant import kv_cache_spec, kv_decode, kv_encode, kv_page_write
from .layers import apply_rope, rms_norm, softcap
from .numerics import einsum_f32acc
from .quant import init_linear, quantized_matmul

NEG_INF = -2.0e38
# the reference's defaults (REPRO_ATTN_KV_CHUNK, REPRO_ATTN_Q_TILE): the
# chunking fixes the summation order, so the port keeps them
KV_CHUNK = 512
Q_TILE = 1024
GLOBAL_WINDOW = 2 ** 30     # the masks' window of a global layer

__all__ = [
    "init_attention", "attention_forward", "attention_decode",
    "attention_prefill", "init_cache", "KV_CHUNK", "Q_TILE",
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
    fmt = cfg.quant_format
    q = quantized_matmul(x, p["wq"], quant, fmt)
    k = quantized_matmul(x, p["wk"], quant, fmt)
    v = quantized_matmul(x, p["wv"], quant, fmt)
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


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, T, nkv, hd) -> (B, T, nkv * n_rep, hd), each KV head repeated
    for its ``n_rep`` query heads."""
    if n_rep == 1:
        return x
    b, t, nkv, hd = x.shape
    return x[:, :, :, None, :].expand(b, t, nkv, n_rep, hd).reshape(
        b, t, nkv * n_rep, hd)


def _pad_chunks(kv: list, pos: torch.Tensor, chunk: int):
    """Pad the KV axis (1) of each of ``kv`` and of ``pos`` (B, T) to a
    multiple of ``chunk``: zeros, and position -1 (masked)."""
    pad = (-kv[0].shape[1]) % chunk
    if pad == 0:
        return kv, pos
    kv = [torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad)) for a in kv]
    pos = torch.nn.functional.pad(pos, (0, pad), value=-1)
    return kv, pos


def _chunked_attention(q, k, v, pos_q, pos_k, cfg, window: int,
                       chunk: int = KV_CHUNK, q_tile: int = Q_TILE):
    """Flash-style streaming attention, q-tiled (the reference's): when
    ``S > q_tile`` and ``q_tile`` divides S, each tile of ``q_tile`` query
    positions runs ``_chunked_attention_inner`` on its own, else all S at
    once. q (B, S, nh, hd); k, v (B, T, nkv, hd); pos_q (B, S), pos_k
    (B, T) absolute positions (-1 = an invalid key); ``window`` the
    layer's (GLOBAL_WINDOW for a global layer). Returns (B, S, nh, hd)
    f32."""
    s = q.shape[1]
    if s > q_tile and s % q_tile == 0:
        return torch.cat([
            _chunked_attention_inner(q[:, i:i + q_tile], k, v,
                                     pos_q[:, i:i + q_tile], pos_k, cfg,
                                     window, chunk)
            for i in range(0, s, q_tile)], dim=1)
    return _chunked_attention_inner(q, k, v, pos_q, pos_k, cfg, window,
                                    chunk)


def _chunked_attention_inner(q, k, v, pos_q, pos_k, cfg, window: int,
                             chunk: int = KV_CHUNK):
    """Every query of q against the keys in chunks of ``min(chunk, T)``
    (the last padded, its padding masked), carrying the running max
    ``m``, normaliser ``l`` and accumulator: scores ``q.k * hd**-0.5`` of
    bf16 operands in f32, soft-capped by ``cfg.attn_softcap``; a key
    counts when its position is >= 0, at most the query's and less than
    ``window`` back. Returns ``acc / max(l, 1e-30)`` as (B, S, nh, hd)."""
    b, s, nh, hd = q.shape
    n_rep = nh // k.shape[2]
    c = min(chunk, k.shape[1])
    (k, v), pos_k = _pad_chunks([k, v], pos_k, c)
    qf = q.to(torch.bfloat16)
    scale = hd ** -0.5
    m = torch.full((b, nh, s), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, nh, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, nh, s, hd), dtype=torch.float32, device=q.device)
    for j in range(0, k.shape[1], c):
        kch = _repeat_kv(k[:, j:j + c], n_rep)
        vch = _repeat_kv(v[:, j:j + c], n_rep)
        pch = pos_k[:, j:j + c]                                # (B, c)
        sc = einsum_f32acc("bsnd,bcnd->bnsc", qf,
                           kch.to(torch.bfloat16)) * scale
        sc = softcap(sc, cfg.attn_softcap)
        valid = (pch >= 0)[:, None, :] & \
            (pos_q[:, :, None] >= pch[:, None, :]) & \
            (pos_q[:, :, None] - pch[:, None, :] < window)    # (B, S, c)
        validb = valid[:, None, :, :]                          # (B,1,S,c)
        sc = torch.where(validb, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.where(validb, torch.exp(sc - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = einsum_f32acc("bnsc,bcnd->bnsd", p.to(torch.bfloat16),
                           vch.to(torch.bfloat16))
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2)                                 # (B,S,nh,hd)


def attention_forward(p: dict, x: torch.Tensor, cfg,
                      positions: torch.Tensor, quant: str = "none",
                      window: int = 0):
    """Full-sequence attention (training): x (B, S, d), ``positions``
    (B, S), ``window`` the layer's (0 = global). Returns (out (B, S, d),
    (k, v)) with k, v (B, S, nkv, hd) after qk-norm and rope."""
    q, k, v = _project_qkv(p, x, cfg, positions, quant)
    out = _chunked_attention(q, k, v, positions, positions, cfg,
                             window or GLOBAL_WINDOW)
    b, s = x.shape[:2]
    out = out.reshape(b, s, -1).to(x.dtype)
    return quantized_matmul(out, p["wo"], quant, cfg.quant_format), (k, v)


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
    return quantized_matmul(ctx, p["wo"], quant, cfg.quant_format)


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
    return quantized_matmul(torch.cat(ctxs, dim=1), p["wo"], quant,
                            cfg.quant_format)


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
