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

Tensor parallelism (``repro_torch.distributed.tp``, under ``use_sharding``
with placed parameters): the activations carry the reference's
``constrain`` annotations at its sites. q, k and v come out of their
column-parallel projections sharded over heads (when the head count
divides over "model"; else replicated, where the reference pads), the
attention runs on this rank's heads, and the context meets ``wo``'s row
shard. The decode caches are sequence-sharded over "model" (``kv_seq``):
a step writes the new token's K/V, gathered whole (B x nkv x hd), into the
rank that holds its ring slot, and for the scores moves the page to a
head sharding (an all-to-all; all-gather and slice on gloo), which lives
for that step only: every cache leaf keeps its placement. Where W does not
divide over "model" the caches are head-sharded (``kv_heads``) and each
rank writes its heads of the row, or replicated where neither divides.
"""
from __future__ import annotations

import torch

from repro_torch.core import envflags
from repro_torch.distributed import tp
from repro_torch.distributed.sharding import constrain
# the reference's name of the validated int read (its test_env_int_validation
# imports it from here)
from repro_torch.core.envflags import env_int as _env_int  # noqa: F401
from .kvquant import kv_cache_spec, kv_decode, kv_encode, kv_page_write
from .layers import apply_rope, rms_norm, softcap
from .numerics import einsum_f32acc
from .quant import init_linear, quantized_matmul

NEG_INF = -2.0e38
# the chunking fixes the summation order: read at import, as the reference
# reads them (defaults 512 and 1024)
KV_CHUNK = envflags.get_int("REPRO_ATTN_KV_CHUNK")
Q_TILE = envflags.get_int("REPRO_ATTN_Q_TILE")
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
        q, k, v = (_add(q, p["bq"]), _add(k, p["bk"]), _add(v, p["bv"]))
    q = _split_heads(q, nh, hd)
    k = _split_heads(k, nkv, hd)
    v = _split_heads(v, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = _constrain_heads(q, ("batch", "seq", "heads", None), nh)
    k = _constrain_heads(k, ("batch", "seq", "kv_heads", None), nkv)
    v = _constrain_heads(v, ("batch", "seq", "kv_heads", None), nkv)
    return q, k, v


def _add(x, bias):
    """x + bias (a bias placed like x's last axis under tensor
    parallelism)."""
    if tp.is_dtensor(x):
        return tp.local_apply(torch.add, x, bias)
    return x + bias


def _split_heads(x, n: int, hd: int):
    """(B, T, n * hd) -> (B, T, n, hd). Under tensor parallelism the
    heads stay sharded when ``n`` divides over "model"; a projection whose
    columns divide but whose heads do not is gathered (its heads are then
    replicated, where the reference pads them)."""
    b, t = x.shape[:2]
    if not tp.is_dtensor(x):
        return x.reshape(b, t, n, hd)
    if x.placements[0].is_shard() and n % tp.tp_size():
        x = tp.to_placement(x, tp.replicate())
    return tp.local_apply(lambda a: a.reshape(b, t, -1, hd), x)


def _constrain_heads(x, axes, n: int):
    """The reference's head constraint (its sites at _project_qkv): a
    no-op unless placed, and kept where the heads divide over "model"
    (an uneven head shard is not taken: the heads stay replicated)."""
    if tp.is_dtensor(x) and n % tp.tp_size() == 0:
        return constrain(x, axes)
    return x


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
        sc = constrain(sc, ("batch", "heads", None, None))
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
    b, s = x.shape[:2]
    if tp.is_dtensor(q):
        out = _local_heads(
            lambda ql, kl, vl: _chunked_attention(
                ql, *_select_kv(ql, kl, vl, cfg), positions, positions,
                cfg, window or GLOBAL_WINDOW).reshape(b, s, -1).to(x.dtype),
            q, k, v)
    else:
        out = _chunked_attention(q, k, v, positions, positions, cfg,
                                 window or GLOBAL_WINDOW)
        out = out.reshape(b, s, -1).to(x.dtype)
    out = constrain(out, ("batch", "seq", "q_dim"))
    return quantized_matmul(out, p["wo"], quant, cfg.quant_format), (k, v)


def _local_heads(fn, q, k, v):
    """``fn(q_local, k_local, v_local)`` on this rank's query heads (heads
    on axis 2; k and v tensors or dicts of packed streams). Replicated q
    runs all heads against replicated K and V; sharded q meets K and V
    sharded like it or replicated (``_select_kv`` picks its KV heads). The
    output keeps q's placement."""
    if q.placements[0].is_replicate():
        k, v = (_tree_map(lambda t: tp.to_placement(t, tp.replicate()), a)
                for a in (k, v))
    return tp.local_apply(fn, q, k, v)


def _select_kv(q, k, v, cfg):
    """The local K and V heads of local query heads q (B, T, n, hd): K and
    V sharded like q hold exactly the KV heads of the rank's query heads
    (contiguous shards, ``n_heads / n_kv_heads`` query heads to a KV
    head); replicated K and V beside sharded q are repeated to one per
    query head and cut to the rank's."""
    g = cfg.n_heads // cfg.n_kv_heads
    n = q.shape[2]
    if k.shape[2] * g == n:
        return k, v
    lo = tp.tp_rank() * n
    return tuple(_repeat_kv(a, g)[:, :, lo:lo + n] for a in (k, v))


def _tree_map(fn, node):
    if isinstance(node, dict):
        return {k: _tree_map(fn, v) for k, v in node.items()}
    return fn(node)


def _cache_rows(k: torch.Tensor, v: torch.Tensor, cfg) -> dict:
    """New K and V (B, T, nkv, hd) as the cache stores them: bf16 rows, or
    the packed streams of ``cfg.kv_quant``. The encode works token by token
    (groups along hd), so a chunk's T tokens encode in one call with the
    bytes of T one-token calls."""
    if cfg.kv_quant == "none":
        return {"k": k, "v": v}
    if tp.is_dtensor(k):
        return {name: tp.local_apply(
            lambda a: kv_encode(a, cfg.kv_quant), t)
            for name, t in (("k", k), ("v", v))}
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
    fmt = cfg.kv_quant
    slot = torch.remainder(index, cache["pos"].shape[1])
    kv_page_write(cache, {"pos": index[:, None]}, slot, valid)
    if fmt != "none":
        for name in ("k", "v"):
            kv_page_write(cache[name], rows[name], slot, valid)
        k, v = kv_decode(cache["k"], fmt), kv_decode(cache["v"], fmt)
    else:
        kv_page_write(cache, rows, slot, valid)
        k, v = cache["k"], cache["v"]
    return _attend_page(q, k, v, cache["pos"], index, cfg, out_dtype,
                        window)


def _attend_page(q, k, v, pos, index, cfg, out_dtype, window=0):
    """q (B, 1, n, hd) against a whole page k, v (B, W, n / g, hd) with
    position track ``pos`` (B, W): the scores ``q.k * hd**-0.5`` in f32 of
    bf16-rounded operands, soft-capped, masked (empty, future and -- for
    ``window`` -- too old keys), softmaxed and summed over the values.
    Returns ctx (B, 1, n * hd) in ``out_dtype``."""
    b, _, n, hd = q.shape
    nkv = k.shape[2]
    g = n // nkv
    qh = q.reshape(b, nkv, g, hd).to(torch.bfloat16).to(torch.float32)
    sc = torch.einsum("bkgd,bwkd->bkgw", qh,
                      k.to(torch.float32)) * (hd ** -0.5)
    sc = softcap(sc, cfg.attn_softcap)
    idx = index[:, None]
    valid_kv = (pos >= 0) & (pos <= idx)                         # (B, W)
    if window:
        valid_kv = valid_kv & (idx - pos < window)
    sc = torch.where(valid_kv[:, None, None, :], sc, NEG_INF)
    sc = constrain(sc, ("batch", "kv_heads", None, "kv_seq"))
    probs = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgw,bwkd->bkgd",
                       probs.to(torch.bfloat16).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, 1, n * hd).to(out_dtype)


def _attend_one_tp(q, rows, out_dtype, cfg, cache, index, valid=None,
                   window=0):
    """``_attend_one`` on a placed cache (module docstring): every cache
    leaf is a DTensor, ``pos`` replicated, K and V sequence-sharded over
    "model" (``kv_seq``) or, where W does not divide, head-sharded
    (``kv_heads``) or replicated where neither divides. The new token's
    rows are gathered whole and each leaf takes its part of them
    (``_write_placed``); the page then moves to q's head sharding for the
    scores of this rank's heads. Returns ctx (B, 1, nh * hd), sharded like
    q's heads."""
    fmt = cfg.kv_quant
    rows = {name: _tree_full(val) for name, val in rows.items()}
    pos = cache["pos"].to_local()                  # replicated: all of it
    slot = torch.remainder(index, pos.shape[1])
    if pos.shape[0] == index.shape[0]:
        kv_page_write({"pos": pos}, {"pos": index[:, None]}, slot, valid)
    else:
        pos = _write_all_slots(pos, cache["k"], index, valid)
    pages = {}
    for name in ("k", "v"):
        leaf = cache[name]
        if fmt == "none":
            _write_placed(leaf, rows[name], slot, valid)
            pages[name] = _page_view(leaf)
        else:
            for key, row in rows[name].items():
                _write_placed(leaf[key], row, slot, valid)
            pages[name] = {key: _page_view(t) for key, t in leaf.items()}
    heads = q.placements[0].is_shard() and \
        cfg.n_kv_heads % tp.tp_size() == 0
    target = tp.shard(2) if heads else tp.replicate()

    def moved(t):
        t = constrain(t, ("batch", "kv_seq", "kv_heads", None))
        return tp.to_placement(t, target)
    pages = {name: (moved(pg) if fmt == "none"
                    else {key: moved(t) for key, t in pg.items()})
             for name, pg in pages.items()}

    def attend(ql, kl, vl):
        if fmt != "none":
            kl, vl = kv_decode(kl, fmt), kv_decode(vl, fmt)
        kl, vl = _select_kv(ql, kl, vl, cfg)
        return _attend_page(ql, kl, vl, pos, index, cfg, out_dtype, window)
    return _local_heads(attend, q, pages["k"], pages["v"])


def _write_all_slots(pos, k_leaf, index, valid):
    """The replicated position track ``pos`` (every slot's) written for
    every slot where the slots are sharded over a batch dim (the dry-run's
    cells; the engine keeps them whole): the index and valid rows are
    gathered along the K leaf's batch dims, so every replica stays equal.
    Returns this rank's rows of ``pos``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    if isinstance(k_leaf, dict):
        k_leaf = next(iter(k_leaf.values()))
    mesh = k_leaf.device_mesh
    rows = [p if p.is_shard() and p.dim == 0 else tp.replicate()
            for p in k_leaf.placements]

    def whole(t):
        return DTensor.from_local(t, mesh, rows, run_check=False) \
            .full_tensor()
    idx = whole(index)
    ok = None if valid is None else whole(valid.to(torch.int32)).bool()
    kv_page_write({"pos": pos}, {"pos": idx[:, None]},
                  torch.remainder(idx, pos.shape[1]), ok)
    _, (lo,) = compute_local_shape_and_global_offset((idx.shape[0],), mesh,
                                                     rows)
    return pos.narrow(0, lo, index.shape[0])


def _write_placed(leaf, row, slot, valid) -> None:
    """Ring write of one token's whole row (B, 1, ...) into placed cache
    leaf (B, W, ...) at ``slot``, in place, by the leaf's placement along
    "model": sharded over W, the rank that holds the slot writes it;
    sharded on another axis (the heads), every rank writes its block of
    the row; replicated, every rank writes the whole row."""
    local = leaf.to_local()
    if local.shape[0] != row.shape[0]:
        raise NotImplementedError(
            "tensor-parallel decode keeps the slots whole: these caches "
            "shard the slot axis over a batch dim larger than 1")
    placement = tp.model_placement(leaf)
    if placement.is_shard() and placement.dim == 1:
        w_local = local.shape[1]
        at = slot - tp.tp_rank() * w_local
        mine = (at >= 0) & (at < w_local)
        if valid is not None:
            mine = mine & valid
        kv_page_write({"t": local}, {"t": row}, at.clamp(0, w_local - 1),
                      mine)
        return
    if placement.is_shard():
        d = placement.dim
        block = -(-row.shape[d] // tp.tp_size())       # torch.chunk's
        start = min(tp.tp_rank() * block, row.shape[d])
        row = row.narrow(d, start, local.shape[d])
    kv_page_write({"t": local}, {"t": row}, slot, valid)


def _page_view(leaf):
    """A cache leaf's local part as a DTensor on the "model" submesh (its
    placement along "model"), for the scores' redistribution."""
    return tp.wrap(leaf.to_local(), tp.model_placement(leaf))


def _tree_full(node):
    if isinstance(node, dict):
        return {k: _tree_full(v) for k, v in node.items()}
    return tp.full(node)


def attention_decode(p: dict, x: torch.Tensor, cfg, cache: dict,
                     index: torch.Tensor, quant: str = "none",
                     window: int = 0):
    """One-token decode for every slot: x (B,1,d), ``index`` (B,) absolute
    positions, ``window`` the layer's (0 = global). Updates ``cache`` in
    place; returns out (B,1,d)."""
    q, k_new, v_new = _project_qkv(p, x, cfg, index[:, None], quant)
    attend = _attend_one_tp if tp.is_dtensor(cache["pos"]) else _attend_one
    ctx = attend(q, _cache_rows(k_new, v_new, cfg), x.dtype, cfg, cache,
                 index, window=window)
    ctx = constrain(ctx, ("batch", "seq", "q_dim"))
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
    attend = _attend_one
    if tp.is_dtensor(cache["pos"]):
        attend, rows = _attend_one_tp, _tree_full(rows)

    def at(node, i):
        if isinstance(node, dict):
            return {key: at(val, i) for key, val in node.items()}
        return node[:, i:i + 1]
    ctxs = [attend(q[:, i:i + 1], at(rows, i), x.dtype, cfg, cache,
                   index + i, valid=i < lengths, window=window)
            for i in range(t)]
    ctx = constrain(torch.cat(ctxs, dim=1), ("batch", "seq", "q_dim"))
    return quantized_matmul(ctx, p["wo"], quant, cfg.quant_format)


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
