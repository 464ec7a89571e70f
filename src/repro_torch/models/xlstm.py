"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory with true recurrence, sequential) -- port of
repro.models.xlstm.

mLSTM cell (exponential gating, stabilized):
    m_t = max(logf_t + m_{t-1}, logi_t)
    C_t = e^{logf+m_{t-1}-m_t} C_{t-1} + e^{logi-m_t} v k^T
    n_t = e^{logf+m_{t-1}-m_t} n_{t-1} + e^{logi-m_t} k
    h_t = (C_t q_t) / max(|n_t . q_t|, e^{-m_t})

Training uses the chunkwise-parallel form: intra-chunk attention-like
scores plus the inter-chunk (C, n, m) carry, a loop over chunks where the
reference scans. Decode is the single-step recurrence. A sequence is one
chunk of at most ``MLSTM_CHUNK`` positions or a whole number of chunks (the
reference's domain: it reshapes S into chunks); any other length raises.

sLSTM keeps per-head recurrent weights (block-diagonal R) and runs as a
sequential loop in both directions; its state is O(d).

The projections (``up``, ``w_o``, ``down``, ``w``, ``ff_up``, ``ff_down``)
go through ``quantized_matmul`` -- under ``serve`` the packed dequant-GEMM;
the cell math stays f32 plain PyTorch, as it is XLA in the reference. The
elementwise functions are the reference's formulas (``silu`` is
``x * sigmoid(x)``, ``log_sigmoid`` is ``-softplus(-x)``, softplus
``max(x, 0) + log1p(exp(-|x|))``, gelu the tanh approximation, which is
``jax.nn.gelu``'s default).

Every function takes plain tensors and dicts; caches are dicts of f32
tensors with the slot on axis 0, returned new by the decode steps. Under
tensor parallelism (placed parameters, DTensor activations and cache
leaves, ``repro_torch.distributed.tp``, whose docstring says what moves)
the mLSTM's q/k/v products and cell run on this rank's heads against its
head-sharded C, n and m, the sLSTM whole on every rank; each new state
keeps its leaf's placement.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import tp
from repro_torch.distributed.sharding import local_tree
from .layers import rms_norm
from .quant import init_linear, quantized_matmul

__all__ = [
    "MLSTM_CHUNK", "init_mlstm", "mlstm_forward", "init_mlstm_cache",
    "mlstm_decode", "init_slstm", "slstm_forward", "init_slstm_cache",
    "slstm_decode", "silu", "softplus", "log_sigmoid", "check_chunks",
]

MLSTM_CHUNK = 128
_F32 = torch.float32


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): max(x, 0) +
    log1p(exp(-|x|)); no threshold, unlike ``F.softplus``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


def check_chunks(s: int, chunk: int, what: str) -> int:
    """The chunk length of a chunked scan over ``s`` positions:
    ``min(chunk, s)``; raises ``ValueError`` unless it divides ``s``."""
    length = min(chunk, s)
    if s % length:
        raise ValueError(
            f"{what} takes a sequence of at most {chunk} positions or a "
            f"multiple of {chunk}, as the reference's chunked form does; "
            f"got {s}")
    return length


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg):
    din = 2 * cfg.d_model
    h = cfg.n_heads
    return din, h, din // h


def init_mlstm(gen: torch.Generator, cfg, device="cuda") -> dict:
    d = cfg.d_model
    din, h, p_ = _mlstm_dims(cfg)

    def randn(shape):
        return torch.randn(shape, generator=gen, dtype=_F32, device=device)

    def blk():
        return (randn((h, p_, p_)) * p_ ** -0.5).to(torch.bfloat16)
    return {
        "up": init_linear(gen, d, 2 * din, device),
        "conv_w": randn((4, din)) * 0.5,
        "conv_b": torch.zeros(din, dtype=_F32, device=device),
        "wq": blk(), "wk": blk(), "wv": blk(),
        "w_if": init_linear(gen, din, 2 * h, device, dtype=_F32),
        "b_if": torch.cat([
            torch.zeros(h, dtype=_F32, device=device),
            torch.linspace(3.0, 6.0, h, dtype=_F32, device=device)]),
        "w_o": init_linear(gen, d, din, device),
        "gn": torch.ones(din, dtype=_F32, device=device),
        "down": init_linear(gen, din, d, device),
    }


def _conv4(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv + silu over (B, S, C), kernel (K, C), summed
    as the reference's Python ``sum``: 0, the taps in order, then the
    bias."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x.to(_F32), (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + pad[:, i:i + s] * w[i]
    return silu(out + b)


def _heads(xc, xin, w, heads, h, p_):
    """q, k, v of heads ``heads`` = (first, count) through the per-head
    block-diagonal projections (f32); xc and xin hold those heads'
    channels, ``w``'s ``wq``/``wk``/``wv`` all h heads or those."""
    lo, n = heads

    def blk(name):
        t = w[name]
        t = t[lo:lo + n] if t.shape[0] == h and n < h else t
        tp.record_gemm("heads", xc, t.shape)
        return t.to(_F32)
    q = torch.einsum("...hp,hpq->...hq", xc, blk("wq"))
    k = torch.einsum("...hp,hpq->...hq", xc, blk("wk")) * (p_ ** -0.5)
    v = torch.einsum("...hp,hpq->...hq", xin, blk("wv"))
    return q, k, v


# the mLSTM's parameters that its cell reads whole on every rank (the
# per-head blocks wq/wk/wv are sharded over "heads")
_MLSTM_CELL = ("conv_w", "conv_b", "wq", "wk", "wv", "w_if", "b_if")


def _mlstm_front(up, o, w, cfg, heads, conv):
    """Shared front half from the whole ``up`` output (..., 2 din) and the
    output gate's pre-activation ``o`` (its ``heads`` channels, or all):
    ``conv`` (up's xin -> xc, the conv and silu over every channel), then
    q, k, v, the input and forget gates and the output gate of heads
    ``heads`` = (first, count)."""
    din, h, p_ = _mlstm_dims(cfg)
    lo, n = heads
    lead = up.shape[:-1]
    xin = up[..., :din]
    xc = conv(xin)                                            # f32
    cols = slice(lo * p_, (lo + n) * p_)
    q, k, v = _heads(xc[..., cols].reshape(*lead, n, p_),
                     xin.to(_F32)[..., cols].reshape(*lead, n, p_), w,
                     heads, h, p_)
    gates = xc @ w["w_if"].to(_F32) + w["b_if"]               # (...,2H)
    logi = gates[..., lo:lo + n]
    logf = log_sigmoid(gates[..., h + lo:h + lo + n])
    if o.shape[-1] != n * p_:
        o = o[..., cols]
    return xc, q, k, v, logi, logf, torch.sigmoid(o.to(_F32))


def _gate_input(o, heads, h: int):
    """The output gate's pre-activation for ``_mlstm_front``: gathered
    whole where this rank runs every head (a column shard of ``w_o`` is
    then not its heads' channels)."""
    return tp.gathered(o) if heads[1] == h else o


def _mlstm_cell_chunkwise(q, k, v, logi, logf):
    """Chunkwise-parallel stabilized mLSTM. q/k/v: (B, S, H, P); gates
    (B, S, H). Returns h (B, S, H, P) and the final {"C", "n", "m"}."""
    b, s, h, p_ = q.shape
    n = check_chunks(s, MLSTM_CHUNK, "the mLSTM's chunkwise cell")
    nc = s // n
    qc = q.reshape(b, nc, n, h, p_)
    kc = k.reshape(b, nc, n, h, p_)
    vc = v.reshape(b, nc, n, h, p_)
    li = logi.reshape(b, nc, n, h)
    lf = logf.reshape(b, nc, n, h)
    fcum = torch.cumsum(lf, dim=2)                            # F_t
    g = li - fcum                                             # li_s - F_s
    gmax_run = torch.cummax(g, dim=2).values
    g_end = g.amax(dim=2)                                     # (B,nc,H)
    f_end = fcum[:, :, -1]                                    # (B,nc,H)
    qk = torch.einsum("bclhp,bcmhp->bclmh", qc, kc)           # (B,nc,L,L,H)
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=q.device))

    c_st = q.new_zeros((b, h, p_, p_))
    n_st = q.new_zeros((b, h, p_))
    m_c = q.new_full((b, h), -1e30)
    outs = []
    for c in range(nc):
        gc, gmx, fe, ge = g[:, c], gmax_run[:, c], f_end[:, c], g_end[:, c]
        kcc, vcc, qcc, qkc = kc[:, c], vc[:, c], qc[:, c], qk[:, c]
        mu = torch.maximum(m_c[:, None], gmx)                 # (B,L,H)
        # masked inside the exponent: an inf forward value would make the
        # backward NaN through inf * 0
        expo = gc[:, None, :, :] - mu[:, :, None, :]          # (B,Lt,Ls,H)
        w_st = torch.exp(expo.masked_fill(~mask[None, :, :, None], -1e9))
        num_intra = torch.einsum("blmh,blmh,bmhp->blhp", qkc, w_st, vcc)
        den_intra = torch.einsum("blmh,blmh->blh", qkc, w_st)
        w_in = torch.exp(m_c[:, None] - mu)                   # (B,L,H)
        num_inter = torch.einsum("blhp,bhpq->blhq", qcc, c_st) \
            * w_in[..., None]
        den_inter = torch.einsum("blhp,bhp->blh", qcc, n_st) * w_in
        m_t = fcum[:, c] + mu
        den = torch.maximum((den_intra + den_inter).abs(), torch.exp(-m_t))
        outs.append((num_intra + num_inter) / den[..., None])
        m_next = fe + torch.maximum(m_c, ge)
        cd = torch.exp(m_c + fe - m_next)                     # (B,H)
        wk_end = torch.exp(fe[:, None] + gc - m_next[:, None])  # (B,L,H)
        c_st = c_st * cd[:, :, None, None] + torch.einsum(
            "blh,blhp,blhq->bhpq", wk_end, kcc, vcc)
        n_st = n_st * cd[:, :, None] + torch.einsum(
            "blh,blhp->bhp", wk_end, kcc)
        m_c = m_next
    hseq = torch.stack(outs, dim=1).reshape(b, s, h, p_)
    return hseq, {"C": c_st, "n": n_st, "m": m_c}


def mlstm_forward(p: dict, x: torch.Tensor, cfg, quant: str = "none"):
    """Full-sequence mLSTM block (the caller adds the residual). x: (B, S,
    D) normalized. Returns (out, final cache).

    Placed (a DTensor x, ``repro_torch.distributed.tp``): ``up``'s column
    product is gathered whole along "model" (the xin | z split does not
    fall on a shard boundary), the conv and the gates run on every
    channel, q/k/v and the chunkwise cell on this rank's heads, the
    output is gathered for the group norm over ``din``, and ``down`` is
    row-parallel. The final C, n and m are head-sharded, ``conv`` whole."""
    din, h, p_ = _mlstm_dims(cfg)
    b, s, _ = x.shape
    placed = tp.is_dtensor(x)
    heads = tp.heads_of(h) if placed else (0, h)
    part = tp.shard(2) if heads[1] < h else tp.replicate()
    state_part = tp.shard(1) if heads[1] < h else tp.replicate()
    up = tp.gathered(quantized_matmul(x, p["up"], quant, cfg.quant_format))
    o = _gate_input(quantized_matmul(x, p["w_o"], quant, cfg.quant_format),
                    heads, h)

    def cell(u, og, w):
        _, q, k, v, logi, logf, og = _mlstm_front(
            u, og, w, cfg, heads,
            lambda xin: _conv4(xin, w["conv_w"], w["conv_b"]))
        hseq, state = _mlstm_cell_chunkwise(q, k, v, logi, logf)
        return hseq.reshape(b, s, heads[1] * p_) * og, state
    hseq, state = tp.local_apply(cell, up, o,
                                 {k: p[k] for k in _MLSTM_CELL},
                                 placement=(part, state_part))
    hflat = rms_norm(tp.gathered(hseq), p["gn"], cfg.norm_eps)
    out = quantized_matmul(tp.local_apply(
        lambda a, u: _gate_z(a, u, din, x.dtype), hflat, up), p["down"],
        quant, cfg.quant_format)
    k_ = p["conv_w"].shape[0]
    state["conv"] = tp.local_apply(
        lambda u: u[..., :din].to(_F32)[:, s - (k_ - 1):, :], up)
    return out, state


def _gate_z(hflat, up, din: int, dtype):
    """The normed cell output times silu(z), z = up's second half, each
    cast to ``dtype`` first."""
    return hflat.to(dtype) * silu(up[..., din:].to(_F32)).to(dtype)


def init_mlstm_cache(cfg, batch: int, device="cuda") -> dict:
    din, h, p_ = _mlstm_dims(cfg)
    return {
        "C": torch.zeros((batch, h, p_, p_), dtype=_F32, device=device),
        "n": torch.zeros((batch, h, p_), dtype=_F32, device=device),
        "m": torch.full((batch, h), -1e30, dtype=_F32, device=device),
        "conv": torch.zeros((batch, 3, din), dtype=_F32, device=device),
    }


def mlstm_decode(p: dict, x: torch.Tensor, cfg, cache: dict,
                 quant: str = "none"):
    """Single-token mLSTM step. x: (B, 1, D) normalized. Returns (out, new
    cache). Placed, as ``mlstm_forward``: each rank updates its heads' C,
    n and m and the whole ``conv`` window, each leaf kept at its
    placement."""
    din, h, p_ = _mlstm_dims(cfg)
    placed = tp.is_dtensor(x)
    heads = tp.heads_of(h) if placed else (0, h)
    up = tp.gathered(quantized_matmul(x, p["up"], quant, cfg.quant_format))
    o = _gate_input(quantized_matmul(x, p["w_o"], quant, cfg.quant_format),
                    heads, h)
    hvec, new = _mlstm_step(tp.unwrap(up)[:, 0], tp.unwrap(o)[:, 0],
                            local_tree(cache),
                            {k: tp.model_local(p[k]) for k in _MLSTM_CELL},
                            cfg, heads)
    if placed:
        hvec = tp.wrap(hvec, tp.shard(2) if heads[1] < h
                       else tp.replicate())
    hflat = rms_norm(tp.gathered(hvec), p["gn"], cfg.norm_eps)
    out = tp.local_apply(lambda a, u: _gate_z(a, u, din, x.dtype), hflat,
                         up)
    out = quantized_matmul(out, p["down"], quant, cfg.quant_format)
    return out, {k: tp.like_leaf(cache[k], v) for k, v in new.items()}


def _mlstm_step(up, o, cache: dict, w: dict, cfg, heads: tuple):
    """One recurrent step of heads ``heads`` from the whole ``up`` output
    (B, 2 din), the output gate's pre-activation (B, ...) and the local
    cache (its C, n, m hold those heads): (the gated output of those heads
    (B, 1, count * P) f32, the new local cache)."""
    b = up.shape[0]
    p_ = _mlstm_dims(cfg)[2]
    win = []

    def conv(xin):
        win.append(torch.cat([cache["conv"], xin.to(_F32)[:, None, :]],
                             dim=1))
        return silu(torch.einsum("bkc,kc->bc", win[0], w["conv_w"])
                    + w["conv_b"])
    _, q, k, v, logi, logf, og = _mlstm_front(up, o, w, cfg, heads, conv)
    m_new = torch.maximum(logf + cache["m"], logi)
    wf = torch.exp(logf + cache["m"] - m_new)
    wi = torch.exp(logi - m_new)
    c_new = cache["C"] * wf[..., None, None] + wi[..., None, None] * \
        torch.einsum("bhp,bhq->bhpq", k, v)
    n_new = cache["n"] * wf[..., None] + wi[..., None] * k
    num = torch.einsum("bhp,bhpq->bhq", q, c_new)
    den = torch.maximum(torch.einsum("bhp,bhp->bh", q, n_new).abs(),
                        torch.exp(-m_new))
    hvec = (num / den[..., None]).reshape(b, heads[1] * p_)
    return (hvec * og)[:, None, :], {"C": c_new, "n": n_new, "m": m_new,
                                     "conv": win[0][:, 1:]}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_ff(d: int) -> int:
    """The sLSTM's FFN width: 4/3 d rounded up to a multiple of 64."""
    return int(d * 4 / 3 + 63) // 64 * 64


def init_slstm(gen: torch.Generator, cfg, device="cuda") -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    p_ = d // h
    ff = slstm_ff(d)

    def vec(value, n):
        return torch.full((n,), value, dtype=_F32, device=device)
    return {
        "w": init_linear(gen, d, 4 * d, device),               # z, i, f, o
        "r": torch.randn((4, h, p_, p_), generator=gen, dtype=_F32,
                         device=device) * p_ ** -0.5,
        "b": torch.cat([vec(0.0, 2 * d), vec(3.0, d), vec(0.0, d)]),
        "gn": vec(1.0, d),
        "ff_up": init_linear(gen, d, ff, device),
        "ff_down": init_linear(gen, ff, d, device),
    }


def _slstm_step(p, cfg, carry, wx_t):
    """One sLSTM timestep. carry: (c, n, h, m), each (B, d)."""
    d = cfg.d_model
    nh = cfg.n_heads
    p_ = d // nh
    c, n, hprev, m = carry
    hh = hprev.reshape(-1, nh, p_)
    rec = torch.stack([
        torch.einsum("bhp,hpq->bhq", hh, p["r"][j].to(hh.dtype))
        for j in range(4)
    ], dim=1).reshape(-1, 4 * d)                               # (B, 4d)
    pre = wx_t + rec + p["b"]
    zt = torch.tanh(pre[:, :d])
    logi = pre[:, d:2 * d]
    logf = log_sigmoid(pre[:, 2 * d:3 * d])
    ot = torch.sigmoid(pre[:, 3 * d:])
    m_new = torch.maximum(logf + m, logi)
    wf = torch.exp(logf + m - m_new)
    wi = torch.exp(logi - m_new)
    c_new = wf * c + wi * zt
    n_new = wf * n + wi
    h_new = ot * c_new / torch.clamp_min(n_new, 1.0)
    return (c_new, n_new, h_new, m_new)


def _slstm_ffn(p, h, cfg, quant, dtype):
    """Group norm of the cell output, then the gelu FFN (under tensor
    parallelism ``ff_up`` column- and ``ff_down`` row-parallel)."""
    hseq = rms_norm(h, p["gn"], cfg.norm_eps).to(dtype)
    ff = quantized_matmul(hseq, p["ff_up"], quant, cfg.quant_format)
    ff = tp.local_apply(
        lambda t: F.gelu(t.to(_F32), approximate="tanh").to(dtype), ff)
    return quantized_matmul(ff, p["ff_down"], quant, cfg.quant_format)


def _slstm_scan(wx, w, cfg):
    """The sequential recurrence over wx (B, S, 4d) f32 from the zero
    state: (h of every step (B, S, d), the final state)."""
    b, s, d = wx.shape[0], wx.shape[1], cfg.d_model
    carry = tuple(wx.new_zeros((b, d)) for _ in range(3)) + (
        wx.new_full((b, d), -1e30),)
    hs = []
    for t in range(s):
        carry = _slstm_step(w, cfg, carry, wx[:, t])
        hs.append(carry[2])
    return torch.stack(hs, dim=1), dict(zip("cnhm", carry))


def slstm_forward(p: dict, x: torch.Tensor, cfg, quant: str = "none"):
    """Full-sequence sLSTM block. x: (B, S, D) normalized. Returns (out,
    final cache). Placed, ``w``'s column product is gathered whole along
    "model" (its z | i | f | o split falls on shard boundaries at most for
    t = 4, and each head needs its four gates) and the recurrence runs
    whole on every rank."""
    wx = tp.gathered(quantized_matmul(x, p["w"], quant, cfg.quant_format))
    hs, state = tp.local_apply(
        lambda a, w: _slstm_scan(a.to(_F32), w, cfg), wx,
        {"r": p["r"], "b": p["b"]})
    return _slstm_ffn(p, hs, cfg, quant, x.dtype), state


def init_slstm_cache(cfg, batch: int, device="cuda") -> dict:
    def full(value):
        return torch.full((batch, cfg.d_model), value, dtype=_F32,
                          device=device)
    return {"c": full(0.0), "n": full(0.0), "h": full(0.0),
            "m": full(-1e30)}


def slstm_decode(p: dict, x: torch.Tensor, cfg, cache: dict,
                 quant: str = "none"):
    """Single-token sLSTM step. x: (B, 1, D) normalized. Returns (out, new
    cache). Placed, the step runs whole on every rank: the states sharded
    over "heads" (n and m, by the reference's cache specs) are gathered
    first, and each new state is kept at its leaf's placement."""
    wx = tp.unwrap(tp.gathered(quantized_matmul(
        x, p["w"], quant, cfg.quant_format)))[:, 0].to(_F32)
    state = _slstm_step({k: tp.model_local(p[k]) for k in ("r", "b")}, cfg,
                        tuple(tp.model_whole(cache[k]) for k in "cnhm"),
                        wx)
    h = state[2][:, None, :]
    if tp.is_dtensor(x):
        h = tp.wrap(h, tp.replicate())
    out = _slstm_ffn(p, h, cfg, quant, x.dtype)
    return out, {k: tp.like_leaf(cache[k], v)
                 for k, v in zip("cnhm", state)}
