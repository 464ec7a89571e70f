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
tensors with the slot on axis 0, returned new by the decode steps.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def _heads(xc, xin, p, h, p_):
    """q, k, v of the per-head block-diagonal projections (f32)."""
    q = torch.einsum("...hp,hpq->...hq", xc, p["wq"].to(_F32))
    k = torch.einsum("...hp,hpq->...hq", xc, p["wk"].to(_F32)) \
        * (p_ ** -0.5)
    v = torch.einsum("...hp,hpq->...hq", xin, p["wv"].to(_F32))
    return q, k, v


def _mlstm_qkv(p, x_norm, cfg, quant):
    """Shared front half: projections, conv, gates. x_norm: (B, S, D)."""
    din, h, p_ = _mlstm_dims(cfg)
    b, s, _ = x_norm.shape
    up = quantized_matmul(x_norm, p["up"], quant, cfg.quant_format)
    xin, z = up.chunk(2, dim=-1)
    xc = _conv4(xin, p["conv_w"], p["conv_b"])               # (B,S,din) f32
    q, k, v = _heads(xc.reshape(b, s, h, p_),
                     xin.to(_F32).reshape(b, s, h, p_), p, h, p_)
    gates = xc @ p["w_if"].to(_F32) + p["b_if"]               # (B,S,2H)
    logi = gates[..., :h]
    logf = log_sigmoid(gates[..., h:])
    o = torch.sigmoid(
        quantized_matmul(x_norm, p["w_o"], quant, cfg.quant_format).to(_F32))
    return xin, z, q, k, v, logi, logf, o


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
    D) normalized. Returns (out, final cache)."""
    din, h, p_ = _mlstm_dims(cfg)
    b, s, _ = x.shape
    xin, z, q, k, v, logi, logf, o = _mlstm_qkv(p, x, cfg, quant)
    hseq, state = _mlstm_cell_chunkwise(q, k, v, logi, logf)
    hflat = rms_norm(hseq.reshape(b, s, din) * o, p["gn"], cfg.norm_eps)
    out = hflat.to(x.dtype) * silu(z.to(_F32)).to(x.dtype)
    out = quantized_matmul(out, p["down"], quant, cfg.quant_format)
    k_ = p["conv_w"].shape[0]
    state["conv"] = xin.to(_F32)[:, s - (k_ - 1):, :]
    return out, state


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
    cache)."""
    din, h, p_ = _mlstm_dims(cfg)
    b = x.shape[0]
    up = quantized_matmul(x, p["up"], quant, cfg.quant_format)[:, 0]
    xin, z = up.chunk(2, dim=-1)
    win = torch.cat([cache["conv"], xin.to(_F32)[:, None, :]], dim=1)
    xc = silu(torch.einsum("bkc,kc->bc", win, p["conv_w"]) + p["conv_b"])
    q, k, v = _heads(xc.reshape(b, h, p_), xin.to(_F32).reshape(b, h, p_),
                     p, h, p_)
    gates = xc @ p["w_if"].to(_F32) + p["b_if"]
    logi, logf = gates[:, :h], log_sigmoid(gates[:, h:])
    m_new = torch.maximum(logf + cache["m"], logi)
    wf = torch.exp(logf + cache["m"] - m_new)
    wi = torch.exp(logi - m_new)
    c_new = cache["C"] * wf[..., None, None] + wi[..., None, None] * \
        torch.einsum("bhp,bhq->bhpq", k, v)
    n_new = cache["n"] * wf[..., None] + wi[..., None] * k
    num = torch.einsum("bhp,bhpq->bhq", q, c_new)
    den = torch.maximum(torch.einsum("bhp,bhp->bh", q, n_new).abs(),
                        torch.exp(-m_new))
    hvec = (num / den[..., None]).reshape(b, din)
    o = torch.sigmoid(
        quantized_matmul(x, p["w_o"], quant, cfg.quant_format)[:, 0]
        .to(_F32))
    hvec = rms_norm(hvec * o, p["gn"], cfg.norm_eps)
    out = hvec[:, None, :].to(x.dtype) * \
        silu(z.to(_F32))[:, None, :].to(x.dtype)
    out = quantized_matmul(out, p["down"], quant, cfg.quant_format)
    return out, {"C": c_new, "n": n_new, "m": m_new, "conv": win[:, 1:]}


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
    """Group norm of the cell output, then the gelu FFN."""
    hseq = rms_norm(h, p["gn"], cfg.norm_eps).to(dtype)
    ff = quantized_matmul(hseq, p["ff_up"], quant, cfg.quant_format)
    ff = F.gelu(ff.to(_F32), approximate="tanh").to(dtype)
    return quantized_matmul(ff, p["ff_down"], quant, cfg.quant_format)


def slstm_forward(p: dict, x: torch.Tensor, cfg, quant: str = "none"):
    """Full-sequence sLSTM block. x: (B, S, D) normalized. Returns (out,
    final cache)."""
    b, s, d = x.shape
    wx = quantized_matmul(x, p["w"], quant, cfg.quant_format).to(_F32)
    carry = tuple(x.new_zeros((b, d), dtype=_F32) for _ in range(3)) + (
        x.new_full((b, d), -1e30, dtype=_F32),)
    hs = []
    for t in range(s):
        carry = _slstm_step(p, cfg, carry, wx[:, t])
        hs.append(carry[2])
    out = _slstm_ffn(p, torch.stack(hs, dim=1), cfg, quant, x.dtype)
    return out, {"c": carry[0], "n": carry[1], "h": carry[2], "m": carry[3]}


def init_slstm_cache(cfg, batch: int, device="cuda") -> dict:
    def full(value):
        return torch.full((batch, cfg.d_model), value, dtype=_F32,
                          device=device)
    return {"c": full(0.0), "n": full(0.0), "h": full(0.0),
            "m": full(-1e30)}


def slstm_decode(p: dict, x: torch.Tensor, cfg, cache: dict,
                 quant: str = "none"):
    """Single-token sLSTM step. x: (B, 1, D) normalized. Returns (out, new
    cache)."""
    wx = quantized_matmul(x, p["w"], quant, cfg.quant_format)[:, 0] \
        .to(_F32)
    c, n, h, m = _slstm_step(p, cfg, (cache["c"], cache["n"], cache["h"],
                                      cache["m"]), wx)
    out = _slstm_ffn(p, h[:, None, :], cfg, quant, x.dtype)
    return out, {"c": c, "n": n, "h": h, "m": m}
