"""Mamba2 (SSD) block -- port of repro.models.mamba2: the chunked parallel
scan for training, the O(1)-state recurrent step for decode (zamba2's
backbone).

Fused in_proj -> (z, x, B, C, dt), causal depthwise conv + silu on
(x, B, C), per-head scalar decay a = exp(dt * A), state
h_t = a_t h_{t-1} + dt_t * B_t (x) x_t, output y_t = C_t . h_t + D x_t,
gated RMSNorm, out_proj; ngroups = 1 (B and C shared across heads).

Chunked SSD (chunk ``CHUNK``): intra-chunk an attention-like masked
product (C_t . B_s * exp(l_t - l_s)); the (B, H, P, N) states carried
between chunks by a loop where the reference scans. A sequence is one
chunk of at most ``CHUNK`` positions or a whole number of chunks (the
reference's domain); any other length raises. The recurrence runs in f32
plain PyTorch, as it is XLA in the reference; ``in_proj`` and ``out_proj``
go through ``quantized_matmul`` (under ``serve`` the packed dequant-GEMM).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import rms_norm
from .quant import init_linear, quantized_matmul
from .xlstm import check_chunks, silu, softplus

__all__ = [
    "CHUNK", "init_mamba2", "mamba2_forward", "xbc_raw_tail",
    "init_mamba2_cache", "mamba2_decode",
]

CHUNK = 128
_F32 = torch.float32


def _dims(cfg):
    din = cfg.ssm_expand * cfg.d_model
    nheads = din // cfg.ssm_head_dim
    return din, nheads, cfg.ssm_head_dim, cfg.ssm_state


def init_mamba2(gen: torch.Generator, cfg, device="cuda") -> dict:
    d = cfg.d_model
    din, h, p_, n = _dims(cfg)
    conv_ch = din + 2 * n

    def vec(value, k):
        return torch.full((k,), value, dtype=_F32, device=device)
    return {
        "in_proj": init_linear(gen, d, 2 * din + 2 * n + h, device),
        "conv_w": torch.randn((cfg.ssm_conv, conv_ch), generator=gen,
                              dtype=_F32, device=device)
        * (cfg.ssm_conv ** -0.5),
        "conv_b": vec(0.0, conv_ch),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=_F32,
                                          device=device)),
        "D": vec(1.0, h),
        "dt_bias": vec(0.0, h),
        "norm": vec(1.0, din),
        "out_proj": init_linear(gen, din, d, device),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg):
    din, h, p_, n = _dims(cfg)
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:din + din + 2 * n]
    dt = zxbcdt[..., din + din + 2 * n:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv + silu over (B, S, C) with kernel (K, C),
    summed as the reference's Python ``sum``: 0, the taps in order, then
    the bias."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc.to(_F32), (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + pad[:, i:i + s] * w[i]
    return silu(out + b)


def mamba2_forward(p: dict, x: torch.Tensor, cfg, quant: str = "none"):
    """Full-sequence SSD. x: (B, S, D). Returns (y, final cache)."""
    bsz, s, d = x.shape
    din, h, hp, n = _dims(cfg)
    length = check_chunks(s, CHUNK, "mamba2_forward")
    nc = s // length

    zxbcdt = quantized_matmul(x, p["in_proj"], quant, cfg.quant_format)
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :din].reshape(bsz, s, h, hp)              # (B,S,H,P) f32
    bmat = xbc[..., din:din + n]                            # (B,S,N)
    cmat = xbc[..., din + n:]                               # (B,S,N)

    dt = softplus(dt.to(_F32) + p["dt_bias"])               # (B,S,H)
    a = -torch.exp(p["A_log"])                              # (H,)
    loga = dt * a                                           # log decay <= 0

    xs_c = (xs * dt[..., None]).reshape(bsz, nc, length, h, hp)
    b_c = bmat.reshape(bsz, nc, length, n)
    c_c = cmat.reshape(bsz, nc, length, n)
    lcum = torch.cumsum(loga.reshape(bsz, nc, length, h), dim=2)

    # intra-chunk (attention-like, causal)
    cb = torch.einsum("bcin,bcjn->bcij", c_c, b_c)          # (B,nc,L,L)
    ldiff = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]  # (B,nc,L,L,H)
    mask = torch.tril(torch.ones((length, length), dtype=torch.bool,
                                 device=x.device))
    # masked inside the exponent: exp of a masked (large) entry would be
    # inf and make the backward NaN through inf * 0
    decay = torch.exp(ldiff.masked_fill(~mask[None, None, :, :, None], -1e9))
    scores = cb[..., None] * decay                          # (B,nc,L,L,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xs_c)

    # chunk states, then the carry between chunks
    decay_to_end = torch.exp(lcum[:, :, -1:, :] - lcum)     # (B,nc,L,H)
    states = torch.einsum("bcln,bclh,bclhp->bchpn",
                          b_c, decay_to_end, xs_c)          # (B,nc,H,P,N)
    chunk_decay = torch.exp(lcum[:, :, -1, :])              # (B,nc,H)
    carry = x.new_zeros((bsz, h, hp, n), dtype=_F32)
    h_prev = []
    for c in range(nc):
        h_prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                     # (B,nc,H,P,N)

    y_inter = torch.einsum("bcln,bchpn->bclhp", c_c, h_prev) \
        * torch.exp(lcum)[..., None]                        # decay from start
    y = (y_intra + y_inter).reshape(bsz, s, h, hp) \
        + xs * p["D"][None, None, :, None]
    y = rms_norm(y.reshape(bsz, s, din) * silu(z.to(_F32)), p["norm"],
                 cfg.norm_eps)
    out = quantized_matmul(y.to(x.dtype), p["out_proj"], quant,
                           cfg.quant_format)
    return out, {"ssm": carry, "conv": xbc_raw_tail(zxbcdt, cfg, s)}


def xbc_raw_tail(zxbcdt: torch.Tensor, cfg, s: int) -> torch.Tensor:
    """The last (conv - 1) pre-conv inputs: the decode conv state."""
    din, h, p_, n = _dims(cfg)
    xbc = zxbcdt[..., din:din + din + 2 * n]
    k = cfg.ssm_conv
    return xbc[:, s - (k - 1):, :].to(_F32)


def init_mamba2_cache(cfg, batch: int, device="cuda") -> dict:
    din, h, p_, n = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, h, p_, n), dtype=_F32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, din + 2 * n),
                            dtype=_F32, device=device),
    }


def mamba2_decode(p: dict, x: torch.Tensor, cfg, cache: dict,
                  quant: str = "none"):
    """Single-token step. x: (B, 1, D). Returns (y, new cache)."""
    bsz = x.shape[0]
    din, h, hp, n = _dims(cfg)
    zxbcdt = quantized_matmul(x, p["in_proj"], quant, cfg.quant_format)
    z, xbc_new, dt = _split_proj(zxbcdt[:, 0], cfg)          # (B, ...)

    # conv state: append the new input, convolve the window of K
    win = torch.cat([cache["conv"], xbc_new.to(_F32)[:, None, :]], dim=1)
    xbc = silu(torch.einsum("bkc,kc->bc", win, p["conv_w"]) + p["conv_b"])
    xs = xbc[:, :din].reshape(bsz, h, hp)
    bvec = xbc[:, din:din + n]
    cvec = xbc[:, din + n:]

    dt = softplus(dt.to(_F32) + p["dt_bias"])               # (B,H)
    a = torch.exp(dt * -torch.exp(p["A_log"]))              # (B,H)
    hnew = cache["ssm"] * a[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xs, bvec)
    y = torch.einsum("bn,bhpn->bhp", cvec, hnew) + xs * p["D"][None, :, None]
    y = rms_norm(y.reshape(bsz, 1, din) * silu(z.to(_F32))[:, None, :],
                 p["norm"], cfg.norm_eps)
    out = quantized_matmul(y.to(x.dtype), p["out_proj"], quant,
                           cfg.quant_format)
    return out, {"ssm": hnew, "conv": win[:, 1:, :]}
