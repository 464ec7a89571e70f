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

Under tensor parallelism (placed parameters and a DTensor x,
``repro_torch.distributed.tp``, whose docstring says what moves) the scan
and the state update run on this rank's heads against its head-sharded
``ssm`` state; the unsharded path is the same code on every head.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import tp
from repro_torch.distributed.sharding import local_tree
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
    """Full-sequence SSD. x: (B, S, D). Returns (y, final cache).

    Placed (a DTensor x, ``repro_torch.distributed.tp``): ``in_proj``'s
    column product is gathered whole along "model" (its split points do
    not fall on shard boundaries), the conv runs on every channel, the
    scan on this rank's heads (``tp.heads_of``), the gated output is
    gathered for the norm over ``din``, and ``out_proj`` is row-parallel.
    The final ``ssm`` state is head-sharded, the ``conv`` tail whole."""
    bsz, s, d = x.shape
    din, h, hp, n = _dims(cfg)
    check_chunks(s, CHUNK, "mamba2_forward")
    placed = tp.is_dtensor(x)
    heads = tp.heads_of(h) if placed else (0, h)
    split = heads[1] < h
    zxbcdt = tp.gathered(quantized_matmul(x, p["in_proj"], quant,
                                          cfg.quant_format))
    y, carry = tp.local_apply(
        lambda z, w: _ssd(z, w, cfg, heads), zxbcdt,
        {k: p[k] for k in _CELL},
        placement=(tp.shard(2) if split else tp.replicate(),
                   tp.shard(1) if split else tp.replicate()))
    y = rms_norm(tp.gathered(y), p["norm"], cfg.norm_eps)
    out = quantized_matmul(y.to(x.dtype), p["out_proj"], quant,
                           cfg.quant_format)
    conv = tp.local_apply(lambda z: xbc_raw_tail(z, cfg, s), zxbcdt)
    return out, {"ssm": carry, "conv": conv}


# the block's per-channel and per-head parameters (whole on every rank)
_CELL = ("conv_w", "conv_b", "A_log", "D", "dt_bias")


def _ssd(zxbcdt: torch.Tensor, w: dict, cfg, heads: tuple):
    """The chunked scan of heads ``heads`` = (first, count) from the whole
    in_proj output (B, S, 2 din + 2 N + H): (the gated output y * silu(z)
    of those heads (B, S, count * P) f32, their final state)."""
    bsz, s, _ = zxbcdt.shape
    din, h, hp, n = _dims(cfg)
    lo, nh = heads
    length = min(CHUNK, s)
    nc = s // length
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    xbc = _causal_conv(xbc, w["conv_w"], w["conv_b"])
    xs = xbc[..., :din].reshape(bsz, s, h, hp)[:, :, lo:lo + nh]
    bmat = xbc[..., din:din + n]                            # (B,S,N)
    cmat = xbc[..., din + n:]                               # (B,S,N)

    dt = softplus(dt.to(_F32)[..., lo:lo + nh]
                  + w["dt_bias"][lo:lo + nh])               # (B,S,H)
    a = -torch.exp(w["A_log"][lo:lo + nh])                  # (H,)
    loga = dt * a                                           # log decay <= 0

    xs_c = (xs * dt[..., None]).reshape(bsz, nc, length, nh, hp)
    b_c = bmat.reshape(bsz, nc, length, n)
    c_c = cmat.reshape(bsz, nc, length, n)
    lcum = torch.cumsum(loga.reshape(bsz, nc, length, nh), dim=2)

    # intra-chunk (attention-like, causal)
    cb = torch.einsum("bcin,bcjn->bcij", c_c, b_c)          # (B,nc,L,L)
    ldiff = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]  # (B,nc,L,L,H)
    mask = torch.tril(torch.ones((length, length), dtype=torch.bool,
                                 device=zxbcdt.device))
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
    carry = zxbcdt.new_zeros((bsz, nh, hp, n), dtype=_F32)
    h_prev = []
    for c in range(nc):
        h_prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                     # (B,nc,H,P,N)

    y_inter = torch.einsum("bcln,bchpn->bclhp", c_c, h_prev) \
        * torch.exp(lcum)[..., None]                        # decay from start
    y = (y_intra + y_inter).reshape(bsz, s, nh, hp) \
        + xs * w["D"][None, None, lo:lo + nh, None]
    zl = z[..., lo * hp:(lo + nh) * hp]
    return y.reshape(bsz, s, nh * hp) * silu(zl.to(_F32)), carry


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
    """Single-token step. x: (B, 1, D). Returns (y, new cache). Placed, as
    ``mamba2_forward``: each rank updates its heads' ``ssm`` state and the
    whole ``conv`` window, each leaf kept at its placement."""
    din, h, hp, n = _dims(cfg)
    placed = tp.is_dtensor(x)
    heads = tp.heads_of(h) if placed else (0, h)
    zxbcdt = tp.unwrap(tp.gathered(quantized_matmul(x, p["in_proj"], quant,
                                                    cfg.quant_format)))
    y, new = _ssd_step(zxbcdt[:, 0], local_tree(cache),
                       {k: tp.model_local(p[k]) for k in _CELL}, cfg,
                       heads)
    if placed:
        y = tp.wrap(y, tp.shard(2) if heads[1] < h else tp.replicate())
    y = rms_norm(tp.gathered(y), p["norm"], cfg.norm_eps)
    out = quantized_matmul(y.to(x.dtype), p["out_proj"], quant,
                           cfg.quant_format)
    return out, {k: tp.like_leaf(cache[k], v) for k, v in new.items()}


def _ssd_step(zxbcdt: torch.Tensor, cache: dict, w: dict, cfg,
              heads: tuple):
    """One recurrent step of heads ``heads`` from the whole in_proj output
    (B, 2 din + 2 N + H) and the local cache (its ``ssm`` holds those
    heads): (the gated output of those heads (B, 1, count * P) f32, the
    new local cache)."""
    bsz = zxbcdt.shape[0]
    din, h, hp, n = _dims(cfg)
    lo, nh = heads
    z, xbc_new, dt = _split_proj(zxbcdt, cfg)                # (B, ...)

    # conv state: append the new input, convolve the window of K
    win = torch.cat([cache["conv"], xbc_new.to(_F32)[:, None, :]], dim=1)
    xbc = silu(torch.einsum("bkc,kc->bc", win, w["conv_w"]) + w["conv_b"])
    xs = xbc[:, :din].reshape(bsz, h, hp)[:, lo:lo + nh]
    bvec = xbc[:, din:din + n]
    cvec = xbc[:, din + n:]

    dt = softplus(dt.to(_F32)[:, lo:lo + nh]
                  + w["dt_bias"][lo:lo + nh])               # (B,H)
    a = torch.exp(dt * -torch.exp(w["A_log"][lo:lo + nh]))  # (B,H)
    hnew = cache["ssm"] * a[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xs, bvec)
    y = torch.einsum("bn,bhpn->bhp", cvec, hnew) \
        + xs * w["D"][None, lo:lo + nh, None]
    zl = z[:, lo * hp:(lo + nh) * hp]
    y = y.reshape(bsz, 1, nh * hp) * silu(zl.to(_F32))[:, None, :]
    return y, {"ssm": hnew, "conv": win[:, 1:, :]}
