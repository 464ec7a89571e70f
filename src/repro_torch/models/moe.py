"""Mixture-of-experts FFN with GShard-style grouped top-k dispatch (port of
repro.models.moe).

Tokens are routed in groups of ``moe_group_size`` (at most the B*S tokens
of the call): each group's dispatch is a product with a (G, E, C) one-hot,
so a token that finds its expert's C = capacity slots taken is dropped.
The router's weight and output are f32; the expert products take the serve
path's quantization modes:

  serve, packed : the weight is a :class:`PackedTensor` of shape (K, E, N)
                  (contraction first, as ``pack_params_for_serving`` lays it
                  out); it is decoded whole and the activations are
                  fake-quantized with its codec, then one batched product
                  per expert (no kernel, as in the reference);
  serve, dense  : an (E, K, N) bf16 weight that was not packed (E not a
                  multiple of 32, the reference's rule), and ``none``: the
                  plain batched product.

Every product accumulates in f32 or wider (``numerics.einsum_f32acc``). The
router's logits and softmax are computed in float64 and rounded to f32 once,
and the renormalising sum is exact, so the routing (top-k experts, slot
positions, drops) and the combine weights have the same bits on the card
as on the CPU; they differ from XLA's f32 ones by its last-ulp roundings.
Dispatch and combine are the reference's one-hot contractions, so a token's
-0.0 enters its expert as +0.0 and a NaN spreads over its group as there.
"""
from __future__ import annotations

import torch

from .numerics import einsum_f32acc
from .quant import PackedTensor, decode_serving_weight, fake_quant_act, \
    init_linear

__all__ = ["init_moe", "moe_apply", "route"]


def init_moe(gen: torch.Generator, cfg, device="cuda") -> dict:
    """Router f32 (d, E); expert weights bf16, contraction axis second:
    gate/up (E, d, d_ff), down (E, d_ff, d)."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def experts(d_in, d_out):
        return init_linear(gen, d_in, (e, d_out), device).permute(
            1, 0, 2).contiguous()
    return {"router": init_linear(gen, d, e, device, torch.float32),
            "gate": experts(d, ff), "up": experts(d, ff),
            "down": experts(ff, d)}


def _capacity(group: int, topk: int, n_experts: int, factor: float) -> int:
    c = int(group * topk / n_experts * factor)
    return max(8, (c + 3) // 4 * 4)


def _expert_matmul(xe: torch.Tensor, w, quant: str) -> torch.Tensor:
    """(ng, E, C, K) x per-expert weights -> (ng, E, C, N) in xe's dtype.
    Under ``serve`` a PackedTensor (K, E, N) is decoded and xe fake-quantized
    with its codec; a dense (E, K, N) weight multiplies as it is."""
    if quant == "serve" and isinstance(w, PackedTensor):
        wd = decode_serving_weight(w)                      # (K, E, N)
        xq = fake_quant_act(xe.to(torch.float32), w.codec).to(wd.dtype)
        return einsum_f32acc("geck,kef->gecf", xq, wd).to(xe.dtype)
    if quant not in ("none", "serve"):
        raise NotImplementedError(f"quant={quant!r} is not ported yet")
    return einsum_f32acc("geck,ekf->gecf", xe, w).to(xe.dtype)


def route(router: torch.Tensor, xt: torch.Tensor, topk: int, cap: int):
    """Routing of (ng, g, d) tokens: returns (probs (ng, g, E) f32, top_i
    (ng, g, k) int64, top_p f32 renormalised, pos (ng, g, k, E) f32 each
    token-slot's position in its expert's queue (slot-major: slot 0 of
    every token first, GShard's priority), keep (ng, g, k, E) f32 one where
    the assignment fits within ``cap``). Ties in the top-k go to the lower
    expert index."""
    logits = torch.matmul(xt.to(torch.float64),
                          router.to(torch.float64)).to(torch.float32)
    lg = logits.to(torch.float64)
    u = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    probs = (u / u.sum(dim=-1, keepdim=True)).to(torch.float32)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    top_i = order[..., :topk]
    top_p = torch.gather(probs, -1, top_i)
    top_p = top_p / top_p.to(torch.float64).sum(
        dim=-1, keepdim=True).to(torch.float32)
    ng, g, e = probs.shape
    onehot = torch.nn.functional.one_hot(top_i, e).to(torch.float32)
    flat = onehot.transpose(1, 2).reshape(ng, topk * g, e)
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).reshape(
        ng, topk, g, e).transpose(1, 2)                    # (ng, g, k, E)
    keep = (pos < cap).to(torch.float32) * onehot
    return probs, top_i, top_p, pos, keep


def moe_apply(p: dict, x: torch.Tensor, cfg,
              quant: str = "none") -> torch.Tensor:
    """x (B, S, d) -> (B, S, d)."""
    b, s, d = x.shape
    e, topk = cfg.n_experts, cfg.experts_per_token
    g = min(cfg.moe_group_size, b * s)
    ng = (b * s) // g
    cap = _capacity(g, topk, e, cfg.moe_capacity_factor)
    xt = x.reshape(ng, g, d)
    _, _, top_p, pos, keep = route(p["router"], xt, topk, cap)
    pos_i = pos.clamp(max=cap - 1).to(torch.int64)

    # dispatch / combine accumulated slot by slot, as the reference does
    dispatch = torch.zeros((ng, g, e, cap), dtype=torch.bfloat16,
                           device=x.device)
    combine = torch.zeros((ng, g, e, cap), dtype=torch.float32,
                          device=x.device)
    for k in range(topk):
        oh = torch.nn.functional.one_hot(pos_i[:, :, k], cap).to(
            torch.float32) * keep[:, :, k, :, None]         # (ng, g, E, C)
        dispatch = dispatch + oh.to(torch.bfloat16)
        combine = combine + oh * top_p[:, :, k, None, None]

    xe = einsum_f32acc("ngec,ngd->necd", dispatch,
                       xt.to(torch.bfloat16)).to(x.dtype)
    h_g = _expert_matmul(xe, p["gate"], quant)
    h_u = _expert_matmul(xe, p["up"], quant)
    h = torch.nn.functional.silu(h_g.to(torch.float32)).to(x.dtype) * h_u
    ye = _expert_matmul(h, p["down"], quant)                # (ng, E, C, d)
    y = einsum_f32acc("ngec,necd->ngd", combine.to(x.dtype), ye).to(x.dtype)
    return y.reshape(b, s, d)
