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
                  plain batched product;
  qat           : each expert's weight fake-quantized along K and the
                  activations along the last axis in ``cfg.quant_format``,
                  each through the straight-through estimator, then the
                  plain batched product.

Every product accumulates in f32 or wider (``numerics.einsum_f32acc``). The
router's logits and softmax are computed in float64 and rounded to f32 once,
and the renormalising sum is exact, so the routing (top-k experts, slot
positions, drops) and the combine weights have the same bits on the card
as on the CPU; they differ from XLA's f32 ones by its last-ulp roundings.
Dispatch and combine are the reference's one-hot contractions, so a token's
-0.0 enters its expert as +0.0 and a NaN spreads over its group as there.

Under autograd the top-k choice, the queue positions and the capacity carry
no gradient (indices and one-hots); the renormalised router probabilities
in the combine do, down to the router's weight.

Tensor parallelism (``repro_torch.distributed.tp``): the routing, dispatch
and combine run on every rank's whole (replicated) tokens, with the
reference's four ``constrain`` sites; each expert product runs on this
rank's shard of its weight by the weight's placement along "model": a
dense (E, K, N) stack's N (column) or K (row: reduced at once), a packed
(K, E, N) stack's N (column) or, for ``down`` under the reference's specs,
its E (expert-parallel: the rank's experts, whose outputs are gathered for
the combine).
"""
from __future__ import annotations

import torch

from repro_torch.core.codecs import get_codec
from repro_torch.distributed import tp
from repro_torch.distributed.sharding import constrain
from .layers import gated
from .numerics import einsum_f32acc
from .quant import PackedTensor, decode_serving_weight, fake_quant_act, \
    fake_quant_ste, fake_quant_weight, init_linear, is_placed, placed_product

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


def _fake_quant_experts(w: torch.Tensor, fmt: str) -> torch.Tensor:
    """Each expert's (K, N) weight of (E, K, N) fake-quantized along K: as
    (K, E, N) its groups run along K for every (expert, column)."""
    return fake_quant_weight(w.permute(1, 0, 2), fmt).permute(1, 0, 2)


def _expert_matmul(xe: torch.Tensor, w, quant: str,
                   fmt: str = "m2xfp") -> torch.Tensor:
    """(ng, E, C, K) x per-expert weights -> (ng, E, C, N) in xe's dtype.
    Under ``serve`` a PackedTensor (K, E, N) is decoded and xe fake-quantized
    with its codec; a dense (E, K, N) weight multiplies as it is, after
    ``qat``'s fake-quant in ``fmt``."""
    if is_placed(w):
        return _expert_matmul_tp(xe, w, quant, fmt)
    if quant == "serve" and isinstance(w, PackedTensor):
        wd = decode_serving_weight(w)                      # (K, E, N)
        xq = fake_quant_act(xe.to(torch.float32), w.codec).to(wd.dtype)
        return einsum_f32acc("geck,kef->gecf", xq, wd).to(xe.dtype)
    if quant == "qat":
        w = fake_quant_ste(w, lambda t: _fake_quant_experts(t, fmt))
        xe = fake_quant_ste(xe, lambda t: fake_quant_act(t, fmt))
    elif quant not in ("none", "serve"):
        raise ValueError(f"unknown quant mode {quant!r}")
    return einsum_f32acc("geck,ekf->gecf", xe, w).to(xe.dtype)


def _expert_matmul_tp(xe, w, quant: str, fmt: str):
    """``_expert_matmul`` of a placed expert stack (module docstring),
    through ``quant.placed_product``."""
    packed = quant == "serve" and isinstance(w, PackedTensor)
    if packed:
        ref = decode_serving_weight(w)                     # (K, E, N)
        dims, eq, codec = (2, 0, 1), "geck,kef->gecf", get_codec(w.codec)

        def quantize_x(t):
            return fake_quant_act(t.to(torch.float32), codec.name).to(
                ref.dtype)
    else:
        ref = w                                            # (E, K, N)
        dims, eq, codec = (2, 1, 0), "geck,ekf->gecf", get_codec(fmt)

        def quantize_x(t):
            return fake_quant_ste(t, lambda u: fake_quant_act(u, fmt))
    return placed_product(
        xe, tp.model_local(ref), tp.model_placement(ref), dims, quant,
        codec, packed, lambda xl, wl: einsum_f32acc(eq, xl, wl), quantize_x,
        lambda t: _fake_quant_experts(t, fmt))


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
    """x (B, S, d) -> (B, S, d), with the reference's four ``constrain``
    sites (no-ops unplaced). A placed x (a replicated DTensor) runs the
    routing, the gate and the combine on every rank's local tensors and
    each expert product on the rank's shard (module docstring)."""
    placed = tp.is_dtensor(x)
    run = tp.local_apply if placed else (lambda fn, *args: fn(*args))
    b, s, d = x.shape
    xe, combine = run(lambda xl, r: _dispatch(r, xl, cfg), x, p["router"])
    xe = constrain(xe, ("batch", "expert", None, "embed"))
    fmt = cfg.quant_format
    h_g = _expert_matmul(xe, p["gate"], quant, fmt)
    h_u = _expert_matmul(xe, p["up"], quant, fmt)
    h = run(gated, h_g, h_u)
    h = constrain(h, ("batch", "expert", None, "expert_mlp"))
    ye = _expert_matmul(h, p["down"], quant, fmt)           # (ng, E, C, d)
    if placed:              # an expert-parallel output: every expert's
        ye = tp.to_placement(ye, tp.replicate())
    y = run(lambda c, o: einsum_f32acc("ngec,necd->ngd", c, o).to(x.dtype),
            combine, ye)
    y = constrain(y, ("batch", None, "embed"))
    return run(lambda t: t.reshape(b, s, d), y)


def _dispatch(router, x, cfg):
    """Routing of x (B, S, d) in groups of ``moe_group_size`` tokens: (xe
    (ng, E, C, d) the tokens in their experts' slots, combine (ng, g, E, C)
    in x's dtype). Dispatch and combine are accumulated slot by slot, as
    the reference does."""
    b, s, d = x.shape
    e, topk = cfg.n_experts, cfg.experts_per_token
    g = min(cfg.moe_group_size, b * s)
    ng = (b * s) // g
    cap = _capacity(g, topk, e, cfg.moe_capacity_factor)
    xt = x.reshape(ng, g, d)
    _, _, top_p, pos, keep = route(router, xt, topk, cap)
    pos_i = pos.clamp(max=cap - 1).to(torch.int64)
    dispatch = torch.zeros((ng, g, e, cap), dtype=torch.bfloat16,
                           device=x.device)
    combine = torch.zeros((ng, g, e, cap), dtype=torch.float32,
                          device=x.device)
    for k in range(topk):
        oh = torch.nn.functional.one_hot(pos_i[:, :, k], cap).to(
            torch.float32) * keep[:, :, k, :, None]
        dispatch = dispatch + oh.to(torch.bfloat16)
        combine = combine + oh * top_p[:, :, k, None, None]
    dispatch = constrain(dispatch, ("batch", None, "expert", None))
    xe = einsum_f32acc("ngec,ngd->necd", dispatch,
                       xt.to(torch.bfloat16)).to(x.dtype)
    return xe, combine.to(x.dtype)
