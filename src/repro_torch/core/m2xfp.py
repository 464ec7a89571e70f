"""M2XFP encoders (port of the parts of repro.core.m2xfp the serve path runs).

  * Activations -- Elem-EM-top1 (Alg. 1, online): a group of 32 shares an
    E8M0 scale, every element rounds to FP4 E2M1, and the top-1 element of
    each subgroup of 8 by FP4 magnitude (lowest index on ties) is refined to
    FP6 E2M3 through the 2-bit bias-clamp encoding
    ``meta = clamp(fp6_code + 1, fp4_code<<2, fp4_code<<2 | 3) & 3``.
  * Weights -- Sg-EM-2bit with adaptive shared scale (Eq. 3-4, offline):
    each subgroup picks a multiplier (1 + k/4), k in 0..3, and each group an
    exponent bias b in {-1, 0, +1}, by hierarchical squared-error search.

Bit-identity with the reference hinges on sums in the same order: the
search errors are summed left to right over the subgroup and then over
the subgroups, as XLA reduces them, so near-ties pick the same k and b.
"""
from __future__ import annotations

import torch

from .dtypes import (
    FP4_E2M1, FP6_E2M3, exp2int, fp4_value_to_code, fp6_code_to_value,
    fp6_value_to_code, round_to_grid, sign,
)
from .packing import group_reshape, group_unreshape
from .scaling import shared_scale_exponent

GROUP, SUBGROUP = 32, 8

__all__ = [
    "elem_em_encode_parts", "elem_em_dequant_with_scale",
    "sg_em_dequant_with_scale", "quantize_act_m2xfp", "quantize_weight_m2xfp",
]


def _subgroup(xg: torch.Tensor, subgroup: int) -> torch.Tensor:
    """(..., ng, group) -> (..., ng, n_sub, subgroup)."""
    g = xg.shape[-1]
    return xg.reshape(*xg.shape[:-1], g // subgroup, subgroup)


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis strictly left to right (XLA's row order)."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def elem_em_encode_parts(xg: torch.Tensor, s: torch.Tensor, subgroup: int):
    """Elem-EM-top1 math. ``xg`` (..., ng, group) f32 originals, ``s``
    (..., ng, 1) positive scales. Returns (q4 values (..., ng, group), top1
    mask (..., ng, group), refined FP6 values per subgroup, meta codes
    (..., ng, n_sub), top FP4 codes (..., ng, n_sub))."""
    xs = xg / s
    q4 = round_to_grid(xs, FP4_E2M1)
    q4s = _subgroup(q4, subgroup)
    xss = _subgroup(xs, subgroup)

    c4 = fp4_value_to_code(q4s.abs())
    c4_top = c4.amax(dim=-1)
    is_max = c4 == c4_top[..., None]
    top1 = is_max & (torch.cumsum(is_max.to(torch.int32), dim=-1) == 1)
    x_orig = torch.where(top1, xss, 0.0).sum(dim=-1)   # one nonzero term

    q6 = round_to_grid(x_orig, FP6_E2M3)
    c6 = fp6_value_to_code(q6.abs())
    rmin = c4_top << 2
    clamped = torch.minimum(torch.maximum(c6 + 1, rmin), rmin | 3)
    meta = clamped & 3

    c6_dec = ((c4_top << 2) | meta).clamp_min(1) - 1
    v6 = fp6_code_to_value(c6_dec) * sign(x_orig)
    return q4, top1.reshape(q4.shape), v6, meta, c4_top


def elem_em_dequant_with_scale(xg: torch.Tensor, s: torch.Tensor,
                               subgroup: int) -> torch.Tensor:
    """Fake-quant Elem-EM-top1 (bias-clamp encoded): dequantized
    (..., ng, group) f32."""
    q4, top1, v6, _, _ = elem_em_encode_parts(xg, s, subgroup)
    v6b = v6[..., None].expand(*v6.shape, subgroup).reshape(q4.shape)
    return torch.where(top1, v6b, q4) * s


def sg_em_dequant_with_scale(xg: torch.Tensor, s: torch.Tensor,
                             subgroup: int, bits: int = 2,
                             adaptive: bool = True,
                             return_codes: bool = False):
    """Fake-quant Sg-EM: subgroup scale (1 + k / 2^bits) * s, with the
    adaptive group exponent bias b in {-1, 0, +1} when ``adaptive`` (else
    b = 0 only: the packed KV cache's fixed-scale encode). Returns
    dequantized (..., ng, group); with ``return_codes`` also
    (k (..., ng, n_sub) int32, b (..., ng) int32)."""
    nk = 2 ** bits
    xsub = _subgroup(xg, subgroup)                     # (..., ng, ns, sg)

    def eval_bias(b):
        best_err = torch.full(xsub.shape[:-1], float("inf"),
                              dtype=torch.float32, device=xg.device)
        best_k = torch.zeros(xsub.shape[:-1], dtype=torch.int32,
                             device=xg.device)
        for k in range(nk):
            skb = ((1.0 + k / nk) * s * (2.0 ** b))[..., None]
            d = round_to_grid(xsub / skb, FP4_E2M1) * skb - xsub
            err = _sum_last(d * d)
            take = err < best_err
            best_err = torch.where(take, err, best_err)
            best_k = torch.where(take, k, best_k)
        return best_err, best_k

    biases = (-1, 0, 1) if adaptive else (0,)
    errs, ks = [], []
    for b in biases:
        e, k = eval_bias(b)
        errs.append(_sum_last(e))                      # (..., ng)
        ks.append(k)
    b_idx = torch.argmin(torch.stack(errs, dim=-1), dim=-1)   # first min
    # the biases are consecutive; no host-to-device copy (which would also
    # wait for the device) in the KV cache's per-token encode
    b_val = (b_idx + biases[0]).to(torch.int32)
    k_all = torch.stack(ks, dim=-1)                    # (..., ng, ns, nb)
    idx = b_idx[..., None, None].expand(*k_all.shape[:-1], 1)
    k_sel = torch.gather(k_all, -1, idx)[..., 0]       # (..., ng, ns)

    s_final = ((1.0 + k_sel.to(torch.float32) / nk) * s
               * exp2int(b_val)[..., None])[..., None]
    dq = (round_to_grid(xsub / s_final, FP4_E2M1) * s_final).reshape(xg.shape)
    if return_codes:
        return dq, k_sel, b_val
    return dq


def quantize_act_m2xfp(x: torch.Tensor) -> torch.Tensor:
    """Activation fake-quant: Elem-EM-top1 over the E8M0 shared scale,
    groups of 32 and subgroups of 8 along the last axis."""
    xg = group_reshape(x.to(torch.float32), GROUP)
    e = shared_scale_exponent(xg.abs().amax(dim=-1, keepdim=True))
    dq = elem_em_dequant_with_scale(xg, exp2int(e), SUBGROUP)
    return group_unreshape(dq).to(x.dtype)


def quantize_weight_m2xfp(w: torch.Tensor) -> torch.Tensor:
    """Weight fake-quant: Sg-EM-2bit + adaptive shared scale over E8M0,
    groups of 32 and subgroups of 8 along the last axis."""
    wg = group_reshape(w.to(torch.float32), GROUP)
    e = shared_scale_exponent(wg.abs().amax(dim=-1, keepdim=True))
    dq = sg_em_dequant_with_scale(wg, exp2int(e), SUBGROUP)
    return group_unreshape(dq).to(w.dtype)
