"""M2XFP encoders (port of repro.core.m2xfp).

  * Activations -- Elem-EM-top1 (Alg. 1, online): a group of 32 shares an
    E8M0 scale, every element rounds to FP4 E2M1, and the top-1 element of
    each subgroup of 8 by FP4 magnitude (lowest index on ties) is refined to
    FP6 E2M3 through the 2-bit bias-clamp encoding
    ``meta = clamp(fp6_code + 1, fp4_code<<2, fp4_code<<2 | 3) & 3``.
  * Weights -- Sg-EM-2bit with adaptive shared scale (Eq. 3-4, offline):
    each subgroup picks a multiplier (1 + k/4), k in 0..3, and each group an
    exponent bias b in {-1, 0, +1}, by hierarchical squared-error search.

Both give 8 bits of metadata per group of 32: 4.5 bits per element. The
``*_with_scale`` cores take any positive per-group scale, so the same
machinery builds M2-NVFP4 (paper Tbl. 6) over NVFP4's scales; the knobs
(subgroup, top-k, the unclamped "ideal" FP6, Sg-EM's bits and the adaptive
bias) are the paper's ablations. ``PackedM2XFP`` is the packed layout of
Sec. 5.2 along the last axis.

Bit-identity with the reference hinges on sums in the same order: the
search errors are summed left to right over the subgroup and then over
the subgroups, as XLA reduces them, so near-ties pick the same k and b.
"""
from __future__ import annotations

import dataclasses

import torch

from .dtypes import (
    FP4_E2M1, FP6_E2M3, exp2int, fp4_value_to_code, fp6_code_to_value,
    fp6_value_to_code, round_to_grid, sign, sign_mag_code, signed_fp4,
)
from .formats import nvfp4_scales
from .packing import (
    group_reshape, group_unreshape, pack_meta2, pack_nibbles, unpack_meta2,
    unpack_nibbles,
)
from .scaling import e8m0_decode, e8m0_encode, shared_scale_exponent

GROUP, SUBGROUP = 32, 8

__all__ = [
    "elem_em_encode_parts", "elem_em_dequant_with_scale",
    "sg_em_dequant_with_scale", "quantize_act_m2xfp", "quantize_weight_m2xfp",
    "quantize_act_m2nvfp4", "quantize_weight_m2nvfp4", "PackedM2XFP",
    "encode_act_m2xfp", "decode_act_m2xfp", "encode_weight_m2xfp",
    "decode_weight_m2xfp",
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
                               subgroup: int, n_top: int = 1,
                               encoding: str = "clamped") -> torch.Tensor:
    """Fake-quant Elem-EM: dequantized (..., ng, group) f32.

    ``n_top``: refined elements per subgroup (the paper evaluates top-1 and
    top-2; M2XFP uses top-1). ``encoding="ideal"`` gives the top-1 its
    unconstrained FP6 value (no bias clamp; not encodable in 2 bits), the
    paper's 'without rounding error' ablation (Tbl. 4); it applies to
    top-1 only."""
    if n_top == 1:
        q4, top1, v6, _, _ = elem_em_encode_parts(xg, s, subgroup)
        if encoding == "ideal":
            return torch.where(top1, round_to_grid(xg / s, FP6_E2M3), q4) * s
        v6b = v6[..., None].expand(*v6.shape, subgroup).reshape(q4.shape)
        return torch.where(top1, v6b, q4) * s
    # top-k (k >= 2): the k largest by FP4 magnitude, lowest index on ties
    xs = xg / s
    q4 = round_to_grid(xs, FP4_E2M1)
    q4s = _subgroup(q4, subgroup)
    xss = _subgroup(xs, subgroup)
    c4 = fp4_value_to_code(q4s.abs())
    order_key = c4 * subgroup + (subgroup - 1 - torch.arange(
        subgroup, dtype=torch.int32, device=xg.device))
    c6 = fp6_value_to_code(round_to_grid(xss, FP6_E2M3).abs())
    rmin = c4 << 2
    c6_dec = torch.minimum(torch.maximum(c6 + 1, rmin), rmin | 3
                           ).clamp_min(1) - 1
    v6 = fp6_code_to_value(c6_dec) * sign(xss)
    thresh = torch.sort(order_key, dim=-1).values[
        ..., subgroup - n_top, None]
    dq = torch.where(order_key >= thresh, v6, q4s).reshape(q4.shape)
    return dq * s


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


def quantize_act_m2xfp(x: torch.Tensor, group: int = GROUP,
                       subgroup: int = SUBGROUP, rule: str = "floor",
                       n_top: int = 1,
                       encoding: str = "clamped") -> torch.Tensor:
    """Activation fake-quant: Elem-EM-top1 over the E8M0 shared scale,
    along the last axis."""
    xg = group_reshape(x.to(torch.float32), group)
    e = shared_scale_exponent(xg.abs().amax(dim=-1, keepdim=True), rule)
    dq = elem_em_dequant_with_scale(xg, exp2int(e), subgroup, n_top,
                                    encoding)
    return group_unreshape(dq).to(x.dtype)


# rows per block of the weight fake-quant on the CPU: the search's dozen
# passes over a block stay in the caches; each group is searched on its
# own, so the values are the same. It keeps chip_smoke.py within its time:
# the train phase's CPU step of one full-width qat layer took 73.0 s
# without the blocks and 20.3 s with them (8 host cores beside an H100)
_CPU_ROWS = 512


def quantize_weight_m2xfp(w: torch.Tensor, group: int = GROUP,
                          subgroup: int = SUBGROUP, rule: str = "floor",
                          adaptive: bool = True,
                          bits: int = 2) -> torch.Tensor:
    """Weight fake-quant: Sg-EM-2bit + adaptive shared scale over E8M0,
    along the last axis."""
    if w.device.type == "cpu" and w.dim() == 2 and w.shape[0] > _CPU_ROWS:
        return torch.cat([
            quantize_weight_m2xfp(w[i:i + _CPU_ROWS], group, subgroup, rule,
                                  adaptive, bits)
            for i in range(0, w.shape[0], _CPU_ROWS)])
    wg = group_reshape(w.to(torch.float32), group)
    e = shared_scale_exponent(wg.abs().amax(dim=-1, keepdim=True), rule)
    dq = sg_em_dequant_with_scale(wg, exp2int(e), subgroup, bits=bits,
                                  adaptive=adaptive)
    return group_unreshape(dq).to(w.dtype)


# ---------------------------------------------------------------------------
# M2-NVFP4 (paper Tbl. 6): the same metadata over NVFP4's scales
# ---------------------------------------------------------------------------

def quantize_act_m2nvfp4(x: torch.Tensor, group: int = 16,
                         subgroup: int = 4) -> torch.Tensor:
    xg, _, _, s = nvfp4_scales(x, group)
    dq = elem_em_dequant_with_scale(xg, s, subgroup)
    return group_unreshape(dq).to(x.dtype)


def quantize_weight_m2nvfp4(w: torch.Tensor, group: int = 16,
                            subgroup: int = 4,
                            adaptive: bool = True) -> torch.Tensor:
    wg, _, _, s = nvfp4_scales(w, group)
    dq = sg_em_dequant_with_scale(wg, s, subgroup, bits=2, adaptive=adaptive)
    return group_unreshape(dq).to(w.dtype)


# ---------------------------------------------------------------------------
# Packed representation along the last axis (the serving layout of Sec. 5.2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedM2XFP:
    """Packed M2XFP tensor: three contiguous streams per group of 32.

    codes: u8 (..., n/2)    -- sign-magnitude FP4 codes, 2 per byte
    scale: u8 (..., n/32)   -- biased E8M0 exponent per group
    meta:  u8 (..., n/32)   -- 4 subgroups x 2 bits per group
    kind:  'act' (Elem-EM) | 'weight' (Sg-EM)
    """

    codes: torch.Tensor
    scale: torch.Tensor
    meta: torch.Tensor
    kind: str
    group: int
    subgroup: int
    orig_shape: tuple

    @property
    def nbytes_per_elem(self) -> float:
        total = self.codes.numel() + self.scale.numel() + self.meta.numel()
        n = 1
        for d in self.orig_shape:
            n *= d
        return total / n


def encode_act_m2xfp(x: torch.Tensor, group: int = GROUP,
                     subgroup: int = SUBGROUP,
                     rule: str = "floor") -> PackedM2XFP:
    """Pack activations to the M2XFP serving layout (Alg. 1 + Sec. 5.2)."""
    lead = x.shape[:-1]
    xg = group_reshape(x.to(torch.float32), group)
    e = shared_scale_exponent(xg.abs().amax(dim=-1, keepdim=True), rule)
    q4, _, _, meta, _ = elem_em_encode_parts(xg, exp2int(e), subgroup)
    codes = sign_mag_code(q4, xg < 0)
    return PackedM2XFP(
        codes=pack_nibbles(codes.reshape(*lead, -1)),
        scale=e8m0_encode(e[..., 0]).reshape(*lead, -1),
        meta=pack_meta2(meta.reshape(*lead, -1)),
        kind="act", group=group, subgroup=subgroup,
        orig_shape=tuple(x.shape))


def decode_act_m2xfp(p: PackedM2XFP) -> torch.Tensor:
    """Dequantize a packed Elem-EM tensor (the Top-1 Decode Unit + PE
    math): the first element of each subgroup holding its largest FP4
    code takes the FP6 value of (code << 2 | meta) - 1."""
    group, subgroup = p.group, p.subgroup
    lead, n = p.orig_shape[:-1], p.orig_shape[-1]
    ng, n_sub = n // group, group // subgroup
    codes = unpack_nibbles(p.codes).reshape(*lead, ng, n_sub, subgroup)
    s = e8m0_decode(p.scale).reshape(*lead, ng, 1)
    meta = unpack_meta2(p.meta.reshape(*lead, -1), ng * n_sub).reshape(
        *lead, ng, n_sub)
    c4 = codes & 7
    c4_top = c4.amax(dim=-1)
    is_max = c4 == c4_top[..., None]
    top1 = is_max & (torch.cumsum(is_max.to(torch.int32), dim=-1) == 1)
    v6 = fp6_code_to_value(((c4_top << 2) | meta).clamp_min(1) - 1)
    vals = torch.where(top1, v6[..., None] * torch.where(
        (codes & 8) != 0, -1.0, 1.0), signed_fp4(codes))
    return group_unreshape(vals.reshape(*lead, ng, group) * s)


def encode_weight_m2xfp(w: torch.Tensor, group: int = GROUP,
                        subgroup: int = SUBGROUP, rule: str = "floor",
                        adaptive: bool = True) -> PackedM2XFP:
    """Pack weights to the Sg-EM serving layout: the scale absorbs the
    adaptive exponent bias b, the metadata holds the 2-bit multiplier
    code k."""
    lead = w.shape[:-1]
    wg = group_reshape(w.to(torch.float32), group)
    e = shared_scale_exponent(wg.abs().amax(dim=-1, keepdim=True), rule)
    _, k_sel, b_val = sg_em_dequant_with_scale(
        wg, exp2int(e), subgroup, bits=2, adaptive=adaptive,
        return_codes=True)
    e_stored = e[..., 0] + b_val
    s_final = ((1.0 + k_sel.to(torch.float32) / 4.0)
               * exp2int(e_stored)[..., None])
    wsub = _subgroup(wg, subgroup)
    q = round_to_grid(wsub / s_final[..., None], FP4_E2M1)
    codes = sign_mag_code(q, wsub < 0)
    return PackedM2XFP(
        codes=pack_nibbles(codes.reshape(*lead, -1)),
        scale=e8m0_encode(e_stored).reshape(*lead, -1),
        meta=pack_meta2(k_sel.reshape(*lead, -1)),
        kind="weight", group=group, subgroup=subgroup,
        orig_shape=tuple(w.shape))


def decode_weight_m2xfp(p: PackedM2XFP) -> torch.Tensor:
    """Dequantize packed Sg-EM weights: fp4 * (1 + k/4) * 2^E."""
    group, subgroup = p.group, p.subgroup
    lead, n = p.orig_shape[:-1], p.orig_shape[-1]
    ng, n_sub = n // group, group // subgroup
    codes = unpack_nibbles(p.codes).reshape(*lead, ng, n_sub, subgroup)
    k = unpack_meta2(p.meta.reshape(*lead, -1), ng * n_sub).reshape(
        *lead, ng, n_sub, 1).to(torch.float32)
    s = e8m0_decode(p.scale).reshape(*lead, ng, 1, 1)
    return (signed_fp4(codes) * (1.0 + k / 4.0) * s).reshape(p.orig_shape)
