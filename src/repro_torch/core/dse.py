"""Encoding design-space exploration (paper Sec. 4.1-4.2, Figs. 5-7; port
of repro.core.dse, bit-identical to it).

Unified subgroup-centric framework: a group of ``k`` elements with shared
scale is divided into contiguous subgroups; metadata is spent either on the
most critical element (Elem-*) or on the subgroup scale (Sg-*), as extra
mantissa (EM, precision) or extra exponent (EE, range), under a *fixed*
shared scale (the rule's exponent from the block max) or an *adaptive* one
(MSE search over exponent bias candidates E-1, E, E+1).

Each strategy yields (dequantized tensor, EBW); a sweep over subgroup
sizes traces the Pareto frontier of MSE vs EBW.

Bit identity with the reference: every search compares error sums taken
left to right over the last axis (``m2xfp._sum_last``, the order XLA
reduces them in), so a tie or near-tie picks the reference's candidate;
the first candidate wins a tie (``<``), and a top-1 pick takes the first
index of the maximum, as ``jnp.argmax``. Divisions are by powers of two.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .dtypes import FP4_E2M1, exp2int, round_to_grid
from .ebw import ebw
from .m2xfp import _sum_last, elem_em_dequant_with_scale, \
    sg_em_dequant_with_scale
from .packing import group_reshape, group_unreshape
from .scaling import shared_scale_exponent

__all__ = ["Strategy", "STRATEGIES", "run_strategy", "mxfp4_reference"]


def _scales(xg: torch.Tensor, rule: str = "floor") -> torch.Tensor:
    amax = xg.abs().amax(dim=-1, keepdim=True)
    return exp2int(shared_scale_exponent(amax, rule))


def _subgroup(xg: torch.Tensor, subgroup: int) -> torch.Tensor:
    g = xg.shape[-1]
    return xg.reshape(*xg.shape[:-1], g // subgroup, subgroup)


# --------------------------------------------------------------------------
# Elem-EE: metadata as an exponent offset on the top-1 element
# --------------------------------------------------------------------------

def _elem_ee_dequant(xg, s, subgroup: int, bits: int = 2) -> torch.Tensor:
    """Top-1 element gets candidates fp4 * 2^d, d in {0..2^bits-1}; the best
    (by |error| vs the original) is kept. Range extension, no extra
    precision -- the paper's analysis (Sec. 4.2) predicts this cannot fix
    block-max clipping error; included for DSE completeness."""
    xs = xg / s
    q4 = round_to_grid(xs, FP4_E2M1)
    q4s = _subgroup(q4, subgroup)
    xss = _subgroup(xs, subgroup)
    top_idx = torch.argmax(q4s.abs(), dim=-1, keepdim=True)   # first max
    x_top = torch.gather(xss, -1, top_idx)[..., 0]
    best = torch.gather(q4s, -1, top_idx)[..., 0]
    best_err = (best - x_top).abs()
    for d in range(1, 2 ** bits):
        cand = round_to_grid(x_top / (2.0 ** d), FP4_E2M1) * (2.0 ** d)
        err = (cand - x_top).abs()
        take = err < best_err
        best = torch.where(take, cand, best)
        best_err = torch.where(take, err, best_err)
    onehot = torch.arange(subgroup, device=xg.device) == top_idx
    dq = torch.where(onehot, best[..., None], q4s).reshape(q4.shape)
    return dq * s


# --------------------------------------------------------------------------
# Sg-EE: metadata as a subgroup exponent offset (SMX-style), fixed/adaptive
# --------------------------------------------------------------------------

def _sg_ee_dequant(xg, s, subgroup: int, bits: int = 1,
                   adaptive: bool = False) -> torch.Tensor:
    """Subgroup scale 2^(E - d), d in {0..2^bits-1}. Fixed mode derives d
    from the subgroup max (largest downshift that avoids clipping);
    adaptive mode MSE-searches d jointly with a group bias in {-1, 0,
    +1}."""
    nd = 2 ** bits
    xsub = _subgroup(xg, subgroup)

    def best_for_scale(base_s):
        best_err = torch.full(xsub.shape[:-1], float("inf"),
                              dtype=torch.float32, device=xg.device)
        best_dq = torch.zeros_like(xsub)
        for d in range(nd):
            sd = base_s[..., None] * (2.0 ** -d)
            dq = round_to_grid(xsub / sd, FP4_E2M1) * sd
            err = _sum_last((dq - xsub) ** 2)
            take = err < best_err
            best_err = torch.where(take, err, best_err)
            best_dq = torch.where(take[..., None], dq, best_dq)
        return best_err, best_dq

    if not adaptive:
        # fixed: pick d from the subgroup max (no search over the global E)
        smax = xsub.abs().amax(dim=-1, keepdim=True)
        fits = [smax * (2.0 ** d) <= FP4_E2M1.max_value * s[..., None]
                for d in range(nd)]
        d_sel = torch.zeros(smax.shape, dtype=torch.float32,
                            device=xg.device)
        for d in range(nd - 1, 0, -1):
            d_sel = torch.where(fits[d], float(d), d_sel)
        sd = s[..., None] * exp2int(-d_sel.to(torch.int32))
        dq = round_to_grid(xsub / sd, FP4_E2M1) * sd
        return dq.reshape(xg.shape)

    best_err = best_dq = None
    for b in (-1, 0, 1):
        err, dq = best_for_scale(s * (2.0 ** b))
        gerr = _sum_last(err)[..., None]
        if best_err is None:
            best_err, best_dq = gerr, dq
        else:
            take = gerr < best_err
            best_err = torch.where(take, gerr, best_err)
            best_dq = torch.where(take[..., None], dq, best_dq)
    return best_dq.reshape(xg.shape)


# --------------------------------------------------------------------------
# Strategy registry
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Strategy:
    """One point family in the metadata design space."""

    name: str
    meta_bits_per_subgroup: float
    fn: Callable  # (xg, s, subgroup) -> dequantized (..., ng, group)

    def ebw(self, group: int, subgroup: int) -> float:
        return ebw(group,
                   meta_bits=self.meta_bits_per_subgroup * (group // subgroup))


def _adaptive_scale_wrap(base_fn, xg, s, subgroup):
    """Adaptive shared scale for element-level strategies: MSE-search the
    group exponent over {E-1, E, E+1} (metadata unchanged)."""
    best_err = best_dq = None
    for b in (-1, 0, 1):
        dq = base_fn(xg, s * (2.0 ** b), subgroup)
        err = _sum_last((dq - xg) ** 2)[..., None]
        if best_err is None:
            best_err, best_dq = err, dq
        else:
            take = err < best_err
            best_err = torch.where(take, err, best_err)
            best_dq = torch.where(take, dq, best_dq)
    return best_dq


STRATEGIES: dict = {
    # --- fixed shared scale (Fig. 6) ---
    "elem_em_top1": Strategy(
        "elem_em_top1", 2.0,
        lambda xg, s, sg: elem_em_dequant_with_scale(xg, s, sg, n_top=1)),
    "elem_em_top2": Strategy(
        "elem_em_top2", 4.0,
        lambda xg, s, sg: elem_em_dequant_with_scale(xg, s, sg, n_top=2)),
    "elem_ee": Strategy(
        "elem_ee", 2.0, lambda xg, s, sg: _elem_ee_dequant(xg, s, sg, bits=2)),
    "sg_em_1bit": Strategy(
        "sg_em_1bit", 1.0,
        lambda xg, s, sg: sg_em_dequant_with_scale(xg, s, sg, bits=1,
                                                   adaptive=False)),
    "sg_em_2bit": Strategy(
        "sg_em_2bit", 2.0,
        lambda xg, s, sg: sg_em_dequant_with_scale(xg, s, sg, bits=2,
                                                   adaptive=False)),
    "sg_ee_1bit": Strategy(
        "sg_ee_1bit", 1.0,
        lambda xg, s, sg: _sg_ee_dequant(xg, s, sg, bits=1, adaptive=False)),
    "sg_ee_2bit": Strategy(
        "sg_ee_2bit", 2.0,
        lambda xg, s, sg: _sg_ee_dequant(xg, s, sg, bits=2, adaptive=False)),
    # --- adaptive shared scale (Fig. 7) ---
    "elem_em_top1_adaptive": Strategy(
        "elem_em_top1_adaptive", 2.0,
        lambda xg, s, sg: _adaptive_scale_wrap(
            lambda a, b, c: elem_em_dequant_with_scale(a, b, c, n_top=1),
            xg, s, sg)),
    "sg_em_2bit_adaptive": Strategy(
        "sg_em_2bit_adaptive", 2.0,
        lambda xg, s, sg: sg_em_dequant_with_scale(xg, s, sg, bits=2,
                                                   adaptive=True)),
    "sg_ee_2bit_adaptive": Strategy(
        "sg_ee_2bit_adaptive", 2.0,
        lambda xg, s, sg: _sg_ee_dequant(xg, s, sg, bits=2, adaptive=True)),
}


def run_strategy(name: str, x: torch.Tensor, group: int = 32,
                 subgroup: int = 8, rule: str = "floor"):
    """Apply a DSE strategy. Returns (dequantized, ebw)."""
    strat = STRATEGIES[name]
    xg = group_reshape(x.to(torch.float32), group)
    s = _scales(xg, rule)
    dq = strat.fn(xg, s, subgroup)
    return group_unreshape(dq).to(x.dtype), strat.ebw(group, subgroup)


def mxfp4_reference(x: torch.Tensor, group: int = 32, rule: str = "floor"):
    """Plain MXFP4 as the zero-metadata reference point (EBW 4.25)."""
    xg = group_reshape(x.to(torch.float32), group)
    s = _scales(xg, rule)
    dq = round_to_grid(xg / s, FP4_E2M1) * s
    return group_unreshape(dq).to(x.dtype), ebw(group)
