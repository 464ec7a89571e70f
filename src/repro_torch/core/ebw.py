"""Equivalent bit width (EBW) accounting, paper Eq. 2 (port of
repro.core.ebw).

EBW = B_elem + (B_meta + B_scale) / k

for a group of k elements with B_meta metadata bits and B_scale shared
scale bits in all. It is the x-axis of the DSE Pareto analysis (Figs. 6-7).
"""
from __future__ import annotations

__all__ = ["ebw", "format_ebw"]


def ebw(group: int, elem_bits: float = 4.0, meta_bits: float = 0.0,
        scale_bits: float = 8.0) -> float:
    return elem_bits + (meta_bits + scale_bits) / group


def format_ebw(name: str, **kw) -> float:
    """EBW of the named format. kw: group/subgroup overrides."""
    if name == "mxfp4":
        return ebw(kw.get("group", 32))                        # 4.25
    if name == "nvfp4":
        return ebw(kw.get("group", 16))                        # 4.5
    if name == "smx4":
        # sign(1) + mantissa(2) + pair microexponent (1/2) + 8-bit group scale
        return ebw(kw.get("group", 16), elem_bits=3.5)         # 4.0
    if name == "fp4_fp16scale":
        return ebw(kw.get("group", 32), scale_bits=16.0)       # 4.5
    if name == "m2xfp":
        g = kw.get("group", 32)
        sg = kw.get("subgroup", 8)
        mb = kw.get("meta_bits_per_subgroup", 2.0)
        return ebw(g, meta_bits=mb * (g // sg))                # 4.5
    if name == "m2nvfp4":
        g = kw.get("group", 16)
        sg = kw.get("subgroup", 4)
        return ebw(g, meta_bits=2.0 * (g // sg))               # 5.0
    raise ValueError(f"unknown format {name!r}")
