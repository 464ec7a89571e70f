"""Packed weight layouts of the serve GEMMs (port of repro.kernels.layout).

The wire format is the reference's, byte for byte: the quantization axis
K (the GEMM contraction axis) is the major axis of every stream,

  weights W (K, N): codes u8 (K/2, N), scales u8 (K/32, N), meta u8 (K/32, N)
  activations X^T (K, M): the same three streams with N -> M
  NVFP4 weights W (K, N): codes u8 (K/2, N), E4M3 scale bytes u8 (K/16, N)
    and the f32 per-tensor scale ``tscale`` (1, 1)

and nibbles pair group-half interleaved: within each group of 32 rows along
K, byte row ``g*16 + r`` holds row ``g*32 + r`` (low nibble) and row
``g*32 + 16 + r`` (high nibble). On the card every stream row is N
contiguous bytes, so neighbouring threads of the CUDA kernels read
neighbouring bytes.
"""
from __future__ import annotations

import torch

from repro_torch.core.dtypes import (
    FP4_E2M1, exp2int, round_to_grid, sign_mag_code,
)
from repro_torch.core.formats import mxfp4_components, nvfp4_scales
from repro_torch.core.m2xfp import (
    elem_em_encode_parts, sg_em_dequant_with_scale,
)
from repro_torch.core.packing import group_reshape
from repro_torch.core.scaling import e8m0_encode, shared_scale_exponent

GROUP = 32
SUBGROUP = 8
N_SUB = GROUP // SUBGROUP
GROUP_BYTES = GROUP // 2           # code bytes of one group along K

__all__ = [
    "GROUP", "SUBGROUP", "N_SUB", "GROUP_BYTES", "pack_w_sgem",
    "pack_w_mxfp4", "pack_w_nvfp4", "pack_x_elem_em", "interleave_pack",
    "interleave_unpack", "pad_row_shard",
]


def interleave_pack(codes: torch.Tensor) -> torch.Tensor:
    """Sign-magnitude 4-bit codes (K, n) -> u8 (K/2, n), group-half pairs."""
    k, n = codes.shape
    cg = codes.reshape(k // GROUP, GROUP, n).to(torch.uint8)
    return ((cg[:, :16] & 0xF) | (cg[:, 16:] << 4)).reshape(k // 2, n)


def interleave_unpack(packed: torch.Tensor) -> torch.Tensor:
    """u8 (K/2, n) -> int32 codes (K, n) (inverse of interleave_pack)."""
    k2, n = packed.shape
    pg = packed.reshape(k2 // 16, 16, n)
    lo = (pg & 0xF).to(torch.int32)
    hi = (pg >> 4).to(torch.int32)
    return torch.cat([lo, hi], dim=1).reshape(2 * k2, n)


def pad_row_shard(streams: dict, k: int, rank: int, t: int) -> tuple:
    """(streams, (k0, k1)): rank ``rank``'s padded operand of a packed
    (k, N...) weight's whole ``streams`` whose ``codes`` are cut into t
    equal blocks of byte rows, as a row shard over t ranks cuts them.

    Where a block is not whole groups, its bytes hold a K-set that is not
    a contiguous K-shard (byte row b holds k = 32 (b // 16) + b % 16 and
    that + 16). The operand covers the groups g0 .. g1 - 1 the block
    touches: the block's code bytes at their rows, zero bytes elsewhere
    (code 0 decodes to +0.0 in every codec, so they add exact zeros), and
    those groups' rows of every other row stream (a per-tensor scalar as
    it is). It multiplies x[..., k0:k1], k0 = 32 g0, k1 = 32 g1; the ranks'
    products sum to the whole one."""
    codes = streams["codes"]
    b = codes.shape[0] // t
    lo = rank * b
    g0, g1 = lo // GROUP_BYTES, -(-(lo + b) // GROUP_BYTES)
    off = lo - GROUP_BYTES * g0
    pad = codes.new_zeros((GROUP_BYTES * (g1 - g0), *codes.shape[1:]))
    pad[off:off + b] = codes[lo:lo + b]
    out, groups = {"codes": pad}, k // GROUP
    for name, s in streams.items():
        if name != "codes" and s.shape[1:] == codes.shape[1:]:
            per = s.shape[0] // groups
            s = s[per * g0:per * g1]
        out.setdefault(name, s.contiguous())
    return out, (GROUP * g0, GROUP * g1)


def _pack_meta_fields(fields: torch.Tensor) -> torch.Tensor:
    """2-bit fields (G, 4, n) -> u8 (G, n), subgroup j at bits 2j..2j+1."""
    f = fields.to(torch.int32) & 0x3
    return (f[:, 0] | (f[:, 1] << 2) | (f[:, 2] << 4)
            | (f[:, 3] << 6)).to(torch.uint8)


def pack_w_sgem(w: torch.Tensor, adaptive: bool = True,
                rule: str = "floor") -> dict:
    """Sg-EM-2bit pack of weights (K, N), groups along K (``adaptive``:
    the group exponent-bias search).

    Returns dict(codes u8 (K/2,N), scales u8 (K/32,N), meta u8 (K/32,N)),
    all contiguous."""
    k, n = w.shape
    wg = group_reshape(w.to(torch.float32).T, GROUP)   # (N, K/32, 32)
    e = shared_scale_exponent(wg.abs().amax(dim=-1, keepdim=True), rule)
    _, k_sel, b_val = sg_em_dequant_with_scale(
        wg, exp2int(e), SUBGROUP, adaptive=adaptive, return_codes=True)
    e_stored = e[..., 0] + b_val                       # (N, K/32)
    s_final = ((1.0 + k_sel.to(torch.float32) / 4.0)
               * exp2int(e_stored)[..., None])         # (N, K/32, 4)
    wsub = wg.reshape(n, k // GROUP, N_SUB, SUBGROUP)
    q = round_to_grid(wsub / s_final[..., None], FP4_E2M1)
    codes = sign_mag_code(q, wsub < 0).reshape(n, k).T     # (K, N)
    return {
        "codes": interleave_pack(codes).contiguous(),
        "scales": e8m0_encode(e_stored).T.contiguous(),
        "meta": _pack_meta_fields(k_sel.permute(1, 2, 0)).contiguous(),
    }


def pack_w_mxfp4(w: torch.Tensor, rule: str = "floor") -> dict:
    """Plain MXFP4 pack of weights (K, N): dict(codes u8 (K/2,N), scales
    u8 (K/32,N)), contiguous."""
    k, n = w.shape
    wt = w.to(torch.float32).T
    q, e = mxfp4_components(wt, GROUP, rule)           # (N, K/32, 32)
    codes = sign_mag_code(q, group_reshape(wt, GROUP) < 0).reshape(n, k).T
    return {
        "codes": interleave_pack(codes).contiguous(),
        "scales": e8m0_encode(e[..., 0]).T.contiguous(),
    }


def pack_w_nvfp4(w: torch.Tensor) -> dict:
    """NVFP4 pack of weights (K, N): FP4 codes (group-half interleaved, so
    K % 32 == 0 like every packed operand), one E4M3 scale byte per group
    of 16 along K, and the f32 per-tensor scale.

    Returns dict(codes u8 (K/2,N), scales u8 (K/16,N), tscale f32 (1,1)),
    contiguous. The scales are ``formats.nvfp4_scales``', so decoding gives
    ``quantize_nvfp4`` of the K-groups bit for bit in f32."""
    k, n = w.shape
    xg, s8, t, s = nvfp4_scales(w.to(torch.float32).T, 16)  # (N, K/16, 16)
    q = round_to_grid(xg / s, FP4_E2M1)
    codes = sign_mag_code(q, xg < 0).reshape(n, k).T       # (K, N)
    # s8 lies on the E4M3 grid, so the conversion is exact
    sbytes = s8[..., 0].to(torch.float8_e4m3fn).view(torch.uint8).T
    return {
        "codes": interleave_pack(codes).contiguous(),
        "scales": sbytes.contiguous(),                 # (K/16, N)
        "tscale": t.reshape(1, 1),
    }


def pack_x_elem_em(x: torch.Tensor, rule: str = "floor") -> dict:
    """Elem-EM-top1 pack of activations x (M, K) into the K-major layout.

    Returns dict(codes u8 (K/2,M), scales u8 (K/32,M), meta u8 (K/32,M)),
    all contiguous. Decoding the streams gives ``quantize_act_m2xfp(x)``
    exactly."""
    m, k = x.shape
    xg = group_reshape(x.to(torch.float32), GROUP)     # (M, K/32, 32)
    e = shared_scale_exponent(xg.abs().amax(dim=-1, keepdim=True), rule)
    q4, _, _, meta, _ = elem_em_encode_parts(xg, exp2int(e), SUBGROUP)
    codes = sign_mag_code(q4, xg < 0).reshape(m, k).T      # (K, M)
    return {
        "codes": interleave_pack(codes).contiguous(),
        "scales": e8m0_encode(e[..., 0]).T.contiguous(),
        "meta": _pack_meta_fields(meta.permute(1, 2, 0)).contiguous(),
    }
