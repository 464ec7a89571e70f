"""Plain PyTorch versions of the port's kernels (port of repro.kernels.ref).

The GEMMs decode the packed streams exactly and take the product of the
bf16-rounded (or decoded) activations with the decoded weight; the quantize
engine's plain version is the layout packer; flash attention's runs the
kernel's own online-softmax recurrence block by block, and
``flash_attention_tolerance`` bounds how far another implementation of that
recurrence can lie from it. They are the oracles
of the CUDA kernels: the CPU tests use them, ``chip_smoke.py`` compares the
kernels with them on the card, and the dispatch runs them for tensors that
lie on the CPU.

Accumulation: the product is taken in float64 and rounded to f32. Every
operand is bf16-exact, so each product is exact in float64 and the rounded
sum is row-independent in practice, where an f32 ``torch.matmul`` on the
CPU is not (its blocking depends on M, so a row of a 1-row product can
differ bit-wise from the same row of a 64-row product). Chunked prefill
relies on row independence to stay bit-identical to sequential decode.
"""
from __future__ import annotations

import torch

from repro_torch.core.dtypes import fp4_code_to_value, fp6_code_to_value, \
    signed_fp4
from repro_torch.core.scaling import e8m0_decode
from .layout import GROUP, N_SUB, SUBGROUP, interleave_unpack, pack_x_elem_em

__all__ = [
    "dot_f64acc", "decode_w_sgem_ref", "decode_w_mxfp4_ref",
    "decode_x_elem_em_ref", "m2xfp_matmul_ref", "m2xfp_qmatmul_ref",
    "mxfp4_matmul_ref", "m2xfp_quantize_ref", "flash_attention_ref",
    "flash_attention_tolerance", "FLASH_BLOCK_K", "NEG_INF",
]

FLASH_BLOCK_K = 512      # the reference kernel's default KV block
NEG_INF = -2.0e38        # the reference kernel's mask value


def dot_f64acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) with float64 accumulation, rounded to f32."""
    return torch.matmul(x.to(torch.float64), w.to(torch.float64)).to(
        torch.float32)


def _group_scales(scales: torch.Tensor) -> torch.Tensor:
    """u8 (K/32, N) -> f32 2^(s-127) broadcastable over (K/32, 32, N)."""
    return e8m0_decode(scales)[:, None, :]


def _fields(meta: torch.Tensor) -> torch.Tensor:
    """u8 (K/32, n) -> int32 2-bit subgroup fields (K/32, 4, n)."""
    meta = meta.to(torch.int32)
    return torch.stack([(meta >> (2 * j)) & 0x3 for j in range(N_SUB)], dim=1)


def decode_w_sgem_ref(packed: dict) -> torch.Tensor:
    """Sg-EM packed weight streams -> dense f32 (K, N), exact:
    fp4 * (1 + meta/4) * 2^(scale-127)."""
    codes = interleave_unpack(packed["codes"])
    k, n = codes.shape
    fields = _fields(packed["meta"]).to(torch.float32)     # (K/32, 4, N)
    mult = (1.0 + fields / 4.0).repeat_interleave(SUBGROUP, dim=1)
    w = signed_fp4(codes).reshape(k // GROUP, GROUP, n) * mult \
        * _group_scales(packed["scales"])
    return w.reshape(k, n)


def decode_w_mxfp4_ref(packed: dict) -> torch.Tensor:
    """MXFP4 packed weight streams -> dense f32 (K, N): fp4 * 2^(scale-127)."""
    codes = interleave_unpack(packed["codes"])
    k, n = codes.shape
    w = signed_fp4(codes).reshape(k // GROUP, GROUP, n) \
        * _group_scales(packed["scales"])
    return w.reshape(k, n)


def decode_x_elem_em_ref(packed: dict) -> torch.Tensor:
    """Elem-EM packed activation streams (K-major) -> dense f32 (M, K).

    The Top-1 Decode Unit: the top-1 element of each subgroup of 8 is the
    first one holding the subgroup's largest FP4 magnitude code; it takes
    the FP6 value ``fp6(max((cmax << 2) | meta, 1) - 1)`` with its own
    sign, every other element its FP4 value; all times 2^(scale-127)."""
    codes = interleave_unpack(packed["codes"])             # (K, M)
    k, m = codes.shape
    c4 = (codes & 7).reshape(k // GROUP, N_SUB, SUBGROUP, m)
    cmax = c4.amax(dim=2, keepdim=True)
    is_max = c4 == cmax
    top1 = is_max & (torch.cumsum(is_max.to(torch.int32), dim=2) == 1)
    c6 = ((cmax << 2) | _fields(packed["meta"])[:, :, None, :]).clamp_min(1) - 1
    vals = torch.where(top1, fp6_code_to_value(c6).expand(c4.shape),
                       fp4_code_to_value(c4))
    x = (vals.reshape(k // GROUP, GROUP, m)
         * _group_scales(packed["scales"])).reshape(k, m)
    return torch.where((codes & 8) != 0, -x, x).T           # (M, K)


def _check_k(k: int) -> None:
    if k % GROUP:
        raise ValueError(f"K={k} is not a multiple of the {GROUP}-element "
                         f"quantization group")


def m2xfp_matmul_ref(x: torch.Tensor, w_packed: dict) -> torch.Tensor:
    """bf16(x) (M, K) @ Sg-EM-packed W (K, N) -> f32 (M, N)."""
    _check_k(x.shape[-1])
    return dot_f64acc(x.to(torch.bfloat16), decode_w_sgem_ref(w_packed))


def mxfp4_matmul_ref(x: torch.Tensor, w_packed: dict) -> torch.Tensor:
    """bf16(x) (M, K) @ MXFP4-packed W (K, N) -> f32 (M, N)."""
    _check_k(x.shape[-1])
    return dot_f64acc(x.to(torch.bfloat16), decode_w_mxfp4_ref(w_packed))


def m2xfp_qmatmul_ref(x_packed: dict, w_packed: dict) -> torch.Tensor:
    """Elem-EM-packed X (K-major) @ Sg-EM-packed W (K, N) -> f32 (M, N).
    Both decoded operands are exact in bf16 (at most 4 and 5 significant
    bits), so no rounding precedes the float64 product."""
    k = 2 * x_packed["codes"].shape[0]
    _check_k(k)
    if 2 * w_packed["codes"].shape[0] != k:
        raise ValueError(f"X has K={k}, W has K="
                         f"{2 * w_packed['codes'].shape[0]}")
    return dot_f64acc(decode_x_elem_em_ref(x_packed),
                      decode_w_sgem_ref(w_packed))


def m2xfp_quantize_ref(x_t: torch.Tensor) -> dict:
    """The quantize engine's plain version: K-major activations x_t (K, M)
    -> Elem-EM streams dict(codes, scales, meta), as ``pack_x_elem_em``."""
    _check_k(x_t.shape[0])
    return pack_x_elem_em(x_t.T)


def _flash_blocks(q, k, v, pos_q, pos_k, softcap, window, block_k):
    """The reference kernel's recurrence up to the probabilities, one KV
    block of ``block_k`` keys at a time: yields (qb, kj, vj, s, valid, m_prev,
    m_new, p, corr) in f32, with q/k/v rounded to bf16."""
    bh, sq, hd = q.shape
    f32, bf16 = torch.float32, torch.bfloat16
    qb, kb, vb = (t.to(bf16).to(f32) for t in (q, k, v))
    scale = torch.tensor(hd ** -0.5, dtype=f32)            # as the f32 constant
    cap = None if softcap is None else torch.tensor(softcap, dtype=f32)
    m = torch.full((bh, sq), NEG_INF, dtype=f32, device=q.device)
    pq = pos_q[:, :, None]
    for j0 in range(0, k.shape[1], block_k):
        kj, vj = kb[:, j0:j0 + block_k], vb[:, j0:j0 + block_k]
        pk = pos_k[:, None, j0:j0 + block_k]
        s = torch.matmul(qb, kj.transpose(1, 2)) * scale
        if cap is not None:
            s = cap * torch.tanh(s / cap)
        valid = (pk >= 0) & (pq >= pk) & (pq - pk < window)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        yield qb, kj, vj, s, valid, m, m_new, p, corr
        m = m_new


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pos_q: torch.Tensor, pos_k: torch.Tensor, *,
                        softcap: float | None = None, window: int = 1 << 30,
                        block_k: int = FLASH_BLOCK_K) -> torch.Tensor:
    """Forward attention by the reference kernel's online softmax, over KV
    blocks of ``block_k`` keys (the last one may be shorter). q (BH, Sq, hd),
    k/v (BH, Skv, hd) in any float type (rounded to bf16), positions int32
    (BH, Sq) / (BH, Skv) with ``pos_k = -1`` an invalid key -> f32
    (BH, Sq, hd). A query with no valid key gives 0.

    ``block_k`` fixes where the probabilities are rounded to bf16 (against
    each block's running max), so it moves the result in the last bits."""
    bh, sq, hd = q.shape
    f32, bf16 = torch.float32, torch.bfloat16
    l = torch.zeros((bh, sq), dtype=f32, device=q.device)
    acc = torch.zeros((bh, sq, hd), dtype=f32, device=q.device)
    for _, _, vj, _, _, _, _, p, corr in _flash_blocks(
            q, k, v, pos_q, pos_k, softcap, window, block_k):
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p.to(bf16).to(f32), vj)
    return acc / l.clamp_min(1e-30)[..., None]


def flash_attention_tolerance(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, pos_q: torch.Tensor,
                              pos_k: torch.Tensor, *,
                              softcap: float | None = None,
                              window: int = 1 << 30,
                              block_k: int = FLASH_BLOCK_K) -> torch.Tensor:
    """Elementwise bound (f32, as the output) on |o - flash_attention_ref|
    for any o that runs the same recurrence at the same ``block_k`` with
    other f32 summation orders (the q.k dot, the sum of p, the p.v product)
    and exp/tanh within 2 and 4 ulps (CUDA's ``expf``/``tanhf``).

    With u = 2^-24 and a = scale * |q|.|k| >= |s|, the two scores differ by
    at most e = (2 hd + 16) u a: hd u for each dot order, and 16 u for the
    scale product, the softcap's divide and multiply and tanh on both sides.
    The running maxima then differ by at most E = max e over the keys so far.
    In exact arithmetic a shift of m cancels between acc and l, so outside
    the bf16 rounding each weight p moves by at most rho = e + 2 u |s - m|
    + 8 u relative (the subtraction and exp on both sides). bf16(p) can
    differ only where p (1 +- expm1(rho + E)) rounds to two bf16 values;
    those flips are summed, at their full width, against |v|. The rest is
    the f32 sums: 2 block_k u of the block sums of p and p.v, 8 u per block
    for the corr products, 2 u |m - m_new| per block for corr's argument,
    and 2 u for the division. A row with no valid key gets 0."""
    bh, sq, hd = q.shape
    f32, bf16 = torch.float32, torch.bfloat16
    u = 2.0 ** -24
    scale = torch.tensor(hd ** -0.5, dtype=f32)
    l, l_rho, e_max, dm = (torch.zeros((bh, sq), dtype=f32, device=q.device)
                           for _ in range(4))
    acc, a_acc, f_acc, w_acc = (torch.zeros((bh, sq, hd), dtype=f32,
                                            device=q.device)
                                for _ in range(4))
    n_blocks = 0
    for qb, kj, vj, s, valid, m, m_new, p, corr in _flash_blocks(
            q, k, v, pos_q, pos_k, softcap, window, block_k):
        n_blocks += 1
        a = torch.matmul(qb.abs(), kj.abs().transpose(1, 2)) * scale
        e = torch.where(valid, (2 * hd + 16) * u * a, 0.0)
        e_max = torch.maximum(e_max, e.amax(dim=-1))
        gap = torch.where(valid, (s - m_new[..., None]).abs(), 0.0)
        rho = torch.where(valid, e + 2 * u * gap + 8 * u, 0.0)
        rel = torch.expm1(rho + e_max[..., None])
        flip = ((p * (1 + rel)).to(bf16).to(f32)
                - (p * (1 - rel)).to(bf16).to(f32))
        dm = dm + torch.where(m > NEG_INF, (m - m_new).abs(), 0.0)
        pb, va = p.to(bf16).to(f32), vj.abs()
        c = corr[..., None]
        l = l * corr + p.sum(dim=-1)
        l_rho = l_rho * corr + (p * rho).sum(dim=-1)
        acc = acc * c + torch.matmul(pb, vj)
        a_acc = a_acc * c + torch.matmul(pb, va)
        f_acc = f_acc * c + torch.matmul(flip, va)
        w_acc = w_acc * c + torch.matmul(pb * rho, va)
    den = l.clamp_min(1e-30)[..., None]
    sums = ((2 * block_k + 8 * n_blocks + 2) * u + 2 * u * dm)[..., None]
    return ((f_acc + w_acc + sums * a_acc) / den
            + (acc / den).abs() * (l_rho[..., None] / den + sums))
