"""The recurrent blocks (mLSTM, sLSTM, Mamba2) on the card: the checks
behind chip_smoke.py's ``recurrent`` phase and tests/test_torch_gpu.py.

``forward_vs_decode``: a block's chunked forward against its decode fed
one position at a time, within tests/test_recurrent.py's bounds (the
reference's own: ``MAMBA_BOUNDS`` on the Mamba2 output, SSM state and conv
window, ``XLSTM_BOUND`` on the mLSTM's and sLSTM's outputs).

``decode_card_vs_cpu``: one decode step of a block on the card against the
same step on the CPU (its packed streams and cache copied over). Every
output and state element must lie within ``TOLERANCE``,
2^-7 * (max(|card|, |cpu|) + max|cpu|), the bound chip_smoke.py holds
``moe_apply`` to: the card sums each projection and the state's
contractions in f32 in its own order, the CPU in float64 or another f32
order, so a bf16 rounding of a projection's output, or an FP4 step of the
next fake-quantized activation, can flip. A planted fault must fall
outside it: one slot admitted with its conv window (the sLSTM has none:
its h) left stale, where admission resets it.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.models import mamba2 as mb
from repro_torch.models import xlstm as xl
from repro_torch.models.model import hybrid_segments

__all__ = ["MAMBA_BOUNDS", "XLSTM_BOUND", "TOLERANCE", "BLOCKS",
           "gemm_launches", "forward_vs_decode", "decode_card_vs_cpu"]

MAMBA_BOUNDS = (0.05, 1e-3, 1e-5)       # output, SSM state, conv window
XLSTM_BOUND = 0.08                       # output
TOLERANCE = "2^-7 * (max(|card|, |cpu|) + max|cpu|)"

# kind -> (init, forward, init_cache, decode)
BLOCKS = {
    "mlstm": (xl.init_mlstm, xl.mlstm_forward, xl.init_mlstm_cache,
              xl.mlstm_decode),
    "slstm": (xl.init_slstm, xl.slstm_forward, xl.init_slstm_cache,
              xl.slstm_decode),
    "mamba": (mb.init_mamba2, mb.mamba2_forward, mb.init_mamba2_cache,
              mb.mamba2_decode),
}


def gemm_launches(cfg) -> int:
    """Packed GEMMs (kernel #1's launches) of one decode step of a
    recurrent model under ``serve``: 6 a pair of xLSTM blocks (up, w_o,
    down; w, ff_up, ff_down), or 2 a Mamba2 layer (in_proj, out_proj) and
    7 an application of the shared attention block."""
    if cfg.family == "ssm":
        return 6 * (cfg.n_layers // 2)
    n_seg, seg, trailing = hybrid_segments(cfg)
    return 2 * (n_seg * seg + trailing) + 7 * n_seg


def _ratio(card: torch.Tensor, cpu: torch.Tensor) -> float:
    """The largest ratio of |card - cpu| to TOLERANCE."""
    card, cpu = card.float().cpu(), cpu.float()
    bound = 2.0 ** -7 * (torch.maximum(card.abs(), cpu.abs())
                         + cpu.abs().max())
    return float(((card - cpu).abs() / bound.clamp_min(1e-38)).max())


def forward_vs_decode(cfg, kind: str, gen: torch.Generator, batch: int,
                      seq: int, device="cuda") -> dict:
    """The block ``kind`` with dense bf16 weights drawn from ``gen`` (quant
    none): its forward on a (batch, seq) bf16 input of std 1 against its
    decode fed one position at a time. Returns the errors beside their
    bounds and ``within``."""
    init, fwd, init_cache, dec = BLOCKS[kind]
    cfg = dataclasses.replace(cfg, quant="none")
    t0 = time.perf_counter()
    p = init(gen, cfg, device)
    x = torch.randn(batch, seq, cfg.d_model, generator=gen,
                    device=device).to(torch.bfloat16)
    with torch.no_grad():
        y, state = fwd(p, x, cfg)
        cache = init_cache(cfg, batch, device)
        ys = []
        for t in range(seq):
            yt, cache = dec(p, x[:, t:t + 1], cfg, cache)
            ys.append(yt)
    err = float((y.float() - torch.cat(ys, 1).float()).abs().max())
    out = dict(block=kind, batch=batch, seq=seq, d_model=cfg.d_model,
               max_abs_err_out=err,
               finite=bool(torch.isfinite(y.float()).all()))
    within = out["finite"]
    if kind == "mamba":
        ssm = float((state["ssm"] - cache["ssm"]).abs().max())
        conv = float((state["conv"] - cache["conv"]).abs().max())
        out.update(bound_out=MAMBA_BOUNDS[0], max_abs_err_ssm=ssm,
                   bound_ssm=MAMBA_BOUNDS[1], max_abs_err_conv=conv,
                   bound_conv=MAMBA_BOUNDS[2])
        within = within and err < MAMBA_BOUNDS[0] \
            and ssm < MAMBA_BOUNDS[1] and conv <= MAMBA_BOUNDS[2]
    else:
        out["bound_out"] = XLSTM_BOUND
        within = within and err < XLSTM_BOUND
    out.update(within=within, seconds=time.perf_counter() - t0)
    return out


def decode_card_vs_cpu(cfg, kind: str, p: dict, p_cpu: dict, cache: dict,
                       x: torch.Tensor, fault_slot: int) -> dict:
    """One decode step of a block of ``kind`` -- its parameters ``p`` and a
    cache ``cache`` (one block's dict) on the card, ``x`` its normalized
    (B, 1, d) input -- with slot ``fault_slot`` reset as admission resets
    it, on the card and on the CPU (``p_cpu``: a copy of ``p`` there);
    then, on the card, the planted fault
    (the slot's conv window, the sLSTM's h, left stale). Returns each
    leaf's largest ratio to TOLERANCE (``ratios``: the output and every
    new state leaf), the fault's (``planted_fault_ratio``) and ``within``
    (every ratio at most 1 and the fault's above 1). ``cache`` is not
    changed."""
    decode = BLOCKS[kind][3]
    fresh = {k: v.clone() for k, v in cache.items()}
    for name, leaf in fresh.items():
        leaf[fault_slot] = -1e30 if name == "m" else 0.0
    stale = "h" if kind == "slstm" else "conv"
    faulty = dict(fresh, **{stale: fresh[stale].clone()})
    faulty[stale][fault_slot] = cache[stale][fault_slot]
    planted = not torch.equal(faulty[stale], fresh[stale])
    with torch.no_grad():
        out, new = decode(p, x, cfg, fresh, cfg.quant)
        out_fault, _ = decode(p, x, cfg, faulty, cfg.quant)
        if x.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_cpu, new_cpu = decode(p_cpu, x.cpu(), cfg,
                                  {k: v.cpu() for k, v in fresh.items()},
                                  cfg.quant)
        cpu_s = time.perf_counter() - t0
    ratios = {"out": _ratio(out, out_cpu)}
    ratios.update({k: _ratio(new[k], new_cpu[k]) for k in new})
    fault = _ratio(out_fault, out_cpu)
    return dict(
        block=kind, slots=x.shape[0], tolerance=TOLERANCE,
        max_ratio_to_tolerance=ratios,
        max_abs_diff_out=float((out.float().cpu()
                                - out_cpu.float()).abs().max()),
        bit_equal_share_out=float((out.cpu() == out_cpu).float().mean()),
        planted_fault=f"slot {fault_slot}'s {stale} not reset",
        planted_fault_ratio=fault, cpu_seconds=cpu_s,
        within=planted and max(ratios.values()) <= 1.0 and fault > 1.0)
