"""Bring-up check of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root, on the card

Builds the hand-written CUDA kernels of ``src/repro_torch/csrc`` with nvcc
for sm_90a (into ``build/repro_torch/``), then runs four phases, each
printing JSON lines:

  1. device   -- card, power limit, torch/CUDA versions, kernel build time
  2. kernels  -- each dequant-GEMM at the full-width paper-llama2-7b
                 projection shapes and M in {1, 8, 64, 129}: held against its
                 plain version within the expected size of f32 rounding
                 (see TOLERANCE), shown to reject a planted one-group fault
                 of the packed weight, rows bit-identical across M, timed
                 with the 50 MB L2 flushed between launches, beside its
                 bound, the plain version and a library yardstick
  3. serve    -- continuous-batching serving of full-width, full-depth
                 paper-llama2-7b (random weights from SEED, packed m2xfp)
                 through the port's ServeEngine; every projection must go
                 through the m2xfp kernel; then one all-slots decode step
                 split into host wall time and device time by kernel
  4. serve    -- the same with the mxfp4 codec

It takes no arguments: the traffic is fixed by the constants below.

The last lines are the per-kernel summary, the card's ``nvidia-smi`` name
and power limit, and ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits nonzero and prints no ``ok`` line; it also
exits nonzero without a CUDA device. Timings are this card's at its power
limit, printed beside them.
"""
from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
BF16_FLOPS = 989e12                 # dense bf16 tensor-core peak
PROJ_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096)]   # (K, N)
LAYER_GEMMS = {(4096, 4096): 4, (4096, 11008): 2, (11008, 4096): 1}
MS = [1, 8, 64, 129]
# Serve traffic: 16 requests (twice the slots, so slots are reused), prompt
# lengths drawn by SEED from 16..128, TOKENS new tokens each.
LAYERS, REQUESTS, TOKENS, CHUNK, SEED = 32, 16, 32, 8, 0
N_SLOTS, MAX_LEN = 8, 512
# Kernel vs plain: |diff| <= sqrt(K) * 2^-24 * (|x| @ |Wdec|). Every product
# is exact in f32 and the plain version rounds once, so the kernel's error
# is its K f32 roundings, which add as a random walk: sqrt(K) * 2^-24 of the
# sum of |terms| is their expected size, 1/(2 sqrt(K)) of the worst-case
# 2 K 2^-24. The planted-fault check shows a one-group error exceeds it.
TOLERANCE = "sqrt(K) * 2^-24 * (|x| @ |Wdec|)"
LIBRARY = ("yardstick only, never called by the port: torch.matmul of the "
           "same bf16 x with the decoded bf16 weight, which reads 2 bytes "
           "per weight (3.56x m2xfp's, 3.76x mxfp4's)")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


class Timer:
    """Median CUDA-event time of a call, with L2 flushed before each."""

    def __init__(self, device):
        self.flush_buf = torch.empty(256 << 20, dtype=torch.uint8,
                                     device=device)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(m: int, k: int, n: int, weight_bytes: int):
    """Least time (ms) for x (M,K) bf16 @ packed W -> f32 (M,N): each input
    read once, the output written once, against the bf16 peak."""
    nbytes = m * k * 2 + weight_bytes + m * n * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * m * k * n / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations"), nbytes


def plant_fault(name: str, wp: dict) -> dict:
    """A copy of ``wp`` that decodes differently in its first K group only:
    m2xfp loses subgroup 0's meta multiplier, mxfp4 halves the scale."""
    bad = dict(wp)
    if name == "m2xfp_matmul":
        bad["meta"] = wp["meta"].clone()
        bad["meta"][0] &= 0xFC
    else:
        bad["scales"] = wp["scales"].clone()
        bad["scales"][0] -= 1
    return bad


def kernel_phase(timer, gen, device):
    from repro_torch.kernels import layout, ref
    from repro_torch.kernels.m2xfp_matmul import KERNEL as M2XFP
    from repro_torch.kernels.mxfp4_matmul import KERNEL as MXFP4
    specs = [
        ("m2xfp_matmul", M2XFP, layout.pack_w_sgem, ref.decode_w_sgem_ref,
         ref.m2xfp_matmul_ref,
         "src/repro/kernels/m2xfp_matmul.py:143"),
        ("mxfp4_matmul", MXFP4, layout.pack_w_mxfp4, ref.decode_w_mxfp4_ref,
         ref.mxfp4_matmul_ref,
         "src/repro/kernels/mxfp4_matmul.py:41"),
    ]
    summary = {}
    for name, kern, pack, decode, plain, replaces in specs:
        agg = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
        max_err, bound_by = 0.0, set()
        for k, n in PROJ_SHAPES:
            w = torch.randn(k, n, generator=gen, device=device) * 0.02
            wp = pack(w)
            del w
            wbytes = sum(s.numel() for s in wp.values())
            wdec = decode(wp)
            wdec16 = wdec.to(torch.bfloat16)
            x = torch.randn(MS[-1], k, generator=gen,
                            device=device).to(torch.bfloat16)
            outs = {}
            for m in MS:
                xm = x[:m].contiguous()
                got = kern(xm, wp)
                want = plain(xm, wp)
                torch.cuda.synchronize()
                tol = k ** 0.5 * 2.0 ** -24 * ref.dot_f64acc(xm.abs(),
                                                             wdec.abs())
                diff = (got - want).abs()
                if bool((diff > tol).any()):
                    raise AssertionError(
                        f"{name} K={k} N={n} M={m}: kernel outside "
                        f"{TOLERANCE} of its plain version")
                ratio = float((diff / tol.clamp_min(1e-38)).max())
                err = float(diff.max())
                max_err = max(max_err, err)
                outs[m] = got
                fault = {}
                if m == 8:
                    bad = plant_fault(name, wp)
                    if torch.equal(decode(bad), wdec):
                        raise AssertionError(f"{name} K={k} N={n}: the "
                                             f"planted fault changed nothing")
                    caught = (got - plain(xm, bad)).abs() > tol
                    if not bool(caught.any()):
                        raise AssertionError(
                            f"{name} K={k} N={n}: a one-group fault of the "
                            f"weight passed {TOLERANCE}")
                    fault = dict(planted_fault_flagged_share=float(
                        caught.float().mean()))
                    del bad
                t_k = timer(lambda: kern(xm, wp))
                t_p = timer(lambda: plain(xm, wp), iters=5, warmup=1)
                t_l = timer(lambda: torch.matmul(xm, wdec16))
                b_ms, b_by, nbytes = bound(m, k, n, wbytes)
                emit("kernels", kernel=name, K=k, N=n, M=m,
                     tolerance=TOLERANCE, max_ratio_to_tolerance=ratio,
                     max_abs_err=err, **fault,
                     kernel_ms=t_k, plain_ms=t_p, library_ms=t_l,
                     library=LIBRARY,
                     bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                     launches=kern.launches)
                if m == 8:
                    bound_by.add(b_by)
                    reps = LAYER_GEMMS[(k, n)]
                    for key, t in (("ms", t_k), ("plain_ms", t_p),
                                   ("bound_ms", b_ms), ("library_ms", t_l)):
                        agg[key] += reps * t
            for small in (1, 8):
                for big in (64, 129):
                    if not torch.equal(outs[small], outs[big][:small]):
                        raise AssertionError(
                            f"{name} K={k} N={n}: rows of M={small} differ "
                            f"from the same rows of M={big}")
            emit("kernels", kernel=name, K=k, N=n, row_independent=True)
            del wp, wdec, wdec16, x, outs
        summary[name] = dict(
            name=name, route="cuda", source=str(kern.source.relative_to(ROOT)),
            replaces=replaces, max_abs_err=max_err,
            bound_by="bytes" if bound_by == {"bytes"} else "operations",
            measured_over="the 7 projections of one paper-llama2-7b layer "
                          "at M=8 (sum)", library=LIBRARY, **agg)
    return summary


def serve_phase(codec: str, device, kern, kernels):
    """Serve REQUESTS requests through the port's engine. Every
    launch counter is zeroed just before the run and read just after;
    ``kern`` must have run 7 times per layer per engine launch and every
    other kernel not at all. Returns (engine, launches of ``kern``)."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.prequant import init_packed_params
    cfg = get_config("paper-llama2-7b", quant="serve", quant_format=codec,
                     n_layers=LAYERS)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_packed_params(gen, cfg, device)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in rng.choice(np.arange(16, 129), REQUESTS)]

    def finite_greedy(logits):
        if not np.isfinite(logits).all():
            raise AssertionError(f"{codec}: non-finite logits")
        return np.argmax(logits, axis=-1)

    def run(chunk):
        eng = ServeEngine(params, cfg, n_slots=N_SLOTS, max_len=MAX_LEN,
                          prefill_chunk=chunk, sample_fn=finite_greedy,
                          device=device)
        outs = eng.generate(prompts, TOKENS)
        torch.cuda.synchronize()
        return eng, outs

    torch.cuda.reset_peak_memory_stats()
    for k in kernels:                     # the path's counts start here
        k.launches = 0
    eng, outs = run(CHUNK)
    launches = kern.launches
    others = {k.name: k.launches for k in kernels if k is not kern}
    if any(others.values()):
        raise AssertionError(f"{codec} path launched {others}")
    if launches != 7 * LAYERS * eng.stats.steps:
        raise AssertionError(
            f"{codec}: {launches} kernel launches, expected 7 x {LAYERS} "
            f"layers x {eng.stats.steps} engine launches")
    if len(eng.scheduler.finished) != len(prompts) or any(
            len(o) != TOKENS for o in outs):
        raise AssertionError(f"{codec}: not every request completed")
    peak = torch.cuda.max_memory_allocated()
    _, outs1 = run(1)
    same = sum(a == b for o, o1 in zip(outs, outs1) for a, b in zip(o, o1))
    st = eng.stats
    emit("serve", codec=codec, model=cfg.name, layers=LAYERS,
         d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         n_slots=N_SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
         requests=len(prompts), tokens_out=st.generated_tokens,
         prefill_tokens=st.prefill_tokens, steps=st.steps,
         decode_steps=st.decode_steps, prefill_steps=st.prefill_steps,
         decode_tokens_per_s=st.decode_tokens_per_sec,
         prefill_tokens_per_s=st.prefill_tokens_per_sec,
         decode_step_ms=1e3 * st.decode_wall_s / max(st.decode_steps, 1),
         wall_s=st.wall_s, mean_ttft_steps=eng.mean_ttft_steps(),
         occupancy=st.occupancy, peak_mem_gb=peak / 2 ** 30,
         init_and_pack_s=pack_s, kernel=kern.name, launches=launches,
         launches_expected=7 * LAYERS * st.steps,
         token_agreement_vs_chunk1=same / (len(prompts) * TOKENS))
    return eng, launches


def decode_breakdown(eng, device, steps: int = 3):
    """Wall time of an all-slots decode step (host clock, synchronized, no
    profiler), then its device time by kernel from torch.profiler over as
    many more steps. The idle share is ``1 - device / wall`` unclipped; a
    device time above either run's wall means events were counted twice,
    and raises."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.model import decode_step
    b = eng.n_slots
    tokens = torch.zeros((b, 1), dtype=torch.long, device=device)
    index = torch.full((b,), 128, dtype=torch.long, device=device)

    def run():
        for _ in range(steps):
            decode_step(eng.params, eng.cfg, {"tokens": tokens}, eng.caches,
                        index)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall = (time.perf_counter() - t0) / steps
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    wall_profiled = (time.perf_counter() - t0) / steps
    by_name = {}                      # device-side kernel events only
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.key] = (by_name.get(ev.key, 0.0)
                               + ev.self_device_time_total / 1e3 / steps)
    total = sum(by_name.values())
    gemm = sum(v for k, v in by_name.items() if "dequant_gemm" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    idle = 1 - total / (wall * 1e3)
    if idle < 0 or total > wall_profiled * 1e3:
        raise AssertionError(
            f"device time {total} ms per step exceeds the wall time "
            f"({wall * 1e3} ms, {wall_profiled * 1e3} ms profiled)")
    emit("decode_breakdown", codec=eng.cfg.quant_format,
         layers=eng.cfg.n_layers, slots=b,
         wall_ms=wall * 1e3, profiled_wall_ms=wall_profiled * 1e3,
         device_ms=total, packed_gemm_ms=gemm,
         other_device_ms=total - gemm, device_idle_share=idle,
         top_kernels_ms={k[:80]: v for k, v in top})


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script measures the port "
                 "on an H100 and has nothing to report without one")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.m2xfp_matmul import KERNEL as M2XFP
    from repro_torch.kernels.mxfp4_matmul import KERNEL as MXFP4

    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    built = _build.build()
    regs = {name: [ln.strip() for ln in rep.splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, rep in built["ptxas"].items()}
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, allow_tf32=False,
         build_s=built["seconds"], ptxas=regs)

    timer = Timer(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    summary = kernel_phase(timer, gen, device)

    kernels = (M2XFP, MXFP4)
    eng, summary["m2xfp_matmul"]["launches"] = serve_phase(
        "m2xfp", device, M2XFP, kernels)
    decode_breakdown(eng, device)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng, summary["mxfp4_matmul"]["launches"] = serve_phase(
        "mxfp4", device, MXFP4, kernels)
    decode_breakdown(eng, device)
    del eng

    for name, s in summary.items():
        if s["launches"] < 1:
            raise AssertionError(f"{name} was never launched by its path")
    print(json.dumps({"kernels": list(summary.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
