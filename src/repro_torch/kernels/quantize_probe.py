"""Measurements of the quantize engine (csrc/m2xfp_quantize.cu) on the card:

    PYTHONPATH=src python3 -m repro_torch.kernels.quantize_probe \\
        [--ms 1 8 64 129 2048] [--ks 4096 11008] [--dtype bfloat16]

Prints one JSON line each for:

  device        the card's name and ``nvidia-smi`` name and power limit
  ptxas         registers, stack frame and spill bytes of every kernel
                instance in the library (``nvcc -Xptxas=-v``, built into
                ``build/repro_torch/probe/`` so the report is always there)
  sass          the static SASS instruction count of each kernel instance
                (``cuobjdump -sass``)
  launch_floor  the event time of ``torch.zeros(1, device="cuda")``: one
                allocation and one one-element fill kernel, timed as the
                quantize calls are
  quantize      per (M, K): the event time of one call through the public
                entry point (median of 20, a 256 MB buffer zeroed before
                each launch, so the 50 MB L2 holds none of x), the kernel's
                own device time from ``torch.profiler`` (mean over 20
                launches, same flush), the byte bound (M*K*2 read,
                M*K*(1/2 + 2/32) written, at 3.35 TB/s), the share of it
                reached, the bytes per second of the kernel-only time, and
                as a yardstick of the memory path the event time of
                ``x.clone()`` (twice x's bytes moved, timed alike)

It measures whichever kernel the package at hand holds, so the same script
times an older tree's kernel when run from that tree's ``src``. It exits
with an error without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from . import _build

HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
NAME = "m2xfp_quantize"


def bound_ms(m: int, k: int, itemsize: int = 2) -> float:
    """Least time (ms) of one call: x read once, the streams written once."""
    return (m * k * itemsize + m * k * (0.5 + 2 / 32)) / HBM_BYTES_PER_S * 1e3


def build_report() -> tuple:
    """Compile the quantize source once more with ``-Xptxas=-v`` into
    ``build/repro_torch/probe``; returns (ptxas report, library path)."""
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{NAME}.so"
    done = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(_build.CSRC / f"{NAME}.cu")],
                          check=True, capture_output=True, text=True)
    return done.stdout + done.stderr, lib


def ptxas_functions(report: str) -> list:
    """Per kernel instance of a ``-Xptxas=-v`` report: registers, stack
    frame bytes and spill bytes (stores + loads)."""
    rows, name = [], None
    for line in report.splitlines():
        hit = re.search(r"Compiling entry function '(\S+)'", line)
        if hit:
            name = hit.group(1)
            rows.append({"function": name})
            continue
        if name is None:
            continue
        hit = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", line)
        if hit:
            rows[-1]["stack_bytes"] = int(hit.group(1))
            rows[-1]["spill_bytes"] = int(hit.group(2)) + int(hit.group(3))
        hit = re.search(r"Used (\d+) registers", line)
        if hit:
            rows[-1]["registers"] = int(hit.group(1))
    return rows


def sass_counts(lib: Path) -> dict:
    """Static SASS instruction count of every kernel in ``lib``."""
    sass = subprocess.run(
        [str(Path(_build.nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
        check=True, capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        hit = re.search(r"Function : (\S+)", line)
        if hit:
            name = hit.group(1)
            counts[name] = 0
        elif name is not None and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[name] += 1
    return counts


def event_ms(fn, flush: torch.Tensor, iters: int = 20,
             warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn()``, ``flush`` (larger than the L2)
    zeroed before each launch; chip_smoke.py's Timer."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def launch_floor_ms(flush: torch.Tensor, device) -> float:
    """Event time of the smallest call that launches a kernel."""
    return event_ms(lambda: torch.zeros(1, device=device), flush)


def kernel_only_ms(fn, flush: torch.Tensor, tag: str = "quantize",
                   iters: int = 20):
    """Mean device time per launch of the kernels whose name carries
    ``tag``, from torch.profiler over ``iters`` calls of ``fn`` (each
    launching one), ``flush`` zeroed before each call. The mean is over the
    launches the trace holds: a session can miss its first ones (seen in
    chip_smoke.py after earlier sessions), and one that holds none is
    repeated, twice at most; None (not measured) if all three hold none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        found = [ev for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and tag in ev.key]
        launches = sum(ev.count for ev in found)
        if launches:
            return sum(ev.self_device_time_total for ev in found) \
                / launches / 1e3
    return None


def run(ms, ks, dtype=torch.bfloat16, seed: int = 0) -> list:
    from .m2xfp_quantize import KERNEL
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    lines = [dict(probe="device", name=torch.cuda.get_device_name(0),
                  nvidia_smi=smi)]
    report, lib = build_report()
    lines.append(dict(probe="ptxas", functions=ptxas_functions(report)))
    lines.append(dict(probe="sass", instructions=sass_counts(lib)))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    lines.append(dict(probe="launch_floor",
                      ms=launch_floor_ms(flush, dev)))
    gen = torch.Generator(device=dev).manual_seed(seed)
    for k in ks:
        xk = (torch.randn(max(ms), k, generator=gen, device=dev)
              * torch.exp(0.8 * torch.randn(1, k, generator=gen,
                                            device=dev))).to(dtype)
        for m in ms:
            x = xk[:m]
            fn = lambda: KERNEL(x)                          # noqa: E731
            t = event_ms(fn, flush)
            b = bound_ms(m, k, x.element_size())
            t_k = kernel_only_ms(fn, flush)
            nbytes = b * 1e-3 * HBM_BYTES_PER_S
            lines.append(dict(probe="quantize", M=m, K=k,
                              dtype=str(dtype).replace("torch.", ""),
                              ms=t, kernel_only_ms=t_k, bound_ms=b,
                              share_of_bound=b / t, bytes=nbytes,
                              bytes_per_s_kernel_only=(
                                  nbytes / (t_k * 1e-3) if t_k else None),
                              clone_ms=event_ms(lambda: x.clone(), flush),
                              clone_bytes=2 * x.numel() * x.element_size()))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ms", type=int, nargs="+", default=[1, 8, 2048])
    ap.add_argument("--ks", type=int, nargs="+", default=[4096, 11008])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("quantize_probe: no CUDA device")
    for line in run(args.ms, args.ks, getattr(torch, args.dtype)):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
