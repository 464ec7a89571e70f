"""Per-block timeline of the dequant-GEMM (csrc/mx_dequant_gemm.cuh) on the
card, where ncu and nsys do not run:

    PYTHONPATH=src python3 -m repro_torch.kernels.gemm_timeline [--m 8]

Builds ``csrc/m2xfp_matmul.cu`` once more with ``-DMX_GEMM_TIMELINE``, so
that every block records its clock readings, launches it once per
paper-llama2-7b projection shape on random weights after flushing the L2
cache (as chip_smoke.py's timer does), and prints one JSON line per shape
with the 0/50/90/100th percentiles over the blocks of:

  start_us, end_us  block start and end (globaltimer), from the first start
  first_data_cyc    SM clock cycles from the block's start until its first
                    stage has landed
  wait_cyc          cycles in the loop waiting for stages (and issuing the
                    next copies)
  compute_cyc       cycles in the loop decoding and multiplying
  tail_cyc          cycles from the loop's end to the block's end: the
                    partial tile, the cluster barrier (which waits for the
                    slowest split) and the reduction through distributed
                    shared memory

and ``clock_ghz``, the cycles over the nanoseconds of the slowest block. It
exits with an error without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from . import _build, layout

SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096)]   # (K, N)


def build() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "timeline"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libm2xfp_matmul_timeline.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-DMX_GEMM_TIMELINE",
                    "-o", str(lib), str(_build.CSRC / "m2xfp_matmul.cu")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def _pct(a) -> list:
    return [float(np.percentile(a, p)) for p in (0, 50, 90, 100)]


def run(m: int = 8, seed: int = 0) -> list:
    lib = build()
    gemm = lib.m2xfp_matmul
    gemm.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    gemm.restype = ctypes.c_int
    fetch = lib.dequant_gemm_timeline
    fetch.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fetch.restype = ctypes.c_int
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    lines = []
    for k, n in SHAPES:
        wp = layout.pack_w_sgem(torch.randn(k, n, generator=gen, device=dev)
                                * 0.02)
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty(m, n, device=dev)
        s = _build.split_k(k, n)

        def call():
            rc = gemm(x.data_ptr(), wp["codes"].data_ptr(),
                      wp["scales"].data_ptr(), wp["meta"].data_ptr(),
                      out.data_ptr(), m, k, n, s,
                      torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                raise RuntimeError(f"m2xfp_matmul: CUDA error {rc}")

        for _ in range(3):
            call()
        flush.zero_()
        call()
        torch.cuda.synchronize()
        blocks = -(-n // _build.BLOCK_N) * s * -(-m // 64)
        words = np.zeros(8 * blocks, dtype=np.uint64)
        if fetch(ctypes.c_void_p(words.ctypes.data), words.size):
            raise RuntimeError("dequant_gemm_timeline: copy failed")
        t = words.reshape(blocks, 8).astype(np.int64)
        t0 = t[:, 0].min()
        slowest = int(np.argmax(t[:, 1] - t[:, 0]))
        lines.append(dict(
            kernel="m2xfp_matmul", K=k, N=n, M=m, split_k=s, blocks=blocks,
            device=torch.cuda.get_device_name(0),
            kernel_us=float(t[:, 1].max() - t0) / 1e3,
            start_us=_pct((t[:, 0] - t0) / 1e3),
            end_us=_pct((t[:, 1] - t0) / 1e3),
            first_data_cyc=_pct(t[:, 2]), wait_cyc=_pct(t[:, 3]),
            compute_cyc=_pct(t[:, 4]), tail_cyc=_pct(t[:, 5]),
            stages=_pct(t[:, 6]),
            clock_ghz=float(t[slowest, 7] / (t[slowest, 1] - t[slowest, 0]))))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=8, help="rows of x")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("gemm_timeline: no CUDA device")
    for line in run(args.m):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
