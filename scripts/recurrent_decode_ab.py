"""Host wall time, device time and idle share of the recurrent families'
all-slots decode step on the card, for the port in a given source tree:
run it once per tree within one machine to compare two trees.

    python scripts/recurrent_decode_ab.py --src SRC [--steps N] [--label L]

xlstm-125m (its first 12 blocks) and zamba2-7b (its first 14 blocks),
chip_smoke's recurrent depths, with m2xfp weights packed on the card
from a seed and unplaced; 8 slots against caches of 512 positions, every
slot at position 128, as chip_smoke's decode_breakdown. The step is run
twice to warm up, then timed on the host clock over ``--steps`` steps
(synchronized at the end), then profiled (the device's kernels only)
over as many. ``idle`` is 1 - device / wall. One JSON line per model,
labelled with ``--label``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

MODELS = (("xlstm-125m", 12), ("zamba2-7b", 14))
SLOTS, MAX_LEN, POSITION, SEED = 8, 512, 128, 0


def measure(arch: str, blocks: int, steps: int, device) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models.model import decode_step, init_caches
    from repro_torch.serve.prequant import init_packed_params
    full = get_config(arch)
    cfg = get_config(arch, quant="serve", n_layers=blocks,
                     block_kinds=full.kinds[:blocks])
    params = init_packed_params(
        torch.Generator(device=device).manual_seed(SEED), cfg, device)
    caches = init_caches(cfg, SLOTS, MAX_LEN, device)
    tokens = torch.zeros((SLOTS, 1), dtype=torch.long, device=device)
    index = torch.full((SLOTS,), POSITION, dtype=torch.long, device=device)

    def run(n):
        with torch.no_grad():
            for _ in range(n):
                decode_step(params, cfg, {"tokens": tokens}, caches, index)
        torch.cuda.synchronize()
    run(2)
    t0 = time.perf_counter()
    run(steps)
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(steps)
    device_ms = sum(ev.self_device_time_total for ev in prof.key_averages()
                    if ev.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / steps
    if device_ms <= 0:
        raise RuntimeError(f"{arch}: the profile holds no device time")
    return {"model": arch, "blocks": blocks, "slots": SLOTS,
            "steps": steps, "wall_ms": wall_ms, "device_ms": device_ms,
            "idle": 1.0 - device_ms / wall_ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="the tree's src directory (holds repro_torch)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    for arch, blocks in MODELS:
        line = measure(arch, blocks, args.steps, device)
        print(json.dumps(dict(line, label=args.label, src=args.src)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
