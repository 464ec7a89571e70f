"""Serving example of the PyTorch port (the counterpart of
examples/serve_quantized.py) -- a thin wrapper over the packed-weight
engine.

Pipeline (the paper's deployment path, repro_torch.serve):
  1. offline prequantization: bf16 params -> the packed streams of the
     --fmt codec (m2xfp: Sg-EM, 4.5 bits/element resident; any packable
     repro_torch.core.codecs entry), round-tripped through a packed
     checkpoint;
  2. continuous-batching decode: requests with different prompt lengths
     share the batch, admitted/evicted per slot while the engine keeps
     stepping (quantized KV-cache pages with --kv-quant). On the card each
     projection runs the codec's fused dequant-GEMM (m2xfp, mxfp4), or its
     decode and a dense product (nvfp4).

    PYTHONPATH=src python examples/serve_quantized_torch.py --tokens 16
    PYTHONPATH=src python examples/serve_quantized_torch.py --fmt mxfp4
    PYTHONPATH=src python examples/serve_quantized_torch.py --device cpu \\
        --tokens 4 --requests 3 --slots 2 --d-model 64 --layers 1
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.core.codecs import packed_codecs
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params
from repro_torch.serve import (
    ServeEngine, load_packed_checkpoint, prequantize_params,
    save_packed_checkpoint, tree_nbytes,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fmt", default="m2xfp", choices=list(packed_codecs()),
                    help="packed weight codec served from the checkpoint")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device here "
                           f"(pass --device cpu to run the plain versions)")

    cfg = ModelConfig(
        name="serve-lm", family="dense", n_layers=args.layers,
        d_model=args.d_model, n_heads=args.d_model // 32,
        n_kv_heads=args.d_model // 64, d_ff=3 * args.d_model,
        vocab_size=4096, remat=False, quant="serve",
        quant_format=args.fmt,
        kv_quant="m2xfp" if args.kv_quant else "none")

    params = init_params(torch.Generator(device).manual_seed(0), cfg,
                         device)
    packed = prequantize_params(params, cfg)
    dense_mib = tree_nbytes(params) / 2 ** 20
    packed_mib = tree_nbytes(packed) / 2 ** 20
    print(f"weights: {dense_mib:.1f} MiB bf16 -> {packed_mib:.1f} MiB "
          f"packed {args.fmt}")

    # the engine loads from the packed checkpoint, proving bf16 weights are
    # not needed at serving time
    with tempfile.TemporaryDirectory() as ckdir:
        save_packed_checkpoint(ckdir, packed, cfg)
        served, _ = load_packed_checkpoint(ckdir, cfg, device=device)

    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in rng.integers(args.prompt_len // 2,
                                     args.prompt_len + 1, args.requests)]
    eng = ServeEngine(served, cfg, n_slots=args.slots,
                      max_len=args.prompt_len + args.tokens, device=device)
    outputs = eng.generate(prompts, max_new_tokens=args.tokens)

    s = eng.stats
    print(f"served {len(prompts)} requests on {args.slots} slots in "
          f"{s.steps} steps / {s.wall_s:.2f}s — "
          f"{s.tokens_per_sec:.1f} tok/s on {device.type}, "
          f"slot occupancy {s.occupancy:.2f}")
    print("sample output:", outputs[0])
    return {"bf16_mib": dense_mib, "packed_mib": packed_mib,
            "outputs": outputs, "steps": s.steps,
            "tokens_per_sec": s.tokens_per_sec, "occupancy": s.occupancy}


if __name__ == "__main__":
    main()
