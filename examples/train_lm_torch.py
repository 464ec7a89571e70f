"""End-to-end training driver of the PyTorch port (the counterpart of
examples/train_lm.py): a small LM on the deterministic synthetic stream,
with background checkpointing and resume, straggler monitoring,
preemption safety and optional M2XFP QAT.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --steps 200 --quant qat
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20 \\
        --d-model 64 --layers 2 --batch 4 --seq 32

It runs on the card by default (``--device cuda``); on the CPU it runs
the plain versions of every product.
"""
import argparse

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM
from repro_torch.distributed import PreemptionGuard, StragglerMonitor
from repro_torch.models.config import ModelConfig
from repro_torch.train import AdamWConfig, make_train_state, make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--quant", default="none", choices=["none", "qat"])
    ap.add_argument("--ckpt-dir", default="experiments/artifacts/"
                                          "train_lm_torch")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = ModelConfig(
        name="train-lm", family="dense", n_layers=args.layers,
        d_model=args.d_model, n_heads=args.d_model // 32,
        n_kv_heads=args.d_model // 64, d_ff=3 * args.d_model,
        vocab_size=4096, quant=args.quant, remat=False)
    print(f"model: {cfg.n_params/1e6:.1f}M params, quant={cfg.quant}, "
          f"device={args.device}")

    data = SyntheticLM(DataConfig(batch=args.batch, seq=args.seq,
                                  vocab=cfg.vocab_size, seed=0))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg,
                              num_microbatches=args.microbatches)

    mgr = CheckpointManager(args.ckpt_dir, every=50, keep=2)
    guard = PreemptionGuard()
    monitor = StragglerMonitor(
        on_straggle=lambda s, dt: print(f"  [straggler] step {s}: {dt:.2f}s"))

    gen = torch.Generator(device=args.device).manual_seed(0)
    state = make_train_state(gen, cfg, device=args.device)
    resumed, extra, ck_step = mgr.resume(state, cfg, args.device)
    start = 0
    if resumed is not None:
        state, start = resumed, extra["data_step"]
        print(f"resumed from step {ck_step} (data step {start})")

    pf = Prefetcher(data, start_step=start)
    try:
        for i in range(start, args.steps):
            data_step, batch = next(pf)
            batch = {k: torch.from_numpy(v).to(args.device)
                     for k, v in batch.items()}
            monitor.step_start()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])      # waits for the step
            monitor.step_end(i)
            if i % 20 == 0 or i == args.steps - 1:
                print(f"step {i:5d}  loss {loss:.4f}  "
                      f"gnorm {float(metrics['grad_norm']):.3f}  "
                      f"lr {float(metrics['lr']):.2e}")
            mgr.maybe_save(i, state, extra={"data_step": data_step + 1})
            if guard.preempted:
                print("preempted -- final checkpoint")
                mgr.maybe_save(i, state, extra={"data_step": data_step + 1},
                               force=True)
                break
        else:
            mgr.maybe_save(args.steps - 1, state,
                           extra={"data_step": args.steps}, force=True)
        mgr.wait()
    finally:
        pf.close()
        guard.restore()
    print("done.")


if __name__ == "__main__":
    main()
