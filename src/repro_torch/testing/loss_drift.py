"""Where the card's training loss parts from the CPU's, and how far a
wrong forward moves it (the readings behind ``repro_torch.testing.train``'s
``LOSS_RTOL``):

    PYTHONPATH=src python3 -m repro_torch.testing.loss_drift [--device cuda]
    PYTHONPATH=src python3 -m repro_torch.testing.loss_drift --device cpu

On the card (``--device cuda``), per quant (none, qat): paper-llama2-7b at
full width, 1 layer from seed 0, B = 1, S = 64, the loss on the card and
on a CPU copy and their relative difference; the share of the final
hidden state's elements that differ and its largest difference; the loss
of the head alone fed the CPU's hidden state on both sides (the head's own
drift); and the card's loss, relative to the CPU's, with three planted
faults: the layer dropped, every position 0 (every key visible, no rope),
and the positions reversed.

On the CPU (``--device cpu``), the same model at d_model 512 and 4096
(vocab 2048): the share of the final hidden state that changes when the
products accumulate in f32 (``torch.matmul``) in place of float64 --
the card's accumulation against the CPU's, with everything else the same.

One JSON line per reading.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import model as M
from repro_torch.models import numerics
from repro_torch.train import cast_for_compute, make_train_state
from repro_torch.tree import tree_map


def _batch(vocab: int, device) -> dict:
    data = SyntheticLM(DataConfig(batch=1, seq=64, vocab=vocab, seed=0))
    return {k: torch.from_numpy(v).to(device)
            for k, v in data.batch_at(0).items()}


def _hidden(params, cfg, batch) -> torch.Tensor:
    """``forward``'s hidden state before the final norm."""
    h = M._embed_in(params, cfg, batch)
    pos = torch.arange(h.shape[1], device=h.device).expand(*h.shape[:2])
    for lp, window in zip(params["layers"], M.layer_windows(cfg)):
        h, _ = M._attn_block_forward(lp, h, cfg, pos, window)
    return h


def _head_loss(params, cfg, h, labels) -> float:
    lf = M._logits(params, cfg, h)
    picked = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return float((torch.logsumexp(lf, -1) - picked).mean())


def _params(cfg, device):
    gen = torch.Generator(device).manual_seed(0)
    return cast_for_compute(make_train_state(gen, cfg, device=device)
                            ["params"])


@torch.no_grad()
def card(quant: str) -> dict:
    cfg = dataclasses.replace(get_config("paper-llama2-7b", n_layers=1,
                                         quant=quant), remat=False)
    pg = _params(cfg, "cuda")
    pc = tree_map(lambda t: t.cpu(), pg)
    bg, bc = _batch(cfg.vocab_size, "cuda"), _batch(cfg.vocab_size, "cpu")
    lg, lc = float(M.loss_fn(pg, cfg, bg)), float(M.loss_fn(pc, cfg, bc))
    rel = lambda x: abs(x - lc) / abs(lc)                    # noqa: E731
    hg, hc = _hidden(pg, cfg, bg).cpu(), _hidden(pc, cfg, bc)
    head_c = _head_loss(pc, cfg, hc, bc["labels"])
    head_g = _head_loss(pg, cfg, hc.to("cuda"), bg["labels"])
    dropped = dict(pg, layers=[])
    zero = dict(bg, positions=torch.zeros_like(bg["tokens"]))
    rev = dict(bg, positions=torch.arange(63, -1, -1, device="cuda")
               .expand(1, 64).contiguous())
    return {"quant": quant, "loss_card": lg, "loss_cpu": lc,
            "loss_rel": rel(lg),
            "hidden_differ_share": float((hg != hc).float().mean()),
            "hidden_max_abs": float((hg.float() - hc.float()).abs().max()),
            "head_only_rel": abs(head_g - head_c) / abs(head_c),
            "fault_layer_dropped_rel": rel(float(M.loss_fn(
                dropped, dataclasses.replace(cfg, n_layers=0), bg))),
            "fault_positions_zero_rel": rel(float(M.loss_fn(pg, cfg, zero))),
            "fault_positions_reversed_rel": rel(float(M.loss_fn(pg, cfg,
                                                                rev)))}


@torch.no_grad()
def cpu_accumulation(d_model: int, d_ff: int) -> dict:
    cfg = dataclasses.replace(get_config(
        "paper-llama2-7b", n_layers=1, d_model=d_model, d_ff=d_ff,
        vocab_size=2048), remat=False)
    p, b = _params(cfg, "cpu"), _batch(2048, "cpu")
    h64 = _hidden(p, cfg, b)
    f64 = numerics.dot_f64acc
    numerics.dot_f64acc = lambda a, w: torch.matmul(a.float(), w.float())
    try:
        h32 = _hidden(p, cfg, b)
    finally:
        numerics.dot_f64acc = f64
    return {"d_model": d_model, "d_ff": d_ff,
            "hidden_differ_share_f32_vs_f64": float(
                (h64 != h32).float().mean()),
            "hidden_max_abs": float((h64.float() - h32.float()).abs().max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cpu":
        for d, ff in ((512, 1376), (4096, 11008)):
            print(json.dumps(cpu_accumulation(d, ff)), flush=True)
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("loss_drift --device cuda needs a CUDA device")
    for quant in ("none", "qat"):
        print(json.dumps(card(quant)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
