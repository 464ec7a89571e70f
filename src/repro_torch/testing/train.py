"""A train step on the card held against the same step on the CPU: the
check behind chip_smoke.py's ``train`` phase and tests/test_torch_gpu.py.

The card takes its products on bf16 tensor cores with f32 accumulation
(the backward in IEEE f32), the CPU in float64, and each gradient is
rounded to bf16 where the forward cast to bf16 (``cast_for_compute``, the
product operands). So an element whose sum lies within an ulp of a bf16
rounding edge may round the other way on one side, and later products
carry that on.

Gradients: the bounds that tests/test_torch_train.py holds the port's
gradients to against the reference's (it imports ``GRAD_TOL``,
``GRAD_L2`` and ``grad_agreement`` from here), where the same rounding
flips occur:

  * every gradient element within ``GRAD_TOL * (max(|card|, |cpu|) +
    max|cpu|)`` (the last term: the leaf's largest magnitude);
  * each leaf's L2 error within ``GRAD_L2`` of its norm.

Loss: within ``LOSS_RTOL`` of the CPU's, relative. Its own bound, set
from the card's readings at full width (paper-llama2-7b, 1 layer, B = 1,
S = 64; NVIDIA H100 80GB HBM3, 700.00 W; ``python3 -m
repro_torch.testing.loss_drift`` prints them): the losses are 1.08e-4 (none)
and 2.63e-4 (qat) apart, relative (1.2e-3 and 2.9e-3 at a loss of 11.2),
6 and 15 times tests/test_torch_train.py's ``LOSS_TOL`` (absolute) at
the smoke widths.
The head and the loss alone, fed the same final hidden state, agree
within 6.8e-7; the rest is the hidden state, of which 57% (none) and 3%
(qat) of the elements differ by a bf16 ulp or an FP4 step. The width
makes it: on the CPU, one layer with f32 accumulation in place of float64
flips 44% of the final hidden state at d 4096, ff 11008, and 2.8% at
d 512, ff 1376. The bound leaves a factor 2 over qat's reading. A wrong
forward is far outside it: the layer dropped moves the loss 2.2e-2
(none) and 2.0e-2 (qat), relative; ``step_card_vs_cpu`` plants that fault
each time and reports it.

Gradients measured there: none, ratios 0.17 / 0.17 (elementwise / L2);
qat, 0.83 / 0.35 (an activation's FP4 rounding flips between the two).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.convert import flat_leaves, stack_layers
from repro_torch.models.model import loss_fn
from repro_torch.train.trainer import _grads_and_loss, cast_for_compute
from repro_torch.tree import tree_map

__all__ = ["GRAD_TOL", "GRAD_L2", "LOSS_RTOL", "grad_agreement",
           "step_card_vs_cpu"]

GRAD_TOL = 2.0 ** -5
GRAD_L2 = 2.0 ** -5
LOSS_RTOL = 5e-4


def grad_agreement(got: dict, want: dict) -> dict:
    """Worst ratios, over the leaves of two flat gradient trees ({leaf
    path: tensor}), of the elementwise error to its GRAD_TOL bound and of
    the L2 error to GRAD_L2 (each below 1 when within), with the leaf each
    was found at; ``want`` is the one held to. Computed in float64 on
    ``got``'s device."""
    worst = {"elem_ratio": 0.0, "elem_leaf": None, "l2_ratio": 0.0,
             "l2_leaf": None}
    for k, w in want.items():
        g = got[k].to(torch.float64)
        w = w.to(g.device, torch.float64)
        d = (g - w).abs()
        tol = GRAD_TOL * (torch.maximum(g.abs(), w.abs()) + w.abs().max())
        elem = float((d / tol.clamp_min(1e-38)).max())
        l2 = float(d.norm() / w.norm().clamp_min(1e-38)) / GRAD_L2
        if elem > worst["elem_ratio"]:
            worst.update(elem_ratio=elem, elem_leaf=k)
        if l2 > worst["l2_ratio"]:
            worst.update(l2_ratio=l2, l2_leaf=k)
    return worst


def step_card_vs_cpu(cfg, params: dict, batch: dict) -> dict:
    """Loss and gradients of ``loss_fn(cast_for_compute(params))`` on the
    card (``params`` and ``batch`` there) and on a CPU copy, without remat
    (which recomputes the same values: tests/test_torch_train.py; on the
    CPU the recompute of a full-width layer's m2xfp fake-quant costs
    seconds). Returns the two losses, ``grad_agreement``, ``loss_ratio``
    (the losses' difference to its LOSS_RTOL bound), ``within`` (every
    bound met) and ``planted_fault_ratio``: the same ratio for the card's
    loss with the layers dropped, which a bound that can see a wrong
    forward puts above 1."""
    cfg = dataclasses.replace(cfg, remat=False)
    loss, grads = _grads_and_loss(params, cfg, batch, 1)
    with torch.no_grad():
        dropped = cast_for_compute(
            {k: v for k, v in params.items() if k != "layers"})
        dropped["layers"] = []
        loss_fault = float(loss_fn(dropped, dataclasses.replace(
            cfg, n_layers=0), batch))
    torch.cuda.synchronize()
    loss_cpu, grads_cpu = _grads_and_loss(
        tree_map(lambda t: t.to("cpu"), params), cfg,
        {k: v.to("cpu") for k, v in batch.items()}, 1)
    agree = grad_agreement(flat_leaves(stack_layers(grads)),
                           flat_leaves(stack_layers(grads_cpu)))
    loss, loss_cpu = float(loss), float(loss_cpu)
    bound = LOSS_RTOL * abs(loss_cpu)
    loss_ratio = abs(loss - loss_cpu) / bound
    within = (agree["elem_ratio"] <= 1 and agree["l2_ratio"] <= 1
              and loss_ratio <= 1)
    return {"loss": loss, "loss_cpu": loss_cpu, **agree,
            "loss_ratio": loss_ratio, "within": within,
            "planted_fault_ratio": abs(loss_fault - loss_cpu) / bound}
