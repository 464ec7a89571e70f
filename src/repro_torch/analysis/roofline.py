"""Three-term roofline over a counted step (port of repro.analysis.roofline,
on an NVIDIA H100 SXM 80GB in place of the reference's TPU v5e):

    compute    = FLOPs            / (chips * PEAK_FLOPS)   [dense bf16]
    memory     = HBM bytes        / (chips * HBM_BW)
    collective = collective bytes / (chips * LINK_BW)

The FLOPs, bytes and collective bytes are one rank's step as
``repro_torch.analysis.step_cost`` counts it, times the chip count (the
formulas divide it straight back out), as the reference's are its
per-device HLO counts. The bytes are step_cost's ``hbm_bytes_per_device``,
the least traffic (every operand read once, every result written once),
so that each term is a lower bound on its time. The bound is max(terms) under perfect overlap; the
dominant term is what a tuning pass would attack first.

MODEL_FLOPS takes the 6·N·D training convention (2·N·D for a prefill,
2·N·B for a decode step; N = active parameters for MoE); MODEL_FLOPS /
counted FLOPs exposes recompute and redundant work (below 1 when the step
does more than the model's products).

What differs from the reference: the three constants (below, each with
its source), and the counts it divides, which come from running the
port's step (``step_cost``) where the reference parses its compiled HLO.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM5 80GB data sheet ("NVIDIA H100 Tensor Core GPU",
# SXM5 column): BF16 Tensor Core 1,979 TFLOPS with sparsity, so 989e12
# FLOP/s dense
PEAK_FLOPS = 989e12
# the same data sheet: GPU memory bandwidth 3.35 TB/s (HBM3)
HBM_BW = 3.35e12
# one figure per chip for every collective, as in the reference. The
# production meshes' 16-wide "model" axis spans two 8-GPU NVLink nodes, so
# its rings cross the inter-node network, which binds: one ConnectX-7 NDR
# InfiniBand port per GPU in a DGX H100 (DGX H100 user guide), 400 Gb/s
# = 50e9 B/s. (NVLink 4's 900 GB/s holds only within a node.)
LINK_BW = 50e9

__all__ = ["RooflineTerms", "roofline", "model_flops",
           "PEAK_FLOPS", "HBM_BW", "LINK_BW"]


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    chips: int
    hlo_flops: float             # global (the reference's key names)
    hlo_bytes: float             # global
    collective_bytes: float      # global
    model_flops: float
    dominant: str = ""
    useful_ratio: float = 0.0    # MODEL_FLOPS / counted FLOPs
    roofline_fraction: float = 0.0

    def finalize(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.dominant = max(terms, key=terms.get)
        self.useful_ratio = (self.model_flops / self.hlo_flops
                             if self.hlo_flops else 0.0)
        # fraction of ideal: useful-FLOPs time vs the bound time
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        bound = max(terms.values())
        self.roofline_fraction = ideal / bound if bound > 0 else 0.0
        return self

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline(per_device_flops: float, per_device_bytes: float,
             per_device_coll_bytes: float, chips: int,
             model_flops_: float) -> RooflineTerms:
    gf = per_device_flops * chips
    gb = per_device_bytes * chips
    gc = per_device_coll_bytes * chips
    return RooflineTerms(
        compute_s=gf / (chips * PEAK_FLOPS),
        memory_s=gb / (chips * HBM_BW),
        collective_s=gc / (chips * LINK_BW),
        chips=chips, hlo_flops=gf, hlo_bytes=gb, collective_bytes=gc,
        model_flops=model_flops_,
    ).finalize()


def model_flops(cfg, shape: dict) -> float:
    """6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode), N = active
    params."""
    n = cfg.active_params
    if shape["kind"] == "train":
        return 6.0 * n * shape["batch"] * shape["seq"]
    if shape["kind"] == "prefill":
        return 2.0 * n * shape["batch"] * shape["seq"]
    return 2.0 * n * shape["batch"]          # decode: one token / sequence
