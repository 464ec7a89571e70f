"""Quickstart of the PyTorch port (the counterpart of
examples/quickstart.py): quantize a tensor with every format, inspect the
M2XFP encoding, and run the hand-written CUDA kernels.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --rows 32

It runs on the card by default (``--device cuda``: the online quantize
engine and the fused dequant-GEMM are the CUDA kernels, and the GEMM's
output is held to its plain version); on the CPU every kernel call runs
its plain version.
"""
import argparse
import math

import numpy as np
import torch

from repro_torch.core.dse import run_strategy
from repro_torch.core.formats import (quantize_mxfp4, quantize_nvfp4,
                                      quantize_smx4)
from repro_torch.core.m2xfp import (encode_act_m2xfp, quantize_act_m2xfp,
                                    quantize_weight_m2xfp)
from repro_torch.kernels import m2xfp_matmul, m2xfp_quantize, pack_w_sgem
from repro_torch.kernels.ref import decode_w_sgem_ref, m2xfp_matmul_ref


def device_of(name: str) -> torch.device:
    """``name`` as a device; a CUDA device that is not present raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device here (pass "
                           f"--device cpu to run the plain versions)")
    return device


def gemm_check(x: torch.Tensor, wp: dict, out: torch.Tensor) -> dict:
    """``out`` (the GEMM on x's device) against the plain version on the
    CPU: the max |diff| and its max ratio to sqrt(K) 2^-24 (|x| @
    |Wdec|), the K f32 roundings of the kernel's sum as a random walk."""
    xc = x.cpu().to(torch.bfloat16)
    wc = {k: v.cpu() for k, v in wp.items()}
    plain = m2xfp_matmul_ref(xc, wc)
    k = xc.shape[1]
    bound = math.sqrt(k) * 2.0 ** -24 * torch.matmul(
        xc.double().abs(), decode_w_sgem_ref(wc).double().abs())
    diff = (out.cpu().double() - plain.double()).abs()
    return {"max_abs_err": float(diff.max()),
            "max_ratio_to_tolerance": float((diff / bound.clamp_min(
                1e-45)).max())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=256,
                    help="rows of the tensor (256: the reference "
                         "quickstart's; the kernels take at most 128)")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    rng = np.random.default_rng(0)
    # LLM-like tensor: heavy-tailed with outlier channels
    x = torch.from_numpy(rng.standard_t(4, (args.rows, 1024)).astype(
                         np.float32)
                         * np.exp(0.8 * rng.standard_normal((1, 1024))
                                  ).astype(np.float32)).to(device)

    print("== format comparison (MSE vs f32, lower is better) ==")
    mse = {}
    for name, fn in [
        ("mxfp4   (EBW 4.25)", quantize_mxfp4),
        ("nvfp4   (EBW 4.50)", quantize_nvfp4),
        ("smx4    (EBW 4.00)", quantize_smx4),
        ("m2xfp-A (EBW 4.50)", quantize_act_m2xfp),
        ("m2xfp-W (EBW 4.50)", quantize_weight_m2xfp),
    ]:
        mse[name] = float(torch.mean((fn(x) - x) ** 2))
        print(f"  {name}: {mse[name]:.5f}")

    print("\n== packed M2XFP layout (paper Sec. 5.2) ==")
    p = encode_act_m2xfp(x)
    bits = p.nbytes_per_elem * 8
    print(f"  codes {tuple(p.codes.shape)} u8 + scale {tuple(p.scale.shape)}"
          f" u8 + meta {tuple(p.meta.shape)} u8 = {bits:.2f} bits/elem")

    print("\n== DSE strategies at subgroup 8 (paper Figs. 6-7) ==")
    dse = {}
    for s in ("elem_em_top1", "sg_em_2bit", "sg_em_2bit_adaptive",
              "sg_ee_2bit"):
        dq, ebw = run_strategy(s, x, subgroup=8)
        dse[s] = (ebw, float(torch.mean((dq - x) ** 2)))
        print(f"  {s:22s} EBW={ebw:.3f}  MSE={dse[s][1]:.5f}")

    print(f"\n== kernels on {device.type} (the CUDA kernels on the card, "
          f"their plain versions on the CPU) ==")
    w = torch.from_numpy(rng.standard_normal((1024, 128)).astype(np.float32)
                         * .05).to(device)
    wp = pack_w_sgem(w)
    xb = x[:128].to(torch.bfloat16)
    out = m2xfp_matmul(xb, wp)
    xq = m2xfp_quantize(x[:128, :512].contiguous())
    check = gemm_check(xb, wp, out)
    print(f"  fused dequant-GEMM out: {tuple(out.shape)} {out.dtype}")
    print(f"  online quantize streams: codes {tuple(xq['codes'].shape)}, "
          f"scales {tuple(xq['scales'].shape)}, "
          f"meta {tuple(xq['meta'].shape)}")
    print(f"  dequant-GEMM vs its plain version: max |diff| "
          f"{check['max_abs_err']:.3e}, max ratio to tolerance "
          f"{check['max_ratio_to_tolerance']:.4f}")
    return {"mse": mse, "bits_per_elem": bits, "dse": dse,
            "gemm": dict(check, shape=tuple(out.shape)),
            "quantize_shapes": {k: tuple(v.shape) for k, v in xq.items()}}


if __name__ == "__main__":
    main()
