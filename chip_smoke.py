"""Bring-up check of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root, on the card

Builds the hand-written CUDA kernels of ``src/repro_torch/csrc`` with nvcc
for sm_90a (into ``build/repro_torch/``), then runs these phases, each
printing JSON lines:

  1. device   -- card, power limit, torch/CUDA versions, kernel build time,
                 ptxas registers and spills (flash attention, the two
                 dequant-GEMMs, the W4A4 GEMM and the quantize engine must
                 spill nothing; the quantize engine's registers per instance)
  2. kernels  -- each dequant-GEMM at the full-width paper-llama2-7b
                 projection shapes and M in {1, 8, 64, 129}: held against its
                 plain version within the expected size of f32 rounding
                 (see TOLERANCE), shown to reject a planted one-group fault
                 of the packed weight, rows bit-identical across M, the same
                 bits from two calls, timed with a 256 MB buffer zeroed
                 before each launch (so the 50 MB L2 holds none of the
                 operands), beside its bound (and the share of it reached),
                 the plain version and a library yardstick; each line names
                 the split count (a function of K and N) and the workspace
                 (none: the splits are summed inside a thread-block cluster);
                 then one m2xfp launch per shape at M = 8 built with its
                 per-block clock readings (repro_torch.kernels.gemm_timeline:
                 first-data latency, wait, compute and tail cycles)
  3. serve    -- continuous-batching serving of full-width, full-depth
                 paper-llama2-7b (random weights from SEED, packed m2xfp)
                 through the port's ServeEngine, its guard on (the default);
                 every projection must go through the m2xfp kernel, the
                 guard must stay healthy with nothing quarantined, scrubbed
                 or retried, and the same traffic served with
                 prefill chunks of 1 must give the same tokens (chunked
                 prefill is bit-identical to decode); then one all-slots
                 decode step
                 split into host wall time and device time by kernel, after
                 a check that every kernel in the GEMM's library carries
                 "dequant_gemm" in its name, so the split counts them all,
                 and the engine's decode launch timed with the guard on and
                 off (guard_wall_ms_delta, guard_device_ms_delta)
  4. serve    -- the same traffic with an m2xfp-packed KV cache
                 (kv_quant="m2xfp", paper Sec. 6.4; the main path's step 5)
                 on the first 2 of the same layers (PACKED_KV_LAYERS): the
                 same assertions, and beside them the packed pages' bytes
                 against phase 3's pages at the same depth; then its
                 decode step split as in phase 3
  5. guard    -- the serving guard on the first 16 of the same layers
                 (GUARD_LAYERS), with
                 a bf16 and an m2xfp-packed KV cache: 12 requests (prompts
                 of 16-64 tokens, 16 new tokens, 8 slots) fault-free with
                 the guard on, equal to guard=False, then under a FaultPlan
                 chosen from that run (NaN logits in one slot, a poisoned
                 KV page in another, a transient failure, a delay past the
                 armed watchdog): exactly the planned slots' requests are
                 quarantined, every other request (one of them in a
                 scrubbed slot) keeps its fault-free tokens, the scrubbed
                 pages read zero in every layer, the health recovers within
                 RECOVERY_STEPS; then packed-stream validation of the
                 weights (validate_ms) and a planted scale byte 255
                 reported and repaired by clamp
  6. codecs   -- the paper's codec matrix (m2xfp, m2xfp_ideal6, m2nvfp4,
                 mxfp4, nvfp4, smx4, fp4) on the card against the same calls
                 on the CPU, bit for bit: every codec's fake_quant_act on
                 heavy-tailed (8, 4096) and (64, 11008) activations and
                 fake_quant_weight on a (4096, 512) column slice of a
                 full-width projection; the five scale rules (exponents at
                 the edges where a log2 is rounded, MXFP4 and m2xfp
                 fake-quant); pack_w_nvfp4's codes, E4M3 scale bytes and
                 tensor scale on a full (4096, 11008) weight. Then serving
                 on the first CODEC_LAYERS layers: m2xfp_ideal6 on phase
                 3's m2xfp weights re-tagged (its packed weights are
                 m2xfp's bytes, checked on one projection), through kernel
                 #1 (7 launches per layer per engine launch, chunked
                 prefill bit-identical to decode), and nvfp4 packed on the
                 card from SEED, which launches no dequant-GEMM (decode in
                 f32, then an f32 GEMM); its agreement with chunks of 1 is
                 printed, not asserted (per-tensor activation scales depend
                 on which tokens share a launch), beside its decode step's
                 device time and its weights' bytes
  7. variants -- the attention variants (ROADMAP A6a, A6b) served at full
                 width through the same engine, m2xfp weights from SEED
                 (the QKV biases and qk-norm weights seeded too, not
                 init's zeros and ones: repro_torch.testing.
                 fill_attention_extras), with the codecs phase's traffic:
                 qwen2-0.5b at all 24 layers (QKV bias, the tied
                 151,936-row head, 128-column wk/wv), qwen3-8b at its first
                 4 of 36 (qk-norm), and gemma2-9b at its first 4 of 42 (2
                 local/global pairs, its window of 4096, soft-caps 50 and
                 30, the tied 256,000-row head) with 128 positions and
                 prompts of 96-160 tokens, so both its rings wrap (read
                 from the caches' position tracks: each ring holds its
                 slot's last positions; the positions each ring overwrote
                 are printed); each with phase 3's assertions (7 launches
                 of the m2xfp kernel per layer per engine launch, the guard
                 healthy, chunks of 1 giving the same tokens); before each
                 serve, the kernel at each of the model's projection shapes
                 against its plain version (M = 8 and 64, rows equal
                 across M, the split plan printed); then gemma2's decode
                 step split as in phase 3
  8. families -- the model families of ROADMAP A6c and A6d at full width,
                 m2xfp weights from SEED, bf16 KV. Embedding input at the
                 model level (no engine serves it): musicgen-large at its
                 first 8 of 48 layers and pixtral-12b at its first 8 of
                 40 (FAMILY_EMBED: the phase's time), 8 slots x
                 32 embeddings through prefill chunks of 8 and through
                 decode_step, slots valid for 32..1 positions: logits at
                 every valid position finite and equal bit for bit, caches
                 equal, the m2xfp kernel launched 7 times per layer per
                 launch. Mixture-of-experts through the engine with the
                 codecs phase's traffic: olmoe-1b-7b at its first 8 of 16 (64
                 experts, packed (K, E, N)) and mixtral-8x22b at its first
                 2 of 56 (8 experts, dense bf16, as the reference leaves
                 them); for each of the four models, before its runs, the
                 kernel at each of layer 0's projection shapes against its
                 plain version as in phase 7; before each serve, layer 0's
                 moe_apply on the card at 8 and 64 tokens and its device
                 time split into the experts' decode and products, then,
                 after the serve, the same calls on the CPU (routing bit
                 for bit, the output within MOE_TOLERANCE); each serve
                 with phase 3's assertions but 4 kernel launches per layer
                 (q, k, v, o) and the agreement with chunks of 1 printed,
                 not asserted (a chunk routes as one group, as in the
                 reference); then olmoe's decode step split as in phase 3
                 over one profiled step, without the guard's on/off runs
  9. train    -- training (ROADMAP A8) of full-width paper-llama2-7b at its
                 first 4 of 32 layers (TRAIN_LAYERS; the depth the card's
                 80 GB holds with f32 masters, m, v and gradients, 18 B a
                 parameter) on SyntheticLM from SEED, 2 x 2048 tokens a
                 step, AdamW (warmup 2, cosine to step 8), remat on: 8
                 steps with quant "none" and 8 with "qat" (m2xfp
                 fake-quant with the straight-through estimator), each
                 step's loss, grad_norm and lr finite (asserted; whether
                 the loss falls is printed) beside its time (CUDA events)
                 and the peak memory, no kernel launched (the reference's
                 training reaches none); the first 3 "none" steps run
                 twice and give the same bits; the none-trained model,
                 cast to its compute dtypes and packed m2xfp, served
                 through the engine with the codecs phase's traffic (phase
                 3's assertions), then loss_fn under serve on a held-out
                 2 x 2048 batch through the m2xfp kernel (7 launches a
                 layer, M = 4096), the kernel at M = 4096 on layer 0's wq
                 and its real operand against its plain version within
                 TOLERANCE, and the held-out losses under none, serve and
                 qat/mxfp4 printed (no inequality asserted); last, after
                 the timed work, one train step at full width and 1 layer
                 (B = 1, S = 64) under none and qat on the card against
                 the same step on the CPU (repro_torch.testing.train's
                 tolerances), and the card's loss with the layer dropped
                 outside the loss bound (the bound sees a wrong forward)
  10. serve   -- phase 3 with the mxfp4 codec, at 2 layers (MXFP4_LAYERS)
  11. bitmath -- the FP4/FP6 bit helpers of csrc/mx_bits.cuh on every code:
                 the quantize engine on a 4097-point sweep of [-8, 8] (every
                 FP4 and FP6 code, midpoint and saturation) and the W4A4 GEMM
                 against an identity weight on random X streams (every
                 top-1 code, tie and meta field), both equal to their plain
                 versions; and the two serve GEMMs' in-register weight decode
                 (identity x on random streams: every code, meta field and
                 scale byte 0-250, subnormal weights included) equal to the
                 plain decoders
  12. w4a4    -- the W4A4 datapath (quantize engine, then the fully packed
                 GEMM) through ``repro_torch.kernels`` for the seven
                 projections of one full-width paper-llama2-7b layer at M in
                 {1, 8, 64, 129, 2048}: streams byte-identical to the plain
                 packer, the GEMM within TOLERANCE of its plain version and
                 bit-equal to the serve GEMM on the same fake-quantized
                 activations (bit_equal_to_serve_gemm: one template, one
                 split plan, X decoded exactly into the serve GEMM's bf16
                 operand), rows bit-identical across M, a planted
                 activation-meta fault flagged at every shape, and times
                 beside bound, plain and library (the quantize engine's
                 share_of_bound at every point); then the launch floor (the
                 event time of torch.zeros(1)) and the quantize engine's
                 kernel-only time at M = 8 from torch.profiler
  13. flash   -- flash attention, 32 heads x hd 128 (one paper-llama2-7b
                 layer's prefill): causal at S = 512 and 2048, S = 2048 with
                 a 512 window, with softcap 50 on q scaled by 8 (so scores
                 reach the cap), and with the last 64 keys invalid and a
                 padded query row; within FLASH_TOLERANCE of its plain
                 version at the same block_k, four planted faults flagged
                 (scale, mask, value row, softcap), the padded row 0, and
                 times beside bound, plain and SDPA (causal and window)

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
import re
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
# The mxfp4 serve phase (an earlier path, same code as m2xfp's but the
# codec) runs at a quarter of the depth, and the guard phase (an earlier
# path) at half of it: with them at 16 and 32 layers and the variants
# phase the script took 1145.8 s of its 1200 s limit on a slow host (guard
# phase 304.9 s, mxfp4 77.9 s, variants 138.7 s; NVIDIA H100 80GB HBM3,
# 700.00 W). With the train phase, mxfp4 runs 2 layers (42.9 s at 8
# layers, 21.9-30.7 s at 4).
MXFP4_LAYERS = 2
GUARD_LAYERS = 16
# The packed-KV serve phase (an earlier path since the guard phase came)
# runs at a quarter of the depth: with it at full depth and the guard phase
# the script took 1170 s of its 1200 s limit (packed-KV phase 540 s, guard
# phase 233 s), and at 16 layers beside the codecs phase 1085.9 s on a slow
# host (packed-KV phase 283.6 s; NVIDIA H100 80GB HBM3, 700.00 W); then
# at 8 layers about 125 s; with the train phase at 2 (73.2-78.5 s at 4).
# Its first layers are the full-depth weights' first.
PACKED_KV_LAYERS = 2
# Guard phase traffic: 12 requests (more than the 8 slots, so a quarantined
# slot is reused), prompts drawn by SEED from 16..64 tokens, GUARD_TOKENS new
# tokens each, on the first GUARD_LAYERS of the serve phase's m2xfp weights.
GUARD_REQUESTS, GUARD_TOKENS, GUARD_PROMPTS = 12, 16, (16, 64)
RECOVERY_STEPS = 3                  # GuardConfig's default
# Codecs phase: the first CODEC_LAYERS layers; 8 requests (as many as the
# slots), prompts drawn by SEED from 16..64 tokens, 16 new tokens each.
# With the train phase at 4 layers (the phase 100.3-117.2 s at 8).
CODEC_LAYERS = 4
CODEC_TRAFFIC = (8, 16, (16, 64))           # requests, new tokens, prompts
CODEC_ACTS = [(8, 4096), (64, 11008)]
CODEC_WEIGHT_COLS = 512     # the CPU side of the Sg-EM search is slow at N
# Variants phase: (arch, layers, positions per page, prompt lengths), with
# the codecs phase's 8 requests and 16 new tokens. gemma2-9b's pages of 128
# positions hold fewer than its prompts, so its local ring (window 4096,
# min(4096, 128) positions) and its global ring both wrap, as the
# reference's engine allows for a sliding-window configuration.
# With the train phase qwen3-8b and gemma2-9b run 4 layers (2 local/global
# pairs; the phase 142.5-166.4 s at 8).
VARIANTS = [("qwen2-0.5b", 24, MAX_LEN, (16, 64)),
            ("qwen3-8b", 4, MAX_LEN, (16, 64)),
            ("gemma2-9b", 4, 128, (96, 160))]
# Families phase (ROADMAP A6c, A6d), full widths, m2xfp weights from SEED,
# bf16 KV. Embedding input runs at the model level (no engine serves it):
# (arch, layers), 8 slots x FAMILY_POSITIONS embeddings of std 1 from SEED
# through prefill chunks of CHUNK and through decode_step; each slot's
# valid positions are FAMILY_LENGTHS, so rows end inside a chunk or sit
# idle through later chunks. MoE through the engine with the codecs
# phase's traffic: (arch, layers); mixtral's experts stay dense bf16 (8
# experts: the reference packs experts only when E % 32 == 0), 4.83 GB a
# layer, so it runs its first 2 layers. The phase has 150 s: with
# musicgen-large at all 48 layers it took 235 s, and at 24 layers 185 s
# (olmoe's device-bound serves, its breakdown and the CPU side of its
# check 133 s of those), then 110.9 s at 16 layers with olmoe's breakdown
# cut to one profiled step and the MoE checks' CPU side beside the
# serves. That CPU side now runs after them, so that it takes no host
# time from the serves it would be measured beside (olmoe 21.9 s,
# mixtral 12.9 s; 159.0 s for the phase alone, musicgen 15.2 s of it;
# NVIDIA H100 80GB HBM3, 700.00 W), so musicgen runs its first 8 layers.
# With the train phase olmoe runs its first 8 of 16 (its device-bound
# serves; the phase 128.9-151.9 s at 16).
FAMILY_EMBED = [("musicgen-large", 8), ("pixtral-12b", 8)]
FAMILY_POSITIONS = 32
FAMILY_LENGTHS = (32, 30, 25, 20, 13, 8, 5, 1)
FAMILY_MOE = [("olmoe-1b-7b", 8), ("mixtral-8x22b", 2)]
# Train phase (ROADMAP A8): full-width paper-llama2-7b at its first
# TRAIN_LAYERS layers. Plain single-device AdamW holds f32 masters, m and v,
# f32 gradients and a bf16 compute copy: 18 B a parameter, 121 GB at 32
# layers (6.74 B parameters), 19.3 GB at 4 (1.072 B: 4 x 202,375,168 +
# 2 x 131,072,000), which leaves the card room for the activations of
# TRAIN_BATCH x TRAIN_SEQ tokens (two q tiles, four KV chunks a layer).
# TRAIN_REPEAT_STEPS "none" steps run twice (bit-identical); the card-vs-CPU
# step is (layers, batch, seq) TRAIN_CHECK.
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2, 2048, 8
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)
TRAIN_REPEAT_STEPS = 3
TRAIN_CHECK = (1, 1, 64)
# moe_apply on the card against the CPU: the routing bit for bit (router
# and softmax in float64 on both), the output within 2 bf16 ulps of the
# larger magnitude plus 2^-7 of the largest |output| (the expert products
# accumulate in f32 on the card, in float64 on the CPU, and each is
# rounded to bf16)
MOE_TOLERANCE = "2^-7 * (max(|card|, |cpu|) + max|cpu|)"
# Kernel vs plain: |diff| <= sqrt(K) * 2^-24 * (|x| @ |Wdec|). Every product
# is exact in f32 and the plain version rounds once, so the kernel's error
# is its K f32 roundings, which add as a random walk: sqrt(K) * 2^-24 of the
# sum of |terms| is their expected size, 1/(2 sqrt(K)) of the worst-case
# 2 K 2^-24. The planted-fault check shows a one-group error exceeds it.
TOLERANCE = "sqrt(K) * 2^-24 * (|x| @ |Wdec|)"
LIBRARY = ("yardstick only, never called by the port: torch.matmul of the "
           "same bf16 x with the decoded bf16 weight, which reads 2 bytes "
           "per weight (3.56x m2xfp's, 3.76x mxfp4's)")
INT8_OPS = 1979e12                  # dense int8 tensor-core peak
# W4A4: one paper-llama2-7b layer's projections (q, k, v, o, gate, up, down)
W4A4_PROJS = [(4096, 4096)] * 4 + [(4096, 11008)] * 2 + [(11008, 4096)]
W4A4_MS = [1, 8, 64, 129, 2048]
W4A4_TOLERANCE = "sqrt(K) * 2^-24 * (|Xdec| @ |Wdec|)"
W4A4_LIBRARY = ("yardstick only, never called by the port: torch.matmul of "
                "the decoded bf16 X and W, which reads 2 bytes per element "
                "of each")
QUANT_LIBRARY = ("none: no single PyTorch call computes the Elem-EM-top1 "
                 "encode (scale, RTNE FP4, top-1, FP6 refine, pack)")
# Flash: 32 heads x hd 128, bf16 q/k/v; the reference kernel's KV block.
FLASH_BH, FLASH_HD = 32, 128
# (case, S, options, factor on q): the softcap case scales q by 8, so that
# the scores (then about N(0, 64)) reach the cap of 50.
FLASH_CASES = [("causal", 512, {}, 1.0), ("causal", 2048, {}, 1.0),
               ("window_512", 2048, {"window": 512}, 1.0),
               ("softcap_50_q_x8", 2048, {"softcap": 50.0}, 8.0),
               ("last_64_keys_invalid", 2048, {}, 1.0)]
# The bound of ref.flash_attention_tolerance: the f32 roundings of another
# summation order and of exp/tanh, plus every probability that can round to
# the neighbouring bf16 value under them, at its full width. Each case must
# also flag four planted faults: a 2% scale error (q * 1.02), a mask off by
# one key (pos_q + 1), one key's value row changed, and, in the softcap
# case, the kernel run without its softcap.
FLASH_TOLERANCE = "ref.flash_attention_tolerance (flip-aware f32 bound)"
FLASH_SCALE_FAULT = 1.02
FLASH_LIBRARY = ("yardstick only, never called by the port: "
                 "torch.nn.functional.scaled_dot_product_attention on the "
                 "bf16 q/k/v as (1, BH, S, hd), is_causal=True in the causal "
                 "cases and a boolean attn_mask of the valid pairs in the "
                 "window case; none for the softcap and invalid-key cases")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


class Timer:
    """Median CUDA-event time of a call, with a 256 MB buffer zeroed before
    each (so the 50 MB L2 holds none of its operands):
    repro_torch.kernels.quantize_probe.event_ms."""

    def __init__(self, device):
        self.flush_buf = torch.empty(256 << 20, dtype=torch.uint8,
                                     device=device)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        from repro_torch.kernels.quantize_probe import event_ms
        return event_ms(fn, self.flush_buf, iters, warmup)


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


def kernel_vs_plain(label: str, kern, wp: dict, wdec, plain, x, m: int):
    """``kern`` on the first ``m`` rows of ``x`` against ``plain`` on the
    same rows, within TOLERANCE (``wdec`` the decoded weight). Returns
    (the rows, the kernel's output, the tolerance, the largest ratio of
    the difference to it, the largest absolute difference)."""
    from repro_torch.kernels import ref
    xm = x[:m].contiguous()
    got = kern(xm, wp)
    want = plain(xm, wp)
    torch.cuda.synchronize()
    tol = xm.shape[1] ** 0.5 * 2.0 ** -24 * ref.dot_f64acc(xm.abs(),
                                                           wdec.abs())
    diff = (got - want).abs()
    if bool((diff > tol).any()):
        raise AssertionError(f"{label} M={m}: kernel outside {TOLERANCE} "
                             f"of its plain version")
    return (xm, got, tol, float((diff / tol.clamp_min(1e-38)).max()),
            float(diff.max()))


def assert_rows_independent(label: str, outs: dict, pairs) -> None:
    """For each (small, big) of ``pairs``, the kernel's rows of M = small
    are bit-equal to the first rows of M = big (``outs``: M -> output)."""
    for small, big in pairs:
        if not torch.equal(outs[small], outs[big][:small]):
            raise AssertionError(f"{label}: rows of M={small} differ from "
                                 f"the same rows of M={big}")


def kernel_phase(timer, gen, device):
    from repro_torch.kernels import _build, layout, ref
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
                xm, got, tol, ratio, err = kernel_vs_plain(
                    f"{name} K={k} N={n}", kern, wp, wdec, plain, x, m)
                max_err = max(max_err, err)
                outs[m] = got
                if not torch.equal(kern(xm, wp), got):
                    raise AssertionError(f"{name} K={k} N={n} M={m}: two "
                                         f"calls gave different bits")
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
                     max_abs_err=err, **fault, deterministic=True,
                     split_k=_build.split_k(k, n), workspace_bytes=0,
                     kernel_ms=t_k, plain_ms=t_p, library_ms=t_l,
                     library=LIBRARY,
                     bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                     share_of_bound=b_ms / t_k, launches=kern.launches)
                if m == 8:
                    bound_by.add(b_by)
                    reps = LAYER_GEMMS[(k, n)]
                    for key, t in (("ms", t_k), ("plain_ms", t_p),
                                   ("bound_ms", b_ms), ("library_ms", t_l)):
                        agg[key] += reps * t
            assert_rows_independent(
                f"{name} K={k} N={n}", outs,
                [(small, big) for small in (1, 8) for big in (64, 129)])
            emit("kernels", kernel=name, K=k, N=n, row_independent=True)
            del wp, wdec, wdec16, x, outs
        summary[name] = dict(
            name=name, route="cuda", source=str(kern.source.relative_to(ROOT)),
            replaces=replaces, max_abs_err=max_err,
            bound_by="bytes" if bound_by == {"bytes"} else "operations",
            measured_over="the 7 projections of one paper-llama2-7b layer "
                          "at M=8 (sum)", library=LIBRARY, **agg)
    return summary


def kv_cache_bytes(caches) -> int:
    """Bytes of the K and V pages of every layer (bf16 or packed streams;
    the position tracks not counted)."""
    return sum(t.nbytes for c in caches["layers"] for kv in ("k", "v")
               for t in (c[kv].values() if isinstance(c[kv], dict)
                         else [c[kv]]))


def serve_phase(codec: str, device, kern, kernels, kv_quant="none",
                layers=LAYERS, bf16_kv=None, params=None,
                traffic=(REQUESTS, TOKENS, (16, 128)),
                arch="paper-llama2-7b", max_len=MAX_LEN):
    """Serve ``traffic`` (requests, new tokens each, prompt lengths drawn
    by SEED from the range) through the port's engine (its guard on, as
    by default) on the first ``layers`` layers of ``arch`` with pages of
    ``max_len`` positions, with a bf16 KV cache or one packed in
    ``kv_quant``. Every launch counter is zeroed just before the run and
    read just after;
    ``kern`` must have run 7 times per layer per engine launch (4 for a
    mixture-of-experts model: q, k, v and o; the experts take no kernel)
    and every other kernel not at all (``kern`` None: no kernel at all),
    and the guard must have stayed healthy with nothing quarantined,
    scrubbed or retried. The same traffic served with prefill chunks of 1
    must give the same tokens where the codec's activation quantization is
    batch-invariant and the model has no experts (else the agreement is
    printed only: a chunk's tokens route as one group, whose capacity
    drops other tokens than a decode step's, as in the reference). ``bf16_kv``: the
    bf16-KV phase's result with the same weights, which a packed-KV phase
    prints beside its own. ``params``: weights an earlier phase packed from
    SEED (else packed here). Returns (engine, launches of ``kern``, the
    phase's result: tokens, peak and cache bytes)."""
    from repro_torch.configs import get_config
    from repro_torch.core.codecs import get_codec
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.prequant import init_packed_params
    cfg = get_config(arch, quant="serve", quant_format=codec,
                     kv_quant=kv_quant, n_layers=layers)
    n_requests, n_tokens, (lo, hi) = traffic
    pack_s = None
    if params is None:
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(SEED)
        params = init_packed_params(gen, cfg, device)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in rng.choice(np.arange(lo, hi + 1), n_requests)]

    def finite_greedy(logits):
        if not np.isfinite(logits).all():
            raise AssertionError(f"{codec}: non-finite logits")
        return np.argmax(logits, axis=-1)

    def run(chunk):
        eng = ServeEngine(params, cfg, n_slots=N_SLOTS, max_len=max_len,
                          prefill_chunk=chunk, sample_fn=finite_greedy,
                          device=device)
        outs = eng.generate(prompts, n_tokens)
        torch.cuda.synchronize()
        g = eng.guard_summary()
        if g["state"] != "healthy" or g["quarantines"] or g["scrubs"] \
                or g["retries"]:
            raise AssertionError(f"{codec}: the guard saw faults: {g}")
        return eng, outs

    torch.cuda.reset_peak_memory_stats()
    for k in kernels:                     # the path's counts start here
        k.launches = 0
    eng, outs = run(CHUNK)
    launches = kern.launches if kern is not None else 0
    others = {k.name: k.launches for k in kernels if k is not kern}
    if any(others.values()):
        raise AssertionError(f"{codec} path launched {others}")
    per_layer = 4 if cfg.is_moe else 7
    expected = per_layer * layers * eng.stats.steps if kern is not None \
        else 0
    if launches != expected:
        raise AssertionError(
            f"{codec}: {launches} kernel launches, expected {per_layer} x "
            f"{layers} layers x {eng.stats.steps} engine launches")
    if len(eng.scheduler.finished) != len(prompts) or any(
            len(o) != n_tokens for o in outs):
        raise AssertionError(f"{codec}: not every request completed")
    peak = torch.cuda.max_memory_allocated()
    _, outs1 = run(1)
    same = sum(a == b for o, o1 in zip(outs, outs1) for a, b in zip(o, o1))
    batch_invariant = get_codec(codec).act_batch_invariant \
        and not cfg.is_moe
    if batch_invariant and same != len(prompts) * n_tokens:
        raise AssertionError(
            f"{codec}: prefill chunks of {CHUNK} and of 1 gave different "
            f"tokens ({same} of {len(prompts) * n_tokens} agree)")
    st = eng.stats
    result = dict(outs=outs, peak_memory_bytes=peak, layers=layers,
                  kv_cache_bytes=kv_cache_bytes(eng.caches))
    vs_bf16 = {}
    if bf16_kv is not None:
        # every layer's pages have the same bytes, so the bf16 phase's
        # pages at this depth are its pages times layers / its layers
        bf16_pages = bf16_kv["kv_cache_bytes"] * layers // bf16_kv["layers"]
        vs_bf16 = dict(bf16_kv_cache_bytes_same_depth=bf16_pages,
                       kv_cache_ratio=bf16_pages / result["kv_cache_bytes"])
        if layers == bf16_kv["layers"]:
            agree = sum(a == b for o, o1 in zip(outs, bf16_kv["outs"])
                        for a, b in zip(o, o1))
            vs_bf16.update(
                bf16_kv_peak_memory_bytes=bf16_kv["peak_memory_bytes"],
                peak_memory_saved_bytes=bf16_kv["peak_memory_bytes"] - peak,
                token_agreement_vs_bf16_kv=agree / (len(prompts) * n_tokens))
    emit("serve", codec=codec, kv_quant=kv_quant, model=cfg.name,
         layers=layers,
         d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         n_slots=N_SLOTS, max_len=max_len, prefill_chunk=CHUNK,
         requests=len(prompts), tokens_out=st.generated_tokens,
         prefill_tokens=st.prefill_tokens, steps=st.steps,
         decode_steps=st.decode_steps, prefill_steps=st.prefill_steps,
         decode_tokens_per_s=st.decode_tokens_per_sec,
         prefill_tokens_per_s=st.prefill_tokens_per_sec,
         decode_step_ms=1e3 * st.decode_wall_s / max(st.decode_steps, 1),
         wall_s=st.wall_s, mean_ttft_steps=eng.mean_ttft_steps(),
         occupancy=st.occupancy, peak_mem_gb=peak / 2 ** 30,
         peak_memory_bytes=peak, kv_cache_bytes=result["kv_cache_bytes"],
         **vs_bf16,
         init_and_pack_s=pack_s, guard=eng.guard_summary(),
         kernel=kern.name if kern is not None else None, launches=launches,
         launches_expected=expected,
         token_agreement_vs_chunk1=same / (len(prompts) * n_tokens),
         token_agreement_asserted=batch_invariant)
    return eng, launches, result


def gemm_kernel_names(kern) -> list:
    """Every device kernel in the library of the dequant-GEMM ``kern`` (the
    "Function" entries of ``cuobjdump -sass``), so every kernel any of its
    calls can launch. Raises unless each carries "dequant_gemm", the filter
    by which decode_breakdown counts the GEMM's device time."""
    from repro_torch.kernels import _build
    lib = _build.BUILD_DIR / f"lib{kern.name}.so"
    sass = subprocess.run(
        [str(Path(_build.nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
        check=True, capture_output=True, text=True).stdout
    names = sorted(set(re.findall(r"Function : (\S+)", sass)))
    escaped = [k for k in names if "dequant_gemm" not in k]
    if not names or escaped:
        raise AssertionError(f"{lib.name} holds kernels {names}; not counted "
                             f"as the packed GEMM: {escaped}")
    return names


def decode_breakdown(eng, device, kern, steps: int = 3, guard: bool = True):
    """Wall time of an all-slots decode step (host clock, synchronized, no
    profiler), then its device time by kernel from torch.profiler over as
    many more steps. The idle share is ``1 - device / wall`` unclipped; a
    device time above either run's wall means events were counted twice,
    and raises. The packed GEMM's time is that of every kernel whose name
    carries "dequant_gemm"; gemm_kernel_names checks first that ``kern``'s
    library holds no other. ``kern`` None (a codec served through its
    decode): every kernel whose name carries "gemm". ``guard``: also the
    engine's decode launch with its guard on and off (guard_cost)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.model import decode_step
    b = eng.n_slots
    # a codec without a kernel (nvfp4) multiplies with cuBLAS: its GEMM
    # time is that of every kernel named "gemm" (the LM head's included)
    names = gemm_kernel_names(kern) if kern is not None else []
    tag = "dequant_gemm" if kern is not None else "gemm"
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
    gemm = sum(v for k, v in by_name.items() if tag in k.lower())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    idle = 1 - total / (wall * 1e3)
    if idle < 0 or total > wall_profiled * 1e3:
        raise AssertionError(
            f"device time {total} ms per step exceeds the wall time "
            f"({wall * 1e3} ms, {wall_profiled * 1e3} ms profiled)")
    emit("decode_breakdown", model=eng.cfg.name,
         codec=eng.cfg.quant_format, kv_quant=eng.cfg.kv_quant,
         layers=eng.cfg.n_layers, slots=b,
         wall_ms=wall * 1e3, profiled_wall_ms=wall_profiled * 1e3,
         device_ms=total, packed_gemm_ms=gemm, gemm_name_filter=tag,
         other_device_ms=total - gemm, device_idle_share=idle,
         gemm_kernel_names=names,
         top_kernels_ms={k[:80]: v for k, v in top},
         **(guard_cost(eng, device) if guard else {}))


def _device_ms(prof, steps: int) -> float:
    """Device-side kernel time per step of a torch.profiler run."""
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / steps


def guard_cost(eng, device, steps: int = 2) -> dict:
    """The engine's all-slots decode launch (the model, then the sampled
    rows to the host) with its guard on, against the same launch of a
    guard=False engine on the same weights and caches: wall ms per step
    (host clock, median of three alternating runs, no profiler) and device
    ms per step (torch.profiler), and the differences. The sentinels must
    flag nothing."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import ServeEngine
    off = ServeEngine(eng.params, eng.cfg, n_slots=eng.n_slots,
                      max_len=eng.max_len, guard=False, device=device)
    off.caches = eng.caches
    engines = {"on": eng, "off": off}
    for e in engines.values():
        e._index[:] = 128
        e._tokens[:] = 0

    def run(e):
        for _ in range(steps):
            e._launch_decode({})          # ends in the copy to the host

    walls = {k: [] for k in engines}
    for e in engines.values():
        run(e)
    for _ in range(3):
        for k, e in engines.items():
            t0 = time.perf_counter()
            run(e)
            walls[k].append((time.perf_counter() - t0) / steps * 1e3)
    dev = {}
    for k, e in engines.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(e)
        dev[k] = _device_ms(prof, steps)
    flagged = {site: int(c.sum()) for site, c in eng.guard.drain().items()}
    if any(flagged.values()):
        raise AssertionError(f"the sentinels flagged clean decode steps: "
                             f"{flagged}")
    wall = {k: statistics.median(v) for k, v in walls.items()}
    return dict(guard_on_wall_ms=wall["on"], guard_off_wall_ms=wall["off"],
                guard_wall_ms_delta=wall["on"] - wall["off"],
                guard_on_device_ms=dev["on"], guard_off_device_ms=dev["off"],
                guard_device_ms_delta=dev["on"] - dev["off"])


def _slot_scrubbed(caches, slot: int) -> bool:
    """True if ``slot``'s rows of every layer's cache are in the init
    state: position track -1, bf16 pages or packed streams all zero."""
    flags = []
    for layer in caches["layers"]:
        flags.append((layer["pos"][slot] != -1).any())
        for name in ("k", "v"):
            page = layer[name]
            for t in (page.values() if isinstance(page, dict) else [page]):
                flags.append((t[slot] != 0).any())
    return not bool(torch.stack(flags).any())


def _guard_run(params, cfg, prompts, device, guard=None, plan=None,
               scrub_at=None):
    """Serve ``prompts`` through one engine step by step, under ``plan``
    (a FaultPlan) if given. Records per launch (keyed on the engine's step
    counter) which request held which slot, whether it was a decode launch
    and how many requests waited; per step its wall seconds and the health
    after it; and, right after each step of ``scrub_at`` ({step: slot}),
    whether that slot was back in its init state."""
    from repro_torch.serve import ServeEngine
    from repro_torch.testing import FaultInjector
    eng = ServeEngine(params, cfg, n_slots=N_SLOTS, max_len=MAX_LEN,
                      prefill_chunk=CHUNK, guard=guard, device=device)
    reqs = [eng.submit(p, GUARD_TOKENS) for p in prompts]
    log = {}

    def recorded(fn, decode):
        def launch(*args):
            log[eng.stats.steps] = (
                {slot: r.rid for slot, r in eng.scheduler.active.items()},
                decode, len(eng.scheduler.queue))
            return fn(*args)
        return launch

    eng._step = recorded(eng._step, True)
    eng._prefill = recorded(eng._prefill, False)
    inj = FaultInjector(eng, plan).install() if plan is not None else None
    dts, health, scrubbed = [], [], {}
    t_run = time.perf_counter()
    while eng.scheduler.has_work:
        step = eng.stats.steps
        t0 = time.perf_counter()
        eng.step()
        dts.append(time.perf_counter() - t0)
        health.append(eng.health)
        if scrub_at and step in scrub_at:
            scrubbed[step] = _slot_scrubbed(eng.caches, scrub_at[step])
    torch.cuda.synchronize()
    return dict(eng=eng, reqs=reqs, log=log, dts=dts, health=health,
                scrubbed=scrubbed, wall_s=time.perf_counter() - t_run,
                fired=sorted(inj.fired) if inj else [])


def _plan_faults(log, n_steps: int):
    """Fault steps and slots chosen from a fault-free run's launch log:
    the NaN logits at the first decode launch with every slot busy and
    requests waiting (so the freed slot is reused), in slot 2; the KV
    poison 3 launches later in a slot whose request is the same at both
    launches; then a transient failure and a delay past the watchdog, 2
    and 4 launches after that; the health must recover before the end."""
    t_nan = next((t for t in sorted(log) if t >= 2 and log[t][1]
                  and len(log[t][0]) == N_SLOTS and log[t][2] > 0), None)
    if t_nan is None:
        raise AssertionError("guard traffic: no decode launch with every "
                             "slot busy and requests waiting")
    s_nan, t_kv = 2, t_nan + 3
    s_kv = next((s for s in (5, 6, 7, 0, 1, 3, 4)
                 if log.get(t_kv, ({}, 0, 0))[0].get(s) is not None
                 and log[t_kv][0][s] == log[t_nan][0].get(s)), None)
    if s_kv is None:
        raise AssertionError("guard traffic: no slot keeps its request "
                             f"from launch {t_nan} to {t_kv}")
    t_fail, t_delay = t_kv + 2, t_kv + 4
    if t_delay + RECOVERY_STEPS >= n_steps:
        raise AssertionError("guard traffic: too few launches to recover")
    return t_nan, s_nan, t_kv, s_kv, t_fail, t_delay


def guard_phase(params, device, kern, kernels) -> int:
    """The serving guard at full width on the first GUARD_LAYERS layers of
    the m2xfp weights ``params`` from phase 3, with a bf16 and an
    m2xfp-packed KV cache: the traffic
    fault-free with the guard on (equal to guard=False), then under a
    FaultPlan (NaN logits, a poisoned KV page, a transient failure, a delay
    past the armed watchdog): exactly the planned slots' requests are
    quarantined, every other request keeps its fault-free tokens, the
    scrubbed pages read zero, the health recovers. Launch counts are zeroed
    just before each faulted run and read just after. Then packed-stream
    validation of the weights and a repair by clamp. Returns the faulted
    runs' launches of ``kern``."""
    from repro_torch.configs import get_config
    from repro_torch.core.codecs import PackedTensor, validate_packed_tree
    from repro_torch.serve import GuardConfig, verify_packed_tree
    from repro_torch.testing import FaultPlan
    params = dict(params, layers=params["layers"][:GUARD_LAYERS])
    rng = np.random.default_rng(SEED)
    lo, hi = GUARD_PROMPTS
    vocab = get_config("paper-llama2-7b").vocab_size
    prompts = [list(map(int, rng.integers(0, vocab, n)))
               for n in rng.choice(np.arange(lo, hi + 1), GUARD_REQUESTS)]
    total_launches = 0
    for kv_quant in ("none", "m2xfp"):
        cfg = get_config("paper-llama2-7b", quant="serve",
                         quant_format="m2xfp", kv_quant=kv_quant,
                         n_layers=GUARD_LAYERS)
        clean = _guard_run(params, cfg, prompts, device)
        off = _guard_run(params, cfg, prompts, device, guard=False)
        outs = [r.output for r in clean["reqs"]]
        if [r.output for r in off["reqs"]] != outs:
            raise AssertionError(f"guard kv={kv_quant}: guard=False gave "
                                 f"other tokens than the guard")
        t_nan, s_nan, t_kv, s_kv, t_fail, t_delay = _plan_faults(
            clean["log"], len(clean["dts"]))
        watchdog = 2 * max(clean["dts"]) + 0.5
        delay = 1.25 * watchdog
        plan = FaultPlan(seed=SEED, nan_logit_steps=((t_nan, s_nan),),
                         kv_poison_steps=((t_kv, s_kv),),
                         fail_steps=(t_fail,),
                         delay_steps=((t_delay, delay),))
        for k in kernels:                 # the path's counts start here
            k.launches = 0
        run = _guard_run(params, cfg, prompts, device,
                         guard=GuardConfig(watchdog_s=watchdog), plan=plan,
                         scrub_at={t_nan: s_nan, t_kv: s_kv})
        eng, reqs, log = run["eng"], run["reqs"], run["log"]
        launches = kern.launches
        others = {k.name: k.launches for k in kernels if k is not kern}
        total_launches += launches
        want = {log[t_nan][0][s_nan]: "logits", log[t_kv][0][s_kv]: "kv"}
        got = {r.rid: r.fail_reason for r in reqs
               if r.state == "quarantined"}
        survivors = [r for r in reqs if r.rid not in want]
        reused = sorted({log[t][0][s] for t in log for s in (s_nan, s_kv)
                         if t > (t_nan if s == s_nan else t_kv)
                         and s in log[t][0]})
        g = eng.guard_summary()
        h = run["health"]
        checks = {
            "fired": len(run["fired"]) == 4,
            "quarantined": got == want,
            "survivors_bit_identical": all(
                r.state == "finished" and r.output == outs[r.rid]
                for r in survivors),
            "scrubbed_slot_reused": bool(reused),
            "scrubbed_pages_zero": run["scrubbed"] == {t_nan: True,
                                                       t_kv: True},
            "summary": (g["quarantines"], g["retries"], g["watchdog_trips"],
                        g["scrubs"], g["state"]) == (2, 1, 1, 0, "healthy"),
            "recovery": (set(h[:t_nan]) == {"healthy"}
                         and set(h[t_nan:t_delay + RECOVERY_STEPS])
                         == {"degraded"}
                         and h[t_delay + RECOVERY_STEPS] == "healthy"),
            "launches": (launches == 7 * GUARD_LAYERS * eng.stats.steps
                         and not any(others.values())),
        }
        emit("guard", kv_quant=kv_quant, layers=GUARD_LAYERS,
             requests=len(reqs),
             n_slots=N_SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
             new_tokens=GUARD_TOKENS, plan=plan.describe(),
             watchdog_s=watchdog, delay_s=delay, fired=run["fired"],
             quarantined={str(k): v for k, v in got.items()},
             expected_quarantined={str(k): v for k, v in want.items()},
             reused_scrubbed_slot_by=reused, survivors=len(survivors),
             guard=g, health_trace="".join(x[0] for x in h),
             steps=eng.stats.steps, clean_steps=len(clean["dts"]),
             max_clean_step_ms=1e3 * max(clean["dts"]),
             wall_s={"guard_on": clean["wall_s"], "guard_off": off["wall_s"],
                     "faulted": run["wall_s"]},
             kernel=kern.name, launches=launches,
             launches_expected=7 * GUARD_LAYERS * eng.stats.steps,
             checks=checks)
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"guard kv={kv_quant}: checks failed: "
                                 f"{failed}")
        del clean, off, run, eng
        gc.collect()
        torch.cuda.empty_cache()

    # Packed-stream validation of the full-width weights, then a planted
    # scale byte 255 in one layer's wq, repaired by clamp (no dense source
    # weights here: re-quantization is covered by the CPU tests).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    intact = validate_packed_tree(params)
    validate_ms = (time.perf_counter() - t0) * 1e3
    if intact:
        raise AssertionError(f"intact weights reported: {intact}")
    layer = 17 % GUARD_LAYERS
    wq = params["layers"][layer]["attn"]["wq"]
    at = tuple(i % n for i, n in zip((3, 100), wq.streams["scales"].shape))
    bad_scales = wq.streams["scales"].clone()
    bad_scales[at] = 255
    bad = dict(params, layers=list(params["layers"]))
    bad["layers"][layer] = dict(params["layers"][layer], attn=dict(
        params["layers"][layer]["attn"], wq=PackedTensor(
            {**wq.streams, "scales": bad_scales}, wq.shape, wq.codec)))
    report = validate_packed_tree(bad)
    want = {"layers/attn/wq": [
        f"1 scale byte(s) outside the legal e8m0 range [1, 254] (first at "
        f"index ({layer}, {at[0]}, {at[1]}), byte 255)"]}
    fixed, repairs = verify_packed_tree(bad)
    expect = wq.streams["scales"].clone()
    expect[at] = 254
    repaired = torch.equal(fixed["layers"][layer]["attn"]["wq"]
                           .streams["scales"], expect) and all(
        torch.equal(fixed["layers"][i]["attn"]["wq"].streams["scales"],
                    params["layers"][i]["attn"]["wq"].streams["scales"])
        for i in range(GUARD_LAYERS) if i != layer)
    emit("guard", check="weights", layers=GUARD_LAYERS,
         validate_ms=validate_ms,
         intact_report=intact, planted=f"layer {layer} wq scales{at} = 255",
         report=report, repairs=repairs, repaired_bytes_equal=repaired,
         report_after_repair=validate_packed_tree(fixed))
    if report != want or repairs != [("layers/attn/wq", "clamp")] \
            or not repaired or validate_packed_tree(fixed):
        raise AssertionError("guard: the planted weight byte was not "
                             "reported or repaired as expected")
    return total_launches


def _heavy_tailed(rng, shape, ch_sigma=0.8) -> np.ndarray:
    """LLM-like tensor: student-t entries with per-channel log-normal
    scales (the CPU tests' ``heavy_tailed``)."""
    t = rng.standard_t(df=4.0, size=shape).astype(np.float32)
    ch = np.exp(ch_sigma * rng.standard_normal((1, shape[-1])))
    return t * ch.astype(np.float32)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape and bytes (a on any device, b on the CPU)."""
    a = a.detach().cpu().contiguous()
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.uint8), b.contiguous().view(torch.uint8))


def _log2_edges() -> np.ndarray:
    """Group maxima where a rounded log2 flips: b sqrt(2) 2^k and b 2^k for
    b in {3, 4, 6}, k in -110..110, with their nextafter neighbours."""
    ks = np.arange(-110, 111, dtype=np.float64)
    c = np.concatenate([np.float32(b * f * 2 ** ks) for b in (3.0, 4.0, 6.0)
                        for f in (1.0, 2 ** 0.5)])
    return np.concatenate([c, np.nextafter(c, np.float32(np.inf)),
                           np.nextafter(c, np.float32(0))]).astype(np.float32)


def codec_bit_identity(gen, device):
    """Every codec's fake-quant, the scale rules and pack_w_nvfp4 on the
    card against the same calls on the CPU, bit for bit. Returns the
    full-width dense projection (4096, 11008) bf16 it drew."""
    from repro_torch.core.codecs import list_codecs
    from repro_torch.core.formats import quantize_mxfp4, quantize_smx4
    from repro_torch.core.m2xfp import quantize_act_m2xfp
    from repro_torch.core.scaling import SCALE_RULES, shared_scale_exponent
    from repro_torch.kernels.layout import pack_w_nvfp4
    from repro_torch.models.quant import (fake_quant_act, fake_quant_weight,
                                          init_linear)
    rng = np.random.default_rng(SEED)
    acts = [torch.from_numpy(_heavy_tailed(rng, shape, ch_sigma=2.0))
            for shape in CODEC_ACTS]
    w = init_linear(gen, 4096, 11008, device)
    w_slice = w[:, :CODEC_WEIGHT_COLS].float()
    w_slice_cpu = w_slice.cpu()
    for name in list_codecs():
        t0 = time.perf_counter()
        act_equal = [_same_bits(fake_quant_act(x.to(device), name),
                                fake_quant_act(x, name)) for x in acts]
        weight_equal = _same_bits(fake_quant_weight(w_slice, name),
                                  fake_quant_weight(w_slice_cpu, name))
        emit("codecs", check="bit_identity", codec=name,
             act_shapes=CODEC_ACTS, act_equal=act_equal,
             weight_shape=[4096, CODEC_WEIGHT_COLS],
             weight_equal=weight_equal,
             seconds=time.perf_counter() - t0)
        if not (all(act_equal) and weight_equal):
            raise AssertionError(f"{name}: fake-quant on the card differs "
                                 f"from the CPU's")
    edges = torch.from_numpy(_log2_edges())
    x = acts[1]
    groups = torch.zeros(edges.numel(), 16)
    groups[:, 0], groups[:, 2] = edges, edges / 3
    smx4_equal = _same_bits(quantize_smx4(groups.to(device)),
                            quantize_smx4(groups))
    for rule in SCALE_RULES:
        checks = dict(
            edge_exponents=_same_bits(
                shared_scale_exponent(edges.to(device), rule),
                shared_scale_exponent(edges, rule)),
            mxfp4=_same_bits(quantize_mxfp4(x.to(device), rule=rule),
                             quantize_mxfp4(x, rule=rule)),
            act_m2xfp=_same_bits(quantize_act_m2xfp(x.to(device), rule=rule),
                                 quantize_act_m2xfp(x, rule=rule)))
        emit("codecs", check="scale_rule", rule=rule,
             edge_points=edges.numel(), act_shape=list(x.shape), **checks)
        if not all(checks.values()):
            raise AssertionError(f"scale rule {rule}: {checks}")
    emit("codecs", check="smx4_log2_edges", edge_points=edges.numel(),
         equal=smx4_equal)
    if not smx4_equal:
        raise AssertionError("smx4 at the log2 edges differs on the card")
    t0 = time.perf_counter()
    got = pack_w_nvfp4(w.float())
    want = pack_w_nvfp4(w.float().cpu())
    equal = {k: _same_bits(got[k], want[k]) for k in want}
    emit("codecs", check="pack_w_nvfp4", shape=list(w.shape),
         streams={k: [list(v.shape), str(v.dtype)] for k, v in want.items()},
         equal=equal, tscale=float(want["tscale"]),
         seconds=time.perf_counter() - t0)
    if not all(equal.values()):
        raise AssertionError(f"pack_w_nvfp4 on the card: {equal}")
    return w


def _retag(params: dict, codec: str, layers: int) -> dict:
    """The first ``layers`` layers of ``params`` with every packed weight's
    codec tag set to ``codec`` (the same stream tensors)."""
    from repro_torch.core.codecs import PackedTensor

    def tag(node):
        if isinstance(node, PackedTensor):
            return PackedTensor(node.streams, node.shape, codec)
        if isinstance(node, dict):
            return {k: tag(v) for k, v in node.items()}
        return node
    return dict(params, layers=[tag(lp) for lp in params["layers"][:layers]])


def _packed_bytes(params: dict) -> int:
    from repro_torch.core.codecs import PackedTensor
    total = 0
    for lp in params["layers"]:
        for part in lp.values():
            if isinstance(part, dict):
                total += sum(t.nbytes for p in part.values()
                             if isinstance(p, PackedTensor)
                             for t in p.streams.values())
    return total


def nvfp4_layer_cost(timer, params: dict, m: int) -> dict:
    """Device ms of one layer's nvfp4 serve GEMMs at M rows, split into the
    decode of the seven packed weights to f32 and the seven f32 GEMMs
    (CUDA events, L2 flushed before each)."""
    from repro_torch.models.numerics import dot_f32acc
    from repro_torch.models.quant import decode_serving_weight
    lp = params["layers"][0]
    weights = [lp[part][name] for part, names in (
        ("attn", ("wq", "wk", "wv", "wo")), ("ffn", ("gate", "up", "down")))
        for name in names]
    decoded = [decode_serving_weight(p) for p in weights]
    xs = [torch.randn(m, p.shape[0], device=decoded[0].device).to(
        torch.bfloat16).float() for p in weights]
    decode_ms = timer(lambda: [decode_serving_weight(p) for p in weights])
    gemm_ms = timer(lambda: [dot_f32acc(x, wd)
                             for x, wd in zip(xs, decoded)])
    return dict(rows=m, decode_ms_per_layer=decode_ms,
                f32_gemm_ms_per_layer=gemm_ms)


def codecs_phase(params, timer, gen, device, kern, kernels) -> int:
    """Bit identity of the codec matrix, card against CPU; then serving
    m2xfp_ideal6 (``params``: phase 3's m2xfp weights, re-tagged) through
    ``kern`` and nvfp4 (packed here from SEED) through its decode, on the
    first CODEC_LAYERS layers. Returns the m2xfp_ideal6 run's launches of
    ``kern``."""
    from repro_torch.models.quant import pack_serving_weight
    t0 = time.perf_counter()
    w = codec_bit_identity(gen, device)
    lap_s = time.perf_counter() - t0
    a = pack_serving_weight(w, "m2xfp")
    b = pack_serving_weight(w, "m2xfp_ideal6")
    same = {k: torch.equal(a.streams[k], b.streams[k]) for k in a.streams}
    emit("codecs", check="ideal6_weights_are_m2xfp_bytes",
         shape=list(w.shape), equal=same)
    if not all(same.values()) or sorted(a.streams) != sorted(b.streams):
        raise AssertionError(f"m2xfp_ideal6 packs other bytes: {same}")
    del w, a, b
    ideal = _retag(params, "m2xfp_ideal6", CODEC_LAYERS)
    eng, launches, _ = serve_phase(
        "m2xfp_ideal6", device, kern, kernels, layers=CODEC_LAYERS,
        params=ideal, traffic=CODEC_TRAFFIC)
    decode_breakdown(eng, device, kern)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng, _, _ = serve_phase("nvfp4", device, None, kernels,
                            layers=CODEC_LAYERS, traffic=CODEC_TRAFFIC)
    decode_breakdown(eng, device, None)
    emit("codecs", check="nvfp4_weights", layers=CODEC_LAYERS,
         packed_weight_bytes=_packed_bytes(eng.params),
         m2xfp_packed_weight_bytes_same_depth=_packed_bytes(ideal),
         **nvfp4_layer_cost(timer, eng.params, N_SLOTS),
         bit_identity_s=lap_s)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def variant_gemm_check(timer, name: str, params: dict, kern, device,
                       phase: str = "variants"):
    """``kern`` on the distinct projection shapes of layer 0 of ``params``
    (a packed model; its 2-D packed weights, so not packed (K, E, N)
    experts, which no kernel multiplies), x random bf16 at M = 8 and 64:
    kernel_vs_plain, assert_rows_independent, the split plan and the event
    time at M = 8 beside the bound, printed as ``phase`` lines. These
    launches are not counted as the path's."""
    from repro_torch.core.codecs import PackedTensor
    from repro_torch.kernels import _build, ref
    lp = params["layers"][0]
    shapes = {}                  # (K, N) -> (names, the first one's streams)
    for part, names in (("attn", ("wq", "wk", "wv", "wo")),
                        ("ffn", ("gate", "up", "down"))):
        for w in names:
            if isinstance(lp[part][w], PackedTensor) \
                    and len(lp[part][w].shape) == 2:
                shapes.setdefault(tuple(lp[part][w].shape),
                                  ([], lp[part][w].streams))[0].append(w)
    gen = torch.Generator(device=device).manual_seed(SEED)
    for (k, n), (names, streams) in shapes.items():
        label = f"{name} {names} K={k} N={n}"
        wdec = ref.decode_w_sgem_ref(streams)
        x = torch.randn(64, k, generator=gen, device=device).to(
            torch.bfloat16)
        outs, ratio = {}, 0.0
        for m in (8, 64):
            _, outs[m], _, r, _ = kernel_vs_plain(
                label, kern, streams, wdec, ref.m2xfp_matmul_ref, x, m)
            ratio = max(ratio, r)
        assert_rows_independent(label, outs, [(8, 64)])
        x8 = x[:8].contiguous()
        t_k = timer(lambda: kern(x8, streams))
        b_ms, b_by, _ = bound(8, k, n, sum(s.nbytes
                                           for s in streams.values()))
        emit(phase, model=name, check="gemm_shape", weights=names,
             K=k, N=n, split_k=_build.split_k(k, n),
             tolerance=TOLERANCE, max_ratio_to_tolerance=ratio,
             row_independent=True, kernel_ms_at_m8=t_k, bound_ms=b_ms,
             bound_by=b_by, share_of_bound=b_ms / t_k)
        del wdec, x, outs


def ring_overwrites(eng) -> dict:
    """Per kind of layer (``local_<window>`` or ``global``), read from the
    position tracks of ``eng``'s caches after a serve: the ring's width,
    the positions each slot wrote since its last admit (the largest it
    holds, plus one: its request's prompt and every generated token but
    the last, and one more where the slot sat idle through a later
    decode launch, which writes every slot) and the entries that
    overwrote older ones (the positions written beyond the width, summed
    over slots; one layer's count). Every slot's ring must hold exactly
    its last ``min(written, width)`` positions, each at ``position %
    width``, and every layer of a kind the same."""
    from repro_torch.models.model import layer_windows
    out = {}
    for i, (window, cache) in enumerate(zip(layer_windows(eng.cfg),
                                            eng.caches["layers"])):
        pos = cache["pos"].cpu()
        width = pos.shape[1]
        written = (pos.max(dim=1).values + 1).tolist()
        for slot, n in enumerate(written):
            held = torch.arange(max(0, n - width), n, dtype=pos.dtype)
            want = torch.full((width,), -1, dtype=pos.dtype)
            want[held % width] = held
            if not torch.equal(pos[slot], want):
                raise AssertionError(f"layer {i} slot {slot}: the ring does "
                                     f"not hold the last {len(held)} of "
                                     f"{n} positions")
        kind = f"local_{window}" if window else "global"
        ring = dict(positions=width, written_per_slot=written,
                    overwritten_per_layer=sum(max(0, n - width)
                                              for n in written))
        seen = out.setdefault(kind, dict(ring, layers=0))
        if {k: seen[k] for k in ring} != ring:
            raise AssertionError(f"layer {i}: its {kind} ring differs from "
                                 f"the earlier {kind} layers'")
        seen["layers"] += 1
    return out


def variants_phase(timer, device, kern, kernels) -> int:
    """Pack each of VARIANTS (m2xfp weights on the card from SEED), run
    variant_gemm_check on its projection shapes, serve it with
    serve_phase's assertions and print the ring overwrites; then
    gemma2-9b's decode step split as in phase 3. Returns the launches of
    ``kern`` in the serves."""
    from repro_torch.configs import get_config
    from repro_torch.serve.prequant import init_packed_params
    from repro_torch.testing import attention_extras, fill_attention_extras
    launches = 0
    for arch, layers, max_len, prompts in VARIANTS:
        cfg = get_config(arch, quant="serve", n_layers=layers)
        params = fill_attention_extras(init_packed_params(
            torch.Generator(device=device).manual_seed(SEED), cfg, device),
            cfg, SEED)
        variant_gemm_check(timer, arch, params, kern, device)
        eng, n, _ = serve_phase(
            "m2xfp", device, kern, kernels, layers=layers, params=params,
            traffic=CODEC_TRAFFIC[:2] + (prompts,), arch=arch,
            max_len=max_len)
        del params
        launches += n
        cfg = eng.cfg
        rings = ring_overwrites(eng)
        emit("variants", model=cfg.name, layers=layers, max_len=max_len,
             features=dict(qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
                           tie_embeddings=cfg.tie_embeddings,
                           sliding_window=cfg.sliding_window,
                           local_global=cfg.local_global,
                           attn_softcap=cfg.attn_softcap,
                           final_softcap=cfg.final_softcap),
             seeded_leaves=sorted(attention_extras(cfg)),
             has_lm_head="lm_head" in eng.params, rings=rings)
        if cfg.sliding_window:
            if not all(r["overwritten_per_layer"] > 0
                       for r in rings.values()):
                raise AssertionError(f"{arch}: a ring did not wrap: {rings}")
            decode_breakdown(eng, device, kern)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def embed_input_check(timer, arch: str, layers: int, device, kern,
                      kernels) -> int:
    """Embedding input at full width, the first ``layers`` layers of
    ``arch``: 8 slots of FAMILY_POSITIONS embeddings through prefill_chunk
    in chunks of CHUNK (row b valid for FAMILY_LENGTHS[b] positions) and
    through decode_step one position at a time (a slot past its length
    keeps its cache rows). The logits at every valid position must be
    finite and equal bit for bit, the caches equal, and ``kern`` launched
    7 times per layer per launch, no other kernel; before the runs,
    variant_gemm_check on layer 0. Returns its launches."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import decode_step, init_caches, \
        prefill_chunk
    from repro_torch.serve.prequant import init_packed_params
    cfg = get_config(arch, quant="serve", n_layers=layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_packed_params(gen, cfg, device)
    embeds = torch.randn(N_SLOTS, FAMILY_POSITIONS, cfg.d_model,
                         generator=gen, device=device).to(torch.bfloat16)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    variant_gemm_check(timer, arch, params, kern, device, phase="families")
    lengths = torch.tensor(FAMILY_LENGTHS, device=device)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    pre_caches = init_caches(cfg, N_SLOTS, FAMILY_POSITIONS, device)
    pre = torch.cat([prefill_chunk(
        params, cfg, {"embeds": embeds[:, c:c + CHUNK]}, pre_caches,
        torch.full((N_SLOTS,), c, device=device),
        (lengths - c).clamp(0, CHUNK))
        for c in range(0, FAMILY_POSITIONS, CHUNK)], dim=1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec_caches = init_caches(cfg, N_SLOTS, FAMILY_POSITIONS, device)
    dec = []
    for t in range(FAMILY_POSITIONS):
        idle = torch.nonzero(lengths <= t)[:, 0]
        kept = [{k: v[idle].clone() for k, v in layer.items()}
                for layer in dec_caches["layers"]]
        dec.append(decode_step(params, cfg, {"embeds": embeds[:, t:t + 1]},
                               dec_caches,
                               torch.full((N_SLOTS,), t, device=device))[:, 0])
        for layer, rows in zip(dec_caches["layers"], kept):
            for k, v in rows.items():
                layer[k][idle] = v
    dec = torch.stack(dec, dim=1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    n_launches = FAMILY_POSITIONS // CHUNK + FAMILY_POSITIONS
    launches = kern.launches
    others = {k.name: k.launches for k in kernels if k is not kern}
    valid = torch.arange(FAMILY_POSITIONS, device=device)[None] \
        < lengths[:, None]
    equal = torch.equal(pre[valid], dec[valid])
    finite = bool(torch.isfinite(pre[valid]).all())
    caches_equal = all(torch.equal(a[k], b[k]) for a, b in zip(
        pre_caches["layers"], dec_caches["layers"]) for k in a)
    emit("families", check="embedding_input", model=cfg.name,
         family=cfg.family, layers=layers, d_model=cfg.d_model,
         d_ff=cfg.d_ff, vocab=cfg.vocab_size, slots=N_SLOTS,
         positions=FAMILY_POSITIONS, lengths=list(FAMILY_LENGTHS),
         prefill_chunk=CHUNK, valid_positions=int(valid.sum()),
         prefill_equals_decode=equal, finite=finite,
         caches_equal=caches_equal, kernel=kern.name, launches=launches,
         launches_expected=7 * layers * n_launches, other_launches=others,
         init_and_pack_s=pack_s, prefill_s=prefill_s, decode_s=decode_s,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    if not (equal and finite and caches_equal) or any(others.values()) \
            or launches != 7 * layers * n_launches:
        raise AssertionError(f"{arch}: embedding input failed its checks")
    return launches


def _to_cpu(node):
    from repro_torch.core.codecs import PackedTensor
    if isinstance(node, PackedTensor):
        return PackedTensor({k: t.cpu() for k, t in node.streams.items()},
                            node.shape, node.codec)
    return {k: _to_cpu(v) for k, v in node.items()} \
        if isinstance(node, dict) else node.cpu()


def moe_apply_check(timer, cfg, ffn: dict, device):
    """Layer 0's moe_apply on the card at 8 and 64 tokens (a decode step's
    and a chunk of 8's), then its device time at 8 tokens, split into the
    packed experts' decode and the three expert products (CUDA events, L2
    flushed). Returns the CPU side as a function, run after the serve so
    that it takes no host time from it (the CPU's moe_apply decodes every
    expert, seconds a call at olmoe's width): it holds the routing
    (probabilities, top-k experts and weights, queue positions, kept
    assignments) to the card's bit for bit and the output within
    MOE_TOLERANCE, raises on a difference, and returns the lines to
    print."""
    from repro_torch.core.codecs import PackedTensor
    from repro_torch.models.moe import _capacity, moe_apply, route
    from repro_torch.models.numerics import einsum_f32acc
    from repro_torch.models.quant import decode_serving_weight
    gen = torch.Generator(device=device).manual_seed(SEED)
    k, e, d = cfg.experts_per_token, cfg.n_experts, cfg.d_model
    cases = []
    for b, s in ((N_SLOTS, 1), (N_SLOTS, CHUNK)):
        x = torch.randn(b, s, d, generator=gen, device=device).to(
            torch.bfloat16)
        g = min(cfg.moe_group_size, b * s)
        cap = _capacity(g, k, e, cfg.moe_capacity_factor)
        got = [t.cpu() for t in route(ffn["router"], x.reshape(-1, g, d), k,
                                      cap)]
        cases.append((x.cpu(), g, cap, got,
                      moe_apply(ffn, x, cfg, cfg.quant).float().cpu()))
    cpu_ffn = _to_cpu(ffn)

    def on_cpu() -> list:
        lines = []
        for x, g, cap, got, y in cases:
            t0 = time.perf_counter()
            want = route(cpu_ffn["router"], x.reshape(-1, g, d), k, cap)
            routing_equal = all(torch.equal(a, w) for a, w in zip(got, want))
            y_cpu = moe_apply(cpu_ffn, x, cfg, cfg.quant).float()
            bound_ = 2.0 ** -7 * (torch.maximum(y.abs(), y_cpu.abs())
                                  + y_cpu.abs().max())
            ratio = float(((y - y_cpu).abs() / bound_).max())
            probs = torch.sort(want[0], dim=-1, descending=True).values
            n = x.shape[0] * x.shape[1] * k
            lines.append(dict(
                check="moe_apply", model=cfg.name, tokens=n // k, group=g,
                capacity=cap, experts=e, top_k=k,
                routing_equal=routing_equal, assignments=n,
                dropped=int(n - want[4].sum()),
                smallest_top_k_gap=float((probs[..., k - 1]
                                          - probs[..., k]).min()),
                tolerance=MOE_TOLERANCE, max_ratio_to_tolerance=ratio,
                max_abs_diff=float((y - y_cpu).abs().max()),
                bit_equal_share=float((y == y_cpu).float().mean()),
                finite=bool(torch.isfinite(y).all()),
                cpu_seconds=time.perf_counter() - t0))
            if not routing_equal or not ratio <= 1.0:
                raise AssertionError(f"{cfg.name}: moe_apply on the card "
                                     f"differs from the CPU: {lines[-1]}")
        return lines

    experts = [ffn[n] for n in ("gate", "up", "down")]
    packed = [isinstance(w, PackedTensor) for w in experts]
    dense = [decode_serving_weight(w) if p else w
             for w, p in zip(experts, packed)]
    cap = _capacity(N_SLOTS, k, e, cfg.moe_capacity_factor)
    xs = [torch.randn(1, e, cap, w.shape[0] if p else w.shape[1],
                      generator=gen, device=device).to(torch.bfloat16)
          for w, p in zip(experts, packed)]
    eqs = ["geck,kef->gecf" if p else "geck,ekf->gecf" for p in packed]
    x8 = torch.randn(N_SLOTS, 1, d, generator=gen, device=device).to(
        torch.bfloat16)
    emit("families", check="moe_layer_cost", model=cfg.name, tokens=N_SLOTS,
         capacity=cap, experts_packed=packed,
         expert_weight_bytes=sum(
             sum(t.nbytes for t in w.streams.values()) if p else w.nbytes
             for w, p in zip(experts, packed)),
         moe_apply_ms=timer(lambda: moe_apply(ffn, x8, cfg, cfg.quant)),
         expert_decode_ms=timer(lambda: [decode_serving_weight(w)
                                         for w, p in zip(experts, packed)
                                         if p]) if any(packed) else 0.0,
         expert_products_ms=timer(lambda: [
             einsum_f32acc(eq, xe, w) for eq, xe, w in zip(eqs, xs, dense)]))
    return on_cpu


def families_phase(timer, device, kern, kernels) -> int:
    """Embedding input (FAMILY_EMBED, embed_input_check), then each of
    FAMILY_MOE: m2xfp weights packed on the card from SEED,
    variant_gemm_check and moe_apply_check's card side on layer 0, served
    with serve_phase's assertions (4 launches of ``kern`` per layer per
    engine launch; the agreement with chunks of 1 printed, not asserted);
    olmoe's decode step split as in phase 3; then moe_apply_check's CPU
    side. Returns the launches of ``kern``."""
    from repro_torch.configs import get_config
    from repro_torch.serve.prequant import init_packed_params
    launches = 0
    for arch, layers in FAMILY_EMBED:
        launches += embed_input_check(timer, arch, layers, device, kern,
                                      kernels)
        gc.collect()
        torch.cuda.empty_cache()
    for arch, layers in FAMILY_MOE:
        cfg = get_config(arch, quant="serve", n_layers=layers)
        t0 = time.perf_counter()
        params = init_packed_params(
            torch.Generator(device=device).manual_seed(SEED), cfg, device)
        torch.cuda.synchronize()
        emit("families", check="moe_weights", model=cfg.name, layers=layers,
             experts=cfg.n_experts, top_k=cfg.experts_per_token,
             experts_packed={n: type(params["layers"][0]["ffn"][n]).__name__
                             for n in ("gate", "up", "down")},
             packed_weight_bytes=_packed_bytes(params),
             dense_expert_bytes=sum(
                 t.nbytes for lp in params["layers"]
                 for t in lp["ffn"].values() if isinstance(t, torch.Tensor)
                 and t.dtype == torch.bfloat16),
             init_and_pack_s=time.perf_counter() - t0)
        seconds = {"init_and_pack": time.perf_counter() - t0}
        t0 = time.perf_counter()
        variant_gemm_check(timer, arch, params, kern, device,
                           phase="families")
        seconds["gemm_check"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = moe_apply_check(timer, cfg, params["layers"][0]["ffn"],
                                 device)
        seconds["moe_apply_check_card"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng, n, _ = serve_phase(
            "m2xfp", device, kern, kernels, layers=layers, params=params,
            traffic=CODEC_TRAFFIC, arch=arch)
        seconds["serve_chunks_8_and_1"] = time.perf_counter() - t0
        del params
        launches += n
        if cfg.n_experts % 32 == 0:
            # one profiled step and no guard on/off runs: the profiler's
            # record of a step of olmoe (its experts' decode is thousands
            # of small ops) takes seconds, and with three steps and the
            # guard's runs the breakdown alone took 51 s of the phase
            t0 = time.perf_counter()
            decode_breakdown(eng, device, kern, steps=1, guard=False)
            seconds["decode_breakdown"] = time.perf_counter() - t0
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        for line in on_cpu():
            emit("families", **line)
        seconds["moe_apply_check_cpu"] = time.perf_counter() - t0
        emit("families", check="moe_seconds", model=cfg.name, **seconds)
    return launches


def _finite_metrics(quant: str, step: int, metrics: dict) -> dict:
    vals = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in vals.values()):
        raise AssertionError(f"train {quant} step {step}: non-finite "
                             f"metrics {vals}")
    return vals


def train_breakdown(step_fn, state, batch, wall_ms: float) -> None:
    """Device time of one more train step by kernel (torch.profiler; the
    step's result is dropped) beside ``wall_ms``, the median event time of
    the timed steps after the first; idle share ``1 - device / wall``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(state, batch)
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + \
                ev.self_device_time_total / 1e3
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit("train_breakdown", quant="none", wall_ms=wall_ms, device_ms=total,
         device_idle_share=1 - total / wall_ms,
         gemm_ms=sum(v for k, v in by_name.items() if "gemm" in k.lower()),
         top_kernels_ms={k[:80]: v for k, v in top})


def train_phase(device, kern, kernels) -> int:
    """ROADMAP A8 on full-width paper-llama2-7b at TRAIN_LAYERS layers
    (module docstring, phase 9). Returns the m2xfp kernel's launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import ref
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.model import loss_fn, pack_params_for_serving
    from repro_torch.models.quant import fake_quant_act
    from repro_torch.testing.train import (GRAD_L2, GRAD_TOL, LOSS_RTOL,
                                           step_card_vs_cpu)
    from repro_torch.train import (AdamWConfig, cast_for_compute,
                                   make_train_state, make_train_step)
    from repro_torch.tree import tree_leaves
    cfg = get_config("paper-llama2-7b", n_layers=TRAIN_LAYERS)
    to_dev = lambda b: {k: torch.from_numpy(v).to(device)  # noqa: E731
                        for k, v in b.items()}
    data = SyntheticLM(DataConfig(batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                  vocab=cfg.vocab_size, seed=SEED))
    batches = [to_dev(data.batch_at(i)) for i in range(TRAIN_STEPS)]
    held_out = to_dev(SyntheticLM(DataConfig(
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, vocab=cfg.vocab_size,
        seed=SEED + 99)).batch_at(0))
    opt = AdamWConfig(**TRAIN_OPT)

    def fresh(c, layers=TRAIN_LAYERS):
        c = dataclasses.replace(c, n_layers=layers)
        return make_train_state(torch.Generator(device=device).manual_seed(
            SEED), c, device=device)

    losses, step_ms = {}, {}

    def train(quant, steps):
        """``steps`` steps from a fresh state; returns the state. Raises if
        a kernel launched."""
        c = dataclasses.replace(cfg, quant=quant)
        step_fn = make_train_step(c, opt)
        state = fresh(c)
        losses[quant], step_ms[quant] = [], []
        for k in kernels:
            k.launches = 0
        for i in range(steps):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            state, m = step_fn(state, batches[i])
            t1.record()
            torch.cuda.synchronize()
            vals = _finite_metrics(quant, i, m)
            losses[quant].append(vals["loss"])
            step_ms[quant].append(t0.elapsed_time(t1))
            emit("train_step", quant=quant, quant_format=c.quant_format,
                 step=i, step_ms=step_ms[quant][-1], **vals)
        launched = {k.name: k.launches for k in kernels if k.launches}
        if launched:
            raise AssertionError(f"train {quant} launched {launched}: the "
                                 f"reference's training reaches no kernel")
        return state

    seconds = {}
    t_phase = t_lap = time.perf_counter()

    def lap(name):
        nonlocal t_lap
        now = time.perf_counter()
        seconds[name] = now - t_lap
        t_lap = now

    # the first TRAIN_REPEAT_STEPS "none" steps twice: the same bits
    runs = [train("none", TRAIN_REPEAT_STEPS) for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*map(tree_leaves, runs)))
    del runs
    if not same:
        raise AssertionError(f"two card runs of {TRAIN_REPEAT_STEPS} train "
                             f"steps gave different bits")
    emit("train_deterministic", steps=TRAIN_REPEAT_STEPS, same_bits=same)
    lap("repeat")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = train("none", TRAIN_STEPS)
    peak_none = torch.cuda.max_memory_allocated()
    train_breakdown(make_train_step(cfg, opt), state, batches[0],
                    statistics.median(step_ms["none"][1:]))
    params, trained = state["params"], losses["none"]
    del state
    lap("none")

    # the trained model, its compute dtypes packed m2xfp, served and scored
    scfg = dataclasses.replace(cfg, quant="serve")
    packed = pack_params_for_serving(cast_for_compute(params), scfg)
    eng, serve_launches, _ = serve_phase(
        "m2xfp", device, kern, kernels, layers=TRAIN_LAYERS, params=packed,
        traffic=CODEC_TRAFFIC)
    del eng
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        loss_serve = float(loss_fn(packed, scfg, held_out))
    loss_serve_s = time.perf_counter() - t0
    loss_launches = kern.launches
    others = {k.name: k.launches for k in kernels if k is not kern
              and k.launches}
    expected = 7 * TRAIN_LAYERS
    if loss_launches != expected or others or not np.isfinite(loss_serve):
        raise AssertionError(f"loss_fn under serve: {loss_launches} "
                             f"launches (expected {expected}), others "
                             f"{others}, loss {loss_serve}")
    lp = packed["layers"][0]
    h = packed["embed"][held_out["tokens"]].reshape(-1, cfg.d_model)
    x = fake_quant_act(rms_norm(h, lp["attn_norm"], cfg.norm_eps).to(
        torch.float32)).to(torch.bfloat16)
    wp = lp["attn"]["wq"].streams
    _, _, _, ratio, max_abs = kernel_vs_plain(
        "train wq", kern, wp, ref.decode_w_sgem_ref(wp), ref.m2xfp_matmul_ref,
        x, x.shape[0])
    qcfg = dataclasses.replace(cfg, quant="qat", quant_format="mxfp4")
    with torch.no_grad():
        compute = cast_for_compute(params)
        held = {"none": float(loss_fn(compute, cfg, held_out)),
                "serve_m2xfp": loss_serve,
                "qat_mxfp4": float(loss_fn(compute, qcfg, held_out))}
    del compute, packed, params
    emit("train_served", model=cfg.name, layers=TRAIN_LAYERS,
         held_out_tokens=TRAIN_BATCH * TRAIN_SEQ, held_out_losses=held,
         serve_loss_launches=loss_launches,
         serve_loss_launches_expected=expected, serve_loss_s=loss_serve_s,
         gemm_m=x.shape[0], gemm_k=cfg.d_model, gemm_max_abs_err=max_abs,
         gemm_max_ratio_to_tolerance=ratio, tolerance=TOLERANCE)
    gc.collect()
    torch.cuda.empty_cache()
    lap("served")

    torch.cuda.reset_peak_memory_stats()
    state = train("qat", TRAIN_STEPS)
    peak_qat = torch.cuda.max_memory_allocated()
    losses["none"] = trained
    del state
    gc.collect()
    torch.cuda.empty_cache()
    lap("qat")

    # one step on the card against the CPU, after the timed card work
    checks = {}
    for quant in ("none", "qat"):
        c = dataclasses.replace(cfg, quant=quant, n_layers=TRAIN_CHECK[0])
        st = fresh(c, TRAIN_CHECK[0])
        one = to_dev(SyntheticLM(DataConfig(
            batch=TRAIN_CHECK[1], seq=TRAIN_CHECK[2], vocab=cfg.vocab_size,
            seed=SEED)).batch_at(0))
        checks[quant] = step_card_vs_cpu(c, st["params"], one)
        del st
        lap(f"card_vs_cpu_{quant}")
    emit("train_card_vs_cpu", layers=TRAIN_CHECK[0], batch=TRAIN_CHECK[1],
         seq=TRAIN_CHECK[2], grad_tol=GRAD_TOL, grad_l2=GRAD_L2,
         loss_rtol=LOSS_RTOL, checks=checks)
    failed = [q for q, res in checks.items() if not res["within"]]
    if failed:
        raise AssertionError(f"train step card vs CPU outside the "
                             f"tolerances: {failed}")
    blind = [q for q, res in checks.items()
             if not res["planted_fault_ratio"] > 1]
    if blind:
        raise AssertionError(f"the loss bound does not see a dropped "
                             f"layer: {blind}")
    emit("train", model=cfg.name, layers=TRAIN_LAYERS, batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, steps=TRAIN_STEPS, opt=TRAIN_OPT, remat=cfg.remat,
         peak_memory_bytes={"none": peak_none, "qat": peak_qat},
         loss_fell={q: ls[-1] < ls[0] for q, ls in losses.items()},
         seconds=seconds, total_s=time.perf_counter() - t_phase,
         m2xfp_launches=serve_launches + loss_launches)
    return serve_launches + loss_launches


def bitmath_phase(gen, device):
    """The bit helpers of csrc/mx_bits.cuh on every code, through the two
    W4A4 kernels on constructed inputs, and the serve GEMMs' weight decode
    (their launches are comparisons and are not counted). Raises unless each
    equals its plain version."""
    from repro_torch.kernels import layout, ref
    from repro_torch.kernels.m2xfp_matmul import KERNEL as M2XFP
    from repro_torch.kernels.m2xfp_matmul import QKERNEL
    from repro_torch.kernels.m2xfp_quantize import KERNEL as QUANT
    from repro_torch.kernels.mxfp4_matmul import KERNEL as MXFP4
    # Encode: each sweep value leads subgroup 0 of a group anchored at 4.0
    # (scale 1 while |v| < 8), so it meets RTNE FP4 and, as the top-1, RTNE
    # FP6 and the bias clamp at every code and midpoint of both grids.
    sweep = torch.linspace(-8, 8, 4097, device=device)
    x = torch.zeros(sweep.numel(), 32, device=device)
    x[:, 0] = sweep
    x[:, 8] = sweep * 0.5
    x[:, 24] = 4.0
    got, want = QUANT(x), ref.m2xfp_quantize_ref(x.T)
    for s in got:
        if not torch.equal(got[s], want[s]):
            raise AssertionError(f"bitmath: quantize stream {s} differs from "
                                 f"the plain packer on the sweep")
    # Decode: random X streams (every code byte, meta byte and tie) times an
    # identity weight, whose Sg-EM decode is exact, give the decoded X.
    k, m = 64, 4096
    xp = {"codes": torch.randint(0, 256, (k // 2, m), generator=gen,
                                 device=device, dtype=torch.uint8),
          "scales": torch.randint(100, 150, (k // 32, m), generator=gen,
                                  device=device, dtype=torch.uint8),
          "meta": torch.randint(0, 256, (k // 32, m), generator=gen,
                                device=device, dtype=torch.uint8)}
    eye = torch.eye(k, device=device)
    wp = layout.pack_w_sgem(eye)
    if not torch.equal(ref.decode_w_sgem_ref(wp), eye):
        raise AssertionError("bitmath: the identity weight does not decode "
                             "exactly")
    dec = QKERNEL(xp, wp)
    if not torch.equal(dec, ref.decode_x_elem_em_ref(xp)):
        raise AssertionError("bitmath: the W4A4 GEMM's X decode differs from "
                             "the plain Top-1 Decode Unit")
    # Serve GEMMs: x = I (64 rows) times random W streams gives the decoded
    # weight, one exact product per output: every code, meta field and scale
    # byte 0-250 (bytes 0-3 give subnormal weights; above 250 some decode
    # past f32's range).
    w_streams = {"codes": torch.randint(0, 256, (k // 2, m), generator=gen,
                                        device=device, dtype=torch.uint8),
                 "scales": torch.randint(0, 251, (k // 32, m), generator=gen,
                                         device=device, dtype=torch.uint8),
                 "meta": torch.randint(0, 256, (k // 32, m), generator=gen,
                                       device=device, dtype=torch.uint8)}
    eye16 = eye.to(torch.bfloat16)
    subnormal = 0
    for kern, dec, streams in (
            (M2XFP, ref.decode_w_sgem_ref, ("codes", "scales", "meta")),
            (MXFP4, ref.decode_w_mxfp4_ref, ("codes", "scales"))):
        wq = {s: w_streams[s] for s in streams}
        want = dec(wq)
        if not torch.equal(kern(eye16, wq), want):
            raise AssertionError(f"bitmath: {kern.name}'s weight decode "
                                 f"differs from the plain decoder")
        subnormal += int(((want != 0) & (want.abs() < 2.0 ** -126)).sum())
    torch.cuda.synchronize()
    emit("bitmath", encode_sweep_points=sweep.numel(),
         encode_streams_equal=True, decode_columns=m,
         decode_distinct_code_bytes=int(xp["codes"].unique().numel()),
         decode_distinct_meta_bytes=int(xp["meta"].unique().numel()),
         decode_equal=True, serve_gemm_decode_equal=True,
         serve_gemm_scale_bytes=[int(w_streams["scales"].min()),
                                 int(w_streams["scales"].max())],
         serve_gemm_subnormal_weights=subnormal)


def _w4a4_bound(m: int, k: int, n: int):
    """(quantize, qmatmul) least times (ms) with what bounds them, and bytes:
    the quantize engine reads M*K*2 and writes M*K*(1/2 + 2/32); the GEMM
    reads M*K*(1/2 + 2/32) + K*N*(1/2 + 2/32), writes M*N*4 and does
    2*M*K*N operations against the int8 peak: both decoded operands are
    integers times 2^-3 and a power of two per 32-group (X at most 60, W at
    most 84), so int8 products summed exactly in int32 per group and
    rescaled in f32 compute the same function."""
    packed = 0.5 + 2 / 32
    q_bytes = m * k * 2 + m * k * packed
    g_bytes = m * k * packed + k * n * packed + m * n * 4
    t_bytes, t_ops = g_bytes / HBM_BYTES_PER_S, 2 * m * k * n / INT8_OPS
    return ((q_bytes / HBM_BYTES_PER_S * 1e3, "bytes", q_bytes),
            (max(t_bytes, t_ops) * 1e3,
             "bytes" if t_bytes >= t_ops else "operations", g_bytes))


def w4a4_phase(timer, gen, device, kernels):
    """The W4A4 datapath through the public entry points. The launch counts
    are zeroed just before the path runs (every projection, every M) and
    read just after; the checks and timings come afterwards. Returns the
    summary entries of the two kernels."""
    from repro_torch import kernels as K
    from repro_torch.core.m2xfp import quantize_act_m2xfp
    from repro_torch.kernels import layout, ref
    from repro_torch.kernels.m2xfp_matmul import QKERNEL
    from repro_torch.kernels.m2xfp_quantize import KERNEL as QUANT
    from repro_torch.kernels.quantize_probe import kernel_only_ms
    weights = [layout.pack_w_sgem(torch.randn(k, n, generator=gen,
                                              device=device) * 0.02)
               for k, n in W4A4_PROJS]
    # LLM-like activations: normal entries with log-normal channel scales
    xs = {k: (torch.randn(W4A4_MS[-1], k, generator=gen, device=device)
              * torch.exp(0.8 * torch.randn(1, k, generator=gen,
                                            device=device))).to(torch.bfloat16)
          for k in sorted({k for k, _ in W4A4_PROJS})}
    torch.cuda.synchronize()

    for kern in kernels:                  # the path's counts start here
        kern.launches = 0
    outs = {}
    for p, ((k, _), wp) in enumerate(zip(W4A4_PROJS, weights)):
        for m in W4A4_MS:
            xp = K.m2xfp_quantize(xs[k][:m])
            outs[p, m] = (xp, K.m2xfp_qmatmul(xp, wp))
    torch.cuda.synchronize()
    launches = {QUANT.name: QUANT.launches, QKERNEL.name: QKERNEL.launches}
    others = {k.name: k.launches for k in kernels
              if k is not QUANT and k is not QKERNEL}
    want_launches = len(W4A4_PROJS) * len(W4A4_MS)
    if any(others.values()) or set(launches.values()) != {want_launches}:
        raise AssertionError(f"w4a4 path launched {launches} and {others}; "
                             f"expected {want_launches} of each W4A4 kernel")
    emit("w4a4", path="repro_torch.kernels.m2xfp_quantize -> m2xfp_qmatmul",
         projections=len(W4A4_PROJS), M=W4A4_MS, launches=launches)

    agg = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
           for name in launches}
    qmm_err, quant_err, qmm_by, timed = 0.0, 0, set(), set()
    for p, ((k, n), wp) in enumerate(zip(W4A4_PROJS, weights)):
        wdec = ref.decode_w_sgem_ref(wp)
        wdec16 = wdec.to(torch.bfloat16)
        for m in W4A4_MS:
            x = xs[k][:m]
            xp, got = outs[p, m]
            want_xp = ref.m2xfp_quantize_ref(x.T)
            for s in xp:                                           # (a)
                if xp[s].shape != want_xp[s].shape:
                    raise AssertionError(f"w4a4 K={k} M={m}: quantize "
                                         f"stream {s} has the wrong shape")
                s_err = int((xp[s].int() - want_xp[s].int()).abs().max())
                quant_err = max(quant_err, s_err)
                if s_err:
                    raise AssertionError(f"w4a4 K={k} M={m}: quantize "
                                         f"stream {s} differs from the plain "
                                         f"packer")
            xdec = ref.decode_x_elem_em_ref(xp)
            tol = k ** 0.5 * 2.0 ** -24 * ref.dot_f64acc(xdec.abs(),
                                                         wdec.abs())
            diff = (got - ref.m2xfp_qmatmul_ref(xp, wp)).abs()     # (b)
            if bool((diff > tol).any()):
                raise AssertionError(f"w4a4 K={k} N={n} M={m}: GEMM outside "
                                     f"{W4A4_TOLERANCE} of its plain version")
            serve = K.m2xfp_matmul(quantize_act_m2xfp(x).to(torch.bfloat16),
                                   wp)                             # (c)
            if not torch.equal(got, serve):
                raise AssertionError(f"w4a4 K={k} N={n} M={m}: GEMM not "
                                     f"bit-equal to the serve GEMM on "
                                     f"quantize_act_m2xfp(x)")
            bad = dict(xp)                                         # (e)
            bad["meta"] = xp["meta"].clone()
            bad["meta"][0] ^= 0x02
            if torch.equal(ref.decode_x_elem_em_ref(bad), xdec):
                raise AssertionError("w4a4: the planted fault changed nothing")
            caught = (got - ref.m2xfp_qmatmul_ref(bad, wp)).abs() > tol
            if not bool(caught.any()):
                raise AssertionError(f"w4a4 K={k} N={n} M={m}: a one-field "
                                     f"fault of the X meta passed "
                                     f"{W4A4_TOLERANCE}")
            err = float(diff.max())
            qmm_err = max(qmm_err, err)
            line = dict(projection=p, K=k, N=n, M=m, streams_equal=True,
                        tolerance=W4A4_TOLERANCE, max_abs_err=err,
                        max_ratio_to_tolerance=float(
                            (diff / tol.clamp_min(1e-38)).max()),
                        bit_equal_to_serve_gemm=True,
                        planted_fault_flagged_share=float(
                            caught.float().mean()))
            if (k, n, m) not in timed:            # time each shape once
                timed.add((k, n, m))
                xdec16 = xdec.to(torch.bfloat16)
                (bq, byq, nq), (bg, byg, ng) = _w4a4_bound(m, k, n)
                t_q = timer(lambda: K.m2xfp_quantize(x))
                t_qp = timer(lambda: ref.m2xfp_quantize_ref(x.T), iters=5,
                             warmup=1)
                t_g = timer(lambda: K.m2xfp_qmatmul(xp, wp))
                t_gp = timer(lambda: ref.m2xfp_qmatmul_ref(xp, wp), iters=5,
                             warmup=1)
                t_gl = timer(lambda: torch.matmul(xdec16, wdec16))
                line.update(
                    quantize=dict(kernel_ms=t_q, plain_ms=t_qp,
                                  library_ms=None, bound_ms=bq, bound_by=byq,
                                  bytes=nq, share_of_bound=bq / t_q),
                    qmatmul=dict(kernel_ms=t_g, plain_ms=t_gp,
                                 library_ms=t_gl, library=W4A4_LIBRARY,
                                 bound_ms=bg, bound_by=byg, bytes=ng))
                if m == 8:
                    reps = W4A4_PROJS.count((k, n))
                    for name, vals in (
                            (QUANT.name, (t_q, t_qp, bq, None)),
                            (QKERNEL.name, (t_g, t_gp, bg, t_gl))):
                        for key, t in zip(("ms", "plain_ms", "bound_ms",
                                           "library_ms"), vals):
                            agg[name][key] = (None if t is None
                                              else agg[name][key] + reps * t)
                    qmm_by.add(byg)
            emit("w4a4", **line)
        for small in (1, 8):
            for big in (64, 129, 2048):
                if not torch.equal(outs[p, small][1], outs[p, big][1][:small]):
                    raise AssertionError(f"w4a4 K={k} N={n}: rows of M={small}"
                                         f" differ from those of M={big}")
        emit("w4a4", projection=p, K=k, N=n, row_independent=True)   # (d)
        del wdec, wdec16
    # the launch floor beside the quantize engine at a few rows: the event
    # time of the smallest launch, and the engine's own device time
    quant_m8 = {k: kernel_only_ms(lambda: K.m2xfp_quantize(x[:8]),
                                  timer.flush_buf)
                for k, x in xs.items()}
    emit("w4a4", launch_floor_ms=timer(lambda: torch.zeros(1, device=device)),
         quantize_kernel_only_ms_at_m8=quant_m8,
         kernel_only="torch.profiler device time of the quantize kernel, "
                     "mean per launch over 20, L2 flushed before each")
    measured = ("the 7 projections of one paper-llama2-7b layer at M=8 "
                "(sum)")
    return {
        QUANT.name: dict(
            name=QUANT.name, route="cuda",
            source=str(QUANT.source.relative_to(ROOT)),
            replaces="src/repro/kernels/m2xfp_quantize.py:77",
            launches=launches[QUANT.name], max_abs_err=float(quant_err),
            bound_by="bytes", measured_over=measured, library=QUANT_LIBRARY,
            **agg[QUANT.name]),
        QKERNEL.name: dict(
            name=QKERNEL.name, route="cuda",
            source=str(QKERNEL.source.relative_to(ROOT)),
            replaces="src/repro/kernels/m2xfp_matmul.py:180",
            launches=launches[QKERNEL.name], max_abs_err=qmm_err,
            bound_by="bytes" if qmm_by == {"bytes"} else "operations",
            measured_over=measured, library=W4A4_LIBRARY,
            **agg[QKERNEL.name]),
    }


def flash_phase(timer, gen, device, kernels):
    """Flash attention through its entry point; counts zeroed just before
    the five cases run and read just after, checks and timings afterwards.
    Returns the kernel's summary entry (timed at causal S = 2048)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import KERNEL as FLASH
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    bh, hd, block_k = FLASH_BH, FLASH_HD, ref.FLASH_BLOCK_K
    runs = []
    for name, s, kw, q_scale in FLASH_CASES:
        q, k, v = (torch.randn(bh, s, hd, generator=gen, device=device)
                   for _ in range(3))
        q, k, v = ((q * q_scale).to(torch.bfloat16), k.to(torch.bfloat16),
                   v.to(torch.bfloat16))
        pos_q = torch.arange(s, device=device, dtype=torch.int32).expand(
            bh, s).contiguous()
        pos_k = pos_q.clone()
        if name == "last_64_keys_invalid":
            pos_k[:, -64:] = -1
            pos_q[:, -1] = -1             # a padded query: no valid key
        runs.append((name, s, kw, q_scale, q, k, v, pos_q, pos_k))
    torch.cuda.synchronize()

    for kern in kernels:                  # the path's counts start here
        kern.launches = 0
    outs = [flash_attention_kernel(q, k, v, pq, pk, block_k=block_k, **kw)
            for _, _, kw, _, q, k, v, pq, pk in runs]
    torch.cuda.synchronize()
    launches = FLASH.launches
    others = {k.name: k.launches for k in kernels if k is not FLASH}
    if any(others.values()) or launches != len(runs):
        raise AssertionError(f"flash path launched {launches} and {others}")

    summary, flash_err = None, 0.0
    for (name, s, kw, q_scale, q, k, v, pq, pk), got in zip(runs, outs):
        def plain(q=q, k=k, v=v, pq=pq, pk=pk, kw=kw):
            return ref.flash_attention_ref(q, k, v, pq, pk, block_k=block_k,
                                           **kw)

        want = plain()
        tol = ref.flash_attention_tolerance(q, k, v, pq, pk, block_k=block_k,
                                            **kw)
        diff = (got - want).abs()
        if bool((diff > tol).any()):
            raise AssertionError(f"flash {name} S={s}: outside "
                                 f"{FLASH_TOLERANCE} of its plain version")
        v_bad = v.clone()
        v_bad[:, 0] += 1.0                # key 0's value row
        faults = {"value_row": plain(v=v_bad),
                  "scale_x1.02": plain(q=q * FLASH_SCALE_FAULT),
                  "mask_off_by_one": plain(pq=torch.where(pq >= 0, pq + 1,
                                                          pq))}
        if "softcap" in kw:               # the kernel without its softcap
            faults["no_softcap"] = flash_attention_kernel(
                q, k, v, pq, pk, block_k=block_k,
                window=kw.get("window", 1 << 30))
        flagged = {}
        for fault, out in faults.items():
            held = want if fault == "no_softcap" else got
            caught = (held - out).abs() > tol
            if not bool(caught.any()):
                raise AssertionError(f"flash {name} S={s}: the planted "
                                     f"fault {fault} passed {FLASH_TOLERANCE}")
            flagged[fault] = float(caught.float().mean())
        padded = {}
        if name == "last_64_keys_invalid":
            if not bool((got[:, -1] == 0).all()):
                raise AssertionError("flash: a query with no valid key is "
                                     "not 0")
            padded = dict(padded_query_row_zero=True)
        window = kw.get("window", 1 << 30)
        valid = ((pk >= 0)[:, None, :] & (pq[:, :, None] >= pk[:, None, :])
                 & (pq[:, :, None] - pk[:, None, :] < window))
        share = float(valid.sum()) / valid.numel()
        nbytes = 3 * bh * s * hd * 2 + bh * s * hd * 4
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = 4 * bh * s * s * hd * share / BF16_FLOPS
        b_ms = max(t_bytes, t_ops) * 1e3
        b_by = "bytes" if t_bytes >= t_ops else "operations"
        t_k = timer(lambda: flash_attention_kernel(q, k, v, pq, pk,
                                                   block_k=block_k, **kw))
        t_p = timer(plain, iters=5, warmup=1)
        q4, k4, v4 = q[None], k[None], v[None]        # (1, BH, S, hd)
        t_l = None
        if name == "causal":
            t_l = timer(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True))
        elif name == "window_512":       # the same positions in every head
            t_l = timer(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=valid[0]))
        err = float(diff.max())
        flash_err = max(flash_err, err)
        emit("flash", case=name, BH=bh, S=s, hd=hd, block_k=block_k,
             q_scale=q_scale, **{key: val for key, val in kw.items()},
             tolerance=FLASH_TOLERANCE, max_abs_err=err,
             median_tolerance=float(tol.median()),
             max_ratio_to_tolerance=float((diff / tol.clamp_min(1e-38)).max()),
             planted_fault_flagged_share=flagged,
             **padded, unmasked_share=share, kernel_ms=t_k, plain_ms=t_p,
             library_ms=t_l, library=FLASH_LIBRARY, bound_ms=b_ms,
             bound_by=b_by, bytes=nbytes, launches=launches)
        if name == "causal" and s == 2048:
            summary = dict(
                name=FLASH.name, route="cuda",
                source=str(FLASH.source.relative_to(ROOT)),
                replaces="src/repro/kernels/flash_attention.py:78",
                launches=launches, ms=t_k, plain_ms=t_p,
                bound_ms=b_ms, bound_by=b_by, library_ms=t_l,
                library=FLASH_LIBRARY,
                measured_over=f"causal, BH={bh}, S=2048, hd={hd}, "
                              f"block_k={block_k}")
        del faults, want, tol, diff
    summary["max_abs_err"] = flash_err
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script measures the port "
                 "on an H100 and has nothing to report without one")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, gemm_timeline
    from repro_torch.kernels.flash_attention import KERNEL as FLASH
    from repro_torch.kernels.m2xfp_matmul import KERNEL as M2XFP
    from repro_torch.kernels.m2xfp_matmul import QKERNEL
    from repro_torch.kernels.m2xfp_quantize import KERNEL as QUANT
    from repro_torch.kernels.mxfp4_matmul import KERNEL as MXFP4

    t_start = t_lap = time.perf_counter()
    seconds = {}

    def lap(phase):
        nonlocal t_lap
        now = time.perf_counter()
        seconds[phase] = now - t_lap
        t_lap = now

    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    built = _build.build()
    regs = {name: [ln.strip() for ln in rep.splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, rep in built["ptxas"].items()}
    # bytes spilled (stores + loads) by each kernel instance of a library;
    # None when the library was already built
    def spill_bytes(name):
        found = [int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads",
            built["ptxas"].get(name, ""))]
        return sum(found) if found else None

    spills = {k.name: spill_bytes(k.name)
              for k in (FLASH, M2XFP, MXFP4, QKERNEL, QUANT)}
    quant_regs = [int(n) for n in re.findall(
        r"Used (\d+) registers", built["ptxas"].get(QUANT.name, ""))]
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, allow_tf32=False,
         build_s=built["seconds"], ptxas=regs,
         flash_spill_bytes=spills[FLASH.name],
         gemm_spill_bytes={k: spills[k]
                           for k in (M2XFP.name, MXFP4.name, QKERNEL.name)},
         quantize_spill_bytes=spills[QUANT.name],
         quantize_registers=quant_regs)
    if any(spills.values()):
        raise AssertionError(f"kernels spill registers: {spills}")
    lap("device")

    timer = Timer(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    summary = kernel_phase(timer, gen, device)
    for line in gemm_timeline.run(8, SEED):
        emit("gemm_timeline", **line)
    lap("kernels")

    kernels = (M2XFP, MXFP4, QUANT, QKERNEL, FLASH)
    eng, launches, bf16_kv = serve_phase("m2xfp", device, M2XFP, kernels)
    decode_breakdown(eng, device, M2XFP)
    params = eng.params
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    lap("serve_m2xfp")
    eng, kv_launches, _ = serve_phase(
        "m2xfp", device, M2XFP, kernels, kv_quant="m2xfp",
        layers=PACKED_KV_LAYERS, bf16_kv=bf16_kv,
        params=dict(params, layers=params["layers"][:PACKED_KV_LAYERS]))
    decode_breakdown(eng, device, M2XFP)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    lap("serve_m2xfp_kv_m2xfp")
    guard_launches = guard_phase(params, device, M2XFP, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    lap("guard")
    ideal_launches = codecs_phase(params, timer, gen, device, M2XFP,
                                  kernels)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    lap("codecs")
    variant_launches = variants_phase(timer, device, M2XFP, kernels)
    lap("variants")
    family_launches = families_phase(timer, device, M2XFP, kernels)
    lap("families")
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = train_phase(device, M2XFP, kernels)
    summary["m2xfp_matmul"]["launches"] = (
        launches + kv_launches + guard_launches + ideal_launches
        + variant_launches + family_launches + train_launches)
    gc.collect()
    torch.cuda.empty_cache()
    lap("train")
    eng, summary["mxfp4_matmul"]["launches"], _ = serve_phase(
        "mxfp4", device, MXFP4, kernels, layers=MXFP4_LAYERS)
    decode_breakdown(eng, device, MXFP4)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    lap("serve_mxfp4")

    bitmath_phase(gen, device)
    lap("bitmath")
    summary.update(w4a4_phase(timer, gen, device, kernels))
    gc.collect()
    torch.cuda.empty_cache()
    lap("w4a4")
    summary["flash_attention"] = flash_phase(timer, gen, device, kernels)
    lap("flash")

    for name, s in summary.items():
        if s["launches"] < 1:
            raise AssertionError(f"{name} was never launched by its path")
    emit("total", seconds=time.perf_counter() - t_start,
         phase_seconds=seconds)
    print(json.dumps({"kernels": list(summary.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
