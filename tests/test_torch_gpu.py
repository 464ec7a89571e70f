"""Tests of the port that need the card: the CUDA kernels against their
plain versions (the two dequant-GEMMs, the quantize engine, the W4A4 GEMM
and flash attention), the packed KV cache's encode and decode against the
same calls on the CPU, the engine's launches, chunked prefill against
sequential decode at full width, with bf16 and packed KV caches, and the
serving guard (its sentinels and stream validation against the CPU, and
quarantine with the survivors bit-identical), and the attention variants
(soft-caps and the tied head against the CPU, the guard on rings of two
widths, chunked prefill on gemma2-9b and qwen3-8b), and the model families
of slice 11 (the MoE engine and its routing against the CPU, embedding
input's chunked prefill at full width), and training (slice 12: the
products' backward and a full-width train step against the CPU, the card's
train step deterministic and resumed bit for bit from a checkpoint,
``loss_fn`` under serve through the m2xfp kernel at M = 4096). Each
decides inside its body whether there is a CUDA device and skips without
one. This file imports no JAX, so it also runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The tracer that names the first op of the serve path whose rows differ
between chunked prefill and decode also runs here on the CPU, at smoke size
(the ``*_on_cpu`` tests).
"""
import numpy as np
import pytest
import torch

from conftest import heavy_tailed
from test_torch_serve import _clone_caches
from repro_torch.core.m2xfp import quantize_act_m2xfp
from repro_torch.kernels import layout, ops, ref
from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.m2xfp_matmul import KERNEL as M2XFP_KERNEL
from repro_torch.kernels.m2xfp_matmul import QKERNEL
from repro_torch.kernels.m2xfp_quantize import KERNEL as QUANTIZE_KERNEL
from repro_torch.kernels.m2xfp_quantize import plan as quantize_plan
from repro_torch.kernels.mxfp4_matmul import KERNEL as MXFP4_KERNEL

CODECS = {
    "m2xfp": (layout.pack_w_sgem, ops.m2xfp_matmul, ref.m2xfp_matmul_ref,
              ref.decode_w_sgem_ref, M2XFP_KERNEL),
    "mxfp4": (layout.pack_w_mxfp4, ops.mxfp4_matmul, ref.mxfp4_matmul_ref,
              ref.decode_w_mxfp4_ref, MXFP4_KERNEL),
}


KV_QUANTS = ["none", "m2xfp", "mxfp4"]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# (K, N) at the edges of the tensor-core design: one group and one 8-column
# tile; a group beyond 4096 (the last split one group longer) and N off the
# 128-column tile and the 16-byte copies; the down projection's K; a full
# projection shape (4 splits, aligned copies).
GEMM_EDGES = [(32, 8), (4096 + 32, 200), (11008, 200), (4096, 11008)]


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", GEMM_EDGES)
@pytest.mark.parametrize("fmt", sorted(CODECS))
def test_cuda_kernel_vs_plain(fmt, k, n):
    """The kernel against its plain version within sqrt(K)*2^-24*(|x| @ |W|),
    the expected size of its K f32 roundings (chip_smoke.py's tolerance), at
    M in {1, 8, 17, 64, 65, 129} (one 8-row tile, a ragged one, a full 64-row
    tile, one row beyond it); rows bit-identical to those of M = 129; two
    calls give the same bits; one launch counted per call; a refused dtype
    and K."""
    _need_cuda()
    pack, gemm, plain, decode, kern = CODECS[fmt]
    gen = torch.Generator("cuda").manual_seed(1)
    wp = pack(torch.randn(k, n, generator=gen, device="cuda") * 0.02)
    x = torch.randn(129, k, generator=gen, device="cuda").to(torch.bfloat16)
    wabs = decode(wp).abs()
    full = gemm(x, wp)
    for m in (1, 8, 17, 64, 65, 129):
        xm = x[:m].contiguous()
        before = kern.launches
        got = gemm(xm, wp)
        assert kern.launches == before + 1
        bound = k ** 0.5 * 2.0 ** -24 * ref.dot_f64acc(xm.abs(), wabs)
        assert bool(((got - plain(xm, wp)).abs() <= bound).all()), m
        assert torch.equal(got, full[:m]), m
        assert torch.equal(gemm(xm, wp), got), m          # deterministic
    with pytest.raises(ValueError, match="bfloat16"):
        gemm(x.float(), wp)
    with pytest.raises(ValueError, match="multiple of the 32"):
        gemm(x[:, :k - 16].contiguous(), wp)


@pytest.mark.gpu
def test_engine_on_card_launches_kernel_per_projection():
    """Every projection of every engine launch goes through the m2xfp
    kernel: 7 launches per layer per launch."""
    _need_cuda()
    from repro_torch.configs import smoke_config
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.prequant import init_packed_params
    cfg = smoke_config("paper-llama2-7b", quant="serve")
    params = init_packed_params(torch.Generator("cuda").manual_seed(0), cfg,
                                "cuda")
    eng = ServeEngine(params, cfg, n_slots=2, max_len=32, device="cuda")
    before = M2XFP_KERNEL.launches
    outs = eng.generate([[1, 2, 3], [4, 5, 6, 7, 8, 9, 10]], 4)
    assert all(len(o) == 4 for o in outs)
    assert M2XFP_KERNEL.launches - before == 7 * cfg.n_layers * eng.stats.steps


@pytest.mark.gpu
def test_cuda_quantize_vs_plain():
    """The quantize engine's streams equal the plain packer's byte for byte,
    from bf16 and from f32, at an M and a K off every tile; one launch
    counted per call; a refused dtype and K."""
    _need_cuda()
    gen = torch.Generator("cuda").manual_seed(2)
    x = (torch.randn(77, 11008, generator=gen, device="cuda") * 3).to(
        torch.bfloat16)
    x[0, :32] = 0.0                                    # an all-zero group
    for xin in (x, x.float()):
        before = QUANTIZE_KERNEL.launches
        got = ops.m2xfp_quantize(xin)
        assert QUANTIZE_KERNEL.launches == before + 1
        want = ref.m2xfp_quantize_ref(xin.T)
        for s in ("codes", "scales", "meta"):
            assert torch.equal(got[s], want[s]), s
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        ops.m2xfp_quantize(x.half())
    with pytest.raises(ValueError, match="multiple of the 32"):
        ops.m2xfp_quantize(x[:, :11008 - 16].contiguous())


# M off both tiles (8 and 32 rows) and the 16-byte stores; K off the 8-group
# tile (96, 288) and the projections' K.
QUANT_MS = [1, 7, 8, 9, 15, 16, 17, 63, 64, 65, 77, 129, 2048]
QUANT_KS = [32, 96, 256, 288, 4096, 11008]


def _quantize_vs_plain(x):
    """One launch per call, and the streams torch.equal the plain version's
    on the card."""
    before = QUANTIZE_KERNEL.launches
    got = ops.m2xfp_quantize(x)
    assert QUANTIZE_KERNEL.launches == before + 1
    want = ref.m2xfp_quantize_ref(x.T)
    for s in ("codes", "scales", "meta"):
        assert torch.equal(got[s], want[s]), (s, tuple(x.shape), x.dtype)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("k", QUANT_KS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_quantize_shapes_vs_plain(dtype, k):
    """The quantize engine at every M of QUANT_MS (both tiles, every store
    width) from LLM-like activations; two calls give the same bytes."""
    _need_cuda()
    gen = torch.Generator("cuda").manual_seed(k)
    x = (torch.randn(2048, k, generator=gen, device="cuda")
         * torch.exp(0.8 * torch.randn(1, k, generator=gen, device="cuda"))
         ).to(dtype)
    for m in QUANT_MS:
        got = _quantize_vs_plain(x[:m])
        again = ops.m2xfp_quantize(x[:m])
        assert all(torch.equal(got[s], again[s]) for s in got), m


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,offset", [(torch.bfloat16, 1),
                                          (torch.bfloat16, 2),
                                          (torch.bfloat16, 4),
                                          (torch.float32, 1),
                                          (torch.float32, 2)])
def test_cuda_quantize_unaligned_vs_plain(dtype, offset):
    """x a contiguous view at a storage offset that breaks the 16-byte
    alignment: the same kernel with narrower loads, one launch, the plain
    version's bytes, at both tiles."""
    _need_cuda()
    gen = torch.Generator("cuda").manual_seed(offset)
    for m, k in ((77, 288), (2048, 4096)):
        buf = (torch.randn(m * k + offset, generator=gen, device="cuda")
               * 3).to(dtype)
        x = buf[offset:].view(m, k)
        assert x.is_contiguous() and x.data_ptr() % 16
        assert quantize_plan(x.data_ptr(), m, k)[0] == offset * buf.element_size()
        _quantize_vs_plain(x)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_quantize_edge_inputs_vs_plain(dtype):
    """The edge rows of tests/test_torch_quantize_lanes.py (all-zero and
    -0.0 groups, negatives that round to 0, group maxima at 4, 6 and 8
    times 2^k and their neighbours, subnormal groups, bf16's largest
    finite values): as they are (the 8-row tile) and stacked to 2048 rows
    (the 32-row tile); two calls give the same bytes."""
    _need_cuda()
    from test_torch_quantize_lanes import edge_inputs
    x = torch.from_numpy(edge_inputs()).to(dtype).to("cuda")
    assert bool(torch.isfinite(x).all())
    for xin in (x, x.repeat(64, 1)):
        got = _quantize_vs_plain(xin)
        again = ops.m2xfp_quantize(xin)
        assert all(torch.equal(got[s], again[s]) for s in got)


@pytest.mark.gpu
def test_cuda_qmatmul_vs_plain():
    """The W4A4 GEMM within sqrt(K)*2^-24*(|Xdec| @ |Wdec|) of its plain
    version and of the serve GEMM on the same fake-quantized activations,
    and bit-equal to the serve GEMM on the decoded X (the same template and
    split plan), at M in {1, 8, 17, 64, 65, 129} (unaligned X rows at 1, 17,
    65 and 129, 8-byte copies at 8) with ragged N = 200 and at a K one group
    beyond 4096; rows independent of M, two calls equal, one launch per
    call, a refused K mismatch."""
    _need_cuda()
    gen = torch.Generator("cuda").manual_seed(3)
    n = 200
    for k in (4096, 4096 + 32):
        wp = layout.pack_w_sgem(torch.randn(k, n, generator=gen,
                                            device="cuda") * 0.02)
        x = torch.randn(129, k, generator=gen, device="cuda").to(
            torch.bfloat16)
        xp = ops.m2xfp_quantize(x)
        before = QKERNEL.launches
        got = ops.m2xfp_qmatmul(xp, wp)
        assert QKERNEL.launches == before + 1
        xdec = ref.decode_x_elem_em_ref(xp)
        bound = k ** 0.5 * 2.0 ** -24 * ref.dot_f64acc(
            xdec.abs(), ref.decode_w_sgem_ref(wp).abs())
        assert bool(((got - ref.m2xfp_qmatmul_ref(xp, wp)).abs()
                     <= bound).all())
        serve = ops.m2xfp_matmul(quantize_act_m2xfp(x).to(torch.bfloat16), wp)
        assert bool(((got - serve).abs() <= 2 * bound).all())
        assert torch.equal(got, ops.m2xfp_matmul(
            xdec.to(torch.bfloat16).contiguous(), wp))
        for m in (1, 8, 17, 64, 65):
            xpm = ops.m2xfp_quantize(x[:m].contiguous())
            part = ops.m2xfp_qmatmul(xpm, wp)
            assert torch.equal(part, got[:m]), (k, m)
            assert torch.equal(ops.m2xfp_qmatmul(xpm, wp), part), (k, m)
        assert torch.equal(ops.m2xfp_qmatmul(xp, wp), got), k
    with pytest.raises(ValueError, match="stream 'w codes'"):
        ops.m2xfp_qmatmul(xp, layout.pack_w_sgem(
            torch.zeros(2048, n, device="cuda")))


@pytest.mark.gpu
def test_cuda_flash_attention_vs_plain():
    """Flash attention within ref.flash_attention_tolerance of its plain
    version at the same block_k, with a window, a softcap on q scaled by 8
    (scores reach the cap), invalid keys, a padded query row (gives 0) and
    tails; one launch per call; the kernel without its softcap and a 2%
    scale error both flagged; a refused head dim."""
    _need_cuda()
    gen = torch.Generator("cuda").manual_seed(4)
    bh, s, hd = 4, 300, 128
    q, k, v = (torch.randn(bh, s, hd, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    pos = torch.arange(s, device="cuda", dtype=torch.int32).expand(
        bh, s).contiguous()
    pos_k = pos.clone()
    pos_k[:, -7:] = -1
    pos_q = pos.clone()
    pos_q[:, -1] = -1
    q8 = (q.float() * 8).to(torch.bfloat16)
    for qq, kw in ((q, dict()), (q, dict(window=100)),
                   (q8, dict(softcap=50.0))):
        args = (qq, k, v, pos_q, pos_k)
        before = FLASH_KERNEL.launches
        got = flash_attention_kernel(*args, block_k=128, **kw)
        assert FLASH_KERNEL.launches == before + 1
        want = ref.flash_attention_ref(*args, block_k=128, **kw)
        tol = ref.flash_attention_tolerance(*args, block_k=128, **kw)
        assert bool(((got - want).abs() <= tol).all()), kw
        assert bool((got[:, -1] == 0).all())
        scaled = ref.flash_attention_ref(qq * 1.02, *args[1:], block_k=128,
                                         **kw)
        assert bool(((got - scaled).abs() > tol).any()), kw
    no_cap = flash_attention_kernel(q8, k, v, pos_q, pos_k, block_k=128)
    assert bool(((no_cap - want).abs() > tol).any())
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_kernel(*(torch.zeros(1, 4, 300, device="cuda")
                                 for _ in range(3)), pos[:1, :4], pos[:1, :4])


@pytest.mark.gpu
def test_cuda_flash_attention_edges():
    """The tensor-core kernel at its edges, within ref.flash_attention_
    tolerance of its plain version and one launch per call: head dims 64,
    72 and 100 (padded to 80 and 112 inside), 80, 128 and 256 (two column
    blocks); Sq 1 and 300 against Skv 300; block_k 64, 100 (a short
    sub-tile in every block), 512 and 1024; f32 and bf16 inputs (bf16 at
    hd 100 takes the unaligned copy path); causal with invalid keys, and a
    window of 20 keys, smaller than a 64-key sub-tile, with a softcap."""
    _need_cuda()
    gen = torch.Generator("cuda").manual_seed(5)
    bh, skv = 2, 300
    for hd in (64, 72, 80, 100, 128, 256):
        base = [torch.randn(bh, s, hd, generator=gen, device="cuda")
                for s in (skv, skv, skv)]
        for sq in (1, 300):
            pos_q = (torch.arange(sq, device="cuda", dtype=torch.int32)
                     + (skv - sq)).expand(bh, sq).contiguous()
            pos_k = torch.arange(skv, device="cuda", dtype=torch.int32).expand(
                bh, skv).contiguous()
            pos_k[:, -7:] = -1
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (t.to(dtype) for t in base)
                q = q[:, skv - sq:].contiguous()
                for block_k in (64, 100, 512, 1024):
                    for kw in (dict(), dict(window=20, softcap=5.0)):
                        args = (q, k, v, pos_q, pos_k)
                        before = FLASH_KERNEL.launches
                        got = flash_attention_kernel(*args, block_k=block_k,
                                                     **kw)
                        assert FLASH_KERNEL.launches == before + 1
                        want = ref.flash_attention_ref(*args, block_k=block_k,
                                                       **kw)
                        tol = ref.flash_attention_tolerance(
                            *args, block_k=block_k, **kw)
                        where = (hd, sq, dtype, block_k, kw)
                        assert got.shape == (bh, sq, hd), where
                        assert bool(((got - want).abs() <= tol).all()), where


# ------------------------------------------------ packed KV cache on the card

@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["m2xfp", "mxfp4"])
def test_cuda_kv_encode_decode_equal_cpu(fmt):
    """kv_encode and kv_decode on the card give the bytes and bf16 bits of
    the same calls on the CPU, at full width (8 slots x 32 heads x hd 128)
    over 64 draws: normal rows at scales 2^-20..2^20, heavy-tailed rows,
    bf16-rounded rows (the model's K/V) and random page bytes to decode.
    Every group maximum is 0 or >= 2^-100 (ROADMAP, queue C)."""
    _need_cuda()
    from repro_torch.models.kvquant import kv_cache_spec, kv_decode, \
        kv_encode
    rng = np.random.default_rng(7)
    shape = (8, 1, 32, 128)
    for i in range(64):
        if i % 2:
            x = heavy_tailed(rng, (256, 128)).reshape(shape)
        else:
            x = rng.standard_normal(shape).astype(np.float32)
        x *= np.float32(2.0 ** rng.integers(-20, 21))
        xs = [torch.from_numpy(x)]
        xs.append(xs[0].to(torch.bfloat16))
        for xc in xs:
            want = kv_encode(xc, fmt)
            got = kv_encode(xc.cuda(), fmt)
            for k in want:
                assert torch.equal(got[k].cpu(), want[k]), (i, k, xc.dtype)
            assert torch.equal(kv_decode(got, fmt).cpu(),
                               kv_decode(want, fmt)), (i, xc.dtype)
        page = {k: torch.from_numpy(rng.integers(
            2 if k == "scales" else 0, 256, v.shape, dtype=np.uint8))
            for k, v in kv_cache_spec(8, 64, 32, 128, fmt, "cpu").items()}
        got = kv_decode({k: v.cuda() for k, v in page.items()}, fmt).cpu()
        assert torch.equal(got.view(torch.int16),
                           kv_decode(page, fmt).view(torch.int16)), i


# ------------------------------------------ chunked prefill == decode (C1)

def _trace_labels(n_layers: int) -> list:
    """The traced ops of one serve step, in call order."""
    gemm = [f"{w} {io}" for w in ("wq", "wk", "wv", "wo") for io in
            ("input", "output")]
    ffn = [f"{w} {io}" for w in ("gate", "up", "down") for io in
           ("input", "output")]
    return [f"layer {i} {op}" for i in range(n_layers)
            for op in ["attn_norm", *gemm, "ffn_norm", *ffn]] + ["final_norm"]


def _serve_trace(monkeypatch) -> list:
    """Record, in call order, every rms_norm output of the model and every
    packed GEMM's input (the fake-quantized bf16 activations) and output;
    returns the list the calls append (kind, tensor) to."""
    from repro_torch.models import model, quant
    log, norm, gemm = [], model.rms_norm, quant.packed_matmul

    def rms_norm(x, w, eps=1e-5):
        out = norm(x, w, eps)
        log.append(("norm", out.clone()))
        return out

    def packed_matmul(x, w, fmt):
        out = gemm(x, w, fmt)
        log.extend([("input", x.clone()), ("output", out.clone())])
        return out

    monkeypatch.setattr(model, "rms_norm", rms_norm)
    monkeypatch.setattr(quant, "packed_matmul", packed_matmul)
    return log


def _prefill_vs_decode(params, cfg, tokens, log, caches=None, index=None,
                       lengths=None):
    """Feed tokens (B, T) (embeddings (B, T, d) under
    ``input_mode="embeddings"``) through one prefill_chunk on ``caches``
    (fresh caches, positions from 0 and every row valid when None) and one
    at a time through decode_step on a copy of them; ``log`` is _serve_trace's.
    Returns (prefill logits (B, T, V), decode logits (B, T, V), the first
    traced op whose valid row differs between the two as (label, position,
    differing elements, max |difference|), or None, the decode side's
    caches)."""
    from repro_torch.models.model import decode_step, init_caches, \
        prefill_chunk
    b, t = tokens.shape[:2]
    dev = tokens.device
    key = "embeds" if cfg.input_mode == "embeddings" else "tokens"
    if caches is None:
        caches = init_caches(cfg, b, t, dev)
        index = torch.zeros(b, dtype=torch.long, device=dev)
        lengths = torch.full((b,), t, device=dev)
    copy = _clone_caches(caches)
    log.clear()
    got = prefill_chunk(params, cfg, {key: tokens}, caches, index, lengths)
    chunk_log, step_logs, steps = list(log), [], []
    for i in range(t):
        log.clear()
        steps.append(decode_step(params, cfg, {key: tokens[:, i:i + 1]},
                                 copy, index + i)[:, 0])
        step_logs.append(list(log))
    log.clear()
    labels = _trace_labels(cfg.n_layers)
    for trace in (chunk_log, *step_logs):
        assert [k for k, _ in trace] == [
            "norm" if "norm" in lb else lb.rsplit(" ", 1)[1] for lb in labels]
    first = None
    for j, label in enumerate(labels):
        pre = chunk_log[j][1].reshape(b, t, -1)
        for i in range(t):
            live = lengths > i
            p, d = pre[live, i], step_logs[i][j][1].reshape(b, -1)[live]
            if not torch.equal(p, d):
                first = (label, i, int((p != d).sum()),
                         float((p.float() - d.float()).abs().max()))
                break
        if first is not None:
            break
    return got, torch.stack(steps, 1), first, copy


def _check_prefill_full_width(fmt, kv_quant, monkeypatch):
    """Full-width paper-llama2-7b (d 4096, ff 11008, vocab 32000) cut to 2
    layers, random packed weights from a seeded CUDA generator, a bf16 or
    packed KV cache: one prefill chunk of 8 tokens in 8 slots gives the
    logits of the same tokens fed through decode_step, bit for bit at every
    position, and leaves the same cache bytes. On failure the message names
    the first norm, GEMM input or GEMM output whose row differs."""
    _need_cuda()
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_caches
    from repro_torch.serve.prequant import init_packed_params
    cfg = get_config("paper-llama2-7b", quant="serve", quant_format=fmt,
                     kv_quant=kv_quant, n_layers=2)
    params = init_packed_params(torch.Generator("cuda").manual_seed(0), cfg,
                                "cuda")
    tokens = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.vocab_size, (8, 8))).cuda()
    caches = init_caches(cfg, 8, 8, "cuda")
    got, want, first, seq_caches = _prefill_vs_decode(
        params, cfg, tokens, _serve_trace(monkeypatch), caches,
        torch.zeros(8, dtype=torch.long, device="cuda"),
        torch.full((8,), 8, device="cuda"))
    assert bool(torch.isfinite(got).all())
    assert first is None, f"first op whose rows differ: {first}"
    assert torch.equal(got, want)
    for i, (a, b) in enumerate(zip(caches["layers"],
                                   seq_caches["layers"])):
        for name in a:
            pa, pb = (a[name], b[name]) if isinstance(a[name], dict) \
                else ({"": a[name]}, {"": b[name]})
            for s in pa:
                assert torch.equal(pa[s], pb[s]), (i, name, s)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", KV_QUANTS)
@pytest.mark.parametrize("fmt", ["m2xfp", "mxfp4"])
def test_prefill_chunk_bitexact_vs_decode_full_width(fmt, kv_quant,
                                                     monkeypatch):
    """_check_prefill_full_width for m2xfp and mxfp4 weights."""
    _check_prefill_full_width(fmt, kv_quant, monkeypatch)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", ["none", "m2xfp_ideal6"])
def test_ideal6_prefill_chunk_bitexact_vs_decode_full_width(kv_quant,
                                                            monkeypatch):
    """_check_prefill_full_width for the ideal-FP6 ablation (m2xfp's
    weights and kernel, unclamped FP6 activations), with a bf16 and its
    own packed KV cache."""
    _check_prefill_full_width("m2xfp_ideal6", kv_quant, monkeypatch)


@pytest.mark.gpu
def test_rms_norm_rows_bitexact_full_width():
    """C1's first differing op, held on its own: at d = 4096, rms_norm gives
    a row the same bits among the 64 rows of a prefill chunk (8 slots x 8
    positions) as among the 8 rows of a decode step, over 512 chunks of bf16
    rows with log-normal channel scales (a residual stream's spread)."""
    _need_cuda()
    from repro_torch.models.layers import rms_norm
    gen = torch.Generator("cuda").manual_seed(6)
    d = 4096
    w = torch.ones(d, device="cuda")
    ch = torch.exp(0.8 * torch.randn(d, generator=gen, device="cuda"))
    differ = 0
    for _ in range(512):
        x = (torch.randn(8, 8, d, generator=gen, device="cuda") * ch).to(
            torch.bfloat16)
        chunk = rms_norm(x, w)
        for t in range(8):
            step = rms_norm(x[:, t:t + 1].contiguous(), w)
            differ += int((step != chunk[:, t:t + 1]).any(-1).sum())
    assert differ == 0, f"{differ} of {512 * 64} rows differ"


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", KV_QUANTS)
@pytest.mark.parametrize("fmt", ["m2xfp", "mxfp4"])
def test_engine_prefill_launches_bitexact_vs_decode(fmt, kv_quant,
                                                    monkeypatch):
    """chip_smoke.py's serve traffic (full-width, full-depth paper-llama2-7b
    from seed 0; 16 prompts of 16-128 tokens from seed 0; 8 slots, chunks
    of 8, 512 positions; a bf16 or packed KV cache): each of the engine's
    first three launches, all prefill, gives at every valid row and
    position the bits of decode_step fed the same tokens on a copy of the
    caches, every traced op and the logits; the launch's own result drives
    the engine on."""
    _need_cuda()
    from repro_torch.configs import get_config
    _check_engine_prefill_launches(
        get_config("paper-llama2-7b", quant="serve", quant_format=fmt,
                   kv_quant=kv_quant), 512, 3, monkeypatch)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,max_len,n_launches", [("gemma2-9b", 64, 10),
                                                     ("qwen3-8b", 512, 3),
                                                     ("qwen2-0.5b", 512, 3)])
def test_engine_prefill_launches_bitexact_vs_decode_variants(
        arch, max_len, n_launches, monkeypatch):
    """The same on full-width gemma2-9b (local/global layers, both
    soft-caps, the tied 256,000-row head) with 64 positions over its first
    10 launches, which carry the long prompts past position 64, so its
    local and global rings wrap; on qwen3-8b (qk-norm); and on qwen2-0.5b
    (QKV bias, the tied 151,936-row head); all at 2 layers, with seeded
    biases and qk-norm weights. The tied head's cuBLAS product must give a
    row the same bits at 64 rows as at 8."""
    _need_cuda()
    from repro_torch.configs import get_config
    eng = _check_engine_prefill_launches(
        get_config(arch, quant="serve", n_layers=2), max_len, n_launches,
        monkeypatch)
    if eng.cfg.sliding_window:
        assert int(eng._index.max()) > max_len


def _check_engine_prefill_launches(cfg, max_len: int, n_launches: int,
                                   monkeypatch):
    """test_engine_prefill_launches_bitexact_vs_decode on ``cfg`` with
    pages of ``max_len`` positions, over the first ``n_launches`` launches
    (all prefill), with the QKV biases and qk-norm weights ``cfg`` has
    seeded (``fill_attention_extras``). Returns the engine."""
    from repro_torch.serve import engine
    from repro_torch.serve.prequant import init_packed_params
    from repro_torch.testing import fill_attention_extras
    params = fill_attention_extras(init_packed_params(
        torch.Generator("cuda").manual_seed(0), cfg, "cuda"), cfg)
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in rng.choice(np.arange(16, 129), 16)]
    log, launches = _serve_trace(monkeypatch), []

    def shadowed(params, cfg, batch, caches, index, lengths):
        got, want, first, _ = _prefill_vs_decode(
            params, cfg, batch["tokens"], log, caches, index, lengths)
        valid = lengths[:, None] > torch.arange(got.shape[1],
                                                device=got.device)
        launches.append((first, torch.equal(got[valid], want[valid])))
        return got

    monkeypatch.setattr(engine, "prefill_chunk", shadowed)
    eng = engine.ServeEngine(params, cfg, n_slots=8, max_len=max_len,
                             prefill_chunk=8, device="cuda")
    for p in prompts:
        eng.submit(p, 32)
    while len(launches) < n_launches:
        eng.step()
    assert eng.stats.prefill_steps == n_launches
    for i, (first, same) in enumerate(launches):
        assert first is None, f"launch {i + 1}: first op whose rows " \
                              f"differ: {first}"
        assert same, f"launch {i + 1}: logits differ"
    return eng


def _smoke_params(fmt):
    from repro_torch.configs import smoke_config
    from repro_torch.serve.prequant import init_packed_params
    cfg = smoke_config("paper-llama2-7b", quant="serve", quant_format=fmt)
    return init_packed_params(torch.Generator().manual_seed(0), cfg,
                              "cpu"), cfg


@pytest.mark.parametrize("fmt", ["m2xfp", "mxfp4"])
def test_prefill_vs_decode_trace_on_cpu(fmt, monkeypatch):
    """The full-width test's comparison at smoke size on the CPU: every
    traced op agrees and so do the logits."""
    params, cfg = _smoke_params(fmt)
    tokens = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.vocab_size, (3, 5)))
    got, want, first, _ = _prefill_vs_decode(params, cfg, tokens,
                                             _serve_trace(monkeypatch))
    assert first is None, first
    assert torch.equal(got, want)


def test_prefill_vs_decode_trace_names_a_planted_fault_on_cpu(monkeypatch):
    """A norm whose result depends on the row count (one ulp of the f32
    sum of squares on rows that share a call with others) is named as the
    first op that differs, at layer 0's ffn_norm, where it is planted."""
    from repro_torch.models import layers, model
    params, cfg = _smoke_params("m2xfp")
    calls = []

    def row_dependent(x, w, eps=1e-5):
        calls.append(None)
        out = layers.rms_norm(x, w, eps)
        if len(calls) == 2 and x.shape[1] > 1:       # layer 0's ffn_norm
            out = layers.rms_norm(x * (1 + 2.0 ** -7), w, eps)
        return out

    monkeypatch.setattr(model, "rms_norm", row_dependent)
    tokens = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.vocab_size, (3, 5)))
    _, _, first, _ = _prefill_vs_decode(params, cfg, tokens,
                                        _serve_trace(monkeypatch))
    assert first is not None and first[0] == "layer 0 ffn_norm", first


# ---------------------------------------------------------------------------
# The serving guard on the card
# ---------------------------------------------------------------------------

def _to_device(tree, device):
    from repro_torch.core.codecs import PackedTensor
    if isinstance(tree, PackedTensor):
        return PackedTensor({s: t.to(device) for s, t in tree.streams.items()},
                            tree.shape, tree.codec)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def _to_cpu(tree):
    return _to_device(tree, "cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", ["none", "m2xfp"])
def test_cuda_probes_equal_cpu(kv_quant):
    """probe_kv and probe_logits on the card count what they count on the
    CPU: full-width paper-llama2-7b caches (2 layers, 8 slots x 512
    positions) with NaNs or 255 scale bytes planted at random entries of
    random slots (packed codes and meta bytes random, so all legal), and
    (8, 32000) logits with non-finite entries, idle rows masked."""
    _need_cuda()
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_caches
    from repro_torch.serve.guard import probe_kv, probe_logits
    cfg = get_config("paper-llama2-7b", quant="serve", kv_quant=kv_quant,
                     n_layers=2)
    gen = torch.Generator("cuda").manual_seed(5)
    caches = init_caches(cfg, 8, 512, "cuda")
    for layer in caches["layers"]:
        for name in ("k", "v"):
            page = layer[name]
            for s, t in (page.items() if isinstance(page, dict)
                         else [("", page)]):
                if t.dtype == torch.bfloat16:
                    t.copy_(torch.randn(t.shape, generator=gen,
                                        device="cuda"))
                    bad = torch.rand(t.shape, generator=gen,
                                     device="cuda") < 1e-6
                    t[bad] = float("nan")
                else:
                    hi = 255 if s == "scales" else 256
                    t.copy_(torch.randint(0, hi, t.shape, generator=gen,
                                          device="cuda", dtype=torch.uint8))
                    if s == "scales":
                        t[torch.rand(t.shape, generator=gen,
                                     device="cuda") < 1e-5] = 255
    got = probe_kv(caches, 8)
    assert got.device.type == "cuda" and int(got.sum()) > 0
    assert torch.equal(got.cpu(), probe_kv(_to_cpu(caches), 8))
    logits = torch.randn(8, 32000, generator=gen, device="cuda")
    logits[1, ::7] = float("nan")
    logits[4, 3] = float("inf")
    logits[6, 5] = -float("inf")
    lengths = torch.tensor([1, 1, 0, 1, 3, 1, 0, 1], device="cuda")
    for ln in (None, lengths):
        want = probe_logits(logits.cpu(), None if ln is None else ln.cpu())
        assert torch.equal(probe_logits(logits, ln).cpu(), want)
    assert probe_logits(logits, lengths).tolist() == \
        [0, 4572, 0, 0, 1, 0, 0, 0]


@pytest.mark.gpu
def test_cuda_validate_packed_tree_equals_cpu():
    """validate_packed_tree on full-width packed weights on the card (2
    layers) gives the CPU's report: intact, then with scale bytes 0 and 255
    planted in three weights and two layers."""
    _need_cuda()
    from repro_torch.configs import get_config
    from repro_torch.core.codecs import validate_packed_tree
    from repro_torch.serve.prequant import init_packed_params
    cfg = get_config("paper-llama2-7b", quant="serve", n_layers=2)
    params = init_packed_params(torch.Generator("cuda").manual_seed(0), cfg,
                                "cuda")
    assert validate_packed_tree(params) == {}
    for layer, key, at, byte in ((1, ("attn", "wq"), (3, 100), 255),
                                 (1, ("attn", "wq"), (40, 7), 0),
                                 (0, ("ffn", "down"), (343, 4095), 255),
                                 (1, ("ffn", "up"), (0, 0), 0)):
        params["layers"][layer][key[0]][key[1]].streams["scales"][at] = byte
    got = validate_packed_tree(params)
    assert got == validate_packed_tree(_to_cpu(params))
    assert got["layers/attn/wq"] == [
        "2 scale byte(s) outside the legal e8m0 range [1, 254] (first at "
        "index (1, 3, 100), byte 255)"]
    assert sorted(got) == ["layers/attn/wq", "layers/ffn/down",
                           "layers/ffn/up"]


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", ["none", "m2xfp"])
def test_cuda_quarantine_keeps_survivors_bit_identical(kv_quant):
    """Full-width paper-llama2-7b at 2 layers on the card, 6 requests in 4
    slots: the guard (on by default) changes no token against guard=False;
    under a KV poison and a NaN logit row exactly the planned slots'
    requests are quarantined, every other request (one of them served in a
    scrubbed slot) keeps its fault-free tokens, and a transient failure is
    retried without losing a token."""
    _need_cuda()
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.prequant import init_packed_params
    from repro_torch.testing import FaultInjector, FaultPlan
    cfg = get_config("paper-llama2-7b", quant="serve", kv_quant=kv_quant,
                     n_layers=2)
    params = init_packed_params(torch.Generator("cuda").manual_seed(0), cfg,
                                "cuda")
    rng = np.random.default_rng(2)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in (9, 12, 8, 10, 7, 11)]

    def run(plan=None, **kw):
        eng = ServeEngine(params, cfg, n_slots=4, max_len=64,
                          prefill_chunk=8, device="cuda", **kw)
        reqs = [eng.submit(p, 8) for p in prompts]
        if plan is None:
            eng.run()
        else:
            with FaultInjector(eng, plan):
                eng.run()
        return eng, reqs

    _, clean = run()
    _, off = run(guard=False)
    assert [r.output for r in off] == [r.output for r in clean]
    # steps 3 and 4 are decode steps of requests 0-3 (prefill: 2 steps)
    eng, reqs = run(FaultPlan(seed=1, kv_poison_steps=((3, 1),),
                              nan_logit_steps=((4, 2),), fail_steps=(5,)))
    assert [r.state for r in reqs] == ["finished", "quarantined",
                                       "quarantined", "finished",
                                       "finished", "finished"]
    assert [reqs[i].fail_reason for i in (1, 2)] == ["kv", "logits"]
    for i in (0, 3, 4, 5):
        assert reqs[i].output == clean[i].output, i
    summary = eng.guard_summary()
    assert (summary["quarantines"], summary["retries"],
            summary["scrubs"]) == (2, 1, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", ["none", "m2xfp"])
def test_cuda_probe_and_scrub_mixed_width_equal_cpu(kv_quant):
    """gemma2-9b at full width, 2 layers, 8 slots and 4608 positions: a
    local ring of 4096 and a global ring of 4608. On random pages with NaNs
    or 255 scale bytes planted in both rings, probe_kv on the card counts
    what it counts on the CPU, and ``_reset_slot(scrub=True)`` of two slots
    leaves the CPU's bytes in every page and position track."""
    _need_cuda()
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_caches
    from repro_torch.serve.engine import _reset_slot
    from repro_torch.serve.guard import probe_kv
    cfg = get_config("gemma2-9b", quant="serve", kv_quant=kv_quant,
                     n_layers=2)
    gen = torch.Generator("cuda").manual_seed(9)
    caches = init_caches(cfg, 8, 4608, "cuda")
    assert [c["pos"].shape[1] for c in caches["layers"]] == [4096, 4608]
    for layer in caches["layers"]:
        layer["pos"].copy_(torch.randint(0, 4608, layer["pos"].shape,
                                         generator=gen, device="cuda"))
        for name in ("k", "v"):
            page = layer[name]
            for s, t in (page.items() if isinstance(page, dict)
                         else [("", page)]):
                if t.dtype == torch.bfloat16:
                    t.copy_(torch.randn(t.shape, generator=gen,
                                        device="cuda"))
                    t[torch.rand(t.shape, generator=gen,
                                 device="cuda") < 1e-7] = float("nan")
                else:
                    t.copy_(torch.randint(0, 255 if s == "scales" else 256,
                                          t.shape, generator=gen,
                                          device="cuda", dtype=torch.uint8))
                    if s == "scales":
                        t[torch.rand(t.shape, generator=gen,
                                     device="cuda") < 1e-5] = 255
    cpu = _to_cpu(caches)
    got = probe_kv(caches, 8)
    assert int(got.sum()) > 0
    assert torch.equal(got.cpu(), probe_kv(cpu, 8))
    for slot in (2, 5):
        _reset_slot(caches, slot, scrub=True)
        _reset_slot(cpu, slot, scrub=True)
    assert torch.equal(probe_kv(caches, 8).cpu(), probe_kv(cpu, 8))
    for i, (a, b) in enumerate(zip(caches["layers"], cpu["layers"])):
        for name in a:
            pa, pb = (a[name], b[name]) if isinstance(a[name], dict) \
                else ({"": a[name]}, {"": b[name]})
            for s in pa:
                assert torch.equal(pa[s].cpu().view(torch.uint8),
                                   pb[s].view(torch.uint8)), (i, name, s)


@pytest.mark.gpu
def test_cuda_softcap_and_tied_head_equal_cpu():
    """gemma2-9b's final norm, tied 256,000-row head and final soft-cap on
    the card against the CPU, on the same bf16 embedding and residual rows:
    within the GEMM's expected f32 rounding, sqrt(K) * 2^-24 * (|h| @ |E|^T)
    (chip_smoke's TOLERANCE; the cap's slope is at most 1), plus
    SOFTCAP_ULPS ulps for the two tanh implementations; a row gets the same
    bits among 64 rows as among 8 (chunked prefill == decode). And the
    soft-cap alone on scores and logits within SOFTCAP_ULPS ulps."""
    _need_cuda()
    from test_torch_variants import SOFTCAP_ULPS, softcap_input
    from repro_torch.configs import get_config
    from repro_torch.models.layers import rms_norm, softcap
    from repro_torch.models.model import _logits
    for cap in (30.0, 50.0):
        x = torch.from_numpy(softcap_input())
        want = softcap(x, cap)
        got = softcap(x.cuda(), cap).cpu()
        ulps = (got - want).abs() / torch.from_numpy(
            np.spacing(want.abs().numpy()))
        assert float(ulps.max()) <= SOFTCAP_ULPS, (cap, float(ulps.max()))
    cfg = get_config("gemma2-9b", quant="serve", n_layers=0)
    gen = torch.Generator("cuda").manual_seed(12)
    params = {"embed": (torch.randn(cfg.vocab_size, cfg.d_model,
                                    generator=gen, device="cuda")
                        * 0.02).to(torch.bfloat16),
              "final_norm": torch.ones(cfg.d_model, device="cuda")}
    h = (torch.randn(64, 1, cfg.d_model, generator=gen, device="cuda")
         * 4).to(torch.bfloat16)
    got = _logits(params, cfg, h)
    assert torch.equal(_logits(params, cfg, h[:8]), got[:8])
    cpu = _to_cpu(params)
    want = _logits(cpu, cfg, h.cpu())
    hn = rms_norm(h.cpu(), cpu["final_norm"]).double()
    tol = cfg.d_model ** 0.5 * 2.0 ** -24 * (
        hn.abs() @ cpu["embed"].double().abs().T) + SOFTCAP_ULPS * \
        torch.from_numpy(np.spacing(want.abs().numpy())).double()
    assert float(want.abs().max()) > 1.0          # the cap bends the logits
    assert bool(((got.cpu().double() - want.double()).abs() <= tol).all())


# ---------------------------------------------------------------------------
# The codec matrix on the card
# ---------------------------------------------------------------------------

# a flip of one FP4 step in a few activations of the last layers, at
# this model's scale (test_cuda_engine_codecs_match_cpu)
LAST_TOL_NVFP4 = 0.25
CODEC_NAMES = ["fp4", "m2nvfp4", "m2xfp", "m2xfp_ideal6", "mxfp4", "nvfp4",
               "smx4"]


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("name", CODEC_NAMES)
def test_cuda_fake_quant_equals_cpu(name):
    """Every codec's fake_quant_act (heavy-tailed (8, 4096) and bf16-rounded
    (64, 1024) activations, and rows scaled by 2^-20..2^20) and
    fake_quant_weight (a (1024, 256) weight, groups along K) give the CPU's
    f32 bits on the card: the port divides where the code divides
    (``div_const``) and takes a correctly rounded log2 (``log2_f32``) on
    both devices. Every group maximum is 0 or >= 2^-100."""
    _need_cuda()
    from repro_torch.models.quant import fake_quant_act, fake_quant_weight
    rng = np.random.default_rng(12)
    acts = [heavy_tailed(rng, (8, 4096), ch_sigma=2.0),
            heavy_tailed(rng, (64, 1024)),
            rng.standard_normal((41, 512)).astype(np.float32)
            * np.float32(2.0) ** rng.integers(-20, 21, (41, 1))]
    acts[1] = torch.from_numpy(acts[1]).to(torch.bfloat16).float().numpy()
    for i, x in enumerate(acts):
        xt = torch.from_numpy(x)
        assert _same_bits(fake_quant_act(xt.cuda(), name).cpu(),
                          fake_quant_act(xt, name)), (name, i)
    w = torch.from_numpy(heavy_tailed(rng, (1024, 256)))
    assert _same_bits(fake_quant_weight(w.cuda(), name).cpu(),
                      fake_quant_weight(w, name)), name


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["floor", "ceil", "rtn1", "rtn2", "rtne"])
def test_cuda_scale_rules_equal_cpu(rule):
    """The five scale rules on the card: exponents at the edges where a
    log2 is rounded (M sqrt(2) 2^k, M 2^k and their neighbours), and MXFP4
    and m2xfp fake-quant by rule, equal the CPU's."""
    _need_cuda()
    from repro_torch.core.formats import quantize_mxfp4
    from repro_torch.core.m2xfp import quantize_weight_m2xfp
    from repro_torch.core.scaling import shared_scale_exponent
    ks = np.arange(-110, 111, dtype=np.float64)
    amax = np.concatenate([np.float32(b * 2 ** ks) for b in
                           (6.0, 4.0, 6.0 * 2 ** 0.5, 4.0 * 2 ** 0.5)])
    amax = np.concatenate([amax, np.nextafter(amax, np.float32(np.inf)),
                           np.nextafter(amax, np.float32(0))])
    a = torch.from_numpy(amax.astype(np.float32))
    assert torch.equal(shared_scale_exponent(a.cuda(), rule).cpu(),
                       shared_scale_exponent(a, rule))
    x = torch.from_numpy(heavy_tailed(np.random.default_rng(13), (64, 2048)))
    for fn in (quantize_mxfp4, quantize_act_m2xfp, quantize_weight_m2xfp):
        assert _same_bits(fn(x.cuda(), rule=rule).cpu(), fn(x, rule=rule)), \
            fn.__name__


@pytest.mark.gpu
def test_cuda_pack_w_nvfp4_equals_cpu():
    """pack_w_nvfp4 on the card writes the CPU's codes, E4M3 scale bytes
    and tensor-scale bits, and its decode gives the CPU's f32 bits."""
    _need_cuda()
    from repro_torch.core.codecs import get_codec
    rng = np.random.default_rng(14)
    for w in (heavy_tailed(rng, (1024, 384)),
              rng.standard_normal((512, 64)).astype(np.float32) * 1e-3):
        wt = torch.from_numpy(w)
        want = layout.pack_w_nvfp4(wt)
        got = layout.pack_w_nvfp4(wt.cuda())
        for k in want:
            assert torch.equal(got[k].cpu().view(torch.uint8),
                               want[k].view(torch.uint8)), k
        dec = get_codec("nvfp4").decode
        assert _same_bits(dec(got, *w.shape).cpu(), dec(want, *w.shape))


def _card_cfg(**kw):
    """test_cuda_engine_codecs_match_cpu's model: 2 layers, d 256, hd 64."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(name="codec-card", family="dense", n_layers=2,
                       d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                       vocab_size=512, quant="serve", **kw)


def _check_engine_card_matches_cpu(cfg, params, last_tol: float):
    """The engine on the CPU and on the card (``params`` copied there), 6
    requests through 4 slots with pages of 32 positions and chunks of 4,
    the card's run fed the CPU run's tokens: the same tokens, and the
    logits of the first launch within 2e-3 of the CPU's and of the last
    within ``last_tol`` (|logits| < 4). Returns the card's engine."""
    from repro_torch.serve.engine import ServeEngine
    rng = np.random.default_rng(15)
    prompts = [list(map(int, rng.integers(0, 512, n)))
               for n in (5, 9, 3, 12, 7, 4)]
    cpu_logits, cpu_tokens = [], []

    def record(logits):
        cpu_logits.append(logits)
        cpu_tokens.append(np.argmax(logits, axis=-1))
        return cpu_tokens[-1]

    cpu = ServeEngine(params, cfg, n_slots=4, max_len=32, prefill_chunk=4,
                      sample_fn=record, device="cpu")
    want = cpu.generate(prompts, 6)
    card_logits = []

    def forced(logits):
        card_logits.append(logits)
        return cpu_tokens[len(card_logits) - 1]

    card = ServeEngine(_to_device(params, "cuda"), cfg, n_slots=4, max_len=32,
                       prefill_chunk=4, sample_fn=forced, device="cuda")
    assert card.generate(prompts, 6) == want
    assert len(card_logits) == len(cpu_logits) == card.stats.steps
    for i, tol in ((0, 2e-3), (-1, last_tol)):
        assert np.abs(cpu_logits[i]).max() < 4
        np.testing.assert_allclose(card_logits[i], cpu_logits[i], rtol=0,
                                   atol=tol, err_msg=str(i))
    return card


@pytest.mark.gpu
@pytest.mark.parametrize("fmt,kv_quant", [("m2xfp_ideal6", "none"),
                                          ("m2xfp_ideal6", "m2xfp_ideal6"),
                                          ("nvfp4", "none")])
def test_cuda_engine_codecs_match_cpu(fmt, kv_quant):
    """The engine on the card against the engine on the CPU, on the same
    packed bytes (2 layers, d 256, hd 64, 6 requests through 4 slots,
    chunks of 4). The card's run is fed the CPU run's tokens, so both see
    the same inputs at every launch. The first launch (prefill) and the
    last (decode) give logits within 2e-3 of the CPU's (|logits| < 4): the
    GEMMs' f32 summation orders differ and can move an activation across a
    rounding edge of the next fake-quant. nvfp4's last launch is held
    within LAST_TOL_NVFP4 only: its per-tensor scale t = amax / 2688 puts
    many bf16 activations exactly on an FP4 rounding tie, so an ulp of
    difference in one tensor's maximum flips many elements at once (on the
    CPU an ulp of t alone moves a small model's logits by more than 1e-2,
    tests/test_torch_codecs.py::test_nvfp4_tensor_scale_ulp_moves_logits;
    on the card this test's last launch differed by 0.161, NVIDIA H100
    80GB HBM3, 700 W). m2xfp_ideal6 launches kernel #1 7 times per layer
    per launch, nvfp4 no dequant-GEMM."""
    _need_cuda()
    from repro_torch.serve.prequant import init_packed_params
    cfg = _card_cfg(quant_format=fmt, kv_quant=kv_quant)
    params = init_packed_params(torch.Generator().manual_seed(0), cfg, "cpu")
    for k in (M2XFP_KERNEL, MXFP4_KERNEL, QUANTIZE_KERNEL, QKERNEL):
        k.launches = 0
    card = _check_engine_card_matches_cpu(
        cfg, params, LAST_TOL_NVFP4 if fmt == "nvfp4" else 2e-3)
    expected = 7 * cfg.n_layers * card.stats.steps if fmt != "nvfp4" else 0
    assert M2XFP_KERNEL.launches == expected
    assert MXFP4_KERNEL.launches == QUANTIZE_KERNEL.launches == \
        QKERNEL.launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [
    dict(qkv_bias=True, tie_embeddings=True),
    dict(qk_norm=True),
    dict(local_global=True, sliding_window=8, attn_softcap=50.0,
         final_softcap=30.0, tie_embeddings=True),
], ids=["qkv_bias-tied", "qk_norm", "local_global-softcaps-tied"])
def test_cuda_engine_variants_match_cpu(variant):
    """test_cuda_engine_codecs_match_cpu's comparison on the m2xfp engine
    for each attention variant, with seeded QKV biases and qk-norm weights
    (``fill_attention_extras``), so that a bias or norm weight the card
    dropped would show; the window of 8 is narrower than the longest
    request (12 + 6 tokens), so its rings wrap. Kernel #1 runs 7 times per
    layer per launch."""
    _need_cuda()
    from repro_torch.serve.prequant import init_packed_params
    from repro_torch.testing import fill_attention_extras
    cfg = _card_cfg(quant_format="m2xfp", **variant)
    params = fill_attention_extras(init_packed_params(
        torch.Generator().manual_seed(0), cfg, "cpu"), cfg)
    M2XFP_KERNEL.launches = 0
    card = _check_engine_card_matches_cpu(cfg, params, 2e-3)
    assert M2XFP_KERNEL.launches == 7 * cfg.n_layers * card.stats.steps


# ---------------------------------------------------------------------------
# Mixture-of-experts and embedding input
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch,overrides", [
    ("olmoe-1b-7b", {"n_experts": 64}), ("mixtral-8x22b", {})],
    ids=["packed-experts", "dense-experts"])
def test_cuda_engine_moe_match_cpu(arch, overrides):
    """test_cuda_engine_codecs_match_cpu's comparison on the MoE smoke
    models: olmoe-smoke with 64 experts (packed (K, E, N) experts, decoded
    on the card) and mixtral-smoke (4 dense bf16 experts, window 32). The
    card's engine fed the CPU run's tokens gives logits within 2e-3 at the
    first and the last launch; kernel #1 runs 4 times per layer per launch
    (q, k, v, o: the experts take no kernel)."""
    _need_cuda()
    from repro_torch.configs import smoke_config
    from repro_torch.serve.prequant import init_packed_params
    cfg = smoke_config(arch, quant="serve", **overrides)
    params = init_packed_params(torch.Generator().manual_seed(0), cfg, "cpu")
    M2XFP_KERNEL.launches = 0
    card = _check_engine_card_matches_cpu(cfg, params, 2e-3)
    assert M2XFP_KERNEL.launches == 4 * cfg.n_layers * card.stats.steps


@pytest.mark.gpu
@pytest.mark.parametrize("n_experts,topk", [(64, 8), (8, 2)])
def test_cuda_moe_routing_equals_cpu(n_experts, topk):
    """moe_apply on the card against the CPU, d 256, 64 tokens in one
    group: the routing (probabilities, top-k experts, their renormalised
    weights, queue positions, kept assignments) bit for bit -- the router and softmax run
    in float64 on both -- and the output within 2 bf16 ulps (the expert
    products accumulate in f32 on the card, in float64 on the CPU)."""
    _need_cuda()
    import dataclasses
    from repro_torch.models.moe import _capacity, moe_apply, route
    from repro_torch.models.model import init_layer, pack_layer_for_serving
    cfg = dataclasses.replace(_card_cfg(quant_format="m2xfp"), family="moe",
                              n_experts=n_experts, experts_per_token=topk,
                              moe_group_size=64, d_ff=128)
    ffn = pack_layer_for_serving(init_layer(
        torch.Generator().manual_seed(0), cfg, "cpu"), "m2xfp")["ffn"]
    x = torch.randn(8, 8, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    card = _to_device(ffn, "cuda")
    cap = _capacity(64, topk, n_experts, cfg.moe_capacity_factor)
    for a, b in zip(route(ffn["router"], x.reshape(1, 64, -1), topk, cap),
                    route(card["router"], x.cuda().reshape(1, 64, -1), topk,
                          cap)):
        assert torch.equal(a, b.cpu())
    want = moe_apply(ffn, x, cfg, cfg.quant).float()
    got = moe_apply(card, x.cuda(), cfg, cfg.quant).float().cpu()
    bound = 2.0 ** -7 * (torch.maximum(got.abs(), want.abs())
                         + want.abs().max())
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.gpu
def test_embeddings_prefill_chunk_bitexact_vs_decode_full_width(monkeypatch):
    """_check_prefill_full_width's comparison for embedding input:
    full-width musicgen-large (d 2048, ff 8192, its 2048-column head) cut to
    2 layers, embeddings (8 slots x 8 positions, std 1) through one
    prefill_chunk (64 rows) and through decode_step (8 rows at a time):
    logits and caches bit for bit, the head's rows independent of M."""
    _need_cuda()
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_caches
    from repro_torch.serve.prequant import init_packed_params
    cfg = get_config("musicgen-large", quant="serve", n_layers=2)
    params = init_packed_params(torch.Generator("cuda").manual_seed(0), cfg,
                                "cuda")
    assert "embed" in params and params["lm_head"].shape == (2048, 2048)
    embeds = torch.randn(8, 8, cfg.d_model, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(16)
                         ).to(torch.bfloat16)
    caches = init_caches(cfg, 8, 8, "cuda")
    got, want, first, seq_caches = _prefill_vs_decode(
        params, cfg, embeds, _serve_trace(monkeypatch), caches,
        torch.zeros(8, dtype=torch.long, device="cuda"),
        torch.full((8,), 8, device="cuda"))
    assert bool(torch.isfinite(got).all())
    assert first is None, f"first op whose rows differ: {first}"
    assert torch.equal(got, want)
    for i, (a, b) in enumerate(zip(caches["layers"],
                                   seq_caches["layers"])):
        for name in a:
            assert torch.equal(a[name], b[name]), (i, name)


# ---------------------------------------------------------------------------
# Training (slice 12)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_product_backward_equals_cpu():
    """``dot_f32acc`` and ``einsum_f32acc`` differentiate on the card (the
    forward's bf16 tensor-core product has a backward of IEEE f32
    products) and give the CPU's gradients (float64 there) within f32
    rounding of |g| @ |operand|, each cast to its operand's dtype."""
    _need_cuda()
    from repro_torch.models.numerics import dot_f32acc, einsum_f32acc
    gen = torch.Generator().manual_seed(3)
    cases = [
        ("dot", lambda a, b: dot_f32acc(a, b), (5, 7, 96), (96, 40)),
        ("einsum", lambda a, b: einsum_f32acc("bsnd,bcnd->bnsc", a, b),
         (2, 9, 4, 32), (2, 11, 4, 32)),
    ]
    for name, fn, sa, sb in cases:
        for wdt in (torch.bfloat16, torch.float32):
            a0 = torch.randn(sa, generator=gen).to(torch.bfloat16)
            b0 = torch.randn(sb, generator=gen).to(wdt)
            g0 = torch.randn(fn(a0, b0).shape, generator=gen)
            grads = {}
            for dev in ("cpu", "cuda"):
                a = a0.to(dev, copy=True).requires_grad_()
                b = b0.to(dev, copy=True).requires_grad_()
                out = fn(a, b)
                assert out.dtype == torch.float32
                out.backward(g0.to(dev))
                assert a.grad.dtype == a.dtype and b.grad.dtype == b.dtype
                grads[dev] = (a.grad.cpu().float(), b.grad.cpu().float())
            for cpu_g, card_g in zip(grads["cpu"], grads["cuda"]):
                # one bf16 (or f32) rounding of the gradient either side,
                # after f32 sums of up to ~100 terms
                tol = 2.0 ** -7 * cpu_g.abs().max()
                assert float((cpu_g - card_g).abs().max()) <= tol, \
                    (name, wdt)


def _train_cfg(quant="none", layers=1):
    from repro_torch.configs import get_config
    return get_config("paper-llama2-7b", n_layers=layers, quant=quant)


def _train_batch(cfg, batch, seq, step=0, device="cuda"):
    from repro_torch.data import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(batch=batch, seq=seq,
                                  vocab=cfg.vocab_size, seed=0))
    return {k: torch.from_numpy(v).to(device)
            for k, v in data.batch_at(step).items()}


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["none", "qat"])
def test_cuda_train_step_matches_cpu_full_width(quant):
    """One train step's loss and gradients at full width (paper-llama2-7b,
    1 layer, B = 1, S = 64) on the card against the same step on the CPU,
    within repro_torch.testing.train's tolerances."""
    _need_cuda()
    from repro_torch.testing.train import step_card_vs_cpu
    from repro_torch.train import make_train_state
    cfg = _train_cfg(quant)
    state = make_train_state(torch.Generator("cuda").manual_seed(0), cfg,
                             device="cuda")
    res = step_card_vs_cpu(cfg, state["params"], _train_batch(cfg, 1, 64))
    assert res["within"], str(res)
    # a dropped layer falls outside the loss bound
    assert res["planted_fault_ratio"] > 1, str(res)


def _run_steps(state, cfg, steps, start=0, batch=1, seq=64, mgr=None,
               save_at=None):
    from repro_torch.train import AdamWConfig, make_train_step
    step_fn = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2,
                                               total_steps=8))
    for i in range(start, steps):
        state, _ = step_fn(state, _train_batch(cfg, batch, seq, i))
        if mgr is not None and i + 1 == save_at:
            mgr.maybe_save(save_at, state, extra={"data_step": save_at},
                           force=True)
    if mgr is not None:
        mgr.wait()
    return state


def _assert_same_state(a, b):
    from repro_torch.convert import train_state_leaves
    la, lb = train_state_leaves(a), train_state_leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        assert torch.equal(la[k], lb[k]), k


@pytest.mark.gpu
def test_cuda_train_steps_deterministic():
    """Two runs of three train steps from the same state on the card give
    the same bits (the embedding's backward is a one-hot product, not an
    atomic scatter; the products are cuBLAS's, deterministic on one
    stream), at full width, 2 layers, B = 2, S = 256."""
    _need_cuda()
    from repro_torch.train import make_train_state
    cfg = _train_cfg(layers=2)
    runs = []
    for _ in range(2):
        state = make_train_state(torch.Generator("cuda").manual_seed(0),
                                 cfg, device="cuda")
        runs.append(_run_steps(state, cfg, 3, batch=2, seq=256))
        del state
    _assert_same_state(*runs)


@pytest.mark.gpu
def test_cuda_resume_from_checkpoint_bitexact(tmp_path):
    """A CheckpointManager checkpoint written after 2 of 4 steps on the
    card, resumed, ends on the uninterrupted run's bits (full width, 1
    layer, B = 1, S = 64)."""
    _need_cuda()
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.train import make_train_state
    cfg = _train_cfg()

    def fresh():
        return make_train_state(torch.Generator("cuda").manual_seed(0), cfg,
                                device="cuda")
    full = _run_steps(fresh(), cfg, 4)
    _run_steps(fresh(), cfg, 2, mgr=CheckpointManager(str(tmp_path)),
               save_at=2)
    state, extra, step = CheckpointManager(str(tmp_path)).resume(
        full, cfg, "cuda")
    assert (step, extra) == (2, {"data_step": 2})
    _assert_same_state(_run_steps(state, cfg, 4, start=2), full)


@pytest.mark.gpu
def test_cuda_serve_loss_through_kernel_at_m4096(monkeypatch):
    """``loss_fn`` under serve of a packed full-width layer at 2 x 2048
    tokens: every projection through the m2xfp kernel at M = 4096 (7
    launches), its loss within 1e-4 (relative) of the same call with the
    plain GEMM in the kernel's place; and the kernel at M = 4096 on the
    first projection's real operand (the normed, fake-quantized embeddings)
    within sqrt(K) * 2^-24 * (|x| @ |W|) of its plain version."""
    _need_cuda()
    import dataclasses

    from repro_torch.core import codecs
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.model import loss_fn
    from repro_torch.serve.prequant import init_packed_params
    cfg = _train_cfg("serve")
    params = init_packed_params(torch.Generator("cuda").manual_seed(0),
                                cfg, "cuda")
    batch = _train_batch(cfg, 2, 2048)
    before = M2XFP_KERNEL.launches
    with torch.no_grad():
        loss = float(loss_fn(params, cfg, batch))
    assert M2XFP_KERNEL.launches - before == 7
    plain = dataclasses.replace(codecs.get_codec("m2xfp"),
                                kernel=ref.m2xfp_matmul_ref)
    monkeypatch.setitem(codecs._REGISTRY, "m2xfp", plain)
    with torch.no_grad():
        loss_plain = float(loss_fn(params, cfg, batch))
    assert M2XFP_KERNEL.launches - before == 7
    assert abs(loss - loss_plain) <= 1e-4 * abs(loss_plain), \
        (loss, loss_plain)
    lp = params["layers"][0]
    h = params["embed"][batch["tokens"]].reshape(-1, cfg.d_model)
    x = quantize_act_m2xfp(rms_norm(h, lp["attn_norm"]).float()).to(
        torch.bfloat16)
    wp = lp["attn"]["wq"].streams
    got, want = ops.m2xfp_matmul(x, wp), ref.m2xfp_matmul_ref(x, wp)
    bound = cfg.d_model ** 0.5 * 2.0 ** -24 * ref.dot_f64acc(
        x.abs(), ref.decode_w_sgem_ref(wp).abs())
    assert x.shape[0] == 4096
    assert bool(((got - want).abs() <= bound).all())
