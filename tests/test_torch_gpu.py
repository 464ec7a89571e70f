"""Tests of the port that need the card: the CUDA kernels against their
plain versions (the two dequant-GEMMs, the quantize engine, the W4A4 GEMM
and flash attention), and the engine's launches. Each decides inside its body
whether there is a CUDA device and skips without one. This file imports no
JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.core.m2xfp import quantize_act_m2xfp
from repro_torch.kernels import layout, ops, ref
from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.m2xfp_matmul import KERNEL as M2XFP_KERNEL
from repro_torch.kernels.m2xfp_matmul import QKERNEL
from repro_torch.kernels.m2xfp_quantize import KERNEL as QUANTIZE_KERNEL
from repro_torch.kernels.mxfp4_matmul import KERNEL as MXFP4_KERNEL

CODECS = {
    "m2xfp": (layout.pack_w_sgem, ops.m2xfp_matmul, ref.m2xfp_matmul_ref,
              ref.decode_w_sgem_ref, M2XFP_KERNEL),
    "mxfp4": (layout.pack_w_mxfp4, ops.mxfp4_matmul, ref.mxfp4_matmul_ref,
              ref.decode_w_mxfp4_ref, MXFP4_KERNEL),
}


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


@pytest.mark.gpu
def test_cuda_qmatmul_vs_plain():
    """The W4A4 GEMM within sqrt(K)*2^-24*(|Xdec| @ |Wdec|) of its plain
    version and of the serve GEMM on the same fake-quantized activations,
    rows independent of M, one launch per call, a refused K mismatch."""
    _need_cuda()
    gen = torch.Generator("cuda").manual_seed(3)
    k, n = 4096, 200
    wp = layout.pack_w_sgem(torch.randn(k, n, generator=gen,
                                        device="cuda") * 0.02)
    x = torch.randn(129, k, generator=gen, device="cuda").to(torch.bfloat16)
    xp = ops.m2xfp_quantize(x)
    before = QKERNEL.launches
    got = ops.m2xfp_qmatmul(xp, wp)
    assert QKERNEL.launches == before + 1
    xdec = ref.decode_x_elem_em_ref(xp)
    bound = k ** 0.5 * 2.0 ** -24 * ref.dot_f64acc(
        xdec.abs(), ref.decode_w_sgem_ref(wp).abs())
    assert bool(((got - ref.m2xfp_qmatmul_ref(xp, wp)).abs() <= bound).all())
    serve = ops.m2xfp_matmul(quantize_act_m2xfp(x).to(torch.bfloat16), wp)
    assert bool(((got - serve).abs() <= 2 * bound).all())
    for m in (1, 8, 64):
        part = ops.m2xfp_qmatmul(ops.m2xfp_quantize(x[:m].contiguous()), wp)
        assert torch.equal(part, got[:m]), m
    with pytest.raises(ValueError, match="stream 'w codes'"):
        ops.m2xfp_qmatmul(xp, layout.pack_w_sgem(
            torch.zeros(k // 2, n, device="cuda")))


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
