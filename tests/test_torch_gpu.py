"""Tests of the port that need the card: the CUDA kernels against their
plain versions, and the engine's launches. Each decides inside its body
whether there is a CUDA device and skips without one. This file imports no
JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.kernels import layout, ops, ref
from repro_torch.kernels.m2xfp_matmul import KERNEL as M2XFP_KERNEL
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


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", sorted(CODECS))
def test_cuda_kernel_vs_plain(fmt):
    """The kernel against its plain version within sqrt(K)*2^-24*(|x| @ |W|),
    the expected size of its K f32 roundings (chip_smoke.py's tolerance),
    rows independent of M, one launch counted per call, and a refused
    dtype."""
    _need_cuda()
    pack, gemm, plain, decode, kern = CODECS[fmt]
    gen = torch.Generator("cuda").manual_seed(1)
    k, n = 11008, 200                                  # N off the 64-grid
    wp = pack(torch.randn(k, n, generator=gen, device="cuda") * 0.02)
    x = torch.randn(129, k, generator=gen, device="cuda").to(torch.bfloat16)
    before = kern.launches
    got = gemm(x, wp)
    assert kern.launches == before + 1
    bound = k ** 0.5 * 2.0 ** -24 * ref.dot_f64acc(x.abs(), decode(wp).abs())
    assert bool(((got - plain(x, wp)).abs() <= bound).all())
    for m in (1, 8, 64):
        assert torch.equal(gemm(x[:m].contiguous(), wp), got[:m]), m
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
