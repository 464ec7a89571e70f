"""The port's serve GEMMs: plain versions against the reference's Pallas
kernels (interpret mode on the CPU, as tests/test_kernels.py runs them) and
XLA oracles, row independence, and the device dispatch.

Tolerance for the products: ``rtol = atol = 2e-6``, the reference's own
large-K tolerance (tests/test_kernels.py). The port accumulates in float64
and rounds once, the reference in f32, so the two differ by the
reference's f32 accumulation order only. The CUDA kernels run only on the
card; their tests are in tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import layout as r_layout
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro_torch.kernels import layout as p_layout
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref
from repro_torch.kernels.m2xfp_matmul import KERNEL as M2XFP_KERNEL
from repro_torch.kernels.mxfp4_matmul import KERNEL as MXFP4_KERNEL

CODECS = {
    "m2xfp": (r_layout.pack_w_sgem, r_ops.m2xfp_matmul, r_ref.m2xfp_matmul_ref,
              p_layout.pack_w_sgem, p_ops.m2xfp_matmul, p_ref.m2xfp_matmul_ref,
              p_ref.decode_w_sgem_ref, M2XFP_KERNEL),
    "mxfp4": (r_layout.pack_w_mxfp4, r_ops.mxfp4_matmul,
              r_ref.mxfp4_matmul_ref, p_layout.pack_w_mxfp4,
              p_ops.mxfp4_matmul, p_ref.mxfp4_matmul_ref,
              p_ref.decode_w_mxfp4_ref, MXFP4_KERNEL),
}
TOL = dict(rtol=2e-6, atol=2e-6)
# tests/test_kernels.py:15 (M, K, N) and the conformance (K, N) x M of :123
SHAPES = [(8, 64, 128), (16, 128, 128), (128, 512, 256),
          (1, 64, 128), (129, 64, 128), (1, 256, 128), (129, 256, 128),
          (1, 128, 256), (129, 128, 256), (16, 1024, 128)]


def _data(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    return x, w


def _port_streams(streams) -> dict:
    return {s: torch.from_numpy(np.array(v)) for s, v in streams.items()}


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("fmt", sorted(CODECS))
def test_plain_gemm_vs_reference_pallas_kernel(fmt, m, k, n):
    r_pack, r_kernel, r_oracle, _, p_gemm, _, _, kern = CODECS[fmt]
    x, w = _data(m, k, n, seed=m + k)
    streams = r_pack(jnp.asarray(w))
    want = np.asarray(r_kernel(jnp.asarray(x), streams))
    before = kern.launches
    got = p_gemm(torch.from_numpy(x), _port_streams(streams)).numpy()
    assert got.shape == (m, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        got, np.asarray(r_oracle(jnp.asarray(x), streams)), **TOL)
    assert kern.launches == before       # a CPU tensor never reaches CUDA


@pytest.mark.parametrize("k", [64, 512, 4096])
@pytest.mark.parametrize("fmt", sorted(CODECS))
def test_plain_gemm_row_independent(fmt, k):
    """Rows of M = 1, 3, 8 equal the same rows of M = 129 bit for bit —
    what keeps chunked prefill bit-identical to sequential decode."""
    _, _, _, p_pack, p_gemm, _, _, _ = CODECS[fmt]
    x, w = _data(129, k, 96, seed=k)
    wp = p_pack(torch.from_numpy(w))
    xt = torch.from_numpy(x)
    full = p_gemm(xt, wp)
    for m in (1, 3, 8):
        assert torch.equal(p_gemm(xt[:m].contiguous(), wp), full[:m]), m


@pytest.mark.parametrize("fmt", sorted(CODECS))
def test_k_not_multiple_of_32_raises(fmt):
    _, _, _, p_pack, p_gemm, _, _, _ = CODECS[fmt]
    x, w = _data(4, 64, 32)
    wp = p_pack(torch.from_numpy(w))
    with pytest.raises(ValueError, match="multiple of the 32"):
        p_gemm(torch.from_numpy(x[:, :48]).contiguous(), wp)


@pytest.mark.parametrize("fmt", sorted(CODECS))
def test_packed_matmul_dispatches_cpu_to_plain(fmt):
    """A CPU tensor runs the plain version; the launch counter stays 0."""
    _, _, _, p_pack, _, p_plain, _, kern = CODECS[fmt]
    x, w = _data(5, 128, 64, seed=4)
    wp = p_pack(torch.from_numpy(w))
    before = kern.launches
    got = p_ops.packed_matmul(torch.from_numpy(x), wp, fmt)
    assert torch.equal(got, p_plain(torch.from_numpy(x), wp))
    assert kern.launches == before == 0


def test_packed_matmul_unknown_codec_raises():
    with pytest.raises(ValueError, match="unknown codec"):
        p_ops.packed_matmul(torch.zeros(1, 32), {}, "int4")


def test_packed_matmul_codec_without_kernel_raises():
    """nvfp4 packs but has no fused kernel (it serves through its decode,
    models.quant); asking the kernel dispatch for it names the codecs that
    have one."""
    with pytest.raises(ValueError, match="has no serve kernel; kernel-backed "
                                         "codecs: m2xfp, m2xfp_ideal6, mxfp4"):
        p_ops.packed_matmul(torch.zeros(1, 32), {}, "nvfp4")
