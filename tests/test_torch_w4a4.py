"""The port's W4A4 datapath against the reference: the online quantize engine
(``m2xfp_quantize``, ``pack_x_elem_em``) and the fully packed GEMM
(``m2xfp_qmatmul``), on the CPU where both run their plain versions.

Streams must be byte-identical to the reference's packer and to its Pallas
quantize kernel (interpret mode, as tests/test_kernels.py runs it). GEMMs
use ``rtol = atol = 2e-6``, the tolerance of tests/test_torch_kernels.py:
the port sums in float64 and rounds once, the reference in f32, so the two
differ by the reference's f32 accumulation order only. The bit-identity
domain is finite inputs whose group maxima are 0 or at least 2^-100 (below
that the reference's CPU runtime flushes subnormals, ROADMAP C). The CUDA
kernels run only on the card; their tests are in tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import heavy_tailed
from repro.kernels import layout as r_layout
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro_torch import kernels as p_kernels
from repro_torch.core.m2xfp import quantize_act_m2xfp
from repro_torch.kernels import layout as p_layout
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref
from repro_torch.kernels.m2xfp_matmul import QKERNEL
from repro_torch.kernels.m2xfp_quantize import KERNEL as QUANTIZE_KERNEL

TOL = dict(rtol=2e-6, atol=2e-6)
STREAMS = ("codes", "scales", "meta")


def _edge_group() -> np.ndarray:
    """One group of 32 at scale 1 (amax 7.9): top-1 ties (lowest index
    wins, also between +x and -x), negatives that round to FP4 zero (keep
    the sign bit) and -0.0 (does not), FP4 and FP6 midpoints, FP4
    saturation, and top-1 values whose FP6 code is clamped from below
    (2.55) and above (7.9) by the bias-clamp encoding."""
    return np.float32([
        2.55, 2.55, -2.55, 1.0, 0.0, -0.0, -0.2, 0.1,
        5.0, 4.25, 4.75, 2.125, 3.875, 1.0625, 5.75, 6.5,
        7.9, 6.9, 6.01, 4.0, -7.9, 0.25, 0.75, 1.25,
        1.75, 2.5, 3.5, -5.0, -0.24, 0.0, 0.0, 0.0])


def _edge_inputs() -> np.ndarray:
    """(8, 128): the edge group at scales 1, 2^-3 and 2^5, an all-zero and
    an all -0.0 group, negated and rolled copies, and heavy-tailed rows."""
    e = _edge_group()
    row = np.concatenate([e, np.zeros(32, np.float32), e * 2.0 ** -3,
                          e * 2.0 ** 5])
    neg0 = row.copy()
    neg0[32:64] = -0.0
    rows = [row, -row, np.roll(row, 5), neg0]
    rows += list(heavy_tailed(np.random.default_rng(5), (4, 128)))
    return np.stack(rows).astype(np.float32)


def _inputs(kind: str, m: int, k: int) -> np.ndarray:
    if kind == "edge":
        return _edge_inputs()
    x = heavy_tailed(np.random.default_rng(m * 7 + k), (m, k))
    if kind == "bf16":                    # bf16-exact values
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _port(streams) -> dict:
    return {s: torch.from_numpy(np.array(v)) for s, v in streams.items()}


def _weight(k, n, seed):
    return (heavy_tailed(np.random.default_rng(seed), (k, n)) * 0.05)


@pytest.mark.parametrize("kind,m,k", [("heavy", 16, 256), ("bf16", 8, 128),
                                      ("edge", 8, 128)])
def test_pack_x_elem_em_byte_identical(kind, m, k):
    x = _inputs(kind, m, k)
    want = r_layout.pack_x_elem_em(jnp.asarray(x))
    got = p_layout.pack_x_elem_em(torch.from_numpy(x))
    for s in STREAMS:
        assert got[s].dtype == torch.uint8 and got[s].is_contiguous()
        np.testing.assert_array_equal(np.asarray(want[s]), got[s].numpy(),
                                      err_msg=s)


@pytest.mark.parametrize("kind,m,k", [("heavy", 16, 256), ("edge", 8, 128)])
def test_quantize_vs_reference_pallas_kernel(kind, m, k):
    """The port's entry point (plain version on the CPU, bf16 or f32 input)
    against the reference's Pallas quantize engine in interpret mode."""
    x = _inputs(kind, m, k)
    want = r_ops.m2xfp_quantize(jnp.asarray(x), block_m=min(m, 128),
                                block_k=min(k, 256))
    before = QUANTIZE_KERNEL.launches
    got = p_ops.m2xfp_quantize(torch.from_numpy(x))
    got16 = p_kernels.m2xfp_quantize(
        torch.from_numpy(x).to(torch.bfloat16).float())
    ref16 = r_layout.pack_x_elem_em(
        jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    for s in STREAMS:
        np.testing.assert_array_equal(np.asarray(want[s]), got[s].numpy(),
                                      err_msg=s)
        np.testing.assert_array_equal(np.asarray(ref16[s]), got16[s].numpy(),
                                      err_msg=s)
    assert QUANTIZE_KERNEL.launches == before    # a CPU tensor never reaches CUDA


def test_quantize_ref_is_k_major_packer():
    """``m2xfp_quantize_ref`` takes K-major x^T (K, M), as the reference's."""
    x = _inputs("heavy", 16, 256)
    want = r_ref.m2xfp_quantize_ref(jnp.asarray(x).T)
    got = p_ref.m2xfp_quantize_ref(torch.from_numpy(x).T)
    for s in STREAMS:
        np.testing.assert_array_equal(np.asarray(want[s]), got[s].numpy())


@pytest.mark.parametrize("kind,m,k", [("heavy", 16, 256), ("edge", 8, 128)])
def test_decode_x_is_activation_fake_quant(kind, m, k):
    """decode(pack(x)) equals the reference's decode bit for bit, and the
    activation fake-quant ``quantize_act_m2xfp(x)``: what ties the W4A4
    GEMM to the serve GEMM. Bit for bit where x holds no -0.0; the streams
    cannot hold a -0.0 input (code 8 marks a negative value that rounds to
    zero), so it decodes to +0.0 where the fake-quant keeps -0.0."""
    x = _inputs(kind, m, k)
    streams = r_layout.pack_x_elem_em(jnp.asarray(x))
    got = p_ref.decode_x_elem_em_ref(_port(streams)).numpy()
    np.testing.assert_array_equal(
        np.asarray(r_ref.decode_x_elem_em_ref(streams)).view(np.uint32),
        got.view(np.uint32))
    fq = quantize_act_m2xfp(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(fq, got)               # -0.0 == +0.0
    plain = np.signbit(x) & (x == 0)
    np.testing.assert_array_equal(fq[~plain].view(np.uint32),
                                  got[~plain].view(np.uint32))


@pytest.mark.parametrize("m,k,n", [(16, 256, 128), (8, 128, 256)])
def test_qmatmul_vs_reference(m, k, n):
    """The plain W4A4 GEMM against the reference's XLA oracle and its Pallas
    kernel (interpret mode), on streams packed by the reference."""
    x = _inputs("heavy", m, k)
    w = _weight(k, n, seed=m + n)
    xp = r_layout.pack_x_elem_em(jnp.asarray(x))
    wp = r_layout.pack_w_sgem(jnp.asarray(w))
    before = QKERNEL.launches
    got = p_ops.m2xfp_qmatmul(_port(xp), _port(wp)).numpy()
    assert got.shape == (m, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(r_ref.m2xfp_qmatmul_ref(xp, wp)),
                               **TOL)
    want = r_ops.m2xfp_qmatmul(xp, wp, block_m=min(m, 128),
                               block_n=min(n, 128), block_k=min(k, 256))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert QKERNEL.launches == before


@pytest.mark.parametrize("m,k,n", [(8, 64, 96), (33, 512, 40), (8, 128, 64)])
def test_qmatmul_equals_serve_gemm_on_fake_quant(m, k, n):
    """m2xfp_qmatmul(pack_x_elem_em(x), W) == m2xfp_matmul(bf16(
    quantize_act_m2xfp(x)), W), bit for bit: the same exact products, and
    both plain versions sum them in float64."""
    x = torch.from_numpy(_inputs("heavy", m, k))
    wp = p_layout.pack_w_sgem(torch.from_numpy(_weight(k, n, seed=k)))
    got = p_ref.m2xfp_qmatmul_ref(p_layout.pack_x_elem_em(x), wp)
    want = p_ref.m2xfp_matmul_ref(quantize_act_m2xfp(x).to(torch.bfloat16),
                                  wp)
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [64, 512])
def test_qmatmul_rows_independent_of_m(k):
    x = torch.from_numpy(_inputs("heavy", 129, k))
    wp = p_layout.pack_w_sgem(torch.from_numpy(_weight(k, 96, seed=k)))
    full = p_ops.m2xfp_qmatmul(p_ops.m2xfp_quantize(x), wp)
    for m in (1, 3, 8, 64):
        part = p_ops.m2xfp_qmatmul(p_ops.m2xfp_quantize(x[:m].contiguous()),
                                   wp)
        assert torch.equal(part, full[:m]), m


def test_w4a4_slice_vs_reference_slice():
    """The slice as a whole: quantize engine then packed GEMM, port against
    reference (both Pallas kernels in interpret mode), from the same
    activations and the same packed weight."""
    m, k, n = 16, 256, 128
    x = _inputs("heavy", m, k)
    wp = r_layout.pack_w_sgem(jnp.asarray(_weight(k, n, seed=1)))
    r_xp = r_ops.m2xfp_quantize(jnp.asarray(x), block_m=16, block_k=256)
    want = r_ops.m2xfp_qmatmul(r_xp, wp, block_m=16, block_n=128, block_k=256)
    got = p_kernels.m2xfp_qmatmul(p_kernels.m2xfp_quantize(torch.from_numpy(x)),
                                  _port(wp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_k_not_multiple_of_32_raises():
    x = torch.from_numpy(_inputs("heavy", 4, 64))
    with pytest.raises(ValueError, match="multiple of the 32"):
        p_ops.m2xfp_quantize(x[:, :48].contiguous())
    xp = p_ops.m2xfp_quantize(x)
    wp = p_layout.pack_w_sgem(torch.from_numpy(_weight(64, 32, seed=0)))
    bad = {s: v[:v.shape[0] * 3 // 4] if s == "codes" else v
           for s, v in xp.items()}                       # K = 48
    with pytest.raises(ValueError, match="multiple of the 32"):
        p_ops.m2xfp_qmatmul(bad, wp)
    with pytest.raises(ValueError, match="K="):
        p_ops.m2xfp_qmatmul(xp, p_layout.pack_w_sgem(
            torch.from_numpy(_weight(128, 32, seed=0))))


def test_package_exports_match_reference():
    from repro import kernels as r_kernels
    assert set(r_kernels.__all__) - {"on_tpu", "serve_block_m"} <= \
        set(p_kernels.__all__)
