"""Hypothesis properties of the port's format cores, packing and KV cache
(the properties of tests/test_property.py, on ``repro_torch``), and one
that holds every codec's fake-quant of the port equal, bit for bit, to the
reference's on drawn arrays.

The cross-package property draws its arrays in the domain the port's
tests keep to (ROADMAP, queue C): every group maximum is 0 or at least
2^-100, since XLA's CPU runtime flushes a subnormal one. It runs the
reference op by op for nvfp4, fp4 and M2-NVFP4 (tests/test_torch_core.py)
and is derandomized, so every run draws the same examples.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="hypothesis not installed")
from hypothesis import given, settings, strategies as st  # noqa: E402
from hypothesis.extra import numpy as hnp  # noqa: E402

from test_torch_codecs import CODECS, EAGER, reference_mode  # noqa: E402
from repro.core import codecs as r_codecs  # noqa: E402
from repro_torch.core.dtypes import FP6_E2M3, FP4_E2M1, \
    round_to_grid  # noqa: E402
from repro_torch.core.formats import quantize_mxfp4  # noqa: E402
from repro_torch.core.m2xfp import (  # noqa: E402
    decode_act_m2xfp, encode_act_m2xfp, quantize_act_m2xfp,
    sg_em_dequant_with_scale)
from repro_torch.core import codecs as p_codecs  # noqa: E402
from repro_torch.core.packing import (  # noqa: E402
    group_reshape, pack_meta2, pack_nibbles, unpack_meta2, unpack_nibbles)
from repro_torch.core.scaling import shared_scale_exponent  # noqa: E402
from repro_torch.models.kvquant import kv_decode, kv_encode  # noqa: E402

_f32 = hnp.arrays(
    np.float32, st.tuples(st.integers(1, 4), st.just(64)),
    elements=st.floats(-1e4, 1e4, width=32, allow_nan=False,
                       allow_infinity=False))

# full finite f32 range incl. subnormals and +-0 -- what a KV page may see
_f32_extreme = hnp.arrays(
    np.float32, st.tuples(st.integers(1, 3), st.just(64)),
    elements=st.floats(width=32, allow_nan=False, allow_infinity=False,
                       allow_subnormal=True))

_u8 = hnp.arrays(np.uint8, st.tuples(st.integers(1, 4), st.just(32)),
                 elements=st.integers(0, 255))

# the cross-package domain: magnitudes below 2^-100 drawn as 0
_f32_domain = _f32.map(
    lambda a: np.where(np.abs(a) < 2.0 ** -100, np.float32(0), a))


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _scale(q: torch.Tensor) -> torch.Tensor:
    """2^E of the floor rule per group of 32, (groups, 1)."""
    amax = q.reshape(-1, 32).abs().amax(dim=-1, keepdim=True)
    return torch.exp2(shared_scale_exponent(amax).to(torch.float32))


@settings(max_examples=30, deadline=None)
@given(_f32)
def test_quantize_idempotent(x):
    """Quantization is a projection: q(q(x)) == q(x)."""
    xq = quantize_mxfp4(_t(x))
    assert torch.equal(quantize_mxfp4(xq), xq)


@settings(max_examples=30, deadline=None)
@given(_f32)
def test_m2xfp_act_near_idempotent(x):
    """Elem-EM fake-quant is idempotent up to one FP6 step: a refined FP6
    value can re-round into the next FP4 bin whose {-1..+2} decode set
    clamps it (e.g. 0.75 -> FP4 1.0 -> 0.875)."""
    q1 = quantize_act_m2xfp(_t(x))
    q2 = quantize_act_m2xfp(q1)
    drift = (q2 - q1).reshape(-1, 32).abs()
    assert bool((drift <= 0.25 * _scale(q1) + 1e-7).all())


@settings(max_examples=30, deadline=None)
@given(_f32)
def test_mxfp4_error_bound(x):
    """|x - q(x)| <= 2 * scale: within +-6s the error is at most half the
    largest step (1s); a clipped element (the floor rule allows amax < 8s)
    is less than 2s away."""
    xt = _t(x)
    err = (quantize_mxfp4(xt) - xt).reshape(-1, 32).abs()
    assert bool((err <= 2.0 * _scale(xt) + 1e-6).all())


@settings(max_examples=30, deadline=None)
@given(_f32)
def test_sign_preservation(x):
    xt = _t(x)
    assert bool((xt * quantize_act_m2xfp(xt) >= 0).all())


@settings(max_examples=30, deadline=None)
@given(_f32)
def test_m2xfp_never_worse_than_mxfp4_groupwise(x):
    """Elem-EM refinement only moves the top-1 closer to its true value:
    MSE(m2xfp) <= MSE(mxfp4) + slack for the dropped -2 candidate."""
    xt = _t(x)
    base = float(((quantize_mxfp4(xt) - xt) ** 2).mean())
    m2 = float(((quantize_act_m2xfp(xt) - xt) ** 2).mean())
    assert m2 <= base * 1.001 + 1e-9


@settings(max_examples=20, deadline=None)
@given(_f32)
def test_pack_decode_roundtrip(x):
    """decode(encode(x)) == the fake-quant (values; -0.0 decodes as +0.0,
    ROADMAP queue C)."""
    xt = _t(x)
    dq = decode_act_m2xfp(encode_act_m2xfp(xt))
    assert bool((dq == quantize_act_m2xfp(xt)).all())


@settings(max_examples=30, deadline=None)
@given(st.floats(1e-20, 1e20, allow_nan=False, allow_infinity=False))
def test_scale_monotone(a):
    """The shared scale exponent is monotone in amax."""
    e1 = int(shared_scale_exponent(torch.tensor(a, dtype=torch.float32)))
    e2 = int(shared_scale_exponent(torch.tensor(a * 2, dtype=torch.float32)))
    assert e2 >= e1


@settings(max_examples=30, deadline=None)
@given(st.floats(-7.5, 7.5, allow_nan=False))
def test_fp6_round_is_nearest(v):
    got = float(round_to_grid(torch.tensor(v, dtype=torch.float32),
                              FP6_E2M3))
    e = np.arange(32) >> 3
    m = np.arange(32) & 7
    grid = np.where(e == 0, m / 8.0, 2.0 ** (e - 1) * (1 + m / 8.0))
    grid = np.concatenate([-grid[::-1], grid])
    best = float(grid[np.argmin(np.abs(grid - v))])
    assert abs(got - v) <= abs(best - v) + 1e-7


@settings(max_examples=30, deadline=None)
@given(_u8)
def test_pack_unpack_pack_idempotent(stream):
    """The bit packers are exact inverses both ways: pack(unpack(bytes)) ==
    bytes for any bytes, unpack(pack(codes)) == codes for any 4-bit
    codes."""
    s = _t(stream)
    assert torch.equal(pack_nibbles(unpack_nibbles(s)), s)
    assert torch.equal(pack_meta2(unpack_meta2(s, 4 * s.shape[-1])), s)
    codes = unpack_nibbles(s)
    assert torch.equal(unpack_nibbles(pack_nibbles(codes)), codes)


@settings(max_examples=25, deadline=None)
@given(_f32_extreme)
def test_kv_roundtrip_finite_and_sign_preserving(x):
    """For any finite page content (subnormals, +-0, the largest
    exponents) the Sg-EM KV round trip is finite and never flips a sign;
    exact zeros decode to exact zeros."""
    xt = _t(x)
    dq = kv_decode(kv_encode(xt)).to(torch.float32)
    assert bool(torch.isfinite(dq).all())
    assert bool((xt * dq >= 0).all())
    assert bool(torch.where(xt == 0, dq == 0, True).all())


@settings(max_examples=25, deadline=None)
@given(_f32_extreme)
def test_kv_scale_bytes_in_e8m0_range(x):
    """Encoded E8M0 bytes stay in [1, 254], and the streams take 4.5 bits
    per element."""
    enc = kv_encode(_t(x))
    sb = enc["scales"]
    assert bool(((sb >= 1) & (sb <= 254)).all())
    n = x.size
    assert enc["codes"].numel() == n // 2
    assert enc["scales"].numel() == enc["meta"].numel() == n // 32


@settings(max_examples=25, deadline=None)
@given(_f32)
def test_kv_reencode_drift_bounded(x):
    """Re-encoding a decoded page moves values by at most half an FP4 step
    at the group scale (0.5 * 2^e)."""
    d1 = kv_decode(kv_encode(_t(x))).to(torch.float32)
    d2 = kv_decode(kv_encode(d1)).to(torch.float32)
    drift = (d2 - d1).reshape(-1, 32).abs()
    assert bool((drift <= 0.5 * _scale(d1) * 1.00001 + 1e-7).all())


def test_kv_edge_values_exact():
    """Pinned edge rows: min subnormal, min normal, -0.0 and f32 max
    survive the round trip finite; the all-zero row is exact."""
    edges = np.zeros((4, 64), np.float32)
    edges[1, :] = np.float32(1e-45)
    edges[2, ::2] = np.float32(-0.0)
    edges[2, 1::2] = np.finfo(np.float32).tiny
    edges[3, :] = np.finfo(np.float32).max
    dq = kv_decode(kv_encode(_t(edges))).to(torch.float32).numpy()
    assert np.isfinite(dq).all()
    assert (dq[0] == 0).all()
    with np.errstate(over="ignore"):         # f32 max squared is inf >= 0
        assert (dq * edges >= 0).all()


@settings(max_examples=15, deadline=None)
@given(_f32)
def test_weight_scale_multiplier_search_optimal(x):
    """The fixed-scale Sg-EM pick is at least as good as any single k."""
    xg = group_reshape(_t(x), 32)
    s = _scale(xg).reshape(*xg.shape[:-1], 1)
    best = sg_em_dequant_with_scale(xg, s, 8, bits=2, adaptive=False)
    err_best = float(((best - xg) ** 2).sum())
    for k in range(4):
        sk = (1 + k / 4) * s
        dq = round_to_grid(xg / sk, FP4_E2M1) * sk
        assert err_best <= float(((dq - xg) ** 2).sum()) + 1e-5


@pytest.mark.parametrize("role", ["weight", "act"])
@pytest.mark.parametrize("name", CODECS)
def test_fake_quant_equals_reference(name, role):
    """Every codec's fake-quant of the port equals the reference's, bit
    for bit, on drawn arrays."""
    r_fn = getattr(r_codecs.get_codec(name), f"fake_quant_{role}")
    p_fn = getattr(p_codecs.get_codec(name), f"fake_quant_{role}")

    @settings(max_examples=8, deadline=None, derandomize=True)
    @given(_f32_domain)
    def check(x):
        with reference_mode(name in EAGER):
            want = np.asarray(r_fn(jnp.asarray(x)))
        got = p_fn(_t(x)).numpy()
        assert np.array_equal(want.view(np.uint32), got.view(np.uint32))

    check()
