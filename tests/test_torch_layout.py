"""The torch port's packed layouts and bit helpers against the reference,
byte for byte: the serve kernels of both packages read the same streams."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import heavy_tailed
from repro.core import codecs as r_codecs
from repro.core import dtypes as r_dtypes
from repro.kernels import bitmath as r_bitmath
from repro.kernels import layout as r_layout
from repro.kernels import ref as r_ref
from repro_torch.core import codecs as p_codecs
from repro_torch.kernels import bitmath as p_bitmath
from repro_torch.kernels import layout as p_layout
from repro_torch.kernels import ref as p_ref

PACKERS = {
    "m2xfp": (r_layout.pack_w_sgem, p_layout.pack_w_sgem,
              r_ref.decode_w_sgem_ref, p_ref.decode_w_sgem_ref),
    "mxfp4": (r_layout.pack_w_mxfp4, p_layout.pack_w_mxfp4,
              r_ref.decode_w_mxfp4_ref, p_ref.decode_w_mxfp4_ref),
}
# (K, N) incl. the paper-llama2 down projection's K = 11008 (11008 % 512 != 0)
WEIGHT_SHAPES = [(64, 128), (256, 96), (512, 33), (11008, 8)]


def _weight(k, n, seed):
    w = heavy_tailed(np.random.default_rng(seed), (k, n)) * 0.05
    w[:32, 0] = 0.0                               # an all-zero group
    return w


@pytest.mark.parametrize("k,n", WEIGHT_SHAPES)
@pytest.mark.parametrize("fmt", sorted(PACKERS))
def test_pack_streams_byte_identical(fmt, k, n):
    ref_pack, port_pack, _, _ = PACKERS[fmt]
    w = _weight(k, n, seed=k + n)
    want = ref_pack(jnp.asarray(w))
    got = port_pack(torch.from_numpy(w))
    assert sorted(want) == sorted(got)
    for name in want:
        assert got[name].dtype == torch.uint8 and got[name].is_contiguous()
        np.testing.assert_array_equal(np.asarray(want[name]),
                                      got[name].numpy(), err_msg=name)


@pytest.mark.parametrize("fmt", sorted(PACKERS))
def test_decode_equals_reference_decode(fmt):
    """The plain decoders give the reference's f32 weights exactly, and the
    codec decode is the same function."""
    ref_pack, _, ref_dec, port_dec = PACKERS[fmt]
    w = _weight(256, 64, seed=3)
    streams = ref_pack(jnp.asarray(w))
    pstreams = {s: torch.from_numpy(np.array(v)) for s, v in
                streams.items()}
    want = np.asarray(ref_dec(streams))
    np.testing.assert_array_equal(want, port_dec(pstreams).numpy())
    codec_want = np.asarray(r_codecs.get_codec(fmt).decode(streams, 256, 64))
    np.testing.assert_array_equal(
        codec_want, p_codecs.get_codec(fmt).decode(pstreams, 256, 64).numpy())


def test_interleave_roundtrip():
    rng = np.random.default_rng(0)
    c = rng.integers(0, 16, (128, 64)).astype(np.int32)
    packed = p_layout.interleave_pack(torch.from_numpy(c))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(r_layout.interleave_pack(jnp.asarray(c))))
    np.testing.assert_array_equal(
        p_layout.interleave_unpack(packed).numpy(), c)


def test_bitmath_all_codes():
    """Bit-arithmetic converters == the reference's tables and bit helpers
    on every FP4 and FP6 code."""
    c4, c6 = np.arange(8), np.arange(32)
    v4 = np.array(r_dtypes.fp4_code_to_value(jnp.asarray(c4)))
    v6 = np.array(r_dtypes.fp6_code_to_value(jnp.asarray(c6)))
    np.testing.assert_array_equal(
        p_bitmath.fp4_mag_from_code(torch.from_numpy(c4)).numpy(), v4)
    np.testing.assert_array_equal(
        p_bitmath.fp6_mag_from_code(torch.from_numpy(c6)).numpy(), v6)
    np.testing.assert_array_equal(
        p_bitmath.fp4_code_from_mag(torch.from_numpy(v4)).numpy(), c4)
    np.testing.assert_array_equal(
        p_bitmath.fp6_code_from_mag(torch.from_numpy(v6)).numpy(), c6)
    e = np.arange(-140, 141, dtype=np.int32)
    np.testing.assert_array_equal(
        p_bitmath.exp2i(torch.from_numpy(e)).numpy(),
        np.asarray(r_bitmath.exp2i(jnp.asarray(e))))
    x = np.float32([2.0 ** -126, 0.75, 1.0, 3.0, 6.0, 7.5, 3e38])
    np.testing.assert_array_equal(
        p_bitmath.floor_log2_bits(torch.from_numpy(x)).numpy(),
        np.asarray(r_bitmath.floor_log2_bits(jnp.asarray(x))))


@pytest.mark.parametrize("fn", ["rtne_fp4", "rtne_fp6"])
def test_bitmath_rtne_sweep(fn):
    """The 4097-point sweep of the reference's kernel tests."""
    xs = np.linspace(-8, 8, 4097, dtype=np.float32)
    want = np.asarray(getattr(r_bitmath, fn)(jnp.asarray(xs)))
    got = getattr(p_bitmath, fn)(torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("fmt", sorted(PACKERS))
def test_serving_weight_pack_and_decode(fmt):
    """``models.quant.pack_serving_weight`` / ``decode_serving_weight``: the
    reference's streams and its bf16 decoded weight, bit for bit."""
    from repro.models import quant as r_quant
    from repro_torch.models import quant as p_quant
    w = _weight(128, 48, seed=9)
    want = r_quant.pack_serving_weight(jnp.asarray(w), fmt)
    got = p_quant.pack_serving_weight(torch.from_numpy(w), fmt)
    assert (got.codec, got.shape) == (fmt, (128, 48))
    for name in want.streams:
        np.testing.assert_array_equal(np.asarray(want.streams[name]),
                                      got[name].numpy(), err_msg=name)
    dec_ref = np.asarray(r_quant.decode_serving_weight(want))
    dec = p_quant.decode_serving_weight(got)
    assert dec.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        dec_ref.view(np.uint16), dec.view(torch.int16).numpy().view(np.uint16))
