"""The torch port's format cores against the JAX reference, bit for bit.

The same numpy inputs (heavy-tailed LLM-like tensors, zeros, saturating
groups and exact rounding ties) go through ``repro.core`` and
``repro_torch.core``; every fake-quantized output must have identical f32
bits.

The formats whose scale is not a power of two (nvfp4, fp4 and M2-NVFP4)
are held against the reference run op by op (``jax.disable_jit``): under
``jit`` XLA rewrites a division by a constant (``/ 6``, ``/ (448 * 6)``) as a
product with its rounded reciprocal, which moves 22-76% of their outputs
by an ulp of the scale (ROADMAP, queue C). The port divides, as the code
says and as the reference's op-by-op run does. SMX4 meets a second such
rewrite on the saturating input: XLA folds ``3 * s / 2`` into ``1.5 * s``,
which differs where ``3 * s`` overflows (E = 127, the group of 3e38)."""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import heavy_tailed
from repro.core import dtypes as r_dtypes
from repro.core import formats as r_formats
from repro.core import m2xfp as r_m2xfp
from repro.core import scaling as r_scaling
from repro_torch.core import dtypes as p_dtypes
from repro_torch.core import formats as p_formats
from repro_torch.core import m2xfp as p_m2xfp
from repro_torch.core import scaling as p_scaling

QUANTIZERS = {
    "act_m2xfp": (r_m2xfp.quantize_act_m2xfp, p_m2xfp.quantize_act_m2xfp),
    "weight_m2xfp": (r_m2xfp.quantize_weight_m2xfp,
                     p_m2xfp.quantize_weight_m2xfp),
    "mxfp4": (r_formats.quantize_mxfp4, p_formats.quantize_mxfp4),
    "act_m2xfp_ideal6": (
        functools.partial(r_m2xfp.quantize_act_m2xfp, encoding="ideal"),
        functools.partial(p_m2xfp.quantize_act_m2xfp, encoding="ideal")),
    "act_m2nvfp4": (r_m2xfp.quantize_act_m2nvfp4,
                    p_m2xfp.quantize_act_m2nvfp4),
    "weight_m2nvfp4": (r_m2xfp.quantize_weight_m2nvfp4,
                       p_m2xfp.quantize_weight_m2nvfp4),
    "nvfp4": (r_formats.quantize_nvfp4, p_formats.quantize_nvfp4),
    "smx4": (r_formats.quantize_smx4, p_formats.quantize_smx4),
    "fp4": (r_formats.quantize_fp4_fp16scale,
            p_formats.quantize_fp4_fp16scale),
}
# held against the reference run op by op (see the module docstring)
EAGER = {"act_m2nvfp4", "weight_m2nvfp4", "nvfp4", "fp4", ("smx4", "saturate")}


def reference_mode(eager: bool):
    """The context the reference runs in: op by op, or as written (jit)."""
    return jax.disable_jit() if eager else contextlib.nullcontext()


def _ties() -> np.ndarray:
    """Groups whose scale is exactly 1 (amax 4) holding every FP4 midpoint,
    FP6 midpoints for the top-1 refinement, and saturating values; plus
    the same groups scaled by 2^-3 and 2^5 and negated."""
    fp4_mid = [0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0]
    fp6_mid = [4.25, 4.75, 2.125, 3.875, 1.0625, 5.75, 6.5, 7.25]
    sat = [7.9, 6.9, 6.01, 4.0]
    row = np.array(fp4_mid + [4.0] + fp6_mid + sat + [0.0] * 12,
                   np.float32)[:32]
    rows = [row * s for s in (1.0, 2.0 ** -3, 2.0 ** 5)]
    rows += [-r for r in rows]
    rows.append(np.roll(row, 5))
    return np.stack(rows).astype(np.float32)


def _inputs(kind: str) -> np.ndarray:
    rng = np.random.default_rng({"heavy": 0, "wide": 1}.get(kind, 2))
    if kind == "heavy":
        return heavy_tailed(rng, (64, 256))
    if kind == "wide":
        return heavy_tailed(rng, (8, 4096), ch_sigma=2.0)
    if kind == "zeros":
        x = heavy_tailed(rng, (16, 128))
        x[:, :64] = 0.0                      # all-zero groups -> scale 1
        x[3] = 0.0
        return x
    if kind == "saturate":
        x = heavy_tailed(rng, (16, 128)) * np.float32(2.0 ** 60)
        x[0, :32] = np.float32(3e38)         # top of the E8M0 range
        x[1, :32] = np.float32(2.0 ** -120)  # bottom of the E8M0 range
        return x
    return _ties()


def _same_bits(a: np.ndarray, b: np.ndarray) -> None:
    assert a.shape == b.shape and a.dtype == b.dtype
    diff = a.view(np.uint32) != b.view(np.uint32)
    assert not diff.any(), (
        f"{int(diff.sum())} differing elements, first at "
        f"{np.argwhere(diff)[0]}: {a[diff][0]!r} vs {b[diff][0]!r}")


@pytest.mark.parametrize("kind", ["heavy", "wide", "zeros", "saturate",
                                  "ties"])
@pytest.mark.parametrize("name", sorted(QUANTIZERS))
def test_quantizer_bit_identical(name, kind):
    ref_fn, port_fn = QUANTIZERS[name]
    x = _inputs(kind)
    with reference_mode(name in EAGER or (name, kind) in EAGER):
        want = np.asarray(ref_fn(jnp.asarray(x)))
    got = port_fn(torch.from_numpy(x)).numpy()
    _same_bits(want, got)


@pytest.mark.parametrize("spec", ["FP4_E2M1", "FP6_E2M3", "FP8_E4M3"])
def test_round_to_grid_sweep(spec):
    """RTNE with saturation on a dense sweep through every midpoint (for
    E4M3 also its subnormals, every binade up to 448 and beyond)."""
    xs = np.concatenate([np.linspace(-9, 9, 8193, dtype=np.float32),
                         np.arange(-64, 65, dtype=np.float32) / 16.0])
    if spec == "FP8_E4M3":
        xs = np.concatenate([xs, np.linspace(-500, 500, 16001,
                                             dtype=np.float32),
                             np.arange(0, 129, dtype=np.float32) / 2 ** 10,
                             np.float32(2.0) ** np.arange(-12, 10)])
    want = np.asarray(r_dtypes.round_to_grid(jnp.asarray(xs),
                                             getattr(r_dtypes, spec)))
    got = p_dtypes.round_to_grid(torch.from_numpy(xs),
                                 getattr(p_dtypes, spec)).numpy()
    _same_bits(want, got)


def test_shared_scale_and_e8m0():
    rng = np.random.default_rng(5)
    amax = np.concatenate([
        np.abs(heavy_tailed(rng, (1, 512))[0]),
        np.float32([0.0, 2.0 ** -120, 3e38, 4.0, 3.9999998, 8.0])])
    e_ref = np.asarray(r_scaling.shared_scale_exponent(jnp.asarray(amax)))
    e_port = p_scaling.shared_scale_exponent(torch.from_numpy(amax)).numpy()
    np.testing.assert_array_equal(e_ref, e_port)
    b_ref = np.asarray(r_scaling.e8m0_encode(jnp.asarray(e_ref)))
    b_port = p_scaling.e8m0_encode(torch.from_numpy(e_port)).numpy()
    np.testing.assert_array_equal(b_ref, b_port)
    all_bytes = np.arange(256, dtype=np.uint8)
    _same_bits(np.asarray(r_scaling.e8m0_decode(jnp.asarray(all_bytes))),
               p_scaling.e8m0_decode(torch.from_numpy(all_bytes)).numpy())


def test_sg_em_codes_bit_identical():
    """The weight packer's search picks the same k per subgroup and the
    same exponent bias per group (near-ties included)."""
    rng = np.random.default_rng(7)
    wg = heavy_tailed(rng, (96, 512)).reshape(96, 16, 32)
    s_ref = r_dtypes.exp2int(r_scaling.shared_scale_exponent(
        jnp.max(jnp.abs(jnp.asarray(wg)), axis=-1, keepdims=True)))
    dq_r, k_r, b_r = r_m2xfp.sg_em_dequant_with_scale(
        jnp.asarray(wg), s_ref, 8, return_codes=True)
    dq_p, k_p, b_p = p_m2xfp.sg_em_dequant_with_scale(
        torch.from_numpy(wg), torch.from_numpy(np.array(s_ref)), 8,
        return_codes=True)
    np.testing.assert_array_equal(np.asarray(k_r), k_p.numpy())
    np.testing.assert_array_equal(np.asarray(b_r), b_p.numpy())
    _same_bits(np.asarray(dq_r), dq_p.numpy())
