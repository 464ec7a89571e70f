"""The port's rms_norm (``repro_torch.models.layers``) on the CPU.

Its sum of squares folds the last axis in halves with elementwise adds, so
a row's bits do not depend on how many rows share the call: chunked prefill
norms B*T rows where decode norms B, and on the card a library reduction
picks its order from the row count (ROADMAP C1). It stays within one bf16
ulp of the reference's norm, ``repro.models.layers.rms_norm``, run in JAX
on the same input: the two sum the squares in different orders, so the
f32 mean-square may differ in its last bits and flip a bf16 rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import rms_norm as r_rms_norm
from repro_torch.models.layers import _sum_halves, rms_norm

WIDTHS = [4096, 100, 63]      # the model's d; odd folds (25, then 13, 7, 3)


def _rows(n: int, d: int, seed: int) -> torch.Tensor:
    """(n, d) bf16 normal entries with log-normal channel scales, so the
    squares of a row span many binades."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)) * np.exp(1.5 * rng.standard_normal((1, d)))
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _weight(d: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(d).uniform(
        0.5, 1.5, d).astype(np.float32))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("rows", [1, 7, 64])
def test_rms_norm_row_bits_independent_of_row_count(rows, d):
    """Each row normed alone gives the bits it gets among ``rows`` rows, as
    a 2-d batch and as prefill's (B, T, d) chunk."""
    x, w = _rows(64, d, seed=rows + d), _weight(d)
    alone = torch.cat([rms_norm(x[i:i + 1], w) for i in range(rows)])
    assert torch.equal(rms_norm(x[:rows], w), alone)
    if rows == 64:
        chunk = rms_norm(x.reshape(8, 8, d), w).reshape(64, d)
        assert torch.equal(chunk, alone)


@pytest.mark.parametrize("d", WIDTHS)
def test_rms_norm_within_one_bf16_ulp_of_reference(d):
    """Against the reference's norm in JAX: |port - reference| is at most
    one bf16 ulp of the reference's value, element by element."""
    x, w = _rows(64, d, seed=d), _weight(d)
    got = rms_norm(x, w).float().numpy()
    want = np.asarray(r_rms_norm(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(w.numpy()))).astype(np.float32)
    assert got.shape == want.shape and np.isfinite(want).all()
    mag = np.abs(want)
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-38)))
                                    - 7), 0.0)
    assert (np.abs(got - want) <= ulp).all()


def test_sum_halves_order_is_fixed_by_length():
    """The folds: [a, b, c, d, e] sums as ((a + c) + (b + d)) + e (the odd
    length carries e), which f32 values can tell from a left-to-right sum;
    a power-of-two length sums as a balanced tree; the axis is kept."""
    x = torch.tensor([[1e8, 1.0, -1e8, 1.0, 1.0]], dtype=torch.float32)
    assert _sum_halves(x).tolist() == [[3.0]]
    assert float(((((x[0, 0] + x[0, 1]) + x[0, 2]) + x[0, 3]) + x[0, 4])) \
        == 2.0
    y = torch.tensor([1e8, 1.0, 1.0, 1.0, -1e8, 1.0, 1.0, 1.0])
    assert _sum_halves(y).tolist() == [6.0]      # 1e8 meets -1e8 first
    for n in range(1, 70):
        v = torch.arange(n, dtype=torch.float32)[None]
        assert _sum_halves(v).tolist() == [[n * (n - 1) / 2]], n
