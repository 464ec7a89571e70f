"""The port's encoding design-space study (``repro_torch.core.dse``)
against the reference's (``repro.core.dse``, run op by op in this
process): every strategy at subgroups 2, 4, 8 and 16 under each of the
five scale rules, and ``mxfp4_reference``, ``array_equal`` with the same
EBW, on seeded heavy-tailed inputs that also hold planted ties (zero
groups, equal magnitudes, values on the grids, so that candidates' errors
are equal and the first candidate must win, as in the reference).

Inputs stay in the domain the packages agree on. XLA's CPU runtime
flushes subnormal f32 results to zero (ROADMAP C), and the searches here
sum squared errors: in a group whose amax is near 2^-60 every squared
error is subnormal, the reference's sums flush to 0 and tie where the
port's do not. So every group's amax is 0 or at least 2^-30 (the squared
errors of such a group's candidates stay normal where they decide).
"""
import numpy as np
import pytest
import torch

RULES = ("floor", "ceil", "rtn1", "rtn2", "rtne")
SUBGROUPS = (2, 4, 8, 16)
STRATEGY_NAMES = (
    "elem_em_top1", "elem_em_top2", "elem_ee", "sg_em_1bit", "sg_em_2bit",
    "sg_ee_1bit", "sg_ee_2bit", "elem_em_top1_adaptive",
    "sg_em_2bit_adaptive", "sg_ee_2bit_adaptive")


def _inputs() -> np.ndarray:
    """(24, 256) f32: heavy-tailed rows with outlier columns, then rows of
    planted ties."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((16, 256)) * np.exp(
        rng.standard_normal((16, 1)) * 0.8)).astype(np.float32)
    x[:, ::37] *= 20.0
    x[3] *= 2.0 ** -30                                 # small scales
    ties = np.zeros((8, 256), np.float32)
    ties[1] = 1.0                                      # all equal
    ties[2] = np.tile([4.0, -4.0, 2.0, 0.0], 64)       # equal magnitudes
    ties[3] = rng.choice([-6.0, -3.0, -1.5, 0.5, 1.0, 3.0, 6.0], 256)
    ties[4] = rng.choice([-1.0, 1.0], 256) * 2.0 ** rng.integers(-3, 3, 256)
    ties[5, ::2] = 0.75                                # half zeros
    ties[6] = np.repeat(rng.standard_normal(32).astype(np.float32), 8)
    ties[7] = -ties[3]
    return np.concatenate([x, ties])


X = _inputs()


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def port_x():
    return torch.from_numpy(X)


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("subgroup", SUBGROUPS)
@pytest.mark.parametrize("name", STRATEGY_NAMES)
def test_strategy_equals_reference(port_x, name, subgroup, rule):
    import jax.numpy as jnp
    from repro.core import dse as ref_dse
    from repro_torch.core import dse
    got, got_ebw = dse.run_strategy(name, port_x, subgroup=subgroup,
                                    rule=rule)
    want, want_ebw = ref_dse.run_strategy(name, jnp.asarray(X),
                                          subgroup=subgroup, rule=rule)
    assert got.dtype == torch.float32 and got.shape == port_x.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert got_ebw == want_ebw


@pytest.mark.parametrize("rule", RULES)
def test_mxfp4_reference_equals_reference(port_x, rule):
    import jax.numpy as jnp
    from repro.core import dse as ref_dse
    from repro_torch.core import dse
    got, got_ebw = dse.mxfp4_reference(port_x, rule=rule)
    want, want_ebw = ref_dse.mxfp4_reference(jnp.asarray(X), rule=rule)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert got_ebw == want_ebw == 4.25


def test_registry_equals_reference():
    from repro.core import dse as ref_dse
    from repro_torch.core import dse
    assert tuple(dse.STRATEGIES) == tuple(ref_dse.STRATEGIES) == \
        STRATEGY_NAMES
    for name, strat in dse.STRATEGIES.items():
        ref = ref_dse.STRATEGIES[name]
        assert strat.meta_bits_per_subgroup == ref.meta_bits_per_subgroup
        for sg in SUBGROUPS:
            assert strat.ebw(32, sg) == ref.ebw(32, sg)


def test_ties_are_planted():
    """The tie rows give equal candidate errors: the adaptive scale's three
    biases tie on a group, Sg-EM's multipliers tie on a subgroup, and the
    top-1 candidates tie in magnitude; so the tests above hold the first
    candidate's pick."""
    from repro_torch.core import dse
    from repro_torch.core.m2xfp import _sum_last, elem_em_dequant_with_scale
    from repro_torch.core.packing import group_reshape
    xg = group_reshape(torch.from_numpy(X[16:]), 32)
    s = dse._scales(xg)
    errs = torch.stack([_sum_last((elem_em_dequant_with_scale(
        xg, s * 2.0 ** b, 8) - xg) ** 2) for b in (-1, 0, 1)], -1)
    tied = (errs == errs.min(-1, keepdim=True).values).sum(-1) > 1
    assert int(tied.sum()) >= 8
    sub = xg.reshape(*xg.shape[:-1], 4, 8)
    sk = [((1.0 + k / 4) * s)[..., None] for k in range(4)]
    from repro_torch.core.dtypes import FP4_E2M1, round_to_grid
    kerr = torch.stack([_sum_last((round_to_grid(sub / q, FP4_E2M1) * q
                                   - sub) ** 2) for q in sk], -1)
    assert int(((kerr == kerr.min(-1, keepdim=True).values).sum(-1)
                > 1).sum()) >= 8
    mags = sub.abs()
    assert int(((mags == mags.amax(-1, keepdim=True)).sum(-1) > 1).sum()) \
        >= 8
