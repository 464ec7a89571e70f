"""The port's flash attention against the reference kernel, on the CPU where
``flash_attention_kernel`` runs its plain version (``kernels.ref.
flash_attention_ref``).

The reference is its Pallas kernel in interpret mode, with the port's
``block_k`` as its ``bk``: the block fixes where the probabilities are
rounded to bf16 (against each block's running max), so only equal blocks
compare. Tolerance, elementwise: ``kernels.ref.flash_attention_tolerance``.
The two sum the scores, the probabilities and their products with v in
other orders and take exp and tanh from other libraries; the bound adds up
the f32 roundings that follow, and every probability that can then round
to the neighbouring bf16 value, at its full width. Against the dense
float64 softmax, which rounds no probability to bf16, the tolerance is
``2^-6 * A`` with ``A`` the same attention of ``|v|``: each bf16 p is
within 2^-8 of p_j, so the output within 2^-8 * sum_j p_j |v_j| / l =
2^-8 * A, and the rest covers the f32 sums. A row with no valid key is 0
in both. The CUDA kernel runs only on the card; its test is in
tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_kernel as r_flash
from repro_torch.kernels import ref as p_ref
from repro_torch.kernels.flash_attention import KERNEL
from repro_torch.kernels.flash_attention import flash_attention_kernel as p_flash

BH, S, HD, BQ, BK = 3, 128, 64, 32, 64


def _qkv(seed, bh=BH, sq=S, skv=S, hd=HD):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((bh, sq, hd), (bh, skv, hd), (bh, skv, hd)))


def _positions(bh, s):
    return np.broadcast_to(np.arange(s, dtype=np.int32), (bh, s)).copy()


def _tolerance(q, k, v, pos_q, pos_k, **kw):
    return p_ref.flash_attention_tolerance(
        *(torch.from_numpy(t) for t in (q, k, v, pos_q, pos_k)), **kw).numpy()


def _dense_tolerance(q, k, v, pos_q, pos_k, **kw):
    a = p_flash(*(torch.from_numpy(t) for t in (q, k, np.abs(v), pos_q,
                                                 pos_k)), **kw)
    return 2.0 ** -6 * a.numpy()


# (window, softcap, last keys at pos_k = -1): the three cases of
# tests/test_kernels.py and a padded cache
CASES = [(1 << 30, None, 0), (48, None, 0), (1 << 30, 8.0, 0),
         (1 << 30, None, 16)]


@pytest.mark.parametrize("window,softcap,invalid", CASES)
def test_flash_vs_reference_pallas_kernel(window, softcap, invalid):
    q, k, v = _qkv(7)
    pos_q = _positions(BH, S)
    pos_k = _positions(BH, S)
    if invalid:
        pos_k[:, -invalid:] = -1
    want = np.asarray(r_flash(*(jnp.asarray(t) for t in (q, k, v, pos_q,
                                                         pos_k)),
                              softcap=softcap, window=window, bq=BQ, bk=BK))
    before = KERNEL.launches
    got = p_flash(*(torch.from_numpy(t) for t in (q, k, v, pos_q, pos_k)),
                  softcap=softcap, window=window, block_k=BK).numpy()
    assert KERNEL.launches == before     # a CPU tensor never reaches CUDA
    assert got.shape == (BH, S, HD) and got.dtype == np.float32
    tol = _tolerance(q, k, v, pos_q, pos_k, softcap=softcap, window=window,
                     block_k=BK)
    assert np.all(np.abs(got - want) <= tol)


def test_flash_tolerance_flags_a_changed_value_row():
    """The tolerance is tight enough to see one key's value row changed."""
    q, k, v = _qkv(3)
    pos = _positions(BH, S)
    bad = v.copy()
    bad[:, 5] += 1.0
    args = [torch.from_numpy(t) for t in (q, k, v, pos, pos)]
    good = p_flash(*args, block_k=BK).numpy()
    args[2] = torch.from_numpy(bad)
    moved = p_flash(*args, block_k=BK).numpy()
    tol = _tolerance(q, k, v, pos, pos, block_k=BK)
    assert np.any(np.abs(moved - good) > tol)


def test_flash_softcap_at_the_cap_vs_reference():
    """q scaled by 8 puts the scores (about N(0, 64)) at the cap of 50, so
    the tolerance sees the softcap: the port's result without it fails."""
    q, k, v = _qkv(9)
    q = q * 8
    pos = _positions(BH, S)
    want = np.asarray(r_flash(*(jnp.asarray(t) for t in (q, k, v, pos, pos)),
                              softcap=50.0, bq=BQ, bk=BK))
    args = [torch.from_numpy(t) for t in (q, k, v, pos, pos)]
    got = p_flash(*args, softcap=50.0, block_k=BK).numpy()
    tol = _tolerance(q, k, v, pos, pos, softcap=50.0, block_k=BK)
    assert np.all(np.abs(got - want) <= tol)
    no_cap = p_flash(*args, block_k=BK).numpy()
    assert np.mean(np.abs(no_cap - want) > tol) > 0.5


@pytest.mark.parametrize("window,softcap,invalid", CASES)
def test_flash_tolerance_covers_another_summation_order(window, softcap,
                                                        invalid):
    """The recurrence with the head dims and the keys of each block taken
    in another order (the same function, other f32 sums) stays within the
    bound."""
    q, k, v = _qkv(13)
    pos_q = _positions(BH, S)
    pos_k = _positions(BH, S)
    if invalid:
        pos_k[:, -invalid:] = -1
    rng = np.random.default_rng(0)
    dims = rng.permutation(HD)
    keys = np.concatenate([j0 + rng.permutation(BK) for j0 in range(0, S, BK)])
    kw = dict(softcap=softcap, window=window, block_k=BK)
    want = p_flash(*(torch.from_numpy(t) for t in (q, k, v, pos_q, pos_k)),
                   **kw).numpy()
    other = p_flash(*(torch.from_numpy(np.ascontiguousarray(t)) for t in (
        q[..., dims], k[:, keys][..., dims], v[:, keys], pos_q,
        pos_k[:, keys])), **kw).numpy()
    assert np.all(np.abs(other - want) <= _tolerance(q, k, v, pos_q, pos_k,
                                                     **kw))


@pytest.mark.parametrize("fault", ["scale_x1.02", "mask_off_by_one",
                                   "key_dropped"])
def test_flash_tolerance_flags_planted_faults(fault):
    """A 2% scale error, a causal mask off by one key and one key left out
    each move most outputs outside the tolerance."""
    q, k, v = _qkv(17)
    pos = _positions(BH, S)
    q_bad, pos_q, pos_k = q, pos.copy(), pos.copy()
    if fault == "scale_x1.02":
        q_bad = q * 1.02
    elif fault == "mask_off_by_one":
        pos_q = pos_q + 1
    else:
        pos_k[:, 3] = -1
    good = p_flash(*(torch.from_numpy(t) for t in (q, k, v, pos, pos)),
                   block_k=BK).numpy()
    bad = p_flash(*(torch.from_numpy(t) for t in (q_bad, k, v, pos_q, pos_k)),
                  block_k=BK).numpy()
    flagged = np.abs(bad - good) > _tolerance(q, k, v, pos, pos, block_k=BK)
    assert flagged.mean() > (0.5 if fault != "key_dropped" else 0.0)


def test_flash_tails_and_empty_rows():
    """Any Sq and Skv (the reference drops tail rows): a short last block,
    Sq != Skv, a query row with no valid key gives 0, and the result is the
    dense softmax within the tolerance."""
    q, k, v = _qkv(11, bh=2, sq=37, skv=100, hd=24)
    pos_q = _positions(2, 37) + 63                  # the last 37 of 100
    pos_k = _positions(2, 100)
    pos_q[:, 0] = -1                                # a padded query
    args = [torch.from_numpy(t) for t in (q, k, v, pos_q, pos_k)]
    got = p_flash(*args, block_k=32).numpy()
    assert np.all(got[:, 0] == 0.0)
    qb, kb, vb = (torch.from_numpy(t).to(torch.bfloat16).double()
                  for t in (q, k, v))
    s = qb @ kb.transpose(1, 2) * 24 ** -0.5
    valid = (pos_q[:, :, None] >= pos_k[:, None, :])
    s = s.masked_fill(~torch.from_numpy(valid), float("-inf"))
    dense = torch.nan_to_num(torch.softmax(s, -1)) @ vb
    tol = _dense_tolerance(q, k, v, pos_q, pos_k, block_k=32)
    assert np.all(np.abs(got - dense.float().numpy()) <= tol)


def test_flash_bf16_inputs_are_rounded_inside():
    q, k, v = _qkv(5, bh=1, sq=40, skv=40, hd=16)
    pos = torch.from_numpy(_positions(1, 40))
    f32 = [torch.from_numpy(t).to(torch.bfloat16).float() for t in (q, k, v)]
    b16 = [t.to(torch.bfloat16) for t in f32]
    assert torch.equal(p_flash(*f32, pos, pos, block_k=16),
                       p_flash(*b16, pos, pos, block_k=16))


def test_flash_entry_dispatches_cpu_to_plain():
    q, k, v = (torch.from_numpy(t) for t in _qkv(2, bh=2, sq=20, skv=20,
                                                  hd=8))
    pos = torch.from_numpy(_positions(2, 20))
    before = KERNEL.launches
    got = p_flash(q, k, v, pos, pos, window=5, block_k=8)
    assert torch.equal(got, p_ref.flash_attention_ref(q, k, v, pos, pos,
                                                      window=5, block_k=8))
    assert KERNEL.launches == before == 0


# The CUDA kernel's order of operations (csrc/flash_attention.cu): 64 query
# rows per block, 64-key sub-tiles inside each block_k block (the last one
# short), the q.k dot summed over 16-wide steps of the head dim, two passes
# per block (the row max, then p, l and pv), pv summed sub-tile by sub-tile
# and added to acc * corr at the block's end, and the sub-tiles that cannot
# hold a valid pair of the block's rows skipped.
ROWS, SUB, KSTEP = 64, 64, 16


def _may_hold_valid(pq, pk, window):
    """The kernel's skip test: the ranges of the valid query and key
    positions of a (row block, sub-tile) admit a valid pair."""
    pq, pk = pq[pq >= 0], pk[pk >= 0]
    if pq.numel() == 0 or pk.numel() == 0:
        return False
    return bool(pk.min() <= pq.max() and pq.min() - pk.max() < window)


def _kernel_order(q, k, v, pos_q, pos_k, *, softcap=None, window=1 << 30,
                  block_k=BK, skip=True):
    """Plain f32 emulation (round to nearest) of the kernel's order."""
    f32, bf16 = torch.float32, torch.bfloat16
    q, k, v, pos_q, pos_k = (torch.from_numpy(t) for t in (q, k, v, pos_q,
                                                           pos_k))
    bh, sq, hd = q.shape
    skv = k.shape[1]
    qb, kb, vb = (t.to(bf16).to(f32) for t in (q, k, v))
    scale = torch.tensor(hd ** -0.5, dtype=f32)
    cap = None if softcap is None else torch.tensor(softcap, dtype=f32)
    out = torch.zeros((bh, sq, hd), dtype=f32)
    for b in range(bh):
        for r0 in range(0, sq, ROWS):
            qt, pq = qb[b, r0:r0 + ROWS], pos_q[b, r0:r0 + ROWS]
            rows = qt.shape[0]
            m = torch.full((rows,), p_ref.NEG_INF, dtype=f32)
            l = torch.zeros(rows, dtype=f32)
            acc = torch.zeros((rows, hd), dtype=f32)
            for j0 in range(0, skv, block_k):
                end = min(j0 + block_k, skv)
                subs = [(a, min(a + SUB, end)) for a in range(j0, end, SUB)]
                if skip:
                    subs = [(a, e) for a, e in subs
                            if _may_hold_valid(pq, pos_k[b, a:e], window)]

                def scores(a, e):
                    s = torch.zeros((rows, e - a), dtype=f32)
                    for d in range(0, hd, KSTEP):
                        s = s + qt[:, d:d + KSTEP] @ kb[b, a:e, d:d + KSTEP].T
                    s = s * scale
                    if cap is not None:
                        s = cap * torch.tanh(s / cap)
                    pk = pos_k[b, None, a:e]
                    valid = ((pk >= 0) & (pq[:, None] >= pk)
                             & (pq[:, None] - pk < window))
                    return torch.where(valid, s, p_ref.NEG_INF), valid

                mx = torch.full((rows,), p_ref.NEG_INF, dtype=f32)
                for a, e in subs:                          # pass A
                    mx = torch.maximum(mx, scores(a, e)[0].amax(dim=-1))
                m_new = torch.maximum(m, mx)
                lsum = torch.zeros(rows, dtype=f32)
                pv = torch.zeros((rows, hd), dtype=f32)
                for a, e in subs:                          # pass B
                    s, valid = scores(a, e)
                    p = torch.where(valid, torch.exp(s - m_new[:, None]), 0.0)
                    lsum = lsum + p.sum(dim=-1)
                    pv = pv + p.to(bf16).to(f32) @ vb[b, a:e]
                corr = torch.exp(m - m_new)
                l = l * corr + lsum
                acc = acc * corr[:, None] + pv
                m = m_new
            out[b, r0:r0 + rows] = acc / l.clamp_min(1e-30)[:, None]
    return out.numpy()


def _case_inputs(seed, invalid, sq=S, skv=S):
    q, k, v = _qkv(seed, sq=sq, skv=skv)
    pos_q = _positions(BH, sq) + (skv - sq)
    pos_k = _positions(BH, skv)
    if invalid:
        pos_k[:, -invalid:] = -1
    return q, k, v, pos_q, pos_k


@pytest.mark.parametrize("block_k", [64, 100, 160])
@pytest.mark.parametrize("window,softcap,invalid", CASES)
def test_flash_kernel_order_within_tolerance(window, softcap, invalid,
                                             block_k):
    """The kernel's order of operations lies inside the bound, also where
    block_k is not a multiple of the 64-key sub-tile (a short last
    sub-tile in every block)."""
    q, k, v, pos_q, pos_k = _case_inputs(19, invalid, sq=160, skv=S + 72)
    if softcap is not None:
        q = q * 8                                  # scores reach the cap
    kw = dict(softcap=softcap, window=window, block_k=block_k)
    got = _kernel_order(q, k, v, pos_q, pos_k, **kw)
    want = p_flash(*(torch.from_numpy(t) for t in (q, k, v, pos_q, pos_k)),
                   **kw).numpy()
    tol = _tolerance(q, k, v, pos_q, pos_k, **kw)
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("window,softcap,invalid", CASES)
def test_flash_masked_sub_tiles_change_nothing(window, softcap, invalid):
    """Dropping the fully masked sub-tiles (the kernel's skip) or adding a
    fully masked block of keys leaves the recurrence bit-identical."""
    q, k, v, pos_q, pos_k = _case_inputs(23, invalid)
    kw = dict(softcap=softcap, window=window, block_k=BK)
    skipped = _kernel_order(q, k, v, pos_q, pos_k, **kw)
    every = _kernel_order(q, k, v, pos_q, pos_k, skip=False, **kw)
    assert np.array_equal(skipped, every)
    pad = SUB
    k2, v2 = (np.concatenate([t, t[:, :pad]], axis=1) for t in (k, v))
    pos_k2 = np.concatenate([pos_k, np.full((BH, pad), -1, np.int32)], 1)
    assert np.array_equal(_kernel_order(q, k2, v2, pos_q, pos_k2, **kw),
                          skipped)
    ref = p_flash(*(torch.from_numpy(t) for t in (q, k, v, pos_q, pos_k)),
                  **kw)
    ref2 = p_flash(*(torch.from_numpy(t) for t in (q, k2, v2, pos_q,
                                                   pos_k2)), **kw)
    assert torch.equal(ref, ref2)
