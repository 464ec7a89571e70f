"""The summation order of the tensor-core dequant-GEMMs
(``csrc/mx_dequant_gemm.cuh``), checked on the CPU.

The CUDA kernel runs only on the card. What it computes is fixed here:

  * the split-K plan (``kernels/_build.py::split_k``, ``split_bounds``):
    chosen from (K, N) alone, every K group in exactly one split, splits in
    order, none empty, at most one portable cluster of 8 splits (their sum
    runs through distributed shared memory, so there is no workspace);
  * the in-register weight decode, mirrored bit for bit in PyTorch: the FP4
    nibble placed in a bf16 (its value times 2^-126), times 2^126, times the
    subgroup scale built from the scale byte and the 2-bit meta field, equals
    the plain decoder on every code, meta field and scale byte;
  * an f32 emulation of the kernel's order: exact products, one f32 rounding
    per k16 step (to nearest, and toward zero as the pessimistic model of the
    tensor cores' truncating sums), the splits then added in order. It stays
    within chip_smoke.py's TOLERANCE ``sqrt(K) * 2^-24 * (|x| @ |Wdec|)`` of
    the float64 plain version, its rows do not depend on M, and a one-group
    fault of the weight still breaks the tolerance.

The W4A4 GEMM (``csrc/m2xfp_qmatmul.cu``) is the same template with X
decoded through the Top-1 Decode Unit into the bf16 operand, so the same
emulation, fed ``ref.decode_x_elem_em_ref``'s decoded X, is its order too:
the decoded X is bf16-exact for every code, meta field and scale byte 1-254;
on X whose partial sums are all exact the emulation equals the plain version
bit for bit, and on heavy-tailed X it stays within chip_smoke.py's
W4A4_TOLERANCE ``sqrt(K) * 2^-24 * (|Xdec| @ |Wdec|)``.

The reference's Pallas kernels and plain versions are held against the
port's plain versions in tests/test_torch_kernels.py; this file needs no
JAX.
"""
import inspect

import numpy as np
import pytest
import torch

from conftest import heavy_tailed
from repro_torch.kernels import _build, layout, ref

PROJ_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096)]   # (K, N)
CODECS = {
    "m2xfp": (layout.pack_w_sgem, ref.decode_w_sgem_ref, ref.m2xfp_matmul_ref),
    "mxfp4": (layout.pack_w_mxfp4, ref.decode_w_mxfp4_ref,
              ref.mxfp4_matmul_ref),
}


# ---------------------------------------------------------------- split plan

@pytest.mark.parametrize("k,n", PROJ_SHAPES + [
    (32, 8), (32, 4096), (64, 200), (64, 11008), (11008 + 32, 200),
    (11008 + 32, 4096), (4096 + 32, 200), (11008, 200), (128, 1)])
def test_split_bounds_cover_every_group_once(k, n):
    groups = k // 32
    s = _build.split_k(k, n)
    b = _build.split_bounds(groups, s)
    assert 1 <= s <= min(groups, _build.MAX_SPLITS)
    assert b[0] == 0 and b[-1] == groups and len(b) == s + 1
    assert all(lo < hi for lo, hi in zip(b, b[1:]))       # in order, none empty
    covered = [g for lo, hi in zip(b, b[1:]) for g in range(lo, hi)]
    assert covered == list(range(groups))


@pytest.mark.parametrize("k,n", PROJ_SHAPES)
def test_split_fills_the_card_at_projection_shapes(k, n):
    """Column tiles times splits give about two blocks on each of 132 SMs:
    344 at N = 11008, 256 at N = 4096, where 32 column tiles of 128 meet
    the cluster's limit of 8 splits."""
    tiles = -(-n // _build.BLOCK_N)
    assert tiles * _build.split_k(k, n) >= 256


def test_split_depends_on_k_and_n_only():
    """The split count is a function of (K, N) alone: the wrapper cannot
    pass it an M, so a row is summed in the same order at every M."""
    assert list(inspect.signature(_build.split_k).parameters) == ["k", "n"]
    assert [_build.split_k(k, n) for k, n in PROJ_SHAPES] == [8, 4, 8]


def test_splits_fit_one_portable_cluster():
    """The S splits of a column tile are one thread-block cluster, which
    sums them through distributed shared memory: S stays within a portable
    cluster (8 blocks) for every K and N, so the reduction needs no
    workspace at any M (the w4a4 phase's M = 2048 included)."""
    assert _build.MAX_SPLITS == 8
    for k in (32, 64, 96, 512, 4096, 11008, 16384):
        for n in range(1, 40001, 7):
            s = _build.split_k(k, n)
            assert 1 <= s <= min(8, k // 32)
            tiles = -(-n // _build.BLOCK_N)
            if s < min(8, k // 32):            # only the target stops it
                assert tiles * s >= _build.TARGET_BLOCKS


# ----------------------------------------------------- in-register decode

def _bf16(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.int16).view(torch.bfloat16)


def _decode_bits(codes: torch.Tensor, scales: torch.Tensor,
                 fields: torch.Tensor) -> torch.Tensor:
    """PyTorch mirror of the kernel's decode of FP4 codes (int32) with the
    scale byte and 2-bit meta field of their subgroup: the nibble as bf16
    bits, times 2^126, times (1 + field/4) * 2^(clamp(s, 1, 254) - 127)."""
    raw = _bf16(((codes & 7) << 6) | ((codes & 8) << 12))
    two126 = _bf16(torch.full_like(codes, 0x7E80))
    sub = _bf16((scales.clamp(1, 254) << 7) | (fields << 5))
    return ((raw * two126) * sub).float()


def test_bit_decode_equals_plain_decoder_exhaustively():
    """Every FP4 code x every 2-bit field x every scale byte, subnormal
    results (scale bytes 0-3) and the clamped ends included."""
    c, f, s = torch.meshgrid(torch.arange(16), torch.arange(4),
                             torch.arange(256), indexing="ij")
    c, f, s = (t.reshape(-1).to(torch.int32) for t in (c, f, s))
    n = c.numel()
    # one column per case: K = 32 rows, the case's code in row 0, subgroup 0
    codes = torch.zeros(32, n, dtype=torch.int32)
    codes[0] = c
    packed = {"codes": layout.interleave_pack(codes),
              "scales": s.to(torch.uint8)[None],
              "meta": f.to(torch.uint8)[None]}
    want = ref.decode_w_sgem_ref(packed)[0]
    got = _decode_bits(c, s, f)
    finite = torch.isfinite(want)
    assert torch.equal(got[finite], want[finite])
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert bool(((got != 0) & (got.abs() < 2.0 ** -126)).any())  # subnormals
    mx = ref.decode_w_mxfp4_ref({"codes": packed["codes"],
                                 "scales": packed["scales"]})[0]
    got0 = _decode_bits(c, s, torch.zeros_like(f))
    finite = torch.isfinite(mx)
    assert torch.equal(got0[finite], mx[finite])


# ------------------------------------------------ emulated summation order

def _round_f32(v: torch.Tensor, mode: str) -> torch.Tensor:
    """float64 -> float32, to nearest or toward zero."""
    r = v.float()
    if mode == "rz":
        over = r.double().abs() > v.abs()
        r = torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def _emulate(x: torch.Tensor, wdec: torch.Tensor, s: int,
             mode: str) -> torch.Tensor:
    """The kernel's order for bf16 x (M, K) @ Wdec (K, N) with s splits:
    per split, an f32 chain over its k16 steps in K order, each step the
    exact sum of its 16 products added to the chain and rounded once; then
    out = ((p0 + p1) + p2) + ... in f32."""
    xd, wd = x.double(), wdec.double()
    b = _build.split_bounds(x.shape[1] // 32, s)
    parts = []
    for lo, hi in zip(b, b[1:]):
        acc = torch.zeros(x.shape[0], wdec.shape[1], dtype=torch.float32)
        for k0 in range(32 * lo, 32 * hi, 16):
            prods = xd[:, k0:k0 + 16, None] * wd[None, k0:k0 + 16, :]
            v = acc.double()
            for j in range(16):
                v = v + prods[:, j]
            acc = _round_f32(v, mode)
        parts.append(acc)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _plant_fault(fmt: str, wp: dict) -> dict:
    """chip_smoke.py's fault: the first K group decodes differently (m2xfp
    loses subgroup 0's meta multiplier, mxfp4 halves the scale)."""
    bad = dict(wp)
    if fmt == "m2xfp":
        bad["meta"] = wp["meta"].clone()
        bad["meta"][0] &= 0xFC
    else:
        bad["scales"] = wp["scales"].clone()
        bad["scales"][0] -= 1
    return bad


# (K, N of the projection whose split count is used, emulated columns)
ORDER_CASES = [(4096, 4096, 24), (4096, 11008, 24), (11008, 4096, 24),
               (4096, 24, 24), (11008, 24, 24)]


@pytest.mark.parametrize("mode", ["rn", "rz"])
@pytest.mark.parametrize("k,n_full,n", ORDER_CASES)
@pytest.mark.parametrize("fmt", sorted(CODECS))
def test_emulated_order_within_tolerance(fmt, k, n_full, n, mode):
    """The kernel's order on N(0,1) x and 0.02 randn weights, with the split
    count of the (K, N) projection (its columns are summed independently, so
    a narrow slice of them is what the kernel does for those columns): within
    TOLERANCE of the plain version, rows bit-identical across M in
    {1, 8, 129}, and a planted one-group fault flagged."""
    pack, decode, plain = CODECS[fmt]
    rng = np.random.default_rng(k + n_full)
    x = torch.from_numpy(rng.standard_normal((129, k)).astype(np.float32)
                         ).to(torch.bfloat16).float()
    w = torch.from_numpy(
        (rng.standard_normal((k, n)) * 0.02).astype(np.float32))
    wp = pack(w)
    wdec = decode(wp)
    s = _build.split_k(k, n_full)
    got = _emulate(x, wdec, s, mode)
    tol = k ** 0.5 * 2.0 ** -24 * ref.dot_f64acc(x.abs(), wdec.abs())
    diff = (got - plain(x, wp)).abs()
    ratio = float((diff / tol).max())
    assert ratio < 1, ratio
    for m in (1, 8):
        assert torch.equal(_emulate(x[:m], wdec, s, mode), got[:m]), m
    caught = (got[:8] - plain(x[:8], _plant_fault(fmt, wp))).abs() > tol[:8]
    assert bool(caught.any())


def test_emulated_order_depends_on_the_splits():
    """Another split count changes the bits (so the kernel's fixed count is
    what keeps rows identical), while both stay within the tolerance."""
    rng = np.random.default_rng(7)
    k, n = 4096, 16
    x = torch.from_numpy(rng.standard_normal((8, k)).astype(np.float32)
                         ).to(torch.bfloat16).float()
    wp = layout.pack_w_sgem(torch.from_numpy(
        (rng.standard_normal((k, n)) * 0.02).astype(np.float32)))
    wdec = ref.decode_w_sgem_ref(wp)
    a = _emulate(x, wdec, 1, "rz")
    b = _emulate(x, wdec, 5, "rz")
    assert not torch.equal(a, b)
    tol = k ** 0.5 * 2.0 ** -24 * ref.dot_f64acc(x.abs(), wdec.abs())
    want = ref.m2xfp_matmul_ref(x, wp)
    assert bool(((a - want).abs() <= tol).all())
    assert bool(((b - want).abs() <= tol).all())


# ------------------------------------------- the W4A4 GEMM on decoded X

def test_decoded_x_is_bf16_exact_exhaustively():
    """Every FP4 code x every 2-bit meta field x every scale byte 1-254,
    as the top-1 element (its FP6 value) and as a tied element after it (its
    FP4 value): the Top-1 Decode Unit's output is exact in bf16, so the
    kernel's bf16 x operand is the decoded X itself."""
    c, f, s = torch.meshgrid(torch.arange(16), torch.arange(4),
                             torch.arange(1, 255), indexing="ij")
    c, f, s = (t.reshape(-1).to(torch.int32) for t in (c, f, s))
    codes = torch.zeros(32, c.numel(), dtype=torch.int32)
    codes[0] = c                          # top-1 of subgroup 0 (first max)
    codes[1] = c                          # its tie: keeps the FP4 value
    codes[8] = 15 - c                     # subgroup 1: another code
    xp = {"codes": layout.interleave_pack(codes),
          "scales": s.to(torch.uint8)[None],
          "meta": (f | (f << 2)).to(torch.uint8)[None]}
    xdec = ref.decode_x_elem_em_ref(xp)                    # (M, K) f32
    finite = torch.isfinite(xdec)
    assert torch.equal(xdec.to(torch.bfloat16).float()[finite],
                       xdec[finite])
    assert torch.equal(torch.isinf(xdec.to(torch.bfloat16).float()),
                       torch.isinf(xdec))
    assert not bool(torch.isnan(xdec).any())
    # both paths were taken: FP6 values (not on the FP4 grid) and FP4 ones
    mant = xdec[:, 0][xdec[:, 0] != 0] / 2.0 ** torch.floor(
        torch.log2(xdec[:, 0][xdec[:, 0] != 0].abs()))
    assert bool(((mant.abs() * 8) % 2 == 1).any())       # 3 mantissa bits


def _edge_x() -> torch.Tensor:
    """(8, 128) activations in the style of test_torch_w4a4's edge inputs:
    top-1 ties (also between +x and -x), negatives that round to FP4 zero,
    FP4 and FP6 midpoints, FP4 saturation, FP6 codes clamped from below and
    above, an all-zero group, scales 1, 2^-3 and 2^5, negated and rolled
    rows."""
    e = np.float32([
        2.55, 2.55, -2.55, 1.0, 0.0, -0.0, -0.2, 0.1,
        5.0, 4.25, 4.75, 2.125, 3.875, 1.0625, 5.75, 6.5,
        7.9, 6.9, 6.01, 4.0, -7.9, 0.25, 0.75, 1.25,
        1.75, 2.5, 3.5, -5.0, -0.24, 0.0, 0.0, 0.0])
    row = np.concatenate([e, np.zeros(32, np.float32), e * 2.0 ** -3,
                          e * 2.0 ** 5])
    rows = [row, -row, np.roll(row, 5), np.roll(-row, 11)]
    rows += [np.roll(row, 3 * i) * 2.0 ** -i for i in range(4)]
    return torch.from_numpy(np.stack(rows).astype(np.float32))


@pytest.mark.parametrize("mode", ["rn", "rz"])
@pytest.mark.parametrize("s", [1, 2, 4])
def test_w4a4_emulated_order_exact_sums_equal_plain(s, mode):
    """On edge activations and a weight on a coarse grid, every partial sum
    of the kernel's order is exact in f32 (each product is a multiple of a
    common quantum and every partial sum stays below 2^24 quanta, checked
    here), so the emulation equals the plain version bit for bit at any
    split count."""
    xp = layout.pack_x_elem_em(_edge_x())
    xdec = ref.decode_x_elem_em_ref(xp)
    w = torch.from_numpy(np.random.default_rng(0).integers(
        -3, 4, (128, 24)).astype(np.float32))
    wp = layout.pack_w_sgem(w)
    wdec = ref.decode_w_sgem_ref(wp)
    prods = xdec.double()[:, :, None] * wdec.double()[None]
    mant, exp = torch.frexp(prods[prods != 0].abs())     # exact products
    ints = (mant * 2.0 ** 53).to(torch.int64)
    lsb = exp - 53 + torch.log2((ints & -ints).double()).to(torch.int32)
    quantum = 2.0 ** int(lsb.min())       # every product is a multiple of it
    bound = (xdec.abs().double() @ wdec.abs().double()).max()
    assert float(bound / quantum) < 2 ** 24
    got = _emulate(xdec, wdec, s, mode)
    assert torch.equal(got, ref.m2xfp_qmatmul_ref(xp, wp))


@pytest.mark.parametrize("mode", ["rn", "rz"])
@pytest.mark.parametrize("k,n_full", PROJ_SHAPES)
def test_w4a4_emulated_order_within_tolerance(k, n_full, mode):
    """Heavy-tailed activations (student-t, log-normal channel scales),
    packed by the quantize engine's plain version, against a 0.02 randn
    weight with the split count of the projection: the emulated order
    stays within W4A4_TOLERANCE of the plain version, its rows do not depend
    on M, and a planted fault of the X meta is flagged."""
    x = torch.from_numpy(heavy_tailed(np.random.default_rng(k + n_full),
                                      (16, k)))
    xp = layout.pack_x_elem_em(x)
    xdec = ref.decode_x_elem_em_ref(xp)
    rng = np.random.default_rng(n_full)
    wp = layout.pack_w_sgem(torch.from_numpy(
        (rng.standard_normal((k, 16)) * 0.02).astype(np.float32)))
    wdec = ref.decode_w_sgem_ref(wp)
    s = _build.split_k(k, n_full)
    got = _emulate(xdec, wdec, s, mode)
    tol = k ** 0.5 * 2.0 ** -24 * ref.dot_f64acc(xdec.abs(), wdec.abs())
    ratio = float(((got - ref.m2xfp_qmatmul_ref(xp, wp)).abs() / tol).max())
    assert ratio < 1, ratio
    for m in (1, 8):
        assert torch.equal(_emulate(xdec[:m], wdec, s, mode), got[:m]), m
    bad = dict(xp)
    bad["meta"] = xp["meta"].clone()
    bad["meta"][0] ^= 0x02
    assert bool(((got - ref.m2xfp_qmatmul_ref(bad, wp)).abs() > tol).any())
