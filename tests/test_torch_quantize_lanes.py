"""The design of the quantize engine (``csrc/m2xfp_quantize.cu``), checked on
the CPU, where the CUDA kernel cannot run.

  * its arithmetic: every division of the plain packer is a product with an
    exact power of two (``x * 2^-e`` for ``x / 2^e`` on every finite bf16 and
    every scale exponent a finite group can have; ``ax * 2^(m - e2)`` for
    ``ax / step``), floor(log2) of a normal f32 is its exponent field, and
    the FP4/FP6 code is the least of the three bands' ``rint(ax *
    2^(m - b)) + (b << m)`` (each an fma with 1.5 * 2^23) and the top
    code, against the plain rounding; the sign bits come from whole input
    words;
  * its dataflow, as a plain-torch lane model: one lane per subgroup of 8,
    the quad's amax through xor-1 and xor-2 exchanges, the top-1 in the
    lane as the largest key code * 8 + 7 - i, the meta byte or-ed over the
    quad, codes paired with lane j ^ 2 through a byte permute,
    the tile's stream rows written to a [row][pitch] byte tile and stored
    along M in pieces of the widest width the address allows, masked at the
    M and K tails, for both tiles the wrapper plans (32 rows x 8 groups, 8
    rows x 1 group). It must equal ``layout.pack_x_elem_em`` byte for byte
    on random, heavy-tailed and edge inputs (``edge_inputs``), and the
    reference's Pallas kernel in interpret mode where that is defined;
  * the launch plan of ``kernels/m2xfp_quantize.py``: the load width from
    the address of x, and enough blocks at a few rows;
  * ``kernels/quantize_probe.py``'s reading of a ptxas report and its byte
    bound.

``edge_inputs`` is shared with the card-only tests of
``tests/test_torch_gpu.py``; this module imports JAX only inside the test
that runs the reference's kernel, so the card's machine (no JAX) can import
it.
"""
import numpy as np
import pytest
import torch

from conftest import heavy_tailed
from repro_torch.core.dtypes import (FP4_E2M1, FP6_E2M3, floor_log2,
                                     fp4_value_to_code, fp6_value_to_code,
                                     round_to_grid)
from repro_torch.kernels import _build, layout
from repro_torch.kernels.m2xfp_quantize import GROUPS_PER_BLOCK, plan

STREAMS = ("codes", "scales", "meta")
XOR1 = [1, 0, 3, 2]                 # lane j's partner in __shfl_xor(.., 1)
XOR2 = [2, 3, 0, 1]                 # and in __shfl_xor(.., 2)
E_MIN, E_MAX = -102, 125            # scale exponents of finite groups
W4A4_POINTS = [(m, k) for m in (1, 8, 64, 129, 2048) for k in (4096, 11008)]


# ------------------------------------------------------------------ inputs

def _group(amax: float, rng) -> np.ndarray:
    """One group of 32 led by ``amax`` (element 0), the rest below it."""
    g = rng.uniform(-1.0, 1.0, 32).astype(np.float32) * np.float32(amax)
    g[0] = amax
    return g


def edge_inputs(seed: int = 0) -> np.ndarray:
    """(32, 256) f32 rows of 8 groups each at the edges of the encode:

    * ties, midpoints and saturation at scales 1, 2^-3, 2^5, 2^-90, 2^100 (the
      group of tests/test_torch_w4a4.py), an all-zero and an all -0.0 group,
      a group of negatives that round to FP4 zero (code 8) beside -0.0
      (code 0);
    * group maxima 4, 6 and 8 times 2^k and their f32 neighbours, for k from
      -100 to 125 in steps of 15, where the scale exponent or the FP4 code
      changes;
    * subnormal groups (every element below 2^-126, bf16 and f32);
    * bf16's largest finite values (scale exponent 125) and their negatives;
    * heavy-tailed rows.

    Every value is finite in f32 and in bf16: the encode is defined for
    finite x (the plain packer's floor(log2) of an infinite amax is not an
    exponent)."""
    rng = np.random.default_rng(seed)
    edge = np.float32([
        2.55, 2.55, -2.55, 1.0, 0.0, -0.0, -0.2, 0.1,
        5.0, 4.25, 4.75, 2.125, 3.875, 1.0625, 5.75, 6.5,
        7.9, 6.9, 6.01, 4.0, -7.9, 0.25, 0.75, 1.25,
        1.75, 2.5, 3.5, -5.0, -0.24, 0.0, 0.0, 0.0])
    neg_zero = np.full(32, -0.0, np.float32)
    to_zero = np.float32([4.0] + [-0.2, -0.24, -0.0, 0.1, -0.1, 0.24,
                                  -0.25, -0.26] * 3 + [-0.0] * 7)
    rows = [np.concatenate([edge, np.zeros(32, np.float32), edge * 2.0 ** -3,
                            edge * 2.0 ** 5, neg_zero, to_zero,
                            edge * 2.0 ** -90, edge * 2.0 ** 100])]
    rows.append(-rows[0])
    rows.append(np.roll(rows[0], 37))
    groups = []
    for k in range(-100, 126, 15):
        for lead in (4.0, 6.0, 8.0):
            if lead * 2.0 ** k > 2.0 ** 127:            # 8 * 2^125: past f32
                continue
            a = np.float32(lead * 2.0 ** k)
            for b in (a, np.nextafter(a, np.float32(0)),
                      np.nextafter(a, np.float32(np.inf))):
                groups.append(_group(b, rng))
    groups += [np.zeros(32, np.float32)] * (-len(groups) % 8)
    rows += list(np.concatenate(groups).reshape(-1, 256))
    sub = np.float32(2.0 ** -133) * np.arange(1, 33, dtype=np.float32)
    rng.shuffle(sub)
    sub_f32 = np.float32(2.0 ** -140) * rng.integers(-2 ** 13, 2 ** 13, 32)
    tiny = sub.copy()
    tiny[5] = np.float32(2.0 ** -126)                 # the smallest normal
    rows.append(np.concatenate([sub, -sub, sub_f32, tiny, sub * 0.5,
                                np.roll(sub, 3), -tiny, sub_f32 * 3]))
    big = np.uint32([0x7F7F0000, 0x7F7E0000, 0x7F000000, 0x3F800000])
    top = np.frombuffer(np.resize(big, 32).tobytes(), np.float32).copy()
    rows.append(np.concatenate([top, -top, top * -1 * (np.arange(32) % 2 * 2
                                                       - 1), top * 0.5,
                                np.roll(top, 1), top[::-1].copy(),
                                -np.roll(top, 2), top * 0.25]))
    rows += list(heavy_tailed(rng, (32 - len(rows), 256)))
    return np.stack(rows).astype(np.float32)


def _inputs(kind: str, m: int, k: int) -> np.ndarray:
    rng = np.random.default_rng(m * 31 + k)
    if kind == "random":
        return (rng.standard_normal((m, k)) * 3).astype(np.float32)
    if kind == "heavy":
        return heavy_tailed(rng, (m, k))
    e = edge_inputs()                                # (32, 256) -> (m, k)
    return np.resize(np.roll(e, m, axis=0), (m, k // 256 * 256 + 256))[
        :, :k].copy()


# ---------------------------------------------------------- the arithmetic

def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e for integer e in the normal range, built in the exponent field
    (the kernel's mx::exp2i)."""
    return ((e.to(torch.int32).clamp(-126, 127) + 127) << 23).view(
        torch.float32)


def _exp_field(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of a normal f32 x > 0: its exponent field (the
    kernel's exp_field)."""
    return (x.view(torch.int32) >> 23) - 127


def _finite_bf16() -> torch.Tensor:
    bits = torch.arange(0, 1 << 16, dtype=torch.int32).to(torch.int16)
    v = bits.view(torch.bfloat16).float()
    return v[torch.isfinite(v)]


@pytest.mark.parametrize("lo", range(E_MIN, E_MAX + 1, 19))
def test_pow2_product_is_division_on_every_bf16(lo):
    """x * 2^-e == x / 2^e bit for bit, for every finite bf16 x and every e
    a finite group can have (amax >= 1e-30 gives e >= -102, amax < 2^128
    gives e <= 125): 2^-e is normal, so both are x / 2^e rounded once."""
    v = _finite_bf16()
    es = torch.arange(lo, min(lo + 19, E_MAX + 1))
    prod = v[None, :] * _pow2(-es)[:, None]
    quot = v[None, :] / _pow2(es)[:, None]
    assert torch.isfinite(_pow2(-es)).all() and (_pow2(-es) >= 2.0 ** -126).all()
    assert torch.equal(prod.view(torch.int32), quot.view(torch.int32))


def _dense_0_16() -> torch.Tensor:
    """Every 512th f32 bit pattern of [0, 16), zero and subnormals included."""
    top = int(torch.tensor(16.0).view(torch.int32))
    return torch.arange(0, top, 512, dtype=torch.int32).view(torch.float32)


def _random_bits(n: int = 1 << 20, seed: int = 3) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    bits = torch.randint(0, 0x7F800000, (n,), generator=g, dtype=torch.int32)
    return bits.view(torch.float32)              # every finite f32 >= 0


@pytest.mark.parametrize("sweep", ["dense_0_16", "random_bits"])
@pytest.mark.parametrize("step_exp", [-3, -2, -1, 0, 1])
def test_step_product_is_division(step_exp, sweep):
    """rtne_mag's ax / step == ax * (1 / step) for step = 2^-3 .. 2^1."""
    ax = _dense_0_16() if sweep == "dense_0_16" else _random_bits()
    step = _pow2(torch.tensor(step_exp))
    inv = _pow2(torch.tensor(-step_exp))
    assert torch.equal((ax * inv).view(torch.int32),
                       (ax / step).view(torch.int32))


def _normal_edges() -> torch.Tensor:
    ks = torch.arange(-126, 128, dtype=torch.float64)
    base = torch.cat([2.0 ** ks, 1.5 * 2.0 ** ks]).float()
    below = torch.nextafter(2.0 * base[:254][1:], torch.tensor(0.0))
    return torch.cat([base, below, torch.tensor(
        [1e-30, 1.0, float(np.nextafter(np.float32(1), np.float32(0))),
         float(np.finfo(np.float32).max), 2.0 ** -126])])


@pytest.mark.parametrize("which", ["every_exponent", "random_normal",
                                   "max_1e-30", "max_1"])
def test_exponent_field_is_floor_log2(which):
    """The exponent field gives torch.frexp's floor(log2) on every normal
    f32 exponent (at 2^k, 1.5 * 2^k and just below 2^(k+1)) and on the two
    arguments the kernel takes it of: max(amax, 1e-30) and max(ax, 1)."""
    x = _normal_edges()
    if which == "random_normal":
        x = _random_bits()
        x = x[x >= 2.0 ** -126]
    elif which == "max_1e-30":
        x = torch.cat([x, _dense_0_16(), torch.zeros(1)]).clamp_min(1e-30)
    elif which == "max_1":
        x = torch.cat([x, _dense_0_16()]).clamp_min(1.0)
    assert torch.equal(_exp_field(x), floor_log2(x))


MAGIC = 12582912.0                  # 1.5 * 2^23, the kernel's kMagic
MAGIC_BITS = 0x4B400000
U32 = 0xFFFFFFFF


def fma_f32(a: torch.Tensor, s: torch.Tensor, c: float) -> torch.Tensor:
    """fmaf(a, s, c) for f32 a, a power of two s and c = MAGIC + a small
    integer: a * s + c is exact in float64 (a has 24 bits, a * s < 64 or
    tiny), so one rounding to f32 is the fused result."""
    return (a.double() * s.double() + c).float()


def code_magic(a: torch.Tensor, s2: torch.Tensor, man: int) -> torch.Tensor:
    """The kernel's code_magic<man>: MAGIC + min(rint(ax * 2^m), rint(ax *
    2^(m-1)) + 2^m, rint(ax * 2^(m-2)) + 2^(m+1), top) for ax = a * s2 /
    2^m, each rint from an fma with MAGIC (half to even)."""
    band, top = float(1 << man), float((4 << man) - 1)
    c0 = fma_f32(a, s2, MAGIC)
    c1 = fma_f32(a, 0.5 * s2, MAGIC + band)
    c2 = fma_f32(a, 0.25 * s2, MAGIC + 2 * band)
    return torch.minimum(torch.minimum(c0, c1),
                         torch.minimum(c2, torch.tensor(MAGIC + top)))


def _midpoints(spec) -> torch.Tensor:
    """Every grid value and midpoint of ``spec`` in [0, 8] with 4 f32
    neighbours on each side."""
    grid = torch.unique(round_to_grid(torch.linspace(0, 8, 4097), spec))
    mids = torch.cat([grid, (grid[1:] + grid[:-1]) / 2, torch.tensor([8.0])])
    out = [mids]
    for d in (1, 2, 3, 4):
        bits = mids.view(torch.int32)
        out += [(bits + d).view(torch.float32),
                (bits - d).clamp_min(0).view(torch.float32)]
    return torch.cat(out)


@pytest.mark.parametrize("scale_exp", [-100, -3, 0, 7, 120])
@pytest.mark.parametrize("sweep", ["dense_0_16", "midpoints"])
@pytest.mark.parametrize("fmt", ["fp4", "fp6"])
def test_code_magic_is_plain_rounding(fmt, sweep, scale_exp):
    """The least of the three bands' fma-rounded codes and the top code is
    the code of the plain RTNE value (round_to_grid, then the value's
    bit-field code), saturation included, for ax = a * 2^-e at scales 2^e
    across the range."""
    spec, to_code, man = ((FP4_E2M1, fp4_value_to_code, 1) if fmt == "fp4"
                          else (FP6_E2M3, fp6_value_to_code, 3))
    ax = _dense_0_16() if sweep == "dense_0_16" else _midpoints(spec)
    a = ax * _pow2(torch.tensor(scale_exp))            # exact: a power of 2
    s2 = _pow2(torch.tensor(man - scale_exp))
    got = (code_magic(a, s2, man).view(torch.int32) - MAGIC_BITS)
    want = to_code(round_to_grid(ax, spec).abs()).to(torch.int32)
    assert torch.equal(got, want)


def _bf16_words(rng, n: int) -> np.ndarray:
    """Words of two bf16 patterns: every pattern in the low half beside
    random and edge patterns in the high half."""
    lo = np.arange(1 << 16, dtype=np.uint32)
    hi = np.concatenate([np.uint32([0, 0x8000, 0x0001, 0x8001, 0x7F7F,
                                    0xFF7F, 0x3F80, 0xBF80]),
                         rng.integers(0, 1 << 16, n, dtype=np.uint32)])
    return (lo[None, :] | (hi[:, None] << 16)).reshape(-1)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sign_bits_from_words(dtype):
    """The kernel's sign bits: w & ((w & mag) + mag) & sign has the sign bit
    of each element that is negative and not -0.0, and __umulhi by 2^(20 +
    4p) (bf16 word p) or 2^(nibble + 4) (f32) moves it to bit 3 of the
    element's nibble."""
    rng = np.random.default_rng(7)
    if dtype == "bfloat16":
        w = _bf16_words(rng, 56)
        mag, sign, halves = 0x7FFF7FFF, 0x80008000, 2
    else:
        w = np.concatenate([rng.integers(0, 1 << 32, 1 << 20, dtype=np.uint64
                                         ).astype(np.uint32),
                            np.uint32([0, 0x80000000, 1, 0x80000001])])
        mag, sign, halves = 0x7FFFFFFF, 0x80000000, 1
    w = w.astype(np.uint64)
    neg = w & (((w & mag) + mag) & U32) & sign
    for h in range(halves):
        bits = (w >> (16 * h if halves == 2 else 0)) & (
            0xFFFF if halves == 2 else U32)
        top = 15 if halves == 2 else 31
        want = ((bits >> top) & 1).astype(bool) & ((bits & ((1 << top) - 1))
                                                   != 0)
        got = ((neg >> (16 * h + 15 if halves == 2 else 31)) & 1).astype(bool)
        np.testing.assert_array_equal(got, want)
    for p in range(4 if halves == 2 else 8):
        shift = nibble(p * halves) + 3 + 32 - (15 if halves == 2 else 31)
        moved = neg if shift == 32 else (neg * (1 << shift)) >> 32
        for h in range(halves):
            src = (16 * h + 15) if halves == 2 else 31
            dst = nibble(p * halves + h) + 3
            np.testing.assert_array_equal((moved >> dst) & 1,
                                          (neg >> src) & 1)


# ------------------------------------------------------- the lane model

def nibble(i: int) -> int:
    """The kernel's nibble(i): even elements in the low half-word."""
    return 4 * (i >> 1) + 16 * (i & 1)


def _byte_perm(t: np.ndarray, u: np.ndarray, sel: int) -> np.ndarray:
    """__byte_perm(t, u, sel) for selectors of bytes 0-7 (no sign mode)."""
    both = t.astype(np.uint64) | (u.astype(np.uint64) << 32)
    out = np.zeros_like(t, dtype=np.uint64)
    for k in range(4):
        src = (sel >> (4 * k)) & 7
        out |= ((both >> (8 * src)) & 0xFF) << (8 * k)
    return out


def lane_encode(x: torch.Tensor) -> dict:
    """Per lane (row m, group g, subgroup j) of f32 x (M, K), as the kernel
    computes it: the scale byte, the meta byte (after the quad's or) and
    the 32-bit word of 4 code bytes the lane writes, with its first code row
    within the group."""
    m, k = x.shape
    bits = x.reshape(m, k // 32, 4, 8).view(torch.int32).numpy().astype(
        np.uint64) & U32
    mag = bits & 0x7FFFFFFF
    a = torch.from_numpy(mag.astype(np.uint32).view(np.float32).copy())
    amax = mag.max(-1)                                   # bits order as values
    amax = np.maximum(amax, amax[..., XOR1])
    amax = np.maximum(amax, amax[..., XOR2])
    amax_f = torch.from_numpy(amax.astype(np.uint32).view(np.float32).copy())
    e = torch.where(torch.from_numpy(amax == 0), 0,
                    _exp_field(amax_f.clamp_min(1e-30)) - 2).clamp(-126, 127)
    s = _pow2(-e)[..., None]
    g = code_magic(a, 2.0 * s, 1).view(torch.int32).numpy().astype(
        np.uint64) & U32
    nib = np.full(g.shape[:-1], (-MAGIC_BITS * 0x11111111) & U32, np.uint64)
    key = np.zeros(g.shape[:-1], np.uint64)
    for i in range(8):
        nib = (nib + (g[..., i] << nibble(i))) & U32
        key = np.maximum(key, (g[..., i] * 8 + 7 - i) & U32)
    neg = (bits >> 31) & (mag != 0)                      # x < 0, not -0.0
    for i in range(8):
        nib = nib + (neg[..., i] << (nibble(i) + 3))
    r = (key - MAGIC_BITS * 8) & U32
    cmax, top = (r >> 3).astype(np.int64), 7 - (r & 7).astype(np.int64)
    at = torch.from_numpy(np.take_along_axis(
        mag, top[..., None], -1)[..., 0].astype(np.uint32).view(
            np.float32).copy())
    c6 = (code_magic(at, 8.0 * s[..., 0], 3).view(torch.int32).numpy()
          .astype(np.int64) - MAGIC_BITS)
    rmin = cmax << 2
    j = np.arange(4)
    mb = (np.minimum(np.maximum(c6 + 1, rmin), rmin | 3) & 3) << (2 * j)
    mb = mb | mb[..., XOR1]
    mb = mb | mb[..., XOR2]
    other = nib[..., XOR2]
    upper = (j & 2).astype(bool)
    lo = np.where(upper, other, nib)
    hi = np.where(upper, nib, other)
    t = (lo & 0x0F0F0F0F) | ((hi << 4) & 0xF0F0F0F0)
    u = ((lo >> 4) & 0x0F0F0F0F) | (hi & 0xF0F0F0F0)
    word = np.where(upper, _byte_perm(t, u, 0x7531), _byte_perm(t, u, 0x6420))
    return {"scale": (e[..., 0] + 127).to(torch.uint8).numpy(),
            "meta": mb[..., 1], "word": word,
            "row0": 8 * (j & 1) + 4 * (j >> 1)}


def store_pieces(addr: int, n: int, chunk: int) -> list:
    """(offset, width) of the stores store_bytes issues for n bytes at
    ``addr``: one 16-byte store where address and n allow, else the widest
    width that divides both."""
    a = addr | n
    if chunk == 16 and a % 16 == 0:
        return [(0, 16)]
    for w in (8, 4, 2, 1):
        if a % w == 0:
            return [(i, w) for i in range(0, n, w)]


def pitch(tm: int) -> int:
    return (tm + 15) // 16 * 16 + 8


def lane_model(x: torch.Tensor, tm: int) -> tuple:
    """The kernel's streams for f32 x (M, K) with blocks of ``tm`` rows x
    GROUPS_PER_BLOCK[tm] groups, and the widths of every store it issues."""
    m, k = x.shape
    groups, tg = k // 32, GROUPS_PER_BLOCK[tm]
    mpad = -(-m // tm) * tm                  # rows past M are encoded as 0
    lanes = lane_encode(torch.cat([x, x.new_zeros(mpad - m, k)]))
    word = lanes["word"]
    out = {"codes": np.zeros((k // 2, m), np.uint8),
           "scales": np.zeros((groups, m), np.uint8),
           "meta": np.zeros((groups, m), np.uint8)}
    chunk = min(tm, 16)
    widths = []
    gtiles = -(-groups // tg)
    for t in range(mpad // tm * gtiles):         # block t: groups fastest
        m0, g0 = t // gtiles * tm, t % gtiles * tg
        tile = np.zeros((18 * tg, pitch(tm)), np.uint8)
        gv = min(tg, groups - g0)
        rows = slice(m0, m0 + tm)
        for w in range(gv):
            for j in range(4):
                base = 16 * w + int(lanes["row0"][j])
                for b in range(4):
                    tile[base + b, :tm] = (word[rows, g0 + w, j]
                                           >> (8 * b)) & 0xFF
            tile[16 * tg + w, :tm] = lanes["scale"][rows, g0 + w]
            tile[17 * tg + w, :tm] = lanes["meta"][rows, g0 + w]
        valid = min(tm, m - m0)
        for r in range(18 * tg):
            if r < 16 * tg:
                name, row, ok = "codes", 16 * g0 + r, r < 16 * gv
            elif r < 17 * tg:
                name, row, ok = "scales", g0 + r - 16 * tg, r - 16 * tg < gv
            else:
                name, row, ok = "meta", g0 + r - 17 * tg, r - 17 * tg < gv
            for c in range(0, tm, chunk):
                if not ok or c >= valid:
                    continue
                n = min(chunk, valid - c)
                addr = row * m + m0 + c
                got = 0
                for off, wd in store_pieces(addr, n, chunk):
                    assert (addr + off) % wd == 0 and off == got
                    out[name][row, m0 + c + off:m0 + c + off + wd] = \
                        tile[r, c + off:c + off + wd]
                    got += wd
                    widths.append(wd)
                assert got == n
    return {s: torch.from_numpy(a) for s, a in out.items()}, widths


@pytest.mark.parametrize("tm", sorted(GROUPS_PER_BLOCK))
@pytest.mark.parametrize("m,k", [(1, 32), (7, 96), (9, 288), (17, 256),
                                 (33, 544), (70, 288)])
@pytest.mark.parametrize("kind", ["random", "heavy", "edge"])
def test_lane_model_equals_packer(kind, m, k, tm):
    """The kernel's dataflow gives the plain packer's bytes, for both tiles,
    at M and K tails (K = 96, 288, 544: not multiples of 8 groups; M off 8
    and 32), from f32 and from bf16 values."""
    x = torch.from_numpy(_inputs(kind, m, k))
    for xin in (x, x.to(torch.bfloat16).float()):
        assert torch.isfinite(xin).all()
        got, _ = lane_model(xin, tm)
        want = layout.pack_x_elem_em(xin)
        for s in STREAMS:
            assert torch.equal(got[s], want[s]), s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lane_model_equals_packer_on_edge_rows(dtype):
    """Every edge row of ``edge_inputs`` (also those the other cases roll
    away), at the 32-row tile with its M tail."""
    x = torch.from_numpy(edge_inputs()).to(getattr(torch, dtype)).float()
    got, _ = lane_model(x, 32)
    want = layout.pack_x_elem_em(x)
    for s in STREAMS:
        assert torch.equal(got[s], want[s]), s


@pytest.mark.parametrize("kind,m,k", [("heavy", 16, 256), ("edge", 8, 256),
                                      ("random", 32, 512)])
def test_lane_model_equals_reference_pallas_kernel(kind, m, k):
    """The lane model against the reference's Pallas quantize kernel in
    interpret mode (as tests/test_torch_w4a4.py runs it), on shapes where
    that kernel is defined and inputs in its domain (group maxima 0 or at
    least 2^-100: below that the reference's CPU runtime flushes, ROADMAP
    C)."""
    import jax.numpy as jnp
    from repro.kernels import ops as r_ops
    x = _inputs(kind, m, k)
    g = np.abs(x.reshape(m, k // 32, 32)).max(-1)
    keep = ((g == 0) | (g >= 2.0 ** -100))[..., None]
    x = np.where(keep, x.reshape(m, k // 32, 32), 0.0).reshape(m, k)
    x = x.astype(np.float32)
    want = r_ops.m2xfp_quantize(jnp.asarray(x), block_m=min(m, 128),
                                block_k=min(k, 256))
    for tm in sorted(GROUPS_PER_BLOCK):
        got, _ = lane_model(torch.from_numpy(x), tm)
        for s in STREAMS:
            np.testing.assert_array_equal(np.asarray(want[s]),
                                          got[s].numpy(), err_msg=s)


@pytest.mark.parametrize("m,tm,widths", [(2048, 32, {16}), (64, 32, {16}),
                                         (8, 8, {8}), (24, 8, {8}),
                                         (40, 32, {16, 8}), (12, 8, {8, 4})])
def test_store_widths(m, tm, widths):
    """The store phase's widths: all 16 bytes where every row starts on a
    16-byte boundary (M % 16 == 0, 32-row tiles), 8 at the 8-row tile and
    M % 8 == 0, narrower where a row starts off those boundaries."""
    x = torch.from_numpy(_inputs("heavy", m, 64))
    got, used = lane_model(x, tm)
    assert set(used) == widths
    assert torch.equal(got["codes"], layout.pack_x_elem_em(x)["codes"])


@pytest.mark.parametrize("tm", sorted(GROUPS_PER_BLOCK))
@pytest.mark.parametrize("m", [1, 3, 13, 129])
def test_store_pieces_cover_each_byte_once(m, tm):
    """At an odd M the rows start at every alignment: the pieces, each at
    its own alignment and in order (asserted inside lane_model), store
    every byte of the three streams exactly once."""
    k = 96
    x = torch.from_numpy(_inputs("random", m, k))
    got, used = lane_model(x, tm)
    assert sum(used) == m * (k // 2 + 2 * (k // 32))
    for s in STREAMS:
        assert torch.equal(got[s], layout.pack_x_elem_em(x)[s]), s


# ------------------------------------------------------- the launch plan

@pytest.mark.parametrize("offset,vec", [(0, 16), (2, 2), (4, 4), (6, 2),
                                        (8, 8), (12, 4), (16, 16), (24, 8)])
def test_plan_load_width(offset, vec):
    """The widest load the address of x allows (x at a storage offset)."""
    base = 0x7F00_0000_0000
    assert plan(base + offset, 8, 4096)[0] == vec


@pytest.mark.parametrize("m,k", W4A4_POINTS)
def test_plan_fills_the_card(m, k):
    """At every W4A4 point of chip_smoke.py the grid has at least 128
    blocks (of 132 SMs), and M = 2048 takes the 32-row tile."""
    tm = plan(0, m, k)[1]
    blocks = -(-m // tm) * -(-(k // 32) // GROUPS_PER_BLOCK[tm])
    assert blocks >= 128
    assert (tm == 32) == (m == 2048)
    assert tm == 8 or blocks >= _build.TARGET_BLOCKS


def test_plan_tiles_are_the_kernels():
    """The tiles the plan can pick are the kernel's two instances."""
    src = (_build.CSRC / "m2xfp_quantize.cu").read_text()
    for tm, tg in GROUPS_PER_BLOCK.items():
        assert f"launch<T, {tm}, {tg}>" in src


# ----------------------------------------------- the measurement script

PTXAS = """\
ptxas info    : Compiling entry function '_Z8quantizeILi16EEvPKv' for 'sm_90a'
ptxas info    : Function properties for _Z8quantizeILi16EEvPKv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 52 registers, used 1 barriers, 5760 bytes smem
ptxas info    : Compiling entry function '_Z8quantizeILi2EEvPKv' for 'sm_90a'
ptxas info    : Function properties for _Z8quantizeILi2EEvPKv
    8 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 432 bytes smem
"""


def test_probe_reads_ptxas_report():
    """quantize_probe (the script behind PERF.md's quantize numbers) reads
    registers, stack frame and spill bytes per kernel instance."""
    from repro_torch.kernels.quantize_probe import ptxas_functions
    assert ptxas_functions(PTXAS) == [
        {"function": "_Z8quantizeILi16EEvPKv", "stack_bytes": 0,
         "spill_bytes": 0, "registers": 52},
        {"function": "_Z8quantizeILi2EEvPKv", "stack_bytes": 8,
         "spill_bytes": 16, "registers": 40}]


@pytest.mark.parametrize("m,k,itemsize", [(2048, 4096, 2), (2048, 11008, 2),
                                          (8, 4096, 2), (2048, 4096, 4)])
def test_probe_bound_is_bytes_over_hbm_rate(m, k, itemsize):
    """The byte bound of one call: x read once, the three streams written
    once (K/2 + 2 K/32 bytes per row), at the H100's 3.35 TB/s."""
    from repro_torch.kernels.quantize_probe import bound_ms
    streams = m * (k // 2 + 2 * (k // 32))
    assert bound_ms(m, k, itemsize) == pytest.approx(
        (m * k * itemsize + streams) / 3.35e12 * 1e3, rel=1e-12)
