"""Low-bit floating-point grids of the MX formats (port of repro.core.dtypes).

Rounding is round-to-nearest-even (RTNE): scale into the element's binade
(exact, via ``torch.frexp``) and round with ``torch.round``, which rounds
half to even. Grid-index parity equals mantissa parity within a binade, so
integer RTNE equals floating-point RTNE on these grids.

Formats:
  FP4 E2M1  (bias 1): magnitudes {0, .5, 1, 1.5, 2, 3, 4, 6}
  FP6 E2M3  (bias 1): 32 magnitudes, max 7.5, subnormal step 1/8
  FP8 E4M3  (bias 7): max 448 (NVFP4's group scale; its byte view is
            ``torch.float8_e4m3fn``)
  E8M0      (bias 127): power-of-two scale 2^E

Code <-> value conversions use exponent-field arithmetic instead of a
lookup table, so they need no per-device constant tensors; on grid values
they equal the reference's table lookups (tests/test_torch_layout.py checks
every code).
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "FloatSpec", "FP4_E2M1", "FP6_E2M3", "FP8_E4M3", "round_to_grid",
    "floor_log2", "exp2int", "fp4_code_to_value", "fp4_value_to_code",
    "fp6_code_to_value", "fp6_value_to_code", "sign", "div_const",
    "log2_f32", "sign_mag_code", "signed_fp4",
]


@dataclasses.dataclass(frozen=True)
class FloatSpec:
    """A miniature sign/exponent/mantissa float format (finite grid)."""

    name: str
    exp_bits: int
    man_bits: int
    bias: int
    # E4M3 reserves mantissa 0b111 of the top binade for NaN, so its
    # largest value is 448, not the generic 480. None: the generic formula.
    max_value_override: float | None = None

    @property
    def emax(self) -> int:
        """Largest true (unbiased) exponent of a normal number."""
        return (2 ** self.exp_bits - 1) - self.bias

    @property
    def emin(self) -> int:
        """True exponent of the smallest normal / the subnormal binade."""
        return 1 - self.bias

    @property
    def max_value(self) -> float:
        if self.max_value_override is not None:
            return self.max_value_override
        return float(2.0 ** self.emax * (2.0 - 2.0 ** (-self.man_bits)))

    @property
    def max_pow2(self) -> float:
        """Largest representable power of two (the OCP 'P' constant)."""
        return float(2.0 ** self.emax)


FP4_E2M1 = FloatSpec("fp4_e2m1", exp_bits=2, man_bits=1, bias=1)
FP6_E2M3 = FloatSpec("fp6_e2m3", exp_bits=2, man_bits=3, bias=1)
FP8_E4M3 = FloatSpec("fp8_e4m3", exp_bits=4, man_bits=3, bias=7,
                     max_value_override=448.0)


def exp2int(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e (f32) for integer e, clamped to [-126, 127], built in the
    exponent field."""
    bits = (e.clamp(-126, 127).to(torch.int32) + 127) << 23
    return bits.view(torch.float32)


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact floor(log2(|x|)) via frexp; x > 0 where used."""
    return torch.frexp(x)[1] - 1


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` correctly rounded on every device. PyTorch's CUDA division
    by a Python scalar multiplies by the scalar's reciprocal, which rounds
    differently where ``c`` is not a power of two; a 0-dim tensor on
    ``x``'s device (a fill, no host-to-device copy) keeps it a division, as
    on the CPU."""
    return x / x.new_full((), c)


def log2_f32(x: torch.Tensor) -> torch.Tensor:
    """log2 of f32 ``x``, correctly rounded to f32 (taken in float64), so
    the CPU and the card agree where a rounding or ceiling of it is taken
    next to an integer or a half."""
    return torch.log2(x.to(torch.float64)).to(torch.float32)


def sign(x: torch.Tensor) -> torch.Tensor:
    """-1, 0 or +1 like ``torch.sign``, but -0.0 for -0.0 (as ``jnp.sign``),
    so ``sign(x) * q`` keeps the reference's signed zeros."""
    return torch.where(x == 0, x, torch.sign(x))


def round_to_grid(x: torch.Tensor, spec: FloatSpec,
                  saturate: bool = True) -> torch.Tensor:
    """RTNE-round ``x`` onto the magnitude grid of ``spec`` (sign kept),
    saturating to +-max_value."""
    x = x.to(torch.float32)
    ax = x.abs()
    e = floor_log2(ax.clamp_min(2.0 ** spec.emin))
    e = e.clamp(spec.emin, spec.emax)
    step = exp2int(e - spec.man_bits)
    q = torch.round(ax / step) * step
    if saturate:
        q = q.clamp_max(spec.max_value)
    return sign(x) * q


def _bits(v: torch.Tensor):
    b = v.to(torch.float32).view(torch.int32)
    return ((b >> 23) & 0xFF) - 127, b


def fp4_code_to_value(c: torch.Tensor) -> torch.Tensor:
    """E2M1 magnitude code (0..7) -> grid value (f32)."""
    c = c.to(torch.int32)
    normal = exp2int((c >> 1) - 1) * (1.0 + 0.5 * (c & 1).to(torch.float32))
    return torch.where(c == 0, 0.0, torch.where(c == 1, 0.5, normal))


def fp4_value_to_code(v: torch.Tensor) -> torch.Tensor:
    """On-grid E2M1 magnitude (>= 0) -> 3-bit code."""
    e, b = _bits(v)
    code = ((e + 1) << 1) | ((b >> 22) & 1)
    zero = torch.zeros_like(code)
    return torch.where(v == 0.0, zero, torch.where(v < 1.0, zero + 1, code))


def fp6_code_to_value(c: torch.Tensor) -> torch.Tensor:
    """E2M3 magnitude code (0..31) -> grid value (f32)."""
    c = c.to(torch.int32)
    e = c >> 3
    m = (c & 7).to(torch.float32)
    normal = exp2int(e - 1) * (1.0 + m / 8.0)
    return torch.where(e == 0, m / 8.0, normal)


def fp6_value_to_code(v: torch.Tensor) -> torch.Tensor:
    """On-grid E2M3 magnitude (>= 0) -> 5-bit code."""
    e, b = _bits(v)
    code = ((e + 1) << 3) | ((b >> 20) & 7)
    sub = (v.to(torch.float32) * 8.0).to(torch.int32)
    return torch.where(v < 1.0, sub, code)


def sign_mag_code(values: torch.Tensor, negative: torch.Tensor):
    """FP4 grid values + sign mask -> 4-bit sign-magnitude codes (bit 3 =
    sign, so a negative value that rounds to zero keeps its sign)."""
    mag = fp4_value_to_code(values.abs())
    return torch.where(negative, mag | 8, mag)


def signed_fp4(codes: torch.Tensor) -> torch.Tensor:
    """4-bit sign-magnitude codes -> f32 values (code 8 gives -0.0)."""
    return fp4_code_to_value(codes & 7) * torch.where(
        (codes & 8) != 0, -1.0, 1.0)
