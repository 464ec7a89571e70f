"""FP4/FP6 code <-> value bit arithmetic (port of repro.kernels.bitmath).

The reference keeps a second, table-free copy of the format conversions for
its Pallas kernels. The port's ``core.dtypes`` is already table-free
(exponent-field construction, shifts and selects), so the plain versions
here are those functions under the reference's kernel-side names. Their
CUDA counterparts are the ``__device__`` helpers of ``csrc/mx_bits.cuh``
(``exp2i``, ``floor_log2``, ``fp4_mag``, ``fp6_mag``, ``fp4_code``,
``fp6_code``, ``rtne_fp4``, ``rtne_fp6``). Conventions:

  FP4 sign-magnitude: bit3 = sign, bits2..0 = E2M1 magnitude code
  E2M1 code c: c==0 -> 0, c==1 -> 0.5, else 2^((c>>1)-1) * (1 + (c&1)/2)
  E2M3 code c: e=c>>3, m=c&7: e==0 -> m/8, else 2^(e-1) * (1 + m/8)
"""
from __future__ import annotations

import torch

from repro_torch.core.dtypes import (
    FP4_E2M1, FP6_E2M3, exp2int, floor_log2, fp4_code_to_value,
    fp4_value_to_code, fp6_code_to_value, fp6_value_to_code, round_to_grid,
)

__all__ = [
    "exp2i", "floor_log2_bits", "fp4_mag_from_code", "fp4_code_from_mag",
    "fp6_mag_from_code", "fp6_code_from_mag", "rtne_fp4", "rtne_fp6",
]

exp2i = exp2int
floor_log2_bits = floor_log2
fp4_mag_from_code = fp4_code_to_value
fp4_code_from_mag = fp4_value_to_code
fp6_mag_from_code = fp6_code_to_value
fp6_code_from_mag = fp6_value_to_code


def rtne_fp4(x: torch.Tensor) -> torch.Tensor:
    """RTNE to the E2M1 grid (saturating at +-6)."""
    return round_to_grid(x, FP4_E2M1)


def rtne_fp6(x: torch.Tensor) -> torch.Tensor:
    """RTNE to the E2M3 grid (saturating at +-7.5)."""
    return round_to_grid(x, FP6_E2M3)
