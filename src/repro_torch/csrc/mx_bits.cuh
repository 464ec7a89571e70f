// FP4/FP6 code <-> value bit arithmetic of the port's kernels: the CUDA
// counterparts of repro_torch/kernels/bitmath.py (port of the reference's
// src/repro/kernels/bitmath.py). Conventions:
//
//   FP4 sign-magnitude: bit3 = sign, bits2..0 = E2M1 magnitude code
//   E2M1 code c: c==0 -> 0, c==1 -> 0.5, else 2^((c>>1)-1) * (1 + (c&1)/2)
//   E2M3 code c: e=c>>3, m=c&7: e==0 -> m/8, else 2^(e-1) * (1 + m/8)
//
// Rounding is round-half-to-even, as jnp.round and torch.round: rintf, never
// roundf (half away from zero). The kernels are built without --use_fast_math,
// so x / s is IEEE division and subnormals are kept.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mx {

constexpr int kGroup = 32;     // quantization group along K (one E8M0 scale)
constexpr int kSubgroup = 8;   // subgroup of one 2-bit meta field

// 2^e for integer e, clamped to the normal f32 range [-126, 127] (exact).
__device__ __forceinline__ float exp2i(int e) {
  e = max(-126, min(127, e));
  return __int_as_float((e + 127) << 23);
}

// floor(log2(x)) for finite x > 0, subnormals included (as torch.frexp).
__device__ __forceinline__ int floor_log2(float x) { return ilogbf(x); }

// E2M1 magnitude code (0..7) -> {0, .5, 1, 1.5, 2, 3, 4, 6}.
__device__ __forceinline__ float fp4_mag(int c) {
  const float normal = exp2i((c >> 1) - 1) * (1.0f + 0.5f * (float)(c & 1));
  return c == 0 ? 0.0f : (c == 1 ? 0.5f : normal);
}

// E2M3 magnitude code (0..31) -> grid value (max 7.5).
__device__ __forceinline__ float fp6_mag(int c) {
  const int e = c >> 3;
  const float m = (float)(c & 7);
  return e == 0 ? m / 8.0f : exp2i(e - 1) * (1.0f + m / 8.0f);
}

// On-grid E2M1 magnitude (>= 0) -> 3-bit code, from the f32 bit fields.
__device__ __forceinline__ int fp4_code(float v) {
  const int b = __float_as_int(v);
  const int code = ((((b >> 23) & 0xFF) - 126) << 1) | ((b >> 22) & 1);
  return v == 0.0f ? 0 : (v < 1.0f ? 1 : code);
}

// On-grid E2M3 magnitude (>= 0) -> 5-bit code, from the f32 bit fields.
__device__ __forceinline__ int fp6_code(float v) {
  const int b = __float_as_int(v);
  const int code = ((((b >> 23) & 0xFF) - 126) << 3) | ((b >> 20) & 7);
  return v < 1.0f ? (int)(v * 8.0f) : code;
}

// RTNE of |x| onto a mini-float magnitude grid with exponents [0, 2] and
// man_bits mantissa bits, saturating at maxval.
template <int kManBits>
__device__ __forceinline__ float rtne_mag(float ax, float maxval) {
  const int e = min(2, max(0, floor_log2(fmaxf(ax, 1.0f))));
  const float step = exp2i(e - kManBits);
  return fminf(rintf(ax / step) * step, maxval);
}

// RTNE magnitude onto the E2M1 grid (saturating at 6).
__device__ __forceinline__ float rtne_fp4(float ax) { return rtne_mag<1>(ax, 6.0f); }

// RTNE magnitude onto the E2M3 grid (saturating at 7.5).
__device__ __forceinline__ float rtne_fp6(float ax) { return rtne_mag<3>(ax, 7.5f); }

}  // namespace mx
