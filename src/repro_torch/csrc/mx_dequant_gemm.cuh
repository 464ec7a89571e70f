// Shared body of the two packed-weight GEMMs (m2xfp_matmul.cu, mxfp4_matmul.cu).
//
//   out[m, n] = sum_k bf16(x[m, k]) * Wdec[k, n]      (f32 accumulation)
//
// Wdec is the exact decoded weight: fp4 * (1 + meta/4) * 2^(scale - 127) for
// the Sg-EM (m2xfp) streams, fp4 * 2^(scale - 127) for MXFP4. Every decoded
// value has at most 4 significant bits and every bf16 activation 8, so each
// product is exact in f32 and an f32 FMA chain equals a bf16 x bf16 -> f32
// tensor-core product up to accumulation order.
//
// Streams (the reference's wire format, K-major, N contiguous):
//   codes  u8 (K/2, N): byte row g*16 + r holds the sign-magnitude FP4 code of
//                       K row g*32 + r (low nibble) and g*32 + 16 + r (high)
//   scales u8 (K/32, N): biased E8M0 exponent per group of 32 along K
//   meta   u8 (K/32, N): four 2-bit subgroup multiplier codes, subgroup j at
//                        bits 2j..2j+1 (Sg-EM only)
//
// Design (simple and right first): one thread owns one output column n and
// kRows rows, and walks K in ascending groups of 32. Per group it reads its
// column's 16 code bytes, its scale byte and its meta byte -- neighbouring
// threads read neighbouring bytes of each stream row, so every warp load is
// one 32-byte sector -- decodes the 32 weights in registers and FMAs them
// against the x tile that the block staged in shared memory. The weight is
// never written back as a dense tensor. Each output element is summed in
// natural K order whatever M is and whichever row tile it falls in, so a
// row's result does not depend on how many rows share the launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mx_bits.cuh"

namespace mx {

constexpr int kRows = 8;         // output rows per thread (row tile)
constexpr int kBlockN = 64;      // output columns (threads) per block
constexpr int kTileGroups = 8;   // groups of x staged per __syncthreads
constexpr int kTileK = kTileGroups * kGroup;

template <bool kMeta>
__global__ void __launch_bounds__(kBlockN)
dequant_gemm(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
             const uint8_t* __restrict__ scales, const uint8_t* __restrict__ meta,
             float* __restrict__ out, int M, int K, int N) {
  __shared__ float xs[kRows][kTileK];
  const int n = blockIdx.x * kBlockN + threadIdx.x;
  const int m0 = blockIdx.y * kRows;
  const bool live = n < N;
  const int groups = K / kGroup;

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;

  for (int g0 = 0; g0 < groups; g0 += kTileGroups) {
    const int tg = min(kTileGroups, groups - g0);
    const int tk = tg * kGroup;
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kRows * tk; i += kBlockN) {
      const int r = i / tk;
      const int c = i - r * tk;
      const int m = m0 + r;
      xs[r][c] = m < M ? __bfloat162float(x[(size_t)m * K + (size_t)g0 * kGroup + c])
                       : 0.0f;
    }
    __syncthreads();
    if (!live) continue;
    for (int gg = 0; gg < tg; ++gg) {
      const int g = g0 + gg;
      const float s = exp2i((int)scales[(size_t)g * N + n] - 127);
      float sub[4];  // per-subgroup scale: (1 + k/4) * 2^e, exact
      if (kMeta) {
        const int mt = meta[(size_t)g * N + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) sub[j] = sgem_sub_scale(mt, j, s);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) sub[j] = s;
      }
      float w[kGroup];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int b = codes[(size_t)(g * 16 + r) * N + n];
        w[r] = decode(b & 0xF, sub[r >> 3]);
        w[16 + r] = decode(b >> 4, sub[2 + (r >> 3)]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float* xr = &xs[r][gg * kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) acc[r] = fmaf(xr[j], w[j], acc[r]);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (m0 + r < M) out[(size_t)(m0 + r) * N + n] = acc[r];
}

template <bool kMeta>
inline int launch(const void* x, const void* codes, const void* scales, const void* meta,
                  void* out, int M, int K, int N, void* stream) {
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kRows - 1) / kRows);
  dequant_gemm<kMeta><<<grid, kBlockN, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)codes, (const uint8_t*)scales,
      (const uint8_t*)meta, (float*)out, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace mx
