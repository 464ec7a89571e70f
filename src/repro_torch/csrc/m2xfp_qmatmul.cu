// m2xfp_qmatmul: Elem-EM-packed X (K-major) @ Sg-EM-packed W (K, N) -> f32 (M, N),
// the fully packed W4A4 GEMM of the paper's augmented PE.
//
// Replaces the TPU kernel src/repro/kernels/m2xfp_matmul.py::m2xfp_qmatmul_kernel
// (body _mm_qq_kernel, activation decode _decode_x_elem_em).
//
//   X streams: codes u8 (K/2, M), scales u8 (K/32, M), meta u8 (K/32, M)
//   W streams: codes u8 (K/2, N), scales u8 (K/32, N), meta u8 (K/32, N)
//   (the wire format of mx_dequant_gemm.cuh, with M in place of N for X)
//
// X decodes through the Top-1 Decode Unit: per subgroup of 8 along K the first
// element holding the largest FP4 magnitude code cmax takes the FP6 value
// fp6(max((cmax << 2) | meta, 1) - 1) with its own sign, every other element its
// FP4 value; all times 2^(scale - 127). W decodes as in mx_dequant_gemm.cuh,
// fp4 * (1 + meta/4) * 2^(scale - 127). A decoded X value has at most 4
// significant bits and a decoded W value at most 5, so every product is exact
// in f32 and the result differs from the plain version (float64 sum) by the f32
// roundings of the sum only. Each output is one fmaf chain in natural K order,
// x first, as in the dequant-GEMM: a row does not depend on M, and on X decoded
// from quantize_act_m2xfp(x) the two kernels take the same products in the same
// order.
//
// Bound on an H100: it reads M*K*(1/2 + 2/32) + K*N*(1/2 + 2/32) bytes, writes
// M*N*4, and does 2*M*K*N operations. At M = 2048 it is bound by operations
// (0.187 ms at the bf16 tensor-core peak for 4096 x 11008); at M = 8 by bytes.
//
// Design (simple and right first): a block of 256 threads owns a 64 x 64 output
// tile and walks K one group of 32 at a time. Per group, each thread decodes one
// subgroup of 8 of one X row and one subgroup of one W column into shared
// memory (neighbouring threads read neighbouring bytes of each stream row, so
// the loads are coalesced), then computes its 4 x 4 outputs with f32 FMAs from
// shared memory. Left on the table: the tensor cores (the decoded operands are
// exact in bf16), double buffering of the decode, and, at small M, the 63 of 64
// tile rows that are masked.
#include "mx_bits.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kThreads = 256;
constexpr int kTM = 4;  // output rows per thread
constexpr int kTN = 4;  // output columns per thread

// The 8 sign-magnitude codes of subgroup j of one column of a K-major code
// stream in group g: byte rows g*16 + (j & 1)*8 + i, low nibble for j < 2.
__device__ __forceinline__ void load_subgroup(const uint8_t* __restrict__ codes, int g, int j,
                                              int col, int ld, int c[mx::kSubgroup]) {
  const int shift = (j >> 1) * 4;
  const size_t row0 = (size_t)g * 16 + (j & 1) * mx::kSubgroup;
#pragma unroll
  for (int i = 0; i < mx::kSubgroup; ++i)
    c[i] = (codes[(row0 + i) * ld + col] >> shift) & 0xF;
}

__global__ void __launch_bounds__(kThreads)
qmatmul(const uint8_t* __restrict__ xc, const uint8_t* __restrict__ xsc,
        const uint8_t* __restrict__ xm, const uint8_t* __restrict__ wc,
        const uint8_t* __restrict__ wsc, const uint8_t* __restrict__ wm,
        float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) float xs[mx::kGroup][kBM];  // decoded X, k-major
  __shared__ __align__(16) float ws[mx::kGroup][kBN];  // decoded W
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int t = threadIdx.x;
  const int dcol = t % kBM;  // decode: column of the tile
  const int dsub = t / kBM;  // decode: subgroup 0..3
  const int tx = t % (kBN / kTN);
  const int ty = t / (kBN / kTN);

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  const int groups = K / mx::kGroup;
  for (int g = 0; g < groups; ++g) {
    __syncthreads();  // the previous group is consumed
    {  // X: Top-1 Decode Unit
      const int m = m0 + dcol;
      float vals[mx::kSubgroup];
      if (m < M) {
        int c[mx::kSubgroup];
        load_subgroup(xc, g, dsub, m, M, c);
        int cmax = c[0] & 7, first = 0;
#pragma unroll
        for (int i = 1; i < mx::kSubgroup; ++i)
          if ((c[i] & 7) > cmax) {
            cmax = c[i] & 7;
            first = i;
          }
        const int field = (xm[(size_t)g * M + m] >> (2 * dsub)) & 3;
        const float v6 = mx::fp6_mag(max((cmax << 2) | field, 1) - 1);
        const float s = mx::exp2i((int)xsc[(size_t)g * M + m] - 127);
#pragma unroll
        for (int i = 0; i < mx::kSubgroup; ++i) {
          const float v = (i == first ? v6 : mx::fp4_mag(c[i] & 7)) * s;
          vals[i] = (c[i] & 8) ? -v : v;
        }
      } else {
#pragma unroll
        for (int i = 0; i < mx::kSubgroup; ++i) vals[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < mx::kSubgroup; ++i) xs[dsub * mx::kSubgroup + i][dcol] = vals[i];
    }
    {  // W: Sg-EM decode, as mx_dequant_gemm.cuh
      const int n = n0 + dcol;
      float vals[mx::kSubgroup];
      if (n < N) {
        int c[mx::kSubgroup];
        load_subgroup(wc, g, dsub, n, N, c);
        const float s = mx::exp2i((int)wsc[(size_t)g * N + n] - 127);
        const float sub = mx::sgem_sub_scale(wm[(size_t)g * N + n], dsub, s);
#pragma unroll
        for (int i = 0; i < mx::kSubgroup; ++i) vals[i] = mx::decode(c[i], sub);
      } else {
#pragma unroll
        for (int i = 0; i < mx::kSubgroup; ++i) vals[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < mx::kSubgroup; ++i) ws[dsub * mx::kSubgroup + i][dcol] = vals[i];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < mx::kGroup; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * kTM]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[k][tx * kTN]);
      const float av[kTM] = {a.x, a.y, a.z, a.w};
      const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty * kTM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx * kTN + j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int m2xfp_qmatmul(const void* x_codes, const void* x_scales, const void* x_meta,
                             const void* w_codes, const void* w_scales, const void* w_meta,
                             void* out, int M, int K, int N, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  qmatmul<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x_codes, (const uint8_t*)x_scales, (const uint8_t*)x_meta,
      (const uint8_t*)w_codes, (const uint8_t*)w_scales, (const uint8_t*)w_meta,
      (float*)out, M, K, N);
  return (int)cudaGetLastError();
}

extern "C" const char* m2xfp_qmatmul_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
