// m2xfp_quantize: activations x (M, K), bf16 or f32, row-major -> Elem-EM-top1
// streams in the K-major kernel layout:
//   codes u8 (K/2, M), scales u8 (K/32, M), meta u8 (K/32, M).
//
// Replaces the TPU kernel src/repro/kernels/m2xfp_quantize.py::m2xfp_quantize_kernel
// (body _quantize_kernel): the online quantization engine of the paper
// (Sec. 5.5) that feeds m2xfp_qmatmul. Per group of 32 along K:
//   stage 1: E8M0 scale by the floor rule, e = floor(log2(max(amax, 1e-30))) - 2
//            (0 for an all-zero group), clamped to [-126, 127]; RTNE FP4 of x/2^e;
//   stage 2: per subgroup of 8 the top-1 FP4 magnitude code (the first on ties),
//            that element's RTNE FP6 code c6, and the 2-bit bias-clamp field
//            clamp(c6 + 1, cmax << 2, cmax << 2 | 3) & 3; pack.
// A negative input whose FP4 value is 0 keeps its sign bit (code 8); -0.0 does
// not. The streams are byte-identical to repro_torch.kernels.layout.pack_x_elem_em
// (the plain version), which is byte-identical to the reference's packer.
// Unlike the TPU kernel it reads x as it lies (no host-side transpose) and takes
// any M and any K % 32 == 0.
//
// Bound on an H100: it reads M*K*2 bytes (bf16) and writes M*K*(1/2 + 2/32), so
// it is bound by memory, 17.1 us for M = 2048, K = 11008 at 3.35 TB/s.
//
// Design (simple and right first): a block of 256 threads takes 32 rows x 8
// groups. It stages the 32 x 256 tile of x in shared memory with coalesced loads
// (rows padded to 257 floats, so the reads below hit 32 banks); then lane r of
// warp g encodes group g of row r in registers. The 32 lanes of a warp hold 32
// consecutive rows, so each stream row is written as 32 consecutive bytes.
// Left on the table: 2-byte loads per thread, no vector stores, one tile per
// block.
#include <cuda_bf16.h>

#include "mx_bits.cuh"

namespace {

constexpr int kRowsPerBlock = 32;                         // lanes of a warp
constexpr int kGroupsPerBlock = 8;                        // warps of a block
constexpr int kThreads = kRowsPerBlock * kGroupsPerBlock;
constexpr int kTileK = kGroupsPerBlock * mx::kGroup;
constexpr int kPitch = kTileK + 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize(const T* __restrict__ x, uint8_t* __restrict__ codes,
         uint8_t* __restrict__ scales, uint8_t* __restrict__ meta, int M, int K) {
  __shared__ float xs[kRowsPerBlock][kPitch];
  const int m0 = blockIdx.x * kRowsPerBlock;
  const int g0 = blockIdx.y * kGroupsPerBlock;
  const int groups = K / mx::kGroup;
  const int tk = min(kGroupsPerBlock, groups - g0) * mx::kGroup;
  for (int i = threadIdx.x; i < kRowsPerBlock * kTileK; i += kThreads) {
    const int r = i / kTileK;
    const int c = i - r * kTileK;
    const int m = m0 + r;
    xs[r][c] = (m < M && c < tk)
                   ? to_f32(x[(size_t)m * K + (size_t)g0 * mx::kGroup + c])
                   : 0.0f;
  }
  __syncthreads();
  const int r = threadIdx.x % kRowsPerBlock;
  const int gi = threadIdx.x / kRowsPerBlock;
  const int m = m0 + r;
  const int g = g0 + gi;
  if (m >= M || g >= groups) return;
  const float* v = &xs[r][gi * mx::kGroup];

  // Stage 1: shared scale and FP4 codes.
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < mx::kGroup; ++i) amax = fmaxf(amax, fabsf(v[i]));
  int e = amax == 0.0f ? 0 : mx::floor_log2(fmaxf(amax, 1e-30f)) - 2;
  e = max(-126, min(127, e));
  const float s = mx::exp2i(e);
  float xq[mx::kGroup];
  int c4[mx::kGroup];
#pragma unroll
  for (int i = 0; i < mx::kGroup; ++i) {
    xq[i] = v[i] / s;
    c4[i] = mx::fp4_code(mx::rtne_fp4(fabsf(xq[i])));
  }

  // Stage 2: top-1 per subgroup, FP6 refinement, bias-clamp field.
  int meta_byte = 0;
#pragma unroll
  for (int j = 0; j < mx::kGroup / mx::kSubgroup; ++j) {
    int cmax = c4[j * mx::kSubgroup];
    float top = xq[j * mx::kSubgroup];
#pragma unroll
    for (int i = 1; i < mx::kSubgroup; ++i) {
      const int c = c4[j * mx::kSubgroup + i];
      if (c > cmax) {  // strictly greater: the lowest index wins a tie
        cmax = c;
        top = xq[j * mx::kSubgroup + i];
      }
    }
    const int c6 = mx::fp6_code(mx::rtne_fp6(fabsf(top)));
    const int rmin = cmax << 2;
    meta_byte |= (min(max(c6 + 1, rmin), rmin | 3) & 3) << (2 * j);
  }

#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int lo = c4[i] | (v[i] < 0.0f ? 8 : 0);
    const int hi = c4[16 + i] | (v[16 + i] < 0.0f ? 8 : 0);
    codes[(size_t)(g * 16 + i) * M + m] = (uint8_t)(lo | (hi << 4));
  }
  scales[(size_t)g * M + m] = (uint8_t)(e + 127);
  meta[(size_t)g * M + m] = (uint8_t)meta_byte;
}

}  // namespace

extern "C" int m2xfp_quantize(const void* x, int x_is_f32, void* codes, void* scales,
                              void* meta, int M, int K, void* stream) {
  const int groups = K / mx::kGroup;
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock,
                  (groups + kGroupsPerBlock - 1) / kGroupsPerBlock);
  cudaStream_t st = (cudaStream_t)stream;
  if (x_is_f32)
    quantize<float><<<grid, kThreads, 0, st>>>((const float*)x, (uint8_t*)codes,
                                                (uint8_t*)scales, (uint8_t*)meta, M, K);
  else
    quantize<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (uint8_t*)codes, (uint8_t*)scales, (uint8_t*)meta, M, K);
  return (int)cudaGetLastError();
}

extern "C" const char* m2xfp_quantize_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
