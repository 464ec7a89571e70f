// mxfp4_matmul: x (M, K) bf16 @ MXFP4-packed W (K, N) -> f32 (M, N).
//
// Replaces the TPU kernel src/repro/kernels/mxfp4_matmul.py::mxfp4_matmul_kernel
// (body _mm_kernel): the OCP MXFP4 baseline of the paper, the same dequant-GEMM
// without the metadata stream (Wdec = fp4 * 2^(scale - 127)).
//
// Bound on an H100: at decode sizes (M = 8 slots) it moves 0.53125 bytes per
// weight (codes 0.5 + scale 1/32) and is bound by memory: 8.91 MB for a
// 4096 x 4096 projection, 23.95 MB for 4096 x 11008 or 11008 x 4096, 2.7 us
// and 7.2 us at 3.35 TB/s, 0.0327 ms for the seven projections of one
// paper-llama2-7b layer.
//
// It instantiates the tensor-core design of mx_dequant_gemm.cuh with
// m2xfp_matmul (split-K, 16-byte cp.async stages, mma.sync on weights decoded
// in registers, 64 rows of x per block); the two differ only by the meta
// stream, which is neither loaded nor decoded here (every subgroup scale is
// the group scale). What that design does about the first design's limits,
// and what it leaves, is listed in m2xfp_matmul.cu.
#include "mx_dequant_gemm.cuh"

extern "C" int mxfp4_matmul(const void* x, const void* codes, const void* scales,
                            void* out, int M, int K, int N, int S, void* stream) {
  return mx::launch<false>(x, codes, scales, nullptr, out, M, K, N, S, stream);
}

extern "C" const char* mxfp4_matmul_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
