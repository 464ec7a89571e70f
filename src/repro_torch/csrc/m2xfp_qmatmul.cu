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
// It is the serve dequant-GEMM of m2xfp_matmul.cu with a second source for its
// x operand (mx_dequant_gemm.cuh, XSrc::kElemEm): the X byte rows of a stage
// ride in the cp.async ring beside W's, the block decodes them through the
// Top-1 Decode Unit into bf16 (exact: at most 4 significant bits), and the
// tensor-core loop, the split-K plan and the cluster reduction are the serve
// GEMM's. So m2xfp_qmatmul(X, W) equals m2xfp_matmul(bf16(decode(X)), W) bit
// for bit at every shape, and a row does not depend on M. The decoded
// products are exact in f32; the sum rounds once per k16 step and once per
// split, so the result equals the plain version (float64 sum) wherever those
// partial sums are exact.
//
// Bound on an H100: it reads M*K*(1/2 + 2/32) + K*N*(1/2 + 2/32) bytes, writes
// M*N*4, and does 2*M*K*N operations (bound by bytes at M = 8, by operations
// at M = 2048 against the int8 peak). Left for later: int8 mma or wgmma with a
// per-group rescale for M >= 64, where the W decode repeats for every 64-row
// tile; TMA, a producer warp, persistent blocks; X decoded straight into B
// fragments by warp shuffles.
#include "mx_dequant_gemm.cuh"

extern "C" int m2xfp_qmatmul(const void* x_codes, const void* x_scales, const void* x_meta,
                             const void* w_codes, const void* w_scales, const void* w_meta,
                             void* out, int M, int K, int N, int S, void* stream) {
  mx::Args a = {};
  a.xcodes = (const uint8_t*)x_codes;
  a.xscales = (const uint8_t*)x_scales;
  a.xmeta = (const uint8_t*)x_meta;
  a.codes = (const uint8_t*)w_codes;
  a.scales = (const uint8_t*)w_scales;
  a.meta = (const uint8_t*)w_meta;
  a.out = (float*)out;
  a.M = M;
  a.K = K;
  a.N = N;
  a.S = S;
  // X rows are M bytes long: 16-byte copies where M and the pointers allow,
  // else 8-byte ones, else through registers
  const uintptr_t ptrs = (uintptr_t)x_codes | (uintptr_t)x_scales | (uintptr_t)x_meta;
  a.xvec = M % 16 == 0 && ptrs % 16 == 0 ? 16 : (M % 8 == 0 && ptrs % 8 == 0 ? 8 : 0);
  return mx::launch_args<true, mx::XSrc::kElemEm>(a, stream);
}

extern "C" const char* m2xfp_qmatmul_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
