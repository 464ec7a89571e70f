// m2xfp_matmul: x (M, K) bf16 @ Sg-EM-packed W (K, N) -> f32 (M, N).
//
// Replaces the TPU kernel src/repro/kernels/m2xfp_matmul.py::m2xfp_matmul_kernel
// (body _mm_w_kernel, decode _decode_w_sgem): the fused M2XFP dequant-GEMM that
// every QKV/O/MLP projection of the packed serve path runs through.
//
// Bound on an H100: at decode sizes (M = 8 slots) the GEMM moves 0.5625 bytes
// per weight (codes 0.5 + scale 1/32 + meta 1/32) and does 2*M flops per
// weight, so it is bound by memory: 9.44 MB for a 4096 x 4096 projection and
// 25.36 MB for 4096 x 11008 or 11008 x 4096, about 2.9 us and 7.7 us at
// 3.35 TB/s.
//
// What the simple design (mx_dequant_gemm.cuh) leaves on the table: each warp
// load is a single 32-byte sector and a thread has only one group's loads in
// flight, so at small M the kernel is bound by load latency, not bandwidth;
// the block count is N/64 x M/8, too few to fill 132 SMs at decode; the FMAs
// run on the f32 pipes, not the tensor cores (mma.sync/wgmma); and no TMA,
// split-K or tuning is used. Those are later work.
#include "mx_dequant_gemm.cuh"

extern "C" int m2xfp_matmul(const void* x, const void* codes, const void* scales,
                            const void* meta, void* out, int M, int K, int N,
                            void* stream) {
  return mx::launch<true>(x, codes, scales, meta, out, M, K, N, stream);
}

extern "C" const char* m2xfp_matmul_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
