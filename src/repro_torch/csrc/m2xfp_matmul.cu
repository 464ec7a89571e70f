// m2xfp_matmul: x (M, K) bf16 @ Sg-EM-packed W (K, N) -> f32 (M, N).
//
// Replaces the TPU kernel src/repro/kernels/m2xfp_matmul.py::m2xfp_matmul_kernel
// (body _mm_w_kernel, decode _decode_w_sgem): the fused M2XFP dequant-GEMM that
// every QKV/O/MLP projection of the packed serve path runs through. The TPU
// kernel decodes a (bk, bn) weight tile to bf16 in VMEM and runs one bf16 x
// bf16 -> f32 dot per K block; here the tile is decoded in registers straight
// into mma.sync fragments (design in mx_dequant_gemm.cuh).
//
// Bound on an H100: at decode sizes (M = 8 slots) the GEMM moves 0.5625 bytes
// per weight (codes 0.5 + scale 1/32 + meta 1/32) and does 2*M flops per
// weight, so it is bound by memory: 9.44 MB for a 4096 x 4096 projection and
// 25.36 MB for 4096 x 11008 or 11008 x 4096, 2.9 us and 7.7 us at 3.35 TB/s,
// 0.0346 ms for the seven projections of one paper-llama2-7b layer.
//
// What held the first design (one thread per column, f32 FMAs) at about 100x
// that bound, and what this one does about it:
//   * an emptied card (64 blocks of 2 warps at M = 8, N = 4096): split-K over
//     (K, N)-chosen ranges gives 256-344 blocks of 4 warps at the three
//     shapes, the splits of a column tile summed in one thread-block cluster;
//   * one-byte loads, about 64 KB in flight on the whole card: 16-byte
//     cp.async rows into a 4-stage ring, about 27 KB of weight in flight per
//     block;
//   * f32 FMAs: mma.sync m16n8k16 on weights decoded to bf16 in registers;
//   * the weight re-read for every 8 rows: a block covers 64 rows of x.
// What bounds it now, and what is left (wgmma, TMA, a producer warp,
// persistent blocks), is in mx_dequant_gemm.cuh.
#include "mx_dequant_gemm.cuh"

extern "C" int m2xfp_matmul(const void* x, const void* codes, const void* scales,
                            const void* meta, void* out, int M, int K, int N, int S,
                            void* stream) {
  return mx::launch<true>(x, codes, scales, meta, out, M, K, N, S, stream);
}

extern "C" const char* m2xfp_matmul_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
