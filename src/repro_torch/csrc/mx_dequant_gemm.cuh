// Shared body of the packed-weight GEMMs on Hopper's tensor cores: the two
// serve dequant-GEMMs (m2xfp_matmul.cu, mxfp4_matmul.cu) and the fully packed
// W4A4 GEMM (m2xfp_qmatmul.cu), which differ only in the source of x.
//
//   out[m, n] = sum_k bf16(x[m, k]) * Wdec[k, n]      (f32 accumulation)
//
// Wdec is the exact decoded weight: fp4 * (1 + meta/4) * 2^(scale - 127) for
// the Sg-EM (m2xfp) streams, fp4 * 2^(scale - 127) for MXFP4, with the scale
// exponent clamped to [-126, 127] as mx_bits.cuh's exp2i does. Every decoded
// value has at most 4 significant bits and f32's exponent range, so it is
// exact in bf16, and each bf16 x bf16 product the tensor cores form is the
// product an f32 FMA would form.
//
// Streams (the reference's wire format, K-major, N contiguous; no repack):
//   codes  u8 (K/2, N): byte row g*16 + r holds the sign-magnitude FP4 code of
//                       K row g*32 + r (low nibble) and g*32 + 16 + r (high)
//   scales u8 (K/32, N): biased E8M0 exponent per group of 32 along K
//   meta   u8 (K/32, N): four 2-bit subgroup multiplier codes, subgroup j at
//                        bits 2j..2j+1 (Sg-EM only)
//
// Design. The product runs transposed, out^T = W^T x^T, as mma.sync m16n8k16
// bf16 -> f32: the decoded weight is the 16-row A operand (16 output columns x
// 16 K rows) and x the 8-wide B operand, so M = 8 fills the n8 side without
// padding and one decoded weight fragment serves every 8-row slice of x. A
// block of 4 warps owns 128 output columns (two 16-column fragments per warp),
// up to 64 rows of x (8 accumulator tiles per fragment) and one contiguous
// range of K groups (its split). Thread (gid, t) of a warp holds A rows gid
// and gid + 8, which are the neighbouring output columns 2 gid and 2 gid + 1
// of a fragment, so one 16-bit shared-memory load gives both columns' code
// bytes. The wire interleave fits k16: a group's 16 byte rows feed its two
// k16 steps, low nibbles (K rows g*32 + 0..15, subgroups 0 and 1) then high
// nibbles (g*32 + 16..31, subgroups 2 and 3). The decode is bit arithmetic in
// registers, without a branch: a nibble's magnitude bits go to bits 6..8 of a
// bf16 and its sign to bit 15, which reads as the FP4 value times 2^-126 (code
// 1 lands on the bf16 subnormal 2^-127); two exact bf16x2 multiplies, by 2^126
// and by the subgroup scale (1 + meta/4) * 2^(scale - 127), whose bf16 bits
// are built from the scale byte and the 2-bit field, give the weight. x comes
// in by ldmatrix.x4, one per group and 8-row tile.
//   Loads: every stream row of a stage (4 groups: 64 code rows, 4 scale and 4
// meta rows of the block's 128 columns, and the x rows of those 128 K values)
// moves by 16-byte cp.async, neighbouring threads on neighbouring addresses,
// into a ring of 4 shared-memory stages, 3 in flight while one is consumed
// (about 27 KB of weight bytes per block; 2 or more blocks per SM at the
// projection shapes). Code rows are padded by 16 bytes and x rows by 16 bytes, so the
// fragment loads are free of bank conflicts. A stream whose N is not a
// multiple of 16, or whose pointer is not 16-byte aligned, is copied through
// registers instead, and the ragged column edge is zero-filled either way.
//   Split-K: the K groups are cut into S <= 8 contiguous ranges, S chosen in
// Python from (K, N) alone (kernels/_build.py::split_k): the three projection
// shapes of paper-llama2-7b give 256-344 blocks on 132 SMs at any M. The S
// blocks of a column tile form one thread-block cluster. Each writes its f32
// partial tile into its own shared memory; after a cluster barrier, block s
// sums slice s of the tile over the S partials, read through distributed
// shared memory in split order, and writes it out. No workspace, no second
// kernel, no atomics.
//   Order of summation: out[m, n] is the f32 chain of its split's k16 steps in
// K order (one mma each), then the splits added in order. It depends on K, N
// and S only, never on M, the row tile or which block finishes first, so a
// row's result is the same bits in every launch that contains it.
//   Subnormals: a decoded weight below 2^-126 (scale byte <= 3 with a small
// code) is a bf16 subnormal, which the decode keeps exactly (the bf16
// multiplies keep subnormals). chip_smoke.py's bitmath phase passes such
// weights through the kernel one product at a time; sums that mix them with
// larger terms are outside the tested domain (ROADMAP C).
//   Packed x (XSrc::kElemEm, the W4A4 GEMM): x arrives as Elem-EM streams in
// the same wire format with M in place of N (codes (K/2, M), scales and meta
// (K/32, M)). Each stage's x byte rows (64 code rows, 4 scale and 4 meta rows
// of the block's <= 64 columns of M) ride in the ring beside W's, by cp.async
// of 16 or 8 bytes where M and the pointers allow, else through registers.
// After the stage's wait the block runs the Top-1 Decode Unit, one (row,
// subgroup of 8) per thread and step: the first element holding the largest
// FP4 magnitude code cmax takes fp6(max((cmax << 2) | meta, 1) - 1), every
// other its FP4 value, all times 2^(scale - 127). A decoded value has at most
// 4 significant bits and f32's exponent range, so it is exact in bf16; it is
// written into one bf16 x buffer in the layout ldmatrix reads, and the mma
// loop runs unchanged. So out[m, n] is the serve GEMM's sum on the decoded x,
// bit for bit, at every shape.
//   What bounds it at M = 8 (a block timeline on the card, PERF.md): the
// first stage's data arrives after about 3 us, when the whole card has asked
// for most of the weight at once; then the decode's issue rate (about 70
// instructions per warp per group and fragment, two warps per scheduler),
// not the bytes, sets the pace; the cluster's wait for its slowest split
// ends it. Left for later: wgmma on warpgroup tiles, TMA with mbarriers, a
// producer warp, persistent blocks.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mx_bits.cuh"

namespace mx {
// Internal linkage: each library that includes this header keeps its own
// kernels and its own once-only attribute call.
namespace {

constexpr int kColFrags = 2;                       // 16-column A fragments per warp
constexpr int kWarps = 4;
constexpr int kWarpN = 16 * kColFrags;             // output columns per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockN = kWarps * kWarpN;           // output columns per block
constexpr int kTileM = 64;                         // rows of x per block
constexpr int kStageGroups = 4;                    // K groups per stage
constexpr int kStages = 4;                         // shared-memory ring
constexpr int kCodePitch = kBlockN + 16;           // bytes per staged code row
constexpr int kXPitch = kStageGroups * kGroup + 8; // bf16 per staged x row
constexpr int kCodeBytes = kStageGroups * 16 * kCodePitch;
constexpr int kRowBytes = kStageGroups * kBlockN;  // staged scale (or meta) rows
constexpr int kFixedBytes = kCodeBytes + 2 * kRowBytes;
constexpr int kXRowPitch = kTileM;                 // bytes per staged packed-x row
constexpr int kXCodeBytes = kStageGroups * 16 * kXRowPitch;
constexpr int kXBytes = kXCodeBytes + 2 * kStageGroups * kXRowPitch;
constexpr uint32_t kTwo126 = 0x7E807E80u;          // bf16x2 (2^126, 2^126)
constexpr uint32_t kNegZero = 0x80008000u;         // bf16x2 (-0, -0)

static_assert(kStages * kXPitch * 2 >= kBlockN * 4,
              "the ring must hold a block's f32 partial tile");
static_assert(kStages * (kFixedBytes + kXBytes) >= kTileM * kBlockN * 4,
              "the packed-x ring must hold a block's f32 partial tile");

// Source of the x operand: bf16 rows (M, K), or Elem-EM streams (K-major).
enum class XSrc { kDense, kElemEm };

#ifdef MX_GEMM_TIMELINE
// Per-block clock readings for kernels/gemm_timeline.py (ncu and nsys do not
// run on the card's machine): 8 words per block, see that module.
__device__ unsigned long long g_timeline[8 << 13];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define MX_TL(...) __VA_ARGS__
#else
#define MX_TL(...)
#endif

struct Args {
  const __nv_bfloat16* x;  // (M, K), XSrc::kDense
  const uint8_t* codes;
  const uint8_t* scales;
  const uint8_t* meta;
  float* out;              // (M, N)
  int M, K, N, S;
  int rows_x;              // staged x rows: min(64, M rounded up to 8)
  bool aligned;            // N % 16 == 0 and every pointer 16-byte aligned
  // XSrc::kElemEm (after the dense fields, which keep their offsets)
  const uint8_t* xcodes;   // (K/2, M)
  const uint8_t* xscales;  // (K/32, M)
  const uint8_t* xmeta;    // (K/32, M)
  int xvec;                // bytes per cp.async of its rows (16 or 8), or 0:
                           // copied through registers
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a * b on bf16x2, exact here (the operands carry few significant bits).
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(kNegZero));
  return d;
}

// The sign-magnitude FP4 codes at bits 0..3 and 16..19 of q -> bf16x2 of
// their values times 2^-126 (magnitude bits to 6..8, sign to 15).
__device__ __forceinline__ uint32_t fp4x2_raw(uint32_t q) {
  return ((q << 6) & 0x01C001C0u) | ((q << 12) & 0x80008000u);
}

// Weight fragment of one FP4 pair: its raw bf16x2 times 2^126, times the
// subgroup scale; both multiplies are exact.
__device__ __forceinline__ uint32_t decode_pair(uint32_t q, uint32_t sub) {
  return mul_bf16x2(mul_bf16x2(fp4x2_raw(q), kTwo126), sub);
}

// The A fragments of one group's two k16 steps for the column pair (c, c+1):
// w0/w1 hold the code bytes of rows (2t, 2t+1) / (2t+8, 2t+9), sc and mt the
// two columns' scale and meta bytes. The subgroup scale of column c and
// subgroup j is the bf16 (1 + field_j/4) * 2^(clamp(s, 1, 254) - 127):
// exponent field clamp(s, 1, 254), mantissa field field_j << 5, built for
// both columns at once in the two halves of a word, then spread to both
// halves of one word per column. No branch, so the groups of a stage
// interleave.
template <bool kMeta>
__device__ __forceinline__ void decode_group(uint32_t w0, uint32_t w1, uint32_t sc, uint32_t mt,
                                             uint32_t (&a)[2][4]) {
  uint32_t e = __byte_perm(sc, 0, 0x4140);  // halves (s_c, s_c+1)
  e = __vminu2(__vmaxu2(e, 0x00010001u), 0x00FE00FEu) << 7;
  const uint32_t m = kMeta ? __byte_perm(mt, 0, 0x4140) : 0u;
  uint32_t sub[2][4];  // [column c / c+1][subgroup], each in both halves
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t both = kMeta ? e | (((m >> (2 * j)) & 0x00030003u) << 5) : e;
    sub[0][j] = __byte_perm(both, 0, 0x1010);
    sub[1][j] = __byte_perm(both, 0, 0x3232);
  }
  // {(col c, k 2t..), (c+1, 2t..), (c, 2t+8..), (c+1, 2t+8..)}, low nibbles
  // (subgroups 0, 1) then high nibbles (subgroups 2, 3)
  a[0][0] = decode_pair(w0, sub[0][0]);
  a[0][1] = decode_pair(w0 >> 8, sub[1][0]);
  a[0][2] = decode_pair(w1, sub[0][1]);
  a[0][3] = decode_pair(w1 >> 8, sub[1][1]);
  a[1][0] = decode_pair(w0 >> 4, sub[0][2]);
  a[1][1] = decode_pair(w0 >> 12, sub[1][2]);
  a[1][2] = decode_pair(w1 >> 4, sub[0][3]);
  a[1][3] = decode_pair(w1 >> 12, sub[1][3]);
}

__device__ __forceinline__ uint32_t lds_u16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// 16 bytes from src to shared dst, of which the first `avail` exist (the
// rest are zero-filled); `base` is a valid address to name when none does.
__device__ __forceinline__ void copy16(uint8_t* dst, const uint8_t* src, const void* base,
                                       int avail, bool aligned) {
  avail = max(0, min(16, avail));
  if (aligned) {
    cp_async16(dst, avail > 0 ? (const void*)src : base, avail);
  } else {
#pragma unroll
    for (int b = 0; b < 16; ++b) dst[b] = b < avail ? src[b] : 0;
  }
}

// Bytes c.. of one packed-x row into shared dst: a cp.async of `vec` (16 or
// 8) bytes, or 8 bytes through registers (vec 0); of them the first `avail`
// exist, the rest are zero-filled.
__device__ __forceinline__ void copy_x(uint8_t* dst, const uint8_t* src, const void* base,
                                       int avail, int vec) {
  if (vec == 16) {
    avail = max(0, min(16, avail));
    cp_async16(dst, avail > 0 ? (const void*)src : base, avail);
  } else if (vec == 8) {
    avail = max(0, min(8, avail));
    cp_async8(dst, avail > 0 ? (const void*)src : base, avail);
  } else {
#pragma unroll
    for (int b = 0; b < 8; ++b) dst[b] = b < avail ? src[b] : 0;
  }
}

// Stage of ng groups from group g0: code rows, scale rows, meta rows, then x:
// bf16 rows, or packed-x code, scale and meta rows.
template <bool kMeta, XSrc kX>
__device__ __forceinline__ void load_stage(uint8_t* st, const Args& a, int g0, int ng,
                                           int n0, int m0) {
  constexpr int kChunks = kBlockN / 16;  // 16-byte chunks per stream row
  for (int i = threadIdx.x; i < ng * 16 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 16;
    copy16(st + r * kCodePitch + c, a.codes + (size_t)(g0 * 16 + r) * a.N + n0 + c,
           a.codes, a.N - n0 - c, a.aligned);
  }
  for (int i = threadIdx.x; i < ng * kChunks * (kMeta ? 2 : 1); i += kThreads) {
    const int stream = i / (ng * kChunks), j = i - stream * ng * kChunks;
    const int r = j / kChunks, c = (j % kChunks) * 16;
    const uint8_t* src = stream ? a.meta : a.scales;
    copy16(st + kCodeBytes + stream * kRowBytes + r * kBlockN + c,
           src + (size_t)(g0 + r) * a.N + n0 + c, src, a.N - n0 - c, a.aligned);
  }
  if constexpr (kX == XSrc::kDense) {
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st + kFixedBytes);
    const int chunks = ng * kGroup / 8;  // 16-byte chunks per x row
    for (int i = threadIdx.x; i < a.rows_x * chunks; i += kThreads) {
      const int r = i / chunks, c = (i - r * chunks) * 8;
      const bool in = m0 + r < a.M;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(
          a.x + (size_t)(m0 + r) * a.K + (size_t)g0 * kGroup + c);
      copy16(reinterpret_cast<uint8_t*>(xs + r * kXPitch + c), src, a.x, in ? 16 : 0,
             a.aligned);
    }
  } else {
    // code rows g0*16 .. (g0+ng)*16, then ng scale rows, then ng meta rows,
    // each the block's rows_x columns of M from m0
    uint8_t* xb = st + kFixedBytes;
    const int width = a.xvec == 16 ? 16 : 8;  // bytes per copy
    const int per_row = a.rows_x / width;
    for (int i = threadIdx.x; i < ng * 18 * per_row; i += kThreads) {
      const int r = i / per_row, c = (i - r * per_row) * width;
      const uint8_t* src;
      uint8_t* dst;
      if (r < ng * 16) {
        src = a.xcodes + (size_t)(g0 * 16 + r) * a.M;
        dst = xb + r * kXRowPitch;
      } else {
        const int stream = (r - ng * 16) / ng, j = r - ng * 16 - stream * ng;
        src = (stream ? a.xmeta : a.xscales) + (size_t)(g0 + j) * a.M;
        dst = xb + kXCodeBytes + (stream * kStageGroups + j) * kXRowPitch;
      }
      copy_x(dst + c, src + m0 + c, a.xcodes, a.M - m0 - c, a.xvec);
    }
  }
}

// The Top-1 Decode Unit on a staged stage of packed x (ng groups, rows rows
// of M): one (row, group, subgroup of 8) per thread and step, written as 8
// bf16 into xs (row pitch kXPitch, K along the row), which ldmatrix reads.
__device__ __forceinline__ void decode_x(const uint8_t* xb, __nv_bfloat16* xs, int ng,
                                         int rows) {
  for (int i = threadIdx.x; i < rows * ng * 4; i += kThreads) {
    const int m = i % rows, sg = i / rows, gg = sg >> 2, j = sg & 3;
    // subgroup j of group gg: byte rows gg*16 + (j & 1)*8 + e, low nibble for j < 2
    const uint8_t* cr = xb + (gg * 16 + (j & 1) * 8) * kXRowPitch + m;
    const int shift = (j >> 1) * 4;
    int c[kSubgroup];
#pragma unroll
    for (int e = 0; e < kSubgroup; ++e) c[e] = (cr[e * kXRowPitch] >> shift) & 0xF;
    int cmax = c[0] & 7, first = 0;
#pragma unroll
    for (int e = 1; e < kSubgroup; ++e)
      if ((c[e] & 7) > cmax) {
        cmax = c[e] & 7;
        first = e;
      }
    const int field = (xb[kXCodeBytes + (kStageGroups + gg) * kXRowPitch + m] >> (2 * j)) & 3;
    const float v6 = fp6_mag(max((cmax << 2) | field, 1) - 1);
    const float s = exp2i((int)xb[kXCodeBytes + gg * kXRowPitch + m] - 127);
    uint32_t out[kSubgroup / 2];
#pragma unroll
    for (int e = 0; e < kSubgroup; e += 2) {
      float v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ce = c[e + h];
        const float mag = (e + h == first ? v6 : fp4_mag(ce & 7)) * s;
        v[h] = (ce & 8) ? -mag : mag;
      }
      const __nv_bfloat162 p = __floats2bfloat162_rn(v[0], v[1]);  // exact
      out[e / 2] = *reinterpret_cast<const uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(xs + m * kXPitch + gg * kGroup + j * kSubgroup) =
        make_uint4(out[0], out[1], out[2], out[3]);
  }
}

// The mma steps of the ng groups of a staged stage into acc (mtiles tiles of 8
// rows); kFull: ng == kStageGroups, so the groups' decodes may interleave. x
// is the stage's bf16 rows (dense x) or the decoded buffer xdec (packed x).
template <bool kMeta, XSrc kX, bool kFull>
__device__ __forceinline__ void compute_stage(const uint8_t* st, const __nv_bfloat16* xdec,
                                              int ng, int mtiles,
                                              float (&acc)[kColFrags][kTileM / 8][4]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, t = lane & 3;
  const int c0 = (threadIdx.x >> 5) * kWarpN + 2 * gid;  // column pair of fragment 0
  const __nv_bfloat16* xs =
      kX == XSrc::kDense ? reinterpret_cast<const __nv_bfloat16*>(st + kFixedBytes) : xdec;
#pragma unroll
  for (int gg = 0; gg < kStageGroups; ++gg) {
    if (!kFull && gg >= ng) break;
    uint32_t a[kColFrags][2][4];
#pragma unroll
    for (int f = 0; f < kColFrags; ++f) {
      const int c = c0 + 16 * f;
      const uint8_t* cr = st + gg * 16 * kCodePitch + c;
      // bytes (row 2t, col c), (2t, c+1), (2t+1, c), (2t+1, c+1); then rows 2t+8, 2t+9
      const uint32_t w0 = lds_u16(cr + 2 * t * kCodePitch) |
                          (lds_u16(cr + (2 * t + 1) * kCodePitch) << 16);
      const uint32_t w1 = lds_u16(cr + (2 * t + 8) * kCodePitch) |
                          (lds_u16(cr + (2 * t + 9) * kCodePitch) << 16);
      const uint32_t sc = lds_u16(st + kCodeBytes + gg * kBlockN + c);
      const uint32_t mt =
          kMeta ? lds_u16(st + kCodeBytes + kRowBytes + gg * kBlockN + c) : 0u;
      decode_group<kMeta>(w0, w1, sc, mt, a[f]);
    }
#pragma unroll
    for (int i = 0; i < kTileM / 8; ++i) {
      if (i >= mtiles) break;
      uint32_t b[4];  // k 0-7, 8-15 (step 0), 16-23, 24-31 (step 1) of row gid
      ldmatrix_x4(b, xs + (i * 8 + (lane & 7)) * kXPitch + gg * kGroup + (lane >> 3) * 8);
#pragma unroll
      for (int f = 0; f < kColFrags; ++f) {
        mma_bf16(acc[f][i], a[f][0], b[0], b[1]);
        mma_bf16(acc[f][i], a[f][1], b[2], b[3]);
      }
    }
  }
}

// Bytes of one ring stage: W's rows, then x's bf16 rows or packed-x rows.
template <XSrc kX>
__host__ __device__ __forceinline__ int stage_bytes(int rows_x) {
  return kFixedBytes + (kX == XSrc::kDense ? rows_x * kXPitch * 2 : kXBytes);
}

// Grid (ceil(N/kBlockN), S, ceil(M/64)): column tile, split, row tile;
// clusters of (1, S, 1). Shared memory: the ring of kStages stages, then,
// for packed x, the one decoded bf16 x buffer.
template <bool kMeta, XSrc kX>
__global__ void __launch_bounds__(kThreads) dequant_gemm(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int n0 = blockIdx.x * kBlockN, s = blockIdx.y, m0 = blockIdx.z * kTileM;
  const int groups = a.K / kGroup;
  const int g_lo = (int)((long long)s * groups / a.S);
  const int g_hi = (int)((long long)(s + 1) * groups / a.S);
  const int nst = (g_hi - g_lo + kStageGroups - 1) / kStageGroups;
  const int mtiles = (min(kTileM, a.M - m0) + 7) / 8;
  const int st_bytes = stage_bytes<kX>(a.rows_x);
  __nv_bfloat16* const xdec = reinterpret_cast<__nv_bfloat16*>(smem + kStages * st_bytes);
  MX_TL(const unsigned long long t_start = global_ns(); const long long c_start = clock64();
        long long c_data = 0, c_wait = 0, c_compute = 0, c_mark = 0;)

  float acc[kColFrags][kTileM / 8][4];
#pragma unroll
  for (int f = 0; f < kColFrags; ++f)
#pragma unroll
    for (int i = 0; i < kTileM / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[f][i][j] = 0.0f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nst) {
      const int g0 = g_lo + i * kStageGroups;
      load_stage<kMeta, kX>(smem + i * st_bytes, a, g0, min(kStageGroups, g_hi - g0), n0,
                            m0);
    }
    cp_async_commit();
  }
  for (int it = 0; it < nst; ++it) {
    MX_TL(c_mark = clock64();)
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` has landed; stage `it - 1` is consumed
    const int nx = it + kStages - 1;
    if (nx < nst) {
      const int g0 = g_lo + nx * kStageGroups;
      load_stage<kMeta, kX>(smem + (nx % kStages) * st_bytes, a, g0,
                            min(kStageGroups, g_hi - g0), n0, m0);
    }
    cp_async_commit();
    MX_TL(if (it == 0) c_data = clock64() - c_start; c_wait += clock64() - c_mark;
          c_mark = clock64();)
    const uint8_t* st = smem + (it % kStages) * st_bytes;
    const int ng = min(kStageGroups, g_hi - (g_lo + it * kStageGroups));
    if constexpr (kX == XSrc::kElemEm) {
      decode_x(st + kFixedBytes, xdec, ng, mtiles * 8);
      __syncthreads();  // the stage's x is decoded (it is consumed before the next)
    }
    if (ng == kStageGroups)
      compute_stage<kMeta, kX, true>(st, xdec, ng, mtiles, acc);
    else
      compute_stage<kMeta, kX, false>(st, xdec, ng, mtiles, acc);
    MX_TL(c_compute += clock64() - c_mark;)
  }

  // The block's f32 partial, rows_x x kBlockN, goes into its own ring (every
  // copy has landed and been consumed); acc[f][i] holds {(col c, row 2t),
  // (c, 2t+1), (c+1, 2t), (c+1, 2t+1)} of tile i.
  MX_TL(const long long c_loop = clock64();)
  cp_async_wait<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x & 31;
  const int c = (threadIdx.x >> 5) * kWarpN + 2 * (lane >> 2);
#pragma unroll
  for (int f = 0; f < kColFrags; ++f)
#pragma unroll
    for (int i = 0; i < kTileM / 8; ++i) {
      if (i >= mtiles) break;
      const int m = i * 8 + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        part[(m + (j & 1)) * kBlockN + c + 16 * f + (j >> 1)] = acc[f][i][j];
    }
  // The S blocks of a cluster are the S splits of one output tile. After the
  // barrier, block s sums slice s of the tile over the splits' partials, read
  // through distributed shared memory in split order, and writes it out; the
  // second barrier keeps every partial alive until all slices are read.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int count = mtiles * 8 * kBlockN;
  const int lo = (int)((long long)s * count / a.S), hi = (int)((long long)(s + 1) * count / a.S);
  for (int e = lo + threadIdx.x; e < hi; e += kThreads) {
    float p[8];  // all remote loads first, then the sum in split order
#pragma unroll
    for (int r = 0; r < 8; ++r) p[r] = r < a.S ? cluster.map_shared_rank(part, r)[e] : 0.0f;
    float v = p[0];
#pragma unroll
    for (int r = 1; r < 8; ++r)
      if (r < a.S) v += p[r];
    const int mm = m0 + e / kBlockN, nn = n0 + e % kBlockN;
    if (mm < a.M && nn < a.N) a.out[(size_t)mm * a.N + nn] = v;
  }
  cluster.sync();
  MX_TL(if (threadIdx.x == 0) {
    const int blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    if (blk < (1 << 13)) {
      unsigned long long* o = g_timeline + 8 * blk;
      o[0] = t_start; o[1] = global_ns(); o[2] = c_data; o[3] = c_wait;
      o[4] = c_compute; o[5] = clock64() - c_loop; o[6] = nst; o[7] = clock64() - c_start;
    }
  })
}

// Dynamic shared memory of a block staging rows_x rows of x.
template <XSrc kX>
inline int smem_bytes(int rows_x) {
  return kStages * stage_bytes<kX>(rows_x) + (kX == XSrc::kDense ? 0 : rows_x * kXPitch * 2);
}

// One launch of ceil(N/kBlockN) x S x ceil(M/64) blocks in clusters of
// (1, S, 1) on the operands of `a` (its pointers, M, K, N, S and, for packed
// x, xvec set; the rest is filled here).
template <bool kMeta, XSrc kX>
inline int launch_args(Args a, void* stream) {
  const int M = a.M, K = a.K, N = a.N, S = a.S;
  if (S < 1 || S > 8 || S > K / kGroup) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      dequant_gemm<kMeta, kX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<kX>(kTileM));
  if (attr != cudaSuccess) return (int)attr;
  const uintptr_t ptrs = (uintptr_t)a.x | (uintptr_t)a.codes | (uintptr_t)a.scales |
                         (kMeta ? (uintptr_t)a.meta : 0);
  a.rows_x = M < kTileM ? (M + 7) / 8 * 8 : kTileM;
  a.aligned = N % 16 == 0 && ptrs % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kBlockN - 1) / kBlockN, S, (M + kTileM - 1) / kTileM);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<kX>(a.rows_x);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = S;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, dequant_gemm<kMeta, kX>, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// out (M, N) = x (M, K) bf16 @ W, its K groups cut into S <= 8 splits.
template <bool kMeta>
inline int launch(const void* x, const void* codes, const void* scales, const void* meta,
                  void* out, int M, int K, int N, int S, void* stream) {
  Args a = {};
  a.x = (const __nv_bfloat16*)x;
  a.codes = (const uint8_t*)codes;
  a.scales = (const uint8_t*)scales;
  a.meta = (const uint8_t*)meta;
  a.out = (float*)out;
  a.M = M;
  a.K = K;
  a.N = N;
  a.S = S;
  return launch_args<kMeta, XSrc::kDense>(a, stream);
}

}  // namespace
}  // namespace mx

#ifdef MX_GEMM_TIMELINE
extern "C" int dequant_gemm_timeline(void* host, int words) {
  return (int)cudaMemcpyFromSymbol(host, mx::g_timeline, (size_t)words * 8);
}
#endif
