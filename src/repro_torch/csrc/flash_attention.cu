// flash_attention: forward attention with the online softmax over KV blocks,
// on Hopper's tensor cores.
//
//   q (BH, Sq, hd), k/v (BH, Skv, hd) bf16 or f32 (rounded to bf16 here, as the
//   TPU kernel does), pos_q (BH, Sq) / pos_k (BH, Skv) int32 -> o f32 (BH, Sq, hd)
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention_kernel
// (body _flash_kernel). Key j is valid for query i when pos_k[j] >= 0,
// pos_q[i] >= pos_k[j] and pos_q[i] - pos_k[j] < window. Per KV block of block_k
// keys, each query row runs the reference recurrence:
//   s = bf16(q).bf16(k) * scale            (f32; scale = f32(hd^-0.5), from the host)
//   s = softcap * tanh(s / softcap)        (optional)
//   s = valid ? s : -2e38
//   m_new = max(m, rowmax s); p = valid ? exp(s - m_new) : 0; corr = exp(m - m_new)
//   l = l*corr + sum p;  acc = acc*corr + bf16(p).bf16(v);  m = m_new
// and o = acc / max(l, 1e-30), so a row with no valid key gives 0. The block
// size fixes where p is rounded to bf16 (against the max of the whole block), so
// the kernel and its plain version (repro_torch.kernels.ref.flash_attention_ref)
// take the same block_k. Unlike the TPU kernel it takes any Sq and Skv: tail rows
// are masked and the last block may be short.
//
// Bound on an H100: it reads q, k and v once in their type, writes o in f32, and
// does 4*hd operations per valid (query, key) pair. At BH = 32, hd = 128,
// S = 2048, causal (half the pairs valid), that is 34.4 GFLOP, bound by
// operations at 0.035 ms at the bf16 tensor-core peak (989 TFLOP/s).
//
// Design. A block of 4 warps owns 64 query rows of one head, 16 per warp; the
// grid is (BH, ceil(Sq/64), ceil(hd/128)), the last query tiles (the heaviest
// under a causal mask) first, and a head wider than 128 splits its output
// columns over grid z (each z recomputes the scores). Q is staged once in bf16
// in shared memory; K and V come through 64-key sub-tiles in bf16, double-
// buffered with 16-byte cp.async copies (f32 inputs, or bf16 rows that are not
// 16-byte aligned, are converted through registers instead). Rows are padded by
// 16 bytes, so the 8 row addresses of each ldmatrix phase hit 8 distinct 16-byte
// bank groups; hd is padded with zeros to a multiple of 16, which adds exact
// zeros to every dot. Both products are mma.sync m16n8k16 bf16 -> f32: QK^T with
// ldmatrix of Q and K, PV with the score accumulators rounded to bf16 (cvt.rn)
// as the A operand, as in FlashAttention-2, and ldmatrix.trans of V.
// The block max must precede any rounding of p, so each block_k block is walked
// twice: pass A computes the scores of each sub-tile and keeps the row max;
// pass B computes the same scores again with the same instructions, forms p,
// sums l from the unrounded f32 p, and runs PV into a separate f32 sum that is
// added to acc*corr at the block's end. This costs 1.5x the tensor-core work but
// holds no block of scores, so any block_k <= 1024 fits. A sub-tile in which no
// (query, key) pair of the block's 64 rows can be valid (by the ranges of the
// positions) is skipped in both passes, which is exact: its scores would be -2e38
// and its p 0. The softmax step keeps the reference's separate roundings
// (__fmul_rn, __fadd_rn, expf and tanhf, no fast math).
// Left for a later PR: wgmma on 64-row warpgroup tiles, TMA with mbarriers,
// warp specialisation (a producer warp for the copies), and keeping K of pass A
// for pass B where a block has few sub-tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;        // query rows per block, 16 per warp
constexpr int kThreads = 128;    // 4 warps
constexpr int kSub = 64;         // keys per K/V sub-tile
constexpr int kCols = 128;       // output columns per block (grid z for wider heads)
constexpr int kPad = 8;          // bf16 elements of padding per shared-memory row
constexpr int kMaxHd = 256;
constexpr int kMaxBlockK = 1024; // at most 16 sub-tiles per block: a 16-bit mask
constexpr float kNegInf = -2.0e38f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ bool is_valid(int pq, int pk, int window) {
  return pk >= 0 && pq >= pk && pq - pk < window;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16x2 of (lo, hi), each rounded to nearest even; lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Rows [0, n) of src (row length hd), columns [c0, c0 + width), into a kRows x
// pitch bf16 tile; rows >= n and columns >= hd are zero. width is a multiple of
// 16. kAsync: 16-byte cp.async copies (bf16, hd % 8 == 0, 16-byte aligned rows);
// otherwise loads through registers, rounding to bf16.
template <typename T, bool kAsync>
__device__ __forceinline__ void load_tile(bf16* dst, int pitch, const T* src, int n, int hd,
                                          int c0, int width) {
  if constexpr (kAsync) {
    const int chunks = width / 8;
    for (int i = threadIdx.x; i < kRows * chunks; i += kThreads) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * 8;
      const bool in = r < n && c0 + c < hd;
      cp_async16(dst + r * pitch + c, in ? src + (size_t)r * hd + c0 + c : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * width; i += kThreads) {
      const int r = i / width;
      const int c = i - r * width;
      const float x = r < n && c0 + c < hd ? to_float(src[(size_t)r * hd + c0 + c]) : 0.0f;
      dst[r * pitch + c] = __float2bfloat16_rn(x);
    }
  }
}

// Where the walk over the KV range stands: block j0, its mask of sub-tiles that
// may hold a valid pair, the pass (0: row max, 1: p and PV) and the sub-tile.
struct Cursor {
  int j0;
  unsigned mask;
  int pass;
  int st;
};

struct Params {
  const int* pk;   // pos_k of this head
  int Skv, block_k, window;
  int pq_lo, pq_hi;  // range of the block's valid query positions (pq_hi < 0: none)
};

// Bit i: sub-tile i of the block at j0 may hold a valid pair for the block's
// rows (a conservative test on the ranges of the positions; never clears a
// sub-tile that holds one). Every warp computes the same mask.
__device__ unsigned block_mask(const Params& P, int j0) {
  const int lane = threadIdx.x % 32;
  const int nb = min(P.block_k, P.Skv - j0);
  unsigned mask = 0;
  for (int st = 0; st * kSub < nb; ++st) {
    const int k0 = j0 + st * kSub;
    const int n = min(kSub, nb - st * kSub);
    int lo = INT_MAX, hi = -1;
    for (int j = lane; j < n; j += 32) {
      const int p = P.pk[k0 + j];
      if (p >= 0) {
        lo = min(lo, p);
        hi = max(hi, p);
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (hi >= 0 && lo <= P.pq_hi && P.pq_lo - hi < P.window) mask |= 1u << st;
  }
  return mask;
}

// From block c.j0 on, the first block with a sub-tile to compute (j0 >= Skv: none).
__device__ void seek(Cursor& c, const Params& P) {
  for (; c.j0 < P.Skv; c.j0 += P.block_k) {
    c.mask = block_mask(P, c.j0);
    if (c.mask) {
      c.pass = 0;
      c.st = __ffs((int)c.mask) - 1;
      return;
    }
  }
}

__device__ void advance(Cursor& c, const Params& P) {
  const unsigned rest = c.mask & ~((2u << c.st) - 1u);
  if (rest) {
    c.st = __ffs((int)rest) - 1;
  } else if (c.pass == 0) {
    c.pass = 1;
    c.st = __ffs((int)c.mask) - 1;
  } else {
    c.j0 += P.block_k;
    seek(c, P);
  }
}

// The scores of the warp's 16 rows against the 64 keys of a sub-tile, in the
// m16n8k16 accumulator layout (s[nt]: keys 8 nt + 2 (lane % 4) + {0, 1} of rows
// lane / 4 and lane / 4 + 8), scaled, soft-capped and masked. Returns the valid
// bits (nt * 4 + i). Pass A and pass B call it on the same tile and get the same
// scores bit for bit.
__device__ __forceinline__ unsigned scores(float (&s)[8][4], const bf16* qs, const bf16* kt,
                                           int pitch, int ksteps, const int* pk, int pq0,
                                           int pq1, float scale, int use_softcap,
                                           float softcap, int window) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.0f;
  // ldmatrix row addresses: Q as A (rows 0-7/8-15 x k 0-7/8-15), K as B (keys
  // 0-7/8-15 of each 16 x k 0-7/8-15).
  const bf16* qa = qs + (warp * 16 + (lane & 15)) * pitch + (lane >> 4) * 8;
  const bf16* ka = kt + ((lane >> 4) * 8 + (lane & 7)) * pitch + ((lane >> 3) & 1) * 8;
  for (int kk = 0; kk < ksteps; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, qa + kk * 16);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, ka + np * 16 * pitch + kk * 16);
      mma_bf16(s[2 * np], a, b[0], b[1]);
      mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
  unsigned valid = 0;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = __fmul_rn(s[nt][i], scale);
      if (use_softcap) x = __fmul_rn(softcap, tanhf(__fdiv_rn(x, softcap)));
      const bool ok = is_valid(i < 2 ? pq0 : pq1, pk[nt * 8 + t2 + (i & 1)], window);
      s[nt][i] = ok ? x : kNegInf;
      valid |= (unsigned)ok << (nt * 4 + i);
    }
  }
  return valid;
}

// Shared memory: Q (kRows x qp), K x 2 (kRows x qp), V x 2 (kRows x vp), key
// positions x 2 (kSub), with qp = hd16 + kPad and vp = min(kCols, hd16) + kPad.
inline size_t smem_bytes(int hd16) {
  const int qp = hd16 + kPad, vp = (hd16 < kCols ? hd16 : kCols) + kPad;
  return sizeof(bf16) * ((size_t)3 * kRows * qp + (size_t)2 * kRows * vp) +
         sizeof(int) * 2 * kSub;
}

template <typename T, bool kAsync>
__global__ void __launch_bounds__(kThreads, 2)
flash(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
      const int* __restrict__ pos_q, const int* __restrict__ pos_k, float* __restrict__ o,
      int Sq, int Skv, int hd, int block_k, float scale, int use_softcap, float softcap,
      int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd16 = (hd + 15) & ~15;
  const int qp = hd16 + kPad;
  const int c0 = blockIdx.z * kCols;          // this block's output columns
  const int vw = min(kCols, hd16 - c0);
  const int vp = min(kCols, hd16) + kPad;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kRows * qp;                   // 2 buffers
  bf16* vs = ks + 2 * kRows * qp;               // 2 buffers
  int* pks = reinterpret_cast<int*>(vs + 2 * kRows * vp);   // 2 buffers

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const T* kb = k + (size_t)bh * Skv * hd;
  const T* vb = v + (size_t)bh * Skv * hd;
  const int* pqb = pos_q + (size_t)bh * Sq;

  Params P;
  P.pk = pos_k + (size_t)bh * Skv;
  P.Skv = Skv;
  P.block_k = block_k;
  P.window = window;
  {
    int lo = INT_MAX, hi = -1;
    for (int i = lane; i < kRows; i += 32) {
      const int p = q0 + i < Sq ? pqb[q0 + i] : -1;
      if (p >= 0) {
        lo = min(lo, p);
        hi = max(hi, p);
      }
    }
    P.pq_lo = __reduce_min_sync(0xffffffffu, lo);
    P.pq_hi = __reduce_max_sync(0xffffffffu, hi);
  }
  const int r0 = q0 + warp * 16 + lane / 4;     // the thread's two rows
  const int r1 = r0 + 8;
  const int pq0 = r0 < Sq ? pqb[r0] : -1;       // a tail row sees no key
  const int pq1 = r1 < Sq ? pqb[r1] : -1;

  float acc[kCols / 8][4], pv[kCols / 8][4];
#pragma unroll
  for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = pv[nt][i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  float mx0 = kNegInf, mx1 = kNegInf, mn0 = kNegInf, mn1 = kNegInf;
  float corr0 = 1.0f, corr1 = 1.0f, ls0 = 0.0f, ls1 = 0.0f;

  // Item (cursor) -> buffer: K (and in pass B V) of its sub-tile, key positions.
  auto load_item = [&](const Cursor& c, int buf) {
    const int k0 = c.j0 + c.st * kSub;
    const int n = min(kSub, min(block_k, Skv - c.j0) - c.st * kSub);
    load_tile<T, kAsync>(ks + buf * kRows * qp, qp, kb + (size_t)k0 * hd, n, hd, 0, hd16);
    if (c.pass == 1)
      load_tile<T, kAsync>(vs + buf * kRows * vp, vp, vb + (size_t)k0 * hd, n, hd, c0, vw);
    if (threadIdx.x < kSub)
      pks[buf * kSub + threadIdx.x] = (int)threadIdx.x < n ? P.pk[k0 + threadIdx.x] : -1;
  };

  load_tile<T, kAsync>(qs, qp, q + ((size_t)bh * Sq + q0) * hd, min(kRows, Sq - q0), hd, 0,
                       hd16);
  Cursor cur;
  cur.j0 = 0;
  seek(cur, P);
  if (cur.j0 < Skv) load_item(cur, 0);
  cp_async_commit();
  int buf = 0;
  while (cur.j0 < Skv) {
    Cursor nxt = cur;
    advance(nxt, P);
    if (nxt.j0 < Skv) load_item(nxt, buf ^ 1);   // overlaps this item's products
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[8][4];
    const unsigned valid = scores(s, qs, ks + buf * kRows * qp, qp, hd16 / 16,
                                  pks + buf * kSub, pq0, pq1, scale, use_softcap, softcap,
                                  window);
    if (cur.pass == 0) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = (valid >> (nt * 4 + i)) & 1u
                              ? expf(__fsub_rn(s[nt][i], i < 2 ? mn0 : mn1))
                              : 0.0f;
          s[nt][i] = p;
          if (i < 2)
            ls0 = __fadd_rn(ls0, p);
          else
            ls1 = __fadd_rn(ls1, p);
        }
      }
      const bf16* vt = vs + buf * kRows * vp;
      const bf16* va = vt + (lane & 15) * vp + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < kCols / 16; ++np) {
          if (np * 16 < vw) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, va + kk * 16 * vp + np * 16);
            mma_bf16(pv[2 * np], a, b[0], b[1]);
            mma_bf16(pv[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
    }

    if (nxt.j0 != cur.j0 || nxt.pass != cur.pass) {   // the end of a pass of a block
      if (cur.pass == 0) {
        mn0 = fmaxf(m0, quad_max(mx0));
        mn1 = fmaxf(m1, quad_max(mx1));
        corr0 = expf(__fsub_rn(m0, mn0));
        corr1 = expf(__fsub_rn(m1, mn1));
        mx0 = mx1 = kNegInf;
      } else {
        l0 = __fadd_rn(__fmul_rn(l0, corr0), quad_sum(ls0));
        l1 = __fadd_rn(__fmul_rn(l1, corr1), quad_sum(ls1));
#pragma unroll
        for (int nt = 0; nt < kCols / 8; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[nt][i] = __fadd_rn(__fmul_rn(acc[nt][i], i < 2 ? corr0 : corr1), pv[nt][i]);
            pv[nt][i] = 0.0f;
          }
        }
        m0 = mn0;
        m1 = mn1;
        ls0 = ls1 = 0.0f;
      }
    }
    __syncthreads();   // the buffer is consumed before the next load overwrites it
    cur = nxt;
    buf ^= 1;
  }
  cp_async_wait<0>();

  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < kCols / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i < 2 ? r0 : r1;
      const int col = c0 + nt * 8 + t2 + (i & 1);
      if (row < Sq && col < hd)
        o[((size_t)bh * Sq + row) * hd + col] = __fdiv_rn(acc[nt][i], i < 2 ? den0 : den1);
    }
  }
}

template <typename T, bool kAsync>
int launch(const void* q, const void* k, const void* v, const void* pos_q, const void* pos_k,
           void* o, int BH, int Sq, int Skv, int hd, int block_k, float scale,
           int use_softcap, float softcap, int window, cudaStream_t stream) {
  const int hd16 = (hd + 15) & ~15;
  const dim3 grid(BH, (Sq + kRows - 1) / kRows, (hd16 + kCols - 1) / kCols);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(hd16);
  cudaError_t err = cudaFuncSetAttribute(flash<T, kAsync>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash<T, kAsync>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  flash<T, kAsync><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)pos_q, (const int*)pos_k, (float*)o,
      Sq, Skv, hd, block_k, scale, use_softcap, softcap, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Takes 1 <= hd <= 256 and 1 <= block_k <= 1024 (the Python wrapper checks them
// first and raises ValueError).
extern "C" int flash_attention(const void* q, const void* k, const void* v, const void* pos_q,
                               const void* pos_k, void* o, int is_f32, int BH, int Sq, int Skv,
                               int hd, int block_k, float scale, int use_softcap, float softcap,
                               int window, void* stream) {
  if (hd < 1 || hd > kMaxHd || block_k < 1 || block_k > kMaxBlockK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f32)
    return launch<float, false>(q, k, v, pos_q, pos_k, o, BH, Sq, Skv, hd, block_k, scale,
                                use_softcap, softcap, window, st);
  const bool aligned =
      hd % 8 == 0 && (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) == 0;
  return aligned ? launch<bf16, true>(q, k, v, pos_q, pos_k, o, BH, Sq, Skv, hd, block_k,
                                      scale, use_softcap, softcap, window, st)
                 : launch<bf16, false>(q, k, v, pos_q, pos_k, o, BH, Sq, Skv, hd, block_k,
                                       scale, use_softcap, softcap, window, st);
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
