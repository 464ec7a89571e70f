// flash_attention: forward attention with the online softmax over KV blocks.
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
// size fixes where p is rounded to bf16, so the kernel and its plain version
// (repro_torch.kernels.ref.flash_attention_ref) take the same block_k. A block
// in which no (query, key) pair of the tile is valid leaves m, l and acc exactly
// as they were (corr = 1, p = 0), so it is skipped. Unlike the TPU kernel it
// takes any Sq and Skv: tail rows are masked and the last block may be short.
//
// Bound on an H100: it reads q, k and v once in their type and writes o in f32,
// and does 4*hd operations per valid (query, key) pair. At BH = 32, hd = 128,
// S = 2048, causal, that is 34.4 GFLOP, bound by operations at 0.035 ms at the
// bf16 tensor-core peak.
//
// Design (simple and right first): a block of 128 threads owns 16 query rows of
// one head. Q is staged in shared memory as f32; per KV block, K comes through
// a 32-key tile (rows padded to hd + 1 floats, so the 32 lanes of a warp, one
// key each, hit 32 banks), every thread computes 4 scores of one key with f32
// FMAs, the scores of the block stay in shared memory, each warp takes the max,
// exp and sums of 4 rows, and V comes through the same tile for the PV product,
// each thread owning hd/128 output columns of all 16 rows in registers. Left on
// the table: the tensor cores (mma/wgmma for both products), cp.async/TMA
// prefetch of the next tile, and a larger query tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 16;         // query rows per block
constexpr int kThreads = 128;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 32;        // keys per shared-memory K/V tile
constexpr int kMaxHd = 256;
constexpr int kCols = kMaxHd / kThreads;  // output columns per thread
constexpr int kMaxBlockK = 1024;
constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_round(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ bool is_valid(int pq, int pk, int window) {
  return pk >= 0 && pq >= pk && pq - pk < window;
}

// Shared memory: q (kBQ x hd), scores/probabilities (kBQ x block_k), key
// positions (block_k), the K/V tile (kSub x (hd + 1)), and m, l, corr per row.
inline size_t smem_bytes(int hd, int block_k) {
  return sizeof(float) * ((size_t)kBQ * hd + (size_t)kBQ * block_k + block_k +
                          (size_t)kSub * (hd + 1) + 3 * kBQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
      const int* __restrict__ pos_q, const int* __restrict__ pos_k, float* __restrict__ o,
      int Sq, int Skv, int hd, int block_k, float scale, int use_softcap, float softcap,
      int window) {
  extern __shared__ float smem[];
  float* qs = smem;                                  // kBQ x hd
  float* ss = qs + kBQ * hd;                         // kBQ x block_k
  int* pks = reinterpret_cast<int*>(ss + kBQ * block_k);   // block_k
  float* tile = reinterpret_cast<float*>(pks + block_k);   // kSub x (hd + 1)
  float* m_row = tile + kSub * (hd + 1);             // kBQ
  float* l_row = m_row + kBQ;
  float* corr_row = l_row + kBQ;
  __shared__ int pqs[kBQ];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int pitch = hd + 1;
  const T* kb = k + (size_t)bh * Skv * hd;
  const T* vb = v + (size_t)bh * Skv * hd;

  for (int i = t; i < kBQ * hd; i += kThreads) {
    const int r = i / hd;
    const int row = q0 + r;
    qs[i] = row < Sq ? bf16_round(q[((size_t)bh * Sq + row) * hd + (i - r * hd)]) : 0.0f;
  }
  if (t < kBQ) {
    const int row = q0 + t;
    pqs[t] = row < Sq ? pos_q[(size_t)bh * Sq + row] : -1;  // a tail row sees no key
    m_row[t] = kNegInf;
    l_row[t] = 0.0f;
  }
  float acc[kBQ][kCols];
#pragma unroll
  for (int r = 0; r < kBQ; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;

  for (int j0 = 0; j0 < Skv; j0 += block_k) {
    const int nb = min(block_k, Skv - j0);
    __syncthreads();  // the previous block is consumed
    for (int j = t; j < nb; j += kThreads) pks[j] = pos_k[(size_t)bh * Skv + j0 + j];
    __syncthreads();
    int any = 0;
    for (int i = t; i < kBQ * nb && !any; i += kThreads) {
      const int r = i / nb;
      any = is_valid(pqs[r], pks[i - r * nb], window);
    }
    if (!__syncthreads_or(any)) continue;  // m, l and acc would not change

    // Scores of the block: thread (key jj, rows warp + 4i).
    for (int st = 0; st < nb; st += kSub) {
      for (int i = t; i < kSub * hd; i += kThreads) {
        const int jj = i / hd;
        const int d = i - jj * hd;
        tile[jj * pitch + d] =
            st + jj < nb ? bf16_round(kb[(size_t)(j0 + st + jj) * hd + d]) : 0.0f;
      }
      __syncthreads();
      float s[kBQ / kWarps];
#pragma unroll
      for (int i = 0; i < kBQ / kWarps; ++i) s[i] = 0.0f;
      const float* kr = tile + lane * pitch;
      for (int d = 0; d < hd; ++d) {
        const float kd = kr[d];
#pragma unroll
        for (int i = 0; i < kBQ / kWarps; ++i)
          s[i] = fmaf(qs[(warp + kWarps * i) * hd + d], kd, s[i]);
      }
      if (st + lane < nb) {
#pragma unroll
        for (int i = 0; i < kBQ / kWarps; ++i) {
          const int r = warp + kWarps * i;
          float x = __fmul_rn(s[i], scale);
          if (use_softcap) x = __fmul_rn(softcap, tanhf(__fdiv_rn(x, softcap)));
          ss[r * block_k + st + lane] =
              is_valid(pqs[r], pks[st + lane], window) ? x : kNegInf;
        }
      }
      __syncthreads();
    }

    // Softmax statistics: warp w owns rows w, w + 4, w + 8, w + 12.
#pragma unroll
    for (int i = 0; i < kBQ / kWarps; ++i) {
      const int r = warp + kWarps * i;
      float* sr = ss + r * block_k;
      float mx = kNegInf;
      for (int j = lane; j < nb; j += 32) mx = fmaxf(mx, sr[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_row[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int j = lane; j < nb; j += 32) {
        const float p = is_valid(pqs[r], pks[j], window) ? expf(sr[j] - m_new) : 0.0f;
        sum += p;
        sr[j] = bf16_round(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_row[r] = corr;
        l_row[r] = __fadd_rn(__fmul_rn(l_row[r], corr), sum);
        m_row[r] = m_new;
      }
    }

    // PV of the block, then acc = acc * corr + pv.
    float pv[kBQ][kCols];
#pragma unroll
    for (int r = 0; r < kBQ; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) pv[r][c] = 0.0f;
    for (int st = 0; st < nb; st += kSub) {
      __syncthreads();  // scores/stats written, the K tile consumed
      const int nt = min(kSub, nb - st);
      for (int i = t; i < nt * hd; i += kThreads) {
        const int jj = i / hd;
        const int d = i - jj * hd;
        tile[jj * pitch + d] = bf16_round(vb[(size_t)(j0 + st + jj) * hd + d]);
      }
      __syncthreads();
      for (int jj = 0; jj < nt; ++jj) {
        const float* vr = tile + jj * pitch;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = t + kThreads * c;
          if (d < hd) {
            const float vd = vr[d];
#pragma unroll
            for (int r = 0; r < kBQ; ++r) pv[r][c] = fmaf(ss[r * block_k + st + jj], vd, pv[r][c]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kBQ; ++r) {
      const float corr = corr_row[r];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = __fadd_rn(__fmul_rn(acc[r][c], corr), pv[r][c]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kBQ; ++r) {
    const int row = q0 + r;
    if (row >= Sq) break;
    const float den = fmaxf(l_row[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = t + kThreads * c;
      if (d < hd) o[((size_t)bh * Sq + row) * hd + d] = __fdiv_rn(acc[r][c], den);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pos_q, const void* pos_k,
           void* o, int BH, int Sq, int Skv, int hd, int block_k, float scale,
           int use_softcap, float softcap, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd, block_k);
  cudaError_t err = cudaFuncSetAttribute(flash<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  flash<T><<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                            (const int*)pos_q, (const int*)pos_k, (float*)o,
                                            Sq, Skv, hd, block_k, scale, use_softcap, softcap,
                                            window);
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
  return is_f32 ? launch<float>(q, k, v, pos_q, pos_k, o, BH, Sq, Skv, hd, block_k, scale,
                                use_softcap, softcap, window, st)
                : launch<__nv_bfloat16>(q, k, v, pos_q, pos_k, o, BH, Sq, Skv, hd, block_k,
                                        scale, use_softcap, softcap, window, st);
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
