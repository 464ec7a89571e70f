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
// it is bound by memory, 17.2 us for M = 2048, K = 11008 at 3.35 TB/s; at a few
// rows it is bound by its launch.
//
// Design. One lane encodes one subgroup of 8 elements of one row, so a quad of
// lanes holds a group of 32 and a warp 8 rows of one group:
//   * one 16-byte load per lane of 8 bf16 (two for f32), read once (no L1
//     allocation, 256-byte L2 fetches); instances with narrower evict-first
//     loads for an x that starts off a 16-byte boundary;
//   * the group amax from two xor shuffles (1, 2) of magnitude bits (bits of
//     non-negative floats order as their values); scale exponent
//     e = floor(log2(max(amax, 1e-30))) - 2 from the exponent field;
//   * no division: e is in [-102, 125] for finite x, so 2^k * 2^-e is a normal
//     f32 for the k used here, and x * 2^k * 2^-e is exact, or rounds once as
//     x / 2^e does where the quotient is subnormal (the build keeps IEEE
//     behaviour: no fast math, no flush to zero);
//   * the FP4 and FP6 codes with no floor(log2) per element: for ax = |x| / 2^e
//     and a grid with m mantissa bits, the code in binade e2 (e2 = 0 below 2) is
//     rint(ax * 2^(m - e2)) + (e2 << m), and every other binade's term is at
//     least as large, so the code is the least of the three terms and the top
//     code. Each rint is one fma with a magic constant (1.5 * 2^23 in f32; for
//     bf16 x two elements per bf16x2 fma with 192 = 1.5 * 2^7, whose ulp is 1);
//     tests/test_torch_quantize_lanes.py holds this to the plain rounding on a
//     dense sweep of [0, 16) and at every midpoint of both grids;
//   * the top-1 of a subgroup in the lane as the largest key code * 8 + 7 - i
//     (the lowest index wins a tie), no compare-and-select per element; the
//     meta byte from each lane's 2-bit field at bits 2j, or-ed over the quad;
//   * the sign bits from whole input words (x < 0: the sign bit and a nonzero
//     magnitude, so -0.0 gets code 0 and a negative x that rounds to 0 code 8);
//   * byte i of a group's codes is code i | code 16+i << 4, so lane j pairs with
//     lane j ^ 2: one shuffle of the 8 packed nibbles and a byte permute give
//     each lane 4 bytes;
//   * the tile's stream rows (16 code rows, a scale and a meta row per group)
//     go through shared memory ([row][pitch] bytes, pitch = 8 mod 16 so that
//     the four byte rows a quad writes fall in different banks), then out
//     along M with the widest store the address allows: 16 bytes where
//     row * M + m0 is a multiple of 16, narrower at the M tail and for
//     M % 16 != 0. The K tail (K % 256 != 0) is masked by group.
// A block takes TM rows x TG groups with TG warps, warp w group w: 32 x 8
// (256 threads, 4 rows per lane, all loaded before the first is encoded) where
// that gives at least two blocks per SM, else 8 x 1 (one warp), so that a few
// rows still spread over the card (128 blocks at M = 8, K = 4096). Blocks are
// numbered with the groups fastest, so the blocks in flight read whole rows of
// x. The host picks the tile and the load width (kernels/m2xfp_quantize.py).
// What limits it at M = 2048 is the memory path, not the encode: PERF.md has
// its times against a copy of the same bytes.
#include <cuda_bf16.h>
#include <stdint.h>

#include "mx_bits.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// 1.5 * 2^23: from 2^23 to 2^24 the ulp of an f32 is 1, so fma(a, s, kMagic + c)
// for an exact a * s below 2^22 is kMagic + c + rint(a * s), half to even (c even)
constexpr float kMagic = 12582912.0f;
constexpr uint32_t kMagicBits = 0x4B400000u;

// A block works on tiles of TM rows x TG groups: TG warps, each 8 rows per pass.
template <int TM, int TG>
struct Tile {
  static constexpr int kThreads = 32 * TG;
  static constexpr int kPasses = TM / 8;
  static constexpr int kCodeRows = 16 * TG;
  static constexpr int kRows = 18 * TG;                   // codes, scales, meta
  static constexpr int kPitch = (TM + 15) / 16 * 16 + 8;  // bytes, 8 mod 16
  static constexpr int kChunk = TM < 16 ? TM : 16;        // bytes per store
};

// floor(log2(x)) of a normal f32 x > 0: its exponent field.
__device__ __forceinline__ int exp_field(float x) { return (__float_as_int(x) >> 23) - 127; }

// kMagic + the RTNE code of ax = a * s on the E2M<m> grid (exponents 0..2),
// saturated at the top code; s2 = 2^m * s. With n_b = rint(ax * 2^(m - b)),
// the code is n_e2 + (e2 << m) for ax in binade e2 (e2 = 0 below 2), and every
// other band's n_b + (b << m) is at least as large, so the code is the least of
// the three and the top code (FP4: 7 = 6.0, FP6: 31 = 7.5).
template <int kMan>
__device__ __forceinline__ float code_magic(float a, float s2) {
  constexpr float kBand = (float)(1 << kMan), kTop = (float)((4 << kMan) - 1);
  const float c0 = fmaf(a, s2, kMagic);
  const float c1 = fmaf(a, 0.5f * s2, kMagic + kBand);
  const float c2 = fmaf(a, 0.25f * s2, kMagic + 2.0f * kBand);
  return fminf(fminf(c0, c1), fminf(c2, kMagic + kTop));
}

// Nibble of element i in a lane's code word: even elements in the low half.
__host__ __device__ constexpr int nibble(int i) { return 4 * (i >> 1) + 16 * (i & 1); }

// A lane's 8 elements as 32-bit words: bf16 two per word (element 2p in the
// low half of word p), f32 one. codes() gives the lane's FP4 code word (code of
// element i at nibble(i)) and its top-1 key, the largest code * 8 + 7 - i (the
// lowest index wins a tie), from the magnitude words and the scale exponent.
template <typename T>
struct In;
template <>
struct In<__nv_bfloat16> {
  static constexpr int kWords = 4, kPerWord = 2, kSignBit = 15;
  static constexpr uint32_t kMag = 0x7fff7fffu, kSign = 0x80008000u;
  static __device__ __forceinline__ uint32_t vmax(uint32_t a, uint32_t b) { return __vmaxu2(a, b); }
  // f32 bits of the larger half
  static __device__ __forceinline__ uint32_t top_bits(uint32_t m) {
    return max(m << 16, m & 0xffff0000u);
  }
  // Two elements per bf16x2 fma: 192 = 1.5 * 2^7 has ulp 1 in bf16, and the
  // fma rounds a * 2^k + 192 once, so each half is 192 + rint(a * 2^k) (the
  // product is exact) as in code_magic, and so is the least of the bands'.
  static __device__ __forceinline__ void codes(const uint32_t (&wa)[kWords], int e, uint32_t& nib,
                                               uint32_t& key) {
    const uint32_t s1 = (uint32_t)(127 - e) << 7;  // 2^-e in each bf16 half
    const __nv_bfloat162 k0 = pair((s1 + 0x80u) * 0x10001u), k1 = pair(s1 * 0x10001u);
    const __nv_bfloat162 k2 = pair((s1 - 0x80u) * 0x10001u);
    nib = 0u - 0x43404340u * 0x1111u;
    uint32_t keys = 0;
#pragma unroll
    for (int p = 0; p < kWords; ++p) {
      const __nv_bfloat162 a = pair(wa[p]);
      const __nv_bfloat162 c01 = __hmin2(__hfma2(a, k0, pair(0x43404340u)),    // 192
                                         __hfma2(a, k1, pair(0x43424342u)));   // 194
      const __nv_bfloat162 c2 = __hmin2(__hfma2(a, k2, pair(0x43444344u)),     // 196
                                        pair(0x43474347u));                     // 199
      const uint32_t g = bits(__hmin2(c01, c2));     // 192 + code in each half
      nib += g << (4 * p);                           // nibbles 2p and 2p + 1
      keys = __vmaxu2(keys, g * 8u + (0u - 0x43404340u * 8u) +
                                (uint32_t)((7 - 2 * p) | (6 - 2 * p) << 16));
    }
    key = max(keys & 0xffffu, keys >> 16);
  }
  // |element i| in f32, by byte permutes and a select (no indexed registers)
  static __device__ __forceinline__ float pick(const uint32_t (&wa)[kWords], int i) {
    const uint32_t sel = (uint32_t)(i & 3) * 0x2200u + 0x1000u;  // bytes 2i, 2i+1 -> 2, 3
    const uint32_t lo = __byte_perm(wa[0], wa[1], sel), hi = __byte_perm(wa[2], wa[3], sel);
    return __uint_as_float((i & 4 ? hi : lo) & 0xffff0000u);
  }
  static __device__ __forceinline__ __nv_bfloat162 pair(uint32_t u) {
    return *reinterpret_cast<const __nv_bfloat162*>(&u);
  }
  static __device__ __forceinline__ uint32_t bits(__nv_bfloat162 b) {
    return *reinterpret_cast<const uint32_t*>(&b);
  }
};
template <>
struct In<float> {
  static constexpr int kWords = 8, kPerWord = 1, kSignBit = 31;
  static constexpr uint32_t kMag = 0x7fffffffu, kSign = 0x80000000u;
  static __device__ __forceinline__ uint32_t vmax(uint32_t a, uint32_t b) { return max(a, b); }
  static __device__ __forceinline__ uint32_t top_bits(uint32_t m) { return m; }
  static __device__ __forceinline__ void codes(const uint32_t (&wa)[kWords], int e, uint32_t& nib,
                                               uint32_t& key) {
    const float s2 = mx::exp2i(1 - e);
    nib = 0u - kMagicBits * 0x11111111u;
    key = 0;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const uint32_t g = __float_as_uint(code_magic<1>(__uint_as_float(wa[i]), s2));
      nib += g << nibble(i);
      key = max(key, g * 8u + (uint32_t)(7 - i));
    }
    key -= kMagicBits * 8u;
  }
  static __device__ __forceinline__ float pick(const uint32_t (&wa)[kWords], int i) {
    const uint32_t a = i & 1 ? wa[1] : wa[0], b = i & 1 ? wa[3] : wa[2];
    const uint32_t c = i & 1 ? wa[5] : wa[4], d = i & 1 ? wa[7] : wa[6];
    const uint32_t ab = i & 2 ? b : a, cd = i & 2 ? d : c;
    return __uint_as_float(i & 4 ? cd : ab);
  }
};

// 16 bytes of x, read once: no L1 allocation, and a 256-byte L2 fetch, so a
// miss also brings the neighbouring lanes' and warps' bytes of the row.
__device__ __forceinline__ uint4 load_once(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// kWords words from p with loads of kVec bytes (p is kVec-aligned).
template <int kVec, int kWords>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[kWords]) {
  if constexpr (kVec == 16) {
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i) {
      const uint4 v = load_once(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
    }
  } else if constexpr (kVec == 8) {
#pragma unroll
    for (int i = 0; i < kWords / 2; ++i) {
      const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p) + i);
      w[2 * i] = v.x; w[2 * i + 1] = v.y;
    }
  } else if constexpr (kVec == 4) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = __ldcs(reinterpret_cast<const uint32_t*>(p) + i);
  } else {
    static_assert(kVec == 2, "loads of 2, 4, 8 or 16 bytes");
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      w[i] = (uint32_t)__ldcs(h + 2 * i) | ((uint32_t)__ldcs(h + 2 * i + 1) << 16);
  }
}

// Encodes the quad's group of one row from the lane's 8 elements (lane j of
// the quad holds subgroup j) into column col of the tile: the lane's 4 code
// bytes, lane 0 the scale byte, lane 1 the meta byte.
template <typename T, int TM, int TG>
__device__ __forceinline__ void encode(const uint32_t (&w)[In<T>::kWords], int j, int warp,
                                       int col, uint8_t* tile) {
  using S = Tile<TM, TG>;
  using I = In<T>;
  uint32_t wa[I::kWords];
  uint32_t most = 0;
#pragma unroll
  for (int p = 0; p < I::kWords; ++p) {
    wa[p] = w[p] & I::kMag;
    most = I::vmax(most, wa[p]);
  }
  // group amax over the quad (magnitude bits order as their values)
  uint32_t amax = I::top_bits(most);
  amax = max(amax, __shfl_xor_sync(kFull, amax, 1));
  amax = max(amax, __shfl_xor_sync(kFull, amax, 2));
  int e = amax == 0 ? 0 : exp_field(fmaxf(__uint_as_float(amax), 1e-30f)) - 2;
  e = max(-126, min(127, e));
  // e is in [-102, 125] for finite x, so every 2^k * 2^-e below is a normal f32
  const float s = mx::exp2i(-e);

  // Stage 1: FP4 codes into the code word, the top-1 key, then the sign bits.
  uint32_t nib, key;
  I::codes(wa, e, nib, key);
  // sign bit 3 of a nibble: x < 0 (a negative x that rounds to 0 keeps it; -0.0 not)
#pragma unroll
  for (int p = 0; p < I::kWords; ++p) {
    const uint32_t neg = w[p] & (wa[p] + I::kMag) & I::kSign;
    const int shift = nibble(p * I::kPerWord) + 3 + 32 - I::kSignBit;  // bit -> 3 + nibble
    nib += shift == 32 ? neg : __umulhi(neg, 1u << (shift & 31));
  }

  // Stage 2: FP6 refinement of the top-1, bias-clamp field at bits 2j.
  const int cmax = (int)(key >> 3);
  const int top = 7 - (int)(key & 7);
  const float at = I::pick(wa, top);
  const int c6 = (int)(__float_as_uint(code_magic<3>(at, 8.0f * s)) - kMagicBits);
  const int rmin = cmax << 2;
  uint32_t mb = (uint32_t)(min(max(c6 + 1, rmin), rmin | 3) & 3) << (2 * j);
  mb |= __shfl_xor_sync(kFull, mb, 1);
  mb |= __shfl_xor_sync(kFull, mb, 2);

  // Byte i of the group's codes is code i | code 16+i << 4: lanes 0/2 hold
  // codes 0-7/16-23 (bytes 0-7), lanes 1/3 codes 8-15/24-31 (bytes 8-15). Nibble
  // n of a code word holds element 2n (n < 4) or 2(n-4)+1, so the low nibbles
  // of (lo, hi) give bytes 0,4,1,5 of the pair's 8, the high nibbles 2,6,3,7; the
  // lower lane of a pair keeps bytes 0-3, the upper 4-7.
  const uint32_t other = __shfl_xor_sync(kFull, nib, 2);
  const bool upper = j & 2;
  const uint32_t lo = upper ? other : nib, hi = upper ? nib : other;
  const uint32_t t = (lo & 0x0f0f0f0fu) | ((hi << 4) & 0xf0f0f0f0u);
  const uint32_t u = ((lo >> 4) & 0x0f0f0f0fu) | (hi & 0xf0f0f0f0u);
  const uint32_t word = __byte_perm(t, u, upper ? 0x7531 : 0x6420);
  uint8_t* dst = tile + (16 * warp + 8 * (j & 1) + 4 * (j >> 1)) * S::kPitch + col;
#pragma unroll
  for (int k = 0; k < 4; ++k) dst[k * S::kPitch] = (uint8_t)(word >> (8 * k));
  if (j == 0) tile[(S::kCodeRows + warp) * S::kPitch + col] = (uint8_t)(e + 127);
  if (j == 1) tile[(S::kCodeRows + TG + warp) * S::kPitch + col] = (uint8_t)mb;
}

// n (1..kChunk) bytes from shared memory (8-aligned) to dst, with the widest
// stores that dst and n allow.
template <int kChunk>
__device__ __forceinline__ void store_bytes(uint8_t* dst, const uint8_t* src, int n) {
  const unsigned a = (unsigned)reinterpret_cast<uintptr_t>(dst) | (unsigned)n;
  if constexpr (kChunk == 16) {
    if ((a & 15) == 0) {  // n == 16
      const uint2 lo = *reinterpret_cast<const uint2*>(src);
      const uint2 hi = *reinterpret_cast<const uint2*>(src + 8);
      *reinterpret_cast<uint4*>(dst) = make_uint4(lo.x, lo.y, hi.x, hi.y);
      return;
    }
  }
  if ((a & 7) == 0) {
    for (int i = 0; i < n; i += 8)
      *reinterpret_cast<uint2*>(dst + i) = *reinterpret_cast<const uint2*>(src + i);
  } else if ((a & 3) == 0) {
    for (int i = 0; i < n; i += 4)
      *reinterpret_cast<uint32_t*>(dst + i) = *reinterpret_cast<const uint32_t*>(src + i);
  } else if ((a & 1) == 0) {
    for (int i = 0; i < n; i += 2)
      *reinterpret_cast<uint16_t*>(dst + i) = *reinterpret_cast<const uint16_t*>(src + i);
  } else {
    for (int i = 0; i < n; ++i) dst[i] = src[i];
  }
}

// One block per tile, tiles numbered with the groups fastest.
template <typename T, int kVec, int TM, int TG>
__global__ void __launch_bounds__(32 * TG)
quantize(const T* __restrict__ x, uint8_t* __restrict__ codes,
         uint8_t* __restrict__ scales, uint8_t* __restrict__ meta, int M, int K) {
  using S = Tile<TM, TG>;
  __shared__ __align__(16) uint8_t tile[S::kRows * S::kPitch];
  const int groups = K / mx::kGroup;
  const int gtiles = (groups + TG - 1) / TG;
  const int m0 = blockIdx.x / gtiles * TM;
  const int g0 = blockIdx.x % gtiles * TG;
  const int warp = threadIdx.x / 32;
  const int q = threadIdx.x % 32 / 4;  // row of the pass
  const int j = threadIdx.x % 4;       // subgroup of the group
  const int g = g0 + warp;
  if (g < groups) {  // the same for the whole warp
    uint32_t w[S::kPasses][In<T>::kWords];
#pragma unroll
    for (int p = 0; p < S::kPasses; ++p) {
      const int m = m0 + 8 * p + q;
      if (m < M) {
        load_words<kVec>(x + (size_t)m * K + g * mx::kGroup + j * mx::kSubgroup, w[p]);
      } else {
#pragma unroll
        for (int i = 0; i < In<T>::kWords; ++i) w[p][i] = 0;
      }
    }
#pragma unroll
    for (int p = 0; p < S::kPasses; ++p) encode<T, TM, TG>(w[p], j, warp, 8 * p + q, tile);
  }
  __syncthreads();

  const int rows = min(TM, M - m0);
  const int gv = min(TG, groups - g0);
  constexpr int kPieces = TM / S::kChunk;
  for (int i = threadIdx.x; i < S::kRows * kPieces; i += S::kThreads) {
    const int r = i / kPieces;
    const int c = i % kPieces * S::kChunk;
    uint8_t* dst;
    if (r < S::kCodeRows) {
      if (r >= 16 * gv) continue;
      dst = codes + (size_t)(16 * g0 + r) * M;
    } else if (r < S::kCodeRows + TG) {
      if (r - S::kCodeRows >= gv) continue;
      dst = scales + (size_t)(g0 + r - S::kCodeRows) * M;
    } else {
      if (r - S::kCodeRows - TG >= gv) continue;
      dst = meta + (size_t)(g0 + r - S::kCodeRows - TG) * M;
    }
    if (c < rows)
      store_bytes<S::kChunk>(dst + m0 + c, tile + r * S::kPitch + c, min(S::kChunk, rows - c));
  }
}

template <typename T, int kVec, int TM, int TG>
void launch_vec(const T* x, uint8_t* c, uint8_t* s, uint8_t* m, int M, int K, cudaStream_t st) {
  const int tiles = (M + TM - 1) / TM * ((K / mx::kGroup + TG - 1) / TG);
  quantize<T, kVec, TM, TG><<<tiles, Tile<TM, TG>::kThreads, 0, st>>>(x, c, s, m, M, K);
}

template <typename T, int TM, int TG>
int launch(const void* x, int vec, void* codes, void* scales, void* meta, int M, int K,
           cudaStream_t st) {
  const T* xt = (const T*)x;
  uint8_t *c = (uint8_t*)codes, *s = (uint8_t*)scales, *m = (uint8_t*)meta;
  if (vec == 16)
    launch_vec<T, 16, TM, TG>(xt, c, s, m, M, K, st);
  else if (vec == 8)
    launch_vec<T, 8, TM, TG>(xt, c, s, m, M, K, st);
  else if (vec == 4)
    launch_vec<T, 4, TM, TG>(xt, c, s, m, M, K, st);
  else if constexpr (sizeof(T) == 2)
    launch_vec<T, 2, TM, TG>(xt, c, s, m, M, K, st);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tile(const void* x, int vec, int tile_rows, void* codes, void* scales, void* meta,
                int M, int K, cudaStream_t st) {
  if (tile_rows == 32) return launch<T, 32, 8>(x, vec, codes, scales, meta, M, K, st);
  return launch<T, 8, 1>(x, vec, codes, scales, meta, M, K, st);
}

}  // namespace

// x_vec_bytes: the load width, a power of two from the element size to 16
// that divides x's address; tile_rows: 32 or 8 rows of x per block.
extern "C" int m2xfp_quantize(const void* x, int x_is_f32, int x_vec_bytes, int tile_rows,
                              void* codes, void* scales, void* meta, int M, int K,
                              void* stream) {
  const int elem = x_is_f32 ? 4 : 2;
  if (x_vec_bytes < elem || x_vec_bytes > 16 || (x_vec_bytes & (x_vec_bytes - 1)) ||
      reinterpret_cast<uintptr_t>(x) % x_vec_bytes || (tile_rows != 32 && tile_rows != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_is_f32)
    return launch_tile<float>(x, x_vec_bytes, tile_rows, codes, scales, meta, M, K, st);
  return launch_tile<__nv_bfloat16>(x, x_vec_bytes, tile_rows, codes, scales, meta, M, K, st);
}

extern "C" const char* m2xfp_quantize_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
