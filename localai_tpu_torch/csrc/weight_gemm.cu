// Weight GEMMs that read each weight as it is stored: the int8 projections
// (W8A16) and the f32 vocabulary projection (the lm head).
//
// Replaces two products that the reference leaves to XLA, which fuses each
// weight's convert into its dot (no Pallas kernel):
//   - localai_tpu/ops/quant.py:78-80 (qmatmul): y = x @ q.astype(x.dtype),
//     then y * s.astype(y.dtype); q int8 [K, N], s f32 [1, N] (one scale an
//     output channel), x bf16, f16 or f32 [M, K];
//   - localai_tpu/models/llama.py:347-364 (_lm_head): x32 f32 [M, K]
//     against a bf16/f16 head [K, V], a tied embedding [V, K] read
//     transposed, or an int8 head {q, s} with x32 rounded to bf16.
// A cast of the weight before each product would write it out and read
// it back: 14 GB of bf16 copies a decode step at 8B widths (int8), and
// 2.1 GB for the head's f32 copy.
//
// Arithmetic (the reference's, exactly):
//   - bf16/f16 x, int8 q (weight_gemm_mma_kernel, EPI_ROUND): each int8
//     value converts to x's type (exact), products sum in f32 on the tensor
//     cores (mma.sync m16n8k16), the sum rounds once to x's type, the scale
//     rounds to x's type and their product rounds again: y * s.to(y.dtype);
//   - int8 head (the same kernel, EPI_F32): x32 rounded to bf16 by the
//     caller; bf16 x int8 products are exact in f32, summed in f32, then
//     times s in f32;
//   - f32 x with an int8, bf16 or f16 weight (weight_gemm_simt_kernel): f32
//     FMAs of x and the weight's exact f32 value. The tensor cores would
//     round x to bf16 (or TF32), which is not the reference's arithmetic.
//
// What bounds it on the H100: at decode (M <= 8) the weight's bytes — one
// int8 byte (or two bf16 bytes) read per element, 3.35 TB/s — and at
// prefill's M the tensor cores (or, for f32 x, the 67 TFLOP/s of f32 FMA).
// Design (simple and right; wgmma/TMA are later work):
//   - every block streams its weight tiles once, through a cp.async ring in
//     shared memory, and reuses each tile for all of its M rows (16, 64 or
//     128 on the tensor cores, 8 on the SIMT route); the tensor-core route
//     converts an int8 tile to x's type in shared memory (bf16 by byte
//     permutes and f32 adds, wg_cvt4), then ldmatrix feeds mma. Every
//     block of rows converts the tile again, so at prefill's M the
//     conversion, not the stream, is what the 128-row tiles amortise;
//   - split-K where the output tiles alone would not fill the card (a
//     4096x1024 projection at M = 4 has 8 column tiles for 132 SMs): each
//     split writes f32 partials to a workspace the caller allocates on its
//     stream, and a combine pass sums them in split order and applies the
//     epilogue. No float atomics: a call's result is the same bits every
//     time, so CUDA graph replays equal eager runs bit for bit.
// Limits: K and N multiples of 16 (16-byte rows for cp.async); the M, N and
// K tails inside a tile are predicated (zero-filled, never stored).
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

enum WgDtype { WG_F32 = 0, WG_BF16 = 1, WG_F16 = 2, WG_I8 = 3 };
enum WgEpi { EPI_ROUND = 0, EPI_F32 = 1 };

// tensor-core route: tiles of BM (16, 64 or 128) x 128 output elements,
// 64 of K
constexpr int TC_BN = 128, TC_BK = 64;
// SIMT route: tiles of 8 x 512 outputs, 16 of K; 4 outputs a thread a row
constexpr int SG_BM = 8, SG_BN = 512, SG_BK = 16, SG_STAGES = 3;
constexpr int SG_THREADS = 128;
// the [BN][BK] tile of a transposed (tied) weight, rows padded to 48 bytes
// so that eight lanes' 16-byte reads of eight rows hit distinct banks
constexpr int SG_NK_LD = SG_BK + 8;
constexpr int COMBINE_THREADS = 256;

__device__ __forceinline__ float wg_f(float x) { return x; }
__device__ __forceinline__ float wg_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float wg_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T wg_round(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 wg_round<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}
template <>
__device__ __forceinline__ __half wg_round<__half>(float x) {
  return __float2half_rn(x);
}

// byte j of w as a signed int8 value
__device__ __forceinline__ int wg_byte(uint32_t w, int j) {
  return static_cast<int>(static_cast<int8_t>((w >> (8 * j)) & 0xffu));
}

// Four int8 values (one 32-bit word) as two packed pairs of T, byte 0 in
// the low half of p0 (exact: |v| <= 128 has at most 8 significant bits).
template <typename T>
__device__ __forceinline__ void wg_cvt4(uint32_t w, uint32_t& p0,
                                        uint32_t& p1);
template <>
__device__ __forceinline__ void wg_cvt4<__half>(uint32_t w, uint32_t& p0,
                                                uint32_t& p1) {
  __half2 h0 = __floats2half2_rn(static_cast<float>(wg_byte(w, 0)),
                                 static_cast<float>(wg_byte(w, 1)));
  __half2 h1 = __floats2half2_rn(static_cast<float>(wg_byte(w, 2)),
                                 static_cast<float>(wg_byte(w, 3)));
  p0 = *reinterpret_cast<uint32_t*>(&h0);
  p1 = *reinterpret_cast<uint32_t*>(&h1);
}
// bf16, without the int -> float conversion unit (16 a clock an SM, the
// kernel's bottleneck at prefill's M): byte b + 128 (b ^ 0x80) put in the
// low byte of 2^23's bit pattern is the f32 2^23 + b + 128, exactly, and
// subtracting 2^23 + 128 leaves b. An integer of at most 8 significant
// bits is exact in bf16, so the f32's high half is its bf16; one byte
// permute packs two. Byte permutes and f32 adds run at full rate.
template <>
__device__ __forceinline__ void wg_cvt4<__nv_bfloat16>(uint32_t w,
                                                       uint32_t& p0,
                                                       uint32_t& p1) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr uint32_t kMagic = 0x4B000000u;   // 2^23
  constexpr float kBias = 8388736.f;         // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, kMagic, 0x7650)) - kBias;
  const float f1 = __uint_as_float(__byte_perm(u, kMagic, 0x7651)) - kBias;
  const float f2 = __uint_as_float(__byte_perm(u, kMagic, 0x7652)) - kBias;
  const float f3 = __uint_as_float(__byte_perm(u, kMagic, 0x7653)) - kBias;
  p0 = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  p1 = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// 2 (bf16, f16) or 4 (int8) weight elements of one 32-bit word as f32
__device__ __forceinline__ void wg_word_f(uint32_t w, __nv_bfloat16,
                                          float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void wg_word_f(uint32_t w, __half, float* v) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w));
  v[0] = f.x;
  v[1] = f.y;
}
__device__ __forceinline__ void wg_word_f(uint32_t w, int8_t, float* v) {
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = static_cast<float>(wg_byte(w, j));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory (lanes 8i..8i+7 give matrix i's
// row addresses); .trans delivers each transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16x16, row) * b (16x8, col) in T, f32 accumulators.
template <typename T>
__device__ __forceinline__ void wg_mma(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void wg_mma<__nv_bfloat16>(float (&d)[4],
                                                      const uint32_t (&a)[4],
                                                      uint32_t b0,
                                                      uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void wg_mma<__half>(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Outputs o and o + 1 (columns n, n + 1) from their f32 sums v0, v1.
// EPI_ROUND: out is T, y = T(v), then T(y * T(s[n])), the reference's two
// roundings (the product of two T values is exact in f32). EPI_F32: out is
// f32, v * s[n] (s == nullptr: v).
template <typename T, int EPI>
__device__ __forceinline__ void wg_store(void* out, const float* s,
                                         int64_t o, int n, float v0,
                                         float v1) {
  if constexpr (EPI == EPI_F32) {
    const float s0 = s ? s[n] : 1.f, s1 = s ? s[n + 1] : 1.f;
    *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
        make_float2(v0 * s0, v1 * s1);
  } else {
    const float y0 = wg_f(wg_round<T>(v0)), y1 = wg_f(wg_round<T>(v1));
    const float s0 = wg_f(wg_round<T>(s[n])), s1 = wg_f(wg_round<T>(s[n + 1]));
    T* p = static_cast<T*>(out) + o;
    p[0] = wg_round<T>(y0 * s0);
    p[1] = wg_round<T>(y1 * s1);
  }
}

// -------------------------------------------------- tensor-core route

// A block of WM x WN warps, each MI m16 fragments tall; STAGES tiles in
// the cp.async ring. The three shapes (launch_mma_rows): 16 rows (M <=
// 16: decode), 64 rows, and 128 rows on 8 warps (M > 64: prefill, the
// ragged packs), where a block's converted weight tile feeds twice the
// rows.
template <typename T, int WM, int WN, int MI, int STAGES>
struct TcTile {
  static constexpr int NT = 32 * WM * WN;       // threads a block
  static constexpr int BM = WM * MI * 16;       // rows a block
  static constexpr int WCOLS = TC_BN / WN;      // columns a warp
  static constexpr int NI = WCOLS / 8;          // n8 fragments a warp
  static constexpr int A_STAGE = BM * TC_BK;    // T elements
  static constexpr int Q_STAGE = TC_BK * TC_BN; // int8 bytes
  static constexpr size_t SMEM =
      STAGES * (A_STAGE * sizeof(T) + Q_STAGE) + TC_BK * TC_BN * sizeof(T);
};

// out [M, N] = epilogue(x [M, K] @ q [K, N]) for K tiles [z*kt_per,
// (z+1)*kt_per) of split z = blockIdx.z; with several splits the f32 sums
// go to ws [splits][M][N] instead. Shared memory: the ring of x tiles
// [BM][64] and int8 tiles [64][128], and one converted tile [64][128] of T.
// 16-byte chunks of x rows and converted rows are stored at chunk c ^ (row
// & 7), so ldmatrix's eight row addresses hit distinct banks.
template <typename T, int WM, int WN, int MI, int STAGES, int EPI>
__global__ void __launch_bounds__(32 * WM * WN)
    weight_gemm_mma_kernel(const T* __restrict__ x,
                           const int8_t* __restrict__ q,
                           const float* __restrict__ s, void* __restrict__ out,
                           float* __restrict__ ws, int M, int N, int K,
                           int kt_per) {
  using L = TcTile<T, WM, WN, MI, STAGES>;
  constexpr int NT = L::NT;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  int8_t* sQ =
      reinterpret_cast<int8_t*>(smem + STAGES * L::A_STAGE * sizeof(T));
  T* sB = reinterpret_cast<T*>(
      smem + STAGES * (L::A_STAGE * sizeof(T) + L::Q_STAGE));

  const int m0 = blockIdx.x * L::BM, n0 = blockIdx.y * TC_BN;
  const int nk = (K + TC_BK - 1) / TC_BK;
  const int kt0 = blockIdx.z * kt_per;
  const int ntile = min(nk, kt0 + kt_per) - kt0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * TC_BK;
    T* a = sA + stage * L::A_STAGE;
    for (int i = tid; i < L::BM * 8; i += NT) {
      const int r = i >> 3, c = i & 7;
      const int gm = m0 + r, gk = k0 + c * 8;
      const bool ok = gm < M && gk < K;
      lt_cp_async16(a + r * TC_BK + ((c ^ (r & 7)) << 3),
                    ok ? x + static_cast<int64_t>(gm) * K + gk : x, ok);
    }
    int8_t* b = sQ + stage * L::Q_STAGE;
    for (int i = tid; i < TC_BK * 8; i += NT) {
      const int r = i >> 3, c = i & 7;
      const int gk = k0 + r, gn = n0 + c * 16;
      const bool ok = gk < K && gn < N;
      lt_cp_async16(b + r * TC_BN + c * 16,
                    ok ? q + static_cast<int64_t>(gk) * N + gn : q, ok);
    }
  };

  // int8 tile of `stage` -> sB in T: 16 int8 a thread, two 16-byte chunks
  auto convert = [&](int stage) {
    const int8_t* b = sQ + stage * L::Q_STAGE;
    for (int i = tid; i < TC_BK * 8; i += NT) {
      const int r = i >> 3, c = i & 7;
      const uint4 raw = *reinterpret_cast<const uint4*>(b + r * TC_BN + c * 16);
      uint4 lo, hi;
      wg_cvt4<T>(raw.x, lo.x, lo.y);
      wg_cvt4<T>(raw.y, lo.z, lo.w);
      wg_cvt4<T>(raw.z, hi.x, hi.y);
      wg_cvt4<T>(raw.w, hi.z, hi.w);
      T* row = sB + r * TC_BN;
      *reinterpret_cast<uint4*>(row + (((2 * c) ^ (r & 7)) << 3)) = lo;
      *reinterpret_cast<uint4*>(row + (((2 * c + 1) ^ (r & 7)) << 3)) = hi;
    }
  };

  float acc[MI][L::NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < L::NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  auto compute = [&](int stage) {
    const T* a = sA + stage * L::A_STAGE;
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = (wm * MI + mi) * 16 + (lane & 15);
        const int c = kk * 2 + (lane >> 4);
        ldsm_x4(af[mi], a + r * TC_BK + ((c ^ (r & 7)) << 3));
      }
#pragma unroll
      for (int nj = 0; nj < L::NI / 2; ++nj) {
        // matrices (k 0-7, frag 2nj), (k 8-15, 2nj), (k 0-7, 2nj+1), (k
        // 8-15, 2nj+1): the b0, b1 pairs of two n8 fragments
        const int r = kk * 16 + (lane & 15);
        const int c = ((wn * L::WCOLS) >> 3) + nj * 2 + (lane >> 4);
        uint32_t bf[4];
        ldsm_x4_t(bf, sB + r * TC_BN + ((c ^ (r & 7)) << 3));
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          wg_mma<T>(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
          wg_mma<T>(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ntile) load(st, kt0 + st);
    lt_cp_async_commit();
  }
  for (int t = 0; t < ntile; ++t) {
    lt_cp_async_wait<STAGES - 2>();
    // tile t has landed for every thread, and every warp is done with
    // tile t - 1 (its ring stage and sB are free)
    __syncthreads();
    const int nt = t + STAGES - 1;
    if (nt < ntile) load(nt % STAGES, kt0 + nt);
    lt_cp_async_commit();
    convert(t % STAGES);
    __syncthreads();
    compute(t % STAGES);
  }

  const int g = lane >> 2, t4 = lane & 3;
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < L::NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + (wm * MI + mi) * 16 + g + h * 8;
        const int n = n0 + wn * L::WCOLS + ni * 8 + t4 * 2;
        if (r >= M || n >= N) continue;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        const int64_t o = static_cast<int64_t>(r) * N + n;
        if (split)
          *reinterpret_cast<float2*>(
              ws + static_cast<int64_t>(blockIdx.z) * M * N + o) =
              make_float2(v0, v1);
        else
          wg_store<T, EPI>(out, s, o, n, v0, v1);
      }
}

// ---------------------------------------------------------- SIMT route

template <typename WT, bool NK>
struct SgTile {
  static constexpr int X_STAGE = SG_BM * SG_BK;  // floats
  static constexpr int W_STAGE =
      NK ? SG_BN * SG_NK_LD : SG_BK * SG_BN;     // WT elements
  static constexpr size_t SMEM =
      SG_STAGES * (X_STAGE * sizeof(float) + W_STAGE * sizeof(WT));
};

// out [M, N] f32 = x [M, K] f32 @ w (times s[n] when s is given), w [K, N]
// row-major (NK = false) or the transpose of a row-major [N, K] (NK =
// true, a tied embedding). Thread j owns 4 columns of the block's 512
// (4j..4j+3 for [K, N], j + 128c for [N, K], so that its reads are
// conflict-free) and all 8 rows; its sums run over K in order. With
// several splits the sums go to ws [splits][M][N].
template <typename WT, bool NK>
__global__ void __launch_bounds__(SG_THREADS)
    weight_gemm_simt_kernel(const float* __restrict__ x,
                            const WT* __restrict__ w,
                            const float* __restrict__ s,
                            float* __restrict__ out, float* __restrict__ ws,
                            int M, int N, int K, int kt_per) {
  using L = SgTile<WT, NK>;
  constexpr int WV = 16 / sizeof(WT);  // elements of a 16-byte chunk
  extern __shared__ __align__(128) unsigned char smem[];
  float* sX = reinterpret_cast<float*>(smem);
  WT* sW = reinterpret_cast<WT*>(smem +
                                 SG_STAGES * L::X_STAGE * sizeof(float));

  const int m0 = blockIdx.x * SG_BM, n0 = blockIdx.y * SG_BN;
  const int nk = (K + SG_BK - 1) / SG_BK;
  const int kt0 = blockIdx.z * kt_per;
  const int ntile = min(nk, kt0 + kt_per) - kt0;
  const int tid = threadIdx.x;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * SG_BK;
    float* xs = sX + stage * L::X_STAGE;
    if (tid < SG_BM * (SG_BK / 4)) {
      const int r = tid / (SG_BK / 4), c = tid % (SG_BK / 4);
      const int gm = m0 + r, gk = k0 + c * 4;
      const bool ok = gm < M && gk < K;
      lt_cp_async16(xs + r * SG_BK + c * 4,
                    ok ? x + static_cast<int64_t>(gm) * K + gk : x, ok);
    }
    WT* wt = sW + stage * L::W_STAGE;
    if constexpr (NK) {
      constexpr int CPR = SG_BK / WV;  // chunks a weight row
      for (int i = tid; i < SG_BN * CPR; i += SG_THREADS) {
        const int r = i / CPR, c = i % CPR;
        const int gn = n0 + r, gk = k0 + c * WV;
        const bool ok = gn < N && gk < K;
        lt_cp_async16(wt + r * SG_NK_LD + c * WV,
                      ok ? w + static_cast<int64_t>(gn) * K + gk : w, ok);
      }
    } else {
      constexpr int CPR = SG_BN / WV;
      for (int i = tid; i < SG_BK * CPR; i += SG_THREADS) {
        const int r = i / CPR, c = i % CPR;
        const int gk = k0 + r, gn = n0 + c * WV;
        const bool ok = gk < K && gn < N;
        lt_cp_async16(wt + r * SG_BN + c * WV,
                      ok ? w + static_cast<int64_t>(gk) * N + gn : w, ok);
      }
    }
  };

  float acc[SG_BM][4];
#pragma unroll
  for (int m = 0; m < SG_BM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  auto compute = [&](int stage) {
    const float* xs = sX + stage * L::X_STAGE;
    const WT* wt = sW + stage * L::W_STAGE;
#pragma unroll
    for (int kk = 0; kk < SG_BK; kk += 8) {
      float wv[8][4];  // [k][column]
      if constexpr (NK) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              wt + (tid + c * SG_THREADS) * SG_NK_LD + kk);
          const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float v[2];
            wg_word_f(words[j], WT(), v);
            wv[2 * j][c] = v[0];
            wv[2 * j + 1][c] = v[1];
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const WT* p = wt + (kk + j) * SG_BN + tid * 4;
          if constexpr (sizeof(WT) == 1) {
            wg_word_f(*reinterpret_cast<const uint32_t*>(p), WT(), wv[j]);
          } else {
            const uint2 raw = *reinterpret_cast<const uint2*>(p);
            wg_word_f(raw.x, WT(), wv[j]);
            wg_word_f(raw.y, WT(), wv[j] + 2);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < SG_BM; ++m) {
        const float4 xa = *reinterpret_cast<const float4*>(xs + m * SG_BK + kk);
        const float4 xb =
            *reinterpret_cast<const float4*>(xs + m * SG_BK + kk + 4);
        const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[m][c] = fmaf(xv[j], wv[j][c], acc[m][c]);
      }
    }
  };

#pragma unroll
  for (int st = 0; st < SG_STAGES - 1; ++st) {
    if (st < ntile) load(st, kt0 + st);
    lt_cp_async_commit();
  }
  for (int t = 0; t < ntile; ++t) {
    lt_cp_async_wait<SG_STAGES - 2>();
    __syncthreads();
    const int nt = t + SG_STAGES - 1;
    if (nt < ntile) load(nt % SG_STAGES, kt0 + nt);
    lt_cp_async_commit();
    compute(t % SG_STAGES);
  }

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int m = 0; m < SG_BM; ++m) {
    const int r = m0 + m;
    if (r >= M) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = NK ? n0 + tid + c * SG_THREADS : n0 + tid * 4 + c;
      if (n >= N) continue;
      const int64_t o = static_cast<int64_t>(r) * N + n;
      if (split)
        ws[static_cast<int64_t>(blockIdx.z) * M * N + o] = acc[m][c];
      else
        out[o] = s ? acc[m][c] * s[n] : acc[m][c];
    }
  }
}

// ------------------------------------------------------------- combine

// out = epilogue(sum over z of ws[z]), summed in split order (the same
// bits every run); one thread per pair of columns.
template <typename T, int EPI>
__global__ void __launch_bounds__(COMBINE_THREADS)
    weight_gemm_combine_kernel(const float* __restrict__ ws,
                               const float* __restrict__ s,
                               void* __restrict__ out, int M, int N,
                               int splits) {
  const int64_t pairs = static_cast<int64_t>(M) * N / 2;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * COMBINE_THREADS + threadIdx.x;
  if (i >= pairs) return;
  const float2* p = reinterpret_cast<const float2*>(ws);
  float v0 = 0.f, v1 = 0.f;
  for (int z = 0; z < splits; ++z) {
    const float2 v = p[z * pairs + i];
    v0 += v.x;
    v1 += v.y;
  }
  const int64_t o = 2 * i;
  wg_store<T, EPI>(out, s, o, static_cast<int>(o % N), v0, v1);
}

template <typename T, int EPI>
cudaError_t combine(const float* ws, const float* s, void* out, int M, int N,
                    int splits, cudaStream_t st) {
  const int64_t pairs = static_cast<int64_t>(M) * N / 2;
  const int64_t blocks = (pairs + COMBINE_THREADS - 1) / COMBINE_THREADS;
  weight_gemm_combine_kernel<T, EPI>
      <<<static_cast<unsigned>(blocks), COMBINE_THREADS, 0, st>>>(
          ws, s, out, M, N, splits);
  return cudaGetLastError();
}

// (splits, kt_per) must cover the nk tiles of K with no empty split
bool bad_split(int K, int bk, int splits, int kt_per, const void* ws) {
  const int nk = (K + bk - 1) / bk;
  return splits < 1 || kt_per < 1 || (splits - 1) * kt_per >= nk ||
         splits * kt_per < nk || (splits > 1 && ws == nullptr);
}

template <typename T, int WM, int WN, int MI, int STAGES, int EPI>
int launch_mma(const void* x, const void* q, const float* s, void* out,
               float* ws, int M, int N, int K, int splits, int kt_per,
               cudaStream_t st) {
  using L = TcTile<T, WM, WN, MI, STAGES>;
  auto kernel = weight_gemm_mma_kernel<T, WM, WN, MI, STAGES, EPI>;
  static size_t done[LT_MAX_DEVICES];
  cudaError_t e = lt_set_max_smem(kernel, L::SMEM, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + L::BM - 1) / L::BM, (N + TC_BN - 1) / TC_BN, splits);
  kernel<<<grid, L::NT, L::SMEM, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q), s, out,
      splits > 1 ? ws : nullptr, M, N, K, kt_per);
  e = cudaGetLastError();
  if (e == cudaSuccess && splits > 1)
    e = combine<T, EPI>(ws, s, out, M, N, splits, st);
  return static_cast<int>(e);
}

// rows 0: 16-row tiles (4 warps in a row), 1: 64-row tiles (2 x 2 warps),
// 2: 128-row tiles (4 x 2 warps, a 3-stage ring: 88 KB, two blocks an SM)
template <typename T, int EPI>
int launch_mma_rows(int rows, const void* x, const void* q, const float* s,
                    void* out, float* ws, int M, int N, int K, int splits,
                    int kt_per, cudaStream_t st) {
  if (rows == 0)
    return launch_mma<T, 1, 4, 1, 4, EPI>(x, q, s, out, ws, M, N, K, splits,
                                          kt_per, st);
  if (rows == 1)
    return launch_mma<T, 2, 2, 2, 4, EPI>(x, q, s, out, ws, M, N, K, splits,
                                          kt_per, st);
  if (rows == 2)
    return launch_mma<T, 4, 2, 2, 3, EPI>(x, q, s, out, ws, M, N, K, splits,
                                          kt_per, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename WT, bool NK>
int launch_simt(const void* x, const void* w, const float* s, void* out,
                float* ws, int M, int N, int K, int splits, int kt_per,
                cudaStream_t st) {
  using L = SgTile<WT, NK>;
  static size_t done[LT_MAX_DEVICES];
  cudaError_t e =
      lt_set_max_smem(weight_gemm_simt_kernel<WT, NK>, L::SMEM, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + SG_BM - 1) / SG_BM, (N + SG_BN - 1) / SG_BN, splits);
  weight_gemm_simt_kernel<WT, NK><<<grid, SG_THREADS, L::SMEM, st>>>(
      static_cast<const float*>(x), static_cast<const WT*>(w), s,
      static_cast<float*>(out), splits > 1 ? ws : nullptr, M, N, K, kt_per);
  e = cudaGetLastError();
  if (e == cudaSuccess && splits > 1)
    e = combine<float, EPI_F32>(ws, s, out, M, N, splits, st);
  return static_cast<int>(e);
}

bool bad_shape(int M, int N, int K) {
  return M <= 0 || N <= 0 || K <= 0 || N % 16 != 0 || K % 16 != 0;
}

}  // namespace

// Tensor-core route. x [M, K] in `dtype` (bf16 or f16), q [K, N] int8, s
// [N] f32; epi 0 (EPI_ROUND): out [M, N] in dtype, the reference's
// qmatmul; epi 1 (EPI_F32, bf16 only): out [M, N] f32 = sums * s, the int8
// head. rows: the block's rows, 0: 16 (decode), 1: 64, 2: 128. ws: f32
// [splits * M * N] when splits > 1; split z sums K tiles [z*kt_per,
// (z+1)*kt_per) of 64.
extern "C" int weight_gemm_mma_launch(int dtype, int epi, int rows,
                                      const void* x, const void* q,
                                      const void* s, void* out, void* ws,
                                      int M, int N, int K, int splits,
                                      int kt_per, void* stream) {
  if (bad_shape(M, N, K) || bad_split(K, TC_BK, splits, kt_per, ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(s);
  float* w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == WG_BF16 && epi == EPI_ROUND)
    return launch_mma_rows<__nv_bfloat16, EPI_ROUND>(rows, x, q, sc, out, w, M,
                                                     N, K, splits, kt_per, st);
  if (dtype == WG_BF16 && epi == EPI_F32)
    return launch_mma_rows<__nv_bfloat16, EPI_F32>(rows, x, q, sc, out, w, M,
                                                   N, K, splits, kt_per, st);
  if (dtype == WG_F16 && epi == EPI_ROUND)
    return launch_mma_rows<__half, EPI_ROUND>(rows, x, q, sc, out, w, M, N, K,
                                              splits, kt_per, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// SIMT route (f32 activations). x [M, K] f32; w in `wdtype` (int8, bf16 or
// f16): [K, N] row-major (nk = 0) or the transpose of a row-major [N, K]
// (nk = 1, bf16/f16 only); s [N] f32 or null; out [M, N] f32 = (x @ w) * s.
// ws and (splits, kt_per) as above, over K tiles of 16.
extern "C" int weight_gemm_simt_launch(int wdtype, int nk, const void* x,
                                       const void* w, const void* s,
                                       void* out, void* ws, int M, int N,
                                       int K, int splits, int kt_per,
                                       void* stream) {
  if (bad_shape(M, N, K) || bad_split(K, SG_BK, splits, kt_per, ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(s);
  float* wsp = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wdtype == WG_I8 && !nk)
    return launch_simt<int8_t, false>(x, w, sc, out, wsp, M, N, K, splits,
                                      kt_per, st);
  if (wdtype == WG_BF16)
    return nk ? launch_simt<__nv_bfloat16, true>(x, w, sc, out, wsp, M, N, K,
                                                 splits, kt_per, st)
              : launch_simt<__nv_bfloat16, false>(x, w, sc, out, wsp, M, N,
                                                  K, splits, kt_per, st);
  if (wdtype == WG_F16)
    return nk ? launch_simt<__half, true>(x, w, sc, out, wsp, M, N, K, splits,
                                          kt_per, st)
              : launch_simt<__half, false>(x, w, sc, out, wsp, M, N, K,
                                           splits, kt_per, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
