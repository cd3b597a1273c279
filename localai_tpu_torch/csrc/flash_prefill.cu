// Causal GQA flash attention for prefill.
//
// Replaces: localai_tpu/ops/pallas/flash_attention.py flash_prefill
// (_prefill_kernel). Same function: q [B,S,H,D], k/v [B,S,KVH,D] in bf16 or
// f32, per-row `lengths`, optional sliding window; online softmax in f32
// with NEG_INF = -0.7 * f32max; a fully masked row stays finite through the
// 1e-30 floor on the denominator; padding rows are don't-care but finite.
//
// What bounds it on the H100: at the main path's S=512 prefill the work is
// O(S^2 D) multiply-adds against O(S D) bytes, so the bound is operations:
// the bf16 tensor cores (989 TFLOP/s dense).
//
// bf16: prefill_tc_kernel, on the tensor cores (it replaced a SIMT kernel
// that staged f32 tiles and multiplied with scalar FMAs). One warpgroup (128
// threads) per (64-row q tile, q head, batch row):
//   - S = Q K^T is a wgmma m64n64k16 per 16 columns of D, Q and the K tile
//     read from shared memory (both K-major), f32 accumulators;
//   - the online softmax runs on the S accumulator in registers (each
//     thread owns 2 rows; row max/sum over the 4 lanes of a quad); P goes
//     to bf16 in registers as the A operand of the P V wgmma (m64nDPk16, A
//     from registers, the accumulator layout of S being the A-fragment
//     layout); V's [keys, D] tile is the B operand in MN-major order (the
//     transpose bit). The Pallas kernel keeps p in f32, and one bf16
//     rounding of p put outputs 2 bf16 ulps from the plain version (past
//     the bar), so p is split into two bf16 terms, hi = bf16(p) and lo =
//     bf16(p - hi), and both multiply V (exact in bf16): p is carried to
//     about 2^-17 relative for one more wgmma per 16 keys. The
//     denominator sums the f32 p;
//   - shared memory holds bf16 tiles in the 128-byte swizzle (16-byte chunk
//     c of row r at chunk c ^ (r % 8) of a 64-column, 8 KB atom), which the
//     wgmma descriptors read without bank conflicts; D < 64 pads the atom
//     (the pad columns are never a contraction column, and P V's pad output
//     columns are never stored);
//   - K/V tiles of 64 keys are a 2-stage ring filled by 16-byte cp.async
//     (one KV head's rows are strided by KVH*D): the next tile's copy is in
//     flight while the current one is multiplied;
//   - work is skipped as before: K/V tiles past the q tile's causal limit or
//     at/past `length`, and tiles wholly before the window of the tile's
//     first row (tiles inside every row's limits skip the mask work); a q
//     tile at/past `length` computes nothing and writes zeros
//     (the next layer writes those rows' K/V into the cache, where a P of 0
//     meets them: they must be finite). K/V rows at/past `length` are
//     zero-filled, not read;
//   - GQA: one block per q head; the G heads of a group re-read their KV
//     head's tiles through the 50 MB L2 (a prompt's K/V for one KV head is
//     at most S*D*4 bytes = 256 KB at S=512), which keeps a q row one tile
//     row and the causal mask one compare.
// One instantiation per head_dim the wrapper accepts (16, 32, ..., 256).
// Above 128 a block is two warpgroups: a 64 x D f32 output accumulator
// beside the S tile and P's fragments does not fit one thread's 255
// registers, so each warpgroup keeps 128 of P V's output columns (the
// tiles are staged 256 columns wide) and both compute the same S tile and
// softmax (S's product runs in both: a third more MMA work than one).
// It uses wgmma (sm_90a) with register-level softmax, but no warp
// specialisation or intra-warpgroup overlap of softmax with the next S
// product yet.
//
// f32: prefill_simt_kernel, the port's first kernel, kept on purpose: f32
// has no tensor-core path without TF32, which would break the f32 parity
// bar of 2e-5. One block of 128 threads per (32-row q tile, q head, batch
// row) stages f32 tiles and multiplies with scalar FMAs (a thread holds D/4
// outputs: 32 up to D = 128, 64 up to 256). The launcher picks the kernel
// by dtype alone. Both take D % 16 == 0, D <= 256.
#include "common.cuh"

namespace {

// ------------------------------------------------------------------ f32

constexpr int BQ = 32;       // query rows per block
constexpr int BK = 32;       // keys per tile
constexpr int NT = 128;      // threads: 4 per query row
constexpr int MAXD = 256;    // largest head_dim, both kernels

// MAXD4: head_dim / 4 outputs held per thread, 32 (D <= 128) or 64 (D <=
// 256), so the common widths keep the smaller register file
template <int MAXD4>
__global__ void __launch_bounds__(NT)
    prefill_simt_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ lengths,
                        float* __restrict__ out, int S, int H, int KVH, int D,
                        float scale, int window) {
  extern __shared__ float smem[];
  const int ld = D + 1;  // padded rows: no bank conflicts on row walks
  float* Qs = smem;              // [BQ][ld], pre-scaled
  float* Ks = Qs + BQ * ld;      // [BK][ld]
  float* Vs = Ks + BK * ld;      // [BK][ld]
  float* Ps = Vs + BK * ld;      // [BQ][BK + 1]

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KVH);
  const int q0 = qb * BQ;
  const int len = min(lengths[b], S);
  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int nd = D >> 2;
  const int64_t q_row = static_cast<int64_t>(H) * D;
  const int64_t kv_row = static_cast<int64_t>(KVH) * D;

  lt_load_tile(Qs, ld, q + (static_cast<int64_t>(b) * S + q0) * q_row +
                           static_cast<int64_t>(h) * D,
               q_row, BQ, min(BQ, S - q0), D, scale);
  const float* kbase = k + static_cast<int64_t>(b) * S * kv_row +
                       static_cast<int64_t>(kh) * D;
  const float* vbase = v + static_cast<int64_t>(b) * S * kv_row +
                       static_cast<int64_t>(kh) * D;

  const int qpos = q0 + r;
  float m = LT_NEG_INF, l = 0.f;
  float acc[MAXD4];
#pragma unroll
  for (int i = 0; i < MAXD4; ++i) acc[i] = 0.f;

  // causal limit of this query tile, and nothing at or past the length
  const int kb_end = min((q0 + BQ + BK - 1) / BK, (len + BK - 1) / BK);
  // tiles wholly before the window of the tile's FIRST row are masked for
  // every row of the tile
  const int kb_start = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  for (int kb = kb_start; kb < kb_end; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // previous tile fully consumed (and Q visible)
    lt_load_tile(Ks, ld, kbase + k0 * kv_row, kv_row, BK, min(BK, S - k0),
                 D, 1.f);
    lt_load_tile(Vs, ld, vbase + k0 * kv_row, kv_row, BK, min(BK, S - k0),
                 D, 1.f);
    __syncthreads();

    float s[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) s[i] = 0.f;
    const float* qr = Qs + r * ld;
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) s[i] += qd * Ks[(c + 4 * i) * ld + d];
    }
    float tmax = LT_NEG_INF;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int kpos = k0 + c + 4 * i;
      const bool ok = kpos <= qpos && kpos < len &&
                      (window <= 0 || kpos > qpos - window);
      s[i] = ok ? s[i] : LT_NEG_INF;
      tmax = fmaxf(tmax, s[i]);
    }
    // the 4 threads of a query row are 4 adjacent lanes
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const float p = expf(s[i] - m_new);
      Ps[r * (BK + 1) + c + 4 * i] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();  // P visible to the whole row group

#pragma unroll
    for (int i = 0; i < MAXD4; ++i)
      if (i < nd) acc[i] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = Ps[r * (BK + 1) + j];
      const float* vr = Vs + j * ld + c;
#pragma unroll
      for (int i = 0; i < MAXD4; ++i)
        if (i < nd) acc[i] += p * vr[4 * i];
    }
  }

  if (qpos < S) {
    float* o = out + (static_cast<int64_t>(b) * S + qpos) * q_row +
               static_cast<int64_t>(h) * D + c;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < MAXD4; ++i)
      if (i < nd) o[4 * i] = acc[i] / den;
  }
}

int launch_simt(const void* q, const void* k, const void* v,
                const int* lengths, void* out, int B, int S, int H, int KVH,
                int D, int window, float scale, cudaStream_t stream) {
  const int ld = D + 1;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(BQ + 2 * BK) * ld + BQ * (BK + 1));
  auto* kernel = D <= 128 ? prefill_simt_kernel<32> : prefill_simt_kernel<64>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), lengths, static_cast<float*>(out), S, H,
      KVH, D, scale, window);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ bf16

using bf16 = __nv_bfloat16;

constexpr int TM = 64;            // q rows per tile (one wgmma M)
constexpr int TN = 64;            // keys per K/V tile
constexpr int TC_NT = 128;        // one warpgroup
constexpr int ATOM = 64 * 128;    // bytes of a 64-row, 128-byte swizzle atom

// d[64 x 64] (+)= A[64 x 16] * B[16 x 64]^T, A and B K-major in shared
// memory. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : LT_D8(d, 0), LT_D8(d, 8), LT_D8(d, 16), LT_D8(d, 24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x N] += A[64 x 16] (registers, bf16 pairs) * B[16 x N], B MN-major
// in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : LT_D8(d, 0), LT_D8(d, 8), LT_D8(d, 16), LT_D8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : LT_D8(d, 0), LT_D8(d, 8), LT_D8(d, 16), LT_D8(d, 24), LT_D8(d, 32),
        LT_D8(d, 40), LT_D8(d, 48), LT_D8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// (x, y) -> two bf16 pairs: hi = bf16(x, y), lo = bf16((x, y) - hi); .x
// (the lower column) in the low half, as the A fragment takes it.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Copy `valid` rows (of 64) of D bf16 columns, row r at src + r * stride,
// into a swizzled tile of D/64 (rounded up) atoms; rows at/past `valid`
// are zero-filled and not read. NTH threads share the copies.
template <int D, int NTH>
__device__ __forceinline__ void load_tile(uint8_t* dst, const bf16* src,
                                          int64_t stride, int valid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CPR; i += NTH) {
    const int r = i / CPR, c = i - r * CPR;
    const bool ok = r < valid;
    lt_cp_async16(dst + (c >> 3) * ATOM + r * 128 + (((c & 7) ^ (r & 7)) << 4),
                  src + (ok ? r * stride : 0) + c * 8, ok);
  }
}

// Warpgroups of the kernel for head_dim D: one up to 128; two above, which
// split P V's output columns (a 64 x 256 f32 accumulator is 128 registers
// a thread, with the S tile and P's fragments past the 255 a thread has).
template <int D>
__host__ __device__ constexpr int tc_nwg() {
  return D > 128 ? 2 : 1;
}
// Staged columns: whole atoms; above 128 always 256, so each warpgroup's
// 128 output columns start on an atom (pad columns are never a contraction
// column of Q K^T, and P V's pad output columns are never stored).
template <int D>
__host__ __device__ constexpr int tc_dp() {
  return D > 128 ? 256 : (D + 63) / 64 * 64;
}

template <int D>
__global__ void __launch_bounds__(TC_NT * tc_nwg<D>())
    prefill_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int* __restrict__ lengths, bf16* __restrict__ out,
                      int S, int H, int KVH, float scale, int window) {
  constexpr int NWG = tc_nwg<D>(), NTH = TC_NT * NWG;
  constexpr int DP = tc_dp<D>();
  constexpr int OC = DP / NWG;            // P V output columns a warpgroup
  constexpr int TILE = DP / 64 * ATOM;    // bytes of a 64-row tile
  constexpr int KSTEPS = D / 16;          // wgmma k-steps of Q K^T
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is on address bits, so atoms sit on 1024-byte boundaries
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(
      smem_raw));
  uint8_t* smem = smem_raw + ((1024 - (base & 1023)) & 1023);
  uint8_t* Qs = smem;  // then K, V of stage 0, K, V of stage 1

  // grid (H, q tiles, B): the blocks start in order of the longest causal
  // spans first, the heads of one q tile side by side
  const int h = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KVH);
  const int q0 = qt * TM;
  const int len = max(0, min(lengths[b], S));
  // warpgroup wg computes the whole S tile (both compute the same) and P
  // V's columns [wg*OC, wg*OC + OC); warp is the warp within it
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = NWG == 1 ? 0 : tid / TC_NT;
  const int warp = NWG == 1 ? tid >> 5 : (tid >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t q_row = static_cast<int64_t>(H) * D;
  const int64_t kv_row = static_cast<int64_t>(KVH) * D;
  bf16* obase = out + static_cast<int64_t>(b) * S * q_row +
                static_cast<int64_t>(h) * D;

  if (q0 >= len) {  // padding rows only: write finite zeros
    for (int i = tid; i < TM * (D / 8); i += NTH) {
      const int r = i / (D / 8), c = i - r * (D / 8);
      if (q0 + r < S)
        *reinterpret_cast<uint4*>(obase + (q0 + r) * q_row + c * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  // causal limit of the tile, nothing at/past the length; tiles wholly
  // before the window of the tile's first row are masked for every row
  const int kb_end = min(qt + 1, (len + TN - 1) / TN);
  const int kb_start = window > 0 ? max(0, q0 - window + 1) / TN : 0;
  const bf16* kbase = k + static_cast<int64_t>(b) * S * kv_row +
                      static_cast<int64_t>(kh) * D;
  const bf16* vbase = v + static_cast<int64_t>(b) * S * kv_row +
                      static_cast<int64_t>(kh) * D;
  auto load_kv = [&](int kb, int st) {
    const int64_t off = static_cast<int64_t>(kb) * TN * kv_row;
    const int valid = min(TN, len - kb * TN);
    load_tile<D, NTH>(smem + TILE * (1 + 2 * st), kbase + off, kv_row,
                      valid);
    load_tile<D, NTH>(smem + TILE * (2 + 2 * st), vbase + off, kv_row,
                      valid);
  };

  load_tile<D, NTH>(Qs, q + (static_cast<int64_t>(b) * S + q0) * q_row +
                            static_cast<int64_t>(h) * D,
                    q_row, min(TM, S - q0));
  load_kv(kb_start, 0);
  lt_cp_async_commit();

  const int qp0 = q0 + warp * 16 + g, qp1 = qp0 + 8;  // this thread's rows
  float o[OC / 2];
#pragma unroll
  for (int i = 0; i < OC / 2; ++i) o[i] = 0.f;
  float m0 = LT_NEG_INF, m1 = LT_NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int kb = kb_start; kb < kb_end; ++kb) {
    const int st = (kb - kb_start) & 1;
    if (kb + 1 < kb_end) load_kv(kb + 1, st ^ 1);
    lt_cp_async_commit();     // (possibly empty) group of tile kb + 1
    lt_cp_async_wait<1>();    // tile kb (and Q) landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint8_t* Ks = smem + TILE * (1 + 2 * st);
    const uint8_t* Vs = Ks + TILE;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    lt_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int off = (kk >> 2) * ATOM + (kk & 3) * 32;
      wgmma_ss_n64(s, lt_smem_desc(Qs + off, 16, 1024),
                   lt_smem_desc(Ks + off, 16, 1024), kk > 0);
    }
    lt_wgmma_commit();
    lt_wgmma_wait<0>();
    lt_fence_regs(s);

    // masks and the online softmax, on the accumulator: s[4j + e] is row
    // qp0, key 8j + 2*t4 + e; s[4j + 2 + e] is row qp1, the same key
    const int k0 = kb * TN;
    // a tile below the diagonal, the length and the window of every row
    // of the q tile (most tiles of a long prompt) needs no mask
    const bool unmasked = k0 + TN - 1 <= q0 && k0 + TN <= len &&
                          (window <= 0 || k0 > q0 + TM - 1 - window);
    float mx0 = m0, mx1 = m1;
    if (unmasked) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + 2 * t4 + e;
          const bool ok0 = kp <= qp0 && kp < len &&
                           (window <= 0 || kp > qp0 - window);
          const bool ok1 = kp <= qp1 && kp < len &&
                           (window <= 0 || kp > qp1 - window);
          s[4 * j + e] = ok0 ? s[4 * j + e] * scale : LT_NEG_INF;
          s[4 * j + 2 + e] = ok1 ? s[4 * j + 2 + e] * scale : LT_NEG_INF;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = __expf(m0 - mx0), a1 = __expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    // P as the A fragments of the P V product, in two bf16 terms
    uint32_t hi[16], lo[16];
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p00 = __expf(s[4 * j] - m0), p01 = __expf(s[4 * j + 1] - m0);
      const float p10 = __expf(s[4 * j + 2] - m1);
      const float p11 = __expf(s[4 * j + 3] - m1);
      r0 += p00 + p01;
      r1 += p10 + p11;
      split_bf16(p00, p01, hi[2 * j], lo[2 * j]);
      split_bf16(p10, p11, hi[2 * j + 1], lo[2 * j + 1]);
    }
    l0 = l0 * a0 + r0;  // per-thread partial sums; the quad adds at the end
    l1 = l1 * a1 + r1;
#pragma unroll
    for (int j = 0; j < OC / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }

    lt_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TN / 16; ++kk) {  // 16 keys: 2 groups of 8 V rows
      const uint64_t dv =
          lt_smem_desc(Vs + wg * (OC / 64) * ATOM + kk * 2048, ATOM, 1024);
      wgmma_rs(o, hi + 4 * kk, dv);
      wgmma_rs(o, lo + 4 * kk, dv);
    }
    lt_wgmma_commit();
    lt_wgmma_wait<0>();
    lt_fence_regs(o);
    __syncthreads();  // stage st consumed before it is refilled
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < OC / 8; ++j) {
    if (wg * OC + 8 * j >= D) continue;  // a pad column (D % 8 == 0)
    const int col = wg * OC + 8 * j + 2 * t4;
    if (qp0 < S)
      *reinterpret_cast<__nv_bfloat162*>(obase + qp0 * q_row + col) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (qp1 < S)
      *reinterpret_cast<__nv_bfloat162*>(obase + qp1 * q_row + col) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v,
              const int* lengths, void* out, int B, int S, int H, int KVH,
              int window, float scale, cudaStream_t stream) {
  constexpr int TILE = tc_dp<D>() / 64 * ATOM;
  constexpr int smem = 1024 + 5 * TILE;  // alignment slack, Q, 2 x (K, V)
  static size_t smem_set[LT_MAX_DEVICES] = {};
  const cudaError_t e = lt_set_max_smem(prefill_tc_kernel<D>, smem, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(H, (S + TM - 1) / TM, B);
  prefill_tc_kernel<D><<<grid, TC_NT * tc_nwg<D>(), smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), lengths, static_cast<bf16*>(out), S, H,
      KVH, scale, window);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v,
                const int* lengths, void* out, int B, int S, int H, int KVH,
                int D, int window, float scale, cudaStream_t st) {
  switch (D) {
#define LT_CASE(d)                                                       \
  case d:                                                                \
    return launch_tc<d>(q, k, v, lengths, out, B, S, H, KVH, window, scale, \
                        st);
    LT_CASE(16) LT_CASE(32) LT_CASE(48) LT_CASE(64)
    LT_CASE(80) LT_CASE(96) LT_CASE(112) LT_CASE(128)
    LT_CASE(144) LT_CASE(160) LT_CASE(176) LT_CASE(192)
    LT_CASE(208) LT_CASE(224) LT_CASE(240) LT_CASE(256)
#undef LT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int flash_prefill_launch(int dtype, const void* q, const void* k,
                                    const void* v, const int* lengths,
                                    void* out, int B, int S, int H, int KVH,
                                    int D, int window, float scale,
                                    void* stream) {
  if (D <= 0 || D > MAXD || D % 16 != 0 || KVH <= 0 || H % KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == LT_BF16)
    return launch_bf16(q, k, v, lengths, out, B, S, H, KVH, D, window, scale,
                       st);
  if (dtype == LT_F32)
    return launch_simt(q, k, v, lengths, out, B, S, H, KVH, D, window, scale,
                       st);
  return static_cast<int>(cudaErrorInvalidValue);
}
