// Decode-step GQA attention over the per-slot KV cache, in two storage
// variants and two layouts.
//
// Replaces: localai_tpu/ops/pallas/flash_attention.py
//   - ragged_decode, dense mode (_decode_kernel): bf16/f32 caches;
//   - ragged_decode_q8, dense mode (_decode_q8_kernel): int8 caches with
//     per-token f32 scales stored [B, KVH, T//128, 128] (token t's scale is
//     element t of the slot/head's flattened scale strip);
//   - ragged_decode and ragged_decode_q8, paged mode (_decode_kernel_paged,
//     _decode_q8_kernel_paged): the caches are a block pool [NB, KVH, 128,
//     D] (int8 scales [NB, KVH, 1, 128]) read through a block table [B,
//     MAXB] int32; virtual token t of slot b lives in block table[b,
//     t/128], row t%128, and T = MAXB*128.
// Same function: one query token per slot, q [B,1,H,D] against caches
// [B,KVH,T,D]; `lengths` counts valid entries INCLUDING the new token;
// optional sliding window; online softmax in f32 with the 1e-30 floor. The
// q8 variant applies the K scale to the score columns and the V scale to p
// before the value product, exactly as _decode_q8_kernel does (l sums the
// unscaled p).
//
// What bounds it on the H100: decode reads every valid K/V byte once and
// does 4 flops per byte or fewer, so the bound is the K/V bytes actually
// read over 3.35 TB/s. Design: one block of 128 threads per (slot, KV
// head); the G = H/KVH query heads of the group share each 32-token K/V
// tile staged in shared memory (16-byte vector loads). The block walks
// only ceil(len/32) tiles and never reads a row at or past `len` (masked
// loads stand in for the Pallas zeroing of the partial tile) — the
// O(valid tokens) property the Pallas index-map clamp provides. Paged
// mode is the same kernel (template flag PAGED): a 32-token tile never
// straddles a 128-token block, so each tile reads one table entry,
// table[b, t0/128], and only for t0 < len — a block reads table entries
// below ceil(len/128) only, which keeps the O(valid tokens) property of the
// Pallas index-map clamp. Known limit: at the main path's 4 slots x 8 KV
// heads that is 32 blocks on 132 SMs, so most of the card idles; split-KV
// across blocks is later work.
#include "common.cuh"

namespace {

constexpr int BK = 32;     // tokens per tile (one per lane in the softmax)
constexpr int NT = 128;    // 4 warps
constexpr int MAXO = 8;    // outputs per thread: G * D <= NT * MAXO
constexpr int PBS = 128;   // paged block size (tokens); PBS % BK == 0

template <typename T, typename KV, bool Q8, bool PAGED>
__global__ void __launch_bounds__(NT)
    decode_kernel(const T* __restrict__ q, const KV* __restrict__ kc,
                  const KV* __restrict__ vc, const float* __restrict__ ks,
                  const float* __restrict__ vs,
                  const int* __restrict__ lengths,
                  const int* __restrict__ table, T* __restrict__ out, int H,
                  int KVH, int Tlen, int D, float scale, int window) {
  extern __shared__ float smem[];
  const int G = H / KVH;
  const int ld = D + 1;
  float* Qs = smem;            // [G][ld], pre-scaled
  float* Ks = Qs + G * ld;     // [BK][ld]
  float* Vs = Ks + BK * ld;    // [BK][ld]
  float* Ps = Vs + BK * ld;    // [G][BK] scores, then p (times v scale)
  float* Ms = Ps + G * BK;     // [G] running max
  float* Ls = Ms + G;          // [G] running denominator
  float* Al = Ls + G;          // [G] this tile's rescale factor
  float* Sk = Al + G;          // [BK] k scales (q8)
  float* Sv = Sk + BK;         // [BK] v scales (q8)

  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(lengths[b], Tlen);
  const int64_t slot = static_cast<int64_t>(b) * KVH + kh;
  const int maxb = Tlen / PBS;  // table width (paged)

  lt_load_tile(Qs, ld, q + (static_cast<int64_t>(b) * H + kh * G) * D, D, G,
               G, D, scale);
  for (int g = tid; g < G; g += NT) {
    Ms[g] = LT_NEG_INF;
    Ls[g] = 0.f;
  }
  float acc[MAXO];
#pragma unroll
  for (int i = 0; i < MAXO; ++i) acc[i] = 0.f;

  const int nt = (len + BK - 1) / BK;
  int t_start = 0;
  if (window > 0 && len - window > 0) t_start = (len - window) / BK;

  for (int kb = t_start; kb < nt; ++kb) {
    const int t0 = kb * BK;
    const int valid = min(BK, len - t0);
    // first row of this tile: dense [B, KVH, T] rows, or paged block
    // table[b, t0/128] of the pool's [NB, KVH, 128] rows
    int64_t row0;
    if (PAGED) {
      const int64_t pb = table[static_cast<int64_t>(b) * maxb + t0 / PBS];
      row0 = (pb * KVH + kh) * PBS + t0 % PBS;
    } else {
      row0 = slot * Tlen + t0;
    }
    __syncthreads();  // previous tile consumed (and Q / state visible)
    lt_load_tile(Ks, ld, kc + row0 * D, D, BK, valid, D, 1.f);
    lt_load_tile(Vs, ld, vc + row0 * D, D, BK, valid, D, 1.f);
    if (Q8) {
      // scales: element t of the slot's strip (dense) or row t%128 of the
      // block's [1, 128] scale row (paged) — both sit at row0 + i
      for (int i = tid; i < BK; i += NT) {
        Sk[i] = i < valid ? ks[row0 + i] : 0.f;
        Sv[i] = i < valid ? vs[row0 + i] : 0.f;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * BK; idx += NT) {
      const int g = idx / BK, j = idx - g * BK;
      const float* qr = Qs + g * ld;
      const float* kr = Ks + j * ld;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
      if (Q8) s *= Sk[j];
      const int kpos = t0 + j;
      const bool ok = kpos < len && (window <= 0 || kpos >= len - window);
      Ps[idx] = ok ? s : LT_NEG_INF;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NT / 32) {
      const float s = Ps[g * BK + lane];
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, lt_warp_max(s));
      const float p = expf(s - m_new);
      const float psum = lt_warp_sum(p);
      Ps[g * BK + lane] = Q8 ? p * Sv[lane] : p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Ls[g] = Ls[g] * alpha + psum;
        Ms[g] = m_new;
        Al[g] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < MAXO; ++i) {
      const int idx = tid + i * NT;
      if (idx < G * D) {
        const int g = idx / D, d = idx - g * D;
        const float* pr = Ps + g * BK;
        float a = acc[i] * Al[g];
        for (int j = 0; j < BK; ++j) a += pr[j] * Vs[j * ld + d];
        acc[i] = a;
      }
    }
  }
  __syncthreads();  // final denominators visible

#pragma unroll
  for (int i = 0; i < MAXO; ++i) {
    const int idx = tid + i * NT;
    if (idx < G * D) {
      const int g = idx / D, d = idx - g * D;
      out[(static_cast<int64_t>(b) * H + kh * G + g) * D + d] =
          lt_from_f<T>(acc[i] / fmaxf(Ls[g], 1e-30f));
    }
  }
}

template <typename T, typename KV, bool Q8, bool PAGED>
int launch(const void* q, const void* kc, const void* vc, const float* ks,
           const float* vs, const int* lengths, const int* table, void* out,
           int B, int H, int KVH, int Tlen, int D, int window, float scale,
           cudaStream_t stream) {
  const int G = H / KVH;
  const int ld = D + 1;
  const size_t smem = sizeof(float) * (static_cast<size_t>(G + 2 * BK) * ld +
                                       G * BK + 3 * G + 2 * BK);
  cudaError_t e = cudaFuncSetAttribute(
      decode_kernel<T, KV, Q8, PAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(KVH, B);
  decode_kernel<T, KV, Q8, PAGED><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kc),
      static_cast<const KV*>(vc), ks, vs, lengths, table,
      static_cast<T*>(out), H, KVH, Tlen, D, scale, window);
  return static_cast<int>(cudaGetLastError());
}

bool bad_geometry(int H, int KVH, int D) {
  return KVH <= 0 || H % KVH != 0 || D % 16 != 0 ||
         (H / KVH) * D > NT * MAXO;
}

// Dispatch on dtype and storage; Tlen is T (dense) or MAXB*128 (paged).
template <bool Q8, bool PAGED>
int dispatch(int dtype, const void* q, const void* kc, const void* vc,
             const float* ks, const float* vs, const int* lengths,
             const int* table, void* out, int B, int H, int KVH, int Tlen,
             int D, int window, float scale, void* stream) {
  if (bad_geometry(H, KVH, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // if constexpr: each (Q8, PAGED) pair instantiates only its own KV type
  if constexpr (Q8) {
    if (dtype == LT_BF16)
      return launch<__nv_bfloat16, int8_t, Q8, PAGED>(
          q, kc, vc, ks, vs, lengths, table, out, B, H, KVH, Tlen, D, window,
          scale, st);
    if (dtype == LT_F32)
      return launch<float, int8_t, Q8, PAGED>(q, kc, vc, ks, vs, lengths,
                                              table, out, B, H, KVH, Tlen, D,
                                              window, scale, st);
  } else {
    if (dtype == LT_BF16)
      return launch<__nv_bfloat16, __nv_bfloat16, Q8, PAGED>(
          q, kc, vc, ks, vs, lengths, table, out, B, H, KVH, Tlen, D, window,
          scale, st);
    if (dtype == LT_F32)
      return launch<float, float, Q8, PAGED>(q, kc, vc, ks, vs, lengths,
                                             table, out, B, H, KVH, Tlen, D,
                                             window, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* kc, const void* vc,
                                       const int* lengths, void* out, int B,
                                       int H, int KVH, int Tlen, int D,
                                       int window, float scale,
                                       void* stream) {
  return dispatch<false, false>(dtype, q, kc, vc, nullptr, nullptr, lengths,
                                nullptr, out, B, H, KVH, Tlen, D, window,
                                scale, stream);
}

extern "C" int decode_attention_q8_launch(int dtype, const void* q,
                                          const void* kq, const float* ks,
                                          const void* vq, const float* vs,
                                          const int* lengths, void* out,
                                          int B, int H, int KVH, int Tlen,
                                          int D, int window, float scale,
                                          void* stream) {
  return dispatch<true, false>(dtype, q, kq, vq, ks, vs, lengths, nullptr,
                               out, B, H, KVH, Tlen, D, window, scale,
                               stream);
}

// Paged: pools [NB, KVH, 128, D], table [B, MAXB] int32.
extern "C" int decode_attention_paged_launch(int dtype, const void* q,
                                             const void* kp, const void* vp,
                                             const int* table,
                                             const int* lengths, void* out,
                                             int B, int H, int KVH, int MAXB,
                                             int D, int window, float scale,
                                             void* stream) {
  return dispatch<false, true>(dtype, q, kp, vp, nullptr, nullptr, lengths,
                               table, out, B, H, KVH, MAXB * PBS, D, window,
                               scale, stream);
}

// Paged int8: pools [NB, KVH, 128, D] int8, scales [NB, KVH, 1, 128] f32.
extern "C" int decode_attention_q8_paged_launch(
    int dtype, const void* q, const void* kq, const float* ks, const void* vq,
    const float* vs, const int* table, const int* lengths, void* out, int B,
    int H, int KVH, int MAXB, int D, int window, float scale, void* stream) {
  return dispatch<true, true>(dtype, q, kq, vq, ks, vs, lengths, table, out,
                              B, H, KVH, MAXB * PBS, D, window, scale,
                              stream);
}
