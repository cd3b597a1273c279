// Causal GQA flash attention for prefill.
//
// Replaces: localai_tpu/ops/pallas/flash_attention.py flash_prefill
// (_prefill_kernel). Same function: q [B,S,H,D], k/v [B,S,KVH,D] in bf16 or
// f32, per-row `lengths`, optional sliding window; online softmax in f32;
// KV tiles past the query tile are skipped; a fully masked row stays finite
// through the 1e-30 floor on the denominator; padding rows are don't-care.
//
// What bounds it on the H100: at the main path's S=512 prefill the work is
// O(S^2 D) multiply-adds against O(S D) bytes, so the bound is operations
// (bf16 tensor-core peak). This first version is deliberately simple and
// does NOT reach that bound: one block of 128 threads per (query tile of
// 32 rows, q head, batch row) stages Q, K and V tiles in shared memory as
// f32 and computes scores and the value product with scalar FMAs (4
// threads per query row, each owning every 4th key and every 4th output
// channel). The f32 path therefore never touches TF32. It loops over KV
// tiles only up to the causal limit of its query tile and the row's
// length, and skips tiles wholly before a sliding window. A wgmma/TMA
// version is later work.
#include "common.cuh"

namespace {

constexpr int BQ = 32;       // query rows per block
constexpr int BK = 32;       // keys per tile
constexpr int NT = 128;      // threads: 4 per query row
constexpr int MAXD4 = 32;    // head_dim / 4 held per thread (D <= 128)

template <typename T>
__global__ void __launch_bounds__(NT)
    prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   T* __restrict__ out, int S, int H, int KVH, int D,
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
  const T* kbase = k + static_cast<int64_t>(b) * S * kv_row +
                   static_cast<int64_t>(kh) * D;
  const T* vbase = v + static_cast<int64_t>(b) * S * kv_row +
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
    T* o = out + (static_cast<int64_t>(b) * S + qpos) * q_row +
           static_cast<int64_t>(h) * D + c;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < MAXD4; ++i)
      if (i < nd) o[4 * i] = lt_from_f<T>(acc[i] / den);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int B, int S, int H, int KVH, int D, int window,
           float scale, cudaStream_t stream) {
  const int ld = D + 1;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(BQ + 2 * BK) * ld + BQ * (BK + 1));
  cudaError_t e = cudaFuncSetAttribute(
      prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + BQ - 1) / BQ, H, B);
  prefill_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), S, H, KVH, D,
      scale, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_prefill_launch(int dtype, const void* q, const void* k,
                                    const void* v, const int* lengths,
                                    void* out, int B, int S, int H, int KVH,
                                    int D, int window, float scale,
                                    void* stream) {
  if (D > 4 * MAXD4 || D % 4 != 0 || H % KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == LT_BF16)
    return launch<__nv_bfloat16>(q, k, v, lengths, out, B, S, H, KVH, D,
                                 window, scale, st);
  if (dtype == LT_F32)
    return launch<float>(q, k, v, lengths, out, B, S, H, KVH, D, window,
                         scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
