// Ragged paged attention: one flat token stream of mixed prefill chunks and
// decode rows, each row attending to its own sequence's paged KV through
// the block table.
//
// Replaces: localai_tpu/ops/pallas/ragged_attention.py
//   - ragged_paged_attention (_ragged_kernel): bf16/f32 pools [NB, KVH, 128,
//     D];
//   - ragged_paged_attention_q8 (_ragged_q8_kernel): int8 pools with
//     per-token f32 scales [NB, KVH, 1, 128].
// Same function: q [T, H, D] (T % 8 == 0) in 8-row q blocks, each owned by
// one sequence (block_seq [T/8], -1 = dead block); sequence s covers rows
// qstart[s] .. qstart[s]+qlen[s]-1 and attends to its first kvlen[s] cache
// tokens (this tick's rows already written), row r of it at position
// q_pos = kvlen - qlen + (r - qstart); mask kv_pos <= q_pos, kv_pos <
// kvlen and, with a window, kv_pos > q_pos - window; online softmax in f32
// with NEG_INF = -0.7 f32max and the 1e-30 floor on the denominator. The
// q8 variant applies the K scale to the score columns and the V scale to p
// before the value product (l sums the unscaled p), as _ragged_q8_kernel
// does. Rows of a block outside its sequence's span, and every row of a
// dead block, are written as 0 (the reference's finish of an empty
// accumulator); callers ignore them.
//
// What bounds it on the H100: every sequence's K/V below its length has to
// be read once (plus q, out and the table entries), at 4 flops per K/V
// element and q-row pair; at the serving shapes (mostly decode rows) that is
// far below the card's ops:byte line, so bytes bound it. Design, simple
// first: one block of 256 threads per (q block, KV head, head group), the
// Pallas grid's (T/8, KVH) axes and a third over groups of at most GC =
// min(G, max(1, 512 / D)) of the KV head's G query heads (GC*D <= 512, so a
// block's QBLK*GC*D outputs fit its threads' registers at any G: G = 4 at D
// = 128 is one group, G = 7 is 4 + 3, G = 16 four of 4). The group's
// query rows (row c is token c/G', head g0 + c%G' of the KV head's G, G'
// the group's own count; with one group this is _q_blocked's row r = token
// r/G, head r%G) share each 32-token K/V tile staged in shared memory, and
// each output row goes back to its (token, head) of q's [T, H, D] layout.
// The Pallas kernel's sequential KV-block axis becomes a loop inside the
// block. With more than one group, each group's blocks read the
// same K/V tiles, the second time mostly from the 50 MB L2. The loop runs
// only over tiles below min(kvlen, the block's last q_pos + 1) (and, with a
// window, from the first q_pos's window start), which is exact: a tile the
// mask hides from every row adds nothing. A 32-token tile never straddles a
// 128-token block, so each tile reads one table entry, tables[s, t0/128],
// always below ceil(kvlen/128) — the O(valid tokens) property of the
// Pallas index-map clamp, and no read of a column past the allocation. Only
// the block's live rows are computed (one token's G rows for a decode
// block). Known limits, for later work: a prefill chunk's q blocks each
// re-read the same KV (16 times for a 128-token chunk), and a long decode
// row serializes in one block; split-KV and tensor cores would fix both.
#include "common.cuh"

namespace {

constexpr int QBLK = 8;    // q rows per block (the reference's QBLK)
constexpr int BK = 32;     // tokens per tile (one per lane in the softmax)
constexpr int NT = 256;    // 8 warps
constexpr int MAXO = 16;   // outputs per thread: QBLK * GC * D <= NT * MAXO
constexpr int MAXD = NT * MAXO / QBLK;  // largest head_dim (GC = 1): 512

// Query heads of one block: GC of the KV head's G, GC*D <= NT*MAXO/QBLK.
__host__ __device__ __forceinline__ int head_group(int G, int D) {
  const int c = D < MAXD ? MAXD / D : 1;
  return G < c ? G : c;
}
constexpr int PBS = 128;   // paged block size (tokens); PBS % BK == 0

// Stage query rows into shared memory as f32 times `scale`: compact row c
// is token t_lo + c/G, head h0 + c%G of the flat stream (G heads from h0).
// 16-byte loads (the wrapper checks D % 16 == 0 and 16-byte alignment).
template <typename T>
__device__ __forceinline__ void load_q(float* Qs, int ld,
                                       const T* __restrict__ q, int row0,
                                       int t_lo, int nr, int G, int H, int h0,
                                       int D, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_row = D / VEC;
  for (int i = threadIdx.x; i < nr * per_row; i += blockDim.x) {
    const int c = i / per_row;
    const int col = (i - c * per_row) * VEC;
    const int t = t_lo + c / G, g = c - (c / G) * G;
    const T* src =
        q + (static_cast<int64_t>(row0 + t) * H + h0 + g) * D + col;
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
    float* d = Qs + c * ld + col;
#pragma unroll
    for (int j = 0; j < VEC; ++j) d[j] = lt_to_f(e[j]) * scale;
  }
}

// GROUPED: blockIdx.z is the head group (GC = head_group(G, D) heads);
// otherwise the block takes all G heads, the case of every G*D <= 512,
// compiled without the group arithmetic.
template <typename T, typename KV, bool Q8, bool GROUPED>
__global__ void __launch_bounds__(NT)
    ragged_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                  const KV* __restrict__ vp, const float* __restrict__ ks,
                  const float* __restrict__ vs,
                  const int* __restrict__ block_seq,
                  const int* __restrict__ qstart,
                  const int* __restrict__ qlen, const int* __restrict__ kvlen,
                  const int* __restrict__ tables, T* __restrict__ out, int H,
                  int KVH, int MAXB, int D, float scale, int window) {
  extern __shared__ float smem[];
  const int GA = H / KVH;  // the KV head's query heads
  const int kh = blockIdx.y;
  const int g0 = GROUPED ? blockIdx.z * head_group(GA, D) : 0;
  const int G = GROUPED ? min(head_group(GA, D), GA - g0) : GA;  // its heads
  const int h0 = kh * GA + g0;                    // its first q head
  const int R = QBLK * G;
  const int ld = D + 1;
  float* Qs = smem;            // [R][ld], pre-scaled
  float* Ks = Qs + R * ld;     // [BK][ld]
  float* Vs = Ks + BK * ld;    // [BK][ld]
  float* Ps = Vs + BK * ld;    // [R][BK] scores, then p (times v scale)
  float* Ms = Ps + R * BK;     // [R] running max
  float* Ls = Ms + R;          // [R] running denominator
  float* Al = Ls + R;          // [R] this tile's rescale factor
  float* Sk = Al + R;          // [BK] k scales (q8)
  float* Sv = Sk + BK;         // [BK] v scales (q8)

  const int qb = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = qb * QBLK;
  const int s_raw = block_seq[qb];
  const int s = max(s_raw, 0);  // never index with -1
  const int klen = kvlen[s], qs = qstart[s], ql = qlen[s];
  // the block's live tokens [t_lo, t_hi): rows inside the sequence's span
  int t_lo = max(qs - row0, 0), t_hi = min(qs + ql - row0, QBLK);
  if (s_raw < 0 || t_hi <= t_lo) t_lo = t_hi = 0;
  const int nr = (t_hi - t_lo) * G;
  const int qpos0 = klen - ql + (row0 - qs);   // q_pos of token 0
  // tiles: up to the last live row's q_pos (causal) and kvlen; with a
  // window, from the first live row's window start
  int kv_end = nr > 0 ? min(min(klen, qpos0 + t_hi), MAXB * PBS) : 0;
  int kv_begin = 0;
  if (window > 0) kv_begin = max(qpos0 + t_lo - window + 1, 0);

  load_q(Qs, ld, q, row0, t_lo, nr, G, H, h0, D, scale);
  for (int r = tid; r < nr; r += NT) {
    Ms[r] = LT_NEG_INF;
    Ls[r] = 0.f;
  }
  float acc[MAXO];
#pragma unroll
  for (int i = 0; i < MAXO; ++i) acc[i] = 0.f;

  const int64_t tab0 = static_cast<int64_t>(s) * MAXB;
  for (int t0 = (kv_begin / BK) * BK; t0 < kv_end; t0 += BK) {
    const int valid = min(BK, kv_end - t0);
    const int64_t pb = tables[tab0 + t0 / PBS];
    const int64_t rowk = (pb * KVH + kh) * PBS + t0 % PBS;
    __syncthreads();  // previous tile consumed (and Q / state visible)
    lt_load_tile(Ks, ld, kp + rowk * D, D, BK, valid, D, 1.f);
    lt_load_tile(Vs, ld, vp + rowk * D, D, BK, valid, D, 1.f);
    if (Q8) {
      // row t0%128 + i of the block's [1, 128] scale row sits at rowk + i
      for (int i = tid; i < BK; i += NT) {
        Sk[i] = i < valid ? ks[rowk + i] : 0.f;
        Sv[i] = i < valid ? vs[rowk + i] : 0.f;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < nr * BK; idx += NT) {
      const int c = idx / BK, j = idx - c * BK;
      const float* qr = Qs + c * ld;
      const float* kr = Ks + j * ld;
      float sc = 0.f;
      for (int d = 0; d < D; ++d) sc += qr[d] * kr[d];
      if (Q8) sc *= Sk[j];
      const int qpos = qpos0 + t_lo + c / G;
      const int kpos = t0 + j;
      const bool ok = j < valid && kpos <= qpos &&
                      (window <= 0 || kpos > qpos - window);
      Ps[idx] = ok ? sc : LT_NEG_INF;
    }
    __syncthreads();

    for (int c = warp; c < nr; c += NT / 32) {
      const float sc = Ps[c * BK + lane];
      const float m_old = Ms[c];
      const float m_new = fmaxf(m_old, lt_warp_max(sc));
      const float p = expf(sc - m_new);
      const float psum = lt_warp_sum(p);
      Ps[c * BK + lane] = Q8 ? p * Sv[lane] : p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Ls[c] = Ls[c] * alpha + psum;
        Ms[c] = m_new;
        Al[c] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < MAXO; ++i) {
      const int idx = tid + i * NT;
      if (idx < nr * D) {
        const int c = idx / D, d = idx - c * D;
        const float* pr = Ps + c * BK;
        float a = acc[i] * Al[c];
        for (int j = 0; j < BK; ++j) a += pr[j] * Vs[j * ld + d];
        acc[i] = a;
      }
    }
  }
  __syncthreads();  // final denominators visible

#pragma unroll
  for (int i = 0; i < MAXO; ++i) {
    const int idx = tid + i * NT;
    if (idx < nr * D) {
      const int c = idx / D, d = idx - c * D;
      const int t = t_lo + c / G, g = c - (c / G) * G;
      out[(static_cast<int64_t>(row0 + t) * H + h0 + g) * D + d] =
          lt_from_f<T>(acc[i] / fmaxf(Ls[c], 1e-30f));
    }
  }
  // rows outside the live span: zero
  for (int idx = tid; idx < R * D; idx += NT) {
    const int r = idx / D, d = idx - r * D;
    const int t = r / G, g = r - t * G;
    if (t < t_lo || t >= t_hi)
      out[(static_cast<int64_t>(row0 + t) * H + h0 + g) * D + d] =
          lt_from_f<T>(0.f);
  }
}

template <typename T, typename KV, bool Q8>
int launch(const void* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* block_seq, const int* qstart,
           const int* qlen, const int* kvlen, const int* tables, void* out,
           int Trows, int H, int KVH, int MAXB, int D, int window,
           float scale, cudaStream_t stream) {
  const int G = H / KVH, GC = head_group(G, D);
  const int R = QBLK * GC;
  const int ld = D + 1;
  const size_t smem = sizeof(float) * (static_cast<size_t>(R + 2 * BK) * ld +
                                       R * BK + 3 * R + 2 * BK);
  auto* kernel = GC < G ? ragged_kernel<T, KV, Q8, true>
                        : ragged_kernel<T, KV, Q8, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (Trows <= 0) return 0;
  dim3 grid(Trows / QBLK, KVH, (G + GC - 1) / GC);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), ks, vs, block_seq, qstart, qlen, kvlen,
      tables, static_cast<T*>(out), H, KVH, MAXB, D, scale, window);
  return static_cast<int>(cudaGetLastError());
}

bool bad_geometry(int Trows, int H, int KVH, int D, int MAXB) {
  return KVH <= 0 || H % KVH != 0 || D % 16 != 0 || Trows % QBLK != 0 ||
         MAXB <= 0 || D <= 0 || D > MAXD;
}

template <bool Q8>
int dispatch(int dtype, const void* q, const void* kp, const void* vp,
             const float* ks, const float* vs, const int* block_seq,
             const int* qstart, const int* qlen, const int* kvlen,
             const int* tables, void* out, int Trows, int H, int KVH,
             int MAXB, int D, int window, float scale, void* stream) {
  if (bad_geometry(Trows, H, KVH, D, MAXB))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (Q8) {
    if (dtype == LT_BF16)
      return launch<__nv_bfloat16, int8_t, true>(
          q, kp, vp, ks, vs, block_seq, qstart, qlen, kvlen, tables, out,
          Trows, H, KVH, MAXB, D, window, scale, st);
    if (dtype == LT_F32)
      return launch<float, int8_t, true>(
          q, kp, vp, ks, vs, block_seq, qstart, qlen, kvlen, tables, out,
          Trows, H, KVH, MAXB, D, window, scale, st);
  } else {
    if (dtype == LT_BF16)
      return launch<__nv_bfloat16, __nv_bfloat16, false>(
          q, kp, vp, ks, vs, block_seq, qstart, qlen, kvlen, tables, out,
          Trows, H, KVH, MAXB, D, window, scale, st);
    if (dtype == LT_F32)
      return launch<float, float, false>(
          q, kp, vp, ks, vs, block_seq, qstart, qlen, kvlen, tables, out,
          Trows, H, KVH, MAXB, D, window, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// bf16/f32: q/out [T, H, D]; pools [NB, KVH, 128, D] in q's dtype;
// block_seq [T/8], qstart/qlen/kvlen [NSEQ], tables [NSEQ, MAXB] int32.
extern "C" int ragged_attention_launch(int dtype, const void* q,
                                       const void* kp, const void* vp,
                                       const int* block_seq,
                                       const int* qstart, const int* qlen,
                                       const int* kvlen, const int* tables,
                                       void* out, int Trows, int H, int KVH,
                                       int MAXB, int D, int window,
                                       float scale, void* stream) {
  return dispatch<false>(dtype, q, kp, vp, nullptr, nullptr, block_seq,
                         qstart, qlen, kvlen, tables, out, Trows, H, KVH,
                         MAXB, D, window, scale, stream);
}

// int8: pools [NB, KVH, 128, D] int8 with scales [NB, KVH, 1, 128] f32.
extern "C" int ragged_attention_q8_launch(
    int dtype, const void* q, const void* kq, const float* ks, const void* vq,
    const float* vs, const int* block_seq, const int* qstart,
    const int* qlen, const int* kvlen, const int* tables, void* out,
    int Trows, int H, int KVH, int MAXB, int D, int window, float scale,
    void* stream) {
  return dispatch<true>(dtype, q, kq, vq, ks, vs, block_seq, qstart, qlen,
                        kvlen, tables, out, Trows, H, KVH, MAXB, D, window,
                        scale, stream);
}
