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
// dead block, are written as 0; callers ignore them.
//
// What bounds it on the H100: every sequence's K/V below its length has to
// be read once (plus q, out and the table entries), at 4 flops per K/V
// element and q-row pair; at the serving shapes (mostly decode rows beside
// a chunk or two) that is far below the card's ops:byte line, so bytes
// bound it. What the design does about that: spread every sequence's K/V
// over many blocks (split-KV), read each K/V tile once for as many query
// rows as a block can hold, keep several tiles of copies in flight, and
// keep the per-tile arithmetic short (tensor cores).
//
// Split-KV, two launches:
//   - Split pass, grid (T/8, KVH * ngrp, nsplit). A block takes one q tile
//     of one KV head's query heads over one span of `split` tokens. The q
//     tile: up to QT consecutive q blocks of one sequence. The device finds
//     it from block_seq and qstart alone: the leader is the q block whose
//     offset from its sequence's first block is a multiple of QT, and the
//     other blocks exit at once. A decode row's q block is its own tile. Its
//     rows are compact (row c = live token c/G', head g0 + c%G' of the KV
//     head's G = H/KVH, G' the group's own count), at most 128 on the
//     tensor cores: (GC, QT) = (min(G, 16), 128 / (8 GC)), so G = 4 takes
//     32 tokens a tile, G = 7 16, G = 16 8, and every head of a group of up
//     to 16 shares each K/V tile (ngrp = ceil(G / GC) head groups, more than
//     one only above G = 16). A prefill chunk's K/V tile is so read once per
//     q tile, not once per q block. The span is cut to the tile's causal end
//     (its last live row's q_pos + 1) and, with a window, to its first live
//     row's window start: a block whose span starts at/past that end, or
//     ends at or before that start, exits before any table read, and the
//     combine never reads its partial. The block reads the span's table
//     entries into shared memory in one parallel load (a 32-token tile never
//     straddles a 128-token block, so each tile takes one entry, below
//     ceil(kvlen/128)), then streams the span's K/V rows through a ring of
//     32-token tiles filled by 16-byte cp.async (NS_TC stages; for int8 the
//     tile's 32 K and 32 V scales ride in the same stage; one barrier a
//     tile), so several tiles are in flight while one is consumed; rows
//     at/past the span's end are zero-filled, never read. It writes f32
//     partials (m, l, acc[D]) of each live row to the workspace [T, H,
//     nsplit] (m, l), then [T, H, nsplit, D]; a row the span hides wholly
//     writes (NEG_INF, 0, 0).
//   - Tensor cores (bf16 q, D <= 256, bf16 or int8 K/V): mma.sync
//     m16n8k16 (bf16 -> f32; m16n8k8 for 8-key slices). The 8 warps form
//     row groups of 16 compact rows; the WK warps of a row group each take
//     32/WK keys of every tile with a running softmax of their own (m, l,
//     acc), merged through shared memory at the end of the span: WK = 4 up
//     to 32 rows (a decode block runs 4 warps a tile, not one), 2 up to 64,
//     1 above (in two steps of 16 keys, which keeps fewer registers live).
//     S = Q K^T with Q (bf16, as given) and the K tile read by ldmatrix; the
//     score is scaled in f32 after the product (d^-0.5, times the K scale
//     for int8), masked, and the online softmax runs on the accumulator
//     fragments (a row's max and sum over the quad that holds it). P V is
//     the same mma with P from registers (S's accumulator layout is the A
//     fragment's) and V through ldmatrix.trans. The plain version keeps p
//     in f32, so p (times the V scale for int8) enters as two bf16 terms,
//     hi = bf16(p) and lo = bf16(p - hi), about 2^-17 relative, as in
//     flash_prefill.cu. int8 K/V convert exactly to bf16 (|v| <= 127) in a
//     shared staging tile. The accumulator is 16 x D f32 a warp: D / 2
//     registers a thread (DMAX 128 or 256 instantiations).
//   - SIMT variant, routed by shape: f32 q (no tensor-core path keeps the
//     f32 bar of 2e-5 without TF32) and bf16 above D = 256 (a 16 x D f32
//     accumulator a warp would not fit the registers). Same spans, table
//     staging, ring (2 stages, 1 where two f32 tiles at D = 512 would not
//     fit) and partials; at most 4096 / D compact rows a block (16 outputs
//     a thread), scalar f32 dot products with the query pre-scaled.
//   - Combine pass, grid (T, ceil(H/8)), one warp per (row, head): M = max
//     m_i, l = sum e^(m_i-M) l_i, out = sum e^(m_i-M) acc_i / max(l, 1e-30)
//     over the row's own splits only, from its window start's split to
//     ceil((q_pos+1)/split); rows outside a sequence's span and dead blocks
//     come out 0. It is a programmatic dependent launch: it starts while
//     the split pass runs and waits for that grid on the device.
//   - nsplit and split come from shapes alone (T, MAXB*128, KVH, the SM
//     count: ops/kernels/ragged_attention.ragged_split), never from kvlen,
//     so a tick needs no device sync; split is a multiple of the tile.
// The KV lifecycle tier (ragged_attention_tier_launch; the reference reads
// tiered KV through its XLA twin, _xla_core's tier branch): tables are
// compact ring tables and each sequence has sink blocks sb, ring width rw,
// retained sinks and window ([NSEQ] int32).
//   - A q tile's keys are two spans, the sinks [0, sinks) and its first
//     row's window (q_first - window, q_last], walked in one compressed
//     order (tier_plan: tile j < g0 is true tile j, tile j >= g0 true tile
//     j + gap) cut into ragged_split's spans; each tile's table entry comes
//     through ring_block_map and is staged per tile, -1 for a dead tile
//     (not resident, past the causal end, or no key kept).
//   - Row mask: resident, kv_pos <= q_pos and (kv_pos > q_pos - window or
//     kv_pos < sinks). The combine reads the splits of the row's q tile.
//   - Raw block indices run up to kvlen/128 while MAXB is the compact
//     width; the kept keys never exceed the resident columns, so
//     nsplit * split >= MAXB*128 covers them.
// Geometry: any G; D % 16 == 0 up to 512 (the SIMT variant's 8 rows of 512
// outputs over 256 threads).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int QBLK = 8;    // q rows per block (the reference's QBLK)
constexpr int BK = 32;     // tokens per tile
constexpr int NT = 256;    // 8 warps
constexpr int NW = NT / 32;
constexpr int PBS = 128;   // paged block size (tokens); PBS % BK == 0
constexpr int MAXD = 512;  // largest head_dim
constexpr int TC_ROWS = 16 * NW;       // compact rows of a tensor-core block
constexpr int TC_MAXD = 256;           // largest head_dim on the tensor cores
constexpr int NS_TC = 4;               // ring stages of the tensor-core pass
constexpr int SIMT_OUT = 16;           // outputs a SIMT thread holds
constexpr int SIMT_CELLS = NT * SIMT_OUT;  // rows * D of a SIMT block
constexpr size_t SMEM_CAP = 220 * 1024;    // of the 227 KB a block may use

// Rows a block holds: 128 on the tensor cores, 4096 / D (at least one q
// block of one head) in the SIMT variant.
__host__ __device__ __forceinline__ int tile_rows(int D, bool tc) {
  if (tc) return TC_ROWS;
  const int r = SIMT_CELLS / D;
  return r > QBLK ? r : QBLK;
}

// (GC, QT): query heads of a head group, q blocks of a q tile.
__host__ __device__ __forceinline__ void tiling(int G, int D, bool tc,
                                                int& gc, int& qt) {
  const int rows = tile_rows(D, tc);
  const int c = rows / QBLK > 1 ? rows / QBLK : 1;
  gc = G < c ? G : c;
  const int t = rows / (QBLK * gc);
  qt = t > 1 ? t : 1;
}

// What one split-pass block computes: sequence s, KV head kh, query heads
// h0 .. h0+G-1, the tile's rows row0 + [t_lo, t_hi), compact rows nr,
// q_pos of row row0 (qpos0), and the span's tokens [lo, hi) of the tile's
// window start tbeg. The mask of a row at q_pos q: key position kpos <
// kend, kpos <= q and (kpos > q - win or kpos < snk), win 0 = no window.
// Under the KV tier (TIER) the span's tokens are in the q tile's
// compressed order — tile j < g0 is true tile j, tile j >= g0 true tile j
// + gap, ntile of them (tier_plan) —, kend is the tile's causal end and
// (win, snk) the sequence's retention window and sinks.
struct Span {
  int s, kh, h0, G, row0, t_lo, t_hi, nr, qpos0, tbeg, lo, hi;
  int kend, win, snk, g0, gap, ntile, sb, rw, cur, ring_lo;
};

// Per-sequence geometry of the KV lifecycle tier (engine/kvtier.py),
// [NSEQ] int32 each: sink blocks, ring width, retained sinks and window;
// sb is null outside the tier.
struct RTier {
  const int* sb;
  const int* rw;
  const int* sinks;
  const int* window;
};

// The q tile led by q block qb of a sequence with rows [qs, qs + ql) and
// kv length klen: its rows and the q position of its first row; false when
// qb leads no tile (not a leader, or no live row).
__device__ __forceinline__ bool tile_of(Span& p, int qb, int qs, int ql,
                                        int klen, int qt) {
  const int fb = qs / QBLK;  // the sequence's first q block
  if (qb < fb || (qb - fb) % qt != 0) return false;
  const int nqb = min(qt, (qs + ql + QBLK - 1) / QBLK - qb);
  p.row0 = qb * QBLK;
  p.t_lo = max(qs - p.row0, 0);
  p.t_hi = min(qs + ql - p.row0, nqb * QBLK);
  if (p.t_hi <= p.t_lo) return false;
  p.qpos0 = klen - ql + (p.row0 - qs);
  return true;
}

// The tier's compressed order for a q tile: its live keys are the sinks [0,
// a) and the window of its first row up to its causal end, [c, kend), each
// within the resident blocks (sink blocks, and the ring's raw blocks
// ring_lo .. cur); g0 = ceil(a/32), gap the tiles skipped between. A ring
// always holds the window of every row of a chunk (kvtier.ring_blocks keeps
// a prefill chunk of margin), so at most MAXB*4 tiles are live.
__device__ __forceinline__ void tier_plan(Span& p, const RTier& tr,
                                          int klen) {
  p.kend = min(klen, p.qpos0 + p.t_hi);
  p.sb = tr.sb[p.s];
  p.rw = max(tr.rw[p.s], 1);
  p.snk = tr.sinks[p.s];
  p.win = tr.window[p.s];
  p.cur = klen > 0 ? (klen - 1) / PBS : 0;
  p.ring_lo = max(p.sb, p.cur - p.rw + 1);
  int a = min(min(p.snk, p.kend), p.sb * PBS);
  int c = max(p.qpos0 + p.t_lo - p.win + 1, p.ring_lo * PBS);
  a = max(a, 0);
  c = min(max(c, a), max(p.kend, 0));
  p.g0 = (a + BK - 1) / BK;
  p.gap = max(c / BK, p.g0) - p.g0;
  p.ntile = (max(p.kend, 0) + BK - 1) / BK - p.gap;
}

// Fill `p`; false when the block has nothing to do (dead block, not a
// tile's leader, no live row, or a span outside the tile's keys), before
// any table read.
template <bool TIER>
__device__ __forceinline__ bool block_span(
    Span& p, const int* __restrict__ block_seq, const int* __restrict__ qstart,
    const int* __restrict__ qlen, const int* __restrict__ kvlen, int H,
    int KVH, int MAXB, int window, int split, int gc, int qt,
    const RTier& tr) {
  const int GA = H / KVH;
  const int ngrp = (GA + gc - 1) / gc;
  p.kh = blockIdx.y / ngrp;
  const int g0 = (blockIdx.y - p.kh * ngrp) * gc;
  p.G = min(gc, GA - g0);
  p.h0 = p.kh * GA + g0;
  const int qb = blockIdx.x;
  p.s = block_seq[qb];
  if (p.s < 0) return false;
  const int qs = qstart[p.s], ql = qlen[p.s], klen = kvlen[p.s];
  if (!tile_of(p, qb, qs, ql, klen, qt)) return false;
  p.nr = (p.t_hi - p.t_lo) * p.G;
  p.lo = blockIdx.z * split;
  if (TIER) {
    tier_plan(p, tr, klen);
    p.tbeg = 0;
    p.hi = min(p.lo + split, p.ntile * BK);
    return p.hi > p.lo;
  }
  // causal end of the tile (its last live row's q_pos + 1), within kvlen
  const int tend = min(min(klen, p.qpos0 + p.t_hi), MAXB * PBS);
  p.tbeg = window > 0 ? max(p.qpos0 + p.t_lo - window + 1, 0) : 0;
  p.hi = min(p.lo + split, tend);
  p.kend = p.hi;
  p.win = window;
  p.snk = 0;
  return p.hi > p.lo && p.lo + split > p.tbeg;
}

// Bytes of one ring stage: the K and V tiles (rows padded by 16 bytes),
// then, for int8, the tile's 32 K scales and 32 V scales (f32).
template <typename KV, bool Q8>
__host__ __device__ __forceinline__ int stage_bytes(int D) {
  return 2 * BK * (D * static_cast<int>(sizeof(KV)) + 16) +
         (Q8 ? 2 * BK * static_cast<int>(sizeof(float)) : 0);
}

// Table entries a span can touch: split/128 blocks, plus one at each end
// where the span is not block-aligned; under the tier one a tile (a span's
// tiles may lie on both sides of the gap).
template <bool TIER>
__host__ __device__ __forceinline__ int span_entries(int split) {
  return TIER ? split / BK : split / PBS + 2;
}

// Stage the span's table entries [kb0, kb1) into Tb: one parallel read at
// the block's start instead of one dependent read a tile. Untiered, entry i
// is block (kb0*BK)/PBS + i of the sequence's table. TIER: entry i is the
// pool block of the span's tile kb0 + i through ring_block_map, or -1 for
// a dead tile (not resident, past the causal end, or no key of it kept).
// The caller synchronises before the first load_tile.
template <bool TIER>
__device__ __forceinline__ void stage_table(int* Tb,
                                            const int* __restrict__ tables,
                                            const Span& p, int MAXB, int kb0,
                                            int kb1) {
  if (TIER) {
    const int qf = p.qpos0 + p.t_lo;
    for (int i = threadIdx.x; i < kb1 - kb0; i += NT) {
      const int kb = kb0 + i;
      const int t0 = (kb < p.g0 ? kb : kb + p.gap) * BK;
      const int raw = t0 / PBS;
      int col = raw;
      bool live = t0 < p.kend &&
                  (t0 < min(p.snk, p.kend) || t0 + BK > qf - p.win + 1);
      if (raw >= p.sb) {
        live = live && raw >= p.ring_lo && raw <= p.cur;
        col = p.sb + (raw - p.sb) % p.rw;
      }
      live = live && col < MAXB;
      Tb[i] = live ? tables[static_cast<int64_t>(p.s) * MAXB + col] : -1;
    }
    return;
  }
  const int e0 = kb0 * BK / PBS;
  const int n = kb1 > kb0 ? ((kb1 * BK - 1) / PBS) - e0 + 1 : 0;
  for (int i = threadIdx.x; i < n; i += NT)
    Tb[i] = tables[static_cast<int64_t>(p.s) * MAXB + e0 + i];
}

// Tile kb of the span: its first true key position t0, its pool block pb,
// and the rows to load (0: a dead tile, never loaded or consumed).
struct RTile {
  int64_t pb;
  int t0, valid;
};

template <bool TIER>
__device__ __forceinline__ RTile span_tile(const int* Tb, const Span& p,
                                           int kb0, int kb) {
  if (TIER) {
    const int t0 = (kb < p.g0 ? kb : kb + p.gap) * BK;
    const int pb = Tb[kb - kb0];
    return RTile{pb, t0, pb < 0 ? 0 : min(BK, p.kend - t0)};
  }
  const int t0 = kb * BK;
  return RTile{Tb[t0 / PBS - kb0 * BK / PBS], t0, min(BK, p.hi - t0)};
}

// Issue the cp.async copies of a tile into `stage`: K rows, then V rows,
// then (int8) the scales. Rows at/past `valid` are zero-filled.
template <typename KV, bool Q8>
__device__ __forceinline__ void load_tile(uint8_t* stage,
                                          const KV* __restrict__ kp,
                                          const KV* __restrict__ vp,
                                          const float* __restrict__ ks,
                                          const float* __restrict__ vs,
                                          const RTile& tl, const Span& p,
                                          int KVH, int D) {
  constexpr int VEC = 16 / sizeof(KV);
  const int rs = D * static_cast<int>(sizeof(KV)) + 16;
  const int valid = tl.valid;
  const int64_t row0 = (tl.pb * KVH + p.kh) * PBS + tl.t0 % PBS;
  uint8_t* kt = stage;
  uint8_t* vt = stage + BK * rs;
  const int cpr = D / VEC;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < BK * cpr; i += NT) {
    const int r = i / cpr, c = i - r * cpr;
    const bool ok = r < valid;
    const int64_t off = (row0 + (ok ? r : 0)) * D + c * VEC;
    lt_cp_async16(kt + r * rs + c * 16, kp + off, ok);
    lt_cp_async16(vt + r * rs + c * 16, vp + off, ok);
  }
  if (Q8 && threadIdx.x < 2 * BK / 4) {
    // 8 chunks of 4 K scales, then 8 of 4 V scales; a chunk wholly past
    // the span's end is zero-filled (a partial one is masked when used)
    const int c = threadIdx.x % (BK / 4);
    const bool ok = 4 * c < valid;
    const float* src =
        (threadIdx.x < BK / 4 ? ks : vs) + row0 + (ok ? 4 * c : 0);
    lt_cp_async16(vt + BK * rs + threadIdx.x * 16, src, ok);
  }
}

// Workspace index of (row t of the stream, head h, split sp).
__device__ __forceinline__ int64_t part_index(int t, int H, int h,
                                              int nsplit, int sp) {
  return (static_cast<int64_t>(t) * H + h) * nsplit + sp;
}

// ------------------------------------------------------ tensor-core pass

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

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (hi, lo) bf16 pairs of (x, y): hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16x8 bf16, row) * b (8x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Byte offset of the table entries in the tensor-core pass's shared
// memory: after Q [128][D+8] bf16, the ring and, for int8, the bf16
// staging tiles of K and V [2*32][D+8].
template <typename KV, bool Q8>
__host__ __device__ __forceinline__ int tc_table_offset(int D) {
  const int row = 2 * (D + 8);
  return TC_ROWS * row + NS_TC * stage_bytes<KV, Q8>(D) +
         (Q8 ? 2 * BK * row : 0);
}

// Shared-memory bytes of the tensor-core pass: the layout above plus the
// span's table entries, or the end-of-span merge of the warps' states
// ([8 warps][DMAX/2 + 4][32 lanes] f32) laid over it, whichever is larger.
template <typename KV, bool Q8, int DMAX, bool TIER>
size_t tc_smem(int D, int split) {
  const size_t main =
      tc_table_offset<KV, Q8>(D) +
      sizeof(int) * static_cast<size_t>(span_entries<TIER>(split));
  const size_t merge = sizeof(float) * NW * (DMAX / 2 + 4) * 32;
  return main > merge ? main : merge;
}

// One span of one q tile on the tensor cores. The block's warps form row
// groups of 16 compact rows; WK warps share a row group, each taking 32/WK
// keys of every tile with its own running softmax (m, l, acc), merged at
// the end of the span: a decode block (16 rows or fewer) runs 4 warps on
// each tile instead of one. Q's copies are in flight (cp.async) when it
// starts; Tb holds the span's table entries (stage_table).
template <typename KV, bool Q8, int DMAX, int WK, bool TIER>
__device__ __forceinline__ void tc_span(uint8_t* smem, const Span& p,
                                        const KV* __restrict__ kp,
                                        const KV* __restrict__ vp,
                                        const float* __restrict__ ks,
                                        const float* __restrict__ vs,
                                        const int* Tb, float* __restrict__ ws,
                                        int H, int KVH, int D, float scale,
                                        int nsplit, int kb0, int kb1) {
  constexpr int NF = DMAX / 8;  // accumulator fragments (8 columns each)
  // a warp's keys of a tile, 32/WK, in NSUB steps of SF fragments of 8
  // keys: one step of 8 (WK = 4) or 16, two of 16 at WK = 1 (fewer live
  // registers than one step of 32)
  constexpr int SF = WK == 4 ? 1 : 2;
  constexpr int NSUB = WK == 1 ? 2 : 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ldq = D + 8;  // bf16 row of Q and of the staging tiles
  const int rs = D * static_cast<int>(sizeof(KV)) + 16;
  const int stage = stage_bytes<KV, Q8>(D);
  const __nv_bfloat16* Qs = reinterpret_cast<const __nv_bfloat16*>(smem);
  uint8_t* ring = smem + TC_ROWS * ldq * 2;
  __nv_bfloat16* Kb = reinterpret_cast<__nv_bfloat16*>(ring + NS_TC * stage);
  auto load = [&](int kb) {
    const RTile tl = span_tile<TIER>(Tb, p, kb0, kb);
    if (tl.valid > 0)
      load_tile<KV, Q8>(ring + ((kb - kb0) % NS_TC) * stage, kp, vp, ks, vs,
                        tl, p, KVH, D);
  };
  // the first NS-1 tiles in flight, one commit group each (the first also
  // holds Q's copies)
#pragma unroll
  for (int i = 0; i < NS_TC - 1; ++i) {
    if (kb0 + i < kb1) load(kb0 + i);
    lt_cp_async_commit();
  }

  // warp (row group rg, key group kg): rows rg*16 .., keys kg*32/WK ..
  const int rg = warp / WK, kg = warp - rg * WK;
  const int k0 = kg * (BK / WK);
  const bool busy = rg * 16 < p.nr;
  // this thread's two rows (quad row g and g + 8): q_pos (-1 for a row past
  // the live ones: every key masked) and window start
  const int ra = rg * 16 + (lane >> 2), rb = ra + 8;
  const int qa = ra < p.nr ? p.qpos0 + p.t_lo + ra / p.G : -1;
  const int qb = rb < p.nr ? p.qpos0 + p.t_lo + rb / p.G : -1;
  const int wa = p.win > 0 ? qa - p.win + 1 : 0;
  const int wb = p.win > 0 ? qb - p.win + 1 : 0;
  float m_a = LT_NEG_INF, m_b = LT_NEG_INF, l_a = 0.f, l_b = 0.f;
  float acc[NF][4];
#pragma unroll
  for (int i = 0; i < NF; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kb = kb0; kb < kb1; ++kb) {
    lt_cp_async_wait<NS_TC - 2>();  // tile kb (and Q) landed
    __syncthreads();  // ... for every thread; tile kb-1's stage is free
    if (kb + NS_TC - 1 < kb1) load(kb + NS_TC - 1);
    lt_cp_async_commit();
    const RTile tl = span_tile<TIER>(Tb, p, kb0, kb);
    // a dead tile (the same for every thread) is skipped: nothing reads its
    // stage, and the next refill of it goes to a stage no one reads
    if (TIER && tl.valid <= 0) continue;
    const uint8_t* st = ring + ((kb - kb0) % NS_TC) * stage;
    // int8: K scales [BK], then V scales [BK]
    const float* sc = reinterpret_cast<const float*>(st + 2 * BK * rs);
    const __nv_bfloat16* Kt;
    if constexpr (Q8) {
      // int8 -> bf16 (exact): K rows then V rows into [2*BK][ldq]
      const int cp8 = D / 16;
      for (int i = tid; i < 2 * BK * cp8; i += NT) {
        const int r = i / cp8, c = i - r * cp8;
        const uint4 raw =
            *reinterpret_cast<const uint4*>(st + r * rs + c * 16);
        const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
        uint32_t w[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          w[j] = bf16x2_bits(__floats2bfloat162_rn(
              static_cast<float>(e[2 * j]), static_cast<float>(e[2 * j + 1])));
        uint4* dst = reinterpret_cast<uint4*>(Kb + r * ldq + c * 16);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
      Kt = Kb;
    } else {
      Kt = reinterpret_cast<const __nv_bfloat16*>(st);
    }
    const __nv_bfloat16* Vt = Kt + BK * ldq;  // rs == 2 * ldq for bf16
    if (!busy) continue;

#pragma unroll
    for (int sub = 0; sub < NSUB; ++sub) {
      const int kq = k0 + sub * 16;  // this step's first key of the tile
      // S [16 rows][8*SF keys]: SF fragments of 8 keys
      float s[SF][4];
#pragma unroll
      for (int j = 0; j < SF; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* qrow =
          Qs + (rg * 16 + (lane & 15)) * ldq + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        if (kk < D / 16) {
          uint32_t a[4];
          ldsm_x4(a, qrow + kk * 16);
          if constexpr (SF >= 2) {
#pragma unroll
            for (int jp = 0; jp < SF / 2; ++jp) {
              uint32_t b[4];
              ldsm_x4(b, Kt + (kq + jp * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                  ldq +
                             kk * 16 + ((lane >> 3) & 1) * 8);
              mma_bf16(s[2 * jp], a, b[0], b[1]);
              mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
            }
          } else {
            uint32_t b[2];
            ldsm_x2(b, Kt + (kq + (lane & 7)) * ldq + kk * 16 +
                           ((lane >> 3) & 1) * 8);
            mma_bf16(s[0], a, b[0], b[1]);
          }
        }
      }
      // scale, mask, online softmax; row a in [0..1], row b in [2..3]
      const int t0 = tl.t0;
      float mx_a = LT_NEG_INF, mx_b = LT_NEG_INF;
#pragma unroll
      for (int j = 0; j < SF; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kq + j * 8 + 2 * (lane & 3) + e;
          const int kpos = t0 + col;
          const float mul = Q8 ? scale * sc[col] : scale;
          const bool in = kpos < p.kend;
          const bool ok_a =
              in && kpos <= qa && (kpos >= wa || (TIER && kpos < p.snk));
          const bool ok_b =
              in && kpos <= qb && (kpos >= wb || (TIER && kpos < p.snk));
          s[j][e] = ok_a ? s[j][e] * mul : LT_NEG_INF;
          s[j][2 + e] = ok_b ? s[j][2 + e] * mul : LT_NEG_INF;
          mx_a = fmaxf(mx_a, s[j][e]);
          mx_b = fmaxf(mx_b, s[j][2 + e]);
        }
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const float al_a = __expf(m_a - mn_a), al_b = __expf(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      // P (times the V scale for int8), in place of the scores; l sums the
      // unscaled p
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < SF; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[j][e];
          const float pe =
              x == LT_NEG_INF ? 0.f : __expf(x - (e < 2 ? m_a : m_b));
          if (e < 2) sum_a += pe; else sum_b += pe;
          // int8: p times the V scale, 0 where p is (a stale scale meets 0)
          s[j][e] = Q8 ? (pe == 0.f ? 0.f
                                    : pe * sc[BK + kq + j * 8 + 2 * (lane & 3) +
                                              (e & 1)])
                       : pe;
        }
      }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) {
        if (nf < D / 8) {
          acc[nf][0] *= al_a;
          acc[nf][1] *= al_a;
          acc[nf][2] *= al_b;
          acc[nf][3] *= al_b;
        }
      }
      // acc += P V: P as bf16 hi + lo (the A operand, [row a, row b] pairs of
      // each 8-key fragment), one k-step of keys at a time over all columns
      if constexpr (SF == 1) {
        // one 8-key fragment: m16n8k8, V^T [8 keys][16 columns] a step
        uint32_t ha, la, hb, lb;
        split_bf16(s[0][0], s[0][1], ha, la);
        split_bf16(s[0][2], s[0][3], hb, lb);
        const __nv_bfloat16* vrow =
            Vt + (kq + (lane & 7)) * ldq + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int dp = 0; dp < NF / 2; ++dp) {
          if (dp < D / 16) {
            uint32_t b[2];
            ldsm_x2_t(b, vrow + dp * 16);
            mma_bf16_k8(acc[2 * dp], ha, hb, b[0]);
            mma_bf16_k8(acc[2 * dp], la, lb, b[0]);
            mma_bf16_k8(acc[2 * dp + 1], ha, hb, b[1]);
            mma_bf16_k8(acc[2 * dp + 1], la, lb, b[1]);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < SF / 2; ++kk) {
          uint32_t hi[4], lo[4];
          split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
          split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
          split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
          split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
          const __nv_bfloat16* vrow =
              Vt + (kq + kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ldq +
              (lane >> 4) * 8;
#pragma unroll
          for (int dp = 0; dp < NF / 2; ++dp) {
            if (dp < D / 16) {
              uint32_t b[4];
              ldsm_x4_t(b, vrow + dp * 16);
              mma_bf16(acc[2 * dp], hi, b[0], b[1]);
              mma_bf16(acc[2 * dp], lo, b[0], b[1]);
              mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
              mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
            }
          }
        }
      }
    }
  }

  // l summed over the quad
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  if constexpr (WK > 1) {
    // merge the WK warps of a row group: the others hand their states over
    // shared memory ([warp][DMAX/2 + 4][lane]) to key group 0
    lt_cp_async_wait<0>();
    __syncthreads();  // every warp done with Q, the ring and the staging
    float* mb = reinterpret_cast<float*>(smem);
    constexpr int PER = NF * 4 + 4;
    if (busy && kg > 0) {
      float* w = mb + warp * PER * 32 + lane;
#pragma unroll
      for (int i = 0; i < NF; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[(i * 4 + e) * 32] = acc[i][e];
      w[NF * 4 * 32] = m_a;
      w[(NF * 4 + 1) * 32] = m_b;
      w[(NF * 4 + 2) * 32] = l_a;
      w[(NF * 4 + 3) * 32] = l_b;
    }
    __syncthreads();
    if (!busy || kg > 0) return;
#pragma unroll
    for (int o = 1; o < WK; ++o) {
      const float* w = mb + (warp + o) * PER * 32 + lane;
      const float mo_a = w[NF * 4 * 32], mo_b = w[(NF * 4 + 1) * 32];
      const float M_a = fmaxf(m_a, mo_a), M_b = fmaxf(m_b, mo_b);
      const float fa = expf(m_a - M_a), ga = expf(mo_a - M_a);
      const float fb = expf(m_b - M_b), gb = expf(mo_b - M_b);
      l_a = l_a * fa + w[(NF * 4 + 2) * 32] * ga;
      l_b = l_b * fb + w[(NF * 4 + 3) * 32] * gb;
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        acc[i][0] = acc[i][0] * fa + w[(i * 4) * 32] * ga;
        acc[i][1] = acc[i][1] * fa + w[(i * 4 + 1) * 32] * ga;
        acc[i][2] = acc[i][2] * fb + w[(i * 4 + 2) * 32] * gb;
        acc[i][3] = acc[i][3] * fb + w[(i * 4 + 3) * 32] * gb;
      }
      m_a = M_a;
      m_b = M_b;
    }
  }
  if (!busy) return;

  // partials of the live rows
  float* wacc = ws + 2 * static_cast<int64_t>(gridDim.x) * QBLK * H * nsplit;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= p.nr) continue;
    const int t = p.t_lo + r / p.G, g = r - (r / p.G) * p.G;
    const int64_t idx =
        part_index(p.row0 + t, H, p.h0 + g, nsplit, blockIdx.z);
    float* a = wacc + idx * D + 2 * (lane & 3);
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
      if (nf < D / 8)
        *reinterpret_cast<float2*>(a + nf * 8) =
            make_float2(acc[nf][2 * half], acc[nf][2 * half + 1]);
    if ((lane & 3) == 0) {
      ws[2 * idx] = half ? m_b : m_a;
      ws[2 * idx + 1] = half ? l_b : l_a;
    }
  }
}

template <typename KV, bool Q8, int DMAX, bool TIER>
__global__ void __launch_bounds__(NT, DMAX <= 128 ? 2 : 1)
    ragged_tc_kernel(const __nv_bfloat16* __restrict__ q,
                     const KV* __restrict__ kp, const KV* __restrict__ vp,
                     const float* __restrict__ ks,
                     const float* __restrict__ vs,
                     const int* __restrict__ block_seq,
                     const int* __restrict__ qstart,
                     const int* __restrict__ qlen,
                     const int* __restrict__ kvlen,
                     const int* __restrict__ tables, float* __restrict__ ws,
                     int H, int KVH, int MAXB, int D, float scale, int window,
                     int split, int nsplit, int gc, int qt, const RTier tr) {
  extern __shared__ __align__(16) uint8_t smem[];
  // let the combine grid launch now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  Span p;
  if (!block_span<TIER>(p, block_seq, qstart, qlen, kvlen, H, KVH, MAXB,
                        window, split, gc, qt, tr))
    return;
  const int kb0 = max(p.lo, p.tbeg) / BK;
  const int kb1 = (p.hi + BK - 1) / BK;
  // Q rows (bf16, as given) by cp.async, zero past the live rows up to the
  // last row group's 16; they complete with the first tile's group
  const int ldq = D + 8;
  const int nr16 = (p.nr + 15) & ~15;
  const int cpq = D / 8;
  for (int i = threadIdx.x; i < nr16 * cpq; i += NT) {
    const int c = i / cpq, col = (i - c * cpq) * 8;
    const bool ok = c < p.nr;
    const int t = p.t_lo + (ok ? c : 0) / p.G;
    const int g = (ok ? c : 0) - ((ok ? c : 0) / p.G) * p.G;
    lt_cp_async16(
        smem + (c * ldq + col) * 2,
        q + (static_cast<int64_t>(p.row0 + t) * H + p.h0 + g) * D + col, ok);
  }
  int* Tb = reinterpret_cast<int*>(smem + tc_table_offset<KV, Q8>(D));
  stage_table<TIER>(Tb, tables, p, MAXB, kb0, kb1);
  __syncthreads();
  // warps a row group of 16: 4 key groups up to two, 2 up to four, 1
  // above
  const int groups = (p.nr + 15) >> 4;
  if (groups <= 2)
    tc_span<KV, Q8, DMAX, 4, TIER>(smem, p, kp, vp, ks, vs, Tb, ws, H, KVH,
                                   D, scale, nsplit, kb0, kb1);
  else if (groups <= 4)
    tc_span<KV, Q8, DMAX, 2, TIER>(smem, p, kp, vp, ks, vs, Tb, ws, H, KVH,
                                   D, scale, nsplit, kb0, kb1);
  else
    tc_span<KV, Q8, DMAX, 1, TIER>(smem, p, kp, vp, ks, vs, Tb, ws, H, KVH,
                                   D, scale, nsplit, kb0, kb1);
}

// --------------------------------------------------------- SIMT variant

// Shared-memory bytes of the SIMT pass with NS stages: Q [rows][D] f32, the
// ring, P [rows][BK], m, l, alpha [rows], and the span's table entries.
template <typename KV, bool Q8, bool TIER>
size_t simt_smem(int D, int NS, int split) {
  const size_t rows = tile_rows(D, false);
  return sizeof(float) * rows * D +
         static_cast<size_t>(NS) * stage_bytes<KV, Q8>(D) +
         sizeof(float) * (rows * BK + 3 * rows) +
         sizeof(int) * static_cast<size_t>(span_entries<TIER>(split));
}

template <typename T, typename KV, bool Q8, int NS, bool TIER>
__global__ void __launch_bounds__(NT)
    ragged_simt_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                       const KV* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ block_seq,
                       const int* __restrict__ qstart,
                       const int* __restrict__ qlen,
                       const int* __restrict__ kvlen,
                       const int* __restrict__ tables,
                       float* __restrict__ ws, int H, int KVH, int MAXB,
                       int D, float scale, int window, int split, int nsplit,
                       int gc, int qt, const RTier tr) {
  constexpr int VEC = 16 / sizeof(KV);
  extern __shared__ __align__(16) uint8_t smem[];
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  Span p;
  if (!block_span<TIER>(p, block_seq, qstart, qlen, kvlen, H, KVH, MAXB,
                        window, split, gc, qt, tr))
    return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cap = tile_rows(D, false);
  const int rs = D * static_cast<int>(sizeof(KV)) + 16;
  const int stage = stage_bytes<KV, Q8>(D);
  float* Qs = reinterpret_cast<float*>(smem);  // [cap][D], pre-scaled
  uint8_t* ring = smem + sizeof(float) * cap * D;
  float* Ps = reinterpret_cast<float*>(ring + NS * stage);  // [cap][BK]
  float* Ms = Ps + cap * BK;
  float* Ls = Ms + cap;
  float* Al = Ls + cap;
  int* Tb = reinterpret_cast<int*>(Al + cap);

  const int kb0 = max(p.lo, p.tbeg) / BK;
  const int kb1 = (p.hi + BK - 1) / BK;
  stage_table<TIER>(Tb, tables, p, MAXB, kb0, kb1);
  __syncthreads();
  auto load = [&](int kb) {
    const RTile tl = span_tile<TIER>(Tb, p, kb0, kb);
    if (tl.valid > 0)
      load_tile<KV, Q8>(ring + ((kb - kb0) % NS) * stage, kp, vp, ks, vs, tl,
                        p, KVH, D);
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (kb0 + i < kb1) load(kb0 + i);
    lt_cp_async_commit();
  }

  {  // query rows as f32 times the softmax scale
    constexpr int QV = 16 / sizeof(T);
    const int per_row = D / QV;
    for (int i = tid; i < p.nr * per_row; i += NT) {
      const int c = i / per_row, col = (i - c * per_row) * QV;
      const int t = p.t_lo + c / p.G, g = c - (c / p.G) * p.G;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + (static_cast<int64_t>(p.row0 + t) * H + p.h0 + g) * D + col);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < QV; ++j) Qs[c * D + col + j] = lt_to_f(e[j]) * scale;
    }
  }
  for (int r = tid; r < p.nr; r += NT) {
    Ms[r] = LT_NEG_INF;
    Ls[r] = 0.f;
  }
  float acc[SIMT_OUT];
#pragma unroll
  for (int i = 0; i < SIMT_OUT; ++i) acc[i] = 0.f;

  for (int kb = kb0; kb < kb1; ++kb) {
    if (kb + NS - 1 < kb1) load(kb + NS - 1);
    lt_cp_async_commit();
    lt_cp_async_wait<NS - 1>();
    __syncthreads();
    const RTile tl = span_tile<TIER>(Tb, p, kb0, kb);
    // a dead tile (the same for every thread) is skipped, as in tc_span
    if (TIER && tl.valid <= 0) continue;
    const uint8_t* kt = ring + ((kb - kb0) % NS) * stage;
    const uint8_t* vt = kt + BK * rs;
    const float* sc = reinterpret_cast<const float*>(vt + BK * rs);
    const int t0 = tl.t0;

    for (int idx = tid; idx < p.nr * BK; idx += NT) {
      const int c = idx / BK, j = idx - c * BK;
      const float* qr = Qs + c * D;
      const uint8_t* kr = kt + j * rs;
      float a = 0.f;
      for (int d = 0; d < D; d += VEC) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(kr + d * sizeof(KV));
        const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
        for (int x = 0; x < VEC; ++x) a += qr[d + x] * lt_to_f(e[x]);
      }
      if (Q8) a *= sc[j];
      const int qpos = p.qpos0 + p.t_lo + c / p.G;
      const int kpos = t0 + j;
      const bool ok = kpos < p.kend && kpos <= qpos &&
                      (p.win <= 0 || kpos > qpos - p.win ||
                       (TIER && kpos < p.snk));
      Ps[idx] = ok ? a : LT_NEG_INF;
    }
    __syncthreads();

    for (int c = warp; c < p.nr; c += NW) {
      const float x = Ps[c * BK + lane];
      const float m_old = Ms[c];
      const float m_new = fmaxf(m_old, lt_warp_max(x));
      const float pe = x == LT_NEG_INF ? 0.f : expf(x - m_new);
      const float psum = lt_warp_sum(pe);  // l sums the unscaled p
      Ps[c * BK + lane] = Q8 ? (pe == 0.f ? 0.f : pe * sc[BK + lane]) : pe;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Ls[c] = Ls[c] * alpha + psum;
        Ms[c] = m_new;
        Al[c] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < SIMT_OUT; ++i) {
      const int idx = tid + i * NT;
      if (idx < p.nr * D) {
        const int c = idx / D, d = idx - c * D;
        const float* pr = Ps + c * BK;
        float a = acc[i] * Al[c];
        for (int j = 0; j < BK; ++j)
          a += pr[j] * lt_to_f(reinterpret_cast<const KV*>(vt + j * rs)[d]);
        acc[i] = a;
      }
    }
    __syncthreads();  // this stage consumed before it is refilled
  }
  __syncthreads();  // m and l visible (also with no tile at all)

  float* wacc = ws + 2 * static_cast<int64_t>(gridDim.x) * QBLK * H * nsplit;
#pragma unroll
  for (int i = 0; i < SIMT_OUT; ++i) {
    const int idx = tid + i * NT;
    if (idx < p.nr * D) {
      const int c = idx / D, d = idx - c * D;
      const int t = p.t_lo + c / p.G, g = c - (c / p.G) * p.G;
      wacc[part_index(p.row0 + t, H, p.h0 + g, nsplit, blockIdx.z) * D + d] =
          acc[i];
    }
  }
  for (int c = tid; c < p.nr; c += NT) {
    const int t = p.t_lo + c / p.G, g = c - (c / p.G) * p.G;
    const int64_t pi = part_index(p.row0 + t, H, p.h0 + g, nsplit, blockIdx.z);
    ws[2 * pi] = Ms[c];
    ws[2 * pi + 1] = Ls[c];
  }
}

// ---------------------------------------------------------- combine pass

// One warp per (row t, head h): lanes own 16-byte column chunks lane, lane
// + 32, ... of D. TIER: the row's splits are those of its q tile's
// compressed span (tier_plan of the tile's leader, qt q blocks a tile), [0,
// ceil(ntile*32/split)). Launched with programmatic stream serialization,
// it may start while the split pass still runs: griddepcontrol.wait holds
// it until that grid has finished and its writes are visible.
template <typename T, bool TIER>
__global__ void __launch_bounds__(NT)
    ragged_combine_kernel(const float* __restrict__ ws,
                          const int* __restrict__ block_seq,
                          const int* __restrict__ qstart,
                          const int* __restrict__ qlen,
                          const int* __restrict__ kvlen, T* __restrict__ out,
                          int H, int MAXB, int D, int window, int split,
                          int nsplit, const RTier tr, int qt) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int t = blockIdx.x, lane = threadIdx.x & 31;
  const int h = blockIdx.y * NW + (threadIdx.x >> 5);
  if (h >= H) return;
  // the row's own splits [first, first + n): from its window start to its
  // q_pos; none for a row outside a sequence's span or a dead block
  int first = 0, n = 0;
  const int s = block_seq[t / QBLK];
  if (s >= 0) {
    const int qs = qstart[s], ql = qlen[s];
    if (TIER && t >= qs && t < qs + ql) {
      Span p;
      p.s = s;
      const int fb = qs / QBLK, qb = t / QBLK;
      if (tile_of(p, fb + (qb - fb) / qt * qt, qs, ql, kvlen[s], qt)) {
        tier_plan(p, tr, kvlen[s]);
        n = min(nsplit, (p.ntile * BK + split - 1) / split);
      }
    } else if (t >= qs && t < qs + ql) {
      const int qpos = kvlen[s] - ql + (t - qs);
      const int end = min(qpos + 1, MAXB * PBS);
      const int beg = window > 0 ? max(qpos - window + 1, 0) : 0;
      if (end > beg) {
        first = beg / split;
        n = min(nsplit, (end + split - 1) / split) - first;
      }
    }
  }
  const int64_t row = part_index(t, H, h, nsplit, 0);
  const float* ml = ws + 2 * row;
  const float* acc = ws + 2 * static_cast<int64_t>(gridDim.x) * H * nsplit +
                     row * D;
  float M = LT_NEG_INF;
  for (int i = lane; i < n; i += 32) M = fmaxf(M, ml[2 * (first + i)]);
  M = lt_warp_max(M);
  constexpr int NC = MAXD / 4 / 32;  // 16-byte chunks a lane: 4 at D = 512
  float4 o[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) o[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;
  // 32 splits at a time: lane k weighs split c0 + k, and the weights go
  // round by shuffle, so the partials' loads do not wait on one another
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int i = first + c0 + lane;
    const bool in = c0 + lane < n;
    const float w = in ? expf(ml[2 * i] - M) : 0.f;
    l += in ? w * ml[2 * i + 1] : 0.f;
    const int cnt = min(32, n - c0);
    const float* a0 = acc + static_cast<int64_t>(first + c0) * D;
#pragma unroll 8
    for (int k = 0; k < cnt; ++k) {
      const float wk = __shfl_sync(0xffffffffu, w, k);
      const float4* a = reinterpret_cast<const float4*>(a0 + k * D);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int ch = lane + 32 * c;
        if (ch < D / 4) {
          const float4 v = a[ch];
          o[c].x += wk * v.x;
          o[c].y += wk * v.y;
          o[c].z += wk * v.z;
          o[c].w += wk * v.w;
        }
      }
    }
  }
  l = lt_warp_sum(l);
  const float den = fmaxf(l, 1e-30f);
  T* dst = out + (static_cast<int64_t>(t) * H + h) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int ch = lane + 32 * c;
    if (ch < D / 4) {
      dst[4 * ch] = lt_from_f<T>(o[c].x / den);
      dst[4 * ch + 1] = lt_from_f<T>(o[c].y / den);
      dst[4 * ch + 2] = lt_from_f<T>(o[c].z / den);
      dst[4 * ch + 3] = lt_from_f<T>(o[c].w / den);
    }
  }
}

// ------------------------------------------------------------ launching

// Arguments of one call (pointers untyped, as they come through the C
// interface); ks/vs are null for bf16/f32 pools.
struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const float* ks;
  const float* vs;
  const int* block_seq;
  const int* qstart;
  const int* qlen;
  const int* kvlen;
  const int* tables;
  void* out;
  float* ws;
  int T, H, KVH, MAXB, D, window;
  float scale;
  int nsplit, split;
  cudaStream_t stream;
  RTier tier;  // sb null: untiered
};

template <typename T, bool TIER>
int launch_combine(const Args& a, int qt) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.T, (a.H + NW - 1) / NW);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, ragged_combine_kernel<T, TIER>, static_cast<const float*>(a.ws),
      a.block_seq, a.qstart, a.qlen, a.kvlen, static_cast<T*>(a.out), a.H,
      a.MAXB, a.D, a.window, a.split, a.nsplit, a.tier, qt);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV, bool Q8, int DMAX, bool TIER>
int launch_tc(const Args& a) {
  int gc = 0, qt = 0;
  const int G = a.H / a.KVH;
  tiling(G, a.D, true, gc, qt);
  auto* kernel = ragged_tc_kernel<KV, Q8, DMAX, TIER>;
  static size_t smem_set[LT_MAX_DEVICES] = {};
  const size_t smem = tc_smem<KV, Q8, DMAX, TIER>(a.D, a.split);
  const cudaError_t es = lt_set_max_smem(kernel, smem, smem_set);
  if (es != cudaSuccess) return static_cast<int>(es);
  const dim3 grid(a.T / QBLK, a.KVH * ((G + gc - 1) / gc), a.nsplit);
  kernel<<<grid, NT, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KV*>(a.kp),
      static_cast<const KV*>(a.vp), a.ks, a.vs, a.block_seq, a.qstart,
      a.qlen, a.kvlen, a.tables, a.ws, a.H, a.KVH, a.MAXB, a.D, a.scale,
      a.window, a.split, a.nsplit, gc, qt, a.tier);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_combine<__nv_bfloat16, TIER>(a, qt);
}

template <typename T, typename KV, bool Q8, int NS, bool TIER>
int launch_simt_ns(const Args& a) {
  int gc = 0, qt = 0;
  const int G = a.H / a.KVH;
  tiling(G, a.D, false, gc, qt);
  auto* kernel = ragged_simt_kernel<T, KV, Q8, NS, TIER>;
  static size_t smem_set[LT_MAX_DEVICES] = {};
  const size_t smem = simt_smem<KV, Q8, TIER>(a.D, NS, a.split);
  const cudaError_t es = lt_set_max_smem(kernel, smem, smem_set);
  if (es != cudaSuccess) return static_cast<int>(es);
  const dim3 grid(a.T / QBLK, a.KVH * ((G + gc - 1) / gc), a.nsplit);
  kernel<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.kp),
      static_cast<const KV*>(a.vp), a.ks, a.vs, a.block_seq, a.qstart,
      a.qlen, a.kvlen, a.tables, a.ws, a.H, a.KVH, a.MAXB, a.D, a.scale,
      a.window, a.split, a.nsplit, gc, qt, a.tier);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_combine<T, TIER>(a, qt);
}

// Two ring stages where they fit, else one (two f32 tiles at D = 512).
template <typename T, typename KV, bool Q8, bool TIER>
int launch_simt(const Args& a) {
  if (simt_smem<KV, Q8, TIER>(a.D, 2, a.split) <= SMEM_CAP)
    return launch_simt_ns<T, KV, Q8, 2, TIER>(a);
  return launch_simt_ns<T, KV, Q8, 1, TIER>(a);
}

// Route by shape: bf16 q up to D = 256 on the tensor cores, everything
// else (f32 q, bf16 above 256) on the SIMT variant.
template <bool Q8, bool TIER>
int route(int dtype, const Args& a) {
  using KVb = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  using KVf = typename std::conditional<Q8, int8_t, float>::type;
  if (dtype == LT_BF16) {
    if (a.D <= 128) return launch_tc<KVb, Q8, 128, TIER>(a);
    if (a.D <= TC_MAXD) return launch_tc<KVb, Q8, TC_MAXD, TIER>(a);
    return launch_simt<__nv_bfloat16, KVb, Q8, TIER>(a);
  }
  if (dtype == LT_F32) return launch_simt<float, KVf, Q8, TIER>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool Q8>
int dispatch(int dtype, const Args& a) {
  if (a.KVH <= 0 || a.H % a.KVH != 0 || a.D <= 0 || a.D % 16 != 0 ||
      a.D > MAXD || a.T % QBLK != 0 || a.MAXB <= 0 || a.split <= 0 ||
      a.split % BK != 0 || a.nsplit <= 0 ||
      static_cast<int64_t>(a.nsplit) * a.split <
          static_cast<int64_t>(a.MAXB) * PBS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.tier.sb != nullptr &&
      (!a.tier.rw || !a.tier.sinks || !a.tier.window))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.T <= 0) return 0;
  return a.tier.sb != nullptr ? route<Q8, true>(dtype, a)
                              : route<Q8, false>(dtype, a);
}

}  // namespace

// bf16/f32: q/out [T, H, D]; pools [NB, KVH, 128, D] in q's dtype;
// block_seq [T/8], qstart/qlen/kvlen [NSEQ], tables [NSEQ, MAXB] int32; ws
// holds T*H*nsplit*(D+2) floats; split is a multiple of 32 and nsplit*split
// >= MAXB*128 (both from the wrapper's shapes: ragged_split).
extern "C" int ragged_attention_launch(int dtype, const void* q,
                                       const void* kp, const void* vp,
                                       const int* block_seq,
                                       const int* qstart, const int* qlen,
                                       const int* kvlen, const int* tables,
                                       void* out, int Trows, int H, int KVH,
                                       int MAXB, int D, int window,
                                       float scale, float* ws, int nsplit,
                                       int split, void* stream) {
  const Args a = {q, kp, vp, nullptr, nullptr, block_seq, qstart, qlen,
                  kvlen, tables, out, ws, Trows, H, KVH, MAXB, D, window,
                  scale, nsplit, split, static_cast<cudaStream_t>(stream),
                  {}};
  return dispatch<false>(dtype, a);
}

// int8: pools [NB, KVH, 128, D] int8 with scales [NB, KVH, 1, 128] f32; ws,
// nsplit and split as above.
extern "C" int ragged_attention_q8_launch(
    int dtype, const void* q, const void* kq, const float* ks, const void* vq,
    const float* vs, const int* block_seq, const int* qstart,
    const int* qlen, const int* kvlen, const int* tables, void* out,
    int Trows, int H, int KVH, int MAXB, int D, int window, float scale,
    float* ws, int nsplit, int split, void* stream) {
  const Args a = {q, kq, vq, ks, vs, block_seq, qstart, qlen, kvlen, tables,
                  out, ws, Trows, H, KVH, MAXB, D, window, scale, nsplit,
                  split, static_cast<cudaStream_t>(stream), {}};
  return dispatch<true>(dtype, a);
}

// Under the KV lifecycle tier: the pools as above (q8 = 1: int8 with scales
// ks/vs; 0: bf16/f32, ks/vs null), tables [NSEQ, MAXB] the compact ring
// tables, sb/rw/sinks/window [NSEQ] int32 per sequence; keys are walked
// at true positions through ring_block_map, masked by residency, kv_pos <=
// q_pos and (kv_pos > q_pos - window or kv_pos < sinks). ws, nsplit and
// split as above (nsplit*split >= MAXB*128 covers the live keys). No
// sliding window: the tier's mask takes its place.
extern "C" int ragged_attention_tier_launch(
    int dtype, int q8, const void* q, const void* kp, const float* ks,
    const void* vp, const float* vs, const int* block_seq, const int* qstart,
    const int* qlen, const int* kvlen, const int* tables, const int* sb,
    const int* rw, const int* sinks, const int* window, void* out, int Trows,
    int H, int KVH, int MAXB, int D, float scale, float* ws, int nsplit,
    int split, void* stream) {
  if (sb == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = {q, kp, vp, ks, vs, block_seq, qstart, qlen, kvlen, tables,
                  out, ws, Trows, H, KVH, MAXB, D, 0, scale, nsplit, split,
                  static_cast<cudaStream_t>(stream),
                  RTier{sb, rw, sinks, window}};
  return q8 ? dispatch<true>(dtype, a) : dispatch<false>(dtype, a);
}

// The split pass's tiling for q in `dtype` with G query heads a KV head at
// head_dim D: GC (heads of a head group) * 65536 + QT (q blocks of a q
// tile); -1 for a dtype it does not take.
extern "C" int ragged_attention_tiling(int dtype, int G, int D) {
  if ((dtype != LT_BF16 && dtype != LT_F32) || G <= 0 || D <= 0 ||
      D % 16 != 0 || D > MAXD)
    return -1;
  int gc = 0, qt = 0;
  tiling(G, D, dtype == LT_BF16 && D <= TC_MAXD, gc, qt);
  return gc * 65536 + qt;
}
