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
// read over 3.35 TB/s. The card has 132 SMs, and one (slot, KV head) row
// walked by one block leaves most of them idle (8 slots x 8 KV heads is 64
// blocks) and serializes a long row.
//
// Split-KV, two launches, for every mode: dense bf16/f32
// (decode_attention_launch), dense int8 (decode_attention_q8_launch) and
// both paged modes, bf16/f32 and int8 (decode_attention_paged_launch,
// decode_attention_q8_paged_launch).
//   - Split pass, grid (nsplit, KVH * ngrp, B): a block takes one
//     contiguous span of `split` tokens of one (slot, KV head) for one
//     group of at most GC = min(G, 1024 / D) of the KV head's G = H/KVH
//     query heads (ngrp = ceil(G / GC) groups; the last may be partial: G
//     = 16 at D = 128 is 8 + 8, G = 7 one group). It keeps those heads in
//     shared memory (f32, pre-scaled) and streams the span's K/V rows
//     through a ring of 32-token tiles (16-byte cp.async; SK_NS_* stages by
//     K/V type, which decode_split_stages reports), so several tiles of
//     copies are in flight while one is consumed; rows at/past `length`
//     are zero-filled, never read. With ngrp > 1 each group's blocks read
//     the same K/V span, the second time mostly from the 50 MB L2. Tile
//     rows are padded by 16 bytes, so 16-byte reads down a column of 32
//     rows hit distinct banks. Paged: a 32-token tile never straddles a
//     128-token block, so each tile reads one table entry, and only tiles
//     below the length are loaded (the O(valid tokens) property of the
//     Pallas index-map clamp). int8: the tile's 32 K and 32 V scales are
//     contiguous (128 bytes each, at the tile's first row in the flattened
//     scale pool, dense or paged) and ride in the same stage and commit
//     group; the summed score is multiplied by its K scale and then
//     masked, and p times its V scale (0 outside the mask: a reused
//     block's tail holds a freed slot's stale scales) goes into the value
//     product while l sums the unscaled p. It writes f32 partials (m, l,
//     acc[D]) of each of its heads to a workspace. A block whose span
//     starts at/past `length` exits at once, before any table read (the
//     combine never reads it); one whose span ends before the window
//     writes the empty partial (NEG_INF, 0, 0) and loads nothing.
//   - Combine pass, grid (H, B): M = max m_i, l = sum e^(m_i-M) l_i, out =
//     sum e^(m_i-M) acc_i / max(l, 1e-30) over the splits below
//     ceil(len/split) only; with the finite NEG_INF an empty split adds 0,
//     and a row with no split left comes out 0. It is a programmatic
//     dependent launch: its launch overlaps the split pass, and it waits
//     for that grid on the device (griddepcontrol), which hides most of a
//     second launch's cost.
//   - nsplit and split come from shapes alone (T, B*KVH, the SM count:
//     ops/kernels/flash_attention.decode_split), never from `lengths`, so a
//     decode step needs no device sync; split is a multiple of the tile.
// The KV lifecycle tier (decode_attention_tier_launch; no Pallas kernel:
// the reference reads tiered KV through XLA twins, models/llama.py
// _decode_dq) runs the same split pass over TRUE positions of compact ring
// tables: per slot, sink blocks sb, ring width rw, retained sinks and
// window, and optionally a cold table and int8 cold pools.
//   - A raw block reads from the cold pool where the cold table has it,
//     else from the hot pool through ring_block_map (sb + (raw - sb) % rw)
//     where it is resident (raw < sb, or cur - rw < raw <= cur), else not
//     at all (a dead tile: no load, no compute). Token mask: pos < L and,
//     without the cold tier, pos >= L - window or pos < sinks.
//   - The hot splits walk a compressed order: the sinks [0, a) then the
//     window [c, L) (with the cold tier: every sink block, then the ring),
//     tile j < g0 being true tile j and tile j >= g0 true tile j + gap, so
//     a 1024-token window at 32k walks ~40 tiles, not 1024; the live rows
//     never exceed the resident columns, so decode_split over MAXB*128
//     covers them. The cold tier's own splits (grid x beyond nsplit) walk
//     every tile below L and load the demoted ones, dequantized once a tile
//     into a bf16 staging tile as the reference's dequant gives them,
//     bf16(q * scale); the combine merges the hot and the cold partials.
//   - An int8 hot pool keeps the Q8 arithmetic above, so full-policy
//     sentinels (sb = MAXB, rw = 1, sinks = window = the context) give the
//     untiered paged kernel's output bit for bit.
//   - Bound: the kept rows' bytes (and the demoted rows' at int8) over
//     3.35 TB/s; the untiered kernel reads every row below L.
// Geometry: D % 16 == 0 and D <= 256 (a combine thread owns D / 128 output
// columns at most 2; the bf16 ring at D = 256 takes 135 KB of shared
// memory); any G.
#include "common.cuh"

namespace {

constexpr int NT = 128;    // 4 warps
constexpr int PBS = 128;   // paged block size (tokens); PBS % SK_BK == 0
constexpr int SK_MAXD = 256;  // largest head_dim

bool bad_geometry(int H, int KVH, int D) {
  return KVH <= 0 || H % KVH != 0 || D % 16 != 0 || D <= 0 || D > SK_MAXD;
}


// ---------------------------------------------------------------- split-KV

// Two adjacent elements (the first at an even index) as f32.
__device__ __forceinline__ float2 lt_to_f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 lt_to_f2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 lt_to_f2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}

constexpr int SK_BK = 32;     // tokens per tile (one per lane in the softmax)
constexpr int SK_P = NT / SK_BK;  // threads sharing one token's dot products
constexpr int SK_MAXP = 4;    // (d, d+1) output pairs a thread: GC*D <= 1024

// Query heads of one split-pass block: GC = min(G, 1024 / D) of the KV
// head's G, so its GC*D outputs fit SK_MAXP pairs a thread.
__host__ __device__ __forceinline__ int sk_group(int G, int D) {
  const int c = 2 * SK_MAXP * NT / D;
  return G < c ? G : c;
}

// First cache row of the tile at token t0: dense [B, KVH, T] rows, or paged
// block table[b, t0/128] of the pool's [NB, KVH, 128] rows. The int8
// scales of the tile start at the same index of the flattened scale pool.
template <bool PAGED>
__device__ __forceinline__ int64_t tile_row0(const int* table, int b, int kh,
                                             int KVH, int Tlen, int t0) {
  if (PAGED) {
    const int64_t pb =
        table[static_cast<int64_t>(b) * (Tlen / PBS) + t0 / PBS];
    return (pb * KVH + kh) * PBS + t0 % PBS;
  }
  return (static_cast<int64_t>(b) * KVH + kh) * Tlen + t0;
}

// Ring stages of the split pass by K/V type: 4 of bf16 tiles (17 KB each at
// D=128), 2 of f32 (34 KB), 4 of int8 (9.3 KB; 4 beat 6 and 8 on the H100,
// chip_stage_sweep.py: a 4-tile span never has more than 4 tiles in
// flight, so a deeper ring only costs occupancy).
constexpr int SK_NS_BF16 = 4;
constexpr int SK_NS_F32 = 2;
constexpr int SK_NS_Q8 = 4;

// Bytes of one ring stage: the K and V tiles (rows padded by 16 bytes),
// then, for int8, the tile's 32 K scales and 32 V scales (f32).
template <typename KV, bool Q8>
__host__ __device__ __forceinline__ int sk_stage_bytes(int D) {
  return 2 * SK_BK * (D * static_cast<int>(sizeof(KV)) + 16) +
         (Q8 ? 2 * SK_BK * static_cast<int>(sizeof(float)) : 0);
}

// Shared-memory bytes of the split pass with NS stages.
template <typename KV, bool Q8, int NS>
size_t sk_smem(int G, int D) {
  return sizeof(float) * static_cast<size_t>(G) * D +               // Qs
         static_cast<size_t>(NS) * sk_stage_bytes<KV, Q8>(D) +      // ring
         sizeof(float) * (static_cast<size_t>(SK_P + 1) * G * SK_BK +
                          3 * G);                             // Red, Ps, state
}

// How a split-pass span reads a tile's K/V: as stored (bf16/f32), int8
// with the K scale on the finished score and the V scale on p (SK_Q8, the
// hot int8 pools), or int8 dequantized to bf16(q * scale) once a tile into
// a shared staging tile and read from there as bf16 (SK_DQ, the KV tier's
// cold pool: the reference's dequant, which rounds to bf16).
enum SkMode { SK_PLAIN = 0, SK_Q8 = 1, SK_DQ = 2 };

// Bytes of SK_DQ's bf16 staging tile (K rows then V rows, padded as the
// ring's), and the shared memory of a cold span with NS ring stages.
__host__ __device__ __forceinline__ int sk_stage_dq_bytes(int D) {
  return 2 * SK_BK * (2 * D + 16);
}
template <int NS>
size_t sk_smem_dq(int G, int D) {
  return sk_smem<int8_t, true, NS>(G, D) + 16 + sk_stage_dq_bytes(D);
}

// One tile of a span: its first true position, its first cache row (dense
// or pool row, also the index of its scales), and the rows below the span's
// end; valid <= 0 is a dead tile, never loaded or consumed.
struct SkTile {
  int64_t row0;
  int t0, valid;
};

// Issue the cp.async copies of one tile into a ring stage: K rows, then V
// rows (padded by 16 bytes), then for int8 the tile's 32 K and 32 V scales.
// Rows at/past `valid` are zero-filled, never read.
template <typename KV, int MODE>
__device__ __forceinline__ void sk_load(uint8_t* kt, const KV* __restrict__ kc,
                                        const KV* __restrict__ vc,
                                        const float* __restrict__ ksc,
                                        const float* __restrict__ vsc,
                                        const SkTile& tl, int D) {
  constexpr int VEC = 16 / sizeof(KV);
  const int rs = D * static_cast<int>(sizeof(KV)) + 16;
  const int cpr = D / VEC;  // 16-byte chunks per row
  const int tid = threadIdx.x;
  uint8_t* vt = kt + SK_BK * rs;
  for (int i = tid; i < SK_BK * cpr; i += NT) {
    const int r = i / cpr, c = i - r * cpr;
    const bool ok = r < tl.valid;
    const int64_t off = (tl.row0 + (ok ? r : 0)) * D + c * VEC;
    lt_cp_async16(kt + r * rs + c * 16, kc + off, ok);
    lt_cp_async16(vt + r * rs + c * 16, vc + off, ok);
  }
  if (MODE != SK_PLAIN && tid < 2 * SK_BK / 4) {
    // 8 chunks of 4 K scales, then 8 of 4 V scales; a chunk wholly past
    // the end is zero-filled (a partial one is masked when used)
    const int c = tid % (SK_BK / 4);
    const bool ok = 4 * c < tl.valid;
    const float* src =
        (tid < SK_BK / 4 ? ksc : vsc) + tl.row0 + (ok ? 4 * c : 0);
    lt_cp_async16(vt + SK_BK * rs + tid * 16, src, ok);
  }
}

// The landed int8 tile at kt (K rows, V rows, then their 32 + 32 scales)
// as bf16(q * scale) rows into the staging tile stg, the layout of a bf16
// ring stage; the block synchronises before stg is read.
__device__ __forceinline__ void sk_dequant_tile(uint8_t* stg,
                                                const uint8_t* kt, int D) {
  const int rs8 = D + 16, rs16 = 2 * D + 16;
  const float* sc = reinterpret_cast<const float*>(kt + 2 * SK_BK * rs8);
  const int cpr = D / 16;  // 16-byte int8 chunks a row
  for (int i = threadIdx.x; i < 2 * SK_BK * cpr; i += NT) {
    const int r = i / cpr, c = i - r * cpr;  // rows 0..31 K, 32..63 V
    const uint4 raw = *reinterpret_cast<const uint4*>(kt + r * rs8 + c * 16);
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
    const float s = sc[r];  // K scales [0, 32), V scales [32, 64)
    uint32_t w[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(
          static_cast<float>(e[2 * x]) * s,
          static_cast<float>(e[2 * x + 1]) * s);
      w[x] = *reinterpret_cast<const uint32_t*>(&h);
    }
    uint4* dst = reinterpret_cast<uint4*>(stg + r * rs16 + c * 32);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
  __syncthreads();
}

// Shared state of a span over G heads: Qs [G][D] (pre-scaled), the ring,
// Red [SK_P][G][BK], Ps [G][BK] and the running Ms/Ls/Al [G].
struct SkShared {
  float *Qs, *Red, *Ps, *Ms, *Ls, *Al;
  uint8_t* ring;
};

template <typename KV, int MODE, int NS>
__device__ __forceinline__ SkShared sk_shared(uint8_t* raw, int G, int D) {
  SkShared sh;
  sh.Qs = reinterpret_cast<float*>(raw);
  sh.ring = raw + sizeof(float) * G * D;
  constexpr bool SCALED = MODE != SK_PLAIN;  // int8 tiles carry scales
  sh.Red = reinterpret_cast<float*>(sh.ring +
                                    NS * sk_stage_bytes<KV, SCALED>(D));
  sh.Ps = sh.Red + SK_P * G * SK_BK;
  sh.Ms = sh.Ps + G * SK_BK;
  sh.Ls = sh.Ms + G;
  sh.Al = sh.Ls + G;
  return sh;
}

// Consume one landed tile: the scores of its 32 tokens for the G heads,
// masked by ok(kpos), the online softmax, and p V into acc.
template <typename KV, int MODE, class OK>
__device__ __forceinline__ void sk_consume(const SkShared& sh,
                                           const uint8_t* kt, int G, int D,
                                           int t0, float (&acc)[2 * SK_MAXP],
                                           const OK& ok) {
  constexpr int ES = sizeof(KV), VEC = 16 / ES;
  const int rs = D * ES + 16;
  const int cpr = D / VEC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j = tid % SK_BK, part = tid / SK_BK;  // score thread's token
  const uint8_t* vt = kt + SK_BK * rs;
  // int8: K scales [BK], then V scales [BK]
  const float* sc = reinterpret_cast<const float*>(vt + SK_BK * rs);

  // partial dot products of token j over chunks part, part + P, ...,
  // for 8 heads at a time: each K chunk is read once per 8 heads
  for (int gb = 0; gb < G; gb += 8) {
    float s[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) s[x] = 0.f;
    for (int c = part; c < cpr; c += SK_P) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kt + j * rs + c * 16);
      const KV* e = reinterpret_cast<const KV*>(&raw);
      float kf[VEC];
#pragma unroll
      for (int x = 0; x < VEC; ++x) kf[x] = lt_to_f(e[x]);
#pragma unroll
      for (int gi = 0; gi < 8; ++gi) {
        if (gb + gi < G) {
          const float4* qr = reinterpret_cast<const float4*>(
              sh.Qs + (gb + gi) * D + c * VEC);
#pragma unroll
          for (int x = 0; x < VEC / 4; ++x) {
            const float4 qv = qr[x];
            s[gi] += qv.x * kf[4 * x] + qv.y * kf[4 * x + 1] +
                     qv.z * kf[4 * x + 2] + qv.w * kf[4 * x + 3];
          }
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < 8; ++gi)
      if (gb + gi < G) sh.Red[(part * G + gb + gi) * SK_BK + j] = s[gi];
  }
  __syncthreads();

  for (int g = warp; g < G; g += NT / 32) {
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < SK_P; ++p) s += sh.Red[(p * G + g) * SK_BK + lane];
    if (MODE == SK_Q8) s *= sc[lane];  // the K scale on the finished product
    const int kpos = t0 + lane;
    const bool live = ok(kpos);
    s = live ? s : LT_NEG_INF;
    const float m_old = sh.Ms[g];
    const float m_new = fmaxf(m_old, lt_warp_max(s));
    const float p = expf(s - m_new);
    const float psum = lt_warp_sum(p);  // l sums the unscaled p
    sh.Ps[g * SK_BK + lane] =
        MODE == SK_Q8 ? (live ? p * sc[SK_BK + lane] : 0.f) : p;
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      sh.Ls[g] = sh.Ls[g] * alpha + psum;
      sh.Ms[g] = m_new;
      sh.Al[g] = alpha;
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < SK_MAXP; ++i) {
    const int idx = tid + i * NT;
    if (idx < G * D / 2) {
      const int g = idx / (D / 2), d = 2 * (idx - g * (D / 2));
      const float* pr = sh.Ps + g * SK_BK;
      float a0 = acc[2 * i] * sh.Al[g], a1 = acc[2 * i + 1] * sh.Al[g];
#pragma unroll 8
      for (int t = 0; t < SK_BK; ++t) {
        const float2 vv =
            lt_to_f2(reinterpret_cast<const KV*>(vt + t * rs) + d);
        a0 += pr[t] * vv.x;
        a1 += pr[t] * vv.y;
      }
      acc[2 * i] = a0;
      acc[2 * i + 1] = a1;
    }
  }
  __syncthreads();  // this stage consumed before it is refilled
}

// One span of tiles [kb0, kb1) for G heads: tile(kb) gives each tile's
// source (SkTile), ok(kpos) the token mask; writes the heads' f32 partials
// (m, l, acc[D]) at ml (head g at + 2 * g * nsw) and accw (head g at + g *
// nsw * D), nsw the workspace's splits a head. q: the block's first head.
// A dead tile (valid <= 0) is skipped.
template <typename T, typename KV, int MODE, int NS, class TILE, class OK>
__device__ __forceinline__ void sk_span(uint8_t* raw, const T* __restrict__ q,
                                        const KV* __restrict__ kc,
                                        const KV* __restrict__ vc,
                                        const float* __restrict__ ksc,
                                        const float* __restrict__ vsc,
                                        float* ml, float* accw, int nsw, int G,
                                        int D, float scale, int kb0, int kb1,
                                        const TILE& tile, const OK& ok) {
  const int tid = threadIdx.x;
  const SkShared sh = sk_shared<KV, MODE, NS>(raw, G, D);
  const int stage = sk_stage_bytes<KV, MODE != SK_PLAIN>(D);
  auto load = [=](int kb) {
    const SkTile tl = tile(kb);
    if (tl.valid > 0)
      sk_load<KV, MODE>(sh.ring + ((kb - kb0) % NS) * stage, kc, vc, ksc,
                        vsc, tl, D);
  };
  // the first NS-1 tiles in flight, one commit group each (possibly empty)
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (kb0 + i < kb1) load(kb0 + i);
    lt_cp_async_commit();
  }

  lt_load_tile(sh.Qs, D, q, D, G, G, D, scale);
  for (int g = tid; g < G; g += NT) {
    sh.Ms[g] = LT_NEG_INF;
    sh.Ls[g] = 0.f;
  }
  float acc[2 * SK_MAXP];
#pragma unroll
  for (int i = 0; i < 2 * SK_MAXP; ++i) acc[i] = 0.f;

  for (int kb = kb0; kb < kb1; ++kb) {
    if (kb + NS - 1 < kb1) load(kb + NS - 1);
    lt_cp_async_commit();
    lt_cp_async_wait<NS - 1>();  // tile kb landed
    __syncthreads();
    const SkTile tl = tile(kb);
    // a dead tile (the same for every thread) is skipped: nothing read its
    // stage, and the next refill of it goes to a stage no one reads
    if (tl.valid <= 0) continue;
    const uint8_t* kt = sh.ring + ((kb - kb0) % NS) * stage;
    if constexpr (MODE == SK_DQ) {
      uint8_t* stg = reinterpret_cast<uint8_t*>(
          (reinterpret_cast<uintptr_t>(sh.Al + G) + 15) & ~uintptr_t(15));
      sk_dequant_tile(stg, kt, D);
      sk_consume<__nv_bfloat16, SK_PLAIN>(sh, stg, G, D, tl.t0, acc, ok);
    } else {
      sk_consume<KV, MODE>(sh, kt, G, D, tl.t0, acc, ok);
    }
  }
  // m and l are visible: a consumed tile ends with a barrier, and without
  // one each thread reads back only the heads it set itself

#pragma unroll
  for (int i = 0; i < SK_MAXP; ++i) {
    const int idx = tid + i * NT;
    if (idx < G * D / 2) {
      const int g = idx / (D / 2), d = 2 * (idx - g * (D / 2));
      float* a = accw + static_cast<int64_t>(g) * nsw * D + d;
      a[0] = acc[2 * i];
      a[1] = acc[2 * i + 1];
    }
  }
  for (int g = tid; g < G; g += NT) {
    ml[2 * g * nsw] = sh.Ms[g];
    ml[2 * g * nsw + 1] = sh.Ls[g];
  }
}

// This block's heads kh*GA + g0 + [0, G) of the KV head's GA = H/KVH.
// GROUPED: blockIdx.y = kh * ngrp + head group; otherwise blockIdx.y = kh
// and the block takes all GA heads (GC = GA), the case of every G*D <=
// 1024, compiled without the group arithmetic.
template <bool GROUPED>
__device__ __forceinline__ void sk_heads(int H, int KVH, int D, int& kh,
                                         int& g0, int& G) {
  const int GA = H / KVH;
  kh = blockIdx.y;
  g0 = 0;
  G = GA;
  if (GROUPED) {
    const int GC = sk_group(GA, D), ngrp = (GA + GC - 1) / GC;
    kh = blockIdx.y / ngrp;
    g0 = (blockIdx.y - kh * ngrp) * GC;
    G = min(GC, GA - g0);
  }
}

// Workspace: ml [B, H, nsplit, 2] (m, l) then acc [B, H, nsplit, D], f32.
// T is q's (and out's) type, KV the cache's: T itself, or int8 with the
// f32 scales ksc/vsc (Q8). GROUPED: blockIdx.y = kh * ngrp + head group;
// otherwise blockIdx.y = kh and the block takes all G heads (GC = G), the
// case of every G*D <= 1024, compiled without the group arithmetic.
template <typename T, typename KV, bool Q8, bool PAGED, int NS, bool GROUPED>
__global__ void __launch_bounds__(NT)
    decode_split_kernel(const T* __restrict__ q, const KV* __restrict__ kc,
                        const KV* __restrict__ vc,
                        const float* __restrict__ ksc,
                        const float* __restrict__ vsc,
                        const int* __restrict__ lengths,
                        const int* __restrict__ table, float* __restrict__ ws,
                        int H, int KVH, int Tlen, int D, float scale,
                        int window, int split, int nsplit) {
  constexpr int ES = sizeof(KV), VEC = 16 / ES;
  extern __shared__ __align__(16) uint8_t sk_raw[];
  const int GA = H / KVH;  // the KV head's query heads
  // this block's heads: kh*GA + g0 + [0, G)
  int kh = blockIdx.y, g0 = 0, G = GA;
  if (GROUPED) {
    const int GC = sk_group(GA, D), ngrp = (GA + GC - 1) / GC;
    kh = blockIdx.y / ngrp;
    g0 = (blockIdx.y - kh * ngrp) * GC;
    G = min(GC, GA - g0);
  }
  const int rs = D * ES + 16;  // padded tile row (bytes)
  const int stage = sk_stage_bytes<KV, Q8>(D);
  float* Qs = reinterpret_cast<float*>(sk_raw);  // [G][D], pre-scaled
  uint8_t* ring = sk_raw + sizeof(float) * G * D;  // NS x (K, V[, scales])
  float* Red = reinterpret_cast<float*>(ring + NS * stage);
  float* Ps = Red + SK_P * G * SK_BK;  // [G][BK] p (int8: times v scale)
  float* Ms = Ps + G * SK_BK;          // [G] running max
  float* Ls = Ms + G;                  // [G] running denominator
  float* Al = Ls + G;                  // [G] this tile's rescale factor

  // let the combine grid launch now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int sp = blockIdx.x, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(lengths[b], Tlen);
  const int wstart = window > 0 ? max(len - window, 0) : 0;
  const int lo = sp * split, hi = min(lo + split, len);
  // at/past the length: the combine reads only the splits below
  // ceil(len/split), so this one writes nothing (and reads no table entry)
  if (hi <= lo) return;
  const int64_t head0 = static_cast<int64_t>(b) * H + kh * GA + g0;
  const int64_t part0 = head0 * nsplit + sp;
  float* ml = ws + 2 * part0;  // head g at + 2 * g * nsplit
  float* accw = ws + 2 * static_cast<int64_t>(gridDim.z) * H * nsplit +
                part0 * D;     // head g at + g * nsplit * D

  if (hi <= wstart) {  // before the window: the partial that adds 0
    for (int i = tid; i < G * D; i += NT) {
      const int g = i / D;
      accw[static_cast<int64_t>(g) * nsplit * D + (i - g * D)] = 0.f;
    }
    for (int g = tid; g < G; g += NT) {
      ml[2 * g * nsplit] = LT_NEG_INF;
      ml[2 * g * nsplit + 1] = 0.f;
    }
    return;
  }

  const int kb0 = max(lo, wstart) / SK_BK;
  const int kb1 = (hi + SK_BK - 1) / SK_BK;
  const int cpr = D / VEC;  // 16-byte chunks per row
  auto load = [&](int kb) {
    const int t0 = kb * SK_BK;
    const int valid = min(SK_BK, hi - t0);
    const int64_t row0 = tile_row0<PAGED>(table, b, kh, KVH, Tlen, t0);
    uint8_t* kt = ring + ((kb - kb0) % NS) * stage;
    uint8_t* vt = kt + SK_BK * rs;
    for (int i = tid; i < SK_BK * cpr; i += NT) {
      const int r = i / cpr, c = i - r * cpr;
      const bool ok = r < valid;
      const int64_t off = (row0 + (ok ? r : 0)) * D + c * VEC;
      lt_cp_async16(kt + r * rs + c * 16, kc + off, ok);
      lt_cp_async16(vt + r * rs + c * 16, vc + off, ok);
    }
    if (Q8 && tid < 2 * SK_BK / 4) {
      // 8 chunks of 4 K scales, then 8 of 4 V scales; a chunk wholly past
      // the length is zero-filled (a partial one is masked when used)
      const int c = tid % (SK_BK / 4);
      const bool ok = 4 * c < valid;
      const float* src = (tid < SK_BK / 4 ? ksc : vsc) + row0 + (ok ? 4 * c
                                                                    : 0);
      lt_cp_async16(vt + SK_BK * rs + tid * 16, src, ok);
    }
  };
  // the first NS-1 tiles in flight, one commit group each (possibly empty)
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (kb0 + i < kb1) load(kb0 + i);
    lt_cp_async_commit();
  }

  lt_load_tile(Qs, D, q + head0 * D, D, G, G, D, scale);
  for (int g = tid; g < G; g += NT) {
    Ms[g] = LT_NEG_INF;
    Ls[g] = 0.f;
  }
  float acc[2 * SK_MAXP];
#pragma unroll
  for (int i = 0; i < 2 * SK_MAXP; ++i) acc[i] = 0.f;
  const int j = tid % SK_BK, part = tid / SK_BK;  // score thread's token

  for (int kb = kb0; kb < kb1; ++kb) {
    if (kb + NS - 1 < kb1) load(kb + NS - 1);
    lt_cp_async_commit();
    lt_cp_async_wait<NS - 1>();  // tile kb landed
    __syncthreads();
    const uint8_t* kt = ring + ((kb - kb0) % NS) * stage;
    const uint8_t* vt = kt + SK_BK * rs;
    // int8: K scales [BK], then V scales [BK]
    const float* sc = reinterpret_cast<const float*>(vt + SK_BK * rs);
    const int t0 = kb * SK_BK;

    // partial dot products of token j over chunks part, part + P, ...,
    // for 8 heads at a time: each K chunk is read once per 8 heads
    for (int gb = 0; gb < G; gb += 8) {
      float s[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) s[x] = 0.f;
      for (int c = part; c < cpr; c += SK_P) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(kt + j * rs + c * 16);
        const KV* e = reinterpret_cast<const KV*>(&raw);
        float kf[VEC];
#pragma unroll
        for (int x = 0; x < VEC; ++x) kf[x] = lt_to_f(e[x]);
#pragma unroll
        for (int gi = 0; gi < 8; ++gi) {
          if (gb + gi < G) {
            const float4* qr = reinterpret_cast<const float4*>(
                Qs + (gb + gi) * D + c * VEC);
#pragma unroll
            for (int x = 0; x < VEC / 4; ++x) {
              const float4 qv = qr[x];
              s[gi] += qv.x * kf[4 * x] + qv.y * kf[4 * x + 1] +
                       qv.z * kf[4 * x + 2] + qv.w * kf[4 * x + 3];
            }
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < 8; ++gi)
        if (gb + gi < G) Red[(part * G + gb + gi) * SK_BK + j] = s[gi];
    }
    __syncthreads();

    for (int g = warp; g < G; g += NT / 32) {
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < SK_P; ++p) s += Red[(p * G + g) * SK_BK + lane];
      if (Q8) s *= sc[lane];  // the K scale on the finished dot product
      const int kpos = t0 + lane;
      const bool ok = kpos < len && kpos >= wstart;
      s = ok ? s : LT_NEG_INF;
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, lt_warp_max(s));
      const float p = expf(s - m_new);
      const float psum = lt_warp_sum(p);  // l sums the unscaled p
      Ps[g * SK_BK + lane] = Q8 ? (ok ? p * sc[SK_BK + lane] : 0.f) : p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Ls[g] = Ls[g] * alpha + psum;
        Ms[g] = m_new;
        Al[g] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < SK_MAXP; ++i) {
      const int idx = tid + i * NT;
      if (idx < G * D / 2) {
        const int g = idx / (D / 2), d = 2 * (idx - g * (D / 2));
        const float* pr = Ps + g * SK_BK;
        float a0 = acc[2 * i] * Al[g], a1 = acc[2 * i + 1] * Al[g];
#pragma unroll 8
        for (int t = 0; t < SK_BK; ++t) {
          const float2 vv =
              lt_to_f2(reinterpret_cast<const KV*>(vt + t * rs) + d);
          a0 += pr[t] * vv.x;
          a1 += pr[t] * vv.y;
        }
        acc[2 * i] = a0;
        acc[2 * i + 1] = a1;
      }
    }
    __syncthreads();  // this stage consumed before it is refilled
  }

#pragma unroll
  for (int i = 0; i < SK_MAXP; ++i) {
    const int idx = tid + i * NT;
    if (idx < G * D / 2) {
      const int g = idx / (D / 2), d = 2 * (idx - g * (D / 2));
      float* a = accw + static_cast<int64_t>(g) * nsplit * D + d;
      a[0] = acc[2 * i];
      a[1] = acc[2 * i + 1];
    }
  }
  for (int g = tid; g < G; g += NT) {
    ml[2 * g * nsplit] = Ms[g];
    ml[2 * g * nsplit + 1] = Ls[g];
  }
}

// ------------------------------------------------------------- the KV tier

// Per-slot geometry of the KV lifecycle tier (engine/kvtier.py), [B] int32
// each: sink blocks sb, ring width rw, retained sinks and window (tokens);
// with the cold tier, its table ctab [B, cmaxb] (cold block per raw block,
// 0 = not demoted) and the cold int8 pools [NBc, KVH, 128, D] with scales
// [NBc, KVH, 1, 128], read by splits of their own (nsplit_c of split_c).
struct TierArgs {
  const int* sb;
  const int* rw;
  const int* sinks;
  const int* window;
  const int* ctab;
  int cmaxb;
  const int8_t* ckq;
  const float* cks;
  const int8_t* cvq;
  const float* cvs;
  int nsplit_c, split_c;
};

// One slot's plan: true length L, its current raw block cur, the ring's
// first resident raw block ring_lo, and the live tiles of each view. The
// hot view's live positions are [0, a) U [c, L) — the sinks (and, cold,
// every sink block) and the window (cold: the ring) — walked as ntile_hot
// tiles: tile j < g0 is true tile j, tile j >= g0 true tile j + gap, so a
// 1024-token window at 32k walks ~40 tiles, not 1024. The cold view walks
// every tile below L and skips those not demoted.
struct TierRow {
  int L, cur, sb, rw, sinks, window, ring_lo, g0, gap, nhot, ncold;
};

__device__ __forceinline__ TierRow tier_row(const TierArgs& ta, int b, int L,
                                            bool cold) {
  TierRow r;
  r.L = max(L, 0);
  r.sb = ta.sb[b];
  r.rw = max(ta.rw[b], 1);
  // the cold tier keeps every demoted or resident row: no retention mask
  // (the reference lifts the window to 1 << 30), hot rows from every sink
  // block and the ring
  r.sinks = cold ? r.sb * PBS : ta.sinks[b];
  r.window = cold ? (1 << 30) : ta.window[b];
  r.cur = r.L > 0 ? (r.L - 1) / PBS : 0;
  r.ring_lo = max(r.sb, r.cur - r.rw + 1);
  int a = min(min(r.sinks, r.L), r.sb * PBS);
  int c = max(r.L - r.window, r.ring_lo * PBS);
  a = max(a, 0);
  c = min(max(c, a), r.L);
  r.g0 = (a + SK_BK - 1) / SK_BK;
  r.gap = max(c / SK_BK, r.g0) - r.g0;
  r.nhot = (r.L + SK_BK - 1) / SK_BK - r.gap;
  r.ncold = cold ? (r.L + SK_BK - 1) / SK_BK : 0;
  return r;
}

// Physical hot block of raw block `raw` (ring_block_map through the
// table), or -1 when it is not resident (or demoted to the cold tier).
__device__ __forceinline__ int64_t tier_hot_block(const TierRow& r,
                                                  const TierArgs& ta,
                                                  const int* __restrict__ table,
                                                  int b, int MAXB, int raw) {
  int col = raw;
  if (raw >= r.sb) {
    if (raw < r.ring_lo || raw > r.cur) return -1;
    col = r.sb + (raw - r.sb) % r.rw;
  }
  if (col >= MAXB) return -1;
  if (ta.ctab != nullptr && raw < ta.cmaxb &&
      ta.ctab[static_cast<int64_t>(b) * ta.cmaxb + raw] != 0)
    return -1;
  return table[static_cast<int64_t>(b) * MAXB + col];
}

// Splits of each view a slot's combine reads (the split pass writes a
// partial for each): hot [0, nh), cold [nsplit, nsplit + nc).
__device__ __forceinline__ void tier_splits(const TierRow& r,
                                            const TierArgs& ta, int split,
                                            int nsplit, int& nh, int& nc) {
  const int th = split / SK_BK;
  nh = min(nsplit, (r.nhot + th - 1) / th);
  nc = 0;
  if (ta.ctab != nullptr) {
    const int tc = ta.split_c / SK_BK;
    nc = min(ta.nsplit_c, (r.ncold + tc - 1) / tc);
  }
}

// The tiered split pass over true positions, grid (nsplit [+ nsplit_c],
// KVH * ngrp, B): blocks below nsplit walk the hot view's live tiles
// through the ring map (SK_PLAIN, or SK_Q8 on an int8 hot pool), the others
// (COLD) the cold view's demoted tiles (SK_DQ, NSC stages). Token mask:
// pos < L and, without the cold tier, (pos >= L - window or pos < sinks).
// Workspace as decode_split_kernel's with nsplit + nsplit_c splits a head.
template <typename T, typename KV, bool Q8, int NS, int NSC, bool GROUPED,
          bool COLD>
__global__ void __launch_bounds__(NT)
    decode_tier_kernel(const T* __restrict__ q, const KV* __restrict__ kc,
                       const KV* __restrict__ vc,
                       const float* __restrict__ ksc,
                       const float* __restrict__ vsc,
                       const int* __restrict__ lengths,
                       const int* __restrict__ table, const TierArgs ta,
                       float* __restrict__ ws, int H, int KVH, int MAXB,
                       int D, float scale, int split, int nsplit) {
  extern __shared__ __align__(16) uint8_t sk_raw[];
  int kh, g0, G;
  sk_heads<GROUPED>(H, KVH, D, kh, g0, G);
  const int GA = H / KVH;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.z;
  const TierRow r = tier_row(ta, b, lengths[b], COLD);
  const bool cold = COLD && static_cast<int>(blockIdx.x) >= nsplit;
  const int sp = cold ? blockIdx.x - nsplit : blockIdx.x;
  const int tps = (cold ? ta.split_c : split) / SK_BK;  // tiles a span
  const int kb0 = sp * tps;
  const int kb1 = min(kb0 + tps, cold ? r.ncold : r.nhot);
  // past the view's live tiles: the combine reads no partial of this block
  if (kb1 <= kb0) return;
  const int nsw = nsplit + (COLD ? ta.nsplit_c : 0);
  const int64_t head0 = static_cast<int64_t>(b) * H + kh * GA + g0;
  const int64_t part0 = head0 * nsw + blockIdx.x;
  float* ml = ws + 2 * part0;
  float* accw =
      ws + 2 * static_cast<int64_t>(gridDim.z) * H * nsw + part0 * D;
  const int L = r.L;
  if constexpr (COLD) {
    if (cold) {
      auto tile = [=](int kb) {
        const int t0 = kb * SK_BK, raw = t0 / PBS;
        const int ci = raw < ta.cmaxb
                           ? ta.ctab[static_cast<int64_t>(b) * ta.cmaxb + raw]
                           : 0;
        if (ci == 0) return SkTile{0, t0, 0};
        return SkTile{(static_cast<int64_t>(ci) * KVH + kh) * PBS + t0 % PBS,
                      t0, min(SK_BK, L - t0)};
      };
      auto ok = [=](int kpos) { return kpos < L; };
      sk_span<T, int8_t, SK_DQ, NSC>(
          sk_raw, q + head0 * D, ta.ckq, ta.cvq, ta.cks, ta.cvs, ml, accw,
          nsw, G, D, scale, kb0, kb1, tile, ok);
      return;
    }
  }
  auto tile = [=](int kb) {
    const int t = kb < r.g0 ? kb : kb + r.gap;
    const int t0 = t * SK_BK;
    const int64_t pb = tier_hot_block(r, ta, table, b, MAXB, t0 / PBS);
    // a tile is live when it is resident and one of its tokens is kept
    const bool kept = t0 < min(r.sinks, L) || t0 + SK_BK > L - r.window;
    if (pb < 0 || t0 >= L || !kept) return SkTile{0, t0, 0};
    return SkTile{(pb * KVH + kh) * PBS + t0 % PBS, t0, min(SK_BK, L - t0)};
  };
  const int lw = L - r.window, snk = r.sinks;
  auto ok = [=](int kpos) { return kpos < L && (kpos >= lw || kpos < snk); };
  sk_span<T, KV, Q8 ? SK_Q8 : SK_PLAIN, NS>(
      sk_raw, q + head0 * D, kc, vc, ksc, vsc, ml, accw, nsw, G, D, scale,
      kb0, kb1, tile, ok);
}

// One block of NT threads per (q head, slot); thread tid owns outputs tid,
// tid + NT, ... below D (DC of them: 1 for D <= 128, 2 up to 256), and all
// NT stage the splits' weights in chunks of NT. Launched with programmatic
// stream serialization, it may start while the split pass still runs:
// griddepcontrol.wait holds it until that grid has finished and its writes
// are visible. The splits it reads: below ceil(len/split) of the nsplit a
// head; TIER, the tiered split pass's: the slot's hot splits [0, n1) and,
// with the cold tier, its cold splits [nsplit, nsplit + n2) of the nsplit +
// nsplit_c a head (tier_splits), merged as n1 + n2 splits in that order.
template <typename T, int DC, bool TIER>
__global__ void __launch_bounds__(NT)
    decode_combine_kernel(const float* __restrict__ ws,
                          const int* __restrict__ lengths,
                          T* __restrict__ out, int H, int Tlen, int D,
                          int split, int nsplit, const TierArgs ta) {
  __shared__ float wsm[NT], lsm[NT], red[NT / 32];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int n1, n2 = 0, nsw = nsplit;
  if (TIER) {
    const bool cold = ta.ctab != nullptr;
    tier_splits(tier_row(ta, b, lengths[b], cold), ta, split, nsplit, n1, n2);
    nsw += cold ? ta.nsplit_c : 0;
  } else {
    const int len = min(lengths[b], Tlen);
    n1 = min(nsplit, (len + split - 1) / split);
  }
  const int n = n1 + n2, off2 = nsplit - n1;
  // workspace split of the i-th split read
  auto at = [=](int i) { return TIER && i >= n1 ? i + off2 : i; };
  const int64_t row = static_cast<int64_t>(b) * H + h;
  const float* ml = ws + 2 * row * nsw;
  const float* acc = ws + 2 * static_cast<int64_t>(gridDim.y) * H * nsw +
                     row * nsw * D + tid;
  float mx = LT_NEG_INF;
  for (int i = tid; i < n; i += NT) mx = fmaxf(mx, ml[2 * at(i)]);
  mx = lt_warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  float M = red[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) M = fmaxf(M, red[w]);
  float l = 0.f, o[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) o[c] = 0.f;
  for (int c0 = 0; c0 < n; c0 += NT) {
    const int i = c0 + tid;
    const float w = i < n ? expf(ml[2 * at(i)] - M) : 0.f;
    __syncthreads();  // the previous chunk consumed
    wsm[tid] = w;
    lsm[tid] = i < n ? w * ml[2 * at(i) + 1] : 0.f;
    __syncthreads();
    const int cnt = min(NT, n - c0);
    if (tid < D) {
#pragma unroll 8
      for (int k = 0; k < cnt; ++k) {
        const float* ak = acc + static_cast<int64_t>(at(c0 + k)) * D;
#pragma unroll
        for (int c = 0; c < DC; ++c)
          if (tid + c * NT < D) o[c] += wsm[k] * ak[c * NT];
        l += lsm[k];
      }
    }
  }
#pragma unroll
  for (int c = 0; c < DC; ++c)
    if (tid + c * NT < D)
      out[row * D + tid + c * NT] = lt_from_f<T>(o[c] / fmaxf(l, 1e-30f));
}

// Arguments of one split-KV decode call (pointers untyped, as they come
// through the C interface). Tlen is T (dense) or MAXB*128 (paged); ks/vs
// (int8 scales) and table (paged) are null where unused; tier.sb is null
// outside the KV tier.
struct SplitArgs {
  const void* q;
  const void* kc;
  const void* vc;
  const float* ks;
  const float* vs;
  const int* table;
  const int* lengths;
  void* out;
  float* ws;
  int B, H, KVH, Tlen, D, window;
  float scale;
  int nsplit, split;
  cudaStream_t stream;
  TierArgs tier;
};

// The combine of a split pass, as a programmatic dependent launch: its
// launch overlaps the split pass's tail; it waits for the split grid inside.
template <typename T, bool TIER>
int launch_combine(const SplitArgs& a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.H, a.B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* cws = a.ws;
  T* o = static_cast<T*>(a.out);
  const cudaError_t e2 =
      a.D <= NT ? cudaLaunchKernelEx(&cfg, decode_combine_kernel<T, 1, TIER>,
                                     cws, a.lengths, o, a.H, a.Tlen, a.D,
                                     a.split, a.nsplit, a.tier)
                : cudaLaunchKernelEx(&cfg, decode_combine_kernel<T, 2, TIER>,
                                     cws, a.lengths, o, a.H, a.Tlen, a.D,
                                     a.split, a.nsplit, a.tier);
  if (e2 != cudaSuccess) return static_cast<int>(e2);
  return static_cast<int>(cudaGetLastError());
}

// The split pass over ngrp groups of GC heads a KV head, then the combine.
template <typename T, typename KV, bool Q8, bool PAGED, int NS, bool GROUPED>
int launch_groups(const SplitArgs& a, int GC, int ngrp) {
  const size_t smem = sk_smem<KV, Q8, NS>(GC, a.D);
  static size_t smem_set[LT_MAX_DEVICES] = {};
  const cudaError_t ea = lt_set_max_smem(
      decode_split_kernel<T, KV, Q8, PAGED, NS, GROUPED>, smem, smem_set);
  if (ea != cudaSuccess) return static_cast<int>(ea);
  decode_split_kernel<T, KV, Q8, PAGED, NS, GROUPED>
      <<<dim3(a.nsplit, a.KVH * ngrp, a.B), NT, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const KV*>(a.kc),
          static_cast<const KV*>(a.vc), a.ks, a.vs, a.lengths, a.table, a.ws,
          a.H, a.KVH, a.Tlen, a.D, a.scale, a.window, a.split, a.nsplit);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_combine<T, false>(a);
}

// The tiered split pass (hot splits, then the cold tier's), then the
// combine; shared memory for the larger of the two span kinds.
template <typename T, typename KV, bool Q8, int NS, bool GROUPED, bool COLD>
int launch_tier_groups(const SplitArgs& a, int GC, int ngrp) {
  size_t smem = sk_smem<KV, Q8, NS>(GC, a.D);
  if (COLD) {
    const size_t sc = sk_smem_dq<SK_NS_Q8>(GC, a.D);
    smem = sc > smem ? sc : smem;
  }
  auto* kernel = decode_tier_kernel<T, KV, Q8, NS, SK_NS_Q8, GROUPED, COLD>;
  static size_t smem_set[LT_MAX_DEVICES] = {};
  const cudaError_t ea = lt_set_max_smem(kernel, smem, smem_set);
  if (ea != cudaSuccess) return static_cast<int>(ea);
  const int nx = a.nsplit + (COLD ? a.tier.nsplit_c : 0);
  kernel<<<dim3(nx, a.KVH * ngrp, a.B), NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.kc),
      static_cast<const KV*>(a.vc), a.ks, a.vs, a.lengths, a.table, a.tier,
      a.ws, a.H, a.KVH, a.Tlen / PBS, a.D, a.scale, a.split, a.nsplit);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_combine<T, true>(a);
}

template <typename T, typename KV, bool Q8, bool PAGED, int NS>
int launch_split(const SplitArgs& a) {
  const int G = a.H / a.KVH, GC = sk_group(G, a.D);
  const int ngrp = (G + GC - 1) / GC;
  if (PAGED && a.tier.sb != nullptr) {
    const bool cold = a.tier.ctab != nullptr;
    if (GC < G)
      return cold ? launch_tier_groups<T, KV, Q8, NS, true, true>(a, GC, ngrp)
                  : launch_tier_groups<T, KV, Q8, NS, true, false>(a, GC,
                                                                   ngrp);
    return cold ? launch_tier_groups<T, KV, Q8, NS, false, true>(a, G, 1)
                : launch_tier_groups<T, KV, Q8, NS, false, false>(a, G, 1);
  }
  if (GC < G)
    return launch_groups<T, KV, Q8, PAGED, NS, true>(a, GC, ngrp);
  return launch_groups<T, KV, Q8, PAGED, NS, false>(a, G, 1);
}

bool bad_split(const SplitArgs& a) {
  if (bad_geometry(a.H, a.KVH, a.D) || a.split <= 0 ||
      a.split % SK_BK != 0 || a.nsplit <= 0 ||
      static_cast<int64_t>(a.nsplit) * a.split < a.Tlen)
    return true;
  const TierArgs& t = a.tier;
  if (t.sb == nullptr) return false;
  if (!t.rw || !t.sinks || !t.window) return true;
  if (t.ctab == nullptr) return false;
  // the cold tier: its pools and spans, every raw block of the slot's
  // context in the cold table
  return !t.ckq || !t.cks || !t.cvq || !t.cvs || t.cmaxb <= 0 ||
         t.split_c <= 0 || t.split_c % SK_BK != 0 || t.nsplit_c <= 0 ||
         static_cast<int64_t>(t.nsplit_c) * t.split_c <
             static_cast<int64_t>(t.cmaxb) * PBS;
}

template <bool PAGED>
int split_same_type(int dtype, const SplitArgs& a) {
  if (bad_split(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == LT_BF16)
    return launch_split<__nv_bfloat16, __nv_bfloat16, false, PAGED,
                        SK_NS_BF16>(a);
  if (dtype == LT_F32)
    return launch_split<float, float, false, PAGED, SK_NS_F32>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool PAGED>
int split_q8(int dtype, const SplitArgs& a) {
  // the cold tier rides a dense hot pool only (the reference's rule)
  if (bad_split(a) || a.tier.ctab != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == LT_BF16)
    return launch_split<__nv_bfloat16, int8_t, true, PAGED, SK_NS_Q8>(a);
  if (dtype == LT_F32)
    return launch_split<float, int8_t, true, PAGED, SK_NS_Q8>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Dense bf16/f32, split-KV: ws holds B*H*nsplit*(D+2) floats; split is a
// multiple of 32 and nsplit*split >= T (both from the wrapper's shapes).
extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* kc, const void* vc,
                                       const int* lengths, void* out,
                                       float* ws, int B, int H, int KVH,
                                       int Tlen, int D, int window,
                                       float scale, int nsplit, int split,
                                       void* stream) {
  const SplitArgs a = {q, kc, vc, nullptr, nullptr, nullptr, lengths, out,
                       ws, B, H, KVH, Tlen, D, window, scale, nsplit, split,
                       static_cast<cudaStream_t>(stream), {}};
  return split_same_type<false>(dtype, a);
}

// Dense int8, split-KV: caches [B, KVH, T, D] int8 (T % 128 == 0), scales
// [B, KVH, T/128, 128] f32 (token t's at element t of the slot/head's
// strip); ws, nsplit and split as the dense launch has them.
extern "C" int decode_attention_q8_launch(
    int dtype, const void* q, const void* kq, const float* ks, const void* vq,
    const float* vs, const int* lengths, void* out, float* ws, int B, int H,
    int KVH, int Tlen, int D, int window, float scale, int nsplit, int split,
    void* stream) {
  const SplitArgs a = {q, kq, vq, ks, vs, nullptr, lengths, out, ws, B, H,
                       KVH, Tlen, D, window, scale, nsplit, split,
                       static_cast<cudaStream_t>(stream), {}};
  return split_q8<false>(dtype, a);
}

// Paged, split-KV: pools [NB, KVH, 128, D], table [B, MAXB] int32; ws,
// nsplit and split as the dense launch has them, with T = MAXB*128.
extern "C" int decode_attention_paged_launch(
    int dtype, const void* q, const void* kp, const void* vp,
    const int* table, const int* lengths, void* out, float* ws, int B, int H,
    int KVH, int MAXB, int D, int window, float scale, int nsplit, int split,
    void* stream) {
  const SplitArgs a = {q, kp, vp, nullptr, nullptr, table, lengths, out, ws,
                       B, H, KVH, MAXB * PBS, D, window, scale, nsplit, split,
                       static_cast<cudaStream_t>(stream), {}};
  return split_same_type<true>(dtype, a);
}

// Paged int8, split-KV: pools [NB, KVH, 128, D] int8, scales [NB, KVH, 1,
// 128] f32.
extern "C" int decode_attention_q8_paged_launch(
    int dtype, const void* q, const void* kq, const float* ks, const void* vq,
    const float* vs, const int* table, const int* lengths, void* out,
    float* ws, int B, int H, int KVH, int MAXB, int D, int window,
    float scale, int nsplit, int split, void* stream) {
  const SplitArgs a = {q, kq, vq, ks, vs, table, lengths, out, ws, B, H,
                       KVH, MAXB * PBS, D, window, scale, nsplit, split,
                       static_cast<cudaStream_t>(stream), {}};
  return split_q8<true>(dtype, a);
}

// Paged under the KV lifecycle tier: the pools as the paged launches take
// them (int8: q8 = 1 with scales ks/vs; bf16/f32: ks/vs null), table [B,
// MAXB] the compact ring table, sb/rw/sinks/window [B] int32 per slot; the
// cold tier (ctab non-null, dense hot pool only) adds ctab [B, cmaxb] and
// the int8 cold pools [NBc, KVH, 128, D] / scales [NBc, KVH, 1, 128], read
// by nsplit_c splits of split_c tokens (nsplit_c * split_c >= cmaxb*128).
// ws holds B*H*(nsplit + nsplit_c)*(D+2) floats. No sliding window: the
// tier's mask takes its place.
extern "C" int decode_attention_tier_launch(
    int dtype, int q8, const void* q, const void* kp, const float* ks,
    const void* vp, const float* vs, const int* table, const int* lengths,
    const int* sb, const int* rw, const int* sinks, const int* window,
    const int* ctab, int cmaxb, const int8_t* ckq, const float* cks,
    const int8_t* cvq, const float* cvs, void* out, float* ws, int B, int H,
    int KVH, int MAXB, int D, float scale, int nsplit, int split,
    int nsplit_c, int split_c, void* stream) {
  if (sb == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const TierArgs t = {sb,  rw,  sinks, window, ctab,     cmaxb,  ckq,
                      cks, cvq, cvs,   ctab ? nsplit_c : 0, ctab ? split_c : 0};
  const SplitArgs a = {q, kp, vp, ks, vs, table, lengths, out, ws, B, H, KVH,
                       MAXB * PBS, D, 0, scale, nsplit, split,
                       static_cast<cudaStream_t>(stream), t};
  return q8 ? split_q8<true>(dtype, a) : split_same_type<true>(dtype, a);
}

// Ring stages the split pass launches with for K/V in `dtype` (q8 = 0) or
// int8 (q8 = 1); 0 for a dtype it does not take.
extern "C" int decode_split_stages(int dtype, int q8) {
  if (q8) return SK_NS_Q8;
  if (dtype == LT_BF16) return SK_NS_BF16;
  if (dtype == LT_F32) return SK_NS_F32;
  return 0;
}
