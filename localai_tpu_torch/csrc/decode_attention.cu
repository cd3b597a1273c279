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
//   - The hot spans walk a compressed order: the sinks [0, a) then the
//     window [c, L) (with the cold tier: every sink block, then the ring),
//     tile j < g0 being true tile j and tile j >= g0 true tile j + gap, so
//     a 1024-token window at 32k walks ~40 tiles, not 1024. The live rows
//     never exceed the resident columns (MAXB*128), and the host plans
//     spans over them deep enough to stream (ops/kernels/flash_attention
//     tier_plan: 32 tiles, where decode_split's 16 blocks an SM gave ~5).
//     Each span first resolves its tiles (ring map, cold table, block
//     table) into shared memory side by side (sk_resolve), so no K/V load
//     waits on an index load and dead tiles never enter the ring. The cold
//     tier's own spans (grid x past the hot ones) walk the demoted blocks
//     alone, in raw order, found by a scan of the slot's cold table, and
//     read their int8 tiles through the Q8 ring, each element dequantized
//     in registers at the read as the reference's dequant gives it,
//     bf16(q * scale) (SK_DQ); the combine merges the hot and the cold
//     partials.
//   - A span of a slot under a policy, and a cold span, with bf16 q and
//     at most 8 heads a block, consumes its tiles on the tensor cores
//     (sk_consume_tc: mma.sync with the heads as n = 8), a few times fewer
//     instructions a tile than the SIMT consume, which set the pace.
//   - An int8 hot pool keeps the Q8 arithmetic above (the K scale on the
//     score, the V scale on p), and a full-policy slot (sentinels: sb =
//     MAXB, rw = 1, sinks = window = the context) keeps the untiered
//     launch's spans and its SIMT consume, walked in turn by the tier's
//     hot blocks, so the sentinels give the untiered paged kernel's output
//     bit for bit.
//   - Bound: the kept rows' bytes (and the demoted rows' at int8) over
//     3.35 TB/s; the untiered kernel reads every row below L.
// Geometry: D % 16 == 0 and D <= 256 (a combine thread owns D / 128 output
// columns at most 2; the bf16 ring at D = 256 takes 135 KB of shared
// memory); any G.
#include <type_traits>

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
// the KV tier's cold spans: int8 stages, dequantized at the read
constexpr int SK_NS_COLD = 4;

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
// hot int8 pools), or int8 dequantized at the read, each element bf16(q *
// its row's scale) in registers as the reference's dequant gives it, the
// scores and p then as SK_PLAIN's (SK_DQ, the KV tier's cold pool).
enum SkMode { SK_PLAIN = 0, SK_Q8 = 1, SK_DQ = 2 };

// One tile of a span: its first true position, its first cache row (dense
// or pool row, also the index of its scales), and the rows below the span's
// end; valid <= 0 is a dead tile, never loaded or consumed.
struct SkTile {
  int64_t row0;
  int t0, valid;
};

// Shared memory a tiered span keeps past its state: the span's resolved
// tiles (tmax), the cold view's demoted blocks (lmax) and a scan's warp
// counts.
__host__ __device__ __forceinline__ int sk_extra_bytes(int tmax, int lmax) {
  return 16 + static_cast<int>(sizeof(SkTile)) * tmax + 8 * lmax +
         4 * (NT / 32);
}

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

// Byte I of u (an int8 word xor 0x80808080) as its exact f32 value without
// the int -> float unit (quarter rate on the H100): the byte in the low
// mantissa bits of 2^23, minus 2^23 + 128. The value static_cast<float>
// gives, so the int8 arithmetic stays row 5's bit for bit.
template <int I>
__device__ __forceinline__ float sk_i8(uint32_t u) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | I)) -
         8388736.f;
}

// Two f32 values rounded to bf16 (the reference's dequant) and back.
__device__ __forceinline__ float2 sk_bf16_pair(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// The 16 / sizeof(KV) elements of a 16-byte K chunk as f32: as stored, the
// exact int8 values (SK_Q8), or bf16(q * s) with its row's scale s (SK_DQ).
template <typename KV, int MODE>
__device__ __forceinline__ void sk_chunk(const uint4& raw, float s,
                                         float* kf) {
  if constexpr (sizeof(KV) == 1) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t u = w[j] ^ 0x80808080u;
      kf[4 * j] = sk_i8<0>(u);
      kf[4 * j + 1] = sk_i8<1>(u);
      kf[4 * j + 2] = sk_i8<2>(u);
      kf[4 * j + 3] = sk_i8<3>(u);
    }
    if constexpr (MODE == SK_DQ) {
#pragma unroll
      for (int x = 0; x < 16; x += 2) {
        const float2 f = sk_bf16_pair(kf[x] * s, kf[x + 1] * s);
        kf[x] = f.x;
        kf[x + 1] = f.y;
      }
    }
  } else {
    const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int x = 0; x < 16 / static_cast<int>(sizeof(KV)); ++x)
      kf[x] = lt_to_f(e[x]);
  }
}

// Two adjacent V elements at p (the first at an even column) as f32, as
// sk_chunk converts K.
template <typename KV, int MODE>
__device__ __forceinline__ float2 sk_pair(const uint8_t* p, float s) {
  if constexpr (sizeof(KV) == 1) {
    const uint32_t u =
        static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) ^ 0x8080u;
    const float a = sk_i8<0>(u), b = sk_i8<1>(u);
    if constexpr (MODE == SK_DQ) return sk_bf16_pair(a * s, b * s);
    return make_float2(a, b);
  } else {
    return lt_to_f2(reinterpret_cast<const KV*>(p));
  }
}

// Shared state of a span over G heads: Qs [G][D] (pre-scaled), the ring,
// Red [SK_P][G][BK], Ps [G][BK] and the running Ms/Ls/Al [G]; `extra`
// (16-byte aligned) is the tiered span's (sk_extra_bytes).
struct SkShared {
  float *Qs, *Red, *Ps, *Ms, *Ls, *Al;
  uint8_t *ring, *extra;
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
  sh.extra = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(sh.Al + G) + 15) & ~uintptr_t(15));
  return sh;
}

// Consume one landed tile: the scores of its 32 tokens for the G heads,
// masked by ok(kpos), the online softmax, and p V into acc. The arithmetic
// of decode_split_kernel's loop (SK_PLAIN, SK_Q8), in the same order.
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
  const float skj = MODE == SK_DQ ? sc[j] : 1.f;

  // partial dot products of token j over chunks part, part + P, ...,
  // for 8 heads at a time: each K chunk is read once per 8 heads
  for (int gb = 0; gb < G; gb += 8) {
    float s[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) s[x] = 0.f;
    for (int c = part; c < cpr; c += SK_P) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kt + j * rs + c * 16);
      float kf[VEC];
      sk_chunk<KV, MODE>(raw, skj, kf);
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
        const float2 vv = sk_pair<KV, MODE>(
            vt + t * rs + d * ES, MODE == SK_DQ ? sc[SK_BK + t] : 1.f);
        a0 += pr[t] * vv.x;
        a1 += pr[t] * vv.y;
      }
      acc[2 * i] = a0;
      acc[2 * i + 1] = a1;
    }
  }
  __syncthreads();  // this stage consumed before it is refilled
}

// ---------------------------------------- tier spans on the tensor cores

// A tiered span of a slot under a policy (no bit-exact twin to keep) with
// bf16 q and at most SK_TC_HEADS heads a block runs its tile on the tensor
// cores (mma.sync m16n8k16, bf16 -> f32), the heads as the n = 8 side: S^T
// [32 tokens x 8 heads] = K [32 x D] . q^T, the four warps each taking 16
// tokens and half of D (their halves added in shared memory); the online
// softmax a warp a head on the finished scores (times d^-0.5, and for
// SK_Q8 the K scale, after the product); then O^T [D x 8] += V^T . p^T,
// each warp D/64 m16 tiles of D, V through ldmatrix.trans (bf16) or int8
// pairs converted in registers. p enters as two bf16 terms, hi = bf16(p)
// and lo = bf16(p - hi) (about 2^-17 relative, as ragged_attention.cu's
// tensor-core pass), q as given, K and V exactly (bf16, int8 values, or
// SK_DQ's bf16(q * s)): a tile costs each warp ~100 instructions where the
// SIMT consume takes ~550, which set the span's pace.
constexpr int SK_TC_HEADS = 8;
constexpr int SK_TC_PLD = SK_BK + 8;  // p rows (bf16): conflict-free reads

// shared memory of the tensor-core scratch: q [8][D+8] bf16, the two K
// halves' scores [2][8][32] f32, p's hi and lo terms [2][8][PLD] bf16, and
// the heads' rescale factors [8]
__host__ __device__ __forceinline__ int sk_tc_bytes(int D) {
  return 16 + SK_TC_HEADS * (D + 8) * 2 + 2 * SK_TC_HEADS * SK_BK * 4 +
         2 * SK_TC_HEADS * SK_TC_PLD * 2 + SK_TC_HEADS * 4;
}

struct SkTc {
  __nv_bfloat16 *Qb, *Ph, *Pl;
  float *Sp, *Al;
};

__device__ __forceinline__ SkTc sk_tc(uint8_t* p, int D) {
  SkTc tc;
  uint8_t* a = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 15) & ~uintptr_t(15));
  tc.Qb = reinterpret_cast<__nv_bfloat16*>(a);
  tc.Sp = reinterpret_cast<float*>(tc.Qb + SK_TC_HEADS * (D + 8));
  tc.Ph = reinterpret_cast<__nv_bfloat16*>(tc.Sp + 2 * SK_TC_HEADS * SK_BK);
  tc.Pl = tc.Ph + SK_TC_HEADS * SK_TC_PLD;
  tc.Al = reinterpret_cast<float*>(tc.Pl + SK_TC_HEADS * SK_TC_PLD);
  return tc;
}

__device__ __forceinline__ void sk_ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(lt_smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void sk_ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(lt_smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void sk_ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(lt_smem_u32(p))
               : "memory");
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void sk_mma(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t sk_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two int8 bytes (b0 in the low half of u) as a bf16 pair: exact (SK_Q8)
// or each times its scale and rounded once (SK_DQ: bf16(q * s)).
template <int MODE>
__device__ __forceinline__ uint32_t sk_i8_pair(uint32_t u, float s0,
                                               float s1) {
  const uint32_t x = u ^ 0x8080u;
  const float a = sk_i8<0>(x), b = sk_i8<1>(x);
  return MODE == SK_DQ ? sk_bf16x2(a * s0, b * s1) : sk_bf16x2(a, b);
}

// The span's q rows of this block (bf16, G of them) into Qb, zero rows up
// to 8 heads; p's rows past G zero, and every head's rescale 1 (the heads
// past G ride the mma as zeros).
template <typename T>
__device__ __forceinline__ void sk_tc_begin(const SkTc& tc,
                                            const T* __restrict__ q, int G,
                                            int D) {
  const int ld = D + 8;
  for (int i = threadIdx.x; i < SK_TC_HEADS * D / 8; i += NT) {
    const int g = i / (D / 8), c = (i - g * (D / 8)) * 8;
    const uint4 v = g < G ? *reinterpret_cast<const uint4*>(q + g * D + c)
                          : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(tc.Qb + g * ld + c) = v;
  }
  for (int i = threadIdx.x; i < 2 * SK_TC_HEADS * SK_TC_PLD; i += NT)
    tc.Ph[i] = __float2bfloat16(0.f);  // Ph and Pl are contiguous
  if (threadIdx.x < SK_TC_HEADS) tc.Al[threadIdx.x] = 1.f;
}

// One landed tile on the tensor cores (the block's four warps): acc [4][4]
// is the warp's O^T fragments, m16 tiles warp, warp + 4, ... of D.
template <typename KV, int MODE, class OK>
__device__ __forceinline__ void sk_consume_tc(const SkShared& sh,
                                              const SkTc& tc,
                                              const uint8_t* kt, int G, int D,
                                              float scale, int t0,
                                              float (&acc)[4][4],
                                              const OK& ok) {
  constexpr int ES = sizeof(KV);
  const int rs = D * ES + 16, qld = D + 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const uint8_t* vt = kt + SK_BK * rs;
  const float* sc = reinterpret_cast<const float*>(vt + SK_BK * rs);

  // S^T: warp -> 16 tokens (m0) and half of D's k steps
  {
    const int m0 = 16 * (warp & 1), nks = D / 16, half = (nks + 1) / 2;
    const int k0 = (warp >> 1) * half, k1 = min(nks, k0 + half);
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ks = k0; ks < k1; ++ks) {
      uint32_t a[4], b[2];
      if constexpr (ES == 2) {
        sk_ldsm_x4(a, kt + (m0 + (lane & 15)) * rs +
                          (ks * 16 + (lane >> 4) * 8) * 2);
      } else {
        // rows g, g + 8; columns 2t4 (+ 8): two bytes each
        const float s0 = MODE == SK_DQ ? sc[m0 + g] : 1.f;
        const float s1 = MODE == SK_DQ ? sc[m0 + g + 8] : 1.f;
        const uint8_t* r0 = kt + (m0 + g) * rs + ks * 16 + 2 * t4;
        const uint8_t* r1 = r0 + 8 * rs;
        a[0] = sk_i8_pair<MODE>(*reinterpret_cast<const uint16_t*>(r0), s0, s0);
        a[1] = sk_i8_pair<MODE>(*reinterpret_cast<const uint16_t*>(r1), s1, s1);
        a[2] = sk_i8_pair<MODE>(*reinterpret_cast<const uint16_t*>(r0 + 8), s0,
                                s0);
        a[3] = sk_i8_pair<MODE>(*reinterpret_cast<const uint16_t*>(r1 + 8), s1,
                                s1);
      }
      sk_ldsm_x2(b, tc.Qb + (lane & 7) * qld + ks * 16 + ((lane >> 3) & 1) * 8);
      sk_mma(c, a, b[0], b[1]);
    }
    float* sp = tc.Sp + (warp >> 1) * SK_TC_HEADS * SK_BK;
    sp[(2 * t4) * SK_BK + m0 + g] = c[0];
    sp[(2 * t4 + 1) * SK_BK + m0 + g] = c[1];
    sp[(2 * t4) * SK_BK + m0 + g + 8] = c[2];
    sp[(2 * t4 + 1) * SK_BK + m0 + g + 8] = c[3];
  }
  __syncthreads();

  for (int h = warp; h < G; h += NT / 32) {
    float s = (tc.Sp[h * SK_BK + lane] +
               tc.Sp[(SK_TC_HEADS + h) * SK_BK + lane]) * scale;
    if (MODE == SK_Q8) s *= sc[lane];  // the K scale on the finished product
    const int kpos = t0 + lane;
    const bool live = ok(kpos);
    s = live ? s : LT_NEG_INF;
    const float m_old = sh.Ms[h];
    const float m_new = fmaxf(m_old, lt_warp_max(s));
    const float p = expf(s - m_new);
    const float psum = lt_warp_sum(p);  // l sums the unscaled p
    const float pv = MODE == SK_Q8 ? (live ? p * sc[SK_BK + lane] : 0.f) : p;
    const __nv_bfloat16 hi = __float2bfloat16(pv);
    tc.Ph[h * SK_TC_PLD + lane] = hi;
    tc.Pl[h * SK_TC_PLD + lane] = __float2bfloat16(pv - __bfloat162float(hi));
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      sh.Ls[h] = sh.Ls[h] * alpha + psum;
      sh.Ms[h] = m_new;
      tc.Al[h] = alpha;
    }
  }
  __syncthreads();

  // O^T += V^T . p^T: the warp's m16 tiles of D, two k steps of 16 tokens
  const float al0 = tc.Al[2 * t4], al1 = tc.Al[2 * t4 + 1];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int d0 = 16 * (warp + 4 * mi);
    if (d0 >= D) break;
    acc[mi][0] *= al0;
    acc[mi][1] *= al1;
    acc[mi][2] *= al0;
    acc[mi][3] *= al1;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t a[4];
      if constexpr (ES == 2) {
        sk_ldsm_x4_t(a, vt + (16 * ks + (lane & 7) + ((lane >> 4) << 3)) * rs +
                            (d0 + ((lane >> 3) & 1) * 8) * 2);
      } else {
        // rows d0 + g (+ 8), tokens 16ks + 2t4 (+ 1, + 8, + 9): a byte each
        const int tk = 16 * ks + 2 * t4;
        const uint8_t* v0 = vt + tk * rs + d0 + g;
        auto pair = [&](const uint8_t* p, int t) {
          const uint32_t u = static_cast<uint32_t>(p[0]) |
                             (static_cast<uint32_t>(p[rs]) << 8);
          return sk_i8_pair<MODE>(u, MODE == SK_DQ ? sc[SK_BK + t] : 1.f,
                                  MODE == SK_DQ ? sc[SK_BK + t + 1] : 1.f);
        };
        a[0] = pair(v0, tk);
        a[1] = pair(v0 + 8, tk);
        a[2] = pair(v0 + 8 * rs, tk + 8);
        a[3] = pair(v0 + 8 * rs + 8, tk + 8);
      }
      const int pb = g * SK_TC_PLD + 16 * ks + 2 * t4;
      sk_mma(acc[mi], a, *reinterpret_cast<const uint32_t*>(tc.Ph + pb),
             *reinterpret_cast<const uint32_t*>(tc.Ph + pb + 8));
      sk_mma(acc[mi], a, *reinterpret_cast<const uint32_t*>(tc.Pl + pb),
             *reinterpret_cast<const uint32_t*>(tc.Pl + pb + 8));
    }
  }
  __syncthreads();  // this stage consumed before it is refilled
}

// The tiles kb0..kb1-1 that tile(kb) resolves, the live ones (valid > 0)
// packed in order into tt by all NT threads at once — the table walks run
// side by side, before any K/V load waits on them; returns their count.
// tmp: NT/32 ints of shared memory.
template <class TILE>
__device__ __forceinline__ int sk_resolve(SkTile* tt, int kb0, int kb1,
                                          const TILE& tile, int* tmp) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int base = 0;
  for (int c0 = kb0; c0 < kb1; c0 += NT) {
    const int kb = c0 + tid;
    SkTile tl = {0, 0, 0};
    if (kb < kb1) tl = tile(kb);
    const bool live = kb < kb1 && tl.valid > 0;
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (lane == 0) tmp[warp] = __popc(m);
    __syncthreads();
    int off = base, tot = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      off += w < warp ? tmp[w] : 0;
      tot += tmp[w];
    }
    if (live) tt[off + __popc(m & ((1u << lane) - 1))] = tl;
    base += tot;
    __syncthreads();
  }
  return base;
}

// One span of tiles [kb0, kb1) for G heads: tile(kb) gives each tile's
// source (SkTile), ok(kpos) the token mask; writes the heads' f32 partials
// (m, l, acc[D]) at ml (head g at + 2 * g * nsw) and accw (head g at + g *
// nsw * D), nsw the workspace's splits a head. q: the block's first head.
// The span's tiles are resolved first (sk_resolve into tt), so no K/V
// load waits on a table; dead tiles never enter the ring. TC: the tiles on
// the tensor cores (sk_consume_tc; bf16 q, G <= SK_TC_HEADS), its scratch
// past tt's (tmax tiles, then sk_tc_bytes).
template <typename T, typename KV, int MODE, int NS, bool TC = false,
          class TILE, class OK>
__device__ __forceinline__ void sk_span(uint8_t* raw, SkTile* tt, int* tmp,
                                        const T* __restrict__ q,
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
  const int n = sk_resolve(tt, kb0, kb1, tile, tmp);
  auto load = [=](int i) {
    sk_load<KV, MODE>(sh.ring + (i % NS) * stage, kc, vc, ksc, vsc, tt[i], D);
  };
  // the first NS-1 tiles in flight, one commit group each (possibly empty)
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n) load(i);
    lt_cp_async_commit();
  }

  for (int g = tid; g < G; g += NT) {
    sh.Ms[g] = LT_NEG_INF;
    sh.Ls[g] = 0.f;
  }
  if constexpr (TC) {
    const SkTc tc = sk_tc(reinterpret_cast<uint8_t*>(tmp + NT / 32), D);
    sk_tc_begin(tc, q, G, D);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int i = 0; i < n; ++i) {
      if (i + NS - 1 < n) load(i + NS - 1);
      lt_cp_async_commit();
      lt_cp_async_wait<NS - 1>();  // tile i landed
      __syncthreads();
      sk_consume_tc<KV, MODE>(sh, tc, sh.ring + (i % NS) * stage, G, D, scale,
                              tt[i].t0, acc, ok);
    }
    // acc[mi]: rows d0 + g (+ 8) of D, heads 2t4, 2t4 + 1
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int d0 = 16 * (warp + 4 * mi);
      if (d0 >= D) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = 2 * t4 + (j & 1), d = d0 + g + 8 * (j >> 1);
        if (h < G) accw[static_cast<int64_t>(h) * nsw * D + d] = acc[mi][j];
      }
    }
    for (int g2 = tid; g2 < G; g2 += NT) {
      ml[2 * g2 * nsw] = sh.Ms[g2];
      ml[2 * g2 * nsw + 1] = sh.Ls[g2];
    }
    return;
  }
  lt_load_tile(sh.Qs, D, q, D, G, G, D, scale);
  float acc[2 * SK_MAXP];
#pragma unroll
  for (int i = 0; i < 2 * SK_MAXP; ++i) acc[i] = 0.f;

  for (int i = 0; i < n; ++i) {
    if (i + NS - 1 < n) load(i + NS - 1);
    lt_cp_async_commit();
    lt_cp_async_wait<NS - 1>();  // tile i landed
    __syncthreads();
    sk_consume<KV, MODE>(sh, sh.ring + (i % NS) * stage, G, D, tt[i].t0, acc,
                         ok);
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
// split_f: the span of a full-policy slot (the untiered kernel's).
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
  int split_f;
};

// One slot's plan: true length L, its current raw block cur, the ring's
// first resident raw block ring_lo, and the hot view's live tiles. The
// hot view's live positions are [0, a) U [c, L) — the sinks (and, cold,
// every sink block) and the window (cold: the ring) — walked as nhot
// tiles: tile j < g0 is true tile j, tile j >= g0 true tile j + gap, so a
// 1024-token window at 32k walks ~40 tiles, not 1024. full: a full-policy
// slot (sb >= the table width, the ring map the identity).
struct TierRow {
  int L, cur, sb, rw, sinks, window, ring_lo, g0, gap, nhot;
  bool full;
};

__device__ __forceinline__ TierRow tier_row(const TierArgs& ta, int b, int L,
                                            bool cold, int MAXB) {
  TierRow r;
  r.L = max(L, 0);
  r.sb = ta.sb[b];
  r.rw = max(ta.rw[b], 1);
  r.full = r.sb >= MAXB;
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
  return r;
}

// Tiles a hot span of the slot takes: a full-policy slot keeps the
// untiered kernel's spans (split_f), so its output is row 3/5's bit for
// bit; a slot under a policy the tier's deeper spans (split).
__device__ __forceinline__ int tier_hot_tiles(const TierRow& r,
                                              const TierArgs& ta, int split) {
  return (r.full ? ta.split_f : split) / SK_BK;
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

// The slot's demoted blocks below L (cold-table entries != 0), counted by
// all NT threads; tmp: NT/32 ints of shared memory. The cold view walks
// their tiles in raw order, PBS / SK_BK a block.
__device__ __forceinline__ int tier_cold_blocks(const TierArgs& ta, int b,
                                                int L, int* tmp) {
  const int lim = min(ta.cmaxb, (L + PBS - 1) / PBS);
  const int* row = ta.ctab + static_cast<int64_t>(b) * ta.cmaxb;
  int c = 0;
  for (int r = threadIdx.x; r < lim; r += NT) c += row[r] != 0;
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0) tmp[threadIdx.x >> 5] = c;
  __syncthreads();
  int tot = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) tot += tmp[w];
  __syncthreads();
  return tot;
}

// The slot's demoted blocks of rank k0..k1-1 (in raw order, below L) into
// list as (raw block, cold block), by all NT threads.
__device__ __forceinline__ void tier_cold_list(const TierArgs& ta, int b,
                                               int L, int k0, int k1,
                                               int2* list, int* tmp) {
  const int lim = min(ta.cmaxb, (L + PBS - 1) / PBS);
  const int* row = ta.ctab + static_cast<int64_t>(b) * ta.cmaxb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int base = 0;
  for (int r0 = 0; r0 < lim && base < k1; r0 += NT) {
    const int r = r0 + tid;
    const int ci = r < lim ? row[r] : 0;
    const unsigned m = __ballot_sync(0xffffffffu, ci != 0);
    if (lane == 0) tmp[warp] = __popc(m);
    __syncthreads();
    int off = base, tot = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      off += w < warp ? tmp[w] : 0;
      tot += tmp[w];
    }
    const int rank = off + __popc(m & ((1u << lane) - 1));
    if (ci != 0 && rank >= k0 && rank < k1) list[rank - k0] = make_int2(r, ci);
    base += tot;
    __syncthreads();
  }
}

// Splits of each view a slot's combine reads (the split pass writes a
// partial for each): hot [0, nh), cold [nsplit, nsplit + nc); ncold: the
// cold view's tiles.
__device__ __forceinline__ void tier_splits(const TierRow& r,
                                            const TierArgs& ta, int split,
                                            int nsplit, int ncold, int& nh,
                                            int& nc) {
  const int th = tier_hot_tiles(r, ta, split);
  nh = min(nsplit, (r.nhot + th - 1) / th);
  nc = 0;
  if (ta.ctab != nullptr) {
    const int tc = ta.split_c / SK_BK;
    nc = min(ta.nsplit_c, (ncold + tc - 1) / tc);
  }
}

// The tiered split pass over true positions, grid (nsplit [+ nsplit_c],
// KVH * ngrp, B): blocks below nsplit walk the hot view's live tiles
// through the ring map (SK_PLAIN, or SK_Q8 on an int8 hot pool) in spans of
// tier_hot_tiles; the others (COLD) the demoted blocks' tiles alone, in
// raw order (SK_DQ, NSC stages). Each span resolves its tiles into shared
// memory first (sk_resolve). Token mask: pos < L and, without the cold
// tier, (pos >= L - window or pos < sinks). Workspace as
// decode_split_kernel's with nsplit + nsplit_c splits a head.
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
  const TierRow r = tier_row(ta, b, lengths[b], COLD, MAXB);
  // hot blocks a (slot, head group): the grid's x less the cold splits
  const int nhx = static_cast<int>(gridDim.x) - (COLD ? ta.nsplit_c : 0);
  const bool cold = COLD && static_cast<int>(blockIdx.x) >= nhx;
  // the extra shared memory: the span's tiles, the cold list, a scan's
  // counts (sk_extra_bytes)
  const int tmax = max(max(split, ta.split_f), COLD ? ta.split_c : 0) / SK_BK;
  const int lmax = COLD ? ta.split_c / SK_BK / (PBS / SK_BK) + 2 : 0;
  const int nsw = nsplit + (COLD ? ta.nsplit_c : 0);
  const int64_t head0 = static_cast<int64_t>(b) * H + kh * GA + g0;
  // the partials of workspace split `part` (hot below nsplit, cold above)
  auto ml_at = [=](int part) { return ws + 2 * (head0 * nsw + part); };
  auto acc_at = [=](int part) {
    return ws + 2 * static_cast<int64_t>(gridDim.z) * H * nsw +
           (head0 * nsw + part) * D;
  };
  const int L = r.L;
  if constexpr (COLD) {
    if (cold) {
      SkTile* tt = reinterpret_cast<SkTile*>(
          sk_shared<int8_t, SK_DQ, NSC>(sk_raw, G, D).extra);
      int2* list = reinterpret_cast<int2*>(tt + tmax);
      int* tmp = reinterpret_cast<int*>(list + lmax);
      const int sp = blockIdx.x - nhx, tpc = ta.split_c / SK_BK;
      const int ncold = (PBS / SK_BK) * tier_cold_blocks(ta, b, L, tmp);
      const int kb0 = sp * tpc, kb1 = min(kb0 + tpc, ncold);
      // past the view's live tiles: the combine reads no partial of it
      if (kb1 <= kb0) return;
      const int k0 = kb0 / (PBS / SK_BK);
      tier_cold_list(ta, b, L, k0, (kb1 + PBS / SK_BK - 1) / (PBS / SK_BK),
                     list, tmp);
      auto tile = [=](int kb) {
        const int2 e = list[kb / (PBS / SK_BK) - k0];  // (raw, cold block)
        const int off = (kb % (PBS / SK_BK)) * SK_BK;
        const int t0 = e.x * PBS + off;
        return SkTile{(static_cast<int64_t>(e.y) * KVH + kh) * PBS + off, t0,
                      min(SK_BK, L - t0)};
      };
      auto ok = [=](int kpos) { return kpos < L; };
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        if (G <= SK_TC_HEADS) {
          sk_span<T, int8_t, SK_DQ, NSC, true>(
              sk_raw, tt, tmp, q + head0 * D, ta.ckq, ta.cvq, ta.cks, ta.cvs,
              ml_at(nsplit + sp), acc_at(nsplit + sp), nsw, G, D, scale, kb0,
              kb1, tile, ok);
          return;
        }
      }
      sk_span<T, int8_t, SK_DQ, NSC>(
          sk_raw, tt, tmp, q + head0 * D, ta.ckq, ta.cvq, ta.cks, ta.cvs,
          ml_at(nsplit + sp), acc_at(nsplit + sp), nsw, G, D, scale, kb0, kb1,
          tile, ok);
      return;
    }
  }
  // the slot's hot spans blockIdx.x, + nhx, ... below the workspace's
  // nsplit: one a block for a slot under a policy, several for a
  // full-policy slot, whose spans (split_f) may outnumber the grid's hot
  // width (its rows past MAXB*128, were there any, are not resident)
  const int tps = tier_hot_tiles(r, ta, split);
  if (static_cast<int>(blockIdx.x) * tps >= r.nhot) return;
  SkTile* tt = reinterpret_cast<SkTile*>(
      sk_shared<KV, Q8 ? SK_Q8 : SK_PLAIN, NS>(sk_raw, G, D).extra);
  int* tmp = reinterpret_cast<int*>(reinterpret_cast<int2*>(tt + tmax) + lmax);
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
  constexpr int HM = Q8 ? SK_Q8 : SK_PLAIN;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // a slot under a policy: its one span on the tensor cores
    if (!r.full && G <= SK_TC_HEADS) {
      const int sp = blockIdx.x;
      sk_span<T, KV, HM, NS, true>(
          sk_raw, tt, tmp, q + head0 * D, kc, vc, ksc, vsc, ml_at(sp),
          acc_at(sp), nsw, G, D, scale, sp * tps, min(sp * tps + tps, r.nhot),
          tile, ok);
      return;
    }
  }
  for (int sp = blockIdx.x; sp < nsplit && sp * tps < r.nhot; sp += nhx) {
    if (sp != static_cast<int>(blockIdx.x)) __syncthreads();
    sk_span<T, KV, HM, NS>(
        sk_raw, tt, tmp, q + head0 * D, kc, vc, ksc, vsc, ml_at(sp),
        acc_at(sp), nsw, G, D, scale, sp * tps, min(sp * tps + tps, r.nhot),
        tile, ok);
  }
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
  __shared__ int ctmp[NT / 32];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int n1, n2 = 0, nsw = nsplit;
  if (TIER) {
    const bool cold = ta.ctab != nullptr;
    const int ncold =
        cold ? (PBS / SK_BK) * tier_cold_blocks(ta, b, lengths[b], ctmp) : 0;
    tier_splits(tier_row(ta, b, lengths[b], cold, Tlen / PBS), ta, split,
                nsplit, ncold, n1, n2);
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
// combine; shared memory for the larger of the two span kinds, each with
// its resolved tiles and the cold list (sk_extra_bytes).
template <typename T, typename KV, bool Q8, int NS, bool GROUPED, bool COLD>
int launch_tier_groups(const SplitArgs& a, int GC, int ngrp) {
  const int tmax =
      max(max(a.split, a.tier.split_f), COLD ? a.tier.split_c : 0) / SK_BK;
  const int lmax = COLD ? a.tier.split_c / SK_BK / (PBS / SK_BK) + 2 : 0;
  const size_t extra = sk_extra_bytes(tmax, lmax) + sk_tc_bytes(a.D);
  size_t smem = sk_smem<KV, Q8, NS>(GC, a.D) + extra;
  if (COLD) {
    const size_t sc = sk_smem<int8_t, true, SK_NS_COLD>(GC, a.D) + extra;
    smem = sc > smem ? sc : smem;
  }
  auto* kernel = decode_tier_kernel<T, KV, Q8, NS, SK_NS_COLD, GROUPED, COLD>;
  static size_t smem_set[LT_MAX_DEVICES] = {};
  const cudaError_t ea = lt_set_max_smem(kernel, smem, smem_set);
  if (ea != cudaSuccess) return static_cast<int>(ea);
  // hot blocks: the tier's spans over the table (full-policy slots walk
  // their more numerous spans in turn), then the cold splits
  const int nx = (a.Tlen + a.split - 1) / a.split +
                 (COLD ? a.tier.nsplit_c : 0);
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
  if (!t.rw || !t.sinks || !t.window || t.split_f <= 0 ||
      t.split_f % SK_BK != 0 ||
      static_cast<int64_t>(a.nsplit) * t.split_f < a.Tlen)
    return true;
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
// Hot spans: split tokens a span for a slot under a policy, split_f for a
// full-policy slot (sb >= MAXB: the untiered launch's span), nsplit of
// them at most (nsplit * min(split, split_f) >= MAXB*128).
// ws holds B*H*(nsplit + nsplit_c)*(D+2) floats. No sliding window: the
// tier's mask takes its place.
extern "C" int decode_attention_tier_launch(
    int dtype, int q8, const void* q, const void* kp, const float* ks,
    const void* vp, const float* vs, const int* table, const int* lengths,
    const int* sb, const int* rw, const int* sinks, const int* window,
    const int* ctab, int cmaxb, const int8_t* ckq, const float* cks,
    const int8_t* cvq, const float* cvs, void* out, float* ws, int B, int H,
    int KVH, int MAXB, int D, float scale, int nsplit, int split, int split_f,
    int nsplit_c, int split_c, void* stream) {
  if (sb == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const TierArgs t = {sb,      rw,
                      sinks,   window,
                      ctab,    cmaxb,
                      ckq,     cks,
                      cvq,     cvs,
                      ctab ? nsplit_c : 0, ctab ? split_c : 0,
                      split_f};
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
