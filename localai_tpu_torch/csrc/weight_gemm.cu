// Weight GEMMs that read each weight as it is stored: the int8 projections
// (W8A16), the f32 vocabulary projection (the lm head) and Mixtral's int8
// expert stacks (the grouped expert GEMM).
//
// Replaces three products that the reference leaves to XLA, which fuses
// each weight's convert into its dot (no Pallas kernel):
//   - localai_tpu/ops/quant.py:78-80 (qmatmul): y = x @ q.astype(x.dtype),
//     then y * s.astype(y.dtype); q int8 [K, N], s f32 [1, N] (one scale an
//     output channel), x bf16, f16 or f32 [M, K];
//   - localai_tpu/models/llama.py:347-364 (_lm_head): x32 f32 [M, K]
//     against a bf16/f16 head [K, V], a tied embedding [V, K] read
//     transposed, or an int8 head {q, s} with x32 rounded to bf16;
//   - localai_tpu/models/llama.py:383-409 (_moe_mlp) with int8 experts:
//     w = dequantize(q, x.dtype) = T(f32(q) * s) for q int8 [E, K, N], s
//     f32 [E, 1, N], then einsum("mk,ekn->men", x, w) (w1, w3: x [M, K]
//     shared by the experts) or einsum("mek,ekn->men", x, w) (w2: x [M, E,
//     K], expert e's own rows), out [M, E, N] in T (bf16: the int8
//     recipe's activations).
// A cast of the weight before each product would write it out and read
// it back: 14 GB of bf16 copies a decode step at 8B widths (int8), 2.1 GB
// for the head's f32 copy, and 2.8 GB a layer for Mixtral-8x7B's experts.
//
// Arithmetic (the reference's, exactly):
//   - bf16/f16 x, int8 q (EPI_ROUND): each int8 value converts to x's type
//     (exact), products sum in f32 on the tensor cores, the sum rounds once
//     to x's type, the scale rounds to x's type and their product rounds
//     again: y * s.to(y.dtype);
//   - int8 head (EPI_F32): x32 rounded to bf16 by the caller; bf16 x int8
//     products are exact in f32, summed in f32, then times s in f32;
//   - f32 x with an int8, bf16 or f16 weight (weight_gemm_simt_kernel): f32
//     FMAs of x and the weight's exact f32 value. The tensor cores would
//     round x to bf16 (or TF32), which is not the reference's arithmetic;
//   - f32 x with a bf16 head above a row count (the wrapper's head_plan;
//     head_gemm_wgmma_kernel): x splits into three bf16 terms whose sum is
//     x (split_terms_kernel), and the tensor cores multiply the head with
//     each, f32 sums: the same exact products in another order.
//
// What bounds it on the H100: at decode (M <= 16) the weight's bytes — one
// int8 byte read per element at 3.35 TB/s — and at prefill's M the bf16
// tensor cores (989 TFLOP/s; the bf16 head's three terms, three times the
// products; the SIMT route's f32 x, the 67 TFLOP/s of f32 FMA). Two
// tensor-core routes for the int8 weights, chosen by M in the wrapper:
//   - large M (weight_gemm_wgmma_kernel, M > 16): the weight is wgmma's A
//     operand and x its B operand (y^T = q^T x^T), so the int8 tile never
//     goes back to shared memory as bf16. A producer warp keeps TMA loads
//     (cp.async.bulk.tensor, 128-byte swizzle) of x tiles [BM][64] and
//     int8 tiles [64][128], read from q [K, N] as stored, in flight through
//     a ring of stages with full/empty mbarriers. Two consumer warpgroups
//     own 64 output channels each: ldmatrix.trans lifts their int8 bytes
//     straight into the A-fragment layout (two channels, two K rows a
//     register), the exact conversion (wg_pair) turns them into bf16/f16
//     pairs in registers, and wgmma m64nBMk16 multiplies them with the x
//     tile from shared memory. The fragments of tile t + 1 are converted
//     while the wgmmas of tile t run (double-buffered fragments,
//     wgmma.wait_group 1). Each int8 element is converted once per BM
//     (64 to 256, the wrapper's choice by shape) rows of x;
//   - decode (weight_gemm_gemv_kernel, M <= 16): mma.sync m16n8k16 with
//     the weight as A and x^T as B, so the 8 (or 16) columns of the tile
//     are the tokens and no row is padding but the tokens' own. Each thread
//     reads 16 channels of four K rows with 16-byte loads straight from
//     device memory, a tile of 64 K rows ahead of its products (16 loads
//     in flight a thread, tens of KB an SM), and converts them in
//     registers into the A fragments (a K and channel permutation that x's
//     fragments share); no shared-memory tile, no barrier in the loop;
//   - split-K where the output tiles alone would not fill the card (a
//     4096x1024 projection at M = 4 has 8 column tiles for 132 SMs): each
//     split writes f32 partials to a workspace the caller allocates on its
//     stream, and the last split to reach an output tile (a counter in
//     `counters`, back to 0 when it is done) sums the partials in split
//     order and applies the epilogue, in the same launch. No float atomics:
//     a call's result is the same bits every time, so CUDA graph replays
//     equal eager runs bit for bit.
// The expert GEMM (EPI_MOE) runs the same two routes with the expert as
// the grid's z axis, one launch for all experts of a projection and no
// split-K (E x the column tiles fill the card at Mixtral's widths). Its
// rounding is _moe_mlp's, not qmatmul's: each weight element becomes
// T(f32(q) * s[e, n]) in the conversion stage (wg_pair_scaled: the exact
// int8 -> T pair, each value times its channel's scale in f32, one
// rounding to T), then T x T products sum in f32 and round once to T on
// output. At decode it is bound by the stack's bytes (E*K*N int8), at
// prefill's M by the bf16 tensor cores over all E experts (dense
// dispatch computes every expert on every token, as the reference does).
// Limits: K and N multiples of 16 (16-byte rows); the M, N and K tails of a
// tile are zero-filled (TMA's out-of-bounds fill, or predicated loads) and
// never stored.
//
// int4 weights (the int4/q4 recipe; the reference's jnp.int4 payloads): the
// same three products on packed weights, built from this source with
// -DWG_INT4=1 into a library of its own (the two builds run side by side,
// each instantiating one width; the C entry points are the same). A packed
// weight is uint8 [K/2, N] (a stack [E, K/2, N]): byte (j, n) holds element
// (2j, n) in its low nibble and (2j + 1, n) in its high nibble, each a
// two's-complement value in [-7, 7]; scales as for int8. A byte's two
// nibbles are K neighbours of one channel, the pair that one register of
// an A fragment holds, so one byte becomes one T pair (wg_nib_pair: the
// nibble xor 8 in the low mantissa bits of 128 (bf16) or 1024 (f16), then
// one packed subtraction of 136 or 1032; exact). The decode route reads
// two 16-byte rows a K step of 16 (four for int8) over K tiles of 128, so
// a warp keeps int8's bytes in flight; the large-M route loads [32][128]
// byte tiles by TMA and lifts a warp's whole tile with one ldmatrix.trans
// (its rows permuted so that a register holds a fragment's four bytes). At
// decode the bound halves with the bytes; at prefill's M it stays the bf16
// tensor cores'. K must be even (a multiple of 16 here). The expert GEMM
// at decode has a kernel of its own in this build (moe_w4_stream_kernel):
// at half int8's bytes the conversion's instructions, not the bytes, set
// its time, so each nibble becomes f32 in two instructions (w4_value), and
// its blocks take equal ranges of (expert, column tile, K tile) units, so
// a stack of fewer tiles than the card's slots (w2) still fills a wave.
// The projection and the head at decode run the decode route as a
// programmatic dependent launch (weight_gemm_w4_launch): a kernel's first
// weight tile streams in under the previous kernel's tail, and only x's
// loads and the stores wait for that grid; the rounding stays qmatmul's.
#include <cuda.h>
#include <cuda_fp16.h>

#include <cstring>
#include <type_traits>

#include "common.cuh"

#ifndef WG_INT4
#define WG_INT4 0
#endif

namespace {

// the weight width this build instantiates: packed int4 or int8
constexpr bool kW4 = WG_INT4 != 0;

enum WgDtype { WG_F32 = 0, WG_BF16 = 1, WG_F16 = 2, WG_I8 = 3 };
enum WgEpi { EPI_ROUND = 0, EPI_F32 = 1, EPI_MOE = 2 };

// large-M route: blocks of BM rows x 128 output channels (64 a consumer
// warpgroup), K stages of 64; a producer warpgroup beside two consumers
constexpr int A_BN = 128, A_BK = 64;
constexpr int A_THREADS = 384;
constexpr int A_RING_BYTES = 200 * 1024;  // shared memory for the ring
// decode route: blocks of 128 output channels (16 a thread row of a warp)
// over K tiles of 64 (int4: 128, the same bytes); a warp takes every 4th
// tile of the block's split
constexpr int B_BN = 128, B_BK = kW4 ? 128 : 64, B_WARPS = 4;
// stored weight rows a K tile of the large-M route (a packed row holds two)
constexpr int A_QROWS = kW4 ? A_BK / 2 : A_BK;
// SIMT route: tiles of 8 x 512 outputs, 16 of K; 4 outputs a thread a row
constexpr int SG_BM = 8, SG_BN = 512, SG_BK = 16, SG_STAGES = 3;
constexpr int SG_THREADS = 128;
// the [BN][BK] tile of a transposed (tied) weight, rows padded to 48 bytes
// so that eight lanes' 16-byte reads of eight rows hit distinct banks
constexpr int SG_NK_LD = SG_BK + 8;
// bf16 head at large M: blocks of BN rows x 128 vocabulary columns (64 a
// consumer warpgroup) over K stages of 64; H_GROUP row tiles share a band
// of the grid's order, so the blocks in flight reuse each other's head and
// x tiles from the L2
constexpr int H_BV = 128, H_GROUP = 8;
// shared memory for the head's ring: a block's whole allowance (227 KB)
// less the alignment slack and the barriers
constexpr int H_RING_BYTES = 232448 - 1024 - 128;
// int4 expert GEMM at decode: units of 128 channels x MS_BK K rows (MS_KS
// K steps of 16) of one expert, the warp's loads one unit ahead
constexpr int MS_KS = 4, MS_BK = 16 * MS_KS;

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

// Two int8 values, bytes 0 and 2 of t (bytes 1 and 3 are not read), as a
// packed pair of T, byte 0 in the low half. Exact (an integer of at most 8
// significant bits), and without the int -> float conversion unit (16 a
// clock an SM): the byte goes into the low mantissa bits of a power of
// two, and one packed subtraction of that power (plus 128 for f16) leaves
// the value. Three instructions a pair.
template <typename T>
__device__ __forceinline__ uint32_t wg_pair(uint32_t t);
// f16: 0x64 above byte u is 1024 + u (10 mantissa bits), so 1024 + (b ^
// 0x80) - 1152 = b.
template <>
__device__ __forceinline__ uint32_t wg_pair<__half>(uint32_t t) {
  const uint32_t u = (t & 0x00FF00FFu) ^ 0x64806480u;
  uint32_t r;
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(r) : "r"(u), "r"(0x64806480u));
  return r;
}
// bf16 has 7 mantissa bits: 0x43 above the byte's low 7 bits is 128 + (b
// & 127), and subtracting 128 (b >= 0) or 256 (b < 0, 0x4380: the sign bit
// moved into the mantissa) leaves b.
template <>
__device__ __forceinline__ uint32_t wg_pair<__nv_bfloat16>(uint32_t t) {
  const uint32_t x = (t & 0x007F007Fu) | 0x43004300u;
  const uint32_t y = (t & 0x00800080u) | 0x43004300u;
  uint32_t r;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(x), "r"(y));
  return r;
}

// Two int4 values of one output channel: the nibbles of byte B of w (low:
// K row 2j, high: 2j + 1), as a packed pair of T, the low nibble's in the
// low half; w4 is w >> 4, which puts the high nibble at bit 16 of the
// permuted word. Exact: the nibble xor 8 goes into the low mantissa bits of
// 128 (bf16, 7 mantissa bits) or 1024 (f16), and one packed subtraction of
// 136 or 1032 leaves the two's-complement value. Three instructions a pair.
template <typename T, int B>
__device__ __forceinline__ uint32_t wg_nib_pair(uint32_t w, uint32_t w4) {
  constexpr bool F16 = std::is_same<T, __half>::value;
  // 136 (bf16) or 1032 (f16) in both halves
  constexpr uint32_t base = F16 ? 0x64086408u : 0x43084308u;
  const uint32_t u =
      (__byte_perm(w, w4, B | ((B + 4) << 8)) & 0x000F000Fu) ^ base;
  uint32_t r;
  if constexpr (F16)
    asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(r) : "r"(u), "r"(base));
  else
    asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(u), "r"(base));
  return r;
}

// An exact pair of T (a wg_pair or wg_nib_pair) of one output channel
// dequantized as the reference's dequantize does: each value times the
// channel's f32 scale in f32, rounded once to T.
template <typename T>
__device__ __forceinline__ uint32_t wg_scale_pair(uint32_t p, float s);
template <>
__device__ __forceinline__ uint32_t wg_scale_pair<__nv_bfloat16>(uint32_t p,
                                                                 float s) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(
      __uint_as_float(p << 16) * s, __uint_as_float(p & 0xffff0000u) * s);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The magic words of w4_value for the nibble positions 0, 4, 8 and 12:
// the exponent of 2^(23-P) and the xor of the nibble's sign bit. They must
// live in registers: a LOP3 takes one immediate, so with the nibble's mask
// and the magic both immediate the compiler emits two LOP3 a value. `zero`
// is a value that is 0 at run time and unknown to the compiler (it keeps
// the words from folding back into immediates), and w4_value's LOP3 is
// inline PTX, which no pass reassociates.
struct W4Magic {
  uint32_t m[4];
};
__device__ __forceinline__ W4Magic w4_magic(uint32_t zero) {
  W4Magic w;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w.m[i] = (((127u + 23u - 4u * i) << 23) | (8u << (4 * i))) ^ zero;
  return w;
}

// The int4 nibble at bit P (0, 4, 8 or 12) of u as an exact f32 value, in
// two instructions: the nibble xor 8 goes into the mantissa of 2^(23-P),
// whose unit is then one (one LOP3: (u & mask) ^ magic), and subtracting
// 2^(23-P) + 8 leaves the two's-complement value (exact: both terms are
// integers below 2^24).
template <int P>
__device__ __forceinline__ float w4_value(uint32_t u, const W4Magic& w) {
  static_assert(P >= 0 && P <= 12 && P % 4 == 0,
                "the nibble must lie in the mantissa");
  constexpr float bias = static_cast<float>((1u << (23 - P)) + 8u);
  uint32_t v;  // (u & mask) ^ magic: one LOP3 (lut 0x6a)
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;"
      : "=r"(v)
      : "r"(u), "n"(0xFu << P), "r"(w.m[P / 4]));
  return __fadd_rn(__uint_as_float(v), -bias);
}

// The nibbles at bits P and P + 4 of u (K rows 2j and 2j + 1 of one
// channel) dequantized as the reference does, T(f32(q) * s) with one f32
// product and one rounding, as a bf16 pair (bit P's in the low half): two
// LOP3, two FADD, two FMUL and one F2F a pair, against wg_nib_pair +
// wg_scale_pair's PRMT, LOP3, HSUB2, two unpacks, two FMUL and one F2F.
template <int P>
__device__ __forceinline__ uint32_t w4_pair_scaled(uint32_t u, float s,
                                                   const W4Magic& w) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(
      __fmul_rn(w4_value<P>(u, w), s), __fmul_rn(w4_value<P + 4>(u, w), s));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Two int8 values of one output channel (bytes 0 and 2 of t, as wg_pair
// takes them), dequantized (wg_scale_pair), packed with byte 0's in the
// low half.
template <typename T>
__device__ __forceinline__ uint32_t wg_pair_scaled(uint32_t t, float s) {
  return wg_scale_pair<T>(wg_pair<T>(t), s);
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

// Four 8x8 b16 matrices from shared memory, each delivered transposed
// (lanes 8i..8i+7 give matrix i's row addresses; lane (g, t4) receives
// rows 2*t4 and 2*t4 + 1 of column g, the first in the low half).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(lt_smem_u32(p))
      : "memory");
}

// Four 8x8 b16 matrices from shared memory as stored (lanes 8i..8i+7
// give matrix i's row addresses; lane (g, t4) receives elements 2*t4 and
// 2*t4 + 1 of row g, the first in the low half).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(lt_smem_u32(p))
      : "memory");
}

// 16 bytes of the weight, read once: no L1 allocation
__device__ __forceinline__ uint4 ldg_stream(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
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

// d[64 x N] += A[64 x 16] (registers, pairs of T) * B[16 x N], B K-major in
// shared memory (x's rows, 128-byte swizzle) at descriptor db.
template <typename T, int N>
__device__ __forceinline__ void wg_wgmma(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wg_wgmma<__nv_bfloat16, 64>(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : LT_D8(d, 0), LT_D8(d, 8), LT_D8(d, 16), LT_D8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wg_wgmma<__half, 64>(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : LT_D8(d, 0), LT_D8(d, 8), LT_D8(d, 16), LT_D8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wg_wgmma<__nv_bfloat16, 128>(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41,"
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : LT_D8(d, 0), LT_D8(d, 8), LT_D8(d, 16), LT_D8(d, 24),
        LT_D8(d, 32), LT_D8(d, 40), LT_D8(d, 48), LT_D8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wg_wgmma<__half, 128>(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41,"
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : LT_D8(d, 0), LT_D8(d, 8), LT_D8(d, 16), LT_D8(d, 24),
        LT_D8(d, 32), LT_D8(d, 40), LT_D8(d, 48), LT_D8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wg_wgmma<__nv_bfloat16, 192>(float (&d)[96],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41,"
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : LT_D8(d, 0), LT_D8(d, 8), LT_D8(d, 16), LT_D8(d, 24),
        LT_D8(d, 32), LT_D8(d, 40), LT_D8(d, 48), LT_D8(d, 56),
        LT_D8(d, 64), LT_D8(d, 72), LT_D8(d, 80), LT_D8(d, 88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wg_wgmma<__half, 192>(float (&d)[96],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41,"
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : LT_D8(d, 0), LT_D8(d, 8), LT_D8(d, 16), LT_D8(d, 24),
        LT_D8(d, 32), LT_D8(d, 40), LT_D8(d, 48), LT_D8(d, 56),
        LT_D8(d, 64), LT_D8(d, 72), LT_D8(d, 80), LT_D8(d, 88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wg_wgmma<__nv_bfloat16, 256>(float (&d)[128],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41,"
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125,"
      "%126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : LT_D8(d, 0), LT_D8(d, 8), LT_D8(d, 16), LT_D8(d, 24),
        LT_D8(d, 32), LT_D8(d, 40), LT_D8(d, 48), LT_D8(d, 56),
        LT_D8(d, 64), LT_D8(d, 72), LT_D8(d, 80), LT_D8(d, 88),
        LT_D8(d, 96), LT_D8(d, 104), LT_D8(d, 112), LT_D8(d, 120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wg_wgmma<__half, 256>(float (&d)[128],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41,"
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125,"
      "%126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : LT_D8(d, 0), LT_D8(d, 8), LT_D8(d, 16), LT_D8(d, 24),
        LT_D8(d, 32), LT_D8(d, 40), LT_D8(d, 48), LT_D8(d, 56),
        LT_D8(d, 64), LT_D8(d, 72), LT_D8(d, 80), LT_D8(d, 88),
        LT_D8(d, 96), LT_D8(d, 104), LT_D8(d, 112), LT_D8(d, 120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the bits of a 16-bit value
__device__ __forceinline__ uint32_t wg_bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ uint32_t wg_bits(__half v) {
  return __half_as_ushort(v);
}

// Outputs o and o + 1 (columns n, n + 1) from their f32 sums v0, v1.
// EPI_ROUND: out is T, y = T(v), then T(y * T(s[n])), the reference's two
// roundings (the product of two T values is exact in f32). EPI_F32: out is
// f32, v * s[n] (s == nullptr: v). EPI_MOE: out is T, T(v) (the scales
// were applied to the weight).
template <typename T, int EPI>
__device__ __forceinline__ void wg_store(void* out, const float* s,
                                         int64_t o, int n, float v0,
                                         float v1) {
  if constexpr (EPI == EPI_MOE) {
    *reinterpret_cast<uint32_t*>(static_cast<T*>(out) + o) =
        wg_bits(wg_round<T>(v0)) | wg_bits(wg_round<T>(v1)) << 16;
  } else if constexpr (EPI == EPI_F32) {
    const float s0 = s ? s[n] : 1.f, s1 = s ? s[n + 1] : 1.f;
    *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
        make_float2(v0 * s0, v1 * s1);
  } else {
    const float y0 = wg_f(wg_round<T>(v0)), y1 = wg_f(wg_round<T>(v1));
    const float s0 = wg_f(wg_round<T>(s[n])), s1 = wg_f(wg_round<T>(s[n + 1]));
    *reinterpret_cast<uint32_t*>(static_cast<T*>(out) + o) =
        wg_bits(wg_round<T>(y0 * s0)) | wg_bits(wg_round<T>(y1 * s1)) << 16;
  }
}

// The split-K combine inside the launch. The threads of a block of split z
// have written their f32 partials of the block's output tile to the
// workspace; `sync` is a barrier of those threads. Returns true in the last
// of the `splits` blocks of the tile to arrive (counted in *counter, which
// that block sets back to 0 for the next launch); that block then sums the
// splits' partials in split order. The barrier orders the block's writes
// before the leader's release; the leader's acquire orders the other
// splits' writes before the block's reads (the last split reads with
// ld.global.cg, past the L1).
template <typename Sync>
__device__ __forceinline__ bool wg_last_split(int* counter, int splits,
                                              int* flag, bool leader,
                                              Sync sync) {
  sync();
  if (leader) {
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(counter)
                 : "memory");
    const bool last = prev == splits - 1;
    if (last) *counter = 0;
    *flag = last;
  }
  sync();
  return *flag != 0;
}

// ---------------------------------------- large-M route: wgmma fed by TMA

// TMA: the box at coordinates (c0 innermost, c1, c2) of the 3-D tensor map
// at `map` into shared memory at dst, completion reported to `bar`.
__device__ __forceinline__ void wg_tma_load_3d(void* dst, const void* map,
                                               uint64_t* bar, int c0, int c1,
                                               int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(lt_smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(lt_smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// The ring for BM rows of x: stage i holds the x tile [BM][64] (T, 128-byte
// swizzle, BM * 128 bytes), then the weight tile [64][128] of int8 (8 KB;
// int4: [32][128] bytes, 4 KB, 128-byte swizzle), both on 1024-byte
// boundaries as the swizzle wants; the full and empty mbarriers of the
// stages and the split flag follow.
template <int BM>
struct RingA {
  static constexpr int X_BYTES = BM * A_BK * 2;
  static constexpr int Q_BYTES = A_QROWS * A_BN;
  static constexpr int STAGE = X_BYTES + Q_BYTES;
  static constexpr int STAGES =
      A_RING_BYTES / STAGE < 8 ? A_RING_BYTES / STAGE : 8;
  static constexpr size_t SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8 + 16;
};

// out [M, N] = epilogue(x [M, K] @ q [K, N]) for the block's BM rows and
// 128 channels over K tiles [z*kt_per, (z+1)*kt_per) of split z =
// blockIdx.z; with several splits, the f32 sums go to ws [splits][M][N]
// and the tile's last split applies the epilogue. tx: x [M, K] in boxes
// [BM][64]; tq: q [K, N] in boxes [64][128]. Warpgroups 0 and 1 consume
// (channels 64*wg..64*wg+63 of the block), warpgroup 2 produces.
// EPI_MOE: blockIdx.z is the expert e (no split, kt_per unused); tx maps x
// as [M, xe, K] (xe 1: one x for every expert; E: expert e's rows) in
// boxes [BM][1][64], tq the stack q [E, K, N] in boxes [1][64][128]; the
// weight converts with expert e's scales s [E, N] and out is [M, E, N].
template <typename T, int BM, int EPI>
__global__ void __launch_bounds__(A_THREADS, 1)
    weight_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                             const __grid_constant__ CUtensorMap tq,
                             const float* __restrict__ s,
                             void* __restrict__ out, float* __restrict__ ws,
                             int* __restrict__ counters, int M, int N, int K,
                             int kt_per, int xe) {
  constexpr bool MOE = EPI == EPI_MOE;
  using R = RingA<BM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (lt_smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  int* flag = reinterpret_cast<int*>(empty + R::STAGES);

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * A_BN;
  const int nk = (K + A_BK - 1) / A_BK;
  const int e = MOE ? blockIdx.z : 0;
  const int kt0 = MOE ? 0 : blockIdx.z * kt_per;
  const int ntile = MOE ? nk : min(nk, kt0 + kt_per) - kt0;
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) {
    for (int i = 0; i < R::STAGES; ++i) {
      lt_mbar_init(&full[i], 1);
      lt_mbar_init(&empty[i], 8);  // one arrival a consumer warp
    }
    lt_mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full; the warpgroup gives its
    // registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      for (int t = 0; t < ntile; ++t) {
        const int st = t % R::STAGES;
        lt_mbar_wait(&empty[st], ((t / R::STAGES) & 1) ^ 1);
        uint8_t* stage = smem + st * R::STAGE;
        const int k0 = (kt0 + t) * A_BK, kq = (kt0 + t) * A_QROWS;
        lt_mbar_expect_tx(&full[st], R::STAGE);
        if constexpr (MOE) {
          wg_tma_load_3d(stage, &tx, &full[st], k0, xe > 1 ? e : 0, m0);
          wg_tma_load_3d(stage + R::X_BYTES, &tq, &full[st], n0, kq, e);
        } else {
          lt_tma_load_2d(stage, &tx, &full[st], k0, m0);
          lt_tma_load_2d(stage + R::X_BYTES, &tq, &full[st], n0, kq);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int g = lane >> 2, t4 = lane & 3;
    // The warp's 16 channels are the 16-byte chunk c of an int8 row; A rows
    // g and g + 8 of the warp are its channels 2g and 2g + 1.
    const int c = 4 * wg + warp;
    // this thread's channels cb, cb + 1 (A rows g, g + 8) and, for the
    // expert GEMM, their scales
    const int cb = n0 + 16 * c + 2 * g;
    float sc0 = 0.f, sc1 = 0.f;
    if constexpr (MOE) {
      if (cb < N) {
        sc0 = s[static_cast<int64_t>(e) * N + cb];
        sc1 = s[static_cast<int64_t>(e) * N + cb + 1];
      }
    }
    float acc[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
    uint32_t fa[4][4], fb[4][4];  // A fragments of two tiles, [k16][reg]

    // The A fragments of the int8 tile at qt. ldmatrix.trans of 8 K rows of
    // the chunk gives lane (g, t4) one register: channels 2g, 2g + 1 of K
    // rows 2t4 (low half) and 2t4 + 1, bytes (k, c0), (k, c1), (k+1, c0),
    // (k+1, c1). Bytes 0 and 2 are the fragment register of row g (channel
    // c0), bytes 1 and 3 the one of row g + 8. Lane l gives the address of
    // row l of each 32.
    // int4: the tile's 32 packed rows are four 8x8 b16 matrices, one a K
    // step of 16; matrix row r is packed row (r >> 1) + 4 (r & 1) of its
    // step, so that ldmatrix.trans gives lane (g, t4) packed rows t4 (K
    // rows 2t4, 2t4 + 1) and t4 + 4 (K rows 2t4 + 8, + 9) of channels 2g,
    // 2g + 1: bytes 0..3 are the step's four fragment registers.
    auto convert4 = [&](const uint8_t* qt, uint32_t (&f)[4][4]) {
      const int r = lane & 7;
      const int p = 8 * (lane >> 3) + (r >> 1) + 4 * (r & 1);
      uint32_t v[4];
      ldsm_x4_t(v, qt + p * A_BN + ((c ^ (p & 7)) << 4));
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint32_t v4 = v[m] >> 4;
        f[m][0] = wg_nib_pair<T, 0>(v[m], v4);
        f[m][1] = wg_nib_pair<T, 1>(v[m], v4);
        f[m][2] = wg_nib_pair<T, 2>(v[m], v4);
        f[m][3] = wg_nib_pair<T, 3>(v[m], v4);
        if constexpr (MOE) {
          f[m][0] = wg_scale_pair<T>(f[m][0], sc0);
          f[m][1] = wg_scale_pair<T>(f[m][1], sc1);
          f[m][2] = wg_scale_pair<T>(f[m][2], sc0);
          f[m][3] = wg_scale_pair<T>(f[m][3], sc1);
        }
      }
    };
    auto convert = [&](const uint8_t* qt, uint32_t (&f)[4][4]) {
      if constexpr (kW4) {
        convert4(qt, f);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 32 * h + lane;
          uint32_t r[4];
          ldsm_x4_t(r, qt + k * A_BN + ((c ^ (k & 7)) << 4));
#pragma unroll
          for (int m = 0; m < 4; ++m) {  // K rows 8m..8m+7 of the 32
            if constexpr (MOE) {
              f[2 * h + (m >> 1)][2 * (m & 1)] = wg_pair_scaled<T>(r[m], sc0);
              f[2 * h + (m >> 1)][2 * (m & 1) + 1] =
                  wg_pair_scaled<T>(r[m] >> 8, sc1);
            } else {
              f[2 * h + (m >> 1)][2 * (m & 1)] = wg_pair<T>(r[m]);
              f[2 * h + (m >> 1)][2 * (m & 1) + 1] = wg_pair<T>(r[m] >> 8);
            }
          }
        }
      }
    };
    // tile t: wait for its stage, convert, start its wgmmas; then wait for
    // tile t - 1's and hand its stage back to the producer
    auto step = [&](int t, uint32_t (&f)[4][4]) {
      const int st = t % R::STAGES;
      lt_mbar_wait(&full[st], (t / R::STAGES) & 1);
      const uint8_t* stage = smem + st * R::STAGE;
      convert(stage + R::X_BYTES, f);
      lt_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg_wgmma<T, BM>(acc, f[kk], lt_smem_desc(stage + kk * 32, 16, 1024));
      lt_wgmma_commit();
      lt_wgmma_wait<1>();
      if (t > 0 && lane == 0) lt_mbar_arrive(&empty[(t - 1) % R::STAGES]);
    };
    int t = 0;
    for (; t + 1 < ntile; t += 2) {
      step(t, fa);
      step(t + 1, fb);
    }
    if (t < ntile) step(t, fa);
    lt_wgmma_wait<0>();
    lt_fence_regs(acc);

    // acc[4j + i] is channel cb, row m0 + 8j + 2t4 + i; acc[4j + 2 + i]
    // channel cb + 1 of the same row (the expert GEMM's output row r is
    // row r * E + e of out [M * E, N])
    const int64_t mn = static_cast<int64_t>(M) * N;
    auto each = [&](auto&& fn) {
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = m0 + 8 * j + 2 * t4 + i;
          const int64_t ro =
              MOE ? static_cast<int64_t>(r) * gridDim.z + e : r;
          if (r < M && cb < N)
            fn(ro * N + cb, acc[4 * j + i], acc[4 * j + 2 + i]);
        }
    };
    if (MOE || gridDim.z == 1) {
      each([&](int64_t o, float v0, float v1) {
        wg_store<T, EPI>(out, s, o, cb, v0, v1);
      });
    } else {
      float* wz = ws + blockIdx.z * mn;
      each([&](int64_t o, float v0, float v1) {
        *reinterpret_cast<float2*>(wz + o) = make_float2(v0, v1);
      });
      if (wg_last_split(counters + blockIdx.x + gridDim.x * blockIdx.y,
                        gridDim.z, flag, tid == 0, [] {
                          asm volatile("bar.sync 1, 256;\n" ::: "memory");
                        })) {
        // the tile's last split: acc becomes the sum of the splits'
        // partials in split order, 8 rows' loads in flight at a time
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
        for (int z = 0; z < static_cast<int>(gridDim.z); ++z) {
          const float* wsz = ws + z * mn;
#pragma unroll
          for (int j0 = 0; j0 < BM / 8; j0 += 4) {
            float2 p[4][2];
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const int r = m0 + 8 * (j0 + j) + 2 * t4 + u;
                p[j][u] = r < M && cb < N
                              ? __ldcg(reinterpret_cast<const float2*>(
                                    wsz + static_cast<int64_t>(r) * N + cb))
                              : make_float2(0.f, 0.f);
              }
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                acc[4 * (j0 + j) + u] += p[j][u].x;
                acc[4 * (j0 + j) + 2 + u] += p[j][u].y;
              }
          }
        }
        each([&](int64_t o, float v0, float v1) {
          wg_store<T, EPI>(out, s, o, cb, v0, v1);
        });
      }
    }
  }
}

// ------------------------------- bf16 head at large M: three bf16 terms

// x32 = hi + mid + lo, each a bf16 (split_terms_kernel): the top 8
// significant bits of x, of the rest, and of what is left. Each cut is a
// truncation of the f32 bits and each rest an exact f32 difference, so the
// three hold x exactly wherever its bits lie at or above 2^-133 (bf16's
// least subnormal: every |x| >= 2^-110, every normal value a row of the
// model holds); bits below that, which no bf16 holds, are dropped. A
// non-finite x: hi = x (NaN as 0x7fc0), mid = lo = 0.
__device__ __forceinline__ void hs_split(float x, uint32_t& h, uint32_t& m,
                                         uint32_t& l) {
  const uint32_t b = __float_as_uint(x);
  if ((b & 0x7f800000u) == 0x7f800000u) {
    h = (b & 0x007fffffu) ? 0x7fc0u : b >> 16;
    m = l = 0;
    return;
  }
  const float r1 = __fsub_rn(x, __uint_as_float(b & 0xffff0000u));
  const uint32_t b1 = __float_as_uint(r1);
  const float r2 = __fsub_rn(r1, __uint_as_float(b1 & 0xffff0000u));
  h = b >> 16;
  m = b1 >> 16;
  l = __float_as_uint(r2) >> 16;
}

// x32 [n4 * 4] f32 -> xs [3][n4 * 4] bf16 (hi, mid, lo), four values a
// thread and step; bound by its bytes (4 read, 6 written a value).
__global__ void split_terms_kernel(const float4* __restrict__ x,
                                   uint2* __restrict__ xs, int64_t n4) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n4; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float4 v = x[i];
    uint32_t h[4], m[4], l[4];
    hs_split(v.x, h[0], m[0], l[0]);
    hs_split(v.y, h[1], m[1], l[1]);
    hs_split(v.z, h[2], m[2], l[2]);
    hs_split(v.w, h[3], m[3], l[3]);
    xs[i] = make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
    xs[n4 + i] = make_uint2(m[0] | m[1] << 16, m[2] | m[3] << 16);
    xs[2 * n4 + i] = make_uint2(l[0] | l[1] << 16, l[2] | l[3] << 16);
  }
}

// The head's ring for BN rows of x: stage i holds the three term tiles
// [BN][64] (bf16, 128-byte swizzle) of x's rows, then the head tile of 128
// vocabulary columns x 64 K rows (16 KB: two boxes [64 K][64 V] of a
// row-major [K, V] head, or one box [128 V][64 K] of a tied [V, K]), each
// on a 1024-byte boundary; the mbarriers and the split flag follow.
template <int BN>
struct RingH {
  static constexpr int X_BYTES = BN * A_BK * 2;
  static constexpr int W_BYTES = H_BV * A_BK * 2;
  static constexpr int STAGE = 3 * X_BYTES + W_BYTES;
  static constexpr int STAGES =
      H_RING_BYTES / STAGE < 8 ? H_RING_BYTES / STAGE : 8;
  static constexpr size_t SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8 + 16;
};

// out [M, V] f32 = x32 @ w for a bf16 head w, on the tensor cores: x32 =
// hi + mid + lo (split_terms_kernel, xs [3, M, K]), and each K step of 16
// multiplies one A fragment of the head with the three term tiles, into
// one f32 accumulator a K stage of 64, added to the running sums in f32.
// The bf16 x bf16 products are exact, so the sum holds the reference's
// products (the head's value times x's) in another order. The head is
// wgmma's A operand, lifted from its tile by ldmatrix (.trans for a
// row-major [K, V] head: a tile row is one K row of 64 columns; as stored
// for a tied [V, K], NK): warp w of consumer warpgroup
// c owns vocabulary columns n0 + 64c + 16w + (0..15), A row r its column
// r. The term tiles are B operands from shared memory. Block order: bands
// of H_GROUP row tiles, the column tile varying fastest in a band; split z
// = blockIdx.y sums K tiles [z*kt_per, (z+1)*kt_per) of 64 (the tile's
// last split combines, as weight_gemm_wgmma_kernel's). tx: xs as [3, M,
// K] in boxes [1][BN][64]; tw: the head (weight_gemm_head_tmap).
template <int BN, bool NK>
__global__ void __launch_bounds__(A_THREADS, 1)
    head_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tw,
                           float* __restrict__ out, float* __restrict__ ws,
                           int* __restrict__ counters, int M, int V, int K,
                           int kt_per) {
  using R = RingH<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (lt_smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  int* flag = reinterpret_cast<int*>(empty + R::STAGES);

  const int nm = (M + BN - 1) / BN, nv = (V + H_BV - 1) / H_BV;
  const int band = H_GROUP * nv, b = blockIdx.x;
  const int first = b / band * H_GROUP, gm = min(nm - first, H_GROUP);
  const int mt = first + b % band % gm, vt = b % band / gm;
  const int m0 = mt * BN, n0 = vt * H_BV;
  const int nk = (K + A_BK - 1) / A_BK;
  const int kt0 = blockIdx.y * kt_per;
  const int ntile = min(nk, kt0 + kt_per) - kt0;
  const int tid = threadIdx.x, wg = tid >> 7;
  // a row-major head's second box lies past V on a ragged last tile
  const bool box2 = NK || n0 + 64 < V;

  if (tid == 0) {
    for (int i = 0; i < R::STAGES; ++i) {
      lt_mbar_init(&full[i], 1);
      lt_mbar_init(&empty[i], 8);  // one arrival a consumer warp
    }
    lt_mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      for (int t = 0; t < ntile; ++t) {
        const int st = t % R::STAGES;
        lt_mbar_wait(&empty[st], ((t / R::STAGES) & 1) ^ 1);
        uint8_t* stage = smem + st * R::STAGE;
        uint8_t* wt = stage + 3 * R::X_BYTES;
        const int k0 = (kt0 + t) * A_BK;
        lt_mbar_expect_tx(&full[st], box2 ? R::STAGE
                                          : R::STAGE - R::W_BYTES / 2);
#pragma unroll
        for (int term = 0; term < 3; ++term)
          wg_tma_load_3d(stage + term * R::X_BYTES, &tx, &full[st], k0, m0,
                         term);
        if constexpr (NK) {
          lt_tma_load_2d(wt, &tw, &full[st], k0, n0);
        } else {
          lt_tma_load_2d(wt, &tw, &full[st], n0, k0);
          if (box2)
            lt_tma_load_2d(wt + R::W_BYTES / 2, &tw, &full[st], n0 + 64, k0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int g = lane >> 2, t4 = lane & 3;
    // acc: the sums so far; part: one stage's, added to acc in f32 (RN)
    // once its wgmmas are done. The tensor cores' f32 accumulation rounds
    // otherwise than RN, and over the 3 x K / 16 wgmmas of a whole K its
    // bias reached 1.05e-4 on logits of ~4; a stage's 12 stay far below.
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    uint32_t f[4][4];  // the stage's A fragments, [k16][reg]

    // The A fragments of the head tile at wt for the four K steps. Matrix
    // i of an x4 (lanes 8i..8i+7 give its rows) is fragment register i:
    // A rows 8 (i & 1) + (0..7), K columns 8 (i >> 1) + (0..7) of the step.
    // A tile row is 128 bytes, its 16-byte chunk c stored at c ^ (row & 7).
    auto frags = [&](const uint8_t* wt) {
      const int i = lane >> 3, r = lane & 7;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (NK) {
          // row: vocabulary column 64 wg + 16 warp + 8 (i & 1) + r; chunk:
          // K columns 16 kk + 8 (i >> 1)
          const int row = 64 * wg + 16 * warp + 8 * (i & 1) + r;
          ldsm_x4(f[kk], wt + row * 128 + (((2 * kk + (i >> 1)) ^ r) << 4));
        } else {
          // row: K row 16 kk + 8 (i >> 1) + r of warpgroup wg's box;
          // chunk: its columns 16 warp + 8 (i & 1)
          const int k = 16 * kk + 8 * (i >> 1) + r;
          ldsm_x4_t(f[kk], wt + wg * (R::W_BYTES / 2) + k * 128 +
                               (((2 * warp + (i & 1)) ^ r) << 4));
        }
      }
    };
    // stage t: its fragments, its 12 wgmmas (the small terms first) into
    // part, then the stage back to the producer and part into acc; the
    // other consumer warpgroup's wgmmas keep the tensor cores busy
    // meanwhile
    for (int t = 0; t < ntile; ++t) {
      const int st = t % R::STAGES;
      lt_mbar_wait(&full[st], (t / R::STAGES) & 1);
      const uint8_t* stage = smem + st * R::STAGE;
      frags(stage + 3 * R::X_BYTES);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) part[i] = 0.f;
      lt_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int term = 2; term >= 0; --term)
          wg_wgmma<__nv_bfloat16, BN>(
              part, f[kk],
              lt_smem_desc(stage + term * R::X_BYTES + kk * 32, 16, 1024));
      lt_wgmma_commit();
      lt_wgmma_wait<0>();
      lt_fence_regs(part);
      if (lane == 0) lt_mbar_arrive(&empty[st]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    }

    // acc[4j + i]: vocabulary column cv + 8 (i >> 1), row m0 + 8j + 2t4 +
    // (i & 1)
    const int cv = n0 + 64 * wg + 16 * warp + g;
    const int64_t mv = static_cast<int64_t>(M) * V;
    auto each = [&](auto&& fn) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = m0 + 8 * j + 2 * t4 + (i & 1);
          const int v = cv + 8 * (i >> 1);
          if (r < M && v < V)
            fn(static_cast<int64_t>(r) * V + v, acc[4 * j + i]);
        }
    };
    if (gridDim.y == 1) {
      each([&](int64_t o, float& a) { out[o] = a; });
    } else {
      float* wz = ws + blockIdx.y * mv;
      each([&](int64_t o, float& a) { wz[o] = a; });
      if (wg_last_split(counters + mt + nm * vt, gridDim.y, flag, tid == 0,
                        [] {
                          asm volatile("bar.sync 1, 256;\n" ::: "memory");
                        })) {
        // the tile's last split: the splits' partials summed in order
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        for (int z = 0; z < static_cast<int>(gridDim.y); ++z) {
          const float* wsz = ws + z * mv;
          each([&](int64_t o, float& a) { a += __ldcg(wsz + o); });
        }
        each([&](int64_t o, float& a) { out[o] = a; });
      }
    }
  }
}

// ------------------------------------------------ decode route: mma.sync

// word i of a 16-byte chunk
__device__ __forceinline__ uint32_t wg_word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// out [M, N] = epilogue(x [M, K] @ q [K, N]) for M <= 8 * NT8 and the
// block's 128 channels over K tiles [z*kt_per, (z+1)*kt_per) of split z =
// blockIdx.y; warp w takes tiles w, w + 4, ... of them. The products are
// m16n8k16 with A = 16 channels of the weight and B = x^T, 8 tokens a
// column tile. Lane (g, t4) reads channels 16g..16g+15 of the block at K
// rows 4t4..4t4+3 of each 16, and fragment k slot 2t4 + {0, 1, 8, 9} is
// K row 4t4 + {0, 1, 2, 3}: x's B fragment is then 8 contiguous bytes of
// a row, and the A fragment of m16 tile i (rows g, g + 8 = channels 16g +
// 2i, + 1) comes from byte 2i, 2i + 1 of the four rows' chunks. The loads
// run a tile ahead: once a 16-row step is multiplied, its registers take
// the same step of the warp's next tile. The warps' sums are added in
// warp order through shared memory.
// EPI_MOE (the int8 build): blockIdx.z is the expert e (no split:
// gridDim.y == 1); x is [M, xe, K] (xe 1: one x for every expert; E:
// expert e's rows), q the stack [E, K, N], each weight pair converted
// with its channel's scale in s [E, N], and out [M, E, N].
// int4 (kW4): K tiles of 128, eight K steps of 16; lane (g, t4) reads
// packed rows 2t4 and 2t4 + 1 of a step (K rows 4t4..4t4+3, the same
// fragment slots), and byte b of a chunk word gives one fragment register
// (wg_nib_pair). The int4 build's projection and head launch as a
// programmatic dependent launch (launch_gemv4): the first tile's weight
// loads are issued before griddepcontrol.wait, x's loads and every store
// after it, so no kernel just before one may write its weight q.
template <typename T, int NT8, int EPI>
__global__ void __launch_bounds__(B_WARPS * 32)
    weight_gemm_gemv_kernel(const T* __restrict__ x,
                            const uint8_t* __restrict__ q,
                            const float* __restrict__ s,
                            void* __restrict__ out, float* __restrict__ ws,
                            int* __restrict__ counters, int M, int N, int K,
                            int kt_per, int xe) {
  constexpr bool MOE = EPI == EPI_MOE;
  static_assert(!(kW4 && MOE), "the int4 expert stacks at decode run "
                               "moe_w4_stream_kernel");
  constexpr int ROWS = 8 * NT8, LD = B_BN + 4;
  // K steps of 16 a tile; 16-byte weight rows a thread reads a step
  constexpr int KS = B_BK / 16, WR = kW4 ? 2 : 4;
  __shared__ __align__(16) float red[B_WARPS][ROWS][LD];
  __shared__ int flag;
  const int n0 = blockIdx.x * B_BN;
  const int nk = (K + B_BK - 1) / B_BK;
  const int kt0 = blockIdx.y * kt_per, kt1 = min(nk, kt0 + kt_per);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int cb = n0 + 16 * g;
  const bool cok = cb < N;
  // the expert GEMM: expert e's weight, x rows and the scales of this
  // thread's 16 channels
  const int e = MOE ? blockIdx.z : 0;
  const int64_t xrow = MOE ? static_cast<int64_t>(xe) * K : K;
  if constexpr (MOE) {
    x += xe > 1 ? static_cast<int64_t>(e) * K : 0;
    q += static_cast<int64_t>(e) * (kW4 ? K / 2 : K) * N;
  }
  float sc[MOE ? 16 : 1];
#pragma unroll
  for (int j = 0; j < (MOE ? 16 : 1); ++j)
    sc[j] = MOE && cok ? s[static_cast<int64_t>(e) * N + cb + j] : 0.f;

  float acc[8][NT8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][nt][j] = 0.f;

  // [k16 step][K row 4t4 + j, int4: packed row 2t4 + j]: 16 channels
  uint4 w[KS][WR];
  uint2 xv[KS][NT8];  // [k16 step][token tile]: K rows 4t4..4t4+3
  // step kk of tile t into w[kk] (the weight) and xv[kk] (x)
  auto load_w = [&](int kk, int t) {
    const int k16 = t * B_BK + 16 * kk, kr = k16 + 4 * t4;
    const bool kok = k16 < K;  // K % 16 == 0
#pragma unroll
    for (int j = 0; j < WR; ++j)
      w[kk][j] = cok && kok ? ldg_stream(q + static_cast<int64_t>(
                                                 (kW4 ? kr / 2 : kr) + j) *
                                                 N +
                                             cb)
                            : make_uint4(0u, 0u, 0u, 0u);
  };
  auto load_x = [&](int kk, int t) {
    const int k16 = t * B_BK + 16 * kk, kr = k16 + 4 * t4;
    const bool kok = k16 < K;
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      const int r = 8 * nt + g;
      xv[kk][nt] = kok && r < M ? *reinterpret_cast<const uint2*>(
                                      x + r * xrow + kr)
                                : make_uint2(0u, 0u);
    }
  };
  auto load = [&](int kk, int t) {
    load_w(kk, t);
    load_x(kk, t);
  };
  auto mul4 = [&](int kk) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // word i / 2 of both rows; channel 16g + 2i is byte 2 (i & 1), the
      // next channel the byte after it
      const uint32_t u0 = wg_word(w[kk][0], i >> 1);
      const uint32_t u1 = wg_word(w[kk][WR - 1], i >> 1);
      const uint32_t v0 = u0 >> 4, v1 = u1 >> 4;
      uint32_t a[4];
      if (i & 1) {
        a[0] = wg_nib_pair<T, 2>(u0, v0);
        a[1] = wg_nib_pair<T, 3>(u0, v0);
        a[2] = wg_nib_pair<T, 2>(u1, v1);
        a[3] = wg_nib_pair<T, 3>(u1, v1);
      } else {
        a[0] = wg_nib_pair<T, 0>(u0, v0);
        a[1] = wg_nib_pair<T, 1>(u0, v0);
        a[2] = wg_nib_pair<T, 0>(u1, v1);
        a[3] = wg_nib_pair<T, 1>(u1, v1);
      }
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
        wg_mma<T>(acc[i][nt], a, xv[kk][nt].x, xv[kk][nt].y);
    }
  };
  auto mul = [&](int kk) {
    if constexpr (kW4) {
      mul4(kk);
    } else {
      // byte b of word i/2 (channel 16g + 2i) in bytes 0 and 2, of rows
      // (0, 1) and (2, 3); byte b + 1 (channel 16g + 2i + 1) likewise
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int wi = i >> 1;
        const uint32_t lo = (i & 1) ? 0x6622 : 0x4400;
        const uint32_t hi = (i & 1) ? 0x7733 : 0x5511;
        const uint32_t w0 = wg_word(w[kk][0], wi), w1 = wg_word(w[kk][1], wi);
        const uint32_t w2 = wg_word(w[kk][WR - 2], wi);
        const uint32_t w3 = wg_word(w[kk][WR - 1], wi);
        uint32_t a[4];
        if constexpr (MOE) {  // rows g, g + 8: channels 16g + 2i, + 1
          a[0] = wg_pair_scaled<T>(__byte_perm(w0, w1, lo), sc[2 * i]);
          a[1] = wg_pair_scaled<T>(__byte_perm(w0, w1, hi), sc[2 * i + 1]);
          a[2] = wg_pair_scaled<T>(__byte_perm(w2, w3, lo), sc[2 * i]);
          a[3] = wg_pair_scaled<T>(__byte_perm(w2, w3, hi), sc[2 * i + 1]);
        } else {
          a[0] = wg_pair<T>(__byte_perm(w0, w1, lo));
          a[1] = wg_pair<T>(__byte_perm(w0, w1, hi));
          a[2] = wg_pair<T>(__byte_perm(w2, w3, lo));
          a[3] = wg_pair<T>(__byte_perm(w2, w3, hi));
        }
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt)
          wg_mma<T>(acc[i][nt], a, xv[kk][nt].x, xv[kk][nt].y);
      }
    }
  };
  const int ntl = kt1 - kt0 > warp ? (kt1 - kt0 - warp + B_WARPS - 1) / B_WARPS
                                   : 0;  // this warp's tiles
  if constexpr (kW4) {
    // a programmatic dependent launch: the next kernel may launch now; the
    // first tile's weight (which no kernel just before it may write)
    // streams in before the wait for the previous grid, x (its output,
    // maybe) and every store after it
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    if (ntl > 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) load_w(kk, kt0 + warp);
    }
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    if (ntl > 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) load_x(kk, kt0 + warp);
    }
  } else if (ntl > 0) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) load(kk, kt0 + warp);
  }
  for (int i = 0; i < ntl; ++i) {
    const int nxt = kt0 + warp + B_WARPS * (i + 1);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      mul(kk);
      if (i + 1 < ntl) load(kk, nxt);
    }
  }

  // acc[i][nt][u]: channel 16g + 2i, token 8nt + 2t4 + u; [2 + u]: the
  // next channel
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        *reinterpret_cast<float2*>(
            &red[warp][8 * nt + 2 * t4 + u][16 * g + 2 * i]) =
            make_float2(acc[i][nt][u], acc[i][nt][2 + u]);
  __syncthreads();
  // this thread's outputs: channels n, n + 1 of rows r0, r0 + 2, ...
  const int n = n0 + 2 * (tid & 63), r0 = tid >> 6;
  const int64_t mn = static_cast<int64_t>(M) * N;
  const bool split = gridDim.y > 1;
  for (int r = r0; r < M; r += 2) {
    float2 v = make_float2(0.f, 0.f);
#pragma unroll
    for (int w8 = 0; w8 < B_WARPS; ++w8) {
      const float2 u = *reinterpret_cast<const float2*>(&red[w8][r][n - n0]);
      v.x += u.x;
      v.y += u.y;
    }
    if (n >= N) continue;
    const int64_t o =
        (MOE ? static_cast<int64_t>(r) * gridDim.z + e : r) * N + n;
    if (split)
      *reinterpret_cast<float2*>(ws + blockIdx.y * mn + o) = v;
    else
      wg_store<T, EPI>(out, s, o, n, v.x, v.y);
  }
  if (!split || !wg_last_split(counters + blockIdx.x, gridDim.y, &flag,
                               tid == 0, [] { __syncthreads(); }))
    return;
  // the tile's last split: sum the splits' partials in split order, the
  // loads of ZG splits in flight at a time
  constexpr int RT = ROWS / 2;  // rows a thread at most
  constexpr int ZG = 8 / NT8;
  const int splits = gridDim.y;
  float2 v[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) v[i] = make_float2(0.f, 0.f);
  for (int z0 = 0; z0 < splits; z0 += ZG) {
    float2 p[ZG][RT];
#pragma unroll
    for (int zz = 0; zz < ZG; ++zz)
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = r0 + 2 * i;
        p[zz][i] = z0 + zz < splits && r < M && n < N
                       ? __ldcg(reinterpret_cast<const float2*>(
                             ws + (z0 + zz) * mn +
                             static_cast<int64_t>(r) * N + n))
                       : make_float2(0.f, 0.f);
      }
#pragma unroll
    for (int zz = 0; zz < ZG; ++zz)
#pragma unroll
      for (int i = 0; i < RT; ++i)
        if (z0 + zz < splits) {
          v[i].x += p[zz][i].x;
          v[i].y += p[zz][i].y;
        }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = r0 + 2 * i;
    if (r < M && n < N)
      wg_store<T, EPI>(out, s, static_cast<int64_t>(r) * N + n, n, v[i].x,
                       v[i].y);
  }
}

// ------------------------------------- int4 expert GEMM at decode: stream

// moe_w4_matmul at M <= 8 * NT8 (the int4 build): out [M, E, N] =
// x @ T(f32(q[e]) * s[e]) over the units (expert e, column tile of 128,
// K tile of MS_BK rows), ordered by tile (e-major) then K. Block b of the
// G blocks takes units [b*U/G, (b+1)*U/G): every block the same bytes,
// whatever E x (column tiles) is against the card's SMs. Its warps
// take every 4th unit of each tile it touches and sum through shared
// memory as weight_gemm_gemv_kernel does, with the same fragments and
// x^T as B; each warp's loads run one unit ahead, across tile edges too.
// A tile whole in the block is stored at once. A tile cut by a block edge
// is a part of each block that touches it: each writes its f32 sums to
// ws [G][2][M][128] (slot 0 for its first tile, 1 for its last), and the
// last to arrive (counters[tile], back to 0 after) sums the parts in
// block order and stores: no float atomics, the same bits every call.
// Conversion: w4_pair_scaled, the reference's rounding in 8 instructions
// a pair with the mma (wg_nib_pair + wg_scale_pair on the decode route
// took 11; cuobjdump -sass).
template <int NT8>
__global__ void __launch_bounds__(B_WARPS * 32,
                                  (MS_KS <= 4 ? 4 : 3) - (NT8 - 1))
    moe_w4_stream_kernel(const __nv_bfloat16* __restrict__ x,
                         const uint8_t* __restrict__ q,
                         const float* __restrict__ s,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ ws, int* __restrict__ counters,
                         int M, int N, int K, int E, int xe) {
  using T = __nv_bfloat16;
  constexpr int ROWS = 8 * NT8, LD = B_BN + 4;
  __shared__ __align__(16) float red[B_WARPS][ROWS][LD];
  __shared__ int flag;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int NT = (N + B_BN - 1) / B_BN, KT = (K + MS_BK - 1) / MS_BK;
  const int64_t U = static_cast<int64_t>(E) * NT * KT;
  const int64_t G = gridDim.x, b = blockIdx.x;
  const int64_t u0 = b * U / G, u1 = (b + 1) * U / G;
  const int tf = static_cast<int>(u0 / KT);
  const int tl = static_cast<int>((u1 - 1) / KT);
  const int64_t qstride = static_cast<int64_t>(K / 2) * N;  // an expert
  const int64_t xrow = static_cast<int64_t>(xe) * K;

  // the warp's first unit in tile t, t + 1, ... tl of the block's range
  auto next_from = [&](int t) -> int64_t {
    for (; t <= tl; ++t) {
      const int64_t lo = static_cast<int64_t>(t) * KT, hi = lo + KT;
      const int64_t a = (u0 > lo ? u0 : lo) + warp;
      if (a < (u1 < hi ? u1 : hi)) return a;
    }
    return -1;
  };
  // where unit u's loads read: its weight rows and x rows for this lane
  struct Src {
    const uint8_t* q;
    const T* x;
    int k0;
    bool cok;
  };
  auto src_of = [&](int64_t u) {
    const int t = static_cast<int>(u / KT);
    const int kt = static_cast<int>(u - static_cast<int64_t>(t) * KT);
    const int e = t / NT, cb = (t - e * NT) * B_BN + 16 * g;
    const int k0 = kt * MS_BK;
    return Src{
        q + e * qstride + static_cast<int64_t>(k0 / 2 + 2 * t4) * N + cb,
        x + (xe > 1 ? static_cast<int64_t>(e) * K : 0) + k0 + 4 * t4, k0,
        cb < N};
  };
  uint4 w[MS_KS][2];    // [k16 step][packed row 2t4 + j]: 16 channels
  uint2 xv[MS_KS][NT8]; // [k16 step][token tile]: K rows 4t4..4t4+3
  auto load = [&](int kk, const Src& p) {
    const bool kok = p.k0 + 16 * kk < K;  // K % 16 == 0
#pragma unroll
    for (int j = 0; j < 2; ++j)
      w[kk][j] = p.cok && kok
                     ? ldg_stream(p.q + static_cast<int64_t>(8 * kk + j) * N)
                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      const int r = 8 * nt + g;
      xv[kk][nt] = kok && r < M ? *reinterpret_cast<const uint2*>(
                                      p.x + r * xrow + 16 * kk)
                                : make_uint2(0u, 0u);
    }
  };
  float sc[16];  // the scales of this lane's 16 channels of the tile
  auto scales = [&](int t) {
    const int e = t / NT, cb = (t - e * NT) * B_BN + 16 * g;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      sc[j] = cb < N ? s[static_cast<int64_t>(e) * N + cb + j] : 0.f;
  };
  float acc[8][NT8][4];
  // M >= 1: its sign bit is the run-time zero of w4_magic
  const W4Magic mg = w4_magic(static_cast<uint32_t>(M) >> 31);
  auto mul = [&](int kk) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // word i / 2 of both rows: channels 16g + 2i and + 1 are its bytes
      // 2 (i & 1) and 2 (i & 1) + 1
      uint32_t u0w = wg_word(w[kk][0], i >> 1);
      uint32_t u1w = wg_word(w[kk][1], i >> 1);
      if (i & 1) {  // bytes 2 and 3: their nibbles to bits 0..15
        u0w >>= 16;
        u1w >>= 16;
      }
      uint32_t a[4];
      a[0] = w4_pair_scaled<0>(u0w, sc[2 * i], mg);
      a[1] = w4_pair_scaled<8>(u0w, sc[2 * i + 1], mg);
      a[2] = w4_pair_scaled<0>(u1w, sc[2 * i], mg);
      a[3] = w4_pair_scaled<8>(u1w, sc[2 * i + 1], mg);
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
        wg_mma<T>(acc[i][nt], a, xv[kk][nt].x, xv[kk][nt].y);
    }
  };
  // the block whose range holds unit u
  auto block_of = [&](int64_t u) { return ((u + 1) * G - 1) / U; };

  int64_t u = next_from(tf);
  if (u >= 0) {
    const Src p = src_of(u);
#pragma unroll
    for (int kk = 0; kk < MS_KS; ++kk) load(kk, p);
  }
  scales(tf);
  for (int t = tf; t <= tl; ++t) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][nt][j] = 0.f;
    const int64_t tend = static_cast<int64_t>(t + 1) * KT;
    const int64_t end = u1 < tend ? u1 : tend;
    while (u >= 0 && u < end) {
      const int64_t nx = u + B_WARPS < end ? u + B_WARPS : next_from(t + 1);
      Src p;
      if (nx >= 0) p = src_of(nx);
#pragma unroll
      for (int kk = 0; kk < MS_KS; ++kk) {
        mul(kk);
        if (nx >= 0) load(kk, p);
      }
      u = nx;
    }
    if (t < tl) scales(t + 1);  // read while the tile's sums combine

    // acc[i][nt][c]: channel 16g + 2i (+1 for c >= 2), token 8nt + 2t4 +
    // (c & 1); the warps' sums added in warp order
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          *reinterpret_cast<float2*>(
              &red[warp][8 * nt + 2 * t4 + c][16 * g + 2 * i]) =
              make_float2(acc[i][nt][c], acc[i][nt][2 + c]);
    __syncthreads();
    const int e = t / NT, n0 = (t - e * NT) * B_BN;
    const int nl = 2 * (tid & 63), n = n0 + nl, r0 = tid >> 6;
    const bool whole = u0 <= static_cast<int64_t>(t) * KT &&
                       u1 >= static_cast<int64_t>(t + 1) * KT;
    constexpr int RT = ROWS / 2;  // rows a thread at most
    float2 v[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      v[i] = make_float2(0.f, 0.f);
      const int r = r0 + 2 * i;
      if (r < M) {
#pragma unroll
        for (int w8 = 0; w8 < B_WARPS; ++w8) {
          const float2 p = *reinterpret_cast<const float2*>(&red[w8][r][nl]);
          v[i].x += p.x;
          v[i].y += p.y;
        }
      }
    }
    bool store = whole;
    if (!whole) {
      // this block's part: slot 0 of its first tile, 1 of its last
      auto part = [&](int64_t bb, int tt) {
        const int64_t f0 = bb * U / G / KT;
        return ws + ((bb * 2 + (tt == f0 ? 0 : 1)) * M) * B_BN;
      };
      float* mine = part(b, t);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = r0 + 2 * i;
        if (r < M) *reinterpret_cast<float2*>(mine + r * B_BN + nl) = v[i];
      }
      const int64_t bf = block_of(static_cast<int64_t>(t) * KT);
      const int64_t bl = block_of(static_cast<int64_t>(t + 1) * KT - 1);
      store = wg_last_split(counters + t, static_cast<int>(bl - bf + 1),
                            &flag, tid == 0, [] { __syncthreads(); });
      if (store) {
        // the tile's last part to arrive: every part, in block order
#pragma unroll
        for (int i = 0; i < RT; ++i) v[i] = make_float2(0.f, 0.f);
        for (int64_t bb = bf; bb <= bl; ++bb) {
          const float* pp = part(bb, t);
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const int r = r0 + 2 * i;
            if (r < M) {
              const float2 p =
                  __ldcg(reinterpret_cast<const float2*>(pp + r * B_BN + nl));
              v[i].x += p.x;
              v[i].y += p.y;
            }
          }
        }
      }
    }
    if (store && n < N) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = r0 + 2 * i;
        if (r < M)
          wg_store<T, EPI_MOE>(
              out, nullptr, (static_cast<int64_t>(r) * E + e) * N + n, n,
              v[i].x, v[i].y);
      }
    }
    __syncthreads();  // red is written again for the next tile
  }
}

// ------------------------------------------- SIMT route (f32 activations)

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
// several splits the sums go to ws [splits][M][N] and the tile's last
// split sums them (wg_last_split).
template <typename WT, bool NK>
__global__ void __launch_bounds__(SG_THREADS)
    weight_gemm_simt_kernel(const float* __restrict__ x,
                            const WT* __restrict__ w,
                            const float* __restrict__ s,
                            float* __restrict__ out, float* __restrict__ ws,
                            int* __restrict__ counters, int M, int N, int K,
                            int kt_per) {
  using L = SgTile<WT, NK>;
  __shared__ int flag;
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
  const int64_t mn = static_cast<int64_t>(M) * N;
  // fn(o, n, m, c) for each output o (column n) of the thread's acc[m][c]
  auto each = [&](auto&& fn) {
#pragma unroll
    for (int m = 0; m < SG_BM; ++m) {
      const int r = m0 + m;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = NK ? n0 + tid + c * SG_THREADS : n0 + tid * 4 + c;
        if (r < M && n < N) fn(static_cast<int64_t>(r) * N + n, n, m, c);
      }
    }
  };
  if (split) {
    each([&](int64_t o, int, int m, int c) {
      ws[blockIdx.z * mn + o] = acc[m][c];
    });
    if (!wg_last_split(counters + blockIdx.x + gridDim.x * blockIdx.y,
                       gridDim.z, &flag, tid == 0, [] { __syncthreads(); }))
      return;
    // the tile's last split: acc becomes the sum of the splits' partials
    // in split order, two splits' loads in flight at once
#pragma unroll
    for (int m = 0; m < SG_BM; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
    const int splits = gridDim.z;
    for (int z = 0; z < splits; z += 2) {
      float p[2][SG_BM][4];
#pragma unroll
      for (int zz = 0; zz < 2; ++zz)
#pragma unroll
        for (int m = 0; m < SG_BM; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c) p[zz][m][c] = 0.f;
      each([&](int64_t o, int, int m, int c) {
        p[0][m][c] = __ldcg(ws + z * mn + o);
        if (z + 1 < splits) p[1][m][c] = __ldcg(ws + (z + 1) * mn + o);
      });
#pragma unroll
      for (int zz = 0; zz < 2; ++zz)
#pragma unroll
        for (int m = 0; m < SG_BM; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (z + zz < splits) acc[m][c] += p[zz][m][c];
    }
  }
  each([&](int64_t o, int n, int m, int c) {
    out[o] = s ? acc[m][c] * s[n] : acc[m][c];
  });
}

// ------------------------------------------------------------ launchers

// (splits, kt_per) must cover the nk tiles of K with no empty split
bool bad_split(int K, int bk, int splits, int kt_per, const void* ws,
               const void* counters) {
  const int nk = (K + bk - 1) / bk;
  return splits < 1 || kt_per < 1 || (splits - 1) * kt_per >= nk ||
         splits * kt_per < nk ||
         (splits > 1 && (ws == nullptr || counters == nullptr));
}

bool bad_shape(int M, int N, int K) {
  return M <= 0 || N <= 0 || K <= 0 || N % 16 != 0 || K % 16 != 0;
}

// cuTensorMapEncodeTiled, looked up at run time (cudaGetDriverEntryPoint),
// so the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major [outer, mid, cols] tensor of `dtype`
// (bf16, f16 or int8) at ptr (rank 2 when mid == 0: [outer, cols]), read
// in boxes of box_outer x box_mid rows of 128 bytes, 128-byte swizzle;
// out-of-bounds elements load as zeros.
int encode_map(CUtensorMap* map, int dtype, const void* ptr, int outer,
               int mid, int cols, int box_outer, int box_mid) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int es = dtype == WG_I8 ? 1 : 2;
  const CUtensorMapDataType t =
      dtype == WG_BF16   ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
      : dtype == WG_F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t row = static_cast<cuuint64_t>(cols) * es;
  const cuuint32_t rank = mid > 0 ? 3 : 2;
  const cuuint64_t dims3[3] = {static_cast<cuuint64_t>(cols),
                               static_cast<cuuint64_t>(mid),
                               static_cast<cuuint64_t>(outer)};
  const cuuint64_t dims2[2] = {static_cast<cuuint64_t>(cols),
                               static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {row, row * static_cast<cuuint64_t>(mid)};
  const cuuint32_t box3[3] = {static_cast<cuuint32_t>(128 / es),
                              static_cast<cuuint32_t>(box_mid),
                              static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t box2[2] = {static_cast<cuuint32_t>(128 / es),
                              static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r =
      fn(map, t, rank, const_cast<void*>(ptr), mid > 0 ? dims3 : dims2,
         strides, mid > 0 ? box3 : box2, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int encode_2d(CUtensorMap* map, int dtype, const void* ptr, int rows,
              int cols, int box_rows) {
  return encode_map(map, dtype, ptr, rows, 0, cols, box_rows, 1);
}

template <typename T, int BM, int EPI>
int launch_wgmma(const CUtensorMap& tx, const CUtensorMap& tq,
                 const float* s, void* out, float* ws, int* counters, int M,
                 int N, int K, int splits, int kt_per, cudaStream_t st) {
  using R = RingA<BM>;
  auto kernel = weight_gemm_wgmma_kernel<T, BM, EPI>;
  static size_t done[LT_MAX_DEVICES];
  cudaError_t e = lt_set_max_smem(kernel, R::SMEM, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + BM - 1) / BM, (N + A_BN - 1) / A_BN, splits);
  kernel<<<grid, A_THREADS, R::SMEM, st>>>(tx, tq, s, out, ws, counters, M,
                                            N, K, kt_per, 1);
  return static_cast<int>(cudaGetLastError());
}

// the expert GEMM on the large-M route: one block a (row tile, column
// tile, expert)
template <typename T, int BM>
int launch_wgmma_moe(const CUtensorMap& tx, const CUtensorMap& tq,
                     const float* s, void* out, int M, int N, int K, int E,
                     int xe, cudaStream_t st) {
  using R = RingA<BM>;
  auto kernel = weight_gemm_wgmma_kernel<T, BM, EPI_MOE>;
  static size_t done[LT_MAX_DEVICES];
  cudaError_t e = lt_set_max_smem(kernel, R::SMEM, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + BM - 1) / BM, (N + A_BN - 1) / A_BN, E);
  kernel<<<grid, A_THREADS, R::SMEM, st>>>(tx, tq, s, out, nullptr, nullptr,
                                            M, N, K, 0, xe);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int EPI>
int launch_wgmma_rows(int bm, const CUtensorMap& tx, const CUtensorMap& tq,
                      const float* s, void* out, float* ws, int* counters,
                      int M, int N, int K, int splits, int kt_per,
                      cudaStream_t st) {
  switch (bm) {
#define WG_CASE(b)                                                           \
  case b:                                                                    \
    return launch_wgmma<T, b, EPI>(tx, tq, s, out, ws, counters, M, N, K,    \
                                   splits, kt_per, st);
    WG_CASE(64) WG_CASE(128) WG_CASE(192) WG_CASE(256)
#undef WG_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int EPI>
int launch_gemv(const void* x, const void* q, const float* s, void* out,
                float* ws, int* counters, int M, int N, int K, int splits,
                int kt_per, cudaStream_t st) {
  const dim3 grid((N + B_BN - 1) / B_BN, splits);
  if (M <= 8)
    weight_gemm_gemv_kernel<T, 1, EPI><<<grid, B_WARPS * 32, 0, st>>>(
        static_cast<const T*>(x), static_cast<const uint8_t*>(q), s, out, ws,
        counters, M, N, K, kt_per, 1);
  else
    weight_gemm_gemv_kernel<T, 2, EPI><<<grid, B_WARPS * 32, 0, st>>>(
        static_cast<const T*>(x), static_cast<const uint8_t*>(q), s, out, ws,
        counters, M, N, K, kt_per, 1);
  return static_cast<int>(cudaGetLastError());
}

#if !WG_INT4
// the expert GEMM on the decode route: one block a (column tile, expert)
template <typename T>
int launch_gemv_moe(const void* x, const void* q, const float* s, void* out,
                    int M, int N, int K, int E, int xe, cudaStream_t st) {
  const int nk = (K + B_BK - 1) / B_BK;
  const dim3 grid((N + B_BN - 1) / B_BN, 1, E);
  if (M <= 8)
    weight_gemm_gemv_kernel<T, 1, EPI_MOE><<<grid, B_WARPS * 32, 0, st>>>(
        static_cast<const T*>(x), static_cast<const uint8_t*>(q), s, out,
        nullptr, nullptr, M, N, K, nk, xe);
  else
    weight_gemm_gemv_kernel<T, 2, EPI_MOE><<<grid, B_WARPS * 32, 0, st>>>(
        static_cast<const T*>(x), static_cast<const uint8_t*>(q), s, out,
        nullptr, nullptr, M, N, K, nk, xe);
  return static_cast<int>(cudaGetLastError());
}
#endif

#if WG_INT4
// the int4 projection at decode: the decode route's grid of (column tile,
// split) blocks, as a programmatic dependent launch
template <typename T, int EPI>
int launch_gemv4(const void* x, const void* q, const float* s, void* out,
                 float* ws, int* counters, int M, int N, int K, int splits,
                 int kt_per, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + B_BN - 1) / B_BN, splits);
  cfg.blockDim = dim3(B_WARPS * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const T* xp = static_cast<const T*>(x);
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  const cudaError_t e =
      M <= 8 ? cudaLaunchKernelEx(&cfg, weight_gemm_gemv_kernel<T, 1, EPI>,
                                  xp, qp, s, out, ws, counters, M, N, K,
                                  kt_per, 1)
             : cudaLaunchKernelEx(&cfg, weight_gemm_gemv_kernel<T, 2, EPI>,
                                  xp, qp, s, out, ws, counters, M, N, K,
                                  kt_per, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the int4 expert GEMM at decode: `blocks` blocks of equal unit ranges
int launch_moe_stream(const void* x, const void* q, const float* s,
                      void* out, float* ws, int* counters, int M, int N,
                      int K, int E, int xe, int blocks, cudaStream_t st) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const uint8_t*>(q);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (M <= 8)
    moe_w4_stream_kernel<1><<<blocks, B_WARPS * 32, 0, st>>>(
        xp, qp, s, op, ws, counters, M, N, K, E, xe);
  else
    moe_w4_stream_kernel<2><<<blocks, B_WARPS * 32, 0, st>>>(
        xp, qp, s, op, ws, counters, M, N, K, E, xe);
  return static_cast<int>(cudaGetLastError());
}
#else
// the bf16 head at large M: one block a (row tile, column tile, split)
template <int BN, bool NK>
int launch_head(const CUtensorMap& tx, const CUtensorMap& tw, float* out,
                float* ws, int* counters, int M, int V, int K, int splits,
                int kt_per, cudaStream_t st) {
  using R = RingH<BN>;
  auto kernel = head_gemm_wgmma_kernel<BN, NK>;
  static size_t done[LT_MAX_DEVICES];
  cudaError_t e = lt_set_max_smem(kernel, R::SMEM, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(((M + BN - 1) / BN) * ((V + H_BV - 1) / H_BV), splits);
  kernel<<<grid, A_THREADS, R::SMEM, st>>>(tx, tw, out, ws, counters, M, V,
                                            K, kt_per);
  return static_cast<int>(cudaGetLastError());
}
#endif

template <typename WT, bool NK>
int launch_simt(const void* x, const void* w, const float* s, void* out,
                float* ws, int* counters, int M, int N, int K, int splits,
                int kt_per, cudaStream_t st) {
  using L = SgTile<WT, NK>;
  static size_t done[LT_MAX_DEVICES];
  cudaError_t e =
      lt_set_max_smem(weight_gemm_simt_kernel<WT, NK>, L::SMEM, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + SG_BM - 1) / SG_BM, (N + SG_BN - 1) / SG_BN, splits);
  weight_gemm_simt_kernel<WT, NK><<<grid, SG_THREADS, L::SMEM, st>>>(
      static_cast<const float*>(x), static_cast<const WT*>(w), s,
      static_cast<float*>(out), ws, counters, M, N, K, kt_per);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tensor map of a weight for the large-M route: q [K, N] int8 at ptr,
// boxes of 64 K rows and 128 columns (the int4 build: q [K/2, N] packed,
// boxes of 32 rows of 128 bytes), written to `map` (128 bytes, host
// memory). K is the weight's depth in elements. The wrapper keeps one a
// weight.
extern "C" int weight_gemm_tmap(const void* ptr, int K, int N, void* map) {
  if (K <= 0 || N <= 0 || N % 16 != 0 || (kW4 && K % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m;
  const int e = encode_2d(&m, WG_I8, ptr, kW4 ? K / 2 : K, N, A_QROWS);
  if (e == 0) memcpy(map, &m, sizeof m);
  return e;
}

// Each entry point below takes K in elements; its weight is int8, or
// packed int4 in the build with WG_INT4 (module comment).
//
// Large-M route (wgmma). x [M, K] in `dtype` (bf16 or f16), its tensor map
// encoded here for boxes of bm (64, 128, 192 or 256) rows; qmap: the
// weight's map from weight_gemm_tmap; s [N] f32; epi 0 (EPI_ROUND): out
// [M, N] in dtype, the reference's qmatmul; epi 1 (EPI_F32, bf16 only):
// out [M, N] f32 = sums * s, the int8 head. ws: f32 [splits * M * N] and
// counters: int32, zero, one a (row tile, column tile) block, when splits
// > 1; split z sums K tiles [z*kt_per, (z+1)*kt_per) of 64.
extern "C" int weight_gemm_wgmma_launch(int dtype, int epi, int bm,
                                        const void* x, const void* qmap,
                                        const void* s, void* out, void* ws,
                                        void* counters, int M, int N, int K,
                                        int splits, int kt_per,
                                        void* stream) {
  if (bad_shape(M, N, K) || bad_split(K, A_BK, splits, kt_per, ws, counters))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tq;
  memcpy(&tq, qmap, sizeof tq);
  const int e = encode_2d(&tx, dtype, x, M, K, bm);
  if (e != 0) return e;
  const float* sc = static_cast<const float*>(s);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == WG_BF16 && epi == EPI_ROUND)
    return launch_wgmma_rows<__nv_bfloat16, EPI_ROUND>(
        bm, tx, tq, sc, out, w, cnt, M, N, K, splits, kt_per, st);
  if (dtype == WG_BF16 && epi == EPI_F32)
    return launch_wgmma_rows<__nv_bfloat16, EPI_F32>(
        bm, tx, tq, sc, out, w, cnt, M, N, K, splits, kt_per, st);
  if (dtype == WG_F16 && epi == EPI_ROUND)
    return launch_wgmma_rows<__half, EPI_ROUND>(bm, tx, tq, sc, out, w, cnt,
                                                M, N, K, splits, kt_per, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Decode route (M <= 16, mma.sync; the int8 build). x [M, K] in `dtype`
// (bf16 or f16), q [K, N] int8, s [N] f32; epi, ws, counters and (splits,
// kt_per) as above, one counter a column tile of 128.
extern "C" int weight_gemm_gemv_launch(int dtype, int epi, const void* x,
                                       const void* q, const void* s,
                                       void* out, void* ws, void* counters,
                                       int M, int N, int K, int splits,
                                       int kt_per, void* stream) {
#if WG_INT4
  // the int4 build's decode route launches through weight_gemm_w4_launch
  return static_cast<int>(cudaErrorNotSupported);
#else
  if (bad_shape(M, N, K) || M > 16 ||
      bad_split(K, B_BK, splits, kt_per, ws, counters))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(s);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == WG_BF16 && epi == EPI_ROUND)
    return launch_gemv<__nv_bfloat16, EPI_ROUND>(x, q, sc, out, w, cnt, M, N,
                                                 K, splits, kt_per, st);
  if (dtype == WG_BF16 && epi == EPI_F32)
    return launch_gemv<__nv_bfloat16, EPI_F32>(x, q, sc, out, w, cnt, M, N,
                                               K, splits, kt_per, st);
  if (dtype == WG_F16 && epi == EPI_ROUND)
    return launch_gemv<__half, EPI_ROUND>(x, q, sc, out, w, cnt, M, N, K,
                                          splits, kt_per, st);
  return static_cast<int>(cudaErrorInvalidValue);
#endif
}

// SIMT route (f32 activations). x [M, K] f32; w in `wdtype` (int8, bf16 or
// f16): [K, N] row-major (nk = 0) or the transpose of a row-major [N, K]
// (nk = 1, bf16/f16 only); s [N] f32 or null; out [M, N] f32 = (x @ w) * s.
// ws, counters and (splits, kt_per) as above, over K tiles of 16.
// The int4 build has no SIMT route: no int4 recipe runs f32 activations.
extern "C" int weight_gemm_simt_launch(int wdtype, int nk, const void* x,
                                       const void* w, const void* s,
                                       void* out, void* ws, void* counters,
                                       int M, int N, int K, int splits,
                                       int kt_per, void* stream) {
#if WG_INT4
  return static_cast<int>(cudaErrorNotSupported);
#else
  if (bad_shape(M, N, K) || bad_split(K, SG_BK, splits, kt_per, ws, counters))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(s);
  float* wsp = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wdtype == WG_I8 && !nk)
    return launch_simt<int8_t, false>(x, w, sc, out, wsp, cnt, M, N, K,
                                      splits, kt_per, st);
  if (wdtype == WG_BF16)
    return nk ? launch_simt<__nv_bfloat16, true>(x, w, sc, out, wsp, cnt, M,
                                                 N, K, splits, kt_per, st)
              : launch_simt<__nv_bfloat16, false>(x, w, sc, out, wsp, cnt, M,
                                                  N, K, splits, kt_per, st);
  if (wdtype == WG_F16)
    return nk ? launch_simt<__half, true>(x, w, sc, out, wsp, cnt, M, N, K,
                                          splits, kt_per, st)
              : launch_simt<__half, false>(x, w, sc, out, wsp, cnt, M, N, K,
                                           splits, kt_per, st);
  return static_cast<int>(cudaErrorInvalidValue);
#endif
}

// The tensor map of an int8 expert stack for the expert GEMM's large-M
// route: q [E, K, N] at ptr, boxes of one expert's 64 K rows and 128
// columns (int4: [E, K/2, N] packed, boxes of 32 rows), written to `map`
// (128 bytes, host memory). The wrapper keeps one a stack.
extern "C" int weight_gemm_moe_tmap(const void* ptr, int E, int K, int N,
                                    void* map) {
  if (E <= 0 || K <= 0 || N <= 0 || N % 16 != 0 || (kW4 && K % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m;
  const int e =
      encode_map(&m, WG_I8, ptr, E, kW4 ? K / 2 : K, N, 1, A_QROWS);
  if (e == 0) memcpy(map, &m, sizeof m);
  return e;
}

// The expert GEMM (Mixtral's int8 experts): out [M, E, N] bf16 = x @
// bf16(f32(q[e]) * s[e]) for each expert e, the f32 sums rounded once. x
// [M, xe, K] bf16, xe 1 (one x for every expert) or E (expert e's rows);
// q [E, K, N] int8 (qmap: its map from weight_gemm_moe_tmap, for bm > 0);
// s [E, N] f32. bm 0: the decode route (M <= 16, mma.sync; the int8 build:
// the int4 build's stacks at decode take weight_gemm_moe4_launch); 64,
// 128, 192 or 256: the large-M route's row tile. One launch, every expert; no
// split-K. bf16 alone (the int8 recipe's activations): the kernels are
// templates of T, but each instantiation lengthens the build.
extern "C" int weight_gemm_moe_launch(int dtype, int bm, const void* x,
                                      int xe, const void* q,
                                      const void* qmap, const void* s,
                                      void* out, int M, int N, int K, int E,
                                      void* stream) {
  if (bad_shape(M, N, K) || E <= 0 || (xe != 1 && xe != E) ||
      (bm == 0 && M > 16) || dtype != WG_BF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#if WG_INT4
  if (bm == 0) return static_cast<int>(cudaErrorInvalidValue);
#else
  if (bm == 0)
    return launch_gemv_moe<__nv_bfloat16>(x, q, sc, out, M, N, K, E, xe, st);
#endif
  CUtensorMap tx, tq;
  memcpy(&tq, qmap, sizeof tq);
  const int e = encode_map(&tx, dtype, x, M, xe, K, bm, 1);
  if (e != 0) return e;
  switch (bm) {
#define MOE_CASE(b)                                                     \
  case b:                                                               \
    return launch_wgmma_moe<__nv_bfloat16, b>(tx, tq, sc, out, M, N, K, E, \
                                              xe, st);
    MOE_CASE(64) MOE_CASE(128) MOE_CASE(192) MOE_CASE(256)
#undef MOE_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 head's tensor map for its large-M route: a row-major [K, V]
// head (nk 0) in boxes of 64 K rows x 64 columns, or the transpose of a
// row-major [V, K] tied embedding (nk 1, ptr: the embedding) in boxes of
// 128 vocabulary rows x 64 K columns; written to `map` (128 bytes, host
// memory). The wrapper keeps one a head. The int4 build has no bf16 head.
extern "C" int weight_gemm_head_tmap(const void* ptr, int nk, int K, int V,
                                     void* map) {
#if WG_INT4
  return static_cast<int>(cudaErrorNotSupported);
#else
  if (K <= 0 || V <= 0 || K % 16 != 0 || V % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m;
  const int e = nk ? encode_2d(&m, WG_BF16, ptr, V, K, H_BV)
                   : encode_2d(&m, WG_BF16, ptr, K, V, A_BK);
  if (e == 0) memcpy(map, &m, sizeof m);
  return e;
#endif
}

// x32 [M, K] f32 -> xs [3, M, K] bf16, the terms hi, mid and lo of each
// value (hs_split), for the bf16 head's large-M route. K % 4 == 0, x32
// 16-byte aligned, xs 8-byte aligned.
extern "C" int weight_gemm_split_launch(const void* x, void* xs, int M,
                                        int K, void* stream) {
#if WG_INT4
  return static_cast<int>(cudaErrorNotSupported);
#else
  if (M <= 0 || K <= 0 || K % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n4 = static_cast<int64_t>(M) * K / 4;
  const int blocks = static_cast<int>(n4 / 256 + 1 < 4096 ? n4 / 256 + 1
                                                          : 4096);
  split_terms_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<uint2*>(xs), n4);
  return static_cast<int>(cudaGetLastError());
#endif
}

// The bf16 head at large M (tensor cores): out [M, V] f32 = (hi + mid +
// lo) @ w, xs [3, M, K] bf16 from weight_gemm_split_launch, wmap the
// head's map from weight_gemm_head_tmap (nk as there); bn (64 or 128) rows
// of x a block. ws: f32 [splits * M * V] and counters: int32, zero,
// one a (row tile, column tile) block, when splits > 1; split z sums K
// tiles [z*kt_per, (z+1)*kt_per) of 64.
extern "C" int weight_gemm_head_launch(int nk, int bn, const void* xs,
                                       const void* wmap, void* out,
                                       void* ws, void* counters, int M,
                                       int V, int K, int splits, int kt_per,
                                       void* stream) {
#if WG_INT4
  return static_cast<int>(cudaErrorNotSupported);
#else
  if (bad_shape(M, V, K) || bad_split(K, A_BK, splits, kt_per, ws, counters))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tw;
  memcpy(&tw, wmap, sizeof tw);
  const int e = encode_map(&tx, WG_BF16, xs, 3, M, K, 1, bn);
  if (e != 0) return e;
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn * 2 + (nk ? 1 : 0)) {
#define HEAD_CASE(b)                                                       \
  case 2 * b:                                                              \
    return launch_head<b, false>(tx, tw, o, w, cnt, M, V, K, splits,       \
                                 kt_per, st);                              \
  case 2 * b + 1:                                                          \
    return launch_head<b, true>(tx, tw, o, w, cnt, M, V, K, splits, kt_per, \
                                st);
    HEAD_CASE(64) HEAD_CASE(128)
#undef HEAD_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
#endif
}

// The int4 projection at decode (the int4 build; M <= 16): the decode
// route of weight_gemm_gemv_launch (x, q packed, s, epi, ws, counters and
// (splits, kt_per) as there, K tiles of 128), launched as a programmatic
// dependent launch: its first weight tile is read before the previous
// kernel in the stream has finished, so that kernel must not write q.
extern "C" int weight_gemm_w4_launch(int dtype, int epi, const void* x,
                                     const void* q, const void* s, void* out,
                                     void* ws, void* counters, int M, int N,
                                     int K, int splits, int kt_per,
                                     void* stream) {
#if WG_INT4
  if (bad_shape(M, N, K) || M > 16 ||
      bad_split(K, B_BK, splits, kt_per, ws, counters))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(s);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == WG_BF16 && epi == EPI_ROUND)
    return launch_gemv4<__nv_bfloat16, EPI_ROUND>(x, q, sc, out, w, cnt, M, N,
                                                  K, splits, kt_per, st);
  if (dtype == WG_BF16 && epi == EPI_F32)
    return launch_gemv4<__nv_bfloat16, EPI_F32>(x, q, sc, out, w, cnt, M, N,
                                                K, splits, kt_per, st);
  if (dtype == WG_F16 && epi == EPI_ROUND)
    return launch_gemv4<__half, EPI_ROUND>(x, q, sc, out, w, cnt, M, N, K,
                                           splits, kt_per, st);
  return static_cast<int>(cudaErrorInvalidValue);
#else
  return static_cast<int>(cudaErrorNotSupported);
#endif
}

// The int4 expert GEMM at decode (the int4 build; M <= 16): out [M, E, N]
// bf16 = x @ bf16(f32(q[e]) * s[e]) for each expert, one launch of
// `blocks` (at most the E x ceil(N/128) x ceil(K/MS_BK) units: no empty
// block). x [M, xe, K] bf16 (xe 1 or E), q [E, K/2, N] packed,
// s [E, N] f32; ws f32 [blocks * 2 * M * 128], counters int32, zero, one
// an (expert, column tile).
extern "C" int weight_gemm_moe4_launch(const void* x, int xe, const void* q,
                                       const void* s, void* out, void* ws,
                                       void* counters, int M, int N, int K,
                                       int E, int blocks, void* stream) {
#if WG_INT4
  const int64_t units = static_cast<int64_t>(E) * ((N + B_BN - 1) / B_BN) *
                        ((K + MS_BK - 1) / MS_BK);
  if (bad_shape(M, N, K) || M > 16 || E <= 0 || (xe != 1 && xe != E) ||
      blocks < 1 || blocks > units || ws == nullptr || counters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_moe_stream(x, q, static_cast<const float*>(s), out,
                           static_cast<float*>(ws),
                           static_cast<int*>(counters), M, N, K, E, xe,
                           blocks, static_cast<cudaStream_t>(stream));
#else
  return static_cast<int>(cudaErrorNotSupported);
#endif
}
