// Paged-KV decode write: each slot's new K/V row into the block pool, in
// place.
//
// Replaces: localai_tpu/ops/pallas/paged_scatter.py
//   - paged_scatter_append (_append_kernel): bf16/f32 pools [NB,KVH,BS,D];
//   - paged_scatter_append_q8 (_append_q8_kernel): int8 pools plus per-token
//     f32 scales [NB,KVH,1,BS] (ops/kvcache layout with BS == 128), with the
//     per-token quantization that the reference's wrapper runs before it.
// Same function: slot b's row k_new[b] ([KVH, D]) goes to physical block
// pb[b], in-block row off[b] of every KV head (the targets the wrapper
// computes once per decode step, as the reference's _targets does at trace
// time); the int8 variant quantizes each (slot, head) row and also writes
// its scale element. The pools are updated in place — the counterpart of
// the Pallas input_output_aliases — and nothing else in them is touched.
//
// What bounds it on the H100: pure data movement, B*KVH*D elements read and
// written per pool (a few KB per step at 8B geometry), so the bound is
// those bytes over 3.35 TB/s — far below one launch's overhead. Design:
//   - bf16/f32 (scatter_rows): one block per slot; its threads copy the
//     slot's KVH rows of D elements with the widest vector access the row
//     size allows (16 bytes at D=128 in bf16).
//   - int8 (scatter_q8_rows): one warp per (slot, KV head) reads the bf16
//     or f32 row itself, takes amax |x| by a warp max, and writes the int8
//     row and its scale, so the quantization runs inside the one launch.
//     It computes what ops/kvcache.quantize_tokens computes, bit for bit:
//     scale = max(amax, 1e-8) / 127 and q = round-half-even(x / scale)
//     clamped to +-127, both divisions IEEE round-to-nearest (__fdiv_rn,
//     whatever the compiler flags), never a product with the inverse.
// A target outside the pool (pb >= NB) is skipped, never written: the
// engine's table holds only block ids it allocated. The KV tier's demotion
// (ops/kernels/paged_scatter.paged_demote_q8; the reference's engine
// _demote is XLA) runs scatter_q8_rows too: a layer's hot block [KVH, 128,
// D] as KVH*128 rows of one head into the cold pool viewed [NBc*KVH, 1,
// 128, D].
#include "common.cuh"

namespace {

constexpr int BS = 128;   // tokens per block == the int8 scale tile
constexpr int NT = 128;

// Copy KVH rows of `row_units` U-sized units from src [B, KVH, row] to the
// pool row (pb, h, off) of [NB, KVH, BS, row].
template <typename U>
__global__ void __launch_bounds__(NT)
    scatter_rows(const U* __restrict__ k_new, const U* __restrict__ v_new,
                 U* __restrict__ k_pool, U* __restrict__ v_pool,
                 const int* __restrict__ pb, const int* __restrict__ off,
                 int KVH, int row_units, int NB) {
  const int b = blockIdx.x;
  const int blk = pb[b], row = off[b];
  if (blk < 0 || blk >= NB || row < 0 || row >= BS) return;
  const int n = KVH * row_units;
  for (int i = threadIdx.x; i < n; i += NT) {
    const int h = i / row_units, c = i - h * row_units;
    const int64_t src = (static_cast<int64_t>(b) * KVH + h) * row_units + c;
    const int64_t dst =
        ((static_cast<int64_t>(blk) * KVH + h) * BS + row) * row_units + c;
    k_pool[dst] = k_new[src];
    v_pool[dst] = v_new[src];
  }
}

int launch_rows(const void* k_new, const void* v_new, void* k_pool,
                void* v_pool, const int* pb, const int* off, int B, int KVH,
                int row_bytes, int NB, cudaStream_t st) {
  if (B <= 0) return 0;
  if (row_bytes % 16 == 0) {
    scatter_rows<uint4><<<B, NT, 0, st>>>(
        static_cast<const uint4*>(k_new), static_cast<const uint4*>(v_new),
        static_cast<uint4*>(k_pool), static_cast<uint4*>(v_pool), pb, off,
        KVH, row_bytes / 16, NB);
  } else if (row_bytes % 4 == 0) {
    scatter_rows<uint32_t><<<B, NT, 0, st>>>(
        static_cast<const uint32_t*>(k_new),
        static_cast<const uint32_t*>(v_new), static_cast<uint32_t*>(k_pool),
        static_cast<uint32_t*>(v_pool), pb, off, KVH, row_bytes / 4, NB);
  } else {
    scatter_rows<uint8_t><<<B, NT, 0, st>>>(
        static_cast<const uint8_t*>(k_new),
        static_cast<const uint8_t*>(v_new), static_cast<uint8_t*>(k_pool),
        static_cast<uint8_t*>(v_pool), pb, off, KVH, row_bytes, NB);
  }
  return static_cast<int>(cudaGetLastError());
}

// Quantize one row of D elements (the calling warp's lanes together) into
// q and its scale into *s, as quantize_tokens does.
template <typename T>
__device__ __forceinline__ void quant_row(const T* __restrict__ x,
                                          int8_t* __restrict__ q, float* s,
                                          int D, int lane) {
  float amax = 0.f;
  for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(lt_to_f(x[d])));
  amax = lt_warp_max(amax);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  for (int d = lane; d < D; d += 32) {
    const float r = rintf(__fdiv_rn(lt_to_f(x[d]), scale));
    q[d] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
  }
  if (lane == 0) *s = scale;
}

// Warp w of the grid takes (slot b, head h) = (w / KVH, w % KVH): the K and
// the V row of k_new/v_new [B, KVH, D] into pool row (pb[b], h, off[b]) of
// [NB, KVH, BS, D] int8 and scale element (pb[b], h, 0, off[b]) of [NB,
// KVH, 1, BS] f32.
template <typename T>
__global__ void __launch_bounds__(NT)
    scatter_q8_rows(const T* __restrict__ k_new, const T* __restrict__ v_new,
                    int8_t* __restrict__ kq, int8_t* __restrict__ vq,
                    float* __restrict__ ks, float* __restrict__ vs,
                    const int* __restrict__ pb, const int* __restrict__ off,
                    int B, int KVH, int D, int NB) {
  const int w = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= B * KVH) return;  // the whole warp
  const int b = w / KVH, h = w - b * KVH;
  const int blk = pb[b], row = off[b];
  if (blk < 0 || blk >= NB || row < 0 || row >= BS) return;
  const int64_t src = static_cast<int64_t>(w) * D;
  const int64_t dst = (static_cast<int64_t>(blk) * KVH + h) * BS + row;
  quant_row(k_new + src, kq + dst * D, ks + dst, D, lane);
  quant_row(v_new + src, vq + dst * D, vs + dst, D, lane);
}

template <typename T>
int launch_q8(const void* k_new, const void* v_new, void* kq, void* ks,
              void* vq, void* vs, const int* pb, const int* off, int B,
              int KVH, int D, int NB, cudaStream_t st) {
  constexpr int WARPS = NT / 32;
  scatter_q8_rows<T><<<(B * KVH + WARPS - 1) / WARPS, NT, 0, st>>>(
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<int8_t*>(kq), static_cast<int8_t*>(vq),
      static_cast<float*>(ks), static_cast<float*>(vs), pb, off, B, KVH, D,
      NB);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16/f32 (any element size): k_new/v_new [B, KVH, D], pools [NB, KVH,
// 128, D] of `elem_bytes`-sized elements; pb/off [B] int32.
extern "C" int paged_scatter_launch(int elem_bytes, const void* k_new,
                                    const void* v_new, void* k_pool,
                                    void* v_pool, const void* pb,
                                    const void* off, int B, int KVH, int D,
                                    int NB, void* stream) {
  if (elem_bytes <= 0 || KVH <= 0 || D <= 0 || NB <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_rows(k_new, v_new, k_pool, v_pool,
                     static_cast<const int*>(pb),
                     static_cast<const int*>(off), B, KVH, elem_bytes * D, NB,
                     static_cast<cudaStream_t>(stream));
}

// int8: k_new/v_new [B, KVH, D] in `dtype` (bf16 or f32), quantized here;
// pools kq/vq [NB, KVH, 128, D] int8, scales ks/vs [NB, KVH, 1, 128] f32;
// pb/off [B] int32. One launch quantizes and writes rows and scales.
extern "C" int paged_scatter_q8_launch(int dtype, const void* k_new,
                                       const void* v_new, void* kq, void* ks,
                                       void* vq, void* vs, const void* pb,
                                       const void* off, int B, int KVH, int D,
                                       int NB, void* stream) {
  if (KVH <= 0 || D <= 0 || NB <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  const int* p = static_cast<const int*>(pb);
  const int* o = static_cast<const int*>(off);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == LT_BF16)
    return launch_q8<__nv_bfloat16>(k_new, v_new, kq, ks, vq, vs, p, o, B,
                                    KVH, D, NB, st);
  if (dtype == LT_F32)
    return launch_q8<float>(k_new, v_new, kq, ks, vq, vs, p, o, B, KVH, D,
                            NB, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
