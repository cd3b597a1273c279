// Paged-KV decode write: each slot's new K/V row into the block pool, in
// place.
//
// Replaces: localai_tpu/ops/pallas/paged_scatter.py
//   - paged_scatter_append (_append_kernel): bf16/f32 pools [NB,KVH,BS,D];
//   - paged_scatter_append_q8 (_append_q8_kernel): int8 pools plus per-token
//     f32 scales [NB,KVH,1,BS] (ops/kvcache layout with BS == 128).
// Same function: slot b's row k_new[b] ([KVH, D]) goes to physical block
// pb[b], in-block row off[b] of every KV head (the targets the wrapper
// computes once per decode step, as the reference's _targets does at trace
// time); the int8 variant also writes one scale element per (slot, head).
// The pools are updated in place — the counterpart of the Pallas
// input_output_aliases — and nothing else in them is touched.
//
// What bounds it on the H100: pure data movement, B*KVH*D elements read and
// written per pool (a few KB per step at 8B geometry), so the bound is
// those bytes over 3.35 TB/s — far below one launch's overhead. Design: one
// block per slot; its threads copy the slot's KVH rows of D elements with
// the widest vector access the row size allows (16 bytes at D=128 in bf16
// and int8). A target outside the pool (pb >= NB) is skipped, never
// written: the engine's table holds only block ids it allocated.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 128;   // tokens per block == the int8 scale tile
constexpr int NT = 128;

// Copy KVH rows of `row_units` U-sized units from src [B, KVH, row] to the
// pool row (pb, h, off) of [NB, KVH, BS, row]. SCALES: also one f32 scale
// per (slot, head) from [B, KVH] into the scale pool [NB, KVH, 1, BS].
template <typename U, bool SCALES>
__global__ void __launch_bounds__(NT)
    scatter_rows(const U* __restrict__ k_new, const U* __restrict__ v_new,
                 U* __restrict__ k_pool, U* __restrict__ v_pool,
                 const float* __restrict__ ks_new,
                 const float* __restrict__ vs_new, float* __restrict__ ks,
                 float* __restrict__ vs, const int* __restrict__ pb,
                 const int* __restrict__ off, int KVH, int row_units,
                 int NB) {
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
  if (SCALES) {
    for (int h = threadIdx.x; h < KVH; h += NT) {
      const int64_t dst = (static_cast<int64_t>(blk) * KVH + h) * BS + row;
      ks[dst] = ks_new[b * KVH + h];
      vs[dst] = vs_new[b * KVH + h];
    }
  }
}

template <bool SCALES>
int launch_rows(const void* k_new, const void* v_new, void* k_pool,
                void* v_pool, const float* ks_new, const float* vs_new,
                float* ks, float* vs, const int* pb, const int* off, int B,
                int KVH, int row_bytes, int NB, cudaStream_t st) {
  if (B <= 0) return 0;
  if (row_bytes % 16 == 0) {
    scatter_rows<uint4, SCALES><<<B, NT, 0, st>>>(
        static_cast<const uint4*>(k_new), static_cast<const uint4*>(v_new),
        static_cast<uint4*>(k_pool), static_cast<uint4*>(v_pool), ks_new,
        vs_new, ks, vs, pb, off, KVH, row_bytes / 16, NB);
  } else if (row_bytes % 4 == 0) {
    scatter_rows<uint32_t, SCALES><<<B, NT, 0, st>>>(
        static_cast<const uint32_t*>(k_new),
        static_cast<const uint32_t*>(v_new), static_cast<uint32_t*>(k_pool),
        static_cast<uint32_t*>(v_pool), ks_new, vs_new, ks, vs, pb, off, KVH,
        row_bytes / 4, NB);
  } else {
    scatter_rows<uint8_t, SCALES><<<B, NT, 0, st>>>(
        static_cast<const uint8_t*>(k_new),
        static_cast<const uint8_t*>(v_new), static_cast<uint8_t*>(k_pool),
        static_cast<uint8_t*>(v_pool), ks_new, vs_new, ks, vs, pb, off, KVH,
        row_bytes, NB);
  }
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
  return launch_rows<false>(
      k_new, v_new, k_pool, v_pool, nullptr, nullptr, nullptr, nullptr,
      static_cast<const int*>(pb), static_cast<const int*>(off), B, KVH,
      elem_bytes * D, NB, static_cast<cudaStream_t>(stream));
}

// int8: kq_new/vq_new [B, KVH, D] int8 and ks_new/vs_new [B, KVH] f32 (the
// wrapper's per-token quantization); pools kq/vq [NB, KVH, 128, D] int8,
// scales ks/vs [NB, KVH, 1, 128] f32. One launch writes rows and scales.
extern "C" int paged_scatter_q8_launch(const void* kq_new, const void* ks_new,
                                       const void* vq_new, const void* vs_new,
                                       void* kq, void* ks, void* vq, void* vs,
                                       const void* pb, const void* off, int B,
                                       int KVH, int D, int NB, void* stream) {
  if (KVH <= 0 || D <= 0 || NB <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_rows<true>(
      kq_new, vq_new, kq, vq, static_cast<const float*>(ks_new),
      static_cast<const float*>(vs_new), static_cast<float*>(ks),
      static_cast<float*>(vs), static_cast<const int*>(pb),
      static_cast<const int*>(off), B, KVH, D, NB,
      static_cast<cudaStream_t>(stream));
}
