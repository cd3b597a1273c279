// Shared helpers of the port's kernels (sm_90a, plain C ABI).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The reference's mask value, -0.7 * f32max: large but finite, so
// exp(NEG_INF - NEG_INF) stays 1 instead of NaN on a fully masked row and
// exp(NEG_INF - m) is exactly 0 once a real score is seen.
#define LT_NEG_INF (static_cast<float>(-0.7 * 3.4028234663852886e38))

enum LtDtype { LT_F32 = 0, LT_BF16 = 1 };

__device__ __forceinline__ float lt_to_f(float x) { return x; }
__device__ __forceinline__ float lt_to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float lt_to_f(int8_t x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T lt_from_f(float x);
template <> __device__ __forceinline__ float lt_from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 lt_from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

// Stage `rows` rows of D elements into shared memory as f32 (times `mul`),
// row r read from src + r * src_stride. Rows at or past `valid` are zero
// and never read from device memory. Loads are 16 bytes per thread, so D *
// sizeof(T) must be a multiple of 16 and every row 16-byte aligned (the
// wrappers check both).
template <typename T>
__device__ __forceinline__ void lt_load_tile(float* dst, int ld,
                                             const T* __restrict__ src,
                                             int64_t src_stride, int rows,
                                             int valid, int D, float mul) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_row = D / VEC;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * VEC;
    float* d = dst + r * ld + c;
    if (r < valid) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + r * src_stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) d[j] = lt_to_f(e[j]) * mul;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) d[j] = 0.f;
    }
  }
}

// 16-byte asynchronous copy global -> shared (cp.async, L2 only). With
// valid == false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void lt_cp_async16(void* dst, const void* src,
                                              bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void lt_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void lt_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Raise `kernel`'s dynamic shared memory limit to `smem` bytes on the
// current device. The attribute is per device, so `done` keeps, per device
// id, the largest size set so far, and a launch sets it only when it needs
// more on its device; a device id past LT_MAX_DEVICES sets it every time.
constexpr int LT_MAX_DEVICES = 64;
template <typename K>
inline cudaError_t lt_set_max_smem(K* kernel, size_t smem,
                                   size_t (&done)[LT_MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool kept = dev >= 0 && dev < LT_MAX_DEVICES;
  if (kept && smem <= done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess && kept) done[dev] = smem;
  return e;
}

__device__ __forceinline__ float lt_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float lt_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------- Hopper: wgmma, mbarrier, TMA

__device__ __forceinline__ uint32_t lt_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, 128-byte swizzle. lbo/sbo in bytes.
__device__ __forceinline__ uint64_t lt_smem_desc(const void* p, uint32_t lbo,
                                                 uint32_t sbo) {
  const uint32_t a = lt_smem_u32(p);
  uint64_t d = static_cast<uint64_t>((a & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16;
  d |= static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32;
  d |= 1ull << 62;
  return d;
}

__device__ __forceinline__ void lt_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void lt_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups of the warpgroup are pending
template <int N>
__device__ __forceinline__ void lt_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads across the async MMA
template <int N>
__device__ __forceinline__ void lt_fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// eight accumulator operands d[i..i+7] of a wgmma asm statement
#define LT_D8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// mbarriers in shared memory. A wait on `parity` returns once the phase of
// that parity has completed (the phase before the first, parity 1, counts
// as completed: a producer's first wait on an empty slot passes).
__device__ __forceinline__ void lt_mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   lt_smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void lt_mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void lt_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   lt_smem_u32(bar))
               : "memory");
}
// arrive, and expect `bytes` more of asynchronous copies in this phase
__device__ __forceinline__ void lt_mbar_expect_tx(uint64_t* bar,
                                                  uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          lt_smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void lt_mbar_wait(uint64_t* bar,
                                             uint32_t parity) {
  const uint32_t a = lt_smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at coordinates (c0 innermost, c1) of the 2-D tensor map at
// `map` (a __grid_constant__ kernel parameter) into shared memory at dst;
// completion is reported to `bar` as transaction bytes.
__device__ __forceinline__ void lt_tma_load_2d(void* dst, const void* map,
                                               uint64_t* bar, int c0,
                                               int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(lt_smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(lt_smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
