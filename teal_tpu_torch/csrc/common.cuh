// Shared helpers for the port's kernels: element types, the gather
// GEMVs' weight plans and thread layout, fixed-order block reductions,
// and asynchronous copies with the mbarriers they complete on.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace teal {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) {
  return static_cast<float>(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float to T's precision and back (identity for fp32).
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum in a fixed order: butterfly within each warp, then warp
// partials added in warp order by one thread. `scratch` holds >= 32
// floats. Every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += scratch[w];
    scratch[0] = s;
  }
  __syncthreads();
  float r = scratch[0];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = scratch[0];
    for (int w = 1; w < nw; ++w) m = fmaxf(m, scratch[w]);
    scratch[0] = m;
  }
  __syncthreads();
  float r = scratch[0];
  __syncthreads();
  return r;
}

// Weight plans of the gather GEMVs K1 and K3 (the reference's
// `_WeightPlan`, teal_tpu/ops/block_gemv.py:82): weights of the stream
// type T; int8 (converted exactly to fp32; a per-channel scale, where
// there is one, goes on the fp32 sums); packed int4: a byte of row p of
// group g's packed slab [G/2, N] holds row g*G + p in its low nibble and
// row g*G + G/2 + p in its high one, and sz [nb, 2, N] holds each
// group's [scale, zero] (`quant.pack_int4`).
enum Plan { PLAN_STREAM = 0, PLAN_INT8 = 1, PLAN_INT4 = 2 };

// Thread layout of the gather GEMVs (K1, K3, K4): a block owns TILE
// output columns; a thread loads VEC columns of one weight row (16 bytes,
// or 8 bytes = 8 columns x 2 rows of packed int4), LPR lanes cover a
// row's tile, so a warp covers RPW rows per load and the block SLOTS rows
// ("row slots").
template <int VEC_, int TILE, int THREADS>
struct VecShape {
  static constexpr int VEC = VEC_;
  static constexpr int LPR = TILE / VEC;
  static constexpr int RPW = 32 / LPR;
  static constexpr int SLOTS = (THREADS / 32) * RPW;
};

template <typename T, int TILE, int THREADS>
using GatherShape = VecShape<16 / sizeof(T), TILE, THREADS>;

// The layout of plan P with a stream of type T.
template <typename T, int P, int TILE, int THREADS>
using PlanShape =
    VecShape<P == PLAN_INT8 ? 16 : (P == PLAN_INT4 ? 8 : 16 / sizeof(T)),
             TILE, THREADS>;

// One 16-byte load of VEC weights of element type E, as fp32.
template <typename E, int VEC>
__device__ __forceinline__ void load_row(const E* p, float (&v)[VEC]) {
  static_assert(VEC * sizeof(E) == 16, "a row load is 16 bytes");
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const E* e = reinterpret_cast<const E*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = to_f(e[i]);
}

// One 8-byte load of packed int4: 8 columns of two rows, as the raw
// nibbles 0..15 in fp32 (low nibble: the group's row p, high: p + G/2).
__device__ __forceinline__ void load_nibbles(const int8_t* p, float (&lo)[8],
                                             float (&hi)[8]) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    lo[i] = static_cast<float>(b[i] & 15);
    hi[i] = static_cast<float>(b[i] >> 4);
  }
}

// --- asynchronous copies, tensor cores and clusters (sm_90a) ---------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, through L2 only (one weight slab is read once)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, which lands in r[i].
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// mbarriers (shared::cta): init by one thread, then the fence before any
// other thread uses them; a wait spins until the phase of the given
// parity has completed (a fresh barrier is in phase 0).
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// One arrival that also expects `bytes` of asynchronous copies.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// The cluster barrier in two halves: an arrival that orders nothing (at a
// kernel's entry), and the wait that completes it. After the wait every
// block of the cluster has started, so its shared memory may be written.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// 8 consecutive fp32 values (32-byte aligned).
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// First half of the fixed-order sum over row slots: a butterfly across
// the RPW lanes of each warp that hold the same columns, then lanes
// [0, LPR) store the warp's partials [R][TILE] at red + warp * R * TILE.
// After a __syncthreads the caller adds the warps' partials in warp
// order, so the result never depends on scheduling.
template <typename S, int TILE, int R>
__device__ __forceinline__ void warp_partials(float (&acc)[R][S::VEC],
                                              float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = S::LPR; o < 32; o <<= 1)
#pragma unroll
    for (int b = 0; b < R; ++b)
#pragma unroll
      for (int e = 0; e < S::VEC; ++e)
        acc[b][e] += __shfl_xor_sync(0xffffffffu, acc[b][e], o);
  if (lane < S::LPR)
#pragma unroll
    for (int b = 0; b < R; ++b)
#pragma unroll
      for (int e = 0; e < S::VEC; ++e)
        red[(warp * R + b) * TILE + lane * S::VEC + e] = acc[b][e];
}

}  // namespace teal
