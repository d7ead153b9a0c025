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

// One 16-byte load of VEC weights of element type E, as fp32.
template <typename E, int VEC>
__device__ __forceinline__ void load_row(const E* p, float (&v)[VEC]) {
  static_assert(VEC * sizeof(E) == 16, "a row load is 16 bytes");
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const E* e = reinterpret_cast<const E*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = to_f(e[i]);
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

// cp.async.wait_group with a run-time count (a ring's depth - 2)
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// --- the gather GEMVs' split of their slots or kept groups ---------------

// The first item of split s of S over `count` items: split s takes
// [split_lo(count, S, s), split_lo(count, S, s + 1)), so the S splits
// cover [0, count) once, in order (some empty where count < S).
__host__ __device__ inline int split_lo(int count, int S, int s) {
  return static_cast<int>(static_cast<long long>(count) * s / S);
}

// --- int8 and packed int4 as bf16, exactly (the gather GEMVs' MMAs) -------

// bf16x2 (128 + a, 128 + b) -> (a, b): exact for nibbles
__device__ __forceinline__ uint32_t minus128(uint32_t v) {
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                                   __floats2bfloat162_rn(128.f, 128.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// bf16x2 of byte s of int8 words w0 (low half) and w1, exactly and on
// full-rate integer and half2 units: magnitude m <= 128 as bits 0x4300 | m
// (128 + m: bf16 counts 1s from 128 to 256), the sign in bit 15, then
// +-(128 + m) - +-128.
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w0, uint32_t w1,
                                              int s) {
  const uint32_t m = __byte_perm(__vabs4(w0), __vabs4(w1),
                                 s | ((4 + s) << 8)) & 0x00FF00FFu;
  const uint32_t sg = __byte_perm(w0, w1, (s << 4) | ((4 + s) << 12)) &
                      0x80008000u;
  uint32_t v = m | 0x43004300u | sg, c = 0x43004300u | sg;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                                   *reinterpret_cast<__nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// B fragments of mma16816 for one warp's 16 k-rows of a gathered weight
// slab in shared memory (rows `wstride` bytes apart), over a 64-column
// tile: MMA k-index i reads slab row row0 + i (i < 8) or row0 + HALF + i
// - 8 -- for packed int4 the low (i < 8) and high nibbles of packed row
// row0 + i % 8, so one byte feeds two k-indices (HALF = G / 2 places the
// high nibbles' rows in the group). Column n (0..7) of n-tile t is the
// tile's column 8n + t, so a lane's eight n-tiles share one 16-byte
// (bf16) or 8-byte (int8, int4) chunk of a weight row. int8 values and
// nibbles become bf16 exactly.
template <int P, int HALF>
__device__ __forceinline__ void gather_b_frags(const unsigned char* W,
                                               int wstride, int row0,
                                               uint32_t (&b)[8][2]) {
  const int lane = threadIdx.x & 31;
  const int q = lane & 3, n8 = (lane >> 2) * 8;
  if constexpr (P == PLAN_STREAM) {            // bf16
    const unsigned char* r0 = W + (row0 + 2 * q) * wstride + n8 * 2;
    const uint4 v0 = *reinterpret_cast<const uint4*>(r0);
    const uint4 v1 = *reinterpret_cast<const uint4*>(r0 + wstride);
    const uint4 v2 = *reinterpret_cast<const uint4*>(r0 + HALF * wstride);
    const uint4 v3 =
        *reinterpret_cast<const uint4*>(r0 + (HALF + 1) * wstride);
    const uint32_t e0[4] = {v0.x, v0.y, v0.z, v0.w};
    const uint32_t e1[4] = {v1.x, v1.y, v1.z, v1.w};
    const uint32_t e2[4] = {v2.x, v2.y, v2.z, v2.w};
    const uint32_t e3[4] = {v3.x, v3.y, v3.z, v3.w};
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const uint32_t s = (t & 1) ? 0x7632u : 0x5410u;
      b[t][0] = __byte_perm(e0[t >> 1], e1[t >> 1], s);
      b[t][1] = __byte_perm(e2[t >> 1], e3[t >> 1], s);
    }
  } else if constexpr (P == PLAN_INT8) {
    const unsigned char* r0 = W + (row0 + 2 * q) * wstride + n8;
    const uint2 v0 = *reinterpret_cast<const uint2*>(r0);
    const uint2 v1 = *reinterpret_cast<const uint2*>(r0 + wstride);
    const uint2 v2 = *reinterpret_cast<const uint2*>(r0 + HALF * wstride);
    const uint2 v3 =
        *reinterpret_cast<const uint2*>(r0 + (HALF + 1) * wstride);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      b[t][0] = i8x2_bf16(t < 4 ? v0.x : v0.y, t < 4 ? v1.x : v1.y, t & 3);
      b[t][1] = i8x2_bf16(t < 4 ? v2.x : v2.y, t < 4 ? v3.x : v3.y, t & 3);
    }
  } else {                                     // packed int4
    const unsigned char* r0 = W + (row0 + 2 * q) * wstride + n8;
    const uint2 p0 = *reinterpret_cast<const uint2*>(r0);
    const uint2 p1 = *reinterpret_cast<const uint2*>(r0 + wstride);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const uint32_t s = t & 3;
      // bytes 0, 1: packed row 2q's byte t; bytes 2, 3: row 2q + 1's
      const uint32_t v = __byte_perm(t < 4 ? p0.x : p0.y, t < 4 ? p1.x : p1.y,
                                     s | (s << 4) | ((4 + s) << 8) |
                                         ((4 + s) << 12));
      b[t][0] = minus128((v & 0x000F000Fu) | 0x43004300u);
      b[t][1] = minus128(((v >> 4) & 0x000F000Fu) | 0x43004300u);
    }
  }
}

// --- int8 and packed int4 as fp32, exactly (the one-row streams) -------

// Byte k of an int8 word as fp32, exactly: the byte b xor 0x80 placed
// under 0x4B000000 is the float 2^23 + 128 + b, and 2^23 + 128 comes off.
__device__ __forceinline__ float i8_f(uint32_t w, int k) {
  return __int_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u,
                                    k | (4 << 4) | (5 << 8) | (7 << 12))) -
         8388736.f;
}

// 128 + nibble byte k of w (bytes 0..15) as fp32, exactly, in one PRMT:
// the bits 0x43000000 | n << 16 (the bf16 0x4300 | n widened).
__device__ __forceinline__ float nib128_f(uint32_t w, int k) {
  return __int_as_float(__byte_perm(w, 0x43000000u,
                                    4 | (5 << 4) | (k << 8) | (7 << 12)));
}

}  // namespace teal
