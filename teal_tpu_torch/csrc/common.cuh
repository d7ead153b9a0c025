// Shared helpers for the port's kernels: element types and fixed-order
// block reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace teal {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// Thread layout of the gather GEMVs (K1, K3, K4): a block owns TILE
// output columns; a thread loads 16 bytes (VEC columns) of one weight
// row, LPR lanes cover a row's tile, so a warp covers RPW rows per load
// and the block SLOTS rows ("row slots").
template <typename T, int TILE, int THREADS>
struct GatherShape {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int LPR = TILE / VEC;
  static constexpr int RPW = 32 / LPR;
  static constexpr int SLOTS = (THREADS / 32) * RPW;
};

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
