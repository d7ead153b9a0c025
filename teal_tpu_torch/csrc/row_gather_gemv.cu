// K4: unstructured row-gather GEMV (the exact elementwise TEAL rule).
//
// Replaces the Pallas kernel `_kernel` of `row_gather_gemv`
// (teal_tpu/ops/gather_gemv.py:61), whose grid steps one weight row at a
// time. It computes
//   out[n] = sum over slots i < nnz_cap of xc[i] * W[idx[i], n]
// with fp32 sums, cast to W's type: idx and xc are the compacted
// survivors of `|x| > t` (`gather_gemv.compact_indices`), padded and
// overflow slots carrying xc == 0.
//
// What bounds it on the H100: bytes. A slot with xc != 0 needs one weight
// row (8 KB for a 4096-wide bf16 output, 22 KB for 11008), against 2 * N
// flops; a slot with xc == 0 needs nothing. The TPU pays a fixed cost per
// grid step (about 180 ns a row, gather_gemv.py:10-15); a GPU has no such
// step, so skipping single rows is worth only the bytes they save.
//
// Design: the gather of K1 and K3 with one row per group. Each block
// owns 32 output columns (N / 32 blocks: 128 at N = 4096, 344 at 11008)
// and walks the slots in 64 row slots (bf16; 32 for fp32), each thread
// loading 16 bytes of one survivor's row; slots with xc == 0 load
// nothing. Partial sums are added in a fixed order (a warp butterfly,
// then warps in order): no atomics, no dependence on scheduling. Indices
// are clamped to [0, K): a bad index reads a wrong row, never outside W.
#include "common.cuh"

using namespace teal;

namespace {

constexpr int TILE = 32;     // output columns per block
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
rgg_kernel(const int* idx, const float* xc, const T* w, T* out, int K,
           int N, int nnz) {
  using S = GatherShape<T, TILE, THREADS>;
  __shared__ float red[(THREADS / 32) * TILE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * TILE;
  const int sub = lane % S::LPR;
  const int slot = warp * S::RPW + lane / S::LPR;
  const T* W = w + c0 + sub * S::VEC;

  float acc[1][S::VEC];
#pragma unroll
  for (int e = 0; e < S::VEC; ++e) acc[0][e] = 0.f;
#pragma unroll 4
  for (int r = slot; r < nnz; r += S::SLOTS) {
    const float xv = __ldg(xc + r);
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (xv != 0.f) {
      const int k = min(max(__ldg(idx + r), 0), K - 1);
      raw = __ldg(reinterpret_cast<const uint4*>(
          W + static_cast<size_t>(k) * N));
    }
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < S::VEC; ++e)
      acc[0][e] = fmaf(xv, to_f(v[e]), acc[0][e]);
  }
  warp_partials<S, TILE>(acc, red);
  __syncthreads();
  if (tid < TILE) {
    float s = 0.f;
    for (int wp = 0; wp < THREADS / 32; ++wp) s += red[wp * TILE + tid];
    out[c0 + tid] = from_f<T>(s);
  }
}

template <typename T>
int launch(const int* idx, const float* xc, const void* w, void* out, int K,
           int N, int nnz, cudaStream_t s) {
  rgg_kernel<T><<<N / TILE, THREADS, 0, s>>>(
      idx, xc, static_cast<const T*>(w), static_cast<T*>(out), K, N, nnz);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (weights and output). The caller checks shapes:
// N % 32 == 0, w 16-byte aligned, idx and xc of length nnz.
extern "C" int teal_row_gather_gemv(int dtype, const void* idx,
                                    const void* xc, const void* w, void* out,
                                    int K, int N, int nnz, void* stream) {
  cudaGetLastError();  // clear any stale error of this library
  auto s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(idx);
  const float* x = static_cast<const float*>(xc);
  return dtype == 0 ? launch<float>(i, x, w, out, K, N, nnz, s)
                    : launch<__nv_bfloat16>(i, x, w, out, K, N, nnz, s);
}
