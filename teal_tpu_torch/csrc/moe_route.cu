// K5: Mixtral routing for single-token decode.
//
// Replaces the routing of the Pallas whole-token kernel's MoE branch
// (inside the `pallas_call` at teal_tpu/ops/token_block.py:518): the
// mlp-norm fold before it (`_norm_fold`, teal_tpu/ops/block_gemv.py:388,
// called at token_block.py:290) and `_moe_route` (token_block.py:131).
// For the raw residual stream x [D] at layer `layer` it computes:
//   1. xn = rms_norm(x) with the reference's cast points:
//      (x * rsqrt(sum(x^2) / D + eps)) -> T, then * gain[layer] -> T;
//   2. fp32 logits[e] = sum over d of xn[d] * router[layer, d, e];
//   3. the top K_EXP experts by repeated max, the lowest index winning
//      among equal logits (jax.lax.top_k's order);
//   4. the softmax of the kept logits, w_t = exp(v_t - v_0) / sum over t
//      of exp(v_t - v_0), the sum taken in t order;
// and writes xn (type T), the pseudo-layers layer * E + e_t (int32) that
// index the expert stacks read as [L*E, K, N], and w (fp32), all on the
// device: the expert stages (K1) read them there, so the host never waits
// for the routing.
//
// What bounds it on the H100: launch latency. It reads x and the gain
// (2 * D values) and the layer's fp32 router (D * E: 128 KB at Mixtral's
// D = 4096, E = 8), about 0.05 us at 3.35 TB/s, and does 2 * D * E flops:
// a few microseconds of launch and block start-up dominate. So the design
// is the simplest that is deterministic: one block of 512 threads. The
// norm is a fixed-order block sum; xn lands in shared memory as fp32.
// Thread t then reads the router rows d = t, t + 512, ... whole (E
// consecutive floats: neighbouring threads read neighbouring rows, so
// every load is coalesced and all of them are in flight at once) and
// keeps one partial sum per expert, in the same order for every expert;
// the partials meet in a butterfly within each warp and then in warp
// order. Every expert's logit is summed in one order, so two equal router
// columns give bit-equal logits and the tie rule sees the tie. Thread 0
// then picks and weighs the top K_EXP.
#include "common.cuh"

using namespace teal;

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_E = 64;      // experts (a 64-bit taken mask)
constexpr int MAX_K = 8;       // routed experts a token
constexpr int ECHUNK = 8;      // experts summed a pass (registers)

struct Args {
  const void* x;               // [D] raw stream
  const void* norm;            // [L, D] gains
  float eps;
  const float* router;         // [L, D, E]
  void* xn;                    // [D] out, type T
  int* eidx;                   // [k_exp] out: layer * E + e_t
  float* w;                    // [k_exp] out: routing weights
  int D, E, k_exp, layer;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) route_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, E = a.E;
  float* xs = smem;                  // [D] xn as fp32
  float* logits = xs + D;            // [E]
  float* part = logits + E;          // [NWARPS][E] per-warp partials
  float* scratch = part + NWARPS * E;  // [32]
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.norm) +
               static_cast<size_t>(a.layer) * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. the folded mlp norm
  float ss = 0.f;
  for (int k = tid; k < D; k += THREADS) {
    const float v = to_f(x[k]);
    ss = fmaf(v, v, ss);
  }
  ss = block_sum(ss, scratch);
  const float scale = 1.0f / sqrtf(ss / static_cast<float>(D) + a.eps);
  T* xn = static_cast<T*>(a.xn);
  for (int k = tid; k < D; k += THREADS) {
    const T v = from_f<T>(rnd<T>(to_f(x[k]) * scale) * to_f(g[k]));
    xn[k] = v;
    xs[k] = to_f(v);
  }
  __syncthreads();

  // 2. logits: whole router rows a thread, one summation order for every
  // expert (thread order, then the butterfly, then warp order)
  const float* r = a.router + static_cast<size_t>(a.layer) * D * E;
  for (int e0 = 0; e0 < E; e0 += ECHUNK) {
    const int ne = min(ECHUNK, E - e0);
    float acc[ECHUNK];
#pragma unroll
    for (int j = 0; j < ECHUNK; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int d = tid; d < D; d += THREADS) {
      const float xv = xs[d];
      const float* row = r + static_cast<size_t>(d) * E + e0;
#pragma unroll
      for (int j = 0; j < ECHUNK; ++j)
        if (j < ne) acc[j] = fmaf(xv, row[j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < ECHUNK; ++j) {
      const float v = warp_sum(acc[j]);
      if (lane == 0 && j < ne) part[warp * E + e0 + j] = v;
    }
  }
  __syncthreads();
  if (tid < E) {
    float s = 0.f;
    for (int w = 0; w < NWARPS; ++w) s += part[w * E + tid];
    logits[tid] = s;
  }
  __syncthreads();

  // 3-4. top K_EXP by repeated max (lowest index among equals), softmax
  if (tid == 0) {
    float v[MAX_K], ex[MAX_K];
    int id[MAX_K];
    unsigned long long taken = 0ull;
    for (int t = 0; t < a.k_exp; ++t) {
      int best = -1;
      for (int e = 0; e < E; ++e) {
        if ((taken >> e) & 1ull) continue;
        if (best < 0 || logits[e] > logits[best]) best = e;
      }
      taken |= 1ull << best;
      id[t] = best;
      v[t] = logits[best];
    }
    float den = 0.f;
    for (int t = 0; t < a.k_exp; ++t) {
      ex[t] = expf(v[t] - v[0]);
      den += ex[t];
    }
    for (int t = 0; t < a.k_exp; ++t) {
      a.eidx[t] = a.layer * E + id[t];
      a.w[t] = ex[t] / den;
    }
  }
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (x, norm and xn). router: fp32 [L, D, E]. The
// caller checks shapes, 0 <= layer < L and 1 <= k_exp <= min(E, 8); E > 64
// or k_exp out of range returns cudaErrorInvalidValue.
extern "C" int teal_moe_route(int dtype, const void* x, const void* norm,
                              float eps, const void* router, void* xn,
                              void* eidx, void* w, int D, int E, int k_exp,
                              int layer, void* stream) {
  cudaGetLastError();  // clear any stale error of this library
  if (E < 1 || E > MAX_E || k_exp < 1 || k_exp > MAX_K || k_exp > E)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.norm = norm;
  a.eps = eps;
  a.router = static_cast<const float*>(router);
  a.xn = xn;
  a.eidx = static_cast<int*>(eidx);
  a.w = static_cast<float*>(w);
  a.D = D;
  a.E = E;
  a.k_exp = k_exp;
  a.layer = layer;
  const size_t smem = sizeof(float) * (D + E + NWARPS * E + 32);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(route_kernel<float>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    route_kernel<float><<<1, THREADS, smem, s>>>(a);
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(route_kernel<__nv_bfloat16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    route_kernel<__nv_bfloat16><<<1, THREADS, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
