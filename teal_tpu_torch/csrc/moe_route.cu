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
// What bounds it on the H100: latency. It reads x and the gain (2 * D
// values) and the layer's fp32 router (D * E: 128 KB at Mixtral's D =
// 4096, E = 8), about 0.05 us at 3.35 TB/s, and does 2 * D * E flops; the
// launch, one trip to memory and the barriers are what a call costs. So
// the design keeps every SM's share of the reads in flight at once and
// puts the one read that waits for nothing first:
//   - one cluster of C <= 8 blocks (`route_plan`); block `rank` takes the
//     rows [split_lo(D, C, rank), split_lo(D, C, rank + 1)) of x, the gain
//     and the router;
//   - before anything else each block issues its router slab (16 KB at
//     Mixtral's shapes) into shared memory as 16-byte `cp.async` copies
//     (4-byte ones at a slab's unaligned ends), so its latency runs under
//     the x read and the norm;
//   - every block sums the squares of all of x (8 KB, from L2) in one
//     fixed order (a thread's elements in order, the butterfly, the warps
//     in order), so all hold the same scale without a cluster barrier
//     (rsqrtf, as the reference's rsqrt rounds on the card: torch.rsqrt);
//     pushing each block's partial to its peers instead costs a barrier
//     and was slower (PERF.md section 6, row 2a);
//   - a block's xn rows land in global memory and, as fp32, in shared
//     memory; each thread then sums one expert's column over a stride of
//     rows, reading the flat slab with neighbouring threads on
//     neighbouring words (no bank conflicts at any E), and an expert's
//     threads meet in thread order, the same order for every expert (then
//     rank order): two equal router columns give bit-equal logits, and the
//     tie rule sees the tie;
//   - the block's E partials are pushed to rank 0; after the one cluster
//     barrier one warp of rank 0 adds them in rank order (lane e holds
//     experts e and e + 32), counts each expert's place among the logits
//     (the larger first, the lower index among equals: the order of
//     repeated max) and writes the first K_EXP places and their softmax.
//     No block touches a peer's shared memory after its last barrier, and
//     nothing is atomic.
// Measured on the H100: PERF.md section 6, row 2a.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace teal;

namespace {

constexpr int THREADS = 256;
constexpr int MAXC = 8;        // blocks a cluster (the portable size)
constexpr int MIN_ROWS = 64;   // rows a block at least, where D allows
constexpr int MAX_E = 64;      // experts (two a lane of the picking warp)
constexpr int MAX_K = 8;       // routed experts a token
constexpr int MAXR = 4;        // x and gain rows a thread keeps in registers
constexpr int SMEM_MAX = 232448;  // a block's shared memory on Hopper

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// Shared memory of a block, in floats: the router slab [rows * E] (+3:
// it keeps its global address's offset within 16 bytes), xn as fp32
// [rows], the threads' partial logits [THREADS], the peers' partial
// logits [MAXC][E] (rank 0's are read) and block_sum's scratch [32]. The
// wrapper's `_route_smem` mirrors `total` (bytes).
struct RouteLayout {
  int xs, part, cpart, scratch, total;
  __host__ __device__ RouteLayout(int rows, int E) {
    xs = pad4(rows * E + 3);
    part = xs + rows;
    cpart = part + THREADS;
    scratch = cpart + MAXC * E;
    total = (scratch + 32) * 4;
  }
};

// The plan, from D and E only: C blocks (the largest power of two <= MAXC
// leaving each block MIN_ROWS rows, at least 1), rows = the largest share
// ceil(D / C), and the shared bytes; smem -1 where no plan fits (a block's
// rows beyond MAXR a thread, or its slab beyond shared memory).
struct RoutePlan { int C, rows, smem; };

RoutePlan route_plan(int D, int E) {
  RoutePlan p = {0, 0, -1};
  if (D < 1 || E < 1 || E > MAX_E) return p;
  int C = MAXC;
  while (C > 1 && D < C * MIN_ROWS) C >>= 1;
  const int rows = (D + C - 1) / C;
  const int smem = RouteLayout(rows, E).total;
  if (rows > MAXR * THREADS || smem > SMEM_MAX) return p;
  p = {C, rows, smem};
  return p;
}

struct Args {
  const void* x;               // [D] raw stream
  const void* norm;            // [L, D] gains
  float eps;
  const float* router;         // [L, D, E]
  void* xn;                    // [D] out, type T
  int* eidx;                   // [k_exp] out: layer * E + e_t
  float* w;                    // [k_exp] out: routing weights
  int D, E, k_exp, layer, C, rows;
};

// 4 bytes global -> shared (a slab's unaligned ends)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) route_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int D = a.D, E = a.E, C = a.C;
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = split_lo(D, C, rank), n = split_lo(D, C, rank + 1) - lo;
  const RouteLayout lay(a.rows, E);
  float* xs = sm + lay.xs;
  float* part = sm + lay.part;
  float* cpart = sm + lay.cpart;
  float* scratch = sm + lay.scratch;
  cluster_arrive_relaxed();

  // 1. the router slab, issued first: rows [lo, lo + n) are n * E floats
  // from `src`, which need not be 16-byte aligned; they land at the same
  // offset within 16 bytes, so the aligned middle goes in 16-byte copies
  const float* src =
      a.router + (static_cast<size_t>(a.layer) * D + lo) * E;
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  float* slab = sm + mis;
  const int cnt = n * E;
  const int head = min(cnt, (4 - mis) & 3);
  const int nvec = (cnt - head) >> 2;
  const int tail = head + 4 * nvec;
  for (int j = tid; j < nvec; j += THREADS)
    cp_async16(slab + head + 4 * j, src + head + 4 * j);
  if (tid < head) cp_async4(slab + tid, src + tid);
  if (tid < cnt - tail) cp_async4(slab + tail + tid, src + tail + tid);
  cp_async_commit();

  // 2. the norm: the block's gain rows, which do not wait for the kernel
  // before, then its x rows, kept in registers (MAXR a thread)
  const T* x = static_cast<const T*>(a.x) + lo;
  const T* g = static_cast<const T*>(a.norm) +
               static_cast<size_t>(a.layer) * D + lo;
  float xv[MAXR], gv[MAXR];
#pragma unroll
  for (int i = 0; i < MAXR; ++i)
    if (tid + i * THREADS < n) gv[i] = to_f(g[tid + i * THREADS]);
#pragma unroll
  for (int i = 0; i < MAXR; ++i)
    if (tid + i * THREADS < n) xv[i] = to_f(x[tid + i * THREADS]);
  // every block sums the squares of all of x (8 KB at Mixtral's D, read
  // from L2) in one order, so all hold the same scale without a cluster
  // barrier
  const T* xall = static_cast<const T*>(a.x);
  float s = 0.f;
#pragma unroll 16
  for (int d = tid; d < D; d += THREADS) {
    const float v = to_f(xall[d]);
    s = fmaf(v, v, s);
  }
  s = block_sum(s, scratch);
  const float scale = rsqrtf(s / static_cast<float>(D) + a.eps);
  T* xn = static_cast<T*>(a.xn) + lo;
  auto norm_row = [&](int r, float v, float gain) {
    const T o = from_f<T>(rnd<T>(v * scale) * gain);
    xn[r] = o;
    xs[r] = to_f(o);
  };
#pragma unroll
  for (int i = 0; i < MAXR; ++i)
    if (tid + i * THREADS < n) norm_row(tid + i * THREADS, xv[i], gv[i]);
  cp_async_wait<0>();
  __syncthreads();
  cluster_wait();                       // every peer has started

  // 3. the block's partial logits. The slab is flat [n * E]; thread t <
  // TE (the largest multiple of E <= THREADS) reads elements t, t + TE,
  // ... (neighbouring threads on neighbouring words), all of one expert
  // t % E, from rows t / E, t / E + TE / E, ...; the sums of an expert's
  // threads then meet in thread order. Every expert is summed in the same
  // order (rows, then threads, then ranks), so two equal router columns
  // give bit-equal logits and the tie rule sees the tie.
  const int TE = (THREADS / E) * E;
  if (tid < TE) {
    float acc = 0.f;
    const int dr = TE / E;
    for (int f = tid, r = tid / E; f < cnt; f += TE, r += dr)
      acc = fmaf(xs[r], slab[f], acc);
    part[tid] = acc;
  }
  __syncthreads();
  if (tid < E) {
    float b = 0.f;
    for (int t = tid; t < TE; t += E) b += part[t];
    cluster.map_shared_rank(cpart, 0)[rank * E + tid] = b;
  }
  cluster.sync();                       // no peer access after this
  if (rank != 0 || warp != 0) return;

  // 4. rank 0, one warp: the logits in rank order (lane e holds experts
  // e and e + 32), each expert's place among them (the larger logit
  // first, the lower index among equals: repeated max's order), then the
  // places t < k_exp: the pseudo-layers, and the softmax anchored at the
  // top logit, summed in t order
  float* lg = part;                     // [E] the logits
  float* sel = part + MAX_E;            // [k_exp] the kept logits, in order
  const float ninf = __int_as_float(0xff800000u);
  float v0 = ninf, v1 = ninf;
  if (lane < E) {
    v0 = 0.f;
    for (int q = 0; q < C; ++q) v0 += cpart[q * E + lane];
    lg[lane] = v0;
  }
  if (lane + 32 < E) {
    v1 = 0.f;
    for (int q = 0; q < C; ++q) v1 += cpart[q * E + lane + 32];
    lg[lane + 32] = v1;
  }
  __syncwarp();
  int p0 = 0, p1 = 0;
  for (int q = 0; q < E; ++q) {
    const float u = lg[q];
    p0 += u > v0 || (u == v0 && q < lane);
    p1 += u > v1 || (u == v1 && q < lane + 32);
  }
  const int k = a.k_exp, base = a.layer * E;
  if (lane < E && p0 < k) {
    sel[p0] = v0;
    a.eidx[p0] = base + lane;
  }
  if (lane + 32 < E && p1 < k) {
    sel[p1] = v1;
    a.eidx[p1] = base + lane + 32;
  }
  __syncwarp();
  if (lane < k) {
    float den = 0.f;
    for (int t = 0; t < k; ++t) den += expf(sel[t] - sel[0]);
    a.w[lane] = expf(sel[lane] - sel[0]) / den;
  }
}

template <typename T>
int launch(const Args& a0, cudaStream_t stream) {
  const RoutePlan p = route_plan(a0.D, a0.E);
  if (p.smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a = a0;
  a.C = p.C;
  a.rows = p.rows;
  auto fn = route_kernel<T>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.C, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fn, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

}  // namespace

// An empty kernel of `blocks` blocks of K5's THREADS threads, in one
// cluster of them where `cluster` is non-zero: the least a launch of K5's
// shape costs on the card (the floor chip_smoke.py times beside K5).
extern "C" int teal_empty_launch(int blocks, int cluster, void* stream) {
  cudaGetLastError();
  if (blocks < 1 || blocks > MAXC)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, empty_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The launch plan for D rows and E experts: out = {C, rows a block,
// shared bytes a block}; shared bytes -1 where no plan fits.
extern "C" int teal_moe_route_plan(int D, int E, int* out) {
  const RoutePlan p = route_plan(D, E);
  out[0] = p.C;
  out[1] = p.rows;
  out[2] = p.smem;
  return 0;
}

// dtype: 0 fp32, 1 bf16 (x, norm and xn). router: fp32 [L, D, E]. The
// caller checks shapes, 0 <= layer < L and 1 <= k_exp <= min(E, 8); E > 64,
// k_exp out of range or shapes with no plan return cudaErrorInvalidValue.
extern "C" int teal_moe_route(int dtype, const void* x, const void* norm,
                              float eps, const void* router, void* xn,
                              void* eidx, void* w, int D, int E, int k_exp,
                              int layer, void* stream) {
  cudaGetLastError();  // clear any stale error of this library
  if (E < 1 || E > MAX_E || k_exp < 1 || k_exp > MAX_K || k_exp > E)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
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
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(a, s) : launch<__nv_bfloat16>(a, s);
}
