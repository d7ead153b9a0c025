// K1: select + gather GEMV for single-token decode at group size G in
// {32, 64, 128}.
//
// Replaces the Pallas kernel `_fused_select_gather_kernel`
// (teal_tpu/ops/block_gemv.py:518, launched by
// `fused_select_gather_packed`, block_gemv.py:761, and at any G by
// `fused_select_gather_gemv`, block_gemv.py:682) and the projection
// stage `_proj_stage` of the whole-token kernel
// (teal_tpu/ops/token_block.py:55) and of the attention block
// (teal_tpu/ops/attn_block.py:94, its QKV gather). It computes:
//   1. an optional rms_norm of x in fp32 (`_norm_fold`), with the
//      reference's cast points: (x * rsqrt(mean(x^2) + eps)) -> T, * gain;
//   2. a max-|x| score for each G-wide group;
//   3. THE selection rule: survivors are score > thr, taken in ascending
//      group order, the first `cap` kept (`_select_scan`);
//   4. y[n] = sum over kept rows k of x[k] * W[layer, k, n], fp32 sums,
//      over 1-3 layer-stacked weights [L, K, N_i] sharing one selection;
//   5. an epilogue: raw fp32 (q|k|v), + residual then cast (o, down), or
//      silu(gate) * up then cast (gate|up: mode 2, two weights).
//
// What bounds it on the H100: bytes. Per call it reads cap * 128 rows of
// each weight (bf16: 16 MB for the 7B o stage at cap 16, 90 MB for
// gate|up), against 2 * rows * N flops, so HBM bandwidth (3.35 TB/s) is
// the roofline and the kernel should keep enough loads in flight on
// every SM.
//
// Design. Each block owns a tile of 32 output columns of every weight it
// reads, so the grid is N_out / 32 blocks (128 blocks for a 4096-wide
// output, 688 for gate|up at 7B) and no block needs another's result:
// no atomics, no split-K. Every block reads the whole input vector (at
// most 11008 values) and repeats the norm, the scores and the scan
// itself -- a few microseconds of L2 traffic that replaces a second
// launch. The scan is a warp ballot + popcount prefix over the groups
// (32 a step; up to 344 groups), which keeps exactly the groups the
// serial scan keeps. G is a template parameter, so the row -> (group,
// offset) split in the gather is a shift and a mask. In the gather,
// each thread loads 16 bytes (8 bf16 columns) of one kept row; a warp
// covers 8 rows (bf16) of the tile per instruction and the 8 warps 64
// rows, unrolled 4 deep. The 64 per-slot partial sums of each column are
// added in slot order through shared memory, so the result does not
// depend on scheduling.
#include "common.cuh"

using namespace teal;

namespace {

constexpr int TILE = 32;     // output columns per block
constexpr int THREADS = 256;

struct Args {
  const void* x;
  const float* thr;
  const void* norm;          // [L, K] gains, or null
  float eps;
  const void* w[3];          // [L, K, n_i] each
  int n[3];
  int n_w;
  const void* res;           // [N_out] residual (mode 1)
  void* out;                 // fp32 [N_tot] (mode 0) or T [N_out]
  int* idx_out;              // [cap] kept groups, -1 past the count
  int* count_out;            // [1]
  int K, layer, cap, mode;
};

template <typename T>
using Shape = GatherShape<T, TILE, THREADS>;

template <typename T, bool PAIR, int G>
__global__ void __launch_bounds__(THREADS) sgg_kernel(Args a) {
  using S = Shape<T>;
  constexpr int NW = PAIR ? 2 : 1;
  extern __shared__ float smem[];
  const int K = a.K, nb = K / G;
  float* xs = smem;                             // [K] selected input
  float* red = xs + K;                          // [SLOTS][NW * TILE]
  float* scores = red + S::SLOTS * NW * TILE;   // [nb]
  float* scratch = scores + nb;                 // [32]
  float* fin = scratch + 32;                    // [NW * TILE]
  int* idx = reinterpret_cast<int*>(fin + NW * TILE);  // [cap]
  int* cnt = idx + a.cap;                       // [1]
  const T* x = static_cast<const T*>(a.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. input, with the optional folded rms_norm
  if (a.norm != nullptr) {
    float ss = 0.f;
    for (int k = tid; k < K; k += THREADS) {
      const float v = to_f(x[k]);
      ss = fmaf(v, v, ss);
    }
    ss = block_sum(ss, scratch);
    const float scale = 1.0f / sqrtf(ss / static_cast<float>(K) + a.eps);
    const T* g = static_cast<const T*>(a.norm) +
                 static_cast<size_t>(a.layer) * K;
    for (int k = tid; k < K; k += THREADS)
      xs[k] = rnd<T>(rnd<T>(to_f(x[k]) * scale) * to_f(g[k]));
  } else {
    for (int k = tid; k < K; k += THREADS) xs[k] = to_f(x[k]);
  }
  __syncthreads();

  // 2. group scores
  for (int gi = warp; gi < nb; gi += THREADS / 32) {
    float m = 0.f;
    for (int j = lane; j < G; j += 32) m = fmaxf(m, fabsf(xs[gi * G + j]));
    m = warp_max(m);
    if (lane == 0) scores[gi] = m;
  }
  __syncthreads();

  // 3. survivors in ascending order, first `cap` kept
  if (warp == 0) {
    const float t = *a.thr;
    int c = 0;
    for (int base = 0; base < nb; base += 32) {
      const int i = base + lane;
      const bool s = i < nb && scores[i] > t;
      const unsigned m = __ballot_sync(0xffffffffu, s);
      const int r = c + __popc(m & ((1u << lane) - 1u));
      if (s && r < a.cap) idx[r] = i;
      c += __popc(m);
    }
    if (lane == 0) *cnt = min(c, a.cap);
  }
  __syncthreads();
  const int count = *cnt;
  if (blockIdx.x == 0) {
    for (int j = tid; j < a.cap; j += THREADS)
      a.idx_out[j] = j < count ? idx[j] : -1;
    if (tid == 0) *a.count_out = count;
  }

  // 4. gather the kept rows of this block's column tile
  const int c0 = blockIdx.x * TILE;
  const T* W[NW];
  int N;
  if (PAIR) {
    N = a.n[0];
    const size_t base = static_cast<size_t>(a.layer) * K * N + c0;
    W[0] = static_cast<const T*>(a.w[0]) + base;
    if (NW > 1) W[NW - 1] = static_cast<const T*>(a.w[1]) + base;
  } else {
    int wi = 0, off = c0;
    while (off >= a.n[wi]) off -= a.n[wi++];
    N = a.n[wi];
    W[0] = static_cast<const T*>(a.w[wi]) +
           static_cast<size_t>(a.layer) * K * N + off;
  }
  const int sub = lane % S::LPR;
  const int slot = warp * S::RPW + lane / S::LPR;
  float acc[NW][S::VEC];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int e = 0; e < S::VEC; ++e) acc[w][e] = 0.f;
  const int R = count * G;
#pragma unroll 4
  for (int r = slot; r < R; r += S::SLOTS) {
    const int k = idx[r / G] * G + (r % G);
    const float xv = xs[k];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          W[w] + static_cast<size_t>(k) * N + sub * S::VEC));
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < S::VEC; ++e)
        acc[w][e] = fmaf(xv, to_f(v[e]), acc[w][e]);
    }
  }
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int e = 0; e < S::VEC; ++e)
      red[slot * NW * TILE + w * TILE + sub * S::VEC + e] = acc[w][e];
  __syncthreads();

  // 5. fixed-order sum over slots, then the epilogue
  if (tid < NW * TILE) {
    float s = 0.f;
    for (int sl = 0; sl < S::SLOTS; ++sl) s += red[sl * NW * TILE + tid];
    fin[tid] = s;
  }
  __syncthreads();
  if (tid < TILE) {
    const int col = c0 + tid;
    if (a.mode == 0) {
      static_cast<float*>(a.out)[col] = fin[tid];
    } else if (a.mode == 1) {
      const float r = to_f(static_cast<const T*>(a.res)[col]);
      static_cast<T*>(a.out)[col] = from_f<T>(fin[tid] + r);
    } else {
      const float g = fin[tid], u = fin[NW * TILE - TILE + tid];
      static_cast<T*>(a.out)[col] =
          from_f<T>(g * (1.0f / (1.0f + expf(-g))) * u);
    }
  }
}

template <typename T, bool PAIR, int G>
int launch(const Args& a, int blocks, cudaStream_t stream) {
  constexpr int NW = PAIR ? 2 : 1;
  const size_t smem =
      sizeof(float) * (a.K + Shape<T>::SLOTS * NW * TILE + a.K / G + 32 +
                       NW * TILE) +
      sizeof(int) * (a.cap + 1);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(sgg_kernel<T, PAIR, G>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  sgg_kernel<T, PAIR, G><<<blocks, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int dispatch(int dtype, const Args& a, int blocks, cudaStream_t s) {
  const bool pair = a.mode == 2;
  if (dtype == 0)
    return pair ? launch<float, true, G>(a, blocks, s)
                : launch<float, false, G>(a, blocks, s);
  return pair ? launch<__nv_bfloat16, true, G>(a, blocks, s)
              : launch<__nv_bfloat16, false, G>(a, blocks, s);
}

}  // namespace

// dtype: 0 fp32, 1 bf16. mode: 0 raw fp32 out, 1 residual, 2 silu pair.
// G: 32, 64 or 128 (else cudaErrorInvalidValue). The caller checks
// shapes: K % G == 0, every n_i % 32 == 0, pointers 16-byte aligned,
// mode 2 with two weights of equal width.
extern "C" int teal_select_gather_gemv(
    int dtype, const void* x, const void* thr, const void* norm, float eps,
    const void* w0, const void* w1, const void* w2, int n0, int n1, int n2,
    int n_w, const void* res, void* out, void* idx, void* count, int K,
    int G, int layer, int cap, int mode, void* stream) {
  cudaGetLastError();  // clear any stale error of this library
  Args a;
  a.x = x;
  a.thr = static_cast<const float*>(thr);
  a.norm = norm;
  a.eps = eps;
  a.w[0] = w0;
  a.w[1] = w1;
  a.w[2] = w2;
  a.n[0] = n0;
  a.n[1] = n_w > 1 ? n1 : 0;
  a.n[2] = n_w > 2 ? n2 : 0;
  a.n_w = n_w;
  a.res = res;
  a.out = out;
  a.idx_out = static_cast<int*>(idx);
  a.count_out = static_cast<int*>(count);
  a.K = K;
  a.layer = layer;
  a.cap = cap;
  a.mode = mode;
  const int n_out = mode == 2 ? n0 : a.n[0] + a.n[1] + a.n[2];
  const int blocks = n_out / TILE;
  auto s = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 32: return dispatch<32>(dtype, a, blocks, s);
    case 64: return dispatch<64>(dtype, a, blocks, s);
    case 128: return dispatch<128>(dtype, a, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
