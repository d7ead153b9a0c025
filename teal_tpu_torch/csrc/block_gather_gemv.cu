// K3: gather GEMV over a kept-group list chosen outside the kernel, for
// 1-8 input rows sharing one selection.
//
// Replaces the Pallas kernel `_manual_gather_kernel`
// (teal_tpu/ops/block_gemv.py:262), launched by `block_gather_gemv_multi`
// (block_gemv.py:354): top-k block-sparse decode and batched decode
// (rows <= 8) with one pooled selection. It computes, for each of 1-3
// layer-stacked weights W_i [L, K, N_i] and each input row b < rows,
//   out[b, off_i + n] = sum over slots j < k_keep, l < G of
//                       xpack[j, b, l] * W_i[layer, idx[j] * G + l, n]
// with fp32 sums, into one fp32 [rows, sum N_i] output.
//
// What bounds it on the H100: bytes. Per call it reads k_keep * G rows of
// each weight (bf16: 50 MB for the 7B q|k|v stage at keep 0.5, 90 MB for
// gate|up), and the input rows ride along: 2 * rows flops per weight
// element read is far below the ~295 flops a byte of the tensor cores.
// So the design aims at keeping loads in flight on every SM, and extra
// rows cost registers, not bytes.
//
// Design. Each block owns a tile of 32 output columns of one weight
// (N_out / 32 blocks: 384 for q|k|v at 7B, 688 for gate|up), so no block
// needs another's result: no atomics, no split-K. The gathered rows are
// split over 64 row slots (bf16; 32 for fp32): each thread loads 16 bytes
// of one kept row of the tile and multiplies them by every input row's
// value of that row, kept in `rows` x 8 fp32 accumulators. The input
// values come from xpack through the L1 cache (all blocks read the same
// few kilobytes). Group size G and the row count are template parameters
// (G in {32, 64, 128}; 1 or 8 rows), so the row split is shifts and the
// accumulators stay in registers. Partial sums are added in a fixed order
// (a warp butterfly, then warps in order), so results do not depend on
// scheduling. Kept-group indices are clamped to [0, K / G): a bad index
// reads a wrong slab, never outside W.
#include "common.cuh"

using namespace teal;

namespace {

constexpr int TILE = 32;     // output columns per block
constexpr int THREADS = 256;
constexpr int LANES = 128;   // xpack's row width

struct Args {
  const int* idx;            // [k_keep] kept groups
  const void* xpack;         // [k_keep, R, 128] input rows, lanes [:G]
  const void* w[3];          // [L, K, n_i] each
  int n[3];
  float* out;                // fp32 [rows, n_tot]
  int n_tot, K, layer, k_keep, rows;
};

template <typename T, int G, int R>
__global__ void __launch_bounds__(THREADS) bgg_kernel(Args a) {
  using S = GatherShape<T, TILE, THREADS>;
  __shared__ float red[(THREADS / 32) * R * TILE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * TILE;
  int wi = 0, off = c0;
  while (off >= a.n[wi]) off -= a.n[wi++];
  const int N = a.n[wi];
  const T* W = static_cast<const T*>(a.w[wi]) +
               static_cast<size_t>(a.layer) * a.K * N + off;
  const T* xp = static_cast<const T*>(a.xpack);
  const int nb = a.K / G;
  const int sub = lane % S::LPR;
  const int slot = warp * S::RPW + lane / S::LPR;

  float acc[R][S::VEC];
#pragma unroll
  for (int b = 0; b < R; ++b)
#pragma unroll
    for (int e = 0; e < S::VEC; ++e) acc[b][e] = 0.f;
  const int n_rows = a.k_keep * G;
#pragma unroll 4
  for (int r = slot; r < n_rows; r += S::SLOTS) {
    const int j = r / G, l = r % G;
    const int g = min(max(__ldg(a.idx + j), 0), nb - 1);
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
        W + static_cast<size_t>(g * G + l) * N + sub * S::VEC));
    const T* v = reinterpret_cast<const T*>(&raw);
    const T* xr = xp + static_cast<size_t>(j) * R * LANES + l;
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const float xv = to_f(xr[b * LANES]);
#pragma unroll
      for (int e = 0; e < S::VEC; ++e)
        acc[b][e] = fmaf(xv, to_f(v[e]), acc[b][e]);
    }
  }
  warp_partials<S, TILE>(acc, red);
  __syncthreads();
  if (tid < R * TILE) {
    const int b = tid / TILE, c = tid % TILE;
    float s = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) s += red[(w * R + b) * TILE + c];
    if (b < a.rows) a.out[static_cast<size_t>(b) * a.n_tot + c0 + c] = s;
  }
}

template <typename T, int G>
int launch(const Args& a, int R, cudaStream_t s) {
  const int blocks = a.n_tot / TILE;
  if (R == 1)
    bgg_kernel<T, G, 1><<<blocks, THREADS, 0, s>>>(a);
  else
    bgg_kernel<T, G, 8><<<blocks, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int G, int R, cudaStream_t s) {
  switch (G) {
    case 32: return launch<T, 32>(a, R, s);
    case 64: return launch<T, 64>(a, R, s);
    case 128: return launch<T, 128>(a, R, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (xpack and weights). G: 32, 64 or 128; R: xpack's
// rows, 1 or 8 (else cudaErrorInvalidValue); rows <= R. The caller checks
// shapes: K % G == 0, every n_i % 32 == 0, pointers 16-byte aligned.
extern "C" int teal_block_gather_gemv(
    int dtype, const void* idx, const void* xpack, const void* w0,
    const void* w1, const void* w2, int n0, int n1, int n2, int n_w,
    void* out, int K, int G, int layer, int k_keep, int R, int rows,
    void* stream) {
  cudaGetLastError();  // clear any stale error of this library
  if ((R != 1 && R != 8) || rows < 1 || rows > R)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.idx = static_cast<const int*>(idx);
  a.xpack = xpack;
  a.w[0] = w0;
  a.w[1] = w1;
  a.w[2] = w2;
  a.n[0] = n0;
  a.n[1] = n_w > 1 ? n1 : 0;
  a.n[2] = n_w > 2 ? n2 : 0;
  a.out = static_cast<float*>(out);
  a.n_tot = a.n[0] + a.n[1] + a.n[2];
  a.K = K;
  a.layer = layer;
  a.k_keep = k_keep;
  a.rows = rows;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(a, G, R, s)
                    : dispatch<__nv_bfloat16>(a, G, R, s);
}
