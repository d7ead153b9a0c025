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
// with fp32 sums, into one fp32 [rows, sum N_i] output. The weights share
// one plan (`common.cuh`): the stream type; int8, converted in the kernel
// (its per-channel scale is applied by the caller, as the reference's
// `int8_block_gather_gemv` and `project_many` do); or packed int4 at
// G >= 64, where each kept group adds (x_g @ nib_g) * scale_g +
// sum(x_g) * zero_g (`_accumulate`, block_gemv.py:201).
//
// What bounds it on the H100: bytes. Per call it reads k_keep * G rows of
// each weight (bf16: 50 MB for the 7B q|k|v stage at keep 0.5, 90 MB for
// gate|up; half that in int8, a quarter plus the sz rows in int4), and
// the input rows ride along: 2 * rows flops per weight
// element read is far below the ~295 flops a byte of the tensor cores.
// So the design aims at keeping loads in flight on every SM, and extra
// rows cost registers, not bytes.
//
// Design. Each block owns a tile of 32 output columns of one weight
// (N_out / 32 blocks: 384 for q|k|v at 7B, 688 for gate|up), so no block
// needs another's result: no atomics, no split-K. The gathered rows are
// split over 64 row slots (bf16; 32 for fp32, 128 for int8): each thread
// loads 16 bytes of one kept row of the tile and multiplies them by every
// input row's value of that row, kept in `rows` x 8 (int8: x 16) fp32
// accumulators. Packed int4 needs each group's sum before its scale, so
// there a warp owns a kept group at a time: each thread loads 8 bytes
// (8 columns x 2 rows) of G/16 packed rows, sums x * nibble and x per
// input row over them, then adds partial * scale_g + sum(x) * zero_g. The input
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
  const void* w[3];          // [L, K, n_i] each (int4: [L, K/2, n_i])
  const float* sz[3];        // int4: [L, K/G, 2, n_i] (scale, zero)
  int n[3];
  float* out;                // fp32 [rows, n_tot]
  int n_tot, K, layer, k_keep, rows;
};

// element type of a 16-byte row load
template <typename T, int P> struct Elem { using type = T; };
template <typename T> struct Elem<T, PLAN_INT8> { using type = int8_t; };

template <typename T, int P, int G, int R>
__global__ void __launch_bounds__(THREADS) bgg_kernel(Args a) {
  using S = PlanShape<T, P, TILE, THREADS>;
  using E = typename Elem<T, P>::type;
  __shared__ float red[(THREADS / 32) * R * TILE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * TILE;
  int wi = 0, off = c0;
  while (off >= a.n[wi]) off -= a.n[wi++];
  const int N = a.n[wi];
  const T* xp = static_cast<const T*>(a.xpack);
  const int nb = a.K / G;
  const int sub = lane % S::LPR;
  const int rl = lane / S::LPR;
  const int slot = warp * S::RPW + rl;

  float acc[R][S::VEC];
#pragma unroll
  for (int b = 0; b < R; ++b)
#pragma unroll
    for (int e = 0; e < S::VEC; ++e) acc[b][e] = 0.f;
  if constexpr (P == PLAN_INT4) {
    constexpr int HALF = G / 2;                 // packed rows a group
    const int8_t* Q = static_cast<const int8_t*>(a.w[wi]) +
                      static_cast<size_t>(a.layer) * (a.K / 2) * N + off +
                      sub * 8;
    const float* SZ = a.sz[wi] + static_cast<size_t>(a.layer) * nb * 2 * N +
                      off + sub * 8;
    for (int j = warp; j < a.k_keep; j += THREADS / 32) {
      const int g = min(max(__ldg(a.idx + j), 0), nb - 1);
      const T* xr = xp + static_cast<size_t>(j) * R * LANES;
      float p[R][8], sx[R];
#pragma unroll
      for (int b = 0; b < R; ++b) {
        sx[b] = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) p[b][e] = 0.f;
      }
#pragma unroll 2
      for (int i = rl; i < HALF; i += S::RPW) {
        float lo[8], hi[8];
        load_nibbles(Q + static_cast<size_t>(g * HALF + i) * N, lo, hi);
#pragma unroll
        for (int b = 0; b < R; ++b) {
          const float xlo = to_f(xr[b * LANES + i]);
          const float xhi = to_f(xr[b * LANES + HALF + i]);
          sx[b] += xlo + xhi;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            p[b][e] = fmaf(xhi, hi[e], fmaf(xlo, lo[e], p[b][e]));
        }
      }
      float sc[8], zr[8];
      load8(SZ + static_cast<size_t>(g) * 2 * N, sc);
      load8(SZ + static_cast<size_t>(g) * 2 * N + N, zr);
#pragma unroll
      for (int b = 0; b < R; ++b)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[b][e] = fmaf(p[b][e], sc[e], fmaf(sx[b], zr[e], acc[b][e]));
    }
  } else {
    const E* W = static_cast<const E*>(a.w[wi]) +
                 static_cast<size_t>(a.layer) * a.K * N + off + sub * S::VEC;
    const int n_rows = a.k_keep * G;
#pragma unroll 4
    for (int r = slot; r < n_rows; r += S::SLOTS) {
      const int j = r / G, l = r % G;
      const int g = min(max(__ldg(a.idx + j), 0), nb - 1);
      float v[S::VEC];
      load_row<E, S::VEC>(W + static_cast<size_t>(g * G + l) * N, v);
      const T* xr = xp + static_cast<size_t>(j) * R * LANES + l;
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const float xv = to_f(xr[b * LANES]);
#pragma unroll
        for (int e = 0; e < S::VEC; ++e) acc[b][e] = fmaf(xv, v[e], acc[b][e]);
      }
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

template <typename T, int P, int G>
int launch(const Args& a, int R, cudaStream_t s) {
  const int blocks = a.n_tot / TILE;
  if (R == 1)
    bgg_kernel<T, P, G, 1><<<blocks, THREADS, 0, s>>>(a);
  else
    bgg_kernel<T, P, G, 8><<<blocks, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int dispatch_plan(int plan, const Args& a, int R, cudaStream_t s) {
  switch (plan) {
    case PLAN_STREAM: return launch<T, PLAN_STREAM, G>(a, R, s);
    case PLAN_INT8: return launch<T, PLAN_INT8, G>(a, R, s);
    case PLAN_INT4:
      if constexpr (G >= 64)
        return launch<T, PLAN_INT4, G>(a, R, s);
      else
        return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int plan, const Args& a, int G, int R, cudaStream_t s) {
  switch (G) {
    case 32: return dispatch_plan<T, 32>(plan, a, R, s);
    case 64: return dispatch_plan<T, 64>(plan, a, R, s);
    case 128: return dispatch_plan<T, 128>(plan, a, R, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (xpack). plan: 0 weights of xpack's type, 1 int8,
// 2 packed int4 (w_i the packed rows, sz_i their [scale, zero] rows; G 64
// or 128). G: 32, 64 or 128; R: xpack's rows, 1 or 8 (else
// cudaErrorInvalidValue); rows <= R. The caller checks shapes: K % G ==
// 0, every n_i % 32 == 0, pointers 16-byte aligned, one plan for all
// weights.
extern "C" int teal_block_gather_gemv(
    int dtype, int plan, const void* idx, const void* xpack, const void* w0,
    const void* w1, const void* w2, const void* sz0, const void* sz1,
    const void* sz2, int n0, int n1, int n2, int n_w, void* out, int K,
    int G, int layer, int k_keep, int R, int rows, void* stream) {
  cudaGetLastError();  // clear any stale error of this library
  if ((R != 1 && R != 8) || rows < 1 || rows > R)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.idx = static_cast<const int*>(idx);
  a.xpack = xpack;
  const void* w[3] = {w0, w1, w2};
  const void* sz[3] = {sz0, sz1, sz2};
  for (int i = 0; i < 3; ++i) {
    a.w[i] = w[i];
    a.sz[i] = static_cast<const float*>(sz[i]);
  }
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
  return dtype == 0 ? dispatch<float>(plan, a, G, R, s)
                    : dispatch<__nv_bfloat16>(plan, a, G, R, s);
}
