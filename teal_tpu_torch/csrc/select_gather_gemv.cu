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
//      over 1-3 layer-stacked weights [L, K, N_i] sharing one selection
//      and one weight plan (`common.cuh`): the stream type, int8, or
//      packed int4 at G >= 64, where each kept group adds
//      (x_g @ nib_g) * scale_g + sum(x_g) * zero_g;
//   5. an epilogue: int8's per-channel scale on the fp32 sums where the
//      caller passes it (the whole-token kernel's `scale_ref`,
//      token_block.py:55, applied before RoPE in attn_block.py:218), then
//      raw fp32 (q|k|v), + residual then cast (o, down), silu(gate) * up
//      then cast (gate|up: mode 2, two weights), or the MoE expert's
//      weighted residual w[slot] * sums + residual then cast (mode 3, the
//      MoE branch's `write_down_weighted`, token_block.py:302).
//
// MoE (the whole-token kernel's expert stages, token_block.py:274-324):
// the expert stacks [L, E, K, N] are read as [L*E, K, N], expert e of
// layer l being pseudo-layer l*E + e. The layer may then come from the
// device: each block reads layer_dev[slot] (the router kernel K5's
// output) at its start, so the host never waits for the routing, and
// traps on a value outside [0, L) as K2 traps on a bad position. Every
// weight and scale offset is 64-bit: one int8 expert stack of Mixtral is
// 15 GB.
//
// What bounds it on the H100: bytes. Per call it reads cap * 128 rows of
// each weight (bf16: 16 MB for the 7B o stage at cap 16, 90 MB for
// gate|up; half that in int8, a quarter plus the sz rows in int4),
// against 2 * rows * N flops, so HBM bandwidth (3.35 TB/s) is the
// roofline and the kernel should keep enough loads in flight on every SM.
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
// each thread loads 16 bytes (8 bf16 or 16 int8 columns) of one kept
// row; a warp covers 8 rows (bf16; 16 int8) of the tile per instruction
// and the 8 warps 64 (128) rows, unrolled 4 deep. Packed int4 needs each
// group's sum before its scale, so there a warp owns a kept group at a
// time: each thread loads 8 bytes (8 columns x 2 rows) of G/16 packed
// rows of the group, sums x * nibble and x over them, and adds
// partial * scale_g + sum(x) * zero_g to its accumulators. The per-slot
// partial sums of each column are added in slot order through shared
// memory, so the result does not depend on scheduling.
//
// Rows form (B = 2..16 input rows at G = 128, the batched whole-token
// kernel's `_proj_stage` with `batch` rows, token_block.py:343): one
// kept set for all rows, picked by each group's max |x| over lanes and
// rows (`_select_scan`, block_gemv.py:456); the folded norm is per row.
// It reads the kept slabs once for all B rows, so it is bound by the
// same bytes as one row plus B rows of x. Holding B rows of a K-long
// input in shared memory does not fit (B * K * 4 bytes: 704 KB for the
// 7B down stage), and B accumulators of the row-slot layout do not fit
// in registers, so the design differs from the one-row kernel:
//   - the prologue reads x from global memory (L2): per-row norm scales
//     (a warp per row), then the pooled group scores (a warp per group);
//   - the gather streams one kept group at a time through a ring of
//     RSTAGES shared-memory stages: cp.async copies of the group's
//     [128, TILE] slab of each weight (packed int4: [64, TILE] bytes and
//     its [scale, zero] rows), and the group's selected inputs for all
//     16 rows as fp32 [128][16], loaded into registers before the
//     previous stage's arithmetic and stored after it;
//   - each warp owns 16 of a group's 128 rows (int4: 8 packed rows); a
//     lane owns 4 rows x 4 columns of every weight and adds row by row,
//     so one 16-byte load of inputs and one load of 4 weights feed 16
//     FMAs. Per-warp partial sums go through shared memory and are added
//     in warp order before the epilogue: deterministic, no atomics.
// `fixed` (both forms) skips scoring and keeps groups 0..cap-1.
#include "common.cuh"

using namespace teal;

namespace {

constexpr int TILE = 32;     // output columns per block
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;

struct Args {
  const void* x;
  const float* thr;
  const void* norm;          // [L, K] gains, or null
  float eps;
  const void* w[3];          // [L, K, n_i] (int4: packed [L, K/2, n_i])
  const float* sz[3];        // int4: [L, K/G, 2, n_i] (scale, zero)
  const float* scale[3];     // int8: [L, n_i] per-channel scales, or null
  int n[3];
  int n_w;
  const void* res;           // [N_out] residual (mode 1)
  void* out;                 // fp32 [N_tot] (mode 0) or T [N_out]
  int* idx_out;              // [cap] kept groups, -1 past the count
  int* count_out;            // [1]
  int K, layer, cap, mode;
  const int* layer_dev;      // device layers (MoE pseudo-layers), or null
  int slot;                  // this call's entry of layer_dev and route_w
  int L;                     // layers of the weight stacks
  const float* route_w;      // mode 3: fp32 routing weights
  int B;                     // input rows (rows form when > 1)
  int fixed;                 // keep groups 0..cap-1, no scores
  int n_out;                 // output columns of a row
};

template <typename T, int P>
using Shape = PlanShape<T, P, TILE, THREADS>;

// The layer this call reads: the host's, or layer_dev[slot] read on the
// device. A value outside [0, L) traps rather than read out of bounds.
__device__ __forceinline__ size_t read_layer(const Args& a) {
  const int l = a.layer_dev != nullptr ? a.layer_dev[a.slot] : a.layer;
  if (l < 0 || l >= a.L) __trap();
  return static_cast<size_t>(l);
}

// THE selection rule on the group scores (or groups 0..cap-1 with
// `fixed`): a warp ballot + popcount prefix over the groups, 32 a step,
// keeps exactly the groups the serial scan keeps. Fills idx [cap] and
// *cnt in shared memory, block 0 writes them out; returns the count.
__device__ int select_scan(const Args& a, const float* scores, int nb,
                           int* idx, int* cnt) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == 0) {
    if (a.fixed) {
      for (int j = lane; j < a.cap; j += 32) idx[j] = j;
      if (lane == 0) *cnt = a.cap;
    } else {
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
  }
  __syncthreads();
  const int count = *cnt;
  if (blockIdx.x == 0) {
    for (int j = tid; j < a.cap; j += THREADS)
      a.idx_out[j] = j < count ? idx[j] : -1;
    if (tid == 0) *a.count_out = count;
  }
  return count;
}

// The block's output tile: the weights it reads (wsel, 1 or 2) and the
// tile's first column within them (off) and their width (N).
template <int NW>
__device__ __forceinline__ void tile_weights(const Args& a, int c0,
                                             int (&wsel)[NW], int& off,
                                             int& N) {
  off = c0;
  if (NW == 2) {
    N = a.n[0];
    wsel[0] = 0;
    wsel[NW - 1] = 1;
  } else {
    int wi = 0;
    while (off >= a.n[wi]) off -= a.n[wi++];
    N = a.n[wi];
    wsel[0] = wi;
  }
}

// element type of a 16-byte row load
template <typename T, int P> struct Elem { using type = T; };
template <typename T> struct Elem<T, PLAN_INT8> { using type = int8_t; };

template <typename T, int P, bool PAIR, int G>
__global__ void __launch_bounds__(THREADS) sgg_kernel(Args a) {
  using S = Shape<T, P>;
  using E = typename Elem<T, P>::type;
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
  const size_t layer = read_layer(a);

  // 1. input, with the optional folded rms_norm
  if (a.norm != nullptr) {
    float ss = 0.f;
    for (int k = tid; k < K; k += THREADS) {
      const float v = to_f(x[k]);
      ss = fmaf(v, v, ss);
    }
    ss = block_sum(ss, scratch);
    const float scale = 1.0f / sqrtf(ss / static_cast<float>(K) + a.eps);
    const T* g = static_cast<const T*>(a.norm) + layer * K;
    for (int k = tid; k < K; k += THREADS)
      xs[k] = rnd<T>(rnd<T>(to_f(x[k]) * scale) * to_f(g[k]));
  } else {
    for (int k = tid; k < K; k += THREADS) xs[k] = to_f(x[k]);
  }
  __syncthreads();

  // 2. group scores
  for (int gi = a.fixed ? nb : warp; gi < nb; gi += NWARPS) {
    float m = 0.f;
    for (int j = lane; j < G; j += 32) m = fmaxf(m, fabsf(xs[gi * G + j]));
    m = warp_max(m);
    if (lane == 0) scores[gi] = m;
  }
  __syncthreads();

  // 3. survivors in ascending order, first `cap` kept
  const int count = select_scan(a, scores, nb, idx, cnt);

  // 4. gather the kept rows of this block's column tile
  const int c0 = blockIdx.x * TILE;
  int wsel[NW];                 // the weights this block reads
  int off, N;                   // the tile's first column within them
  tile_weights<NW>(a, c0, wsel, off, N);
  const int sub = lane % S::LPR;
  const int slot = warp * S::RPW + lane / S::LPR;
  float acc[NW][S::VEC];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int e = 0; e < S::VEC; ++e) acc[w][e] = 0.f;
  if constexpr (P == PLAN_INT4) {
    constexpr int HALF = G / 2;                 // packed rows a group
    const int rl = lane / S::LPR;
    const int8_t* Q[NW];
    const float* SZ[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      Q[w] = static_cast<const int8_t*>(a.w[wsel[w]]) +
             layer * (K / 2) * N + off + sub * 8;
      SZ[w] = a.sz[wsel[w]] + layer * nb * 2 * N + off + sub * 8;
    }
    for (int j = warp; j < count; j += NWARPS) {
      const int g = idx[j];
      const float* xg = xs + g * G;
      float p[NW][8], sx = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int e = 0; e < 8; ++e) p[w][e] = 0.f;
#pragma unroll 4
      for (int i = rl; i < HALF; i += S::RPW) {
        const float xlo = xg[i], xhi = xg[HALF + i];
        sx += xlo + xhi;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          float lo[8], hi[8];
          load_nibbles(Q[w] + static_cast<size_t>(g * HALF + i) * N, lo, hi);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            p[w][e] = fmaf(xhi, hi[e], fmaf(xlo, lo[e], p[w][e]));
        }
      }
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        float sc[8], zr[8];
        load8(SZ[w] + static_cast<size_t>(g) * 2 * N, sc);
        load8(SZ[w] + static_cast<size_t>(g) * 2 * N + N, zr);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[w][e] = fmaf(p[w][e], sc[e], fmaf(sx, zr[e], acc[w][e]));
      }
    }
  } else {
    const E* W[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w)
      W[w] = static_cast<const E*>(a.w[wsel[w]]) + layer * K * N + off +
             sub * S::VEC;
    const int R = count * G;
#pragma unroll 4
    for (int r = slot; r < R; r += S::SLOTS) {
      const int k = idx[r / G] * G + (r % G);
      const float xv = xs[k];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        float v[S::VEC];
        load_row<E, S::VEC>(W[w] + static_cast<size_t>(k) * N, v);
#pragma unroll
        for (int e = 0; e < S::VEC; ++e) acc[w][e] = fmaf(xv, v[e], acc[w][e]);
      }
    }
  }
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int e = 0; e < S::VEC; ++e)
      red[slot * NW * TILE + w * TILE + sub * S::VEC + e] = acc[w][e];
  __syncthreads();

  // 5. fixed-order sum over slots, the int8 scale, then the epilogue
  if (tid < NW * TILE) {
    float s = 0.f;
    for (int sl = 0; sl < S::SLOTS; ++sl) s += red[sl * NW * TILE + tid];
    const float* sc = a.scale[wsel[tid / TILE]];
    if (sc != nullptr) s *= sc[layer * N + off + tid % TILE];
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
    } else if (a.mode == 3) {
      // (scaled sums * w) + residual, two roundings as in the reference
      const float r = to_f(static_cast<const T*>(a.res)[col]);
      static_cast<T*>(a.out)[col] =
          from_f<T>(__fadd_rn(__fmul_rn(fin[tid], a.route_w[a.slot]), r));
    } else {
      const float g = fin[tid], u = fin[NW * TILE - TILE + tid];
      static_cast<T*>(a.out)[col] =
          from_f<T>(g * (1.0f / (1.0f + expf(-g))) * u);
    }
  }
}

// --- rows form --------------------------------------------------------

constexpr int RG = 128;        // the rows form's group size
constexpr int MAXB = 16;       // input rows
constexpr int RSTAGES = 3;     // kept groups in flight

// One kept group's slab of one weight in shared memory: RROWS rows of
// TILE columns (packed int4: G/2 rows of TILE bytes, then its scale and
// zero rows, TILE fp32 each).
template <typename T, int P>
struct RowsTile {
  static constexpr int RROWS = P == PLAN_INT4 ? RG / 2 : RG;
  static constexpr int ROW_BYTES =
      TILE * (P == PLAN_STREAM ? static_cast<int>(sizeof(T)) : 1);
  static constexpr int SZ_BYTES = P == PLAN_INT4 ? 2 * TILE * 4 : 0;
  static constexpr int BYTES = RROWS * ROW_BYTES + SZ_BYTES;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 4 consecutive weights of element type E from shared memory, as fp32
__device__ __forceinline__ void load4s(const unsigned char* p,
                                       float (&v)[4], float) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void load4s(const unsigned char* p,
                                       float (&v)[4], __nv_bfloat16) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = to_f(e[i]);
}
__device__ __forceinline__ void load4s(const unsigned char* p,
                                       float (&v)[4], int8_t) {
  const int r = *reinterpret_cast<const int*>(p);
  const int8_t* e = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = static_cast<float>(e[i]);
}

template <typename T, int P, bool PAIR>
__global__ void __launch_bounds__(THREADS) sgg_rows_kernel(Args a) {
  using E = typename Elem<T, P>::type;
  using TL = RowsTile<T, P>;
  constexpr int NW = PAIR ? 2 : 1;
  constexpr int ESZ = P == PLAN_STREAM ? static_cast<int>(sizeof(T)) : 1;
  extern __shared__ __align__(16) unsigned char sraw[];
  const int K = a.K, nb = K / RG, B = a.B;
  unsigned char* wbuf = sraw;                      // [RSTAGES][NW] tiles
  float* xbuf = reinterpret_cast<float*>(wbuf + RSTAGES * NW * TL::BYTES);
  float* red = xbuf + RSTAGES * RG * MAXB;         // [NWARPS][MAXB][NW*TILE]
  float* scores = red + NWARPS * MAXB * NW * TILE;  // [nb]
  float* rscale = scores + nb;                     // [MAXB]
  int* idx = reinterpret_cast<int*>(rscale + MAXB);  // [cap]
  int* cnt = idx + a.cap;                          // [1]
  const T* x = static_cast<const T*>(a.x);
  const size_t layer = read_layer(a);
  const T* gain = a.norm == nullptr
                      ? nullptr
                      : static_cast<const T*>(a.norm) + layer * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. per-row norm scale: a warp per row, fixed order
  if (gain != nullptr) {
    for (int b = warp; b < B; b += NWARPS) {
      const T* xb = x + static_cast<size_t>(b) * K;
      float ss = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float v = to_f(xb[k]);
        ss = fmaf(v, v, ss);
      }
      ss = warp_sum(ss);
      if (lane == 0) rscale[b] = 1.0f / sqrtf(ss / static_cast<float>(K) +
                                              a.eps);
    }
  }
  __syncthreads();
  // the selection input of row b at k, from the raw value and the gain
  auto sel = [&](int b, float v, float g) {
    return gain == nullptr ? v : rnd<T>(rnd<T>(v * rscale[b]) * g);
  };

  // 2. pooled group scores: max over lanes and rows
  for (int gi = a.fixed ? nb : warp; gi < nb; gi += NWARPS) {
    float m = 0.f;
    for (int j = lane; j < RG; j += 32) {
      const int k = gi * RG + j;
      const float g = gain == nullptr ? 1.f : to_f(gain[k]);
      for (int b = 0; b < B; ++b)
        m = fmaxf(m, fabsf(sel(b, to_f(x[static_cast<size_t>(b) * K + k]),
                               g)));
    }
    m = warp_max(m);
    if (lane == 0) scores[gi] = m;
  }
  __syncthreads();

  // 3. one kept set for all rows
  const int count = select_scan(a, scores, nb, idx, cnt);

  // 4. the gather, one kept group a stage
  const int c0 = blockIdx.x * TILE;
  int wsel[NW];
  int off, N;
  tile_weights<NW>(a, c0, wsel, off, N);
  const size_t krows = P == PLAN_INT4 ? K / 2 : K;   // stored rows a layer
  auto fetch = [&](int j) {
    if (j < count) {
      const int g = idx[j];
      unsigned char* st = wbuf + (j % RSTAGES) * NW * TL::BYTES;
      constexpr int CPR = TL::ROW_BYTES / 16;          // 16-byte chunks
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const unsigned char* src =
            static_cast<const unsigned char*>(a.w[wsel[w]]) +
            ((layer * krows + static_cast<size_t>(g) * TL::RROWS) * N +
             off) * ESZ;
        unsigned char* dst = st + w * TL::BYTES;
        for (int c = tid; c < TL::RROWS * CPR; c += THREADS)
          cp_async16(dst + c * 16, src + (static_cast<size_t>(c / CPR) * N *
                                          ESZ + (c % CPR) * 16));
        if constexpr (P == PLAN_INT4) {
          const float* sz =
              a.sz[wsel[w]] + (layer * nb + g) * 2 * N + off;
          if (tid < 2 * TILE / 4)
            cp_async16(dst + TL::RROWS * TL::ROW_BYTES + tid * 16,
                       sz + static_cast<size_t>(tid / (TILE / 4)) * N +
                           (tid % (TILE / 4)) * 4);
        }
      }
    }
    cp_async_commit();
  };
  // the group's selected inputs: thread t holds row b = t / 16 at 8
  // consecutive positions of the group
  const int xb_row = tid >> 4, xr0 = (tid & 15) * 8;
  float xv[8], gv[8];
  auto load_x = [&](int j) {
#pragma unroll
    for (int e = 0; e < 8; ++e) xv[e] = gv[e] = 0.f;
    if (j < count && xb_row < B) {
      const int k = idx[j] * RG + xr0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xv[e] = to_f(x[static_cast<size_t>(xb_row) * K + k + e]);
        if (gain != nullptr) gv[e] = to_f(gain[k + e]);
      }
    }
  };
  auto store_x = [&](int j) {
    float* xs = xbuf + (j % RSTAGES) * RG * MAXB;
    const bool live = j < count && xb_row < B;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      xs[(xr0 + e) * MAXB + xb_row] = live ? sel(xb_row, xv[e], gv[e]) : 0.f;
  };

  const int b4 = (lane >> 3) * 4;      // this lane's rows b4 .. b4+3
  const int c4 = (lane & 7) * 4;       // and columns c4 .. c4+3
  float acc[NW][4][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[w][i][e] = 0.f;
  auto compute = [&](int j) {
    const float* xs = xbuf + (j % RSTAGES) * RG * MAXB;
    const unsigned char* st = wbuf + (j % RSTAGES) * NW * TL::BYTES;
    if constexpr (P == PLAN_INT4) {
      constexpr int PR = RG / 2 / NWARPS;           // packed rows a warp
      float p[NW][4][4], sx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[w][i][e] = 0.f;
#pragma unroll
      for (int r = 0; r < PR; ++r) {
        const int pr = warp * PR + r;
        const float4 lo4 =
            *reinterpret_cast<const float4*>(xs + pr * MAXB + b4);
        const float4 hi4 = *reinterpret_cast<const float4*>(
            xs + (pr + RG / 2) * MAXB + b4);
        const float xlo[4] = {lo4.x, lo4.y, lo4.z, lo4.w};
        const float xhi[4] = {hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) sx[i] += xlo[i] + xhi[i];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const unsigned q = *reinterpret_cast<const unsigned*>(
              st + w * TL::BYTES + pr * TL::ROW_BYTES + c4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float nlo = static_cast<float>((q >> (8 * e)) & 15u);
            const float nhi = static_cast<float>((q >> (8 * e + 4)) & 15u);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              p[w][i][e] = fmaf(xhi[i], nhi, fmaf(xlo[i], nlo, p[w][i][e]));
          }
        }
      }
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float* szr = reinterpret_cast<const float*>(
            st + w * TL::BYTES + TL::RROWS * TL::ROW_BYTES);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sc = szr[c4 + e], zr = szr[TILE + c4 + e];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[w][i][e] = fmaf(p[w][i][e], sc, fmaf(sx[i], zr, acc[w][i][e]));
        }
      }
    } else {
      constexpr int KR = RG / NWARPS;               // rows a warp
#pragma unroll 4
      for (int r = 0; r < KR; ++r) {
        const int row = warp * KR + r;
        const float4 x4 =
            *reinterpret_cast<const float4*>(xs + row * MAXB + b4);
        const float xr[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          float v[4];
          load4s(st + w * TL::BYTES + row * TL::ROW_BYTES + c4 * ESZ, v, E());
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[w][i][e] = fmaf(xr[i], v[e],
                                                            acc[w][i][e]);
        }
      }
    }
  };

  for (int j = 0; j < RSTAGES - 1; ++j) {
    fetch(j);
    load_x(j);
    store_x(j);
  }
  for (int j = 0; j < count; ++j) {
    cp_async_wait<RSTAGES - 2>();
    __syncthreads();       // stage j landed; stage j-1 is free again
    const int jn = j + RSTAGES - 1;
    fetch(jn);
    load_x(jn);            // in flight during the arithmetic
    compute(j);
    store_x(jn);
  }
  cp_async_wait<0>();

  // 5. fixed-order sum over warps, the int8 scale, then the epilogue
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * MAXB + b4 + i) * NW * TILE + w * TILE + c4 + e] =
            acc[w][i][e];
  __syncthreads();
  for (int o = tid; o < B * TILE; o += THREADS) {
    const int b = o / TILE, c = o % TILE, col = c0 + c;
    float f[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      float s = 0.f;
      for (int wp = 0; wp < NWARPS; ++wp)
        s += red[(wp * MAXB + b) * NW * TILE + w * TILE + c];
      const float* sc = a.scale[wsel[w]];
      if (sc != nullptr) s *= sc[layer * N + off + c];
      f[w] = s;
    }
    const size_t at = static_cast<size_t>(b) * a.n_out + col;
    if (a.mode == 0) {
      static_cast<float*>(a.out)[at] = f[0];
    } else if (a.mode == 1) {
      static_cast<T*>(a.out)[at] =
          from_f<T>(f[0] + to_f(static_cast<const T*>(a.res)[at]));
    } else {
      static_cast<T*>(a.out)[at] =
          from_f<T>(f[0] * (1.0f / (1.0f + expf(-f[0]))) * f[NW - 1]);
    }
  }
}

template <typename T, int P, bool PAIR>
int launch_rows(const Args& a, int blocks, cudaStream_t stream) {
  constexpr int NW = PAIR ? 2 : 1;
  const size_t smem =
      RSTAGES * NW * RowsTile<T, P>::BYTES +
      sizeof(float) * (RSTAGES * RG * MAXB + NWARPS * MAXB * NW * TILE +
                       a.K / RG + MAXB) +
      sizeof(int) * (a.cap + 1);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(sgg_rows_kernel<T, P, PAIR>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  sgg_rows_kernel<T, P, PAIR><<<blocks, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P, bool PAIR, int G>
int launch(const Args& a, int blocks, cudaStream_t stream) {
  if constexpr (G == RG) {
    if (a.B > 1) return launch_rows<T, P, PAIR>(a, blocks, stream);
  }
  constexpr int NW = PAIR ? 2 : 1;
  const size_t smem =
      sizeof(float) * (a.K + Shape<T, P>::SLOTS * NW * TILE + a.K / G + 32 +
                       NW * TILE) +
      sizeof(int) * (a.cap + 1);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(sgg_kernel<T, P, PAIR, G>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  sgg_kernel<T, P, PAIR, G><<<blocks, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P, int G>
int launch_mode(const Args& a, int blocks, cudaStream_t s) {
  return a.mode == 2 ? launch<T, P, true, G>(a, blocks, s)
                     : launch<T, P, false, G>(a, blocks, s);
}

template <typename T, int G>
int dispatch(int plan, const Args& a, int blocks, cudaStream_t s) {
  switch (plan) {
    case PLAN_STREAM: return launch_mode<T, PLAN_STREAM, G>(a, blocks, s);
    case PLAN_INT8: return launch_mode<T, PLAN_INT8, G>(a, blocks, s);
    case PLAN_INT4:
      if constexpr (G >= 64)
        return launch_mode<T, PLAN_INT4, G>(a, blocks, s);
      else
        return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int G>
int dispatch_type(int dtype, int plan, const Args& a, int blocks,
                  cudaStream_t s) {
  return dtype == 0 ? dispatch<float, G>(plan, a, blocks, s)
                    : dispatch<__nv_bfloat16, G>(plan, a, blocks, s);
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (the stream x, norm, res and the mode 1/2
// output). plan: 0 weights of the stream type, 1 int8, 2 packed int4
// (w_i the packed rows, sz_i their [scale, zero] rows; G 64 or 128).
// scale_i: int8 per-channel scales [L, n_i] applied to the sums, or
// null. mode: 0 raw fp32 out, 1 residual, 2 silu pair, 3 weighted
// residual (route_w[slot] * sums + res; one row). G: 32, 64 or 128 (else
// cudaErrorInvalidValue). rows: input rows B, contiguous [B, K]; out and
// res are [B, n_out]; rows > 1 needs G == 128 and rows <= 16. fixed: keep
// groups 0..cap-1. layer_dev: null (read `layer`) or int32 device layers,
// entry `slot` read by the kernel; L: the stacks' layers. The caller
// checks shapes: K % G == 0, every n_i % 32 == 0, pointers 16-byte
// aligned, mode 2 with two weights of equal width, one plan for all
// weights, a host layer in [0, L), no norm with a device layer.
extern "C" int teal_select_gather_gemv(
    int dtype, int plan, const void* x, const void* thr, const void* norm,
    float eps, const void* w0, const void* w1, const void* w2,
    const void* sz0, const void* sz1, const void* sz2, const void* sc0,
    const void* sc1, const void* sc2, int n0, int n1, int n2, int n_w,
    const void* res, void* out, void* idx, void* count, int K, int G,
    int layer, int cap, int mode, int rows, int fixed, const void* layer_dev,
    int slot, int L, const void* route_w, void* stream) {
  cudaGetLastError();  // clear any stale error of this library
  Args a;
  a.x = x;
  a.thr = static_cast<const float*>(thr);
  a.norm = norm;
  a.eps = eps;
  const void* w[3] = {w0, w1, w2};
  const void* sz[3] = {sz0, sz1, sz2};
  const void* sc[3] = {sc0, sc1, sc2};
  for (int i = 0; i < 3; ++i) {
    a.w[i] = w[i];
    a.sz[i] = static_cast<const float*>(sz[i]);
    a.scale[i] = static_cast<const float*>(sc[i]);
  }
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
  a.layer_dev = static_cast<const int*>(layer_dev);
  a.slot = slot;
  a.L = L;
  a.route_w = static_cast<const float*>(route_w);
  a.B = rows;
  a.fixed = fixed;
  const int n_out = mode == 2 ? n0 : a.n[0] + a.n[1] + a.n[2];
  a.n_out = n_out;
  if (rows < 1 || rows > MAXB || (rows > 1 && (G != RG || mode == 3)) ||
      (mode == 3 && route_w == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = n_out / TILE;
  auto s = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 32: return dispatch_type<32>(dtype, plan, a, blocks, s);
    case 64: return dispatch_type<64>(dtype, plan, a, blocks, s);
    case 128: return dispatch_type<128>(dtype, plan, a, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
