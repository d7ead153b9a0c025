// K8: the attention stage of single-token decode in ONE launch, batch 1:
// the folded attention rms_norm, THE selection rule, the q|k|v gather GEMV,
// RoPE, the in-place write of this token's K/V and GQA attention.
//
// Replaces the Pallas kernel `_attn_block_kernel` (teal_tpu/ops/
// attn_block.py:70, the stage `attn_stage` :94), launched by `attn_block`
// (:605), where the port ran K1 (`select_gather_gemv`) then K2
// (`decode_attention`) with q|k|v in fp32 in device memory between them.
// It computes, with the cast points of that K1 + K2 composition (the plain
// version `attn_block_plain`):
//   1. the folded norm: rs = rsqrt(mean(x^2) + eps) in fp32, the selection
//      input xn = T(T(x * rs) * gain) (x itself without a gain);
//   2. max-|xn| group scores of G-wide groups (G 32, 64 or 128) and THE
//      selection rule: survivors are score > thr, taken in ascending group
//      order, the first `cap` kept; `fixed` keeps groups 0..cap-1;
//   3. the head's q|k|v columns as fp32 sums over the kept rows of
//      weights of the stream type T, or of packed int4 {"qp" [L, K/2, N],
//      "sz" [L, K/G, 2, N]} at G >= 64, where each kept group adds
//      (xn_g . nib_g) * scale_g + sum(xn_g) * zero_g;
//   4. RoPE (HF rotate-half, fp32) on q and k from the sums, q scaled by
//      1/sqrt(128) after it; k and v written at row `pos` of layer `layer`
//      in the cache type T;
//   5. attention over the live rows t < pos (t > pos - window) and the
//      current token: slab scores of q rounded to T in fp32, ONE max over
//      them and the current token's score before any exp, the weights
//      rounded to T before the PV product (the denominator sums them
//      unrounded), the current token's score and value term in fp32, the
//      output rounded to T (K2's rounding points).
//
// What bounds it on the H100: bytes. It reads the kept slab rows of wq, wk
// and wv (bf16 at the 7B, keep 0.5: 50 MB a call), int4's sz rows of the
// kept groups, the live cache rows of K and V, the gains and the stream,
// and does about two flops a weight element, far below the ridge point.
//
// Design: one thread-block cluster of C blocks owns one kv head, and
// clusters are independent (no grid barrier, no co-residency needed):
//   - every block folds the norm, scores the groups and runs the same
//     ballot scan on the same values, so all keep the same groups; block 0
//     of the grid writes them out;
//   - the cluster's blocks split the kept groups in rank order (`split_lo`)
//     and each sums its groups' rows over all of the head's q|k|v columns
//     (GH + 2 tiles of 128 columns): warp w takes rows [w RPW, (w + 1) RPW)
//     of each of its groups, a lane 4 columns of each tile, loaded straight
//     from device memory (8 bytes a lane in bf16, 16 in fp32, 4 in packed
//     int4) one batch of rows ahead of the FMAs; the warps' sums are added
//     in warp order, then the C blocks' in rank order through distributed
//     shared memory, so every block holds the same head sums;
//   - every block applies RoPE; rank 0 writes this token's K/V row, which no
//     block of the launch reads (the current token stays in shared memory);
//   - the blocks split the live rows in rank order; a warp walks chunks of
//     RB rows (round robin over the warps), the lanes' partial dot products
//     added by a butterfly, twice: first the maxima (the warps', then the
//     cluster's blocks' through distributed shared memory, and the current
//     token's: one max M a head), then the weights, the PV sums and the
//     denominators, added in warp order, then the blocks' in rank order,
//     the current token last. Chunks of fixed size: no plan depends on T.
//     (A running max a warp, rescaled chunk by chunk, rounded the weights
//     at other points than the plain version: ~1 bf16 ulp a head, enough
//     to move the o stage's kept groups in the layer holds.)
// No atomics: every sum has a fixed order, so two launches give the same
// bits. Clusters of C blocks: the largest C <= 8 whose Hkv C blocks stay
// within three quarters of the blocks the SMs hold at once (`ab_plan`,
// exported as `teal_attn_block_plan` and mirrored by the wrapper's
// `k8_plan`): two an SM for bf16 arrays at GH <= 4 (at most 127
// registers a thread) where two blocks' shared memory fits, else one.
// The 7B's 32 kv heads on the H100: bf16 arrays C = 6, 192 blocks; in
// turns C = 3, 4, 6 and 8 took 0.0422, 0.0372, 0.0350 and 0.0489 ms at
// pos 511, with 79, 62, 39 and 30 clusters resident
// (`teal_attn_block_clusters`): C = 8 runs a second wave
// (`tools/k8_check.py --clusters`). fp32 and int4 (146-255 registers, one
// block an SM) C = 3: at C = 6 int4 ran in two waves, 1.22-1.38x slower.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace teal;

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int HD = 128;                 // head dim
constexpr int MAXGH = 8;                // query heads a kv head
constexpr int MAXC = 8;                 // blocks a cluster (portable size)
constexpr int RB = 4;                   // cache rows a warp's chunk
constexpr int MISC = 64;                // floats of scratch (block_sum)
constexpr int SMEM_MAX = 232448;        // a block's shared memory on Hopper
constexpr int SMEM_SM = 233472;         // an SM's
constexpr int SMEM_RESERVED = 1024;     // the runtime's share of a block

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

struct Args {
  const void* x;             // [K] stream, type T
  const float* thr;          // one fp32 threshold
  const void* norm;          // [L, K] gains of type T, or null
  float eps;
  const void* w[3];          // wq [L, K, Hq 128], wk / wv [L, K, Hkv 128]
                             // (int4: packed [L, K/2, N] int8)
  const float* sz[3];        // int4: [L, K/G, 2, N] (scale, zero)
  void* kc;                  // [L, 1, Hkv, T, 128] of type T
  void* vc;
  const float* cs;           // [2, 128] cos, sin rows at pos
  const int* pos;            // [1]
  void* out;                 // [Hq 128] of type T
  int* idx_out;              // [cap] kept groups, -1 past the count
  int* count_out;            // [1]
  int K, G, cap, fixed, layer, L, Hq, Hkv, T, window;
  float scale;
  int C;
};

// Shared memory, bytes (`Layout::total`, mirrored by the wrapper's
// `_k8_smem`): the selection input xn [K] fp32, the scores [K/G], the kept
// groups and count [cap + 1], MISC floats of scratch, the warps' sums
// [NWARPS][ncol] (later the warps' attention states), the block's partial
// sums [ncol] (read by the peers), the head's sums [ncol], RoPE'd q (scaled)
// | k and v [ncol], the current token's scores [MAXGH], and the block's
// attention state: maxima and denominators [2 MAXGH] and PV sums [GH][128]
// (read by the peers); ncol = (GH + 2) 128.
struct Layout {
  int xs, scores, idx, misc, red, part, qkv, qf, sc, apart, total;
  __host__ __device__ Layout(int K, int G, int cap, int GH) {
    const int ncol = (GH + 2) * HD;
    xs = 0;
    scores = xs + pad4(K) * 4;
    idx = scores + pad4(K / G) * 4;
    misc = idx + pad4(cap + 1) * 4;
    red = misc + MISC * 4;
    part = red + NWARPS * ncol * 4;
    qkv = part + ncol * 4;
    qf = qkv + ncol * 4;
    sc = qf + ncol * 4;
    apart = sc + MAXGH * 4;
    total = apart + (2 * MAXGH + GH * HD) * 4;
  }
};

struct AbPlan { int C, grid, smem; };   // smem -1: no plan

// The plan from shapes only: GH = Hq / Hkv of 1, 2, 4 or 8; G of 32, 64 or
// 128 dividing K (packed int4 at G >= 64); 1 <= cap <= K / G; the layout
// within a block's shared memory; C the largest size <= MAXC with
// 4 Hkv C <= 3 b n_sms (at least 1), b the blocks an SM holds: 2 for bf16
// arrays at GH <= 4 where two blocks' shared memory fits, else 1.
AbPlan ab_plan(int dtype, int plan, int G, int K, int Hq, int Hkv, int cap,
               int n_sms) {
  AbPlan p = {0, 0, -1};
  if (Hkv < 1 || Hq < Hkv || Hq % Hkv) return p;
  const int GH = Hq / Hkv;
  if (GH != 1 && GH != 2 && GH != 4 && GH != 8) return p;
  if (G != 32 && G != 64 && G != 128) return p;
  if (plan != PLAN_STREAM && plan != PLAN_INT4) return p;
  if (plan == PLAN_INT4 && G < 64) return p;
  if (K <= 0 || K % G || cap < 1 || cap > K / G) return p;
  const Layout lay(K, G, cap, GH);
  if (lay.total > SMEM_MAX) return p;
  int C = 1;
  const bool two = dtype == 1 && plan == PLAN_STREAM && GH <= 4;
  const int b = two && 2 * (lay.total + SMEM_RESERVED) <= SMEM_SM ? 2 : 1;
  while (C < MAXC && 4 * Hkv * (C + 1) <= 3 * b * n_sms) ++C;
  p = {C, Hkv * C, lay.total};
  return p;
}

// A lane's 4 columns of a slab row: 8 bytes (bf16), 16 (fp32), or 4 bytes
// of packed int4 (a byte holds two rows of one column).
template <typename T, int P> struct Raw4;
template <> struct Raw4<float, PLAN_STREAM> { using type = uint4; };
template <> struct Raw4<__nv_bfloat16, PLAN_STREAM> { using type = uint2; };
template <typename T> struct Raw4<T, PLAN_INT4> { using type = uint32_t; };

template <typename R>
__device__ __forceinline__ R ldg_raw(const unsigned char* p) {
  return __ldg(reinterpret_cast<const R*>(p));
}

__device__ __forceinline__ void to4(const uint4& r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void to4(const uint2& r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x << 16); v[1] = __uint_as_float(r.x & 0xffff0000u);
  v[2] = __uint_as_float(r.y << 16); v[3] = __uint_as_float(r.y & 0xffff0000u);
}

// The selection input of a 16-byte chunk of x and of the gains (the
// reference's two roundings, `_norm_fold`), as fp32 in v.
template <typename T>
__device__ __forceinline__ void sel16(const uint4& xr, const uint4* gr,
                                      float rs, float (&v)[16 / sizeof(T)]) {
  constexpr int EPV = 16 / sizeof(T);
  const T* xe = reinterpret_cast<const T*>(&xr);
#pragma unroll
  for (int e = 0; e < EPV; ++e) v[e] = to_f(xe[e]);
  if (gr != nullptr) {
    const T* ge = reinterpret_cast<const T*>(gr);
#pragma unroll
    for (int e = 0; e < EPV; ++e)
      v[e] = rnd<T>(rnd<T>(v[e] * rs) * to_f(ge[e]));
  }
}

template <typename T, int P, int GH>
__global__ void __launch_bounds__(THREADS, 1) attn_block_kernel(Args a) {
  constexpr int NT = GH + 2;                 // 128-column tiles of a head
  constexpr int NCOL = NT * HD;
  constexpr int EPV = 16 / static_cast<int>(sizeof(T));
  constexpr int WESZ = P == PLAN_STREAM ? static_cast<int>(sizeof(T)) : 1;
  constexpr int U = NT <= 4 ? 4 : (NT <= 6 ? 2 : 1);   // rows a batch
  using R = typename Raw4<T, P>::type;
  using RC = typename Raw4<T, PLAN_STREAM>::type;      // a cache row's 4
  extern __shared__ __align__(128) unsigned char sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = a.K, G = a.G, nb = K / G, C = a.C;
  const int rank = static_cast<int>(cluster.block_rank());
  const int head = static_cast<int>(blockIdx.x) / C;
  const Layout lay(K, G, a.cap, GH);
  float* xs = reinterpret_cast<float*>(sm + lay.xs);
  float* scores = reinterpret_cast<float*>(sm + lay.scores);
  int* idx = reinterpret_cast<int*>(sm + lay.idx);
  float* misc = reinterpret_cast<float*>(sm + lay.misc);
  float* red = reinterpret_cast<float*>(sm + lay.red);
  float* part = reinterpret_cast<float*>(sm + lay.part);
  float* qkv = reinterpret_cast<float*>(sm + lay.qkv);
  float* qf = reinterpret_cast<float*>(sm + lay.qf);
  float* scur = reinterpret_cast<float*>(sm + lay.sc);
  float* apart = reinterpret_cast<float*>(sm + lay.apart);
  const size_t layer = static_cast<size_t>(a.layer);
  const int p = *a.pos;
  if (p < 0 || p >= a.T) __trap();
  // the head's cache slabs, and this block's share [ra, rb) of their live
  // rows (attention's)
  const size_t hrow = (layer * a.Hkv + head) * static_cast<size_t>(a.T);
  T* kcache = static_cast<T*>(a.kc) + hrow * HD;
  T* vcache = static_cast<T*>(a.vc) + hrow * HD;
  const int lo = a.window > 0 ? max(p - a.window + 1, 0) : 0;
  const int ra = lo + split_lo(p - lo, C, rank);
  const int rb = lo + split_lo(p - lo, C, rank + 1);

  // 1. the folded norm and the selection input, in every block
  const T* x = static_cast<const T*>(a.x);
  const T* gain = a.norm == nullptr
                      ? nullptr
                      : static_cast<const T*>(a.norm) + layer * K;
  const int nch = K / EPV;
  float rs = 1.f;
  if (gain != nullptr) {
    float ss = 0.f;
    for (int c = tid; c < nch; c += THREADS) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(x) + c);
      const T* v = reinterpret_cast<const T*>(&r);
#pragma unroll
      for (int e = 0; e < EPV; ++e) ss = fmaf(to_f(v[e]), to_f(v[e]), ss);
    }
    ss = block_sum(ss, misc);
    rs = rsqrtf(ss / static_cast<float>(K) + a.eps);
  }
  // 2. scores: a group's XCH chunks are consecutive lanes of one warp
  const int XCH = G / EPV;
  for (int base = 0; base < nch; base += THREADS) {
    const int c = base + tid;
    float m = 0.f;
    if (c < nch) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(x) + c);
      uint4 gr;
      if (gain != nullptr) gr = __ldg(reinterpret_cast<const uint4*>(gain) + c);
      float v[EPV];
      sel16<T>(r, gain != nullptr ? &gr : nullptr, rs, v);
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        xs[c * EPV + e] = v[e];
        m = fmaxf(m, fabsf(v[e]));
      }
    }
    for (int o = 1; o < XCH; o <<= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (c < nch && lane % XCH == 0) scores[c / XCH] = m;
  }
  __syncthreads();
  if (warp == 0) {
    const int c = ballot_select(scores, nb, a.fixed ? 0.f : *a.thr, a.cap,
                                a.fixed != 0, idx);
    if (lane == 0) idx[a.cap] = c;
  }
  __syncthreads();
  const int count = idx[a.cap];
  if (blockIdx.x == 0) {
    for (int j = tid; j < a.cap; j += THREADS)
      a.idx_out[j] = j < count ? idx[j] : -1;
    if (tid == 0) *a.count_out = count;
  }

  // 3. the gather: this block's share of the kept groups, all the head's
  // columns; tile j < GH is q head (head GH + j), GH is k, GH + 1 is v
  const int nq = a.Hq * HD, nk = a.Hkv * HD;
  const size_t krows = P == PLAN_INT4 ? K / 2 : K;
  const int GROWS = P == PLAN_INT4 ? G / 2 : G;   // slab rows a group
  const int RPW = GROWS / NWARPS;                 // a warp's rows a group
  const unsigned char* wp[NT];
  const float* szp[NT];
  size_t wstr[NT];
  int ncols[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int wi = j < GH ? 0 : j - GH + 1;
    const int N = wi == 0 ? nq : nk;
    const int col = (wi == 0 ? head * GH + j : head) * HD + 4 * lane;
    wp[j] = static_cast<const unsigned char*>(a.w[wi]) +
            (layer * krows * N + col) * WESZ;
    szp[j] = P == PLAN_INT4 ? a.sz[wi] + layer * nb * 2 * N + col : nullptr;
    wstr[j] = static_cast<size_t>(N) * WESZ;
    ncols[j] = N;
  }
  const int j0 = split_lo(count, C, rank);
  const int ng = split_lo(count, C, rank + 1) - j0;
  float acc[NT][4], pk[P == PLAN_INT4 ? NT : 1][4], sx = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] = 0.f;
      pk[P == PLAN_INT4 ? j : 0][e] = 0.f;
    }
  const int nbat = ng * RPW / U;
  R cur[U][NT], nxt[U][NT];
  auto issue = [&](int b, R (&buf)[U][NT]) {
    const int u = b * U / RPW, r0 = b * U % RPW;
    const size_t row0 = static_cast<size_t>(idx[j0 + u]) * GROWS +
                        warp * RPW + r0;
#pragma unroll
    for (int i = 0; i < U; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        buf[i][j] = ldg_raw<R>(wp[j] + (row0 + i) * wstr[j]);
  };
  if (nbat > 0) issue(0, cur);
  for (int b = 0; b < nbat; ++b) {
    if (b + 1 < nbat) issue(b + 1, nxt);
    const int u = b * U / RPW, r0 = b * U % RPW;
    const int g = idx[j0 + u];
    const float* xg = xs + g * G + warp * RPW + r0;
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if constexpr (P == PLAN_INT4) {
        const float xlo = xg[i], xhi = xg[i + G / 2];
        sx += xlo + xhi;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t lo = cur[i][j] & 0x0F0F0F0Fu;
          const uint32_t hi = (cur[i][j] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pk[j][e] = fmaf(xhi, nib128_f(hi, e),
                            fmaf(xlo, nib128_f(lo, e), pk[j][e]));
        }
      } else {
        const float xv = xg[i];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float v[4];
          to4(cur[i][j], v);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(xv, v[e], acc[j][e]);
        }
      }
    }
    if constexpr (P == PLAN_INT4) {
      if (r0 + U == RPW) {      // the warp's last rows of group g: its
                                // sums (x . (128 + nib)) - 128 sum(x), then
                                // the group's scale and zero
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* s = szp[j] + static_cast<size_t>(g) * 2 * ncols[j];
          const float4 s4 = __ldg(reinterpret_cast<const float4*>(s));
          const float4 z4 =
              __ldg(reinterpret_cast<const float4*>(s + ncols[j]));
          const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
          const float zv[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[j][e] = fmaf(fmaf(-128.f, sx, pk[j][e]), sv[e],
                             fmaf(sx, zv[e], acc[j][e]));
            pk[j][e] = 0.f;
          }
        }
        sx = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) cur[i][j] = nxt[i][j];
  }

  // the warps' sums in warp order, then the cluster's blocks' in rank
  // order: every block of the cluster holds the same head sums
#pragma unroll
  for (int j = 0; j < NT; ++j)
    *reinterpret_cast<float4*>(red + warp * NCOL + j * HD + 4 * lane) =
        make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  __syncthreads();
  for (int c = tid; c < NCOL; c += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += red[w * NCOL + c];
    part[c] = s;
  }
  cluster.sync();
  for (int c = tid; c < NCOL; c += THREADS) {
    float s = 0.f;
    for (int r = 0; r < C; ++r) s += cluster.map_shared_rank(part, r)[c];
    qkv[c] = s;
  }
  __syncthreads();

  // 4. RoPE on q (then scaled) and k, v as summed; rank 0 writes the row
  for (int i = tid; i < NCOL; i += THREADS) {
    const int j = i / HD, d = i % HD;
    float v = qkv[i];
    if (j <= GH) {
      const float rot = d < HD / 2 ? -qkv[i + HD / 2] : qkv[i - HD / 2];
      v = rope_term(v, rot, __ldg(a.cs + d), __ldg(a.cs + HD + d));
      if (j < GH) v = __fmul_rn(v, a.scale);
    }
    qf[i] = v;
  }
  __syncthreads();
  const float* kn = qf + GH * HD;
  const float* vn = kn + HD;
  if (rank == 0 && tid < HD) {
    kcache[static_cast<size_t>(p) * HD + tid] = from_f<T>(kn[tid]);
    vcache[static_cast<size_t>(p) * HD + tid] = from_f<T>(vn[tid]);
  }
  if (warp < GH) {          // the current token's score, fp32
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s = fmaf(qf[warp * HD + 4 * lane + e], kn[4 * lane + e], s);
    s = warp_sum(s);
    if (lane == 0) scur[warp] = s;
  }

  // 5. attention: the block's share of the live rows [lo, p), chunks of RB
  // rows round robin over the warps, in two passes: the scores' max (the
  // warps', the blocks' in the cluster and the current token's: ONE max
  // M), then the weights e = exp(s - M), rounded to T for the PV product,
  // their unrounded sum the denominator (the plain version's rounding
  // points: a running max rescaled chunk by chunk moved the next stage's
  // kept groups in the layer holds)
  float qr[GH][4];
#pragma unroll
  for (int g = 0; g < GH; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) qr[g][e] = rnd<T>(qf[g * HD + 4 * lane + e]);
  const unsigned char* krow =
      reinterpret_cast<const unsigned char*>(kcache + 4 * lane);
  const unsigned char* vrow =
      reinterpret_cast<const unsigned char*>(vcache + 4 * lane);
  constexpr size_t RSTR = HD * sizeof(T);
  auto load_rows = [&](const unsigned char* base, int t0, RC (&rr)[RB]) {
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      rr[i] = RC{};
      if (t0 + i < rb)
        rr[i] = ldg_raw<RC>(base + static_cast<size_t>(t0 + i) * RSTR);
    }
  };
  // the slab scores of a chunk's rows (every lane holds each one)
  auto scores_of = [&](const RC (&kk)[RB], float (&s)[GH][RB]) {
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      float kv[4];
      to4(kk[i], kv);
#pragma unroll
      for (int g = 0; g < GH; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) d = fmaf(qr[g][e], kv[e], d);
        s[g][i] = warp_sum(d);
      }
    }
  };
  float* wred = red;                    // [NWARPS][MAXGH] maxima, then
                                        // [NWARPS][GH][128] PV sums and
                                        // [NWARPS][MAXGH] denominators
  float* Mg = misc;                     // [MAXGH] the one max a head
  {                                     // pass 1: the maxima
    float mx[GH];
#pragma unroll
    for (int g = 0; g < GH; ++g) mx[g] = -1e30f;
    RC kb[RB], kn2[RB];
    int t0 = ra + warp * RB;
    if (t0 < rb) load_rows(krow, t0, kb);
    for (; t0 < rb; t0 += NWARPS * RB) {
      if (t0 + NWARPS * RB < rb) load_rows(krow, t0 + NWARPS * RB, kn2);
      float sc[GH][RB];
      scores_of(kb, sc);
      const int nr = min(RB, rb - t0);
#pragma unroll
      for (int g = 0; g < GH; ++g)
#pragma unroll
        for (int i = 0; i < RB; ++i)
          if (i < nr) mx[g] = fmaxf(mx[g], sc[g][i]);
#pragma unroll
      for (int i = 0; i < RB; ++i) kb[i] = kn2[i];
    }
    if (lane == 0)
#pragma unroll
      for (int g = 0; g < GH; ++g) wred[warp * MAXGH + g] = mx[g];
  }
  __syncthreads();
  if (tid < GH) {
    float m = -1e30f;
    for (int w = 0; w < NWARPS; ++w) m = fmaxf(m, wred[w * MAXGH + tid]);
    apart[tid] = m;
  }
  cluster.sync();
  if (tid < GH) {
    float m = scur[tid];
    for (int r = 0; r < C; ++r)
      m = fmaxf(m, cluster.map_shared_rank(apart, r)[tid]);
    Mg[tid] = m;
  }
  __syncthreads();
  float M[GH], den[GH], pv[GH][4];
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    M[g] = Mg[g];
    den[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) pv[g][e] = 0.f;
  }
  {                                     // pass 2: weights, PV, sums
    RC kb[RB], vb[RB], kn2[RB], vn2[RB];
    int t0 = ra + warp * RB;
    if (t0 < rb) {
      load_rows(krow, t0, kb);
      load_rows(vrow, t0, vb);
    }
    for (; t0 < rb; t0 += NWARPS * RB) {
      if (t0 + NWARPS * RB < rb) {
        load_rows(krow, t0 + NWARPS * RB, kn2);
        load_rows(vrow, t0 + NWARPS * RB, vn2);
      }
      float sc[GH][RB];
      scores_of(kb, sc);
      const int nr = min(RB, rb - t0);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        if (i >= nr) break;
        float vv[4];
        to4(vb[i], vv);
#pragma unroll
        for (int g = 0; g < GH; ++g) {
          const float w = expf(sc[g][i] - M[g]);
          den[g] += w;
          const float wr = rnd<T>(w);
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[g][e] = fmaf(wr, vv[e], pv[g][e]);
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        kb[i] = kn2[i];
        vb[i] = vn2[i];
      }
    }
  }
  // the warps' sums in warp order, then the blocks' in rank order
  __syncthreads();                      // the maxima in `wred` are read
  float* wacc = wred;                   // [NWARPS][GH][128]
  float* wden = wred + NWARPS * GH * HD;  // [NWARPS][MAXGH]
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    *reinterpret_cast<float4*>(wacc + (warp * GH + g) * HD + 4 * lane) =
        make_float4(pv[g][0], pv[g][1], pv[g][2], pv[g][3]);
    if (lane == 0) wden[warp * MAXGH + g] = den[g];
  }
  __syncthreads();
  for (int i = tid; i < GH * HD; i += THREADS) {
    float A = 0.f, Dn = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      A += wacc[w * GH * HD + i];
      Dn += wden[w * MAXGH + i / HD];
    }
    apart[2 * MAXGH + i] = A;
    if (i % HD == 0) apart[MAXGH + i / HD] = Dn;
  }
  cluster.sync();
  // the cluster's blocks in rank order, then the current token
  T* out = static_cast<T*>(a.out) + static_cast<size_t>(head) * GH * HD;
  for (int i = rank * THREADS + tid; i < GH * HD; i += C * THREADS) {
    const int g = i / HD, d = i % HD;
    float A = 0.f, Dn = 0.f;
    for (int r = 0; r < C; ++r) {
      const float* pr = cluster.map_shared_rank(apart, r);
      A += pr[2 * MAXGH + i];
      Dn += pr[MAXGH + g];
    }
    const float ec = expf(scur[g] - Mg[g]);
    out[i] = from_f<T>((A + ec * vn[d]) * (1.f / (Dn + ec)));
  }
  cluster.sync();            // no block leaves while a peer reads it
}

int device_sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

struct OccEntry { const void* fn; int C, smem, clusters; };
OccEntry occ_cache[64];
int occ_n = 0;

// The clusters of C blocks of one instance of the kernel, at `smem` bytes
// a block, that the card keeps resident at once
// (cudaOccupancyMaxActiveClusters, cached by instance, C and smem); a
// failed query as its negative CUDA error. `cfg` is the launch's, with its
// cluster attribute.
template <typename T, int P, int GH>
int resident(cudaLaunchConfig_t* cfg, int C, int smem) {
  auto fn = attn_block_kernel<T, P, GH>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return -static_cast<int>(e);
    attr_set = true;
  }
  for (int i = 0; i < occ_n; ++i)
    if (occ_cache[i].fn == reinterpret_cast<const void*>(fn) &&
        occ_cache[i].C == C && occ_cache[i].smem == smem)
      return occ_cache[i].clusters;
  int clusters = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, fn, cfg);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (occ_n < 64)
    occ_cache[occ_n++] = {reinterpret_cast<const void*>(fn), C, smem,
                          clusters};
  return clusters;
}

// A launch's configuration: `grid` blocks in clusters of C; `attr` holds
// its one attribute.
cudaLaunchConfig_t config(int grid, int C, int smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int P, int GH>
int launch(const Args& a, int smem, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(a.Hkv * a.C, a.C, smem, stream, attr);
  const int clusters = resident<T, P, GH>(&cfg, a.C, smem);
  if (clusters < 0) return -clusters;
  if (clusters < 1) return -1;             // the cluster cannot be placed
  const cudaError_t e = cudaLaunchKernelEx(&cfg, attn_block_kernel<T, P, GH>,
                                           a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int by_heads(const Args& a, int smem, cudaStream_t s) {
  switch (a.Hq / a.Hkv) {
    case 1: return launch<T, P, 1>(a, smem, s);
    case 2: return launch<T, P, 2>(a, smem, s);
    case 4: return launch<T, P, 4>(a, smem, s);
    case 8: return launch<T, P, 8>(a, smem, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int P>
int resident_by_heads(int GH, int C, int smem) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(C, C, smem, nullptr, attr);
  switch (GH) {
    case 1: return resident<T, P, 1>(&cfg, C, smem);
    case 2: return resident<T, P, 2>(&cfg, C, smem);
    case 4: return resident<T, P, 4>(&cfg, C, smem);
    case 8: return resident<T, P, 8>(&cfg, C, smem);
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The plan for these types and shapes on this card's SM count (`n_sms`,
// 0: the current device's): out[0..2] = C, grid, shared bytes. Returns 0,
// or -1 where the shapes take no plan. dtype: the stream type's code
// (shared memory holds fp32 only, but the instance's registers set the
// blocks an SM holds); plan: 0 weights of the stream type, 2 packed int4.
extern "C" int teal_attn_block_plan(int dtype, int plan, int G, int K,
                                    int Hq, int Hkv, int cap, int n_sms,
                                    int* out) {
  const AbPlan p = ab_plan(dtype, plan, G, K, Hq, Hkv, cap,
                           n_sms > 0 ? n_sms : device_sms());
  out[0] = p.C;
  out[1] = p.grid;
  out[2] = p.smem;
  return p.smem < 0 ? -1 : 0;
}

// How many clusters of C blocks (1 <= C <= 8) of K8's instance for
// (dtype, plan, GH query heads a kv head), at `smem` bytes a block, the
// card keeps resident at once (cudaOccupancyMaxActiveClusters): the
// reading behind the plan's rule for C. A failed query returns its CUDA
// error as a negative value.
extern "C" int teal_attn_block_clusters(int dtype, int plan, int GH, int C,
                                        int smem) {
  if (C < 1 || C > MAXC || smem < 0 || smem > SMEM_MAX)
    return -static_cast<int>(cudaErrorInvalidValue);
  if (plan == PLAN_INT4)
    return dtype == 0 ? resident_by_heads<float, PLAN_INT4>(GH, C, smem)
                      : resident_by_heads<__nv_bfloat16, PLAN_INT4>(GH, C,
                                                                    smem);
  return dtype == 0 ? resident_by_heads<float, PLAN_STREAM>(GH, C, smem)
                    : resident_by_heads<__nv_bfloat16, PLAN_STREAM>(GH, C,
                                                                    smem);
}

// One launch of K8 on `stream`. Weights: plan 0 wq, wk, wv of the stream
// type; plan 2 their packed int4 qp stacks and sz0-2 their sz stacks.
// window 0 means none. The plan is made for `n_sms` SMs (0: the current
// device's; the wrapper passes the count its route planned with). The
// caller checks shapes, types and alignment (the wrapper
// `ops/attn_block.attn_block`); a shape with no plan returns
// cudaErrorInvalidValue, a cluster that cannot be resident -1.
extern "C" int teal_attn_block(
    int dtype, int plan, const void* x, const void* thr, const void* norm,
    float eps, const void* wq, const void* wk, const void* wv,
    const void* sz0, const void* sz1, const void* sz2, void* kc, void* vc,
    const void* cs, const void* pos, void* out, void* idx, void* count,
    int K, int G, int cap, int fixed, int layer, int L, int Hq, int Hkv,
    int T, int window, float scale, int n_sms, void* stream) {
  cudaGetLastError();  // clear any stale error of this library
  const AbPlan p = ab_plan(dtype, plan, G, K, Hq, Hkv, cap,
                           n_sms > 0 ? n_sms : device_sms());
  if (p.smem < 0 || layer < 0 || layer >= L || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.thr = static_cast<const float*>(thr);
  a.norm = norm;
  a.eps = eps;
  a.w[0] = wq;
  a.w[1] = wk;
  a.w[2] = wv;
  a.sz[0] = static_cast<const float*>(sz0);
  a.sz[1] = static_cast<const float*>(sz1);
  a.sz[2] = static_cast<const float*>(sz2);
  a.kc = kc;
  a.vc = vc;
  a.cs = static_cast<const float*>(cs);
  a.pos = static_cast<const int*>(pos);
  a.out = out;
  a.idx_out = static_cast<int*>(idx);
  a.count_out = static_cast<int*>(count);
  a.K = K;
  a.G = G;
  a.cap = cap;
  a.fixed = fixed;
  a.layer = layer;
  a.L = L;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.T = T;
  a.window = window;
  a.scale = scale;
  a.C = p.C;
  auto s = static_cast<cudaStream_t>(stream);
  if (plan == PLAN_INT4)
    return dtype == 0 ? by_heads<float, PLAN_INT4>(a, p.smem, s)
                      : by_heads<__nv_bfloat16, PLAN_INT4>(a, p.smem, s);
  return dtype == 0 ? by_heads<float, PLAN_STREAM>(a, p.smem, s)
                    : by_heads<__nv_bfloat16, PLAN_STREAM>(a, p.smem, s);
}
