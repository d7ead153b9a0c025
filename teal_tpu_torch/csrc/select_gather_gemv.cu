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
// Design of the single row (`sgg_stream_kernel`). A block owns a tile of
// 256 bytes of each slab row of the weights it reads (bf16 128 columns,
// fp32 64, int8 and packed int4 256; mode 2 the same columns of gate and
// up, so the silu product needs no second pass; a narrower last tile of
// a weight is masked) and one of S contiguous shares of the kept list
// (`split_lo`). A thread-block cluster of C = S * (tiles a cluster) <= 8
// blocks does the prologue once: block `rank` reads its 1/C of the groups
// of x with 16-byte loads, pushes its sum of squares into every peer's
// shared memory (added in rank order, so every block forms the same row
// scale), then its groups' max-|x| scores after the fold; every block
// runs the same ballot scan on identical scores, so all keep exactly the
// serial scan's groups. The gather then streams the block's share as
// K3's one-row form does: the kept groups' selection inputs (and int4's
// scale and zero rows, laid out without bank conflicts) are staged in
// shared memory a chunk of groups at a time; each thread streams 16
// bytes of every 16th slab row of its share (of both weights in mode 2)
// through its own slots of an 8-stage cp.async ring and does its FMAs on
// what it copied itself, so the loop has no block barrier and no
// dependent load. int8 becomes fp32 with one byte permute a value
// (`i8_f`); packed int4 with one PRMT a nibble (`nib128_f`), each group's
// sums kept in fp32 before its scale and zero. Sums are added in a fixed
// order -- a thread's rows in order, the 16 row lanes in order, the S
// split blocks in split order after each pushed its part over
// distributed shared memory -- so two calls give the same bits; no
// atomics. The plan (S, C, ring stages, shared bytes) comes from shapes
// only (`sgg_plan`, mirrored by the wrapper's `_sgg_plan` and exported as
// `teal_sgg_plan`). Measured on the H100 (PERF.md section 6): a call
// pays a fixed 8-10 us whatever its bytes; a grid doubled to two blocks
// an SM, a 12-stage ring and 512-byte tiles were all slower.
//
// Rows form (B = 2..16 input rows at G = 128, the batched whole-token
// kernel's `_proj_stage` with `batch` rows, token_block.py:343): one
// kept set for all rows, picked by each group's max |x| over lanes and
// rows (`_select_scan`, block_gemv.py:456); the folded norm is per row.
// It reads the kept slabs once for all B rows, so it is bound by the same
// bytes as one row plus B rows of x, and does 2 * B * rows * N flops: at
// B = 16 about one flop a bf16 weight byte, which fp32 FMAs on the CUDA
// cores could not hide, so the bf16 stream runs on the tensor cores (the
// reference's own arithmetic is a bf16 x bf16 -> fp32 `dot_general` on
// the MXU with 16 sublane rows, block_gemv.py:208-238). The design:
//   - a block owns RT = 64 output columns of a tile, or with S = 2 or 4
//     splits a 1/S share of the tile's kept groups (S = 2 for the
//     4096-wide o and down stages at 7B), so the narrow stages also keep
//     every SM streaming;
//   - a thread-block cluster of C <= 8 blocks does the prologue once: each
//     block takes 1/C of the groups, reads its share of the B input rows
//     with 16-byte loads, and pushes its per-row sums of squares, then
//     (after the row scales are formed from the C partials in rank order)
//     its pooled group scores, into every peer's shared memory. Every
//     block then holds identical scores and runs the same ballot scan, so
//     all keep exactly the serial scan's groups;
//   - the gather streams one kept group a stage through a ring of up to 8
//     shared-memory stages filled by cp.async: the group's [128, RT] slab
//     of each weight (packed int4: [64, RT] bytes and the group's scale
//     and zero rows), its B raw input rows and its gains;
//   - bf16 stream: mma.sync.m16n8k16 with the 16 input rows as M (rows
//     >= B zero), each warp taking 16 of the group's 128 rows as K and all
//     8 n-tiles of the block's columns. The A fragment comes in through
//     ldmatrix and gets the row scale and gain in registers, with the
//     reference's two roundings; int8 and nibbles become bf16 in
//     registers, exactly. int8's per-channel scale goes on the fp32 sums
//     in the epilogue; int4 adds (x @ nib) * scale + sum(x) * zero a
//     group, sum(x) from one more MMA against ones. fp32 stream: the same
//     slices on FMAs (TF32 would not hold the 1e-4 checks);
//   - per-warp sums are added in warp order through shared memory, split
//     parts are pushed to the block that combines those columns and added
//     in split order: deterministic, no atomics.
// The plan (S, C, ring depth) comes from shapes only (`rows_plan`,
// mirrored by the wrapper's `_rows_plan` and exported as
// `teal_sgg_rows_plan`); the launch is one cudaLaunchKernelEx. Measured
// on the H100 (PERF.md section 6): the bf16 stream streams its slabs at
// 2.0-2.8 TB/s and pays a fixed prologue, first-group latency and
// epilogue of about a third of its time; the int8 and int4 plans are
// bound by the arithmetic of the conversions and scales a group, not by
// their bytes. 1-D bulk copies of the 128-byte slab rows, and L2
// prefetches ahead of the ring, were slower than cp.async.
// `fixed` (both forms) skips scoring and keeps groups 0..cap-1.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace teal;

namespace {

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
  int S, C, nst;             // the plan: splits, cluster, ring stages
};

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
    const int c = ballot_select(scores, nb, a.fixed ? 0.f : *a.thr, a.cap,
                                a.fixed != 0, idx);
    if (lane == 0) *cnt = c;
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

// --- single row: selection once per cluster, a stream of slab rows ----

constexpr int PIECE = 256;           // bytes of a slab row a block reads
constexpr int CPR = PIECE / 16;      // 16-byte chunks of a row piece
constexpr int RLANES = THREADS / CPR;  // row lanes
constexpr int SNST = 8;              // ring stages
constexpr int SMAXS = 8;             // splits of a tile's kept groups
constexpr int SMAXC = 8;             // blocks a cluster (the portable size)
constexpr int SCRATCH = 64;          // floats: block_sum, norm partials
constexpr int SMEM_MAX = 232448;     // a block's shared memory on Hopper

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// Groups staged a chunk: 2048 input values' worth (stream, int8), or 8
// groups for packed int4, whose chunk also holds each group's scale and
// zero rows of the tile.
__host__ __device__ constexpr int chunk_groups(int plan, int G) {
  return plan == PLAN_INT4 ? 8 : 2048 / G;
}

// Shared memory of the single-row kernel, bytes: the ring [SNST][NW]
// [THREADS] x 16 (after the loop the row lanes' sums [RLANES][NW][TW]
// fp32), a chunk's selection inputs [CG][G] of the stream type, (int4)
// its groups' scale and zero rows [CG][NW][2][TW] fp32, the kept groups
// and count [cap + 1], the scores [nb], the block_sum scratch and the
// peers' norm partials, the split sums of the block's columns [S][NW]
// [TW / S] fp32 (pushed by the cluster's peers). The wrapper's `_sgg_smem`
// mirrors `total`.
struct StreamLayout {
  int tw, cg, xs, sz, idx, scores, misc, part, total;
  __host__ __device__ StreamLayout(int esz, int plan, int nw, int G, int nb,
                                   int cap) {
    tw = PIECE / (plan == PLAN_STREAM ? esz : 1);
    cg = chunk_groups(plan, G);
    xs = SNST * nw * THREADS * 16;
    sz = xs + cg * G * esz;
    idx = sz + (plan == PLAN_INT4 ? cg * nw * 2 * tw * 4 : 0);
    scores = idx + pad4(cap + 1) * 4;
    misc = scores + pad4(nb) * 4;
    part = misc + SCRATCH * 4;
    total = part + nw * tw * 4;
  }
};

// The single-row plan, from shapes only: S splits of each tile's kept
// groups (the largest power of two <= SMAXS keeping the grid of tiles * S
// blocks within one block an SM), C = S * (tiles a cluster) blocks a
// cluster (the largest power of two <= SMAXC whose tiles divide the
// grid's), the ring's stages and the shared bytes (-1 where the shapes
// take no plan). `tiles` counts ceil(n_i / TW) over the weights (mode 2:
// of gate only, whose tile holds up's columns too).
struct SggPlan { int S, C, nst, smem; };

SggPlan sgg_plan(int esz, int plan, int nw, int G, const int (&n)[3], int K,
                 int cap, int n_sms) {
  SggPlan p = {0, 0, 0, -1};
  if (G <= 0 || K <= 0 || K % G || cap < 1 || cap > K / G) return p;
  const StreamLayout lay(esz, plan, nw, G, K / G, cap);
  const int tiles = nw == 2 ? cdiv(n[0], lay.tw)
                            : cdiv(n[0], lay.tw) + cdiv(n[1], lay.tw) +
                                  cdiv(n[2], lay.tw);
  if (tiles <= 0 || lay.total > SMEM_MAX) return p;
  int S = 1;
  while (S < SMAXS && tiles * 2 * S <= n_sms) S *= 2;
  int tc = 1;
  while (tc * 2 * S <= SMAXC && tiles % (tc * 2) == 0) tc *= 2;
  p = {S, tc * S, SNST, lay.total};
  return p;
}

// The selection input of a 16-byte chunk of x (and of the gains): x
// itself, or rnd(rnd(x * rs) * gain) per element, the reference's two
// roundings (`_norm_fold`); as fp32 in v.
template <typename T>
__device__ __forceinline__ void sel_chunk(const uint4& xr, const uint4* gr,
                                          float rs,
                                          float (&v)[16 / sizeof(T)]) {
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

// 16 bytes of the stream type from fp32 values already rounded to it
template <typename T>
__device__ __forceinline__ uint4 pack_chunk(const float (&v)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  } else {
    return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                      pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

template <typename T, int P, bool PAIR, int G>
__global__ void __launch_bounds__(THREADS, 2) sgg_stream_kernel(Args a) {
  constexpr int NW = PAIR ? 2 : 1;
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int WESZ = P == PLAN_STREAM ? ESZ : 1;
  constexpr int TW = PIECE / WESZ;          // tile columns
  constexpr int VEC = 16 / WESZ;            // a chunk's columns
  constexpr int GROWS = P == PLAN_INT4 ? G / 2 : G;   // slab rows a group
  constexpr int IPG = GROWS / RLANES;       // a thread's rows of a group
  constexpr int CG = chunk_groups(P, G);    // groups a chunk
  constexpr int EPV = 16 / ESZ;             // inputs a 16-byte chunk
  constexpr int XCH = G / EPV;              // chunks of a group's inputs
  constexpr int MAXL = 4;                   // prologue chunks kept a thread
  static_assert(GROWS % RLANES == 0, "whole row lanes a group");
  static_assert(XCH <= 32 && 32 % XCH == 0, "a group's chunks in a warp");
  extern __shared__ __align__(128) unsigned char sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31;
  const int K = a.K, nb = K / G, S = a.S, C = a.C;
  const int rank = static_cast<int>(cluster.block_rank());
  const StreamLayout lay(ESZ, P, NW, G, nb, a.cap);
  uint4* ring = reinterpret_cast<uint4*>(sm);
  T* xs = reinterpret_cast<T*>(sm + lay.xs);
  const float* szs = reinterpret_cast<const float*>(sm + lay.sz);
  int* idx = reinterpret_cast<int*>(sm + lay.idx);
  float* scores = reinterpret_cast<float*>(sm + lay.scores);
  float* misc = reinterpret_cast<float*>(sm + lay.misc);
  float* ssq = misc + 32;                   // [SMAXC] the peers' partials
  float* part = reinterpret_cast<float*>(sm + lay.part);
  const T* x = static_cast<const T*>(a.x);
  // every block reads its layer (and traps on a bad one) before any load
  const size_t layer = read_layer(a);
  const T* gain = a.norm == nullptr
                      ? nullptr
                      : static_cast<const T*>(a.norm) + layer * K;

  // 1. the prologue, once per cluster: block `rank` takes groups [g0, g1)
  // of x; its sum of squares, then its scores, go into every peer's shared
  // memory (combined in rank order), so every block keeps the same groups
  cluster_arrive_relaxed();
  const int g0 = nb * rank / C, g1 = nb * (rank + 1) / C;
  const int nch = (g1 - g0) * XCH;          // the block's 16-byte chunks
  const bool scoring = !a.fixed;
  uint4 raw[MAXL], graw[MAXL];
  auto load_chunk = [&](int c, uint4& r, uint4& gr) {
    r = __ldg(reinterpret_cast<const uint4*>(x + g0 * G) + c);
    if (gain != nullptr)
      gr = __ldg(reinterpret_cast<const uint4*>(gain + g0 * G) + c);
  };
  // the first MAXL chunks of a thread stay in registers from the norm's
  // sum of squares to the scores: one pass over x where they cover it
  if (scoring || gain != nullptr) {
#pragma unroll
    for (int i = 0; i < MAXL; ++i)
      if (tid + i * THREADS < nch)
        load_chunk(tid + i * THREADS, raw[i], graw[i]);
  }
  float rs = 1.f;
  if (gain != nullptr) {
    float ss = 0.f;
    auto squares = [&](const uint4& r) {
      const T* v = reinterpret_cast<const T*>(&r);
#pragma unroll
      for (int e = 0; e < EPV; ++e) ss = fmaf(to_f(v[e]), to_f(v[e]), ss);
    };
#pragma unroll
    for (int i = 0; i < MAXL; ++i)
      if (tid + i * THREADS < nch) squares(raw[i]);
    for (int c = tid + MAXL * THREADS; c < nch; c += THREADS) {
      uint4 r, gr;
      load_chunk(c, r, gr);
      squares(r);
    }
    ss = block_sum(ss, misc);
    cluster_wait();
    if (tid < C) cluster.map_shared_rank(ssq, tid)[rank] = ss;
    cluster.sync();
    // rsqrtf, as the reference's rsqrt rounds on the card (torch.rsqrt)
    float s = 0.f;
    for (int r = 0; r < C; ++r) s += ssq[r];
    rs = rsqrtf(s / static_cast<float>(K) + a.eps);
  } else {
    cluster_wait();
  }
  if (scoring) {
    // a group's XCH chunks are XCH consecutive lanes of one warp: the
    // max over its chunks by a butterfly, pushed into every peer's scores
    // by the group's first lanes
    auto score = [&](int c, const uint4& r, const uint4& gr) {
      float m = 0.f;
      if (c < nch) {
        float v[EPV];
        sel_chunk<T>(r, gain != nullptr ? &gr : nullptr, rs, v);
#pragma unroll
        for (int e = 0; e < EPV; ++e) m = fmaxf(m, fabsf(v[e]));
      }
#pragma unroll
      for (int o = 1; o < XCH; o <<= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (c < nch)
        for (int pr = lane % XCH; pr < C; pr += XCH)
          cluster.map_shared_rank(scores, pr)[g0 + c / XCH] = m;
    };
#pragma unroll
    for (int i = 0; i < MAXL; ++i)
      if (i * THREADS < nch) score(tid + i * THREADS, raw[i], graw[i]);
    for (int i = MAXL; i * THREADS < nch; ++i) {
      const int c = tid + i * THREADS;
      uint4 r, gr;
      if (c < nch) load_chunk(c, r, gr);
      score(c, r, gr);
    }
    cluster.sync();
  }
  const int count = select_scan(a, scores, nb, idx, idx + a.cap);

  // 2. the tile: weights wsel (the pair in mode 2), columns [off, off +
  // valid) of them, output column c0; this block's share of the kept list
  const int split = static_cast<int>(blockIdx.x) % S;
  int t = static_cast<int>(blockIdx.x) / S, wi = 0, c0 = 0;
  if (!PAIR)
    while (t >= cdiv(a.n[wi], TW)) {
      t -= cdiv(a.n[wi], TW);
      c0 += a.n[wi++];
    }
  const int N = a.n[wi], off = t * TW, valid = min(TW, N - off);
  c0 += off;
  const int q = tid % CPR, rl = tid / CPR;
  const bool live = q * VEC < valid;
  const size_t krows = P == PLAN_INT4 ? K / 2 : K;
  const unsigned char* wsrc[NW];
  const float* szsrc[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    wsrc[w] = static_cast<const unsigned char*>(a.w[wi + w]) +
              ((layer * krows * N + off + q * VEC) * WESZ);
    szsrc[w] = P == PLAN_INT4 ? a.sz[wi + w] + layer * nb * 2 * N + off
                              : nullptr;
  }
  const int j0 = split_lo(count, S, split);
  const int mine = split_lo(count, S, split + 1) - j0;

  float acc[NW][VEC];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[w][e] = 0.f;

  for (int cb = 0; cb < mine; cb += CG) {
    const int ng = min(CG, mine - cb);
    const int* sidx = idx + j0 + cb;
    if constexpr (P == PLAN_INT4) {
      // a scale or zero row's 16-byte chunk ch (columns 4ch..4ch+3: chunk
      // j = ch % 4 of thread q = ch / 4's 16) lands at j * CPR + q, so a
      // thread's four loads of a row are conflict-free across a warp
      constexpr int ZCH = TW / 4;           // 16-byte chunks a sz row
      for (int c = tid; c < ng * NW * 2 * ZCH; c += THREADS) {
        const int r = c / ZCH, ch = c % ZCH;   // r = (u * NW + w) * 2 + h
        const int w = r / 2 % NW, u = r / (2 * NW);
        if (ch * 4 < valid)
          cp_async16(sm + lay.sz + (r * ZCH + (ch % 4) * CPR + ch / 4) * 16,
                     szsrc[w] + (static_cast<size_t>(sidx[u]) * 2 + r % 2) *
                                    N + ch * 4);
      }
    }
    cp_async_commit();
    // this thread's rows, SNST - 1 ahead
    const int nit = ng * IPG;
    auto copy_row = [&](int it) {
      if (it < nit && live) {
        const size_t row = static_cast<size_t>(sidx[it / IPG]) * GROWS + rl +
                           (it % IPG) * RLANES;
#pragma unroll
        for (int w = 0; w < NW; ++w)
          cp_async16(&ring[((it % SNST) * NW + w) * THREADS + tid],
                     wsrc[w] + row * N * WESZ);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < SNST - 1; ++i) copy_row(i);
    // the chunk's selection inputs, while the rows are in flight
    for (int c = tid; c < ng * XCH; c += THREADS) {
      const int k = sidx[c / XCH] * G + (c % XCH) * EPV;
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(x + k));
      uint4 gr;
      if (gain != nullptr) gr = __ldg(reinterpret_cast<const uint4*>(gain + k));
      float v[EPV];
      sel_chunk<T>(r, gain != nullptr ? &gr : nullptr, rs, v);
      reinterpret_cast<uint4*>(xs)[c] = pack_chunk<T>(v);
    }
    cp_async_wait<SNST - 2>();              // the sz rows and row 0
    __syncthreads();
    float p[NW][P == PLAN_INT4 ? VEC : 1], sx = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int e = 0; e < (P == PLAN_INT4 ? VEC : 1); ++e) p[w][e] = 0.f;
    for (int it = 0; it < nit; ++it) {
      cp_async_wait<SNST - 2>();            // row it has landed
      copy_row(it + SNST - 1);              // into the slot row it - 1 left
      const int u = it / IPG, l = rl + (it % IPG) * RLANES;
      if constexpr (P == PLAN_INT4) {
        const float xlo = to_f(xs[u * G + l]);
        const float xhi = to_f(xs[u * G + G / 2 + l]);
        sx += xlo + xhi;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const uint4 raw4 = ring[((it % SNST) * NW + w) * THREADS + tid];
          const uint32_t wd[4] = {raw4.x, raw4.y, raw4.z, raw4.w};
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const uint32_t lo = wd[h] & 0x0F0F0F0Fu;
            const uint32_t hi = (wd[h] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
            for (int k = 0; k < 4; ++k)
              p[w][h * 4 + k] = fmaf(xhi, nib128_f(hi, k),
                                     fmaf(xlo, nib128_f(lo, k),
                                          p[w][h * 4 + k]));
          }
        }
        if (it % IPG == IPG - 1) {          // the group's last row here
          // (x_lo (128 + nib_lo) + x_hi (128 + nib_hi)) - 128 sum(x), then
          // the group's scale and zero
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            const float4* sc =
                reinterpret_cast<const float4*>(szs + (u * NW + w) * 2 * TW) +
                q;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4 s4 = sc[j * CPR], z4 = sc[TW / 4 + j * CPR];
              const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
              const float zv[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int e = j * 4 + k;
                acc[w][e] = fmaf(fmaf(-128.f, sx, p[w][e]), sv[k],
                                 fmaf(sx, zv[k], acc[w][e]));
                p[w][e] = 0.f;
              }
            }
          }
          sx = 0.f;
        }
      } else {
        const float xv = to_f(xs[u * G + l]);
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const uint4 raw4 = ring[((it % SNST) * NW + w) * THREADS + tid];
          if constexpr (P == PLAN_INT8) {
            const uint32_t wd[4] = {raw4.x, raw4.y, raw4.z, raw4.w};
#pragma unroll
            for (int h = 0; h < 4; ++h)
#pragma unroll
              for (int k = 0; k < 4; ++k)
                acc[w][h * 4 + k] = fmaf(xv, i8_f(wd[h], k),
                                         acc[w][h * 4 + k]);
          } else {
            const T* v = reinterpret_cast<const T*>(&raw4);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[w][e] = fmaf(xv, to_f(v[e]), acc[w][e]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();                        // the chunk's staging is free
  }

  // 3. fixed-order sums: the row lanes in order, then the tile's S split
  // blocks in rank order. Split s pushes its sums of the columns block r
  // finishes (TW / S of the tile's, [r cw, (r + 1) cw)) into that block's
  // `part` [S][NW][cw] at row s, so one cluster barrier orders them and
  // each block adds its rows in split order. int8's scale, then the
  // epilogue.
  float* red = reinterpret_cast<float*>(sm);        // [RLANES][NW][TW]
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      red[(rl * NW + w) * TW + q * VEC + e] = acc[w][e];
  __syncthreads();
  const int cw = TW / S, lcw = __ffs(cw) - 1;   // S: a power of two
  for (int c = tid; c < NW * TW; c += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < RLANES; ++r) s += red[r * NW * TW + c];
    if (S == 1) {
      part[c] = s;
    } else {
      const int w = c / TW, col = c % TW;
      cluster.map_shared_rank(part, rank - split + (col >> lcw))
          [(split * NW + w) * cw + (col & (cw - 1))] = s;
    }
  }
  auto finish = [&](int c, float (&f)[NW]) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* sc = a.scale[wi + w];
      if (sc != nullptr) f[w] *= sc[layer * N + off + c];
    }
    const int col = c0 + c;
    if (a.mode == 0) {
      static_cast<float*>(a.out)[col] = f[0];
    } else if (a.mode == 1) {
      const float r = to_f(static_cast<const T*>(a.res)[col]);
      static_cast<T*>(a.out)[col] = from_f<T>(f[0] + r);
    } else if (a.mode == 3) {
      // (scaled sums * w) + residual, two roundings as in the reference
      const float r = to_f(static_cast<const T*>(a.res)[col]);
      static_cast<T*>(a.out)[col] =
          from_f<T>(__fadd_rn(__fmul_rn(f[0], a.route_w[a.slot]), r));
    } else {
      static_cast<T*>(a.out)[col] =
          from_f<T>(f[0] * (1.0f / (1.0f + expf(-f[0]))) * f[NW - 1]);
    }
  };
  if (S == 1)
    __syncthreads();
  else
    cluster.sync();                         // every split's sums are in
  for (int c = tid; c < cw; c += THREADS) {
    float f[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      float s = 0.f;
      for (int r = 0; r < S; ++r) s += part[(r * NW + w) * cw + c];
      f[w] = s;
    }
    if (split * cw + c < valid) finish(split * cw + c, f);
  }
}

// --- rows form --------------------------------------------------------

constexpr int RG = 128;          // the rows form's group size
constexpr int MAXB = 16;         // input rows: the MMA's M
constexpr int RT = 64;           // output columns a block
constexpr int MAXC = 8;          // blocks a cluster (the portable size)
constexpr int MAXS = 4;          // splits of the kept groups of a tile
constexpr int MAXNST = 8;        // ring stages, at most
constexpr int SM_SMEM = 233472;  // an SM's, of which 1 KB a resident block's

// Shared-memory layout of the rows kernel, bytes from the (128-byte
// aligned) base. A ring stage holds one kept group: NW weight slabs (rows
// padded by 16 bytes, so the lanes of a fragment load hit distinct banks;
// packed int4: 64 rows, then its scale and zero rows), the group's B raw
// input rows (row stride padded likewise; rows B..15 stay zero) and its
// gains. After the loop the ring holds the per-warp sums. The wrapper's
// `_rows_smem` mirrors `total`; the card tests hold the two together
// through `teal_sgg_rows_plan`.
struct RowsLayout {
  int wstride, wslab, xstride, stage, pall, ssq, rs, scores, idx, total;
  __host__ __device__ RowsLayout(int esz, int plan, int nw, int nst, int S,
                                 int C, int nb, int cap) {
    const int wrows = plan == PLAN_INT4 ? RG / 2 : RG;
    wstride = RT * (plan == PLAN_STREAM ? esz : 1) + 16;
    wslab = wrows * wstride + (plan == PLAN_INT4 ? 2 * RT * 4 : 0);
    xstride = RG * esz + 16;
    stage = nw * wslab + MAXB * xstride + RG * esz;
    const int ring = nst * stage;
    const int red = NWARPS * nw * MAXB * RT * 4;    // [warp][w][b][col]
    pall = ring > red ? ring : red;                 // [S][w][b][RT / S]
    ssq = pall + (S > 1 ? nw * MAXB * RT * 4 : 0);  // [C][MAXB] partials
    rs = ssq + C * MAXB * 4;                        // [MAXB] row scales
    scores = rs + MAXB * 4;                         // [nb]
    idx = scores + pad4(nb) * 4;                    // [cap] + count
    total = idx + pad4(cap + 1) * 4;
  }
};

// The launch plan, from shapes only: S splits of a tile's kept groups
// (the largest power of two <= MAXS keeping the grid within one block an
// SM: a grid of 2 * 128 blocks in clusters of 8 does not fit the H100's
// GPCs at once), C = S * (tiles a cluster) blocks a cluster (the largest
// power of two <= MAXC whose tiles divide the output), and the deepest
// ring (<= MAXNST stages) that leaves room for two blocks an SM (at one
// block an SM only 15 clusters of 8 fit the H100 at once), else that fits
// one block. smem is -1 where the widths are not whole tiles or nothing
// fits.
struct RowsPlan { int S, C, nst, smem; };

RowsPlan rows_plan(int esz, int plan, int nw, int K, int n_out, int cap,
                   int n_sms) {
  RowsPlan p = {0, 0, 0, -1};
  if (n_out % RT || K % RG || n_out <= 0) return p;
  const int tiles = n_out / RT;
  int S = 1;
  while (S < MAXS && tiles * 2 * S <= n_sms) S *= 2;
  int tc = 1;
  while (tc * 2 * S <= MAXC && tiles % (tc * 2) == 0) tc *= 2;
  for (int pass = 0; pass < 2; ++pass)
    for (int nst = MAXNST; nst >= 2; --nst) {
      const int smem =
          RowsLayout(esz, plan, nw, nst, S, tc * S, K / RG, cap).total;
      if (pass == 0 ? 2 * (smem + 1024) <= SM_SMEM : smem <= SMEM_MAX) {
        p = {S, tc * S, nst, smem};
        return p;
      }
    }
  return p;
}

// bf16: two blocks an SM (128 registers a thread), as the plan assumes
template <typename T, int P, bool PAIR>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 2 : 1)
    sgg_rows_kernel(Args a) {
  constexpr int NW = PAIR ? 2 : 1;
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int WESZ = P == PLAN_STREAM ? ESZ : 1;  // bytes a stored weight
  constexpr int EPV = 16 / ESZ;                     // inputs a 16-byte chunk
  constexpr int CPG = RG / EPV;                     // chunks of a group row
  constexpr int WROWS = P == PLAN_INT4 ? RG / 2 : RG;
  constexpr int WCH = RT * WESZ / 16;               // chunks of a weight row
  constexpr bool MMA = ESZ == 2;                    // bf16: tensor cores
  extern __shared__ __align__(128) unsigned char sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = a.S, C = a.C, NST = a.nst;
  const int rank = static_cast<int>(cluster.block_rank());
  const int K = a.K, nb = K / RG, B = a.B;
  const RowsLayout lay(ESZ, P, NW, NST, S, C, nb, a.cap);
  float* ssq = reinterpret_cast<float*>(sm + lay.ssq);
  float* rs = reinterpret_cast<float*>(sm + lay.rs);
  float* scores = reinterpret_cast<float*>(sm + lay.scores);
  int* idx = reinterpret_cast<int*>(sm + lay.idx);
  const T* x = static_cast<const T*>(a.x);
  const size_t layer = read_layer(a);
  const T* gain = a.norm == nullptr
                      ? nullptr
                      : static_cast<const T*>(a.norm) + layer * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. the prologue, once per cluster: block `rank` takes groups
  // [g0, g1); its norm partial sums and scores go into every peer's
  // shared memory, combined in rank order, so every block of the cluster
  // holds the same row scales and scores and keeps the same groups.
  cluster_arrive_relaxed();
  for (int s = 0; s < NST; ++s) {
    uint4* z = reinterpret_cast<uint4*>(sm + s * lay.stage +
                                        NW * lay.wslab + B * lay.xstride);
    for (int i = tid; i < (MAXB - B) * lay.xstride / 16; i += THREADS)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  const int g0 = nb * rank / C, g1 = nb * (rank + 1) / C;
  // A lane's chunks of a group: chunk kc = lane % CPG of rows
  // (lane + 32 i) / CPG, all loaded before the first is used. Where each
  // warp scores at most one group (`one`), its chunks stay in registers
  // from the norm's sums of squares to the scores: one pass over x.
  constexpr int MAXL = MAXB * CPG / 32;
  const int kc = lane % CPG;
  const bool one = !a.fixed && g1 - g0 <= NWARPS;
  uint4 raw[MAXL];
  float gv[EPV];
  auto load_group = [&](int g) {
    if (gain != nullptr) load_row<T, EPV>(gain + g * RG + kc * EPV, gv);
#pragma unroll
    for (int i = 0; i < MAXL; ++i)
      if (lane + 32 * i < B * CPG)
        raw[i] = __ldg(reinterpret_cast<const uint4*>(
            x + static_cast<size_t>((lane + 32 * i) / CPG) * K + g * RG +
            kc * EPV));
  };
  // pooled score of group g from raw: max |selection input| over its
  // lanes and rows, pushed into every peer's scores
  auto score = [&](int g) {
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < MAXL; ++i) {
      if (lane + 32 * i >= B * CPG) break;
      const int b = (lane + 32 * i) / CPG;
      const T* v = reinterpret_cast<const T*>(&raw[i]);
#pragma unroll
      for (int e = 0; e < EPV; ++e)
        m = fmaxf(m, fabsf(gain == nullptr
                               ? to_f(v[e])
                               : rnd<T>(rnd<T>(to_f(v[e]) * rs[b]) * gv[e])));
    }
    m = warp_max(m);
    if (lane < C) cluster.map_shared_rank(scores, lane)[g] = m;
  };
  if (one && g0 + warp < g1) load_group(g0 + warp);
  if (gain != nullptr) {
    if (one) {
      // per-row sums of squares of the warp's group (the CPG lanes of a
      // row chunk by chunk, then a butterfly), added in warp order
      float* part = reinterpret_cast<float*>(sm);   // the ring is free
      if (g0 + warp < g1) {
#pragma unroll
        for (int i = 0; i < MAXL; ++i) {
          float ss = 0.f;
          if (lane + 32 * i < B * CPG) {
            const T* v = reinterpret_cast<const T*>(&raw[i]);
#pragma unroll
            for (int e = 0; e < EPV; ++e) ss = fmaf(to_f(v[e]), to_f(v[e]),
                                                    ss);
          }
#pragma unroll
          for (int o = 1; o < CPG; o <<= 1)
            ss += __shfl_xor_sync(0xffffffffu, ss, o);
          if (kc == 0 && lane + 32 * i < B * CPG)
            part[warp * MAXB + (lane + 32 * i) / CPG] = ss;
        }
      }
      __syncthreads();
      if (tid < B) {
        float ss = 0.f;
        for (int w = 0; w < g1 - g0; ++w) ss += part[w * MAXB + tid];
        rs[tid] = ss;
      }
    } else {
      for (int b = warp; b < B; b += NWARPS) {
        const T* xb = x + static_cast<size_t>(b) * K;
        float ss = 0.f;
#pragma unroll 4
        for (int c = g0 * CPG + lane; c < g1 * CPG; c += 32) {
          float v[EPV];
          load_row<T, EPV>(xb + c * EPV, v);
#pragma unroll
          for (int e = 0; e < EPV; ++e) ss = fmaf(v[e], v[e], ss);
        }
        ss = warp_sum(ss);
        if (lane == 0) rs[b] = ss;
      }
    }
  }
  __syncthreads();
  cluster_wait();
  if (gain != nullptr) {
    for (int i = tid; i < C * B; i += THREADS)
      cluster.map_shared_rank(ssq, i / B)[rank * MAXB + i % B] = rs[i % B];
    cluster.sync();
    // rsqrtf, as the reference's rsqrt rounds on the card (torch.rsqrt):
    // a row scale one ulp away moves a bf16 selection input near a
    // rounding point by one bf16 ulp
    if (tid < MAXB) {
      float s = 0.f;
      for (int r = 0; r < C; ++r) s += ssq[r * MAXB + tid];
      rs[tid] = tid < B ? rsqrtf(s / static_cast<float>(K) + a.eps) : 0.f;
    }
    __syncthreads();
  }
  if (!a.fixed) {
    if (one) {
      if (g0 + warp < g1) score(g0 + warp);
    } else {
      for (int g = g0 + warp; g < g1; g += NWARPS) {
        load_group(g);
        score(g);
      }
    }
    cluster.sync();
  }
  const int count = select_scan(a, scores, nb, idx, idx + a.cap);

  // 2. the gather: this block's share [j0, j0 + mine) of the kept list,
  // one group a ring stage (cp.async: weight slabs, input rows, gains)
  const int split = static_cast<int>(blockIdx.x) % S;
  const int c0 = static_cast<int>(blockIdx.x) / S * RT;
  int wsel[NW];
  int off, N;
  tile_weights<NW>(a, c0, wsel, off, N);
  const int j0 = count * split / S, mine = count * (split + 1) / S - j0;
  const size_t krows = P == PLAN_INT4 ? K / 2 : K;
  // a thread's 16-byte chunks of a weight slab, as offsets from the
  // group's first row (global) and the slab (shared), fixed for the call
  constexpr int WCPT = WROWS * WCH / THREADS;       // chunks a thread
  static_assert(WROWS * WCH % THREADS == 0, "whole chunks a thread");
  size_t wsrc[WCPT];
  int wdst[WCPT];
#pragma unroll
  for (int k = 0; k < WCPT; ++k) {
    const int c = tid + k * THREADS;
    wsrc[k] = static_cast<size_t>(c / WCH) * N * WESZ + (c % WCH) * 16;
    wdst[k] = (c / WCH) * lay.wstride + (c % WCH) * 16;
  }
  auto fetch = [&](int j) {
    if (j < mine) {
      const int g = idx[j0 + j];
      unsigned char* st = sm + (j % NST) * lay.stage;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const unsigned char* src =
            static_cast<const unsigned char*>(a.w[wsel[w]]) +
            ((layer * krows + static_cast<size_t>(g) * WROWS) * N + off) *
                WESZ;
        unsigned char* dst = st + w * lay.wslab;
#pragma unroll
        for (int k = 0; k < WCPT; ++k)
          cp_async16(dst + wdst[k], src + wsrc[k]);
        if constexpr (P == PLAN_INT4) {
          if (tid < 2 * RT / 4)
            cp_async16(dst + WROWS * lay.wstride + tid * 16,
                       a.sz[wsel[w]] +
                           ((layer * nb + g) * 2 + tid / (RT / 4)) * N + off +
                           (tid % (RT / 4)) * 4);
        }
      }
      unsigned char* xd = st + NW * lay.wslab;
      for (int c = tid; c < B * CPG; c += THREADS)
        cp_async16(xd + (c / CPG) * lay.xstride + (c % CPG) * 16,
                   x + static_cast<size_t>(c / CPG) * K + g * RG +
                       (c % CPG) * EPV);
      if (gain != nullptr && tid < CPG)
        cp_async16(xd + MAXB * lay.xstride + tid * 16,
                   gain + g * RG + tid * EPV);
    }
    cp_async_commit();
  };

  // acc[w][t][i]: bf16, MMA n-tile t's accumulator i (row lane/4 + 8 *
  // (i / 2), tile column (2 * (lane % 4) + i % 2) * 8 + t); fp32 FMAs:
  // row (lane / 8) * 4 + i, tile column (lane % 8) * 8 + t
  float acc[NW][8][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[w][t][i] = 0.f;

  auto compute = [&](const unsigned char* st) {
    const unsigned char* xs = st + NW * lay.wslab;
    const T* gs = reinterpret_cast<const T*>(xs + MAXB * lay.xstride);
    if constexpr (MMA) {
      // A: the warp's 16 rows of the group for the 16 input rows, then
      // the selection input applied in registers (each element once)
      uint32_t af[4];
      {
        const int mi = lane >> 3;
        ldsm_x4(af, xs + ((lane & 7) + (mi & 1) * 8) * lay.xstride +
                        (8 * warp + (mi >> 1) * 64) * 2);
      }
      if (gain != nullptr) {
        const int q = lane & 3, r = lane >> 2;
        const uint32_t glo =
            *reinterpret_cast<const uint32_t*>(gs + 8 * warp + 2 * q);
        const uint32_t ghi =
            *reinterpret_cast<const uint32_t*>(gs + 64 + 8 * warp + 2 * q);
        af[0] = sel2(af[0], rs[r], glo);
        af[1] = sel2(af[1], rs[r + 8], glo);
        af[2] = sel2(af[2], rs[r], ghi);
        af[3] = sel2(af[3], rs[r + 8], ghi);
      }
      float sx[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (P == PLAN_INT4)      // the warp's sum of x per row
        mma16816(sx, af, 0x3F803F80u, 0x3F803F80u);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const unsigned char* W = st + w * lay.wslab;
        uint32_t bf[8][2];
        gather_b_frags<P, RG / 2>(W, lay.wstride, 8 * warp, bf);
        if constexpr (P == PLAN_INT4) {
          // (x @ nib) * scale + sum(x) * zero, the group's own sums
          // scale row, then zero row; columns (2q + e) * 8 + t, four
          // tiles (16 bytes) a load
          const float* sz = reinterpret_cast<const float*>(W + WROWS *
                                                               lay.wstride) +
                            2 * (lane & 3) * 8;
#pragma unroll
          for (int h = 0; h < 8; h += 4) {
            const float4 s0 = *reinterpret_cast<const float4*>(sz + h);
            const float4 s1 = *reinterpret_cast<const float4*>(sz + 8 + h);
            const float4 z0 = *reinterpret_cast<const float4*>(sz + RT + h);
            const float4 z1 =
                *reinterpret_cast<const float4*>(sz + RT + 8 + h);
            const float sc0[4] = {s0.x, s0.y, s0.z, s0.w};
            const float sc1[4] = {s1.x, s1.y, s1.z, s1.w};
            const float zr0[4] = {z0.x, z0.y, z0.z, z0.w};
            const float zr1[4] = {z1.x, z1.y, z1.z, z1.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              float p[4] = {0.f, 0.f, 0.f, 0.f};
              mma16816(p, af, bf[h + u][0], bf[h + u][1]);
              float* c = acc[w][h + u];
              c[0] = fmaf(p[0], sc0[u], fmaf(sx[0], zr0[u], c[0]));
              c[1] = fmaf(p[1], sc1[u], fmaf(sx[1], zr1[u], c[1]));
              c[2] = fmaf(p[2], sc0[u], fmaf(sx[2], zr0[u], c[2]));
              c[3] = fmaf(p[3], sc1[u], fmaf(sx[3], zr1[u], c[3]));
            }
          }
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t) mma16816(acc[w][t], af, bf[t][0],
                                               bf[t][1]);
        }
      }
    } else {
      // fp32 stream: FMAs (TF32 would not hold 1e-4); lane: rows b4..b4+3,
      // tile columns c8..c8+7, over the warp's 16 rows of the group
      const int b4 = (lane >> 3) * 4, c8 = (lane & 7) * 8;
      const float* xf = reinterpret_cast<const float*>(xs);
      const int xr = lay.xstride / 4;
      auto xin = [&](int i, int k) {
        const float v = xf[(b4 + i) * xr + k];
        return gain == nullptr ? v : (v * rs[b4 + i]) * to_f(gs[k]);
      };
      if constexpr (P == PLAN_INT4) {
        float p[NW][8][4], sx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int w = 0; w < NW; ++w)
#pragma unroll
          for (int t = 0; t < 8; ++t)
#pragma unroll
            for (int i = 0; i < 4; ++i) p[w][t][i] = 0.f;
#pragma unroll 2
        for (int r = 0; r < 8; ++r) {
          const int pr = 8 * warp + r;
          float xlo[4], xhi[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            xlo[i] = xin(i, pr);
            xhi[i] = xin(i, pr + 64);
            sx[i] += xlo[i] + xhi[i];
          }
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            const uint2 q2 = *reinterpret_cast<const uint2*>(
                st + w * lay.wslab + pr * lay.wstride + c8);
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              const uint32_t bt = ((t < 4 ? q2.x : q2.y) >> ((t & 3) * 8));
              const float nlo = static_cast<float>(bt & 15u);
              const float nhi = static_cast<float>((bt >> 4) & 15u);
#pragma unroll
              for (int i = 0; i < 4; ++i)
                p[w][t][i] = fmaf(xhi[i], nhi, fmaf(xlo[i], nlo, p[w][t][i]));
            }
          }
        }
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const float* sc = reinterpret_cast<const float*>(
              st + w * lay.wslab + WROWS * lay.wstride);
#pragma unroll
          for (int t = 0; t < 8; ++t)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[w][t][i] = fmaf(p[w][t][i], sc[c8 + t],
                                  fmaf(sx[i], sc[RT + c8 + t], acc[w][t][i]));
        }
      } else {
#pragma unroll 2
        for (int r = 0; r < 16; ++r) {
          const int k = r < 8 ? 8 * warp + r : 64 + 8 * warp + r - 8;
          float xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = xin(i, k);
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            const unsigned char* row =
                st + w * lay.wslab + k * lay.wstride + c8 * WESZ;
            float wv[8];
            if constexpr (P == PLAN_INT8) {
              const uint2 q2 = *reinterpret_cast<const uint2*>(row);
#pragma unroll
              for (int t = 0; t < 8; ++t)
                wv[t] = static_cast<float>(static_cast<int8_t>(
                    (t < 4 ? q2.x : q2.y) >> ((t & 3) * 8)));
            } else {
              const float4 lo = *reinterpret_cast<const float4*>(row);
              const float4 hi = *reinterpret_cast<const float4*>(row + 16);
              wv[0] = lo.x; wv[1] = lo.y; wv[2] = lo.z; wv[3] = lo.w;
              wv[4] = hi.x; wv[5] = hi.y; wv[6] = hi.z; wv[7] = hi.w;
            }
#pragma unroll
            for (int t = 0; t < 8; ++t)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                acc[w][t][i] = fmaf(xv[i], wv[t], acc[w][t][i]);
          }
        }
      }
    }
  };

  for (int j = 0; j < NST - 1; ++j) fetch(j);
  for (int j = 0; j < mine; ++j) {
    cp_async_wait_dyn(NST - 2);
    __syncthreads();       // stage j landed; stage j-1 is free again
    fetch(j + NST - 1);
    compute(sm + (j % NST) * lay.stage);
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3. fixed-order sums: over warps, then (S > 1) over the tile's splits,
  // each block combining RT / S columns from its peers' pushes in split
  // order; the int8 scale, then the epilogue. No atomics. The per-warp
  // sums go through shared memory in accumulator order (slot (i, t,
  // lane)), so both the stores and the warp-order sums are free of bank
  // conflicts; `slot` maps a slot to its row and tile column.
  float* red = reinterpret_cast<float*>(sm);      // [warp][w][4][8][32]
  constexpr int SLOTS = 4 * 8 * 32;
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[(warp * NW + w) * SLOTS + (i * 8 + t) * 32 + lane] = acc[w][t][i];
  __syncthreads();
  auto slot = [&](int sl, int& b, int& col) {
    const int i = sl >> 8, t = (sl >> 5) & 7, ln = sl & 31;
    b = MMA ? (ln >> 2) + (i >> 1) * 8 : (ln >> 3) * 4 + i;
    col = MMA ? (2 * (ln & 3) + (i & 1)) * 8 + t : (ln & 7) * 8 + t;
  };
  auto finish = [&](int b, int c, float (&f)[NW]) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* sc = a.scale[wsel[w]];
      if (sc != nullptr) f[w] *= sc[layer * N + off + c];
    }
    const size_t at = static_cast<size_t>(b) * a.n_out + c0 + c;
    if (a.mode == 0) {
      static_cast<float*>(a.out)[at] = f[0];
    } else if (a.mode == 1) {
      static_cast<T*>(a.out)[at] =
          from_f<T>(f[0] + to_f(static_cast<const T*>(a.res)[at]));
    } else {
      static_cast<T*>(a.out)[at] =
          from_f<T>(f[0] * (1.0f / (1.0f + expf(-f[0]))) * f[NW - 1]);
    }
  };
  float* pall = reinterpret_cast<float*>(sm + lay.pall);
  const int cw = RT / S;
  for (int sl = tid; sl < SLOTS; sl += THREADS) {
    int b, col;
    slot(sl, b, col);
    if (b >= B) continue;
    float f[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      float s = 0.f;
      for (int wp = 0; wp < NWARPS; ++wp) s += red[(wp * NW + w) * SLOTS + sl];
      f[w] = s;
    }
    if (S == 1) {
      finish(b, col, f);
    } else {
      float* dst = cluster.map_shared_rank(pall, rank - split + col / cw);
#pragma unroll
      for (int w = 0; w < NW; ++w)
        dst[((split * NW + w) * MAXB + b) * cw + col % cw] = f[w];
    }
  }
  if (S > 1) {
    cluster.sync();        // every split's part is in; no peer access after
    for (int o = tid; o < B * cw; o += THREADS) {
      const int b = o / cw, cl = o % cw;
      float f[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        float s = 0.f;
        for (int sp = 0; sp < S; ++sp)
          s += pall[((sp * NW + w) * MAXB + b) * cw + cl];
        f[w] = s;
      }
      finish(b, split * cw + cl, f);
    }
  }
}

int device_sms() {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

// Occupancy checks already made: (kernel, C, shared bytes) -> clusters.
struct OccEntry { const void* fn; int C, smem, clusters; };
OccEntry occ_cache[64];
int occ_n = 0;

// The rows kernel's launch for a0's shapes: its arguments with the plan,
// its configuration (cfg.attrs points at attr) and the clusters of it
// that can be resident at once (cudaOccupancyMaxActiveClusters, cached).
template <typename T, int P, bool PAIR>
int rows_setup(const Args& a0, cudaStream_t stream, Args& a,
               cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1],
               int& clusters) {
  constexpr int NW = PAIR ? 2 : 1;
  const RowsPlan p = rows_plan(sizeof(T), P, NW, a0.K, a0.n_out, a0.cap,
                               device_sms());
  if (p.smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  a = a0;
  a.S = p.S;
  a.C = p.C;
  a.nst = p.nst;
  auto fn = sgg_rows_kernel<T, P, PAIR>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  cfg = {};
  cfg.gridDim = dim3(a.n_out / RT * p.S, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  clusters = -1;
  for (int i = 0; i < occ_n; ++i)
    if (occ_cache[i].fn == reinterpret_cast<const void*>(fn) &&
        occ_cache[i].C == p.C && occ_cache[i].smem == p.smem)
      clusters = occ_cache[i].clusters;
  if (clusters < 0) {
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (occ_n < 64)
      occ_cache[occ_n++] = {reinterpret_cast<const void*>(fn), p.C, p.smem,
                            clusters};
  }
  return 0;
}

template <typename T, int P, bool PAIR>
int launch_rows(const Args& a0, cudaStream_t stream) {
  Args a;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int clusters;
  const int err = rows_setup<T, P, PAIR>(a0, stream, a, cfg, attr, clusters);
  if (err != 0) return err;
  if (clusters < 1) return -1;             // the cluster cannot be placed
  const cudaError_t e = cudaLaunchKernelEx(&cfg, sgg_rows_kernel<T, P, PAIR>,
                                           a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P, bool PAIR>
int rows_residency(int K, int n_out, int cap, int* out) {
  Args a0 = {};
  a0.K = K;
  a0.n_out = n_out;
  a0.cap = cap;
  Args a = {};
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  int clusters = 0;
  const int err =
      rows_setup<T, P, PAIR>(a0, nullptr, a, cfg, attr, clusters);
  out[0] = static_cast<int>(cfg.gridDim.x);
  out[1] = a.C;
  out[2] = clusters;
  return err;
}

template <typename T, int P>
int residency_pair(int pair, int K, int n_out, int cap, int* out) {
  return pair ? rows_residency<T, P, true>(K, n_out, cap, out)
              : rows_residency<T, P, false>(K, n_out, cap, out);
}

template <typename T>
int residency_plan(int plan, int pair, int K, int n_out, int cap,
                   int* out) {
  switch (plan) {
    case PLAN_STREAM:
      return residency_pair<T, PLAN_STREAM>(pair, K, n_out, cap, out);
    case PLAN_INT8:
      return residency_pair<T, PLAN_INT8>(pair, K, n_out, cap, out);
    case PLAN_INT4:
      return residency_pair<T, PLAN_INT4>(pair, K, n_out, cap, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The single-row kernel's launch: one cluster launch of tiles * S blocks
// in clusters of C, with the plan from the shapes.
template <typename T, int P, bool PAIR, int G>
int launch_stream(const Args& a0, cudaStream_t stream) {
  constexpr int NW = PAIR ? 2 : 1;
  const SggPlan p = sgg_plan(static_cast<int>(sizeof(T)), P, NW, G, a0.n,
                             a0.K, a0.cap, device_sms());
  if (p.smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a = a0;
  a.S = p.S;
  a.C = p.C;
  auto fn = sgg_stream_kernel<T, P, PAIR, G>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int tw = StreamLayout(sizeof(T), P, NW, G, 1, 1).tw;
  const int tiles = PAIR ? cdiv(a.n[0], tw)
                         : cdiv(a.n[0], tw) + cdiv(a.n[1], tw) +
                               cdiv(a.n[2], tw);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * p.S, 1, 1);
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

template <typename T, int P, bool PAIR, int G>
int launch(const Args& a, cudaStream_t stream) {
  if constexpr (G == RG) {
    if (a.B > 1) return launch_rows<T, P, PAIR>(a, stream);
  }
  return launch_stream<T, P, PAIR, G>(a, stream);
}

template <typename T, int P, int G>
int launch_mode(const Args& a, cudaStream_t s) {
  return a.mode == 2 ? launch<T, P, true, G>(a, s)
                     : launch<T, P, false, G>(a, s);
}

template <typename T, int G>
int dispatch(int plan, const Args& a, cudaStream_t s) {
  switch (plan) {
    case PLAN_STREAM: return launch_mode<T, PLAN_STREAM, G>(a, s);
    case PLAN_INT8: return launch_mode<T, PLAN_INT8, G>(a, s);
    case PLAN_INT4:
      if constexpr (G >= 64)
        return launch_mode<T, PLAN_INT4, G>(a, s);
      else
        return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int G>
int dispatch_type(int dtype, int plan, const Args& a, cudaStream_t s) {
  return dtype == 0 ? dispatch<float, G>(plan, a, s)
                    : dispatch<__nv_bfloat16, G>(plan, a, s);
}

}  // namespace

// The single-row kernel's launch plan for a stream of type dtype (0
// fp32, 1 bf16), weight plan `plan`, `pair` (mode 2: two weights), group
// size G, output widths n0..n2 (n_w of them), input dim K, cap and an SM
// count: out = {S, C, ring stages, shared bytes a block}; shared bytes -1
// where the shapes take no plan.
extern "C" int teal_sgg_plan(int dtype, int plan, int pair, int G, int n0,
                             int n1, int n2, int n_w, int K, int cap,
                             int n_sms, int* out) {
  const int n[3] = {n0, n_w > 1 ? n1 : 0, n_w > 2 ? n2 : 0};
  const SggPlan p = sgg_plan(dtype == 0 ? 4 : 2, plan, pair ? 2 : 1, G, n, K,
                             cap, n_sms);
  out[0] = p.S;
  out[1] = p.C;
  out[2] = p.nst;
  out[3] = p.smem;
  return 0;
}

// The rows form's launch plan for a stream of type dtype (0 fp32, 1
// bf16), weight plan `plan`, `pair` (mode 2: two weights), input dim K,
// n_out output columns, cap and an SM count: out = {S, C, ring stages,
// shared bytes a block}; shared bytes -1 where no plan fits.
extern "C" int teal_sgg_rows_plan(int dtype, int plan, int pair, int K,
                                  int n_out, int cap, int n_sms, int* out) {
  const RowsPlan p = rows_plan(dtype == 0 ? 4 : 2, plan, pair ? 2 : 1, K,
                               n_out, cap, n_sms);
  out[0] = p.S;
  out[1] = p.C;
  out[2] = p.nst;
  out[3] = p.smem;
  return 0;
}

// On this card, for the rows form's plan: out = {blocks of the grid,
// blocks a cluster, clusters that can be resident at once}; the card
// tests check that the whole grid is.
extern "C" int teal_sgg_rows_residency(int dtype, int plan, int pair, int K,
                                       int n_out, int cap, int* out) {
  cudaGetLastError();
  return dtype == 0
             ? residency_plan<float>(plan, pair, K, n_out, cap, out)
             : residency_plan<__nv_bfloat16>(plan, pair, K, n_out, cap, out);
}

// dtype: 0 fp32, 1 bf16 (the stream x, norm, res and the mode 1/2
// output). plan: 0 weights of the stream type, 1 int8, 2 packed int4
// (w_i the packed rows, sz_i their [scale, zero] rows; G 64 or 128).
// scale_i: int8 per-channel scales [L, n_i] applied to the sums, or
// null. mode: 0 raw fp32 out, 1 residual, 2 silu pair, 3 weighted
// residual (route_w[slot] * sums + res; one row). G: 32, 64 or 128 (else
// cudaErrorInvalidValue). rows: input rows B, contiguous [B, K]; out and
// res are [B, n_out]; rows > 1 needs G == 128, rows <= 16 and
// widths that are multiples of 64 (returns -1 where no cluster of the
// plan can be placed on the card). fixed: keep
// groups 0..cap-1. layer_dev: null (read `layer`) or int32 device layers,
// entry `slot` read by the kernel; L: the stacks' layers. The caller
// checks shapes: K % G == 0, every n_i % 32 == 0, pointers 16-byte
// aligned (x and norm too), mode 2 with two weights of equal width, one
// plan for all weights, a host layer in [0, L), no norm with a device
// layer.
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
  auto s = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 32: return dispatch_type<32>(dtype, plan, a, s);
    case 64: return dispatch_type<64>(dtype, plan, a, s);
    case 128: return dispatch_type<128>(dtype, plan, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
