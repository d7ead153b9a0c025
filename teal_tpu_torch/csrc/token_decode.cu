// K7: single-token decode of the whole layer stack in ONE persistent
// launch, for one row (batch 1) with weights, stream and cache of one type
// (fp32 or bf16), G = 128, threshold or fixed selection, a dense MLP,
// head_dim 128 (MHA or GQA, Hq / Hkv of 1, 2, 4 or 8) and an optional
// sliding window.
//
// Replaces the Pallas kernel `_token_kernel` (teal_tpu/ops/token_block.py:
// 186, launched by `token_decode` at :518), whose grid steps run the layers
// in order with the residual stream in VMEM. Each layer computes, as
// `_token_kernel` does (token_block.py:222-343), with the cast points of
// the K1/K2 loop that runs the same layer:
//   1. the attention stage (`attn_block.attn_stage`): the folded attention
//      rms_norm ((x * rsqrt(mean(x^2) + eps)) -> T, * gain -> T), max-|x|
//      group scores, THE selection rule (threshold column 0; `fixed` keeps
//      groups 0..cap-1), the q|k|v gather GEMV in fp32, RoPE from the fp32
//      sums (q then scaled by 1/sqrt(128)), this token's K/V written at
//      `pos` into [L, 1, Hkv, T, 128], and GQA attention over the live rows
//      t < pos (t > pos - window) plus the current token: slab scores of q
//      rounded to T, ONE max over all of them before any exp, the weights
//      rounded to T for the PV product, the denominator of the unrounded
//      ones, the output in T;
//   2. o (column 3): out = T(sums + h) into the stream;
//   3. gate|up (column 4) with the folded mlp norm: T(silu(gate) * up);
//   4. down (column 6): out = T(sums + h).
//
// Bound: the bytes of the kept weight slabs (the cache rows and the rest
// are small at decode), so the design keeps the SMs streaming and cuts what
// each layer pays beside the stream. A cooperative grid of clusters of C
// blocks (one block an SM, all resident: C and the clusters come from
// what cudaOccupancyMaxActiveClusters gives for each C, `token_plan`), 288
// threads a block: eight worker warps and one producer warp.
//   - The same kept set in every block: every block folds, scores and
//     scans the same values in the same order; block 0 records it (`sel`).
//   - Column-owned gather stages: cluster c owns a contiguous range of the
//     stage's output columns in 256-byte units (as even as the units
//     allow), and its C blocks split the kept rows in rank order. The
//     producer warp issues the slab rows as TMA boxes of 32 rows x 256
//     bytes over a 2-D map of each [L K, N] weight, with the L2
//     evict-first hint (the weights stream once a token and must not push
//     the stream and the cache rows out of L2), into a ring of 16 KB slots
//     that complete on mbarriers; the workers only convert and FMA in
//     fp32. (Boxes of 64 bytes, four side by side, ran 10% slower a token:
//     the request size, not the SMs' count, bounds the gathers.) A block's
//     sums of a unit (its row lanes, then its warps, in order) go to its
//     shared `part`; after a cluster barrier each block adds its slice of
//     the columns over the cluster's blocks in rank order through
//     distributed shared memory (mapa / ld.shared::cluster) and writes each
//     final value once in T to the workspace: the stream for o and down
//     (T(sums + h)), the intermediate for gate|up (both weights at the same
//     columns, so T(silu(gate) * up) is formed there). After the grid
//     barrier every block reads the stream (or the intermediate, or the
//     attention output) once. No data atomics: every sum has a fixed order.
//   - q|k|v and attention: in the head-owned plan (a cluster for each kv
//     head, `token_plan`) cluster c owns kv head c: its k and v columns and
//     the q columns of its Hq / Hkv query heads; every block of it adds the
//     cluster's partial sums (rank order) into the head's fp32 q|k|v,
//     applies RoPE, block 0 of the cluster writes this token's K/V at
//     `pos`, and the blocks split the live cache rows: maxima, then partial
//     PV and denominators, exchanged through distributed shared memory
//     behind cluster barriers (barrier.cluster arrive.release /
//     wait.acquire). The plan's column-owned stages run on the same
//     clusters. In the other plan (few kv heads) the q|k|v stage is
//     column-owned like the others and writes its fp32 sums to the
//     workspace; a grid barrier; then cluster c runs the attention of kv
//     heads c, c + NC, ... the same way.
// Grid barriers a layer: after attention, o, gate|up and down (four), and
// after q|k|v in the other plan (five); none among a kv head's blocks. A
// stage that keeps no group (every block finds the same) skips its gather,
// its sums and, but for down's, its barrier: o and down then leave the
// stream as it is, gate|up makes the intermediate 0 (two stream buffers
// in the workspace keep the skipped barriers safe). A barrier is a counter
// in the workspace (zeroed by a memset before the launch); every spin, on
// it or on an mbarrier, is bounded by %globaltimer and ends in a trap, so
// a missed arrival fails the run rather than hanging it. The kernel is
// built once for each count of query heads a kv head (one attention body
// each); its phases are inlined into it (measured 10% faster a token at
// pos 40 than with the gather, attention and helpers as calls, 2-5%
// slower at pos 2047 of 2048; PERF.md). With `empty` the
// kernel runs its barriers alone (their floor). The plan (cluster size,
// clusters, ring slots, shared and workspace bytes) comes from shapes and
// the card's resident clusters of each size (`token_plan`, exported as
// `teal_token_plan` and mirrored by the wrapper's `_token_plan`); `stamps`,
// where given, receives block 0's %globaltimer at the points NSTAMP lists,
// and every block's arrival at every grid barrier and end of its share of
// every gather.
#include "common.cuh"

#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is taken at run
                   // time through cudaGetDriverEntryPoint

using namespace teal;

namespace {

constexpr int THREADS = 288;           // 8 worker warps + the producer warp
constexpr int WORKERS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int NWORK = WORKERS / 32;    // worker warps
constexpr int HD = 128;                // head dim = group size
constexpr int UB = 256;                // bytes of a slab row in a TMA box:
                                       // a unit of a stage's columns
constexpr int BR = 32;                 // slab rows of a TMA box
constexpr int BOXB = BR * UB;          // bytes of a box
constexpr int SLOT = 2 * BOXB;         // bytes of a ring slot (16 KB)
constexpr int MAXSLOT = 8;             // ring slots at most
constexpr int MAXGH = 8;               // query heads a kv head
constexpr int MINC = 2, MAXC = 8;      // blocks a cluster (portable sizes)
constexpr int U = 8;                   // cache rows in flight a row lane
constexpr int MAXCH = 8;               // 16-byte chunks of h a thread
constexpr int SMEM_MAX = 232448;       // a block's shared memory on Hopper
constexpr int NBAR = 5;                // grid-barrier slots a layer
// trace stamps a layer (block 0): its start, each grid barrier's arrival
// and exit (slots: q|k|v in the other plan, attention, o, gate|up, down),
// each gather's start (after its selection) and end (its last slot used),
// each stage's end of the cluster sums, five points of attention; then
// every block's arrival at each barrier slot [NBAR][grid] and the end of
// its share of each gather stage [4][grid] (TRACE_ROWS rows a block)
constexpr int ST_GATHER = 1 + 2 * NBAR, ST_GEND = ST_GATHER + 4;
constexpr int ST_EPI = ST_GEND + 4, ST_ATTN = ST_EPI + 4;
constexpr int NSTAMP = ST_ATTN + 5;
constexpr int TRACE_ROWS = NBAR + 4;
constexpr unsigned long long SPIN_NS = 2000000000ull;   // 2 s

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int al16(int n) { return (n + 15) & ~15; }
__host__ __device__ constexpr size_t al256(size_t n) {
  return (n + 255) & ~static_cast<size_t>(255);
}
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// Shared memory, bytes: the ring (attention: the row lanes' PV sums [RPI]
// [GH][128] fp32), its full and empty mbarriers, the block's partial sums
// `part` [NW][columns of its cluster] fp32 (read by the cluster's peers),
// the warps' sums of a tile [8][2][256 bytes / esz] fp32, the stream h [D]
// and a stage's selection input [max(D, I)] of T, the scores, the kept
// groups, 64 floats of scratch, then attention's q|k|v sums [GH + 2][128]
// and RoPE'd q|k [GH + 1][128] fp32, q rounded [GH][128] T, four [8] fp32
// (current score, its weight, max, sum), the block's maxima [8] and
// partial PV and denominators [GH * 128 + 8] fp32 (read by the peers),
// and the score slice [GH][NS] fp32.
struct Layout {
  int bars, part, red, h, xs, scores, idx, misc, qraw, qf, qr, small, amax,
      apv, s, total;
  __host__ __device__ Layout(int esz, int D, int I, int GH, int capmax,
                             int NS, int partf, int nslot) {
    bars = nslot * SLOT;
    part = bars + 2 * MAXSLOT * 8;
    red = part + partf * 4;
    h = red + NWORK * 2 * (UB / esz) * 4;
    xs = h + al16(D * esz);
    scores = xs + al16(imax(D, I) * esz);
    idx = scores + pad4(imax(D, I) / HD) * 4;
    misc = idx + pad4(capmax + 1) * 4;
    qraw = misc + 64 * 4;
    qf = qraw + (GH + 2) * HD * 4;
    qr = qf + (GH + 1) * HD * 4;
    small = qr + al16(GH * HD * esz);
    amax = small + 4 * MAXGH * 4;
    apv = amax + MAXGH * 4;
    s = apv + (GH * HD + MAXGH) * 4;
    total = s + GH * NS * 4;
  }
};

// Workspace, bytes from its (256-byte aligned) base: the grid barrier's
// counter (a 128-byte line, zeroed before the launch), the q|k|v sums
// [(Hq + 2 Hkv) * 128] fp32 (the other plan), the stream [D], the
// attention output [Hq * 128] and the intermediate [I] of T.
struct WsLayout {
  size_t bar, qkv, h, h2, attn, inter, total;
  __host__ __device__ WsLayout(int esz, int D, int I, int Hq, int Hkv) {
    bar = 0;
    qkv = 256;
    h = al256(qkv + static_cast<size_t>(Hq + 2 * Hkv) * HD * 4);
    h2 = al256(h + static_cast<size_t>(D) * esz);
    attn = al256(h2 + static_cast<size_t>(D) * esz);
    inter = al256(attn + static_cast<size_t>(Hq) * HD * esz);
    total = al256(inter + static_cast<size_t>(I) * esz);
  }
};

struct TokPlan {
  int C, NC, head, grid, nslot, NS, partf, smem;   // smem -1: no plan
  size_t ws;
};

// The plan from shapes and nc[C], the clusters of C blocks that can be
// resident at once (C in [MINC, MAXC]; 0 where none), on n_sms SMs:
//   - the head-owned plan: Hkv clusters of the largest C with nc[C] >=
//     Hkv, where they hold at least half the SMs (2 C Hkv >= n_sms; on
//     the H100 the 7B's 32 kv heads take 32 clusters of 3: 30 of 4 fit).
//     Its column-owned stages run on the same Hkv clusters: then the
//     7B's o and down columns fall evenly on them (32 units of 256 bytes
//     over 32), where all 39 resident clusters of 3 would leave 7 idle
//     (measured 5% slower a token, PERF.md);
//   - else the other plan: nc[C] clusters of the largest C whose grid
//     (nc[C] C blocks) is within 1/16 of the largest such grid;
// NS = a block's score slice (its share of the most live rows, padded to
// 4); `part` holds the largest NW x (columns of a cluster) of the stages;
// the ring takes what shared memory is left, up to MAXSLOT slots of SLOT,
// at least two and at least attention's PV sums.
TokPlan token_plan(int esz, int D, int I, int Hq, int Hkv, int T, int window,
                   int capmax, int n_sms, const int* nc) {
  TokPlan p = {0, 0, 0, 0, 0, 0, 0, -1, 0};
  if (D <= 0 || I <= 0 || D % HD || I % HD || Hkv <= 0 || Hq != D / HD ||
      Hq % Hkv || MAXGH % (Hq / Hkv) || T < 1 || capmax < 1 ||
      capmax > imax(D, I) / HD || D * esz > 16 * MAXCH * THREADS)
    return p;
  const int GH = Hq / Hkv;
  int best = 0, co = 0, ch = 0;
  for (int c = MINC; c <= MAXC; ++c) {
    best = imax(best, c * nc[c]);
    if (nc[c] >= Hkv) ch = c;
  }
  for (int c = MAXC; c >= MINC && co == 0; --c)
    if (best > 0 && 16 * c * nc[c] >= 15 * best) co = c;
  const int head = ch > 0 && 2 * ch * Hkv >= n_sms;
  if (!head && co == 0) return p;
  const int C = head ? ch : co, NC = head ? Hkv : nc[C];
  const int live = window > 0 && window < T ? window : T;
  const int NS = pad4(cdiv(imax(live - 1, 1), C));
  const int uw = UB / esz;
  auto most = [&](int cols, int nw) { return nw * cdiv(cols / uw, NC) * uw; };
  const int partf = imax(imax(most(D, 1), most(I, 2)),
                         head ? (GH + 2) * HD
                              : most((Hq + 2 * Hkv) * HD, 1));
  const int rest = Layout(esz, D, I, GH, capmax, NS, partf, 0).total;
  const int nslot = imin(MAXSLOT, (SMEM_MAX - rest) / SLOT);
  const int rpi = WORKERS / (HD * esz / 16);
  if (nslot < 2 || nslot * SLOT < rpi * GH * HD * 4) return p;
  p = {C, NC, head, NC * C, nslot, NS, partf,
       Layout(esz, D, I, GH, capmax, NS, partf, nslot).total,
       WsLayout(esz, D, I, Hq, Hkv).total};
  return p;
}

struct Args {
  const void* x;          // [D] the token's embedding row, T
  const float* thr;       // [L, 7]
  const int* pos;         // [1]
  const float* cs;        // [2, 128] cos, sin at pos
  const void* na;         // [L, D] attention-norm gains, T
  const void* nm;         // [L, D] mlp-norm gains, T
  void* kc;               // [L, 1, Hkv, T, 128]
  void* vc;
  void* out;              // [D] the stream after the last layer
  int* sel;               // [L, 4, 1 + capmax] kept counts and groups, or null
  long long* stamps;      // [L, NSTAMP + NBAR grid] the trace, or null
  unsigned char* ws;
  int L, D, I, Hq, Hkv, T, window, fixed, empty;
  int cap[4], capmax;
  float eps, scale;
  int C, NC, head, grid, nslot, NS, partf;
};

// the seven weights' TMA maps: wq, wk, wv, wo, wgate, wup, wdown
struct Maps {
  CUtensorMap m[7];
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ int cluster_index() {
  int r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: the block's earlier writes
// (shared memory included) before the peers' later reads.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A shared address of this block as the same address in block `rank` of
// the cluster, and a load from it.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// (volatile, so never moved across a cluster barrier; no memory clobber,
// so that the loads of several sums are in flight together)
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// For each k < N with ok[k]: the sum over the cluster's C blocks, in rank
// order, of the float at shared address addr[k] in each (all loads in
// flight at once); 0 elsewhere.
template <int N>
__device__ __forceinline__ void cluster_sums(const uint32_t (&addr)[N],
                                             const bool (&ok)[N], int C,
                                             float (&out)[N]) {
  float v[N][MAXC];
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int q = 0; q < MAXC; ++q)
      if (ok[k] && q < C) v[k][q] = ld_cluster(mapa(addr[k], q));
#pragma unroll
  for (int k = 0; k < N; ++k) {
    out[k] = 0.f;
#pragma unroll
    for (int q = 0; q < MAXC; ++q)
      if (ok[k] && q < C) out[k] += v[k][q];
  }
}

// the workers alone (the producer warp is in its own loop)
__device__ __forceinline__ void workers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(WORKERS) : "memory");
}

// generic-proxy accesses of shared memory before later TMA writes to it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbarrier phase wait, bounded by SPIN_NS
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
__device__ __noinline__ void mbar_wait_slow(uint32_t bar, uint32_t parity) {
  const unsigned long long t0 = globaltimer();
  while (!mbar_try(bar, parity))
    if (globaltimer() - t0 > SPIN_NS) __trap();
}
__device__ __forceinline__ void mbar_wait_bounded(uint32_t bar,
                                                  uint32_t parity) {
  if (!mbar_try(bar, parity)) mbar_wait_slow(bar, parity);
}

__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// One thread: a box {256 bytes of columns from col, 32 rows from row} of a
// 2-D weight map into shared `dst`, completing on mbarrier `bar`, evicted
// first from L2.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, uint32_t bar,
                                         uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
         "r"(bar), "l"(policy)
      : "memory");
}

// Wait until `target` arrivals (this block's included) have reached the
// counter, as CUTLASS's GenericBarrier does: the block's threads meet,
// thread 0 arrives with a release (ordering the block's writes before it)
// and spins on an acquire load, and the block meets again, so every
// thread's later reads (through L2) see the other blocks' writes. A spin
// longer than SPIN_NS traps. `arrived` (or null) receives this block's
// %globaltimer at its arrival.
__device__ __forceinline__ void barrier(unsigned* ctr, unsigned target,
                                     long long* arrived) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long t0 = globaltimer();
    if (arrived != nullptr) *arrived = static_cast<long long>(t0);
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n"
                 :: "l"(ctr), "r"(1u) : "memory");
    while (ld_acquire(ctr) < target)
      if (globaltimer() - t0 > SPIN_NS) __trap();
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void st_cg(T* p, T v) {
  if constexpr (sizeof(T) == 4)
    __stcg(reinterpret_cast<float*>(p), *reinterpret_cast<float*>(&v));
  else
    __stcg(reinterpret_cast<unsigned short*>(p),
           *reinterpret_cast<unsigned short*>(&v));
}

// The kept groups of a stage's selection input xs [K] (T, shared): every
// block the same. Block 0 records them in `sel` row `row` (count, groups,
// -1 past the count). Returns the count.
template <typename T>
__device__ __forceinline__ int select_stage(const Args& a, const T* xs, int K,
                                         float thr, int cap, float* scores,
                                         int* idx, int l, int st) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = K / HD;
  if (!a.fixed) {
    for (int g = warp; g < nb; g += NWARPS) {
      float m = 0.f;
#pragma unroll
      for (int e = 0; e < HD / 32; ++e)
        m = fmaxf(m, fabsf(to_f(xs[g * HD + lane * (HD / 32) + e])));
      m = warp_max(m);
      if (lane == 0) scores[g] = m;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int c = ballot_select(scores, nb, thr, cap, a.fixed != 0, idx);
    if (lane == 0) idx[cap] = c;
  }
  __syncthreads();
  const int count = idx[cap];
  if (blockIdx.x == 0 && a.sel != nullptr) {
    int* row = a.sel + (static_cast<size_t>(l) * 4 + st) * (a.capmax + 1);
    for (int j = tid; j < a.capmax; j += THREADS)
      row[1 + j] = j < count ? idx[j] : -1;
    if (tid == 0) row[0] = count;
  }
  return count;
}

// A thread's 16-byte chunks of a gain vector [D], all in flight at once
// (D * esz <= 16 MAXCH THREADS bytes, which the plan checks): loaded
// before the grid barrier that precedes their fold.
template <typename T>
__device__ __forceinline__ void load_gains(const T* gain, int D,
                                           uint4 (&g)[MAXCH]) {
  const int nch = D * static_cast<int>(sizeof(T)) / 16;
#pragma unroll
  for (int k = 0; k < MAXCH; ++k)
    if (threadIdx.x + k * THREADS < nch)
      g[k] = __ldg(reinterpret_cast<const uint4*>(gain) + threadIdx.x +
                   k * THREADS);
}

// xs = T(T(h * rsqrt(mean(h^2) + eps)) * gain): the folded rms_norm, the
// sum of squares in a fixed order (the same in every block); g holds the
// thread's chunks of the gains (`load_gains`).
template <typename T>
__device__ __forceinline__ void fold(const T* h, const uint4 (&g)[MAXCH], int D,
                                  float eps, T* xs, float* misc) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));
  const int nch = D / EPC, tid = threadIdx.x;
  float ss = 0.f;
  for (int i = tid; i < D; i += THREADS) {
    const float v = to_f(h[i]);
    ss = fmaf(v, v, ss);
  }
  ss = block_sum(ss, misc);
  const float rs = rsqrtf(ss / static_cast<float>(D) + eps);
#pragma unroll
  for (int k = 0; k < MAXCH; ++k) {
    const int c = tid + k * THREADS;
    if (c < nch) {
      float hv[EPC], gv[EPC];
      unpack16(reinterpret_cast<const uint4*>(h)[c], hv);
      unpack16(g[k], gv);
#pragma unroll
      for (int e = 0; e < EPC; ++e) hv[e] = rnd<T>(rnd<T>(hv[e] * rs) * gv[e]);
      T* dst = xs + c * EPC;
#pragma unroll
      for (int e = 0; e < EPC; ++e) dst[e] = from_f<T>(hv[e]);
    }
  }
  __syncthreads();
}

// Copy n elements of T from the workspace (written by other blocks) into
// shared memory through L2, 16 bytes a load, MAXCH loads a thread in
// flight at once.
template <typename T>
__device__ __forceinline__ void load_cg(T* dst, const T* src, int n) {
  const int nch = n * static_cast<int>(sizeof(T)) / 16;
  for (int i0 = threadIdx.x; i0 < nch; i0 += MAXCH * THREADS) {
    uint4 v[MAXCH];
#pragma unroll
    for (int k = 0; k < MAXCH; ++k)
      if (i0 + k * THREADS < nch)
        v[k] = __ldcg(reinterpret_cast<const uint4*>(src) + i0 + k * THREADS);
#pragma unroll
    for (int k = 0; k < MAXCH; ++k)
      if (i0 + k * THREADS < nch)
        reinterpret_cast<uint4*>(dst)[i0 + k * THREADS] = v[k];
  }
  __syncthreads();
}

// A gather stage's weights and this cluster's columns: NW = 1, up to
// three weights read as one concatenation (piece i: map[i], its columns
// [c0[i], c0[i] + n[i])), or NW = 2, the pair (gate, up) at the same
// columns; K rows a layer; the cluster's nu 256-byte units [u0, u0 + nu)
// of the stage's columns.
struct Stage {
  int map[3], c0[3], n[3];
  int K, u0, nu;
};

// the map and column of unit u (NW = 1)
template <int UW>
__device__ __forceinline__ void unit_src(const Stage& st, int u, int& m,
                                         int& col) {
  int off = u * UW, i = 0;
  while (i < 2 && off >= st.n[i]) off -= st.n[i++];
  m = st.map[i];
  col = st.c0[i] + off;
}

// A ring position: slot s of nslot and the parity of its current use
// (the producer and the workers step their own copies alike).
struct Ring {
  int s;
  uint32_t ph;
  __device__ void next(int nslot) {
    if (++s == nslot) {
      s = 0;
      ph ^= 1u;
    }
  }
};

// This block's share of a gather stage: for each 256-byte unit of the
// cluster's columns, the sums over this block's kept rows of xs[row] *
// W[layer, row, columns], into part [NW][cluster columns]. The kept rows
// are cut into row units of a slot (64 rows, or 32 for the gate|up pair),
// the block's rank taking a contiguous share of them. A slot holds two
// boxes of 32 rows x 256 bytes: two halves of a row unit (NW = 1) or its
// gate and up rows (NW = 2). The producer warp's lanes 0 and 1 issue the
// two boxes into the next ring slot (lane 0 first waits for the workers
// to free it); the workers wait for a slot to land, FMA, and free it.
// Worker lanes: two rows a warp, sixteen 16-byte chunks a row (a
// quarter-warp reads 128 contiguous bytes, so shared loads do not
// conflict). Returns the ring position past the stage.
template <typename T, int NW>
__device__ __forceinline__ Ring gather(const Maps& maps, const Stage& st,
                                    int layer, const T* xs, const int* idx,
                                    int count, int rank, int C, int nslot,
                                    unsigned char* sm, uint32_t bars,
                                    float* part, float* red, Ring q) {
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int TW = UB / ESZ;           // columns of a unit
  constexpr int VEC = 16 / ESZ;          // columns of a 16-byte chunk
  constexpr int RU = (NW == 1 ? 2 : 1) * BR;   // kept rows a slot
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ncol = st.nu * TW, rows = count * HD, nru = rows / RU;
  const int r0 = split_lo(nru, C, rank), r1 = split_lo(nru, C, rank + 1);
  if (warp == NWORK) {                   // the producer: lane = half
    const uint64_t policy = evict_first();
    const uint32_t dst = smem_u32(sm) + (lane & 1) * BOXB;
    for (int t = 0; t < st.nu; ++t) {
      int m = st.map[lane & 1], col = (st.u0 + t) * TW;
      if (NW == 1) unit_src<TW>(st, st.u0 + t, m, col);
      const CUtensorMap* map = &maps.m[m];
      for (int r = r0; r < r1; ++r) {
        const int kr = r * RU + (NW == 1 ? (lane & 1) * BR : 0);
        if (lane == 0) {
          mbar_wait_bounded(bars + (MAXSLOT + q.s) * 8, q.ph ^ 1u);
          mbar_expect_tx(bars + q.s * 8, 2 * BOXB);
        }
        __syncwarp();
        if (lane < 2)
          tma_load(dst + q.s * SLOT, map, col,
                   layer * st.K + idx[kr >> 7] * HD + (kr & (HD - 1)),
                   bars + q.s * 8, policy);
        q.next(nslot);
      }
    }
    return q;
  }
  const int rlo = lane >> 4, ch = lane & 15;
  const int rl = 2 * warp + rlo;         // rows rl and rl + 16 of a box
  for (int t = 0; t < st.nu; ++t) {
    float acc[NW][VEC];
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[w][e] = 0.f;
    for (int r = r0; r < r1; ++r) {
      mbar_wait_bounded(bars + q.s * 8, q.ph);
      const unsigned char* slot = sm + q.s * SLOT + ch * 16;
#pragma unroll
      for (int sub = 0; sub < 2; ++sub) {
        const int k0 = r * RU + (NW == 1 ? sub * BR : 0);
        const T* xg = xs + idx[k0 >> 7] * HD + (k0 & (HD - 1));
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int br = rl + 16 * hf;
          const float xv = to_f(xg[br]);
          float v[VEC];
          unpack16(*reinterpret_cast<const uint4*>(slot + sub * BOXB +
                                                   br * UB), v);
          const int w = NW == 1 ? 0 : sub;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[w][e] = fmaf(xv, v[e], acc[w][e]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + (MAXSLOT + q.s) * 8);
      q.next(nslot);
    }
    // unit t's sums: a warp's two row lanes, then the warps in order
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[w][e] += __shfl_xor_sync(0xffffffffu, acc[w][e], 16);
    if (rlo == 0)
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          red[(warp * NW + w) * TW + ch * VEC + e] = acc[w][e];
    workers_sync();
    for (int j = tid; j < NW * TW; j += WORKERS) {
      const int w = j / TW, c = j % TW;
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < NWORK; ++k) sum += red[(k * NW + w) * TW + c];
      part[w * ncol + t * TW + c] = sum;
    }
    workers_sync();
  }
  return q;
}

enum Epi { EPI_HEAD = 0, EPI_QKV = 1, EPI_RES = 2, EPI_SILU = 3 };

// The cluster's sums of stage `st` (after a cluster barrier): block
// `rank` adds, over the cluster's blocks in rank order, its slice of the
// cluster's columns (EPI_HEAD: every column) and writes each once:
// EPI_HEAD the head's q|k|v sums (fp32) into `dst` (shared), EPI_QKV the
// fp32 sums to the workspace at the stage's column, EPI_RES T(sums + h)
// into the stream, EPI_SILU T(silu(gate) * up) into the intermediate;
// dst2 (or null) a second copy of EPI_RES (the launch's output at the last
// layer).
template <typename T>
__device__ __forceinline__ void epilogue(int kind, const Stage& st,
                                      const float* part, int rank, int C,
                                      const T* h, void* dst, void* dst2) {
  constexpr int UW = UB / static_cast<int>(sizeof(T));
  const int ncol = st.nu * UW;
  const uint32_t pb = smem_u32(part);
  const int j0 = kind == EPI_HEAD ? 0 : split_lo(ncol, C, rank);
  const int j1 = kind == EPI_HEAD ? ncol : split_lo(ncol, C, rank + 1);
  for (int j = j0 + static_cast<int>(threadIdx.x); j < j1; j += THREADS) {
    const uint32_t addr[2] = {pb + j * 4, pb + (ncol + j) * 4};
    const bool ok[2] = {true, kind == EPI_SILU};
    float s[2];
    cluster_sums(addr, ok, C, s);
    const int c = st.u0 * UW + j;
    if (kind == EPI_HEAD) {
      static_cast<float*>(dst)[j] = s[0];
    } else if (kind == EPI_QKV) {
      __stcg(static_cast<float*>(dst) + c, s[0]);
    } else if (kind == EPI_RES) {
      const T v = from_f<T>(s[0] + to_f(h[c]));
      st_cg(static_cast<T*>(dst) + c, v);
      if (dst2 != nullptr) static_cast<T*>(dst2)[c] = v;
    } else {
      st_cg(static_cast<T*>(dst) + c,
            from_f<T>(s[0] * (1.0f / (1.0f + expf(-s[0]))) * s[1]));
    }
  }
}

// Kv head hk's attention by this cluster (block `rank` of C) on the head's
// q|k|v sums in `qraw`: see the header. QG = the query heads a kv head
// (one kernel each, so that the hot loops hold no predicated work for
// absent heads).
template <typename T, int QG>
__device__ __forceinline__ void attention(const Args& a, const Layout& lay,
                                       const WsLayout& wl, unsigned char* sm,
                                       int l, int pos, int hk, int rank) {
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int VE = 16 / ESZ;              // a chunk's elements
  constexpr int LPR = HD / VE;              // lanes a cache row
  constexpr int RPI = WORKERS / LPR;        // cache rows a pass
  constexpr int GH = QG;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, NS = a.NS;
  float* qraw = reinterpret_cast<float*>(sm + lay.qraw);
  float* qf = reinterpret_cast<float*>(sm + lay.qf);
  T* qr = reinterpret_cast<T*>(sm + lay.qr);
  float* sc = reinterpret_cast<float*>(sm + lay.small);
  float* ec = sc + MAXGH;
  float* M = ec + MAXGH;
  float* den = M + MAXGH;
  float* amax = reinterpret_cast<float*>(sm + lay.amax);
  float* apv = reinterpret_cast<float*>(sm + lay.apv);
  float* s = reinterpret_cast<float*>(sm + lay.s);
  float* misc = reinterpret_cast<float*>(sm + lay.misc);
  T* attn = reinterpret_cast<T*>(a.ws + wl.attn);
  auto stamp = [&](int i) {
    if (a.stamps != nullptr && blockIdx.x == 0 && tid == 0)
      a.stamps[static_cast<size_t>(l) * (NSTAMP + TRACE_ROWS * a.grid) +
               ST_ATTN +
               i] = static_cast<long long>(globaltimer());
  };

  // RoPE on q (then scaled; also rounded to T for the slab scores) and k
  for (int i = tid; i < (GH + 1) * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const float* row = qraw + r * HD;
    const float rot = d < HD / 2 ? -row[d + HD / 2] : row[d - HD / 2];
    float v = rope_term(row[d], rot, __ldg(a.cs + d), __ldg(a.cs + HD + d));
    if (r < GH) {
      v = __fmul_rn(v, a.scale);
      qr[i] = from_f<T>(v);
    }
    qf[i] = v;
  }
  __syncthreads();
  stamp(0);
  const float* knf = qf + GH * HD;
  const float* vnf = qraw + (GH + 1) * HD;
  const size_t slab = (static_cast<size_t>(l) * a.Hkv + hk) * a.T * HD;
  T* kcache = static_cast<T*>(a.kc) + slab;
  T* vcache = static_cast<T*>(a.vc) + slab;
  if (rank == 0 && tid < HD) {  // row pos: read by no block of this layer
    kcache[static_cast<size_t>(pos) * HD + tid] = from_f<T>(knf[tid]);
    vcache[static_cast<size_t>(pos) * HD + tid] = from_f<T>(vnf[tid]);
  }
  // the current token's score, fp32: a warp a query row
  for (int g = warp; g < GH; g += NWARPS) {
    const float* qg = qf + g * HD + lane * 4;
    const float* kg = knf + lane * 4;
    float p = qg[0] * kg[0];
    p = fmaf(qg[1], kg[1], p);
    p = fmaf(qg[2], kg[2], p);
    p = fmaf(qg[3], kg[3], p);
    p = warp_sum(p);
    if (lane == 0) sc[g] = p;
  }

  // the block's share [ra, ra + nr) of the live rows [lo, pos)
  const int lo = a.window > 0 ? max(pos - a.window + 1, 0) : 0;
  const int n = pos - lo;
  const int ra = lo + split_lo(n, C, rank);
  const int nr = split_lo(n, C, rank + 1) - split_lo(n, C, rank);
  const int li = tid % LPR, rr = tid / LPR;
  const bool worker = tid < WORKERS;
  // a row lane's chunk of cache rows base + rr + u RPI (zeros past nr)
  auto rows = [&](const T* cache, int base, uint4 (&c)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + rr + u * RPI;
      c[u] = worker && t < nr
                 ? __ldcg(reinterpret_cast<const uint4*>(
                              cache + static_cast<size_t>(ra + t) * HD) + li)
                 : make_uint4(0, 0, 0, 0);
    }
  };
  // the first pass's K and V rows in flight together (the only pass up to
  // RPI U rows a block)
  uint4 k0[U], v0[U];
  rows(kcache, 0, k0);
  rows(vcache, 0, v0);
  // slab scores: LPR lanes a cache row, U rows in flight a row lane
  if (worker)
    for (int base = 0; base < nr; base += RPI * U) {
      uint4 kv[U];
      if (base == 0) {
#pragma unroll
        for (int u = 0; u < U; ++u) kv[u] = k0[u];
      } else {
        rows(kcache, base, kv);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = base + rr + u * RPI;
        float k[VE];
        unpack16(kv[u], k);
        for (int g = 0; g < GH; ++g) {
          float qv[VE];
          unpack16(*reinterpret_cast<const uint4*>(qr + g * HD + li * VE),
                   qv);
          float p = 0.f;
#pragma unroll
          for (int e = 0; e < VE; ++e) p = fmaf(qv[e], k[e], p);
#pragma unroll
          for (int o = 1; o < LPR; o <<= 1)
            p += __shfl_xor_sync(0xffffffffu, p, o);
          if (li == 0 && t < nr) s[g * NS + t] = p;
        }
      }
    }
  __syncthreads();
  // the share's max per query row, then the cluster's: the one max M
  for (int g = 0; g < GH; ++g) {
    float m = __int_as_float(0xff800000);   // -inf
    for (int t = tid; t < nr; t += THREADS) m = fmaxf(m, s[g * NS + t]);
    m = block_max(m, misc);
    if (tid == 0) amax[g] = m;
  }
  stamp(1);
  cluster_sync();
  if (tid < GH) {
    const uint32_t at = smem_u32(amax + tid);
    float m = sc[tid], mv[MAXC];
#pragma unroll
    for (int q = 0; q < MAXC; ++q)
      if (q < C) mv[q] = ld_cluster(mapa(at, q));
#pragma unroll
    for (int q = 0; q < MAXC; ++q)
      if (q < C) m = fmaxf(m, mv[q]);
    M[tid] = m;
    ec[tid] = expf(sc[tid] - m);
  }
  __syncthreads();
  stamp(2);
  // weights rounded to T for PV; the sum of the unrounded ones
  for (int g = 0; g < GH; ++g) {
    float sum = 0.f;
    for (int t = tid; t < nr; t += THREADS) {
      const float e = expf(s[g * NS + t] - M[g]);
      s[g * NS + t] = rnd<T>(e);
      sum += e;
    }
    sum = block_sum(sum, misc);
    if (tid == 0) den[g] = sum;
  }
  __syncthreads();
  // partial PV: each lane its VE dimensions of its rows, then the row
  // lanes added in order
  float acc[GH][VE];
#pragma unroll
  for (int g = 0; g < GH; ++g)
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[g][e] = 0.f;
  if (worker)
    for (int base = 0; base < nr; base += RPI * U) {
      uint4 vv[U];
      if (base == 0) {
#pragma unroll
        for (int u = 0; u < U; ++u) vv[u] = v0[u];
      } else {
        rows(vcache, base, vv);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = base + rr + u * RPI;
        if (t < nr) {
          float v[VE];
          unpack16(vv[u], v);
#pragma unroll
          for (int g = 0; g < GH; ++g) {
            const float w = s[g * NS + t];
#pragma unroll
            for (int e = 0; e < VE; ++e) acc[g][e] = fmaf(w, v[e], acc[g][e]);
          }
        }
      }
    }
  float* red = reinterpret_cast<float*>(sm);        // [RPI][GH][128]
  if (worker)
#pragma unroll
    for (int g = 0; g < GH; ++g)
#pragma unroll
      for (int e = 0; e < VE; ++e)
        red[(rr * GH + g) * HD + li * VE + e] = acc[g][e];
  __syncthreads();
  for (int i = tid; i < GH * HD; i += THREADS) {
    float p = 0.f;
    for (int r = 0; r < RPI; ++r) p += red[r * GH * HD + i];
    apv[i] = p;
  }
  if (tid < GH) apv[GH * HD + tid] = den[tid];
  stamp(3);
  cluster_sync();
  stamp(4);
  // this block's slice of the head's dimensions, the cluster's blocks in
  // rank order
  const uint32_t pb = smem_u32(apv);
  const int d0 = split_lo(HD, C, rank), nd = split_lo(HD, C, rank + 1) - d0;
  for (int i = tid; i < GH * nd; i += THREADS) {
    const int g = i / nd, d = d0 + i % nd;
    const uint32_t addr[2] = {pb + (g * HD + d) * 4, pb + (GH * HD + g) * 4};
    const bool ok[2] = {true, true};
    float pd[2];
    cluster_sums(addr, ok, C, pd);
    st_cg(attn + (hk * GH + g) * HD + d,
          from_f<T>((pd[0] + ec[g] * vnf[d]) * (1.0f / (pd[1] + ec[g]))));
  }
  fence_proxy_async();       // `red` lies in the ring, which TMA refills
}

// QG: the query heads a kv head (1, 2, 4 or 8), one kernel each, so that
// a launch's code holds one attention body (the code's size costs time:
// every phase of a layer runs once between the others)
template <typename T, int QG>
__global__ void __launch_bounds__(THREADS, 1)
    token_kernel(const __grid_constant__ Maps maps,
                 const __grid_constant__ Args a) {
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int UW = UB / ESZ;
  extern __shared__ __align__(1024) unsigned char sm[];
  const int tid = threadIdx.x, b = blockIdx.x, warp = tid >> 5;
  const int rank = cluster_rank(), cid = cluster_index();
  const int D = a.D, I = a.I, C = a.C, GH = QG;
  const Layout lay(ESZ, D, I, GH, a.capmax, a.NS, a.partf, a.nslot);
  const WsLayout wl(ESZ, D, I, a.Hq, a.Hkv);
  unsigned* bar = reinterpret_cast<unsigned*>(a.ws + wl.bar);
  const uint32_t bars = smem_u32(sm + lay.bars);
  if (tid == 0) {
    for (int s = 0; s < a.nslot; ++s) {
      mbar_init(bars + s * 8, 1);
      mbar_init(bars + (MAXSLOT + s) * 8, NWORK);
    }
    mbar_init_fence();
  }
  // every block of the cluster has started (its shared memory may be
  // read) and this block's mbarriers are set
  cluster_sync();
  const size_t sw = NSTAMP + static_cast<size_t>(TRACE_ROWS) * a.grid;
  auto stamp = [&](int l, int i) {
    if (a.stamps != nullptr && b == 0 && tid == 0)
      a.stamps[l * sw + i] = static_cast<long long>(globaltimer());
  };
  unsigned nbar = 0;                       // grid barriers passed
  auto grid_barrier = [&](int l, int slot) {
    stamp(l, 1 + 2 * slot);
    barrier(bar, (nbar + 1) * a.grid,
            a.stamps == nullptr
                ? nullptr
                : a.stamps + l * sw + NSTAMP + slot * a.grid + b);
    stamp(l, 2 + 2 * slot);
    ++nbar;
  };
  if (a.empty) {
    for (int l = 0; l < a.L; ++l) {
      cluster_sync();                      // the q|k|v sums
      if (!a.head) grid_barrier(l, 0);
      cluster_sync();                      // attention: maxima, PV
      cluster_sync();
      grid_barrier(l, 1);
      for (int i = 2; i < NBAR; ++i) {
        cluster_sync();                    // the stage's sums
        grid_barrier(l, i);
      }
    }
    cluster_sync();
    return;
  }
  const int pos = *a.pos;
  if (pos < 0 || pos >= a.T) __trap();
  float* part = reinterpret_cast<float*>(sm + lay.part);
  float* red = reinterpret_cast<float*>(sm + lay.red);
  T* h = reinterpret_cast<T*>(sm + lay.h);
  T* xs = reinterpret_cast<T*>(sm + lay.xs);
  float* scores = reinterpret_cast<float*>(sm + lay.scores);
  int* idx = reinterpret_cast<int*>(sm + lay.idx);
  float* misc = reinterpret_cast<float*>(sm + lay.misc);
  float* qraw = reinterpret_cast<float*>(sm + lay.qraw);
  float* wqkv = reinterpret_cast<float*>(a.ws + wl.qkv);
  T* wh = reinterpret_cast<T*>(a.ws + wl.h);      // the stream after o
  T* wh2 = reinterpret_cast<T*>(a.ws + wl.h2);    // ... after down
  T* winter = reinterpret_cast<T*>(a.ws + wl.inter);
  const T* na = static_cast<const T*>(a.na);
  const T* nm = static_cast<const T*>(a.nm);
  const int Hq = a.Hq, Hkv = a.Hkv, NC = a.NC;
  const int kvw = Hkv * HD;
  Ring ring = {0, 0u};                     // the ring's next slot
  const Stage head_qkv = {{0, 1, 2}, {cid * GH * HD, cid * HD, cid * HD},
                          {GH * HD, HD, HD}, D, 0, (GH + 2) * HD / UW};
  // column-owned stage i (q|k|v in the other plan, o, gate|up, down):
  // cluster cid's 256-byte units, an even share
  auto stage = [&](int i) -> Stage {
    const int n = (i == 0 ? D + 2 * kvw : i == 2 ? I : D) / UW;
    const int u0 = split_lo(n, NC, cid), nu = split_lo(n, NC, cid + 1) - u0;
    switch (i) {
      case 0: return {{0, 1, 2}, {0, 0, 0}, {D, kvw, kvw}, D, u0, nu};
      case 1: return {{3, 3, 3}, {0, 0, 0}, {D, 0, 0}, D, u0, nu};
      case 2: return {{4, 5, 5}, {0, 0, 0}, {I, 0, 0}, D, u0, nu};
      default: return {{6, 6, 6}, {0, 0, 0}, {D, 0, 0}, I, u0, nu};
    }
  };
  // a skipped barrier's trace: its arrival and exit now
  auto skip_barrier = [&](int l, int slot) {
    stamp(l, 1 + 2 * slot);
    stamp(l, 2 + 2 * slot);
    if (a.stamps != nullptr && tid == 0)
      a.stamps[l * sw + NSTAMP + slot * a.grid + b] =
          static_cast<long long>(globaltimer());
  };
  // gather stage i on its kept groups, then the cluster's sums of it
  auto run = [&](int l, int i, const Stage& st, int count, int kind,
                 void* dst, void* dst2) {
    stamp(l, ST_GATHER + i);
    if (i == 2)
      ring = gather<T, 2>(maps, st, l, xs, idx, count, rank, C, a.nslot, sm,
                          bars, part, red, ring);
    else
      ring = gather<T, 1>(maps, st, l, xs, idx, count, rank, C, a.nslot, sm,
                          bars, part, red, ring);
    __syncthreads();
    stamp(l, ST_GEND + i);
    if (a.stamps != nullptr && tid == 0)
      a.stamps[l * sw + NSTAMP + (NBAR + i) * a.grid + b] =
          static_cast<long long>(globaltimer());
    cluster_sync();
    epilogue<T>(kind, st, part, rank, C, h, dst, dst2);
    stamp(l, ST_EPI + i);
  };
  const bool qkv_here = !a.head || cid < Hkv;

  uint4 g[MAXCH];                          // the next fold's gains
  load_gains(na, D, g);
  load_cg(h, static_cast<const T*>(a.x), D);
  for (int l = 0; l < a.L; ++l) {
    stamp(l, 0);
    const float thr[4] = {__ldg(a.thr + l * 7), __ldg(a.thr + l * 7 + 3),
                          __ldg(a.thr + l * 7 + 4), __ldg(a.thr + l * 7 + 6)};
    const bool last = l + 1 == a.L;
    // 1. q|k|v on the folded attention norm, then attention
    fold(h, g, D, a.eps, xs, misc);
    const int c0 = select_stage(a, xs, D, thr[0], a.cap[0], scores, idx, l, 0);
    if (qkv_here) {
      if (a.head) {
        run(l, 0, head_qkv, c0, EPI_HEAD, qraw, nullptr);
        __syncthreads();
      } else {
        run(l, 0, stage(0), c0, EPI_QKV, wqkv, nullptr);
      }
    }
    if (!a.head) grid_barrier(l, 0);
    for (int hk = cid; hk < Hkv; hk += NC) {
      if (!a.head) {
        if (hk != cid) cluster_sync();     // the peers are done with amax, apv
        for (int i = tid; i < (GH + 2) * HD; i += THREADS) {
          const int r = i / HD, d = i % HD;
          const int head = r < GH ? hk * GH + r
                                  : (r == GH ? Hq + hk : Hq + Hkv + hk);
          qraw[i] = __ldcg(wqkv + head * HD + d);
        }
        __syncthreads();
      }
      attention<T, QG>(a, lay, wl, sm, l, pos, hk, rank);
    }
    grid_barrier(l, 1);
    // 2. o, its sums added to the stream. Where a stage keeps no group
    // (every block finds the same) its gather, sums and barrier are
    // skipped: o and down then leave the stream as it is (T(0 + h) = h),
    // gate|up makes the intermediate 0.
    load_cg(xs, reinterpret_cast<const T*>(a.ws + wl.attn), Hq * HD);
    const int c1 = select_stage(a, xs, D, thr[1], a.cap[1], scores, idx, l, 1);
    load_gains(nm + static_cast<size_t>(l) * D, D, g);
    if (c1 > 0) {
      run(l, 1, stage(1), c1, EPI_RES, wh, nullptr);
      grid_barrier(l, 2);
      load_cg(h, wh, D);
    } else {
      skip_barrier(l, 2);
    }
    // 3. gate|up on the folded mlp norm: T(silu(gate) * up)
    fold(h, g, D, a.eps, xs, misc);
    const int c2 = select_stage(a, xs, D, thr[2], a.cap[2], scores, idx, l, 2);
    if (c2 > 0) {
      run(l, 2, stage(2), c2, EPI_SILU, winter, nullptr);
      grid_barrier(l, 3);
      load_cg(xs, winter, I);
    } else {
      for (int i = tid; i < I; i += THREADS) xs[i] = from_f<T>(0.f);
      skip_barrier(l, 3);
      __syncthreads();
    }
    // 4. down, its sums added to the stream (the one barrier a layer that
    // is never skipped: it orders this layer's reads of the workspace
    // before the next layer's writes)
    const int c3 = select_stage(a, xs, I, thr[3], a.cap[3], scores, idx, l, 3);
    if (c3 > 0) {
      run(l, 3, stage(3), c3, EPI_RES, wh2, last ? a.out : nullptr);
    } else if (last && b == 0) {
      for (int i = tid; i < D; i += THREADS) static_cast<T*>(a.out)[i] = h[i];
    }
    if (!last) load_gains(na + static_cast<size_t>(l + 1) * D, D, g);
    grid_barrier(l, 4);
    if (c3 > 0 && !last) load_cg(h, wh2, D);
  }
  cluster_sync();              // no peer reads this block's shared memory
}

// --- host side -------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime's
// entry-point query (so nothing links libcuda); null where it is missing.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    return err == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map over a weight [L, K, N] of the stream type as 2-D [L K, N]: boxes
// of 256 bytes of columns by 32 rows, no swizzle.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* p, int esz, int L,
            int K, int N) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(L) * K};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * esz};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(UB / esz), BR};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, esz == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(p), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The kernel of (dtype, GH): its function, with its attribute set once
// (the most dynamic shared memory).
template <typename T, int QG>
const void* kernel_fn() {
  static bool set = false;
  auto fn = token_kernel<T, QG>;
  if (!set) {
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX) != cudaSuccess)
      return nullptr;
    set = true;
  }
  return reinterpret_cast<const void*>(fn);
}

const void* kernel_of(int dtype, int GH) {
  switch ((dtype == 0 ? 0 : 4) + __builtin_ctz(GH)) {
    case 0: return kernel_fn<float, 1>();
    case 1: return kernel_fn<float, 2>();
    case 2: return kernel_fn<float, 4>();
    case 3: return kernel_fn<float, 8>();
    case 4: return kernel_fn<__nv_bfloat16, 1>();
    case 5: return kernel_fn<__nv_bfloat16, 2>();
    case 6: return kernel_fn<__nv_bfloat16, 4>();
    default: return kernel_fn<__nv_bfloat16, 8>();
  }
}

void config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[2], int C,
            int grid, cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM_MAX;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
}

// The card's resident clusters of each size C for the kernel of (dtype,
// GH), at one block an SM (cudaOccupancyMaxActiveClusters, asked once a
// device): nc[C] for C in [0, MAXC], 0 where a size is refused.
const int* cluster_table(int dtype, int GH) {
  static int table[64][8][MAXC + 1];
  static bool done[64][8];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return nullptr;
  const int k = (dtype == 0 ? 0 : 4) + __builtin_ctz(GH);
  int* nc = table[dev][k];
  if (!done[dev][k]) {
    const void* fn = kernel_of(dtype, GH);
    if (fn == nullptr) return nullptr;
    for (int C = 0; C <= MAXC; ++C) {
      nc[C] = 0;
      if (C < MINC) continue;
      cudaLaunchConfig_t cfg;
      cudaLaunchAttribute attr[2];
      config(cfg, attr, C, C, nullptr);
      cfg.numAttrs = 1;
      int n = 0;
      if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) == cudaSuccess)
        nc[C] = n;
      cudaGetLastError();
    }
    done[dev][k] = true;
  }
  return nc;
}

bool heads_ok(int Hq, int Hkv) {
  return Hkv > 0 && Hq > 0 && Hq % Hkv == 0 && MAXGH % (Hq / Hkv) == 0;
}

}  // namespace

// The resident clusters of C blocks of the kernel of (dtype 0 fp32 / 1
// bf16, GH query heads a kv head) on the current device: the table the
// plan reads. -1 where the kernel's attributes cannot be set.
extern "C" int teal_token_clusters(int dtype, int GH, int C) {
  if (GH < 1 || MAXGH % GH || C < 0 || C > MAXC) return -1;
  const int* nc = cluster_table(dtype, GH);
  return nc == nullptr ? -1 : nc[C];
}

// The plan for dtype (0 fp32, 1 bf16) at these shapes on n_sms SMs and the
// current device's resident clusters, into out int32 [11]: grid, threads,
// shared bytes, workspace bytes, grid barriers a token (4 L head-owned, 5
// L other), kv-head barriers a token (0), C, clusters, head-owned (1 / 0),
// ring slots, NS. Returns 0, or -1 where the shapes take no plan (out
// untouched).
extern "C" int teal_token_plan(int dtype, int D, int I, int Hq, int Hkv,
                               int T, int window, int capmax, int n_sms,
                               int L, int* out) {
  if (!heads_ok(Hq, Hkv) || L < 1) return -1;
  const int* nc = cluster_table(dtype, Hq / Hkv);
  if (nc == nullptr) return -1;
  const TokPlan p = token_plan(dtype == 0 ? 4 : 2, D, I, Hq, Hkv, T, window,
                               capmax, n_sms, nc);
  if (p.smem < 0) return -1;
  const int v[11] = {p.grid, THREADS, p.smem, static_cast<int>(p.ws),
                     (p.head ? NBAR - 1 : NBAR) * L, 0, p.C, p.NC, p.head,
                     p.nslot, p.NS};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

// One token through the L layers. The caller checks shapes, types and
// contiguity and allocates `ws` (the plan's workspace bytes); window 0
// means none; fixed keeps groups 0..cap-1; empty runs the barriers alone.
// Returns the launch's error, or -1 where no plan or no tensor map can be
// made.
extern "C" int teal_token_decode(
    int dtype, const void* x, const void* thr, const void* pos,
    const void* cs, const void* na, const void* nm, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* wg,
    const void* wu, const void* wd, void* kc, void* vc, void* out, void* sel,
    void* stamps, void* ws, int L, int D, int I, int Hq, int Hkv, int T,
    int window, int cap0, int cap1, int cap2, int cap3, int fixed, float eps,
    int n_sms, int empty, void* stream) {
  cudaGetLastError();  // clear any stale error of this library
  const int caps[4] = {cap0, cap1, cap2, cap3};
  int capmax = 0;
  for (int c : caps) capmax = imax(capmax, c);
  if (!heads_ok(Hq, Hkv) || L < 1 || cap0 < 1 || cap0 > D / HD ||
      cap1 < 1 || cap1 > D / HD || cap2 < 1 || cap2 > D / HD || cap3 < 1 ||
      cap3 > I / HD)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* nc = cluster_table(dtype, Hq / Hkv);
  if (nc == nullptr) return -1;
  const int esz = dtype == 0 ? 4 : 2;
  const TokPlan p = token_plan(esz, D, I, Hq, Hkv, T, window, capmax,
                               n_sms, nc);
  EncodeTiled fn = encode_tiled();
  if (p.smem < 0 || fn == nullptr) return -1;
  // the maps of the last call's weights are kept (a decode loop passes the
  // same stacks every token)
  static Maps maps;
  static const void* key[7] = {};
  static int key_shape[5] = {};
  const void* w[7] = {wq, wk, wv, wo, wg, wu, wd};
  const int shape[5] = {esz, L, D, I, Hkv};
  bool same = true;
  for (int i = 0; i < 7; ++i) same = same && key[i] == w[i];
  for (int i = 0; i < 5; ++i) same = same && key_shape[i] == shape[i];
  if (!same) {
    const int kn[7][2] = {{D, D}, {D, Hkv * HD}, {D, Hkv * HD}, {D, D},
                          {D, I}, {D, I}, {I, D}};
    for (int i = 0; i < 7; ++i) {
      key[i] = nullptr;
      if (!encode(fn, &maps.m[i], w[i], esz, L, kn[i][0], kn[i][1]))
        return -1;
    }
    for (int i = 0; i < 7; ++i) key[i] = w[i];
    for (int i = 0; i < 5; ++i) key_shape[i] = shape[i];
  }
  Args a;
  a.x = x;
  a.thr = static_cast<const float*>(thr);
  a.pos = static_cast<const int*>(pos);
  a.cs = static_cast<const float*>(cs);
  a.na = na;
  a.nm = nm;
  a.kc = kc;
  a.vc = vc;
  a.out = out;
  a.sel = static_cast<int*>(sel);
  a.stamps = static_cast<long long*>(stamps);
  a.ws = static_cast<unsigned char*>(ws);
  a.L = L;
  a.D = D;
  a.I = I;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.T = T;
  a.window = window;
  a.fixed = fixed;
  a.empty = empty;
  for (int i = 0; i < 4; ++i) a.cap[i] = caps[i];
  a.capmax = capmax;
  a.eps = eps;
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  a.C = p.C;
  a.NC = p.NC;
  a.head = p.head;
  a.grid = p.grid;
  a.nslot = p.nslot;
  a.NS = p.NS;
  a.partf = p.partf;
  auto s = static_cast<cudaStream_t>(stream);
  // the barrier counter starts at 0 (a memset node under stream capture)
  cudaError_t e = cudaMemsetAsync(ws, 0, 256, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  config(cfg, attr, p.C, p.grid, s);
  const void* k = kernel_of(dtype, Hq / Hkv);
  if (k == nullptr) return -1;
  void* params[2] = {&maps, &a};
  e = cudaLaunchKernelExC(&cfg, k, params);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
