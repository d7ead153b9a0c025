// K7: single-token decode of the whole layer stack in ONE persistent
// launch, for one row (batch 1), G = 128, threshold or fixed selection, a
// dense MLP, head_dim 128 (MHA or GQA, Hq / Hkv of 1, 2, 4 or 8) and an
// optional sliding window, in three weight plans (template parameter P,
// `common.cuh`'s Plan): arrays of the stream type T (fp32 or bf16, the
// stream and cache of that type), and with a bf16 stream and cache int8
// {"q" [L, K, N], "scale" [L, N]} or packed int4 at quant group 128
// {"qp" [L, K/2, N], "sz" [L, K/128, 2, N]} (all seven projections of one
// plan). The kernel's body is this header; `token_decode.cu` builds the
// array plans and `token_decode_quant.cu` the quantized ones, each its own
// library (two nvcc processes at once).
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
//      t < pos (t > pos - window) plus the current token, walked in chunks
//      of a fixed number of rows, as the reference's chunked `attn_stage`
//      walks them (attn_block.py:352-380, 492-504), in two passes: slab
//      scores of q rounded to T, ONE max over all of them and the current
//      token's before any exp, the weights rounded to T for the PV
//      product, the denominator of the unrounded ones, the output in T
//      (the plain version's rounding points; a running max rescaled chunk
//      by chunk moved kept groups, PERF.md);
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
//     stage's output columns in 256-byte units of a slab row (as even as
//     the units allow), and its C blocks split the kept rows in rank
//     order. The
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
//     `pos`, and the blocks split the live cache rows: the maxima (every
//     block scores all the live rows where they fit one chunk of
//     `chunk_rows`, else its share, the maxima exchanged), then each
//     block's weights and partial PV and denominators of its share, added
//     in rank order through distributed shared memory behind cluster
//     barriers (barrier.cluster arrive.release / wait.acquire). Shared
//     memory keeps a fixed number of scores (`score_rows`; a longer share
//     is scored again chunk by chunk), so no plan depends on T. The plan's column-owned stages run on the same
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
//
// The quantized plans (the reference's `s_refs`, token_block.py:194-198,
// and its int4 `_WeightPlan`, block_gemv.py:80-127) change only the
// gather's weight read and the stage writers; the rows, the selection,
// the attention, the barriers and the plan stay as above:
//   - a unit of columns is 128 bytes of a slab row (128 columns, as bf16's
//     256 bytes are), so the 7B's o and down fall one unit a cluster and
//     gate|up keeps 86 units. The producer issues boxes of 64 rows x 128
//     bytes (8 KB, as the arrays' 32 x 256) over a 2-D UINT8 map of q
//     [L K, N] or qp [L K/2, N]; the workers are 32 row lanes of 8
//     16-byte chunks (a quarter-warp reads one 128-byte row) and convert
//     exactly with K1's helpers (`i8_f`, `nib128_f`);
//   - int8: a slot is one kept group (two boxes of 64 rows; gate|up: the
//     same 64 rows of both). The per-channel scale multiplies the
//     cluster's fp32 sums in the stage writers, as `_token_kernel`'s
//     writers apply `scale_ref` (token_block.py:249-253, 264-272): before
//     RoPE (q|k|v), before the residual (o, down), on gate and on up each
//     before the silu;
//   - packed int4: a box is one kept group's 64 packed rows (a byte of
//     packed row p holds weight rows g 128 + p and g 128 + 64 + p, so the
//     two x values of a byte are 64 rows apart), and the producer adds the
//     group's [scale, zero] rows of the unit's columns (a 2 x 128 fp32 box
//     with the 128-byte swizzle, so the workers' reads do not conflict;
//     evict-first as the slabs) to the slot; a slot is one group (gate|up:
//     the group of both). The group's affine (x . nib) scale + sum(x) zero
//     (`_accumulate`, block_gemv.py:201-228) is linear, so each lane adds
//     its own rows' (x . (128 + nib)) * scale in fp32, and row lane 0 adds
//     sum(x_g) (zero - 128 scale) once a group, sum(x_g) formed once a
//     kept group after the scan from the selection input in T (`gsum`).
#pragma once

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
constexpr int BOXB = 8192;             // bytes of a TMA box (every plan)
constexpr int SZB = 2 * HD * 4;        // int4: a group's [scale, zero]
                                       // rows of a unit's 128 columns
constexpr int MAXSLOT = 8;             // ring slots at most
constexpr int MAXGH = 8;               // query heads a kv head
constexpr int MINC = 2, MAXC = 8;      // blocks a cluster (portable sizes)
constexpr int U = 8;                   // cache rows in flight a row lane
constexpr int MISC = 128;              // floats of scratch (reductions)
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

// Cache rows of an attention chunk (a block walks its share of a head's
// live rows in chunks): RPI rows a pass (LPR = 8 or 16 lanes a 256- or
// 512-byte row), U passes: 128 (bf16) or 64 (fp32).
__host__ __device__ constexpr int chunk_rows(int esz) {
  return WORKERS / (HD * esz / 16) * U;
}
// Scores a query row of attention keeps in shared memory: SCORES floats
// over the GH query rows of a kv head (a block's share of up to 2048 live
// rows at one query row a kv head, 256 at eight; a longer share is
// scored again in the second pass)
constexpr int SCORES = 2048;
__host__ __device__ constexpr int score_rows(int GH) { return SCORES / GH; }

// Bytes of a slab row in a TMA box, the unit of a stage's columns: 256 for
// arrays (128 bf16 or 64 fp32 columns), 128 for int8 and packed int4 (128
// columns); the stored rows of a box (BOXB bytes); the columns of a unit;
// the bytes of a ring slot: two boxes, and for int4 two groups' [scale,
// zero] rows.
__host__ __device__ constexpr int box_ub(int plan) {
  return plan == PLAN_STREAM ? 256 : 128;
}
__host__ __device__ constexpr int box_rows(int plan) {
  return BOXB / box_ub(plan);
}
__host__ __device__ constexpr int unit_cols(int plan, int esz) {
  return plan == PLAN_STREAM ? 256 / esz : 128;
}
__host__ __device__ constexpr int slot_bytes(int plan) {
  return 2 * BOXB + (plan == PLAN_INT4 ? 2 * SZB : 0);
}

// Shared memory, bytes: the ring (attention: the row lanes' PV sums [RPI]
// [GH][128] fp32), its full and empty mbarriers, the block's partial sums
// `part` [NW][columns of its cluster] fp32 (read by the cluster's peers),
// the warps' sums of a tile [8][2][columns of a unit] fp32, the stream h
// [D] and a stage's selection input [max(D, I)] of T, the scores, the kept
// groups, (int4) each kept group's sum of its selection input [capmax]
// fp32, MISC floats of scratch, then attention's q|k|v sums [GH + 2][128]
// and RoPE'd q|k [GH + 1][128] fp32, q rounded [GH][128] T, four [8] fp32
// (current score, its weight, max, sum), the block's maxima [8] and
// partial PV and denominators [GH * 128 + 8] fp32 (read by the peers),
// and the kept scores [GH][NS] fp32 (NS = `score_rows`).
struct Layout {
  int bars, part, red, h, xs, scores, idx, gsum, misc, qraw, qf, qr, small,
      amax, apv, s, total;
  __host__ __device__ Layout(int plan, int esz, int D, int I, int GH,
                             int capmax, int NS, int partf, int nslot) {
    bars = nslot * slot_bytes(plan);
    part = bars + 2 * MAXSLOT * 8;
    red = part + partf * 4;
    h = red + NWORK * 2 * unit_cols(plan, esz) * 4;
    xs = h + al16(D * esz);
    scores = xs + al16(imax(D, I) * esz);
    idx = scores + pad4(imax(D, I) / HD) * 4;
    gsum = idx + pad4(capmax + 1) * 4;
    misc = gsum + (plan == PLAN_INT4 ? pad4(capmax) * 4 : 0);
    qraw = misc + MISC * 4;
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
// NS = the scores a query row keeps (`score_rows`, whatever T); `part`
// holds the largest NW x (columns of a cluster) of the stages;
// the ring takes what shared memory is left, up to MAXSLOT slots of
// `slot_bytes`, at least two and at least attention's PV sums. The
// quantized plans take a bf16 stream only.
// The plan's structure from the resident clusters (see above): C blocks
// a cluster, NC clusters, head-owned; C 0 where no cluster fits. The rows
// form (`token_decode_rows.cuh`) takes the same.
struct Structure {
  int C, NC, head;
};
Structure token_structure(int Hkv, int n_sms, const int* nc) {
  int best = 0, co = 0, ch = 0;
  for (int c = MINC; c <= MAXC; ++c) {
    best = imax(best, c * nc[c]);
    if (nc[c] >= Hkv) ch = c;
  }
  for (int c = MAXC; c >= MINC && co == 0; --c)
    if (best > 0 && 16 * c * nc[c] >= 15 * best) co = c;
  const int head = ch > 0 && 2 * ch * Hkv >= n_sms;
  if (!head && co == 0) return {0, 0, 0};
  const int C = head ? ch : co, NC = head ? Hkv : nc[C];
  return {C, NC, head};
}

TokPlan token_plan(int plan, int esz, int D, int I, int Hq, int Hkv, int T,
                   int window, int capmax, int n_sms, const int* nc) {
  TokPlan p = {0, 0, 0, 0, 0, 0, 0, -1, 0};
  if ((plan != PLAN_STREAM && esz != 2) || plan < PLAN_STREAM ||
      plan > PLAN_INT4 ||
      D <= 0 || I <= 0 || D % HD || I % HD || Hkv <= 0 || Hq != D / HD ||
      Hq % Hkv || MAXGH % (Hq / Hkv) || T < 1 || capmax < 1 ||
      capmax > imax(D, I) / HD || D * esz > 16 * MAXCH * THREADS)
    return p;
  const int GH = Hq / Hkv;
  const Structure sc = token_structure(Hkv, n_sms, nc);
  if (sc.C == 0) return p;
  const int C = sc.C, NC = sc.NC, head = sc.head;
  const int NS = score_rows(Hq / Hkv);
  const int uw = unit_cols(plan, esz), slot = slot_bytes(plan);
  auto most = [&](int cols, int nw) { return nw * cdiv(cols / uw, NC) * uw; };
  const int partf = imax(imax(most(D, 1), most(I, 2)),
                         head ? (GH + 2) * HD
                              : most((Hq + 2 * Hkv) * HD, 1));
  const int rest = Layout(plan, esz, D, I, GH, capmax, NS, partf, 0).total;
  const int nslot = imin(MAXSLOT, (SMEM_MAX - rest) / slot);
  const int rpi = WORKERS / (HD * esz / 16);
  if (nslot < 2 || nslot * slot < rpi * GH * HD * 4) return p;
  p = {C, NC, head, NC * C, nslot, NS, partf,
       Layout(plan, esz, D, I, GH, capmax, NS, partf, nslot).total,
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
  int B;                  // rows (the rows form, `token_decode_rows.cuh`)
  int seq;                // rows form: the rows are consecutive positions
                          // of one sequence in cache row 0
  int cap[4], capmax;
  float eps, scale;
  int C, NC, head, grid, nslot, NS, partf;
  const float* wscale[7];   // int8: [L, N_i] per-channel scales, or null
  int wn[7];                // the weights' output columns N_i
};

// the seven weights' TMA maps (wq, wk, wv, wo, wgate, wup, wdown: the
// arrays, int8's q or int4's qp), then int4's seven sz maps
struct Maps {
  CUtensorMap m[14];
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

// One thread: int4's [scale, zero] box {32 columns, 4 column blocks, 2
// rows} of a 3-D sz map (128 columns of rows `row` and `row + 1`) into
// shared `dst` (1024-byte aligned, the 128-byte swizzle: 16-byte chunk c of
// 128-byte line l lands at chunk c ^ l), completing on `bar`.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          int col, int row, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3, %4}], [%5], %6;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(0),
         "r"(col / 32), "r"(row), "r"(bar), "l"(policy)
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
// -1 past the count). With `gsum` (int4), each kept group's sum of xs in
// fp32 (a warp's lanes in a fixed order) into gsum [count]. Returns the
// count.
template <typename T>
__device__ __forceinline__ int select_stage(const Args& a, const T* xs, int K,
                                         float thr, int cap, float* scores,
                                         int* idx, float* gsum, int l,
                                         int st) {
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
  if (gsum != nullptr) {
    for (int j = warp; j < count; j += NWARPS) {
      const T* xg = xs + idx[j] * HD + lane * (HD / 32);
      float v = 0.f;
#pragma unroll
      for (int e = 0; e < HD / 32; ++e) v += to_f(xg[e]);
      v = warp_sum(v);
      if (lane == 0) gsum[j] = v;
    }
    __syncthreads();
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

// This block's share of a gather stage: for each unit of the cluster's
// columns, the sums over this block's kept rows of xs[row] * W[layer, row,
// columns], into part [NW][cluster columns]. The kept rows are cut into
// row units of a slot (RU rows), the block's rank taking a contiguous
// share of them. A slot holds two boxes (int4 with NW = 1: one) of BOXB
// bytes: two halves of a row unit (NW = 1) or its gate and up rows (NW =
// 2); int4 adds each box's group's [scale, zero] rows. The producer warp's
// lanes 0 and 1 issue the boxes into the next ring slot (lane 0 first
// waits for the workers to free it); the workers wait for a slot to land,
// FMA, and free it. Arrays: two rows a warp of sixteen 16-byte chunks (a
// quarter-warp reads 128 contiguous bytes, so shared loads do not
// conflict), rows rl and rl + 16 of a box; int8 and int4: four rows a warp
// of eight chunks, rows rl and rl + 32 of a box. gsum (int4): each kept
// group's sum of xs. Returns the ring position past the stage.
template <typename T, int NW, int P>
__device__ __forceinline__ Ring gather(const Maps& maps, const Stage& st,
                                    int layer, const T* xs, const int* idx,
                                    const float* gsum, int count, int rank,
                                    int C, int nslot, unsigned char* sm,
                                    uint32_t bars, float* part, float* red,
                                    Ring q) {
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int TW = unit_cols(P, ESZ);  // columns of a unit
  constexpr int UBP = box_ub(P);         // bytes of a box row
  constexpr int BRP = box_rows(P);       // stored rows of a box
  constexpr int WR = P == PLAN_INT4 ? 2 : 1;   // weight rows a stored row
  constexpr int NB = P == PLAN_INT4 && NW == 1 ? 1 : 2;   // boxes a slot
  constexpr int SLOTB = slot_bytes(P);
  constexpr int ZB = P == PLAN_INT4 ? SZB : 0;
  constexpr int RU = (NW == 1 ? NB : 1) * BRP * WR;   // kept rows a slot
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ncol = st.nu * TW, rows = count * HD, nru = rows / RU;
  const int r0 = split_lo(nru, C, rank), r1 = split_lo(nru, C, rank + 1);
  if (warp == NWORK) {                   // the producer: lane = box
    const uint64_t policy = evict_first();
    const uint32_t dst = smem_u32(sm) + lane * BOXB;
    const uint32_t zdst = smem_u32(sm) + 2 * BOXB + lane * SZB;
    for (int t = 0; t < st.nu; ++t) {
      int m = st.map[lane & 1], col = (st.u0 + t) * TW;
      if (NW == 1) unit_src<TW>(st, st.u0 + t, m, col);
      const CUtensorMap* map = &maps.m[m];
      for (int r = r0; r < r1; ++r) {
        if (lane == 0) {
          mbar_wait_bounded(bars + (MAXSLOT + q.s) * 8, q.ph ^ 1u);
          mbar_expect_tx(bars + q.s * 8, NB * (BOXB + ZB));
        }
        __syncwarp();
        if (lane < NB) {
          const int kr = r * RU + (NW == 1 ? lane * BRP * WR : 0);
          const int g = idx[kr >> 7];
          tma_load(dst + q.s * SLOTB, map, col,
                   layer * (st.K / WR) + g * (HD / WR) + (kr & (HD - 1)) / WR,
                   bars + q.s * 8, policy);
          if (P == PLAN_INT4)
            tma_load3(zdst + q.s * SLOTB, &maps.m[7 + m], col,
                      (layer * (st.K / HD) + g) * 2, bars + q.s * 8, policy);
        }
        q.next(nslot);
      }
    }
    return q;
  }
  constexpr int RL = P == PLAN_STREAM ? 16 : 32;   // row lanes
  constexpr int NCH = UBP / 16;          // 16-byte chunks of a box row
  constexpr int VEC = P == PLAN_STREAM ? 16 / ESZ : 16;   // columns a chunk
  const int rlo = lane / NCH, ch = lane % NCH;
  const int rl = (32 / NCH) * warp + rlo;   // rows rl and rl + RL of a box
  for (int t = 0; t < st.nu; ++t) {
    float acc[NW][VEC];
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[w][e] = 0.f;
    for (int r = r0; r < r1; ++r) {
      mbar_wait_bounded(bars + q.s * 8, q.ph);
      const unsigned char* slot = sm + q.s * SLOTB;
#pragma unroll
      for (int sub = 0; sub < NB; ++sub) {
        const int w = NW == 1 ? 0 : sub;
        const int k0 = r * RU + (NW == 1 ? sub * BRP * WR : 0);
        const T* xg = xs + idx[k0 >> 7] * HD + (k0 & (HD - 1));
        const unsigned char* box = slot + sub * BOXB + ch * 16;
        if constexpr (P == PLAN_STREAM) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int br = rl + RL * hf;
            const float xv = to_f(xg[br]);
            float v[VEC];
            unpack16(*reinterpret_cast<const uint4*>(box + br * UBP), v);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[w][e] = fmaf(xv, v[e], acc[w][e]);
          }
        } else if constexpr (P == PLAN_INT8) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int br = rl + RL * hf;
            const float xv = to_f(xg[br]);
            const uint4 raw = *reinterpret_cast<const uint4*>(box + br * UBP);
            const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
            for (int hh = 0; hh < 4; ++hh)
#pragma unroll
              for (int k = 0; k < 4; ++k)
                acc[w][hh * 4 + k] =
                    fmaf(xv, i8_f(wd[hh], k), acc[w][hh * 4 + k]);
          }
        } else {                         // int4: group k0 / 128's box
          float p[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) p[e] = 0.f;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int br = rl + RL * hf;   // packed row: weight rows br and
            const float xlo = to_f(xg[br]);            // br + 64 of the group
            const float xhi = to_f(xg[HD / 2 + br]);
            const uint4 raw = *reinterpret_cast<const uint4*>(box + br * UBP);
            const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
            for (int hh = 0; hh < 4; ++hh) {
              const uint32_t lo = wd[hh] & 0x0F0F0F0Fu;
              const uint32_t hi = (wd[hh] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
              for (int k = 0; k < 4; ++k)
                p[hh * 4 + k] = fmaf(xhi, nib128_f(hi, k),
                                     fmaf(xlo, nib128_f(lo, k), p[hh * 4 + k]));
            }
          }
          // the group's affine on this lane's rows: (x . (128 + nib)) *
          // scale; row lane 0 adds sum(x_g) (zero - 128 scale) once. The
          // lane's 16 columns are 16-byte chunks (ch & 1) 4 + c4 of line
          // ch / 2 (scale) and 4 + ch / 2 (zero), swizzled (`tma_load3`):
          // the eight chunk lanes of a quarter-warp hit eight bank groups
          const unsigned char* zb = slot + 2 * BOXB + sub * SZB;
          const int zl = ch >> 1;
          const float sg = gsum[k0 >> 7];
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4) {
            const int zq = (ch & 1) * 4 + c4;
            const float4 s4 = *reinterpret_cast<const float4*>(
                zb + zl * 128 + (zq ^ zl) * 16);
            const float4 z4 = *reinterpret_cast<const float4*>(
                zb + (4 + zl) * 128 + (zq ^ (4 + zl)) * 16);
            const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
            const float zv[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int e = c4 * 4 + k;
              acc[w][e] = fmaf(p[e], sv[k], acc[w][e]);
              if (rl == 0)
                acc[w][e] = fmaf(sg, fmaf(-128.f, sv[k], zv[k]), acc[w][e]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + (MAXSLOT + q.s) * 8);
      q.next(nslot);
    }
    // unit t's sums: a warp's row lanes, then the warps in order
#pragma unroll
    for (int o = NCH; o < 32; o <<= 1)
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[w][e] += __shfl_xor_sync(0xffffffffu, acc[w][e], o);
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
// layer). int8 first multiplies each sum by its column's per-channel scale
// at `layer` (gate and up each by their own).
template <typename T, int P>
__device__ __forceinline__ void epilogue(const Args& a, int kind,
                                      const Stage& st, const float* part,
                                      int rank, int C, int layer, const T* h,
                                      void* dst, void* dst2) {
  constexpr int UW = unit_cols(P, static_cast<int>(sizeof(T)));
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
    if constexpr (P == PLAN_INT8) {
      int i = 0, off = c;                // the column's weight and column
      while (i < 2 && off >= st.n[i]) off -= st.n[i++];
      const int m = st.map[i], col = st.c0[i] + off;
      s[0] *= __ldg(a.wscale[m] + static_cast<size_t>(layer) * a.wn[m] +
                    col);
      if (kind == EPI_SILU)
        s[1] *= __ldg(a.wscale[st.map[1]] +
                      static_cast<size_t>(layer) * a.wn[st.map[1]] + col);
    }
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

// N values reduced over the block at once (max or sum) in a fixed order:
// each warp's butterfly, then the warps in order; every thread gets the
// results. `scratch` holds NWARPS * N floats (<= MISC).
template <int N, bool MAX>
__device__ __forceinline__ void block_reduce_n(float (&v)[N],
                                               float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = MAX ? warp_max(v[n]) : warp_sum(v[n]);
  if (lane == 0)
#pragma unroll
    for (int n = 0; n < N; ++n) scratch[warp * N + n] = v[n];
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float r = scratch[n];
    for (int w = 1; w < NWARPS; ++w)
      r = MAX ? fmaxf(r, scratch[w * N + n]) : r + scratch[w * N + n];
    v[n] = r;
  }
  __syncthreads();
}

// Kv head hk's attention by this cluster (block `rank` of C) on the head's
// q|k|v sums in `qraw`: see the header. Two passes over the live rows in
// chunks of CH rows (`chunk_rows`), so that shared memory holds a fixed
// number of scores whatever T: the first finds the one max M of each
// query row over every live row and the current token (where the live
// rows fit one chunk, every block scores them all and no exchange is
// needed; else each block its share, the maxima exchanged through
// distributed shared memory), keeping the block's scores where they fit
// `s` ([GH][NS], NS = `score_rows`); the second takes each of the
// block's rows' weight exp(s - M) rounded to T (the scores recomputed
// chunk by chunk where they did not fit), the sum of the unrounded ones
// and the partial PV. The blocks' PV and denominators are then added in
// rank order: the rounding points of one exact softmax, as the plain
// version's. QG = the query heads a kv head (one kernel each, so that
// the hot loops hold no predicated work for absent heads).
template <typename T, int QG>
__device__ __forceinline__ void attention(const Args& a, const Layout& lay,
                                       const WsLayout& wl, unsigned char* sm,
                                       int l, int pos, int hk, int rank) {
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int VE = 16 / ESZ;              // a chunk's elements
  constexpr int LPR = HD / VE;              // lanes a cache row
  constexpr int RPI = WORKERS / LPR;        // cache rows a pass
  constexpr int CH = chunk_rows(ESZ);       // rows of a chunk: RPI * U
  constexpr int GH = QG;
  constexpr int NS = score_rows(GH);        // scores a query row keeps
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C;
  float* qraw = reinterpret_cast<float*>(sm + lay.qraw);
  float* qf = reinterpret_cast<float*>(sm + lay.qf);
  T* qr = reinterpret_cast<T*>(sm + lay.qr);
  float* sc = reinterpret_cast<float*>(sm + lay.small);
  float* M = sc + MAXGH;
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
  // the live rows [lo, lo + n); the block's share [ra, ra + nr); the rows
  // the first pass scores: all of them where they fit one chunk (`whole`),
  // else the share
  const int lo = a.window > 0 ? max(pos - a.window + 1, 0) : 0;
  const int n = pos - lo;
  const int ra = lo + split_lo(n, C, rank);
  const int nr = split_lo(n, C, rank + 1) - split_lo(n, C, rank);
  const bool whole = n <= CH;
  const int p0 = whole ? lo : ra, np = whole ? n : nr;
  const bool keep = np <= NS;               // the first pass's scores kept
  const int li = tid % LPR, rr = tid / LPR;
  const bool worker = tid < WORKERS;
  // a row lane's chunk of cache rows first + base + rr + u RPI (zeros from
  // count on)
  auto rows = [&](const T* cache, int first, int count, int base,
                  uint4 (&c)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + rr + u * RPI;
      c[u] = worker && t < count
                 ? __ldcg(reinterpret_cast<const uint4*>(
                              cache + static_cast<size_t>(first + t) * HD) +
                          li)
                 : make_uint4(0, 0, 0, 0);
    }
  };
  // the chunk's scores of rows first + base + t into s[g][at + t], t < nc
  auto scores = [&](const uint4 (&kv)[U], int at, int nc) {
    if (worker)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = rr + u * RPI;
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
          if (li == 0 && t < nc) s[g * NS + at + t] = p;
        }
      }
  };
  // the first chunk's K rows (and, where the share is one chunk, its V
  // rows) in flight during the current token's score
  uint4 kv[U], vv[U];
  rows(kcache, p0, np, 0, kv);
  rows(vcache, ra, nr, 0, vv);
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
  // pass 1: each query row's max over the scored rows
  float mx[GH];
#pragma unroll
  for (int g = 0; g < GH; ++g) mx[g] = __int_as_float(0xff800000);   // -inf
  for (int base = 0; base < np; base += CH) {
    if (base > 0) rows(kcache, p0, np, base, kv);
    const int nc = imin(CH, np - base), at = keep ? base : 0;
    scores(kv, at, nc);
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GH; ++g)
      for (int t = tid; t < nc; t += THREADS)
        mx[g] = fmaxf(mx[g], s[g * NS + at + t]);
    if (!keep) __syncthreads();            // s: the next chunk's scores
  }
  block_reduce_n<GH, true>(mx, misc);
  stamp(1);
  if (whole) {                             // every block scored every row
#pragma unroll
    for (int g = 0; g < GH; ++g)
      if (tid == g) M[g] = fmaxf(sc[g], mx[g]);
  } else {                                 // the cluster's maxima
#pragma unroll
    for (int g = 0; g < GH; ++g)
      if (tid == g) amax[g] = mx[g];
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
    }
  }
  __syncthreads();
  stamp(2);
  // pass 2: the share's weights (rounded to T for PV), their unrounded
  // sums and the partial PV, chunk by chunk
  float acc[GH][VE], es[GH];
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    es[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[g][e] = 0.f;
  }
  const int off = whole ? ra - lo : 0;     // the share's first kept score
  for (int base = 0; base < nr; base += CH) {
    const int nc = imin(CH, nr - base);
    int at = off + base;
    if (!keep) {                           // recompute the chunk's scores
      rows(kcache, ra, nr, base, kv);
      at = 0;
      __syncthreads();
      scores(kv, 0, nc);
      __syncthreads();
    }
    if (base > 0) rows(vcache, ra, nr, base, vv);
#pragma unroll
    for (int g = 0; g < GH; ++g)
      for (int t = tid; t < nc; t += THREADS) {
        const float e = expf(s[g * NS + at + t] - M[g]);
        s[g * NS + at + t] = rnd<T>(e);
        es[g] += e;
      }
    __syncthreads();
    if (worker)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = rr + u * RPI;
        if (t < nc) {
          float v[VE];
          unpack16(vv[u], v);
#pragma unroll
          for (int g = 0; g < GH; ++g) {
            const float w = s[g * NS + at + t];
#pragma unroll
            for (int e = 0; e < VE; ++e) acc[g][e] = fmaf(w, v[e], acc[g][e]);
          }
        }
      }
  }
  block_reduce_n<GH, false>(es, misc);
  // the row lanes' partial PV added in order
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
#pragma unroll
  for (int g = 0; g < GH; ++g)
    if (tid == g) apv[GH * HD + g] = es[g];
  stamp(3);
  cluster_sync();
  stamp(4);
  // this block's slice of the head's dimensions, the cluster's blocks in
  // rank order, then the current token
  const uint32_t pb = smem_u32(apv);
  const int d0 = split_lo(HD, C, rank), nd = split_lo(HD, C, rank + 1) - d0;
  for (int i = tid; i < GH * nd; i += THREADS) {
    const int g = i / nd, d = d0 + i % nd;
    const uint32_t addr[2] = {pb + (g * HD + d) * 4, pb + (GH * HD + g) * 4};
    const bool ok[2] = {true, true};
    float pd[2];
    cluster_sums(addr, ok, C, pd);
    const float ec = expf(sc[g] - M[g]);
    st_cg(attn + (hk * GH + g) * HD + d,
          from_f<T>((pd[0] + ec * vnf[d]) * (1.0f / (pd[1] + ec))));
  }
  fence_proxy_async();       // `red` lies in the ring, which TMA refills
}

// QG: the query heads a kv head (1, 2, 4 or 8), one kernel each, so that
// a launch's code holds one attention body (the code's size costs time:
// every phase of a layer runs once between the others); P: the weight
// plan (the quantized plans with T = bf16)
template <typename T, int QG, int P>
__global__ void __launch_bounds__(THREADS, 1)
    token_kernel(const __grid_constant__ Maps maps,
                 const __grid_constant__ Args a) {
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int UW = unit_cols(P, ESZ);
  static_assert(P == PLAN_STREAM || ESZ == 2, "quantized plans: bf16");
  extern __shared__ __align__(1024) unsigned char sm[];
  const int tid = threadIdx.x, b = blockIdx.x, warp = tid >> 5;
  const int rank = cluster_rank(), cid = cluster_index();
  const int D = a.D, I = a.I, C = a.C, GH = QG;
  const Layout lay(P, ESZ, D, I, GH, a.capmax, a.NS, a.partf, a.nslot);
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
  float* gsum = P == PLAN_INT4 ? reinterpret_cast<float*>(sm + lay.gsum)
                               : nullptr;
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
      ring = gather<T, 2, P>(maps, st, l, xs, idx, gsum, count, rank, C,
                             a.nslot, sm, bars, part, red, ring);
    else
      ring = gather<T, 1, P>(maps, st, l, xs, idx, gsum, count, rank, C,
                             a.nslot, sm, bars, part, red, ring);
    __syncthreads();
    stamp(l, ST_GEND + i);
    if (a.stamps != nullptr && tid == 0)
      a.stamps[l * sw + NSTAMP + (NBAR + i) * a.grid + b] =
          static_cast<long long>(globaltimer());
    cluster_sync();
    epilogue<T, P>(a, kind, st, part, rank, C, l, h, dst, dst2);
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
    const int c0 = select_stage(a, xs, D, thr[0], a.cap[0], scores, idx,
                                  gsum, l, 0);
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
    const int c1 = select_stage(a, xs, D, thr[1], a.cap[1], scores, idx,
                                  gsum, l, 1);
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
    const int c2 = select_stage(a, xs, D, thr[2], a.cap[2], scores, idx,
                                  gsum, l, 2);
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
    const int c3 = select_stage(a, xs, I, thr[3], a.cap[3], scores, idx,
                                  gsum, l, 3);
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

// A 2-D map over [rows, N] elements of esz bytes (type dt): boxes of bc
// columns by br rows, no swizzle (or `swz`).
bool encode(EncodeTiled fn, CUtensorMap* map, const void* p,
            CUtensorMapDataType dt, int esz, long long rows, int N, int bc,
            int br, CUtensorMapSwizzle swz = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * esz};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(bc),
                             static_cast<cuuint32_t>(br)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, dt, 2, const_cast<void*>(p), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// int4's sz [rows, N] fp32 as a 3-D map {32 columns, N / 32 column
// blocks, rows}: boxes {32, 4, 2} (128 columns of a scale row and its zero
// row, eight 128-byte lines) with the 128-byte swizzle, so that the
// workers' reads of 16 columns a lane do not conflict.
bool encode_sz(EncodeTiled fn, CUtensorMap* map, const void* p,
               long long rows, int N) {
  const cuuint64_t dims[3] = {32, static_cast<cuuint64_t>(N / 32),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {128, static_cast<cuuint64_t>(N) * 4};
  const cuuint32_t box[3] = {32, HD / 32, 2};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(p),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Weight i's map (and int4's sz map i) of a [L, K, N] projection in plan
// `plan`: arrays [L K, N] of the stream type in boxes of 256 bytes x 32
// rows; int8 q [L K, N] and int4 qp [L K/2, N] as bytes in boxes of 128 x
// 64 rows; sz [L K/128 2, N] fp32 as `encode_sz`.
bool encode_weight(EncodeTiled fn, Maps& maps, int i, int plan, int esz,
                   const void* w, const void* sz, int L, int K, int N) {
  const long long LK = static_cast<long long>(L) * K;
  if (plan == PLAN_STREAM)
    return encode(fn, &maps.m[i], w,
                  esz == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  esz, LK, N, box_ub(plan) / esz, box_rows(plan));
  if (!encode(fn, &maps.m[i], w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
              plan == PLAN_INT4 ? LK / 2 : LK, N, box_ub(plan),
              box_rows(plan)))
    return false;
  return plan != PLAN_INT4 || encode_sz(fn, &maps.m[7 + i], sz, LK / HD * 2,
                                       N);
}

// The kernel of (plan, dtype, GH): defined by the translation unit that
// builds it (`token_decode.cu`: the arrays, `token_decode_quant.cu`: int8
// and int4), null for the others.
const void* kernel_of(int plan, int dtype, int GH);

// The kernel of (T, GH, P): its function, with its attribute set once
// (the most dynamic shared memory).
template <typename T, int QG, int P>
const void* kernel_fn() {
  static bool set = false;
  auto fn = token_kernel<T, QG, P>;
  if (!set) {
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX) != cudaSuccess)
      return nullptr;
    set = true;
  }
  return reinterpret_cast<const void*>(fn);
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

// The card's resident clusters of each size C for the kernel of (plan,
// dtype, GH), at one block an SM (cudaOccupancyMaxActiveClusters, asked
// once a device): nc[C] for C in [0, MAXC], 0 where a size is refused.
const int* cluster_table(int plan, int dtype, int GH) {
  static int table[64][16][MAXC + 1];
  static bool done[64][16];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return nullptr;
  const int k = (plan == PLAN_STREAM ? (dtype == 0 ? 0 : 4)
                                     : 4 + 4 * plan) + __builtin_ctz(GH);
  int* nc = table[dev][k];
  if (!done[dev][k]) {
    const void* fn = kernel_of(plan, dtype, GH);
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

bool form_ok(int plan, int dtype) {
  return plan == PLAN_STREAM ? (dtype == 0 || dtype == 1)
                             : (plan == PLAN_INT8 || plan == PLAN_INT4) &&
                                   dtype == 1;
}

// The resident clusters of C blocks of the kernel of (plan, dtype 0 fp32
// / 1 bf16, GH query heads a kv head) on the current device. -1 where the
// kernel's attributes cannot be set.
int clusters_impl(int plan, int dtype, int GH, int C) {
  if (!form_ok(plan, dtype) || GH < 1 || MAXGH % GH || C < 0 || C > MAXC)
    return -1;
  const int* nc = cluster_table(plan, dtype, GH);
  return nc == nullptr ? -1 : nc[C];
}

// The plan into out int32 [11] (see `teal_token_plan`); 0, or -1 where
// the shapes take none.
int plan_impl(int plan, int dtype, int D, int I, int Hq, int Hkv, int T,
              int window, int capmax, int n_sms, int L, int* out) {
  if (!form_ok(plan, dtype) || !heads_ok(Hq, Hkv) || L < 1) return -1;
  const int* nc = cluster_table(plan, dtype, Hq / Hkv);
  if (nc == nullptr) return -1;
  const TokPlan p = token_plan(plan, dtype == 0 ? 4 : 2, D, I, Hq, Hkv, T,
                               window, capmax, n_sms, nc);
  if (p.smem < 0) return -1;
  const int v[11] = {p.grid, THREADS, p.smem, static_cast<int>(p.ws),
                     (p.head ? NBAR - 1 : NBAR) * L, 0, p.C, p.NC, p.head,
                     p.nslot, p.NS};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

// One token through the L layers in plan `plan` (see `teal_token_decode`):
// w the seven weights (int4: qp), sz int4's seven sz stacks, sc int8's
// seven scale stacks (null where the plan has none).
int decode_impl(int plan, int dtype, const void* x, const void* thr,
                const void* pos, const void* cs, const void* na,
                const void* nm, const void* const (&w)[7],
                const void* const (&sz)[7], const void* const (&sc)[7],
                void* kc, void* vc, void* out, void* sel, void* stamps,
                void* ws, int L, int D, int I, int Hq, int Hkv, int T,
                int window, const int (&caps)[4], int fixed, float eps,
                int n_sms, int empty, void* stream) {
  cudaGetLastError();  // clear any stale error of this library
  int capmax = 0;
  for (int c : caps) capmax = imax(capmax, c);
  bool given = true;
  for (int i = 0; i < 7; ++i)
    given = given && w[i] != nullptr &&
            (plan != PLAN_INT4 || sz[i] != nullptr) &&
            (plan != PLAN_INT8 || sc[i] != nullptr);
  if (!form_ok(plan, dtype) || !given || !heads_ok(Hq, Hkv) || L < 1 ||
      caps[0] < 1 || caps[0] > D / HD || caps[1] < 1 || caps[1] > D / HD ||
      caps[2] < 1 || caps[2] > D / HD || caps[3] < 1 || caps[3] > I / HD)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* nc = cluster_table(plan, dtype, Hq / Hkv);
  if (nc == nullptr) return -1;
  const int esz = dtype == 0 ? 4 : 2;
  const TokPlan p = token_plan(plan, esz, D, I, Hq, Hkv, T, window, capmax,
                               n_sms, nc);
  EncodeTiled fn = encode_tiled();
  if (p.smem < 0 || fn == nullptr) return -1;
  const int kn[7][2] = {{D, D}, {D, Hkv * HD}, {D, Hkv * HD}, {D, D},
                        {D, I}, {D, I}, {I, D}};
  // the maps of the last call's weights are kept (a decode loop passes the
  // same stacks every token), keyed on the plan, the pointers and shapes
  static Maps maps;
  static const void* key[14] = {};
  static int key_shape[6] = {-1};
  const int shape[6] = {plan, esz, L, D, I, Hkv};
  bool same = true;
  for (int i = 0; i < 7; ++i)
    same = same && key[i] == w[i] && key[7 + i] == sz[i];
  for (int i = 0; i < 6; ++i) same = same && key_shape[i] == shape[i];
  if (!same) {
    key_shape[0] = -1;
    for (int i = 0; i < 7; ++i)
      if (!encode_weight(fn, maps, i, plan, esz, w[i], sz[i], L, kn[i][0],
                         kn[i][1]))
        return -1;
    for (int i = 0; i < 7; ++i) {
      key[i] = w[i];
      key[7 + i] = sz[i];
    }
    for (int i = 0; i < 6; ++i) key_shape[i] = shape[i];
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
  a.B = 1;
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
  for (int i = 0; i < 7; ++i) {
    a.wscale[i] = static_cast<const float*>(sc[i]);
    a.wn[i] = kn[i][1];
  }
  auto s = static_cast<cudaStream_t>(stream);
  // the barrier counter starts at 0 (a memset node under stream capture)
  cudaError_t e = cudaMemsetAsync(ws, 0, 256, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  config(cfg, attr, p.C, p.grid, s);
  const void* k = kernel_of(plan, dtype, Hq / Hkv);
  if (k == nullptr) return -1;
  void* params[2] = {&maps, &a};
  e = cudaLaunchKernelExC(&cfg, k, params);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
