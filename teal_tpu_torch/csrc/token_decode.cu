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
// Design. A cooperative grid of P blocks (one an SM, all resident), 256
// threads each. Blocks run in parallel in no order, where the TPU's grid
// steps ran in order, so the layer is cut by grid-wide barriers (a counter
// in the workspace, zeroed by a memset before the launch; every spin
// bounded by %globaltimer and a trap, so a missed arrival fails the run
// rather than hanging it):
//   - every block keeps its own copy of the stream h in shared memory and
//     updates it identically; every block computes each stage's selection
//     input, scores and kept set itself from the same values in the same
//     order, so all blocks keep the same groups;
//   - a gather stage cuts its work -- (output tile of 256 bytes of each
//     slab row) x (kept group) x (16-row step) -- into P equal contiguous
//     ranges (stream-K: a block may finish one tile and start the next),
//     streams its slab rows through a private 8-stage cp.async ring a
//     thread (K1's stream), and writes one fp32 partial a tile it touched
//     into the workspace. After the barrier, a consumer adds a tile's
//     partials in block order: a fixed order, no data atomics;
//   - attention: Hkv x SA blocks, SA blocks a kv head each taking an equal
//     share of the live rows; the head's blocks exchange their maxima, then
//     their partial PV and sums, through the workspace behind two barriers
//     of their own (a counter a kv head), and each combines a slice of the
//     head's dimensions into the attention output (T, workspace);
//   - o and down: every block adds the tiles' partials to its stream;
//     gate|up: block b forms silu(gate) * up for its 1/P of the columns
//     into the workspace, read back by every block after one more barrier.
// Six grid barriers a layer (after q|k|v, attention, o, gate|up, the
// intermediate, down) and two a kv head. Data written by another block is
// read through L2 (ld.global.cg) after a barrier; weights stream through
// cp.async.cg with an L2 evict-first policy, so that they do not push the
// workspace and the cache rows out of L2 (measured on the H100: 5.4 ms a
// 7B token without it, 4.3 with it). Every phase runs once a layer
// between the others, so the code's size costs time: the phases' helpers
// are not inlined and the kernel is built once for each count of query
// heads a kv head (4.3 ms a 7B token, then 3.9, then 3.6; PERF.md). With
// `empty` the kernel runs the barriers alone (their floor). The plan
// (grid, shared bytes, workspace bytes, SA) comes from shapes only
// (`token_plan`, exported as `teal_token_plan` and mirrored by the
// wrapper's `_token_plan`); `sel`, where given, receives each stage's kept
// count and groups (written by block 0); `stamps`, block 0's
// %globaltimer at the points NSTAMP lists.
#include "common.cuh"

using namespace teal;

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int HD = 128;                // head dim = group size
constexpr int PIECE = 256;             // bytes of a slab row a tile reads
constexpr int CPR = PIECE / 16;        // 16-byte chunks a row piece
constexpr int RLANES = THREADS / CPR;  // slab rows a step
constexpr int STEPS = HD / RLANES;     // steps a kept group
constexpr int RING = 64 * 1024;        // a block's cp.async ring, bytes
constexpr int MAXGH = 8;               // query heads a kv head
constexpr int MAXSA = 16;              // attention blocks a kv head
constexpr int U = 8;                   // cache rows in flight a row lane
constexpr int MAXCH = 8;               // 16-byte chunks of h a thread
constexpr int SMEM_MAX = 232448;       // a block's shared memory on Hopper
constexpr int NBAR_GRID = 6;           // grid barriers a layer
constexpr int NBAR_HEAD = 2;           // kv-head barriers a layer
// trace stamps a layer: its start, each grid barrier's arrival and exit,
// each gather's start (after its selection), five points of attention,
// the end of the two stream updates
constexpr int ST_GATHER = 1 + 2 * NBAR_GRID, ST_ATTN = ST_GATHER + 4;
constexpr int ST_UPD = ST_ATTN + 5, NSTAMP = ST_UPD + 2;
constexpr int CTR = 32;                // uint32 a counter: one 128-byte line
constexpr unsigned long long SPIN_NS = 2000000000ull;   // 2 s

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr size_t al256(size_t n) {
  return (n + 255) & ~static_cast<size_t>(255);
}
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// partial slots a tile: the blocks whose ranges meet one tile of n_t
__host__ __device__ constexpr int segs(int P, int n_t) { return P / n_t + 2; }

// Shared memory, bytes: the ring (attention: the row lanes' PV sums [RPI]
// [GH][128] fp32), the row lanes' sums [RLANES][2]
// [TW] fp32, the stream h [D] and a stage's selection input [max(D, I)] of
// T, the scores, the kept groups, 64 floats of scratch, then attention's
// raw q|k|v sums [GH + 2][128] and RoPE'd q|k [GH + 1][128] fp32, q
// rounded [GH][128] T, four [8] fp32 (current score, its weight, max,
// sum) and the score slice [GH][NS] fp32.
struct Layout {
  int red, h, xs, scores, idx, misc, qraw, qf, qr, small, s, total;
  __host__ __device__ Layout(int esz, int D, int I, int GH, int capmax,
                             int NS) {
    const int tw = PIECE / esz;
    red = RING;
    h = red + RLANES * 2 * tw * 4;
    xs = h + ((D * esz + 15) & ~15);
    scores = xs + ((imax(D, I) * esz + 15) & ~15);
    idx = scores + pad4(imax(D, I) / HD) * 4;
    misc = idx + pad4(capmax + 1) * 4;
    qraw = misc + 64 * 4;
    qf = qraw + (GH + 2) * HD * 4;
    qr = qf + (GH + 1) * HD * 4;
    small = qr + ((GH * HD * esz + 15) & ~15);
    s = small + 4 * MAXGH * 4;
    total = s + GH * NS * 4;
  }
};

// Workspace, bytes from its (256-byte aligned) base: the barrier counters
// (1 grid + Hkv heads, a 128-byte line each, zeroed before the launch:
// spinning blocks and arrivals at one counter do not share a line with
// another's), the four gather stages'
// partials [tiles][segs][NW][TW] fp32, attention's maxima and sums [Hkv]
// [SA][GH] and partial PV [Hkv][SA][GH][128] fp32, the attention output
// [Hq * 128] and the intermediate [I] of T.
struct WsLayout {
  size_t bar, pqkv, po, pgu, pdn, amax, aden, apv, attn, inter, total;
  __host__ __device__ WsLayout(int esz, int D, int I, int Hq, int Hkv, int P,
                               int SA) {
    const int tw = PIECE / esz, GH = Hq / Hkv;
    const int nq = (Hq + 2 * Hkv) * HD / tw, nd = D / tw, ni = I / tw;
    bar = 0;
    pqkv = al256(static_cast<size_t>(1 + Hkv) * CTR * 4);
    po = al256(pqkv + static_cast<size_t>(nq) * segs(P, nq) * tw * 4);
    pgu = al256(po + static_cast<size_t>(nd) * segs(P, nd) * tw * 4);
    pdn = al256(pgu + static_cast<size_t>(ni) * segs(P, ni) * 2 * tw * 4);
    amax = al256(pdn + static_cast<size_t>(nd) * segs(P, nd) * tw * 4);
    aden = al256(amax + static_cast<size_t>(Hkv) * SA * GH * 4);
    apv = al256(aden + static_cast<size_t>(Hkv) * SA * GH * 4);
    attn = al256(apv + static_cast<size_t>(Hkv) * SA * GH * HD * 4);
    inter = al256(attn + static_cast<size_t>(Hq) * HD * esz);
    total = al256(inter + static_cast<size_t>(I) * esz);
  }
};

struct TokPlan {
  int grid, smem, SA, NS;
  size_t ws;
};

// The plan from shapes only: P = the SM count (one block an SM), SA =
// min(16, P / Hkv) attention blocks a kv head, NS = a block's score slice
// (its share of the most live rows, padded to 4), the shared and workspace
// bytes; smem -1 where the shapes take no plan.
TokPlan token_plan(int esz, int D, int I, int Hq, int Hkv, int T, int window,
                   int capmax, int n_sms) {
  TokPlan p = {0, -1, 0, 0, 0};
  if (D <= 0 || I <= 0 || D % HD || I % HD || Hkv <= 0 || Hq != D / HD ||
      Hq % Hkv || MAXGH % (Hq / Hkv) || Hkv > n_sms || T < 1 || capmax < 1 ||
      capmax > imax(D, I) / HD || D * esz > 16 * MAXCH * THREADS)
    return p;
  const int SA = n_sms / Hkv < MAXSA ? n_sms / Hkv : MAXSA;
  const int live = window > 0 && window < T ? window : T;
  const int NS = pad4(cdiv(imax(live - 1, 1), SA));
  const Layout lay(esz, D, I, Hq / Hkv, capmax, NS);
  if (lay.total > SMEM_MAX) return p;
  p = {n_sms, lay.total, SA, NS,
       WsLayout(esz, D, I, Hq, Hkv, n_sms, SA).total};
  return p;
}

struct Args {
  const void* x;          // [D] the token's embedding row, T
  const float* thr;       // [L, 7]
  const int* pos;         // [1]
  const float* cs;        // [2, 128] cos, sin at pos
  const void* na;         // [L, D] attention-norm gains, T
  const void* nm;         // [L, D] mlp-norm gains, T
  const void* w[7];       // wq, wk, wv, wo, wgate, wup, wdown: [L, K, N] T
  void* kc;               // [L, 1, Hkv, T, 128]
  void* vc;
  void* out;              // [D] the stream after the last layer
  int* sel;               // [L, 4, 1 + capmax] kept counts and groups, or null
  long long* stamps;      // [L, NSTAMP] block 0's %globaltimer trace, or null
  unsigned char* ws;
  int L, D, I, Hq, Hkv, T, window, fixed, empty;
  int cap[4], capmax;
  float eps, scale;
  int P, SA, NS;
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

// Wait until `target` arrivals (this block's included) have reached the
// counter, as CUTLASS's GenericBarrier does: the block's threads meet,
// thread 0 arrives with a release (ordering the block's writes before it)
// and spins on an acquire load, and the block meets again, so every
// thread's later reads (through L2) see the other blocks' writes. A spin
// longer than SPIN_NS traps.
__device__ __noinline__ void barrier(unsigned* ctr, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n"
                 :: "l"(ctr), "r"(1u) : "memory");
    const unsigned long long t0 = globaltimer();
    while (ld_acquire(ctr) < target)
      if (globaltimer() - t0 > SPIN_NS) __trap();
  }
  __syncthreads();
}

// 16 bytes global -> shared through L2, evicted first: the weights stream
// once a token, and must not push the workspace (partials, attention
// output, intermediate) and the cache rows out of L2.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ void cp_async16_ef(void* dst, const void* src,
                                              uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
      :: "r"(smem_u32(dst)), "l"(src), "l"(policy));
}

template <typename T>
__device__ __forceinline__ void st_cg(T* p, T v) {
  if constexpr (sizeof(T) == 4)
    __stcg(reinterpret_cast<float*>(p), *reinterpret_cast<float*>(&v));
  else
    __stcg(reinterpret_cast<unsigned short*>(p),
           *reinterpret_cast<unsigned short*>(&v));
}

// A gather stage's cut: W work units (tiles x kept groups x STEPS) in P
// ranges, block b taking units [W b / P, W (b + 1) / P); upt units a tile.
// W < 2^31 / P for every shape the plan takes.
struct Cut {
  int W, upt, P, seg;
  __device__ int lo(int b) const { return W * b / P; }
  // the block whose range holds unit u
  __device__ int owner(int u) const { return ((u + 1) * P - 1) / W; }
};

// Four columns [c, c + 4) (of NWT = NW x TW a tile) of tile t: its
// partials added in block order. Every block from the owner of the tile's
// first unit to the owner of its last wrote one (a zero where its range is
// empty), so the sum is in a fixed order; the loads of up to RSLOTS
// partials are in flight at once (zeros past the tile's last add nothing).
constexpr int RSLOTS = 8;
__device__ __noinline__ float4 reduce4(const float* part, const Cut& k,
                                       int t, int NWT, int c) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (k.W == 0) return s;
  const int bf = k.owner(t * k.upt);
  const int n = k.owner(t * k.upt + k.upt - 1) - bf + 1;
  const float4* p = reinterpret_cast<const float4*>(
      part + static_cast<size_t>(t) * k.seg * NWT + c);
  const int stride = NWT / 4;
  for (int j0 = 0; j0 < n; j0 += RSLOTS) {
    float4 v[RSLOTS];
#pragma unroll
    for (int j = 0; j < RSLOTS; ++j)
      v[j] = j0 + j < n ? __ldcg(p + (j0 + j) * stride)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < RSLOTS; ++j) {
      s.x += v[j].x; s.y += v[j].y; s.z += v[j].z; s.w += v[j].w;
    }
  }
  return s;
}

// The kept groups of a stage's selection input xs [K] (T, shared): every
// block the same. Block 0 records them in `sel` row `row` (count, groups,
// -1 past the count). Returns the count.
template <typename T>
__device__ __noinline__ int select_stage(const Args& a, const T* xs, int K,
                                         float thr,
                            int cap, float* scores, int* idx, int l, int st) {
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
__device__ __noinline__ void fold(const T* h, const uint4 (&g)[MAXCH], int D,
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
__device__ __noinline__ void load_cg(T* dst, const T* src, int n) {
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

// A gather stage's weights: nw concatenated weights (NW = 1), or the pair
// (gate, up) read at the same columns (NW = 2); their widths and K.
struct Stage {
  const unsigned char* w[3];
  int n[3], nw, K, tiles;
};

// This block's range of a gather stage: y[c] = sum over kept rows k of
// xs[k] * W[layer, k, c], a partial a tile touched, into `part`. A thread
// streams its 16-byte chunk of each unit's rows through its own slots of a
// ring of 64 KB a block (16 stages, 8 for the gate|up pair) and does its
// FMAs on what it copied itself: no block barrier but at a tile's end.
// A thread's slots: RING / (THREADS 16 NW) stages of 16 bytes a weight.
template <typename T, int NW>
__device__ __noinline__ void gather(const Stage& st, size_t layer,
                                    const T* xs,
                       const int* idx, const Cut& k, float* part,
                       unsigned char* sm, float* red) {
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int TW = PIECE / ESZ;           // tile columns
  constexpr int VEC = 16 / ESZ;             // a chunk's columns
  constexpr int NSTG = RING / (THREADS * 16 * NW);   // ring stages
  const int tid = threadIdx.x, q = tid % CPR, rl = tid / CPR;
  const int b = blockIdx.x;
  if (k.W == 0) return;
  const int u0 = k.lo(b), u1 = k.lo(b + 1);
  if (u0 == u1) {
    // an empty range inside a tile's blocks: a zero partial in its slot
    if (u0 < k.W && u0 % k.upt != 0) {
      const int t = u0 / k.upt;
      float* dst = part + (static_cast<size_t>(t) * k.seg +
                           (b - k.owner(t * k.upt))) * NW * TW;
      for (int c = tid; c < NW * TW; c += THREADS) __stcg(dst + c, 0.f);
    }
    return;
  }
  uint4* ring = reinterpret_cast<uint4*>(sm);
  const uint64_t policy = evict_first();
  // the copy cursor: unit cu, tile ct, unit cr within it, its sources
  int cu = u0, ct = u0 / k.upt, cr = u0 - ct * k.upt;
  const unsigned char* src[NW];
  int srcn[NW];
  auto set_src = [&](int t) {
    int wi = 0, off = t * TW;
    if (NW == 1)
      while (off >= st.n[wi]) off -= st.n[wi++];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      srcn[w] = st.n[wi + w];
      src[w] = st.w[wi + w] +
               (layer * st.K * srcn[w] + off + q * VEC) * ESZ;
    }
  };
  set_src(ct);
  auto copy = [&]() {
    if (cu < u1) {
      const size_t row =
          static_cast<size_t>(idx[cr / STEPS]) * HD + (cr % STEPS) * RLANES + rl;
#pragma unroll
      for (int w = 0; w < NW; ++w)
        cp_async16_ef(&ring[((cu % NSTG) * NW + w) * THREADS + tid],
                      src[w] + row * srcn[w] * ESZ, policy);
      ++cu;
      if (++cr == k.upt) {
        cr = 0;
        if (cu < u1) set_src(++ct);
      }
    }
    cp_async_commit();
  };
  float acc[NW][VEC];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[w][e] = 0.f;
  // the row lanes' sums of tile t, added in row-lane order, as this
  // block's partial slot (its index among the tile's blocks)
  auto flush = [&](int t) {
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        red[(rl * NW + w) * TW + q * VEC + e] = acc[w][e];
        acc[w][e] = 0.f;
      }
    __syncthreads();
    float* dst = part + (static_cast<size_t>(t) * k.seg +
                         (b - k.owner(t * k.upt))) * NW * TW;
    for (int c = tid; c < NW * TW; c += THREADS) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < RLANES; ++r) s += red[r * NW * TW + c];
      __stcg(dst + c, s);
    }
    __syncthreads();
  };
#pragma unroll
  for (int i = 0; i < NSTG - 1; ++i) copy();
  int t = u0 / k.upt, r = u0 - t * k.upt, cur = t;
  for (int u = u0; u < u1; ++u) {
    cp_async_wait<NSTG - 2>();              // unit u has landed
    copy();                                 // into the slot u - 1 left
    if (t != cur) {
      flush(cur);
      cur = t;
    }
    const float xv = to_f(xs[idx[r / STEPS] * HD + (r % STEPS) * RLANES + rl]);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      float v[VEC];
      unpack16(ring[((u % NSTG) * NW + w) * THREADS + tid], v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[w][e] = fmaf(xv, v[e], acc[w][e]);
    }
    if (++r == k.upt) {
      r = 0;
      ++t;
    }
  }
  flush(cur);
  cp_async_wait<0>();
  __syncthreads();
}

// One kv head's share of attention (block j of SA): see the header. QG =
// the query heads a kv head (one instantiation each, so that the hot loops
// hold no predicated work for absent heads).
template <typename T, int QG>
__device__ __noinline__ void attention(const Args& a, const Layout& lay,
                          const WsLayout& wl, unsigned char* sm, int l,
                          int pos, const Cut& kq, int hk, int j,
                          unsigned* bars) {
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int TW = PIECE / ESZ;
  constexpr int VE = 16 / ESZ;              // a chunk's elements
  constexpr int LPR = HD / VE;              // lanes a cache row
  constexpr int RPI = THREADS / LPR;        // cache rows a pass
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int GH = QG;
  const int SA = a.SA, NS = a.NS;
  float* qraw = reinterpret_cast<float*>(sm + lay.qraw);
  float* qf = reinterpret_cast<float*>(sm + lay.qf);
  T* qr = reinterpret_cast<T*>(sm + lay.qr);
  float* sc = reinterpret_cast<float*>(sm + lay.small);
  float* ec = sc + MAXGH;
  float* M = ec + MAXGH;
  float* den = M + MAXGH;
  float* s = reinterpret_cast<float*>(sm + lay.s);
  float* misc = reinterpret_cast<float*>(sm + lay.misc);
  const float* pq = reinterpret_cast<const float*>(a.ws + wl.pqkv);
  float* amax = reinterpret_cast<float*>(a.ws + wl.amax);
  float* aden = reinterpret_cast<float*>(a.ws + wl.aden);
  float* apv = reinterpret_cast<float*>(a.ws + wl.apv);
  T* attn = reinterpret_cast<T*>(a.ws + wl.attn);
  const int hb = hk * SA;                   // the head's first slot
  auto stamp = [&](int i) {
    if (a.stamps != nullptr && blockIdx.x == 0 && tid == 0)
      a.stamps[l * NSTAMP + ST_ATTN + i] =
          static_cast<long long>(globaltimer());
  };

  // the head's raw q rows, k and v: the q|k|v tiles' partials
  for (int i = tid; i < (GH + 2) * HD / 4; i += THREADS) {
    const int r = i * 4 / HD, d = i * 4 % HD;
    const int head = r < GH ? hk * GH + r
                            : (r == GH ? a.Hq + hk : a.Hq + a.Hkv + hk);
    const int col = head * HD + d;
    reinterpret_cast<float4*>(qraw)[i] =
        reduce4(pq, kq, col / TW, TW, col % TW);
  }
  __syncthreads();
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
  if (j == 0 && tid < HD) {    // row pos: read by no block of this layer
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

  // the block's share [ra, rb) of the live rows [lo, pos)
  const int lo = a.window > 0 ? max(pos - a.window + 1, 0) : 0;
  const int n = pos - lo;
  const int ra = lo + split_lo(n, SA, j), nr = split_lo(n, SA, j + 1) -
                                               split_lo(n, SA, j);
  const int li = tid % LPR, rr = tid / LPR;
  // a row lane's chunk of cache rows base + rr + u RPI (zeros past nr)
  auto rows = [&](const T* cache, int base, uint4 (&c)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + rr + u * RPI;
      c[u] = t < nr ? __ldcg(reinterpret_cast<const uint4*>(
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
        unpack16(*reinterpret_cast<const uint4*>(qr + g * HD + li * VE), qv);
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
  // the share's max per query row, then every block's: the one max M
  for (int g = 0; g < GH; ++g) {
    float m = __int_as_float(0xff800000);   // -inf
    for (int t = tid; t < nr; t += THREADS) m = fmaxf(m, s[g * NS + t]);
    m = block_max(m, misc);
    if (tid == 0) __stcg(amax + (hb + j) * GH + g, m);
  }
  stamp(3);
  barrier(bars + (1 + hk) * CTR, (NBAR_HEAD * l + 1) * SA);
  stamp(1);
  if (tid < GH) {
    float m = sc[tid], mv[MAXSA];
#pragma unroll
    for (int r = 0; r < MAXSA; ++r)
      if (r < SA) mv[r] = __ldcg(amax + (hb + r) * GH + tid);
#pragma unroll
    for (int r = 0; r < MAXSA; ++r)
      if (r < SA) m = fmaxf(m, mv[r]);
    M[tid] = m;
    ec[tid] = expf(sc[tid] - m);
  }
  __syncthreads();
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
  stamp(4);
  float* red = reinterpret_cast<float*>(sm);        // [RPI][GH][128]
#pragma unroll
  for (int g = 0; g < GH; ++g)
#pragma unroll
    for (int e = 0; e < VE; ++e)
      red[(rr * GH + g) * HD + li * VE + e] = acc[g][e];
  __syncthreads();
  for (int i = tid; i < GH * HD; i += THREADS) {
    float p = 0.f;
    for (int r = 0; r < RPI; ++r) p += red[r * GH * HD + i];
    __stcg(apv + static_cast<size_t>(hb + j) * GH * HD + i, p);
  }
  if (tid < GH) __stcg(aden + (hb + j) * GH + tid, den[tid]);
  barrier(bars + (1 + hk) * CTR, (NBAR_HEAD * l + 2) * SA);
  stamp(2);
  // this block's slice of the head's dimensions, its blocks in order
  const int d0 = split_lo(HD, SA, j), nd = split_lo(HD, SA, j + 1) - d0;
  for (int i = tid; i < GH * nd; i += THREADS) {
    const int g = i / nd, d = d0 + i % nd;
    // every block's part in flight at once, added in block order
    float pv[MAXSA], dv[MAXSA];
#pragma unroll
    for (int r = 0; r < MAXSA; ++r)
      if (r < SA) {
        pv[r] = __ldcg(apv + (static_cast<size_t>(hb + r) * GH + g) * HD + d);
        dv[r] = __ldcg(aden + (hb + r) * GH + g);
      }
    float p = 0.f, dn = 0.f;
#pragma unroll
    for (int r = 0; r < MAXSA; ++r)
      if (r < SA) {
        p += pv[r];
        dn += dv[r];
      }
    st_cg(attn + (hk * GH + g) * HD + d,
          from_f<T>((p + ec[g] * vnf[d]) * (1.0f / (dn + ec[g]))));
  }
}

// QG: the query heads a kv head (1, 2, 4 or 8), one kernel each, so that
// a launch's code holds one attention body (the code's size costs time:
// every phase of a layer runs once between the others)
template <typename T, int QG>
__global__ void __launch_bounds__(THREADS, 1) token_kernel(Args a) {
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int TW = PIECE / ESZ;
  extern __shared__ __align__(128) unsigned char sm[];
  const int tid = threadIdx.x, b = blockIdx.x, P = a.P;
  const int D = a.D, I = a.I, GH = QG;
  const Layout lay(ESZ, D, I, GH, a.capmax, a.NS);
  const WsLayout wl(ESZ, D, I, a.Hq, a.Hkv, P, a.SA);
  unsigned* bars = reinterpret_cast<unsigned*>(a.ws + wl.bar);
  const bool att = b < a.Hkv * a.SA;
  unsigned nbar = 0;                       // grid barriers passed
  // the trace (`stamps`, block 0): see NSTAMP
  auto stamp_at = [&](int l, int i) {
    if (a.stamps != nullptr && b == 0 && tid == 0)
      a.stamps[l * NSTAMP + i] = static_cast<long long>(globaltimer());
  };
  auto stamp = [&](int i) { stamp_at(nbar / NBAR_GRID, i); };
  auto grid_barrier = [&]() {
    stamp(1 + 2 * (nbar % NBAR_GRID));
    __syncthreads();
    barrier(bars, (nbar + 1) * P);
    stamp(2 + 2 * (nbar % NBAR_GRID));
    ++nbar;
  };
  if (a.empty) {
    for (int l = 0; l < a.L; ++l) {
      grid_barrier();
      if (att) {
        barrier(bars + (1 + b / a.SA) * CTR, (NBAR_HEAD * l + 1) * a.SA);
        barrier(bars + (1 + b / a.SA) * CTR, (NBAR_HEAD * l + 2) * a.SA);
      }
      for (int i = 1; i < NBAR_GRID; ++i) grid_barrier();
    }
    return;
  }
  const int pos = *a.pos;
  if (pos < 0 || pos >= a.T) __trap();
  float* red = reinterpret_cast<float*>(sm + lay.red);
  T* h = reinterpret_cast<T*>(sm + lay.h);
  T* xs = reinterpret_cast<T*>(sm + lay.xs);
  float* scores = reinterpret_cast<float*>(sm + lay.scores);
  int* idx = reinterpret_cast<int*>(sm + lay.idx);
  float* misc = reinterpret_cast<float*>(sm + lay.misc);
  float* pqkv = reinterpret_cast<float*>(a.ws + wl.pqkv);
  float* po = reinterpret_cast<float*>(a.ws + wl.po);
  float* pgu = reinterpret_cast<float*>(a.ws + wl.pgu);
  float* pdn = reinterpret_cast<float*>(a.ws + wl.pdn);
  T* inter = reinterpret_cast<T*>(a.ws + wl.inter);
  const T* na = static_cast<const T*>(a.na);
  const T* nm = static_cast<const T*>(a.nm);
  auto W = [&](int i) { return static_cast<const unsigned char*>(a.w[i]); };
  const int kvw = a.Hkv * HD;
  const Stage sqkv = {{W(0), W(1), W(2)}, {D, kvw, kvw}, 3, D,
                      (D + 2 * kvw) / TW};
  const Stage so = {{W(3), nullptr, nullptr}, {D, 0, 0}, 1, D, D / TW};
  const Stage sgu = {{W(4), W(5), nullptr}, {I, I, 0}, 2, D, I / TW};
  const Stage sdn = {{W(6), nullptr, nullptr}, {D, 0, 0}, 1, I, D / TW};
  auto cut = [&](const Stage& st, int count) {
    return Cut{st.tiles * count * STEPS, count * STEPS, P,
               segs(P, st.tiles)};
  };
  // h += the tiles' partials of a stage that ends in the residual, two
  // groups of four columns a thread at a time (their loads in flight at
  // once)
  auto add_stream = [&](const float* part, const Cut& k) {
    auto put = [&](int c4, const float4& f) {
      T* hc = h + c4 * 4;
      hc[0] = from_f<T>(f.x + to_f(hc[0]));
      hc[1] = from_f<T>(f.y + to_f(hc[1]));
      hc[2] = from_f<T>(f.z + to_f(hc[2]));
      hc[3] = from_f<T>(f.w + to_f(hc[3]));
    };
    for (int c4 = tid; c4 < D / 4; c4 += 2 * THREADS) {
      const int c5 = c4 + THREADS;
      const float4 f = reduce4(part, k, c4 * 4 / TW, TW, c4 * 4 % TW);
      const float4 g = c5 < D / 4 ? reduce4(part, k, c5 * 4 / TW, TW,
                                            c5 * 4 % TW)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      put(c4, f);
      if (c5 < D / 4) put(c5, g);
    }
    __syncthreads();
  };

  uint4 g[MAXCH];                          // the next fold's gains
  load_gains(na, D, g);
  load_cg(h, static_cast<const T*>(a.x), D);
  for (int l = 0; l < a.L; ++l) {
    const size_t layer = static_cast<size_t>(l);
    stamp(0);
    const float thr[4] = {__ldg(a.thr + l * 7), __ldg(a.thr + l * 7 + 3),
                          __ldg(a.thr + l * 7 + 4), __ldg(a.thr + l * 7 + 6)};
    // 1. q|k|v on the folded attention norm, then attention
    fold(h, g, D, a.eps, xs, misc);
    const int c0 = select_stage(a, xs, D, thr[0], a.cap[0], scores, idx, l, 0);
    const Cut kq = cut(sqkv, c0);
    stamp(ST_GATHER + 0);
    gather<T, 1>(sqkv, layer, xs, idx, kq, pqkv, sm, red);
    grid_barrier();
    if (att)
      attention<T, QG>(a, lay, wl, sm, l, pos, kq, b / a.SA, b % a.SA, bars);
    grid_barrier();
    // 2. o, its sums added to the stream
    load_cg(xs, reinterpret_cast<const T*>(a.ws + wl.attn), a.Hq * HD);
    const int c1 = select_stage(a, xs, D, thr[1], a.cap[1], scores, idx, l, 1);
    const Cut ko = cut(so, c1);
    stamp(ST_GATHER + 1);
    gather<T, 1>(so, layer, xs, idx, ko, po, sm, red);
    load_gains(nm + layer * D, D, g);
    grid_barrier();
    add_stream(po, ko);
    stamp(ST_UPD + 0);
    // 3. gate|up on the folded mlp norm; block b's columns of silu * up
    fold(h, g, D, a.eps, xs, misc);
    const int c2 = select_stage(a, xs, D, thr[2], a.cap[2], scores, idx, l, 2);
    const Cut kg = cut(sgu, c2);
    stamp(ST_GATHER + 2);
    gather<T, 2>(sgu, layer, xs, idx, kg, pgu, sm, red);
    grid_barrier();
    for (int c4 = split_lo(I / 4, P, b) + tid; c4 < split_lo(I / 4, P, b + 1);
         c4 += THREADS) {
      const int t = c4 * 4 / TW, c = c4 * 4 % TW;
      const float4 g = reduce4(pgu, kg, t, 2 * TW, c);
      const float4 u = reduce4(pgu, kg, t, 2 * TW, TW + c);
      const float gv[4] = {g.x, g.y, g.z, g.w}, uv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st_cg(inter + c4 * 4 + e,
              from_f<T>(gv[e] * (1.0f / (1.0f + expf(-gv[e]))) * uv[e]));
    }
    grid_barrier();
    // 4. down, its sums added to the stream
    load_cg(xs, inter, I);
    const int c3 = select_stage(a, xs, I, thr[3], a.cap[3], scores, idx, l, 3);
    const Cut kd = cut(sdn, c3);
    stamp(ST_GATHER + 3);
    gather<T, 1>(sdn, layer, xs, idx, kd, pdn, sm, red);
    if (l + 1 < a.L) load_gains(na + (layer + 1) * D, D, g);
    grid_barrier();
    add_stream(pdn, kd);
    stamp_at(l, ST_UPD + 1);
  }
  if (b == 0)
    for (int c = tid; c < D; c += THREADS) static_cast<T*>(a.out)[c] = h[c];
}

// Occupancy checks already made: (kernel, shared bytes) -> blocks an SM.
struct OccEntry { const void* fn; int smem, blocks; };
OccEntry occ_cache[32];
int occ_n = 0;

template <typename T, int QG>
int launch(const Args& a, int smem, cudaStream_t stream) {
  auto fn = token_kernel<T, QG>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  int blocks = -1;
  for (int i = 0; i < occ_n; ++i)
    if (occ_cache[i].fn == reinterpret_cast<const void*>(fn) &&
        occ_cache[i].smem == smem)
      blocks = occ_cache[i].blocks;
  if (blocks < 0) {
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS,
                                                      smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (occ_n < 32)
      occ_cache[occ_n++] = {reinterpret_cast<const void*>(fn), smem, blocks};
  }
  if (blocks < 1) return -1;               // a block cannot be resident
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.P, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fn, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan for dtype (0 fp32, 1 bf16) at these shapes on n_sms SMs, into
// out int32 [7]: grid, threads, shared bytes, workspace bytes, grid
// barriers a token (6 L), kv-head barriers a token (2 L), SA. Returns 0,
// or -1 where the shapes take no plan (out untouched).
extern "C" int teal_token_plan(int dtype, int D, int I, int Hq, int Hkv,
                               int T, int window, int capmax, int n_sms,
                               int L, int* out) {
  const TokPlan p = token_plan(dtype == 0 ? 4 : 2, D, I, Hq, Hkv, T, window,
                               capmax, n_sms);
  if (p.smem < 0 || L < 1) return -1;
  out[0] = p.grid;
  out[1] = THREADS;
  out[2] = p.smem;
  out[3] = static_cast<int>(p.ws);
  out[4] = NBAR_GRID * L;
  out[5] = NBAR_HEAD * L;
  out[6] = p.SA;
  return 0;
}

// One token through the L layers. The caller checks shapes, types and
// contiguity and allocates `ws` (the plan's workspace bytes); window 0
// means none; fixed keeps groups 0..cap-1; empty runs the barriers alone.
// Returns the launch's error, or -1 where a block cannot be resident.
extern "C" int teal_token_decode(
    int dtype, const void* x, const void* thr, const void* pos,
    const void* cs, const void* na, const void* nm, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* wg,
    const void* wu, const void* wd, void* kc, void* vc, void* out, void* sel,
    void* stamps, void* ws, int L, int D, int I, int Hq, int Hkv, int T, int window,
    int cap0, int cap1, int cap2, int cap3, int fixed, float eps, int n_sms,
    int empty, void* stream) {
  cudaGetLastError();  // clear any stale error of this library
  const int caps[4] = {cap0, cap1, cap2, cap3};
  int capmax = 0;
  for (int c : caps) capmax = imax(capmax, c);
  const TokPlan p = token_plan(dtype == 0 ? 4 : 2, D, I, Hq, Hkv, T, window,
                               capmax, n_sms);
  if (p.smem < 0 || L < 1 || cap0 < 1 || cap0 > D / HD || cap1 < 1 ||
      cap1 > D / HD || cap2 < 1 || cap2 > D / HD || cap3 < 1 ||
      cap3 > I / HD)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.thr = static_cast<const float*>(thr);
  a.pos = static_cast<const int*>(pos);
  a.cs = static_cast<const float*>(cs);
  a.na = na;
  a.nm = nm;
  const void* w[7] = {wq, wk, wv, wo, wg, wu, wd};
  for (int i = 0; i < 7; ++i) a.w[i] = w[i];
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
  a.P = p.grid;
  a.SA = p.SA;
  a.NS = p.NS;
  auto s = static_cast<cudaStream_t>(stream);
  // the barrier counters start at 0 (a memset node under stream capture)
  const cudaError_t e =
      cudaMemsetAsync(ws, 0, static_cast<size_t>(1 + Hkv) * CTR * 4, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  switch ((dtype == 0 ? 0 : 4) + __builtin_ctz(Hq / Hkv)) {
    case 0: return launch<float, 1>(a, p.smem, s);
    case 1: return launch<float, 2>(a, p.smem, s);
    case 2: return launch<float, 4>(a, p.smem, s);
    case 3: return launch<float, 8>(a, p.smem, s);
    case 4: return launch<__nv_bfloat16, 1>(a, p.smem, s);
    case 5: return launch<__nv_bfloat16, 2>(a, p.smem, s);
    case 6: return launch<__nv_bfloat16, 4>(a, p.smem, s);
    default: return launch<__nv_bfloat16, 8>(a, p.smem, s);
  }
}
