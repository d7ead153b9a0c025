// K2: single-token GQA decode attention over one layer of the stacked
// KV cache, with RoPE in its prologue and the in-place cache write.
//
// Replaces the Pallas kernel `_decode_attn_kernel`
// (teal_tpu/ops/decode_attention.py:81, launched at :444) and the
// attention step of `attn_block.attn_stage` (teal_tpu/ops/attn_block.py:
// 225-478), whose numerics it keeps:
//   - q, k_new arrive as the fp32 projection sums; RoPE (HF rotate-half)
//     is applied here in fp32 from the cos/sin rows at `pos`, and q is
//     scaled by 1/sqrt(128) after RoPE;
//   - slab scores use q rounded to the cache type against the PRE-update
//     cache rows t < pos (and t > pos - window), summed in fp32;
//   - the current token's score q . k_new and its value term ec * v_new
//     are fp32 (attn_block.py:309-345);
//   - the softmax is fp32 with ONE max taken over the whole live slab and
//     the current token before any exp; the weights are rounded to the
//     cache type before the PV product (attn_block.py:298-307), the
//     denominator sums the unrounded weights;
//   - k_new (post-RoPE) and v_new are written, cast to the cache type,
//     at row `pos` of layer `layer`; the output is in the cache type.
//
// What bounds it on the H100: bytes. It reads the live rows of one
// layer's K and V once (2 * pos * Hkv * 128 elements) and does 4 flops
// per element read, far below the ridge point, so HBM bandwidth is the
// roofline; at short context one launch's fixed cost dominates instead.
//
// Design: a thread-block cluster of S <= 8 blocks per (batch row, kv
// head), S chosen on the host from the shapes (never from pos, which
// lives on the device). Block j of the cluster takes the j-th equal share
// of the live rows lo .. pos-1, computed here from pos and the window.
//   1. Its K rows are one contiguous range of the [T, 128] slab: they
//      stream through a ring of <= 4 16 KB tiles filled by 1-D bulk copies
//      (cp.async.bulk, completion on an mbarrier per stage), the V rows
//      right behind them in the same ring, so V is in flight while the
//      scores and the cluster's max are formed. One or two neighbouring
//      lanes score a cache row against the query rows the thread holds,
//      the 128-wide dot product in registers (16-byte chunks, rotated by
//      row so a quarter-warp hits 8 distinct bank groups), halves added
//      by one shuffle.
//   2. The block's score slice stays in shared memory; its max per query
//      row is pushed into every peer's shared memory (distributed shared
//      memory) and, after a cluster barrier, each block has the S maxima
//      and the current token's score: the one max M.
//   3. e = exp(s - M), rounded to the cache type; the block sums the
//      unrounded e and forms its partial PV (thread d owns dimension d,
//      summing its rows in order); it pushes dimensions r*128/S .. of the
//      partial, and its sums, to rank r.
//   4. After a second cluster barrier rank r combines its dimensions from
//      its own shared memory in split order 0..S-1, adds ec * v_new and
//      divides. No block reads a peer after that barrier, so blocks may
//      exit; every peer has started before the first push (an arrival at
//      entry, waited on before it).
// Every sum runs in a fixed order and nothing is atomic, so two identical
// calls give identical bits. Rank 0 writes row pos, which no block of the
// launch reads. A block whose share is empty (pos < S, a short window)
// contributes 0 to the PV and the denominator and still reaches every
// barrier.
//
// seq_block (the verify path's `cache_rows = (0,)*B`, attn_block.py:
// 118-127): the B slots are consecutive positions pos[0] + i of ONE
// sequence in cache row 0, and slot i attends to slots < i as the
// reference's in-order slots read them back from the cache. One cluster
// per kv head serves a group of slots (all B unless its scores would not
// fit shared memory): its query rows are the (slot, head) pairs, and
// each cache row is read once for all of them. Rows pos[0] .. are not
// read from the cache, which this launch writes: every block rebuilds
// them from k_new / v_new -- RoPE'd with their own slot's rows and
// rounded to the cache type, bit for bit what the write stores -- and
// takes the cache only below pos[0]. Slot i masks the rows outside
// [lo_i, pos[0] + i). Slot i's own term stays fp32.
//
// q, k_new and v_new may be strided rows (views into K1's [B, n_tot]
// q|k|v output): row b starts q_rs (k/v: kv_rs) floats after row b-1.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace teal;

namespace {

constexpr int D = 128;                // head dim
constexpr int THREADS = 128;
constexpr int MAXG = 8;               // query heads per kv head
constexpr int MAXB = 16;              // slots of a seq_block launch
constexpr int MAXS = 8;               // blocks of a cluster (portable)
constexpr int MAXNST = 4;             // ring stages, at most
constexpr int TILE_BYTES = 16384;     // one ring stage
constexpr int SMEM_MAX = 232448;      // a block's shared memory on Hopper

struct Args {
  const float* q;    // [B, Hq, D]   raw (pre-RoPE) fp32, row stride q_rs
  const float* kn;   // [B, Hkv, D]  raw (pre-RoPE) fp32, row stride kv_rs
  const float* vn;   // [B, Hkv, D]  fp32, row stride kv_rs
  const float* cs;   // [B, 2, D]    cos row, sin row
  void* kc;          // [L, Bc, Hkv, T, D]: Bc = B, or 1 with seq_block
  void* vc;
  const int* pos;    // [B]
  void* out;         // [B, Hq, D]
  int B, Hq, Hkv, T, layer, window;
  float scale;
  int q_rs, kv_rs;
  int S;             // blocks a cluster (splits of the live rows)
  int gslots;        // seq_block: slots a cluster (1 otherwise)
  int NS;            // score columns a block: ceil(T / S), padded to 4
  int nst;           // ring stages: min(4, the tiles of K and V a block
                     // has at most)
};

template <typename T>
struct Tile {
  static constexpr int EPC = 16 / sizeof(T);   // elements a 16-byte chunk
  static constexpr int NCH = D / EPC;          // chunks a row
  static constexpr int ROWS = TILE_BYTES / (D * sizeof(T));
  static constexpr int NQG = THREADS / ROWS;   // query groups of a tile
};

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// Shared-memory layout, in bytes from the (128-byte aligned) base. The
// Python wrapper's `_smem_bytes` mirrors `total`, and the card tests hold
// it to `teal_decode_attention_smem`.
struct Layout {
  int bars, qr, pv, pvall, kb, vb, knf, small, s, total;
  __host__ __device__ Layout(int esz, int QR, int gslots, int nreb, int S,
                             int NS, int nst) {
    bars = nst * TILE_BYTES;
    qr = bars + 64;                         // [QR, D] q rounded, type T
    pv = qr + QR * D * esz;                 // [QR, D] fp32: q, then PV
    pvall = pv + QR * D * 4;                // [S, QR, D/S] peers' PV parts
    kb = pvall + QR * D * 4;                // seq: [nreb, D] rebuilt k, T
    vb = kb + nreb * D * esz;               // and v
    knf = vb + nreb * D * esz;              // [2, gslots, D] fp32 current
    small = knf + 2 * gslots * D * 4;       // k, v; sc, ec, M: [QR]; peers'
    s = small + (3 + 2 * S) * pad4(QR) * 4; // maxima, sums: [S, QR]
    total = s + QR * NS * 4;                // [QR, NS] scores, weights
  }
};

// x * cos + rotate_half(x) * sin, rounded as separate products and a sum
// (no fused multiply-add), so the written cache row matches the plain
// version bit for bit.
__device__ __forceinline__ float rope(const float* row, int d, float c,
                                      float s) {
  const float rot =
      d < D / 2 ? -__ldg(row + d + D / 2) : __ldg(row + d - D / 2);
  return rope_term(__ldg(row + d), rot, c, s);
}

// One 16-byte chunk of shared memory as fp32.
template <typename T, int N>
__device__ __forceinline__ void chunk(const T* p, float (&v)[N]) {
  unpack16(*reinterpret_cast<const uint4*>(p), v);
}

// Thread 0: copy `bytes` contiguous bytes from global `src` into the
// stage at `dst`, completing on mbarrier `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Scores of nr cache rows (type T, row-major in shared memory; absolute
// row index t0 + r) against the QR query rows: s[g * NS + t - a], -inf
// where slot g / GH may not see row t (seq_block) -- rows before its
// window or at or after its own position. Thread layout: NP neighbouring
// lanes share a row's dot product (lane h of them the chunks m*NP + h,
// summed in order, then added by a fixed butterfly), ROWS rows, NQ =
// NQG / NP query groups (warp-uniform); a thread holds Q query rows at a
// time (rows past QR repeat the last one and are not stored, so the hot
// loop has no branches). Chunks are rotated by NP * r so the 8 lanes of a
// quarter-warp read 8 distinct bank groups.
template <typename T, bool SEQ, int NP, int Q>
__device__ __forceinline__ void score_rows(
    const T* rows, int nr, int t0, const T* qr, int QR, int GH, float* s,
    int NS, int a, int c0, int p0, int window) {
  using TL = Tile<T>;
  constexpr int NQ = TL::NQG / NP, M = TL::NCH / NP;
  const int h = threadIdx.x % NP, r = (threadIdx.x / NP) % TL::ROWS;
  const int qg = threadIdx.x / (NP * TL::ROWS);
  const int t = t0 + r;
  const T* krow = rows + (r < nr ? r : 0) * D;
  for (int g0 = qg; g0 < QR; g0 += NQ * Q) {
    const T* qp[Q];
    float acc[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      qp[j] = qr + min(g0 + j * NQ, QR - 1) * D;
      acc[j] = 0.f;
    }
    // unrolled twice, not fully: the kernel's code must stay small, as it
    // runs between large kernels that evict it from the instruction caches
#pragma unroll 2
    for (int m = 0; m < M; ++m) {
      const int cc = (m * NP + h + NP * r) & (TL::NCH - 1);
      float k[TL::EPC];
      chunk(krow + cc * TL::EPC, k);
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        float qv[TL::EPC];
        chunk(qp[j] + cc * TL::EPC, qv);
#pragma unroll
        for (int e = 0; e < TL::EPC; ++e) acc[j] = fmaf(qv[e], k[e], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < Q; ++j) {
#pragma unroll
      for (int o = 1; o < NP; o <<= 1)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
      const int g = g0 + j * NQ;
      if (g < QR && r < nr && h == 0) {
        bool ok = true;
        if (SEQ) {
          const int p = p0 + c0 + g / GH;
          ok = t < p && (window <= 0 || t > p - window);
        }
        s[g * NS + t - a] = ok ? acc[j] : __int_as_float(0xff800000);
      }
    }
  }
}

// The thread layouts of a kernel built for at most QC query rows a
// cluster (a power of two; rows past 8 a thread are looped over): score
// with NP lanes a row where there are fewer query rows than query groups
// and QS query rows a thread, PV with QP. One layout a kernel keeps the
// code small: the kernel runs between large kernels that evict it from
// the instruction caches, and with every layout in one kernel the main
// path's call was slower inside the decode step than the one-block
// kernel's, though faster alone.
template <typename T, int QC>
struct Layouts {
  static constexpr int G = Tile<T>::NQG;   // 2 (bf16) or 4 (fp32)
  static constexpr int NP = QC == 1 ? G : (QC < G ? G / 2 : 1);
  static constexpr int QS =
      QC < G ? 1 : ((QC + G - 1) / G > 8 ? 8 : (QC + G - 1) / G);
  static constexpr int QP = QC > 8 ? 8 : QC;
};

// Partial PV over nr value rows: pv[g][d] += sum_r e[g][t0 + r - a] *
// v[r][d], thread d summing its rows in order (loads U rows ahead), Q
// query rows at a time (past QR: the last one again, not stored).
template <typename T, int Q>
__device__ __forceinline__ void pv_rows(const T* rows, int nr, int t0,
                                        const float* s, int NS, int a,
                                        float* pv, int QR) {
  constexpr int U = 8;
  const int d = threadIdx.x;
  for (int g0 = 0; g0 < QR; g0 += Q) {
    const float* ep[Q];
    float acc[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int g = min(g0 + j, QR - 1);
      ep[j] = s + g * NS + t0 - a;
      acc[j] = pv[g * D + d];
    }
    // 16-byte weight loads where the columns are aligned (cache tiles
    // start at multiples of ROWS, and NS is a multiple of 4)
    int r = 0;
    for (; ((t0 - a) & 3) == 0 && r + U <= nr; r += U) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = to_f(rows[(r + u) * D + d]);
#pragma unroll
      for (int j = 0; j < Q; ++j) {
#pragma unroll
        for (int u = 0; u < U; u += 4) {
          const float4 w = *reinterpret_cast<const float4*>(ep[j] + r + u);
          acc[j] = fmaf(w.x, v[u], acc[j]);
          acc[j] = fmaf(w.y, v[u + 1], acc[j]);
          acc[j] = fmaf(w.z, v[u + 2], acc[j]);
          acc[j] = fmaf(w.w, v[u + 3], acc[j]);
        }
      }
    }
    for (; r < nr; ++r) {
      const float v = to_f(rows[r * D + d]);
#pragma unroll
      for (int j = 0; j < Q; ++j) acc[j] = fmaf(ep[j][r], v, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < Q; ++j)
      if (g0 + j < QR) pv[(g0 + j) * D + d] = acc[j];
  }
}

template <typename T, bool SEQ, int QC>
__global__ void __launch_bounds__(THREADS) attn_kernel(Args a) {
  using TL = Tile<T>;
  using LY = Layouts<T, QC>;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = a.S, rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.x / S, d = threadIdx.x;
  const int lane = d & 31, warp = d >> 5;
  const int GH = a.Hq / a.Hkv;
  // slots of this cluster: row b alone, or seq_block slots c0 .. c1-1
  const int c0 = SEQ ? blockIdx.y * a.gslots : blockIdx.y;
  const int c1 = SEQ ? min(c0 + a.gslots, a.B) : c0 + 1;
  const int ns = c1 - c0, QR = ns * GH, NS = a.NS;
  const int nreb = SEQ ? a.B - 1 : 0;
  const int NST = a.nst;
  const Layout lay(sizeof(T), QR, SEQ ? a.gslots : 1, nreb, S, NS, NST);
  T* ring = reinterpret_cast<T*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  T* qr = reinterpret_cast<T*>(smem + lay.qr);
  float* pv = reinterpret_cast<float*>(smem + lay.pv);  // q first
  float* pvall = reinterpret_cast<float*>(smem + lay.pvall);
  T* kb = reinterpret_cast<T*>(smem + lay.kb);
  T* vb = reinterpret_cast<T*>(smem + lay.vb);
  float* knf = reinterpret_cast<float*>(smem + lay.knf);
  float* vnf = knf + (SEQ ? a.gslots : 1) * D;
  float* sc = reinterpret_cast<float*>(smem + lay.small);
  float* ec = sc + pad4(QR);
  float* M = ec + pad4(QR);
  float* mall = M + pad4(QR);           // [S, pad4(QR)]: rank j's maxima
  float* dall = mall + S * pad4(QR);    // and its sums of e
  float* s = reinterpret_cast<float*>(smem + lay.s);

  // the cluster's rows [lo, hi) and this block's share [ra, rb); rows
  // from p0 on are rebuilt (seq_block), the rest come from the cache
  const int p0 = SEQ ? a.pos[0] : 0;
  const int pb = a.pos[c0];
  if (d < ns) {
    const int p = a.pos[c0 + d];
    if (p < 0 || p >= a.T || (SEQ && p != p0 + c0 + d)) __trap();
  }
  const int hi = SEQ ? p0 + c1 - 1 : pb;
  const int lo = a.window > 0 ? max(pb - a.window + 1, 0) : 0;
  const int n = max(hi - lo, 0);
  const int ra = lo + n * rank / S, rb = lo + n * (rank + 1) / S;
  const int ce = SEQ ? min(rb, p0) : rb;     // cache rows [ra, ce)
  const int ncache = max(ce - ra, 0);
  const int nt = (ncache + TL::ROWS - 1) / TL::ROWS;   // tiles of K, of V
  const size_t slab =
      (static_cast<size_t>(a.layer) * (SEQ ? 1 : a.B) + (SEQ ? 0 : c0)) *
          a.Hkv + h;
  T* kcache = static_cast<T*>(a.kc) + slab * a.T * D;
  T* vcache = static_cast<T*>(a.vc) + slab * a.T * D;

  // tile i < nt: K rows ra + i*ROWS ..; i >= nt: the same rows of V
  auto issue = [&](int i) {
    const int first = ra + (i % nt) * TL::ROWS;
    const int rows = min(TL::ROWS, ce - first);
    const T* src = (i < nt ? kcache : vcache) + static_cast<size_t>(first) * D;
    bulk_load(ring + (i % NST) * (TILE_BYTES / sizeof(T)), src,
              rows * D * sizeof(T), smem_u32(&bars[i % NST]));
  };
  // every block of the cluster has started once this arrival is waited on
  cluster_arrive_relaxed();
  if (d == 0) {
    for (int i = 0; i < NST; ++i) mbar_init(smem_u32(&bars[i]), 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (d == 0)
    for (int i = 0; i < min(NST, 2 * nt); ++i) issue(i);

  // prologue: RoPE (fp32), q scale, current keys, rebuilt rows (inputs
  // read through the read-only path)
  for (int i = 0; i < QR; ++i) {
    const int b = c0 + i / GH;
    const float* row = a.q + static_cast<size_t>(b) * a.q_rs +
                       (h * GH + i % GH) * D;
    const float v = __fmul_rn(rope(row, d, __ldg(a.cs + (b * 2) * D + d),
                                   __ldg(a.cs + (b * 2 + 1) * D + d)),
                              a.scale);
    pv[i * D + d] = v;
    qr[i * D + d] = from_f<T>(v);
  }
  for (int i = 0; i < ns; ++i) {
    const int b = c0 + i;
    const size_t kv = static_cast<size_t>(b) * a.kv_rs + h * D;
    knf[i * D + d] = rope(a.kn + kv, d, __ldg(a.cs + (b * 2) * D + d),
                          __ldg(a.cs + (b * 2 + 1) * D + d));
    vnf[i * D + d] = __ldg(a.vn + kv + d);
  }
  if (SEQ) {
    for (int j = 0; j < nreb; ++j) {
      const size_t kvj = static_cast<size_t>(j) * a.kv_rs + h * D;
      kb[j * D + d] =
          from_f<T>(rope(a.kn + kvj, d, __ldg(a.cs + (j * 2) * D + d),
                         __ldg(a.cs + (j * 2 + 1) * D + d)));
      vb[j * D + d] = from_f<T>(__ldg(a.vn + kvj + d));
    }
  }
  if (rank == 0) {   // rows pos[b]: read by no block of this launch
    for (int i = 0; i < ns; ++i) {
      const size_t row = static_cast<size_t>(pb + i) * D + d;
      kcache[row] = from_f<T>(knf[i * D + d]);
      vcache[row] = from_f<T>(vnf[i * D + d]);
    }
  }
  __syncthreads();
  // current token's score, fp32: a warp per query row
  for (int g = warp; g < QR; g += THREADS / 32) {
    const float* qg = pv + g * D + lane * 4;
    const float* kg = knf + (g / GH) * D + lane * 4;
    float part = qg[0] * kg[0];
    part = fmaf(qg[1], kg[1], part);
    part = fmaf(qg[2], kg[2], part);
    part = fmaf(qg[3], kg[3], part);
    part = warp_sum(part);
    if (lane == 0) sc[g] = part;
  }

  // phase 1: scores of the block's K rows
  for (int i = 0; i < nt; ++i) {
    mbar_wait(smem_u32(&bars[i % NST]), (i / NST) & 1);
    const int first = ra + i * TL::ROWS;
    score_rows<T, SEQ, LY::NP, LY::QS>(
        ring + (i % NST) * (TILE_BYTES / sizeof(T)), min(TL::ROWS, ce - first),
        first, qr, QR, GH, s, NS, ra, c0, p0, a.window);
    __syncthreads();
    if (d == 0 && i + NST < 2 * nt) issue(i + NST);
  }
  if (SEQ) {   // rebuilt rows [max(ra, p0), rb)
    for (int t0 = max(ra, p0); t0 < rb; t0 += TL::ROWS)
      score_rows<T, SEQ, LY::NP, LY::QS>(kb + (t0 - p0) * D,
                                         min(TL::ROWS, rb - t0), t0, qr, QR,
                                         GH, s, NS, ra, c0, p0, a.window);
  }
  __syncthreads();
  // the slice's max per query row (a warp per row, lanes strided),
  // pushed into every peer's `mall` row `rank`
  cluster_wait();
  const int nr = rb - ra;
  for (int g = warp; g < QR; g += THREADS / 32) {
    float m = __int_as_float(0xff800000);  // -inf
    for (int t = lane; t < nr; t += 32) m = fmaxf(m, s[g * NS + t]);
    m = warp_max(m);
    if (lane < S) cluster.map_shared_rank(mall, lane)[rank * pad4(QR) + g] = m;
  }
  cluster.sync();                          // every slice max is in

  for (int g = d; g < QR; g += THREADS) {
    float m = sc[g];
    for (int j = 0; j < S; ++j) m = fmaxf(m, mall[j * pad4(QR) + g]);
    M[g] = m;
    ec[g] = expf(sc[g] - m);
  }
  __syncthreads();
  for (int i = d; i < QR * D; i += THREADS) pv[i] = 0.f;
  // weights: e rounded to T for PV; the denominator sums e unrounded
  for (int g = warp; g < QR; g += THREADS / 32) {
    const float m = M[g];
    float sum = 0.f;
    for (int t = lane; t < nr; t += 32) {
      const float e = expf(s[g * NS + t] - m);
      s[g * NS + t] = rnd<T>(e);
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane < S) cluster.map_shared_rank(dall, lane)[rank * pad4(QR) + g] =
        sum;
  }
  __syncthreads();

  // phase 2: partial PV over the block's V rows
  for (int i = nt; i < 2 * nt; ++i) {
    mbar_wait(smem_u32(&bars[i % NST]), (i / NST) & 1);
    const int first = ra + (i - nt) * TL::ROWS;
    pv_rows<T, LY::QP>(ring + (i % NST) * (TILE_BYTES / sizeof(T)),
                       min(TL::ROWS, ce - first), first, s, NS, ra, pv, QR);
    __syncthreads();
    if (d == 0 && i + NST < 2 * nt) issue(i + NST);
  }
  if (SEQ) {
    for (int t0 = max(ra, p0); t0 < rb; t0 += TL::ROWS)
      pv_rows<T, LY::QP>(vb + (t0 - p0) * D, min(TL::ROWS, rb - t0), t0, s,
                         NS, ra, pv, QR);
  }
  __syncthreads();
  // push dimensions [r * D / S, (r + 1) * D / S) of the partial PV to
  // rank r, which combines them
  const int dw = D / S;
  for (int i = d; i < QR * D; i += THREADS) {
    const int g = i / D, r = (i % D) / dw;
    cluster.map_shared_rank(pvall, r)[(rank * QR + g) * dw + i % dw] = pv[i];
  }
  cluster.sync();                          // every partial is in

  // combine this rank's dimensions in split order; nothing is read from
  // a peer from here on, so a block may exit
  T* out = static_cast<T*>(a.out);
  for (int i = d; i < QR * dw; i += THREADS) {
    const int g = i / dw, dd = rank * dw + i % dw;
    float acc = 0.f, den = 0.f;
    for (int j = 0; j < S; ++j) {
      acc += pvall[(j * QR + g) * dw + i % dw];
      den += dall[j * pad4(QR) + g];
    }
    const int b = c0 + g / GH;
    const float vnew = vnf[(g / GH) * D + dd];
    out[(static_cast<size_t>(b) * a.Hq + h * GH + g % GH) * D + dd] =
        from_f<T>((acc + ec[g] * vnew) * (1.0f / (den + ec[g])));
  }
}

// Occupancy checks already made: (kernel, S, shared bytes) -> clusters.
struct OccEntry { const void* fn; int S, smem, clusters; };
OccEntry occ_cache[64];
int occ_n = 0;

template <typename T, bool SEQ, int QC>
int launch(const Args& a, int ny, cudaStream_t stream) {
  const int GH = a.Hq / a.Hkv;
  const int gs = SEQ ? a.gslots : 1;
  const Layout lay(sizeof(T), gs * GH, gs, SEQ ? a.B - 1 : 0, a.S, a.NS,
                   a.nst);
  if (lay.total > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto fn = attn_kernel<T, SEQ, QC>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hkv * a.S, ny, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = -1;
  for (int i = 0; i < occ_n; ++i)
    if (occ_cache[i].fn == reinterpret_cast<const void*>(fn) &&
        occ_cache[i].S == a.S && occ_cache[i].smem == lay.total)
      clusters = occ_cache[i].clusters;
  if (clusters < 0) {
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (occ_n < 64)
      occ_cache[occ_n++] = {reinterpret_cast<const void*>(fn), a.S,
                            lay.total, clusters};
  }
  if (clusters < 1) return -1;             // the cluster cannot be placed
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fn, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The kernel built for the launch's query rows a cluster (GH, times the
// slots of a seq_block group): 1, 2, 4, 8, or (seq_block) 16 and more.
template <typename T, bool SEQ>
int by_rows(const Args& a, int ny, cudaStream_t stream) {
  const int qr = (SEQ ? a.gslots : 1) * (a.Hq / a.Hkv);
  if (qr == 1) return launch<T, SEQ, 1>(a, ny, stream);
  if (qr == 2) return launch<T, SEQ, 2>(a, ny, stream);
  if (qr <= 4) return launch<T, SEQ, 4>(a, ny, stream);
  if (qr <= 8) return launch<T, SEQ, 8>(a, ny, stream);
  if constexpr (SEQ) return launch<T, SEQ, 16>(a, ny, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A block's score columns (ceil(T / S), padded to 4) and ring stages
// (min(4, the tiles of K and V a block has at most)).
void split_shape(int dtype, int T, int S, int* NS, int* nst) {
  const int rows = (T + S - 1) / S;
  const int tile_rows = TILE_BYTES / (D * (dtype == 0 ? 4 : 2));
  *NS = pad4(rows);
  *nst = min(MAXNST, 2 * ((rows + tile_rows - 1) / tile_rows));
}

}  // namespace

// A block's dynamic shared memory in bytes (`Layout::total`) for GH query
// heads a kv head, `slots` slots a cluster (1 but in seq_block), nreb
// rebuilt rows (B - 1 in seq_block, else 0), T cache rows and S splits.
extern "C" int teal_decode_attention_smem(int dtype, int GH, int slots,
                                          int nreb, int T, int S) {
  int NS, nst;
  split_shape(dtype, T, S, &NS, &nst);
  return Layout(dtype == 0 ? 4 : 2, slots * GH, slots, nreb, S, NS, nst)
      .total;
}

// dtype: 0 fp32, 1 bf16 (the cache type). window 0 means none. q_rs /
// kv_rs: row strides of q and of k_new / v_new in floats. seq_block: the
// B <= 16 slots are consecutive positions of cache row 0 (a slot whose
// pos is not pos[0] + i traps), served by clusters of group_slots slots.
// splits: blocks a cluster, a power of two <= 8. The caller checks shapes
// (head dim 128, Hq % Hkv == 0, Hq / Hkv <= 8) and that the block's
// shared memory fits; a launch returns -1 when no cluster of this size
// can be resident on the card.
extern "C" int teal_decode_attention(
    int dtype, const void* q, const void* k_new, const void* v_new,
    const void* cs, void* kc, void* vc, const void* pos, void* out, int B,
    int Hq, int Hkv, int T, int layer, int window, float scale, int q_rs,
    int kv_rs, int seq_block, int splits, int group_slots, void* stream) {
  cudaGetLastError();  // clear any stale error of this library
  if (splits < 1 || splits > MAXS || (splits & (splits - 1)) ||
      Hq % Hkv || Hq / Hkv > MAXG || (seq_block && B > MAXB) ||
      group_slots < 1 || (seq_block && group_slots > B))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const float*>(q);
  a.kn = static_cast<const float*>(k_new);
  a.vn = static_cast<const float*>(v_new);
  a.cs = static_cast<const float*>(cs);
  a.kc = kc;
  a.vc = vc;
  a.pos = static_cast<const int*>(pos);
  a.out = out;
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.T = T;
  a.layer = layer;
  a.window = window;
  a.scale = scale;
  a.q_rs = q_rs;
  a.kv_rs = kv_rs;
  a.S = splits;
  a.gslots = seq_block ? group_slots : 1;
  split_shape(dtype, T, splits, &a.NS, &a.nst);
  const int ny = seq_block ? (B + a.gslots - 1) / a.gslots : B;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return seq_block ? by_rows<float, true>(a, ny, s)
                     : by_rows<float, false>(a, ny, s);
  return seq_block ? by_rows<__nv_bfloat16, true>(a, ny, s)
                   : by_rows<__nv_bfloat16, false>(a, ny, s);
}
