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
// gate|up; half that in int8, a quarter plus the sz rows in int4); the
// input rows ride along. So every SM has to keep a few tens of KB of
// weight slabs in flight, and the int8 / int4 conversions must stay off
// the critical path.
//
// Design: two forms, picked by xpack's row count R (the plan `full_plan`,
// mirrored by the wrapper's `block_gemv._bgg_plan` and exported as
// `teal_block_gather_plan`). In both, a block owns a tile of output
// columns of one weight (a narrower last tile is masked) and one of S
// contiguous shares of the kept list, in order; the S blocks of a tile are
// a thread-block cluster (S <= 8, the largest power of two keeping the
// grid within one block an SM), so the 4096-wide o and down stages fill
// the card too; each block's sums are added to its peers' in split order
// over distributed shared memory. No atomics; two calls give the same
// bits.
//   - R = 1, the one-row stream (`bgg_stream_kernel`): a tile is 256
//     bytes of each slab row (bf16 128 columns, int8 / int4 256); a thread
//     streams 16 bytes of every 16th row of the block's share through its
//     own slots of an 8-stage cp.async ring and does its FMAs on what it
//     copied itself, so the loop has no block barrier and no dependent
//     load (kept groups, input values and int4 scale / zero rows are
//     staged in shared memory first). int8 and nibbles become fp32 with
//     one byte permute each; int4 keeps each group's sums in fp32 and
//     applies the group's scale and zero to them.
//   - R = 8, the rows form on the tensor cores (`bgg_kernel`, batched
//     decode): 64-column tiles; the kept groups stream through a ring of
//     up to 8 shared-memory stages of 128 slab rows (128 / G kept groups'
//     [G, 64] slabs, packed int4 G / 2 rows a group and its scale and
//     zero rows, with their input rows) filled by cp.async; bf16 stream,
//     every plan: mma.sync m16n8k16 with the input rows as M (rows >=
//     `rows` zero), each warp taking 16 of the stage's 128 rows as K (row
//     8w' + i and G / 2 + 8w' + i of its group) and all 8 n-tiles. int8
//     values and nibbles become bf16 exactly in registers (the 0x4300
//     trick, `common.cuh`); int4 adds (x @ nib) * scale + sum(x) * zero a
//     warp's slice, sum(x) from one more MMA against ones, both in fp32.
//     fp32 stream: the same slices on FMAs (TF32 would not hold 1e-5).
//     Per-warp sums are added in warp order through shared memory.
// Kept-group indices are clamped to [0, K / G): a bad index reads a
// wrong slab, never outside W.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace teal;

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int TC = 64;           // output columns a block
constexpr int KR = 128;          // slab rows a ring stage (16 a warp)
constexpr int LANES = 128;       // xpack's row width
constexpr int MAXB = 16;         // input rows: the MMA's M
constexpr int MAXS = 8;          // blocks a cluster
constexpr int MAXNST = 8;        // ring stages, at most
constexpr int SMEM_MAX = 232448; // a block's shared memory on Hopper
constexpr int SM_SMEM = 233472;  // an SM's, of which 1 KB a resident block's

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// Shared-memory layout, bytes from the (128-byte aligned) base. A ring
// stage holds 128 slab rows (rows padded by 16 bytes, so the lanes of a
// fragment load hit distinct banks; packed int4: 64 rows, then each
// group's scale and zero rows) and the stage's 16 input rows (row stride
// padded likewise; rows >= `rows` stay zero). After the loop the ring
// holds the per-warp sums; then the split parts a block combines and the
// block's kept groups. The wrapper's `_bgg_smem` mirrors `total`.
struct Layout {
  int wstride, wslab, xstride, stage, pall, idx, total;
  __host__ __device__ Layout(int esz, int plan, int G, int nst, int S,
                             int jmax) {
    const int wrows = plan == PLAN_INT4 ? KR / 2 : KR;
    wstride = TC * (plan == PLAN_STREAM ? esz : 1) + 16;
    wslab = wrows * wstride + (plan == PLAN_INT4 ? KR / G * 2 * TC * 4 : 0);
    xstride = LANES * esz + 16;
    stage = wslab + MAXB * xstride;
    const int ring = nst * stage;
    const int red = NWARPS * MAXB * TC * 4;         // [warp][4][8][32]
    pall = ring > red ? ring : red;                 // [S][MAXB][TC / S]
    idx = pall + (S > 1 ? MAXB * TC * 4 : 0);       // [jmax]
    total = idx + pad4(jmax) * 4;
  }
};

// The rows form's plan from shapes only: S splits of a tile's kept groups
// (the largest power of two <= MAXS keeping the grid within one block an
// SM), the deepest ring (<= MAXNST stages) that leaves room for two
// blocks an SM, else that fits one block, and the shared bytes (-1 where
// nothing fits). `tiles` is the sum of ceil(N_i / TC).
struct BggPlan { int S, nst, smem; };

BggPlan bgg_plan(int esz, int plan, int G, int tiles, int k_keep,
                 int n_sms) {
  BggPlan p = {0, 0, -1};
  if (tiles <= 0 || k_keep < 1) return p;
  int S = 1;
  while (S < MAXS && tiles * 2 * S <= n_sms) S *= 2;
  const int jmax = (k_keep + S - 1) / S;
  for (int pass = 0; pass < 2; ++pass)
    for (int nst = MAXNST; nst >= 2; --nst) {
      const int smem = Layout(esz, plan, G, nst, S, jmax).total;
      if (pass == 0 ? 2 * (smem + 1024) <= SM_SMEM : smem <= SMEM_MAX) {
        p = {S, nst, smem};
        return p;
      }
    }
  return p;
}

struct Args {
  const int* idx;            // [k_keep] kept groups
  const void* xpack;         // [k_keep, R, 128] input rows, lanes [:G]
  const void* w[3];          // [L, K, n_i] each (int4: [L, K/2, n_i])
  const float* sz[3];        // int4: [L, K/G, 2, n_i] (scale, zero)
  int n[3];
  float* out;                // fp32 [rows, n_tot]
  int n_tot, K, layer, k_keep, R, rows;
  int S, nst;                // the plan's splits and ring stages
};

// bf16: two blocks an SM (128 registers a thread), as the plan assumes
template <typename T, int P, int G>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 2 : 1)
    bgg_kernel(Args a) {
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int WESZ = P == PLAN_STREAM ? ESZ : 1;  // bytes a stored weight
  constexpr int WROWS = P == PLAN_INT4 ? KR / 2 : KR;   // slab rows a stage
  constexpr int GROWS = P == PLAN_INT4 ? G / 2 : G;     // slab rows a group
  constexpr int GPS = KR / G;                           // groups a stage
  constexpr int WPG = G / 16;                           // warps a group
  constexpr int WCH = TC * WESZ / 16;                   // chunks a slab row
  constexpr int XCH = G * ESZ / 16;                     // chunks a group row
  constexpr bool MMA = ESZ == 2;                        // bf16: tensor cores
  extern __shared__ __align__(128) unsigned char sm[];
  const int S = a.S, NST = a.nst;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // every peer has started before the first push into its shared memory
  cluster_arrive_relaxed();

  // the tile: weight wi, columns [off, off + valid) of it, output column c0
  const int split = static_cast<int>(blockIdx.x) % S;
  int wi = 0, t = static_cast<int>(blockIdx.x) / S, c0 = 0;
  while (t >= (a.n[wi] + TC - 1) / TC) {
    t -= (a.n[wi] + TC - 1) / TC;
    c0 += a.n[wi++];
  }
  const int N = a.n[wi], off = t * TC, valid = min(TC, N - off);
  c0 += off;
  const int nb = a.K / G;
  const int j0 = split_lo(a.k_keep, S, split);
  const int mine = split_lo(a.k_keep, S, split + 1) - j0;
  const Layout lay(ESZ, P, G, NST, S, (a.k_keep + S - 1) / S);
  int* sidx = reinterpret_cast<int*>(sm + lay.idx);
  for (int j = tid; j < mine; j += THREADS)
    sidx[j] = min(max(__ldg(a.idx + j0 + j), 0), nb - 1);
  for (int s = 0; s < NST; ++s) {
    uint4* z = reinterpret_cast<uint4*>(sm + s * lay.stage + lay.wslab +
                                        a.rows * lay.xstride);
    for (int i = tid; i < (MAXB - a.rows) * lay.xstride / 16; i += THREADS)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  const int nstages = (mine + GPS - 1) / GPS;
  const size_t krows = P == PLAN_INT4 ? a.K / 2 : a.K;
  const unsigned char* wsrc =
      static_cast<const unsigned char*>(a.w[wi]) +
      (static_cast<size_t>(a.layer) * krows * N + off) * WESZ;
  const float* szsrc =
      P == PLAN_INT4
          ? a.sz[wi] + static_cast<size_t>(a.layer) * nb * 2 * N + off
          : nullptr;
  const unsigned char* xsrc = static_cast<const unsigned char*>(a.xpack);
  const int vch = valid * WESZ / 16;        // chunks of a row in the tile
  // stage s: kept groups j = s * GPS + u (u < GPS, j < mine) -- their
  // slab rows, (int4) scale and zero rows, and input rows
  auto fetch = [&](int s) {
    if (s < nstages) {
      unsigned char* st = sm + (s % NST) * lay.stage;
      for (int c = tid; c < WROWS * WCH; c += THREADS) {
        const int r = c / WCH, ch = c % WCH, j = s * GPS + r / GROWS;
        if (j < mine && ch < vch)
          cp_async16(st + r * lay.wstride + ch * 16,
                     wsrc + (static_cast<size_t>(sidx[j]) * GROWS +
                             r % GROWS) * N * WESZ + ch * 16);
      }
      if constexpr (P == PLAN_INT4) {
        constexpr int SCH = TC / 4;                 // chunks of a sz row
        for (int c = tid; c < GPS * 2 * SCH; c += THREADS) {
          const int u = c / (2 * SCH), h = c / SCH % 2, ch = c % SCH;
          const int j = s * GPS + u;
          if (j < mine && ch * 4 < valid)
            cp_async16(st + WROWS * lay.wstride + ((u * 2 + h) * TC + ch * 4) * 4,
                       szsrc + (static_cast<size_t>(sidx[j]) * 2 + h) * N +
                           ch * 4);
        }
      }
      unsigned char* xs = st + lay.wslab;
      for (int c = tid; c < a.rows * GPS * XCH; c += THREADS) {
        const int b = c / (GPS * XCH), u = c / XCH % GPS, ch = c % XCH;
        const int j = s * GPS + u;
        if (j < mine)
          cp_async16(xs + b * lay.xstride + u * G * ESZ + ch * 16,
                     xsrc + ((static_cast<size_t>(j0 + j) * a.R + b) *
                                 LANES) * ESZ + ch * 16);
      }
    }
    cp_async_commit();
  };

  // the warp's 16 rows of a stage: group slot uw, slab rows (and input
  // positions) xr0 + i and xr0 + G / 2 + i, i < 8 (packed int4: rows
  // 8 * warp + i of the stage's packed slab)
  const int uw = warp / WPG;
  const int xr0 = uw * G + 8 * (warp % WPG);
  // acc[t][i]: bf16, MMA n-tile t's accumulator i (row lane/4 + 8 * (i /
  // 2), tile column (2 * (lane % 4) + i % 2) * 8 + t); fp32 FMAs: row
  // (lane / 8) * 4 + i, tile column (lane % 8) * 8 + t
  float acc[8][4];
#pragma unroll
  for (int t8 = 0; t8 < 8; ++t8)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t8][i] = 0.f;

  auto compute = [&](int s) {
    if (s * GPS + uw >= mine) return;      // the warp's group slot is empty
    const unsigned char* st = sm + (s % NST) * lay.stage;
    const unsigned char* xs = st + lay.wslab;
    const float* szs = reinterpret_cast<const float*>(st + WROWS *
                                                           lay.wstride) +
                       uw * 2 * TC;         // int4: [scale; zero] [2][TC]
    if constexpr (MMA) {
      uint32_t af[4];
      {
        const int mi = lane >> 3;
        ldsm_x4(af, xs + ((lane & 7) + (mi & 1) * 8) * lay.xstride +
                        (xr0 + (mi >> 1) * (G / 2)) * 2);
      }
      uint32_t bf[8][2];
      gather_b_frags<P, G / 2>(st, lay.wstride,
                               P == PLAN_INT4 ? 8 * warp : xr0, bf);
      if constexpr (P == PLAN_INT4) {
        float sx[4] = {0.f, 0.f, 0.f, 0.f};  // the slice's sum of x a row
        mma16816(sx, af, 0x3F803F80u, 0x3F803F80u);
        // (x @ nib) * scale + sum(x) * zero; columns (2q + e) * 8 + t,
        // four tiles (16 bytes) a load
        const float* sz = szs + 2 * (lane & 3) * 8;
#pragma unroll
        for (int h = 0; h < 8; h += 4) {
          const float4 s0 = *reinterpret_cast<const float4*>(sz + h);
          const float4 s1 = *reinterpret_cast<const float4*>(sz + 8 + h);
          const float4 z0 = *reinterpret_cast<const float4*>(sz + TC + h);
          const float4 z1 =
              *reinterpret_cast<const float4*>(sz + TC + 8 + h);
          const float sc0[4] = {s0.x, s0.y, s0.z, s0.w};
          const float sc1[4] = {s1.x, s1.y, s1.z, s1.w};
          const float zr0[4] = {z0.x, z0.y, z0.z, z0.w};
          const float zr1[4] = {z1.x, z1.y, z1.z, z1.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float p[4] = {0.f, 0.f, 0.f, 0.f};
            mma16816(p, af, bf[h + u][0], bf[h + u][1]);
            float* c = acc[h + u];
            c[0] = fmaf(p[0], sc0[u], fmaf(sx[0], zr0[u], c[0]));
            c[1] = fmaf(p[1], sc1[u], fmaf(sx[1], zr1[u], c[1]));
            c[2] = fmaf(p[2], sc0[u], fmaf(sx[2], zr0[u], c[2]));
            c[3] = fmaf(p[3], sc1[u], fmaf(sx[3], zr1[u], c[3]));
          }
        }
      } else {
        // a fresh accumulator a stage, added to the sums with a rounded
        // FADD: accumulating in the MMA truncates against the running sum
#pragma unroll
        for (int t8 = 0; t8 < 8; ++t8) {
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          mma16816(p, af, bf[t8][0], bf[t8][1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[t8][i] += p[i];
        }
      }
    } else {
      // fp32 stream: FMAs; lane: rows b4..b4+3, tile columns c8..c8+7
      const int b4 = (lane >> 3) * 4, c8 = (lane & 7) * 8;
      const float* xf = reinterpret_cast<const float*>(xs);
      const int xr = lay.xstride / 4;
      if constexpr (P == PLAN_INT4) {
        float p[8][4], sx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int t8 = 0; t8 < 8; ++t8)
#pragma unroll
          for (int i = 0; i < 4; ++i) p[t8][i] = 0.f;
#pragma unroll 2
        for (int r = 0; r < 8; ++r) {
          float xlo[4], xhi[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            xlo[i] = xf[(b4 + i) * xr + xr0 + r];
            xhi[i] = xf[(b4 + i) * xr + xr0 + G / 2 + r];
            sx[i] += xlo[i] + xhi[i];
          }
          const uint2 q2 = *reinterpret_cast<const uint2*>(
              st + (8 * warp + r) * lay.wstride + c8);
#pragma unroll
          for (int t8 = 0; t8 < 8; ++t8) {
            const uint32_t bt = ((t8 < 4 ? q2.x : q2.y) >> ((t8 & 3) * 8));
            const float nlo = static_cast<float>(bt & 15u);
            const float nhi = static_cast<float>((bt >> 4) & 15u);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              p[t8][i] = fmaf(xhi[i], nhi, fmaf(xlo[i], nlo, p[t8][i]));
          }
        }
#pragma unroll
        for (int t8 = 0; t8 < 8; ++t8)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[t8][i] = fmaf(p[t8][i], szs[c8 + t8],
                              fmaf(sx[i], szs[TC + c8 + t8], acc[t8][i]));
      } else {
#pragma unroll 2
        for (int r = 0; r < 16; ++r) {
          const int k = r < 8 ? xr0 + r : xr0 + G / 2 + r - 8;
          float xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = xf[(b4 + i) * xr + k];
          const unsigned char* row = st + k * lay.wstride + c8 * WESZ;
          float wv[8];
          if constexpr (P == PLAN_INT8) {
            const uint2 q2 = *reinterpret_cast<const uint2*>(row);
#pragma unroll
            for (int t8 = 0; t8 < 8; ++t8)
              wv[t8] = static_cast<float>(static_cast<int8_t>(
                  (t8 < 4 ? q2.x : q2.y) >> ((t8 & 3) * 8)));
          } else {
            const float4 lo = *reinterpret_cast<const float4*>(row);
            const float4 hi = *reinterpret_cast<const float4*>(row + 16);
            wv[0] = lo.x; wv[1] = lo.y; wv[2] = lo.z; wv[3] = lo.w;
            wv[4] = hi.x; wv[5] = hi.y; wv[6] = hi.z; wv[7] = hi.w;
          }
#pragma unroll
          for (int t8 = 0; t8 < 8; ++t8)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[t8][i] = fmaf(xv[i], wv[t8], acc[t8][i]);
        }
      }
    }
  };

  for (int s = 0; s < NST - 1; ++s) fetch(s);
  for (int s = 0; s < nstages; ++s) {
    cp_async_wait_dyn(NST - 2);
    __syncthreads();       // stage s landed; stage s - 1 is free again
    fetch(s + NST - 1);
    compute(s);
  }
  cp_async_wait<0>();
  __syncthreads();

  // fixed-order sums: over warps, then (S > 1) over the tile's splits,
  // each block combining TC / S columns from its peers' pushes in split
  // order. The per-warp sums go through shared memory in accumulator
  // order (slot (i, t, lane)), so both the stores and the warp-order sums
  // are free of bank conflicts; `slot` maps a slot to its row and column.
  float* red = reinterpret_cast<float*>(sm);      // [warp][4][8][32]
  constexpr int SLOTS = 4 * 8 * 32;
#pragma unroll
  for (int t8 = 0; t8 < 8; ++t8)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[warp * SLOTS + (i * 8 + t8) * 32 + lane] = acc[t8][i];
  __syncthreads();
  cluster_wait();
  cg::cluster_group cluster = cg::this_cluster();
  float* pall = reinterpret_cast<float*>(sm + lay.pall);
  const int cw = TC / S;
  for (int sl = tid; sl < SLOTS; sl += THREADS) {
    const int i = sl >> 8, t8 = (sl >> 5) & 7, ln = sl & 31;
    const int b = MMA ? (ln >> 2) + (i >> 1) * 8 : (ln >> 3) * 4 + i;
    const int col = MMA ? (2 * (ln & 3) + (i & 1)) * 8 + t8 : (ln & 7) * 8 + t8;
    if (b >= a.rows) continue;
    float f = 0.f;
    for (int wp = 0; wp < NWARPS; ++wp) f += red[wp * SLOTS + sl];
    if (S == 1) {
      if (col < valid) a.out[static_cast<size_t>(b) * a.n_tot + c0 + col] = f;
    } else {
      cluster.map_shared_rank(pall, col / cw)[(split * MAXB + b) * cw +
                                              col % cw] = f;
    }
  }
  if (S > 1) {
    cluster.sync();        // every split's part is in; no peer access after
    for (int o = tid; o < a.rows * cw; o += THREADS) {
      const int b = o / cw, cl = o % cw, col = split * cw + cl;
      float f = 0.f;
      for (int sp = 0; sp < S; ++sp) f += pall[(sp * MAXB + b) * cw + cl];
      if (col < valid) a.out[static_cast<size_t>(b) * a.n_tot + c0 + col] = f;
    }
  }
}

// --- the one-row form (R = 1): a stream of slab rows ----------------------

constexpr int SPIECE = 256;      // bytes of a slab row a block reads
constexpr int SCPR = SPIECE / 16;  // 16-byte chunks of a row piece
constexpr int SRL = THREADS / SCPR;  // row lanes
constexpr int SNST = 8;          // ring stages
constexpr int SMAXS = 8;         // blocks a cluster

// Input values staged a chunk at a time: 2048 (1024 for packed int4, whose
// chunk also stages each group's scale and zero rows of the tile).
__host__ __device__ constexpr int stream_xs(int plan) {
  return plan == PLAN_INT4 ? 1024 : 2048;
}

// Shared memory of the one-row form, bytes: the ring [SNST][THREADS] x 16
// (after the loop the row lanes' sums [SRL][TW] fp32), a chunk's input
// values [CG][G] of the stream type, (int4) its groups' scale and zero
// rows [CG][2][TW] fp32, its kept groups [CG], the block's sums [TW]
// fp32 (read by the cluster's peers). The wrapper's `_bgg_stream_smem`
// mirrors `total`.
struct StreamLayout {
  int tw, cg, xs, sz, idx, part, total;
  __host__ __device__ StreamLayout(int esz, int plan, int G) {
    tw = SPIECE / (plan == PLAN_STREAM ? esz : 1);
    cg = stream_xs(plan) / G;
    xs = SNST * THREADS * 16;
    sz = xs + stream_xs(plan) * esz;
    idx = sz + (plan == PLAN_INT4 ? cg * 2 * tw * 4 : 0);
    part = idx + pad4(cg) * 4;
    total = part + tw * 4;
  }
};

// The one-row form's splits: the largest power of two <= SMAXS keeping
// sum(ceil(N_i / TW)) * S within one block an SM.
int stream_splits(int tiles, int n_sms) {
  int S = 1;
  while (S < SMAXS && tiles * 2 * S <= n_sms) S *= 2;
  return S;
}

// Thread (row lane rl, chunk q) streams rows rl, rl + SRL, ... of the
// block's share of the kept groups' slabs (GROWS rows a group, IPG of
// them the thread's), 16 bytes of each, through its own slots of a ring
// of SNST stages in shared memory (cp.async, SNST - 1 ahead), and does
// its FMAs on what it copied itself: no block barrier in the loop. A
// chunk of CG kept groups at a time has its indices, input values and
// (int4) scale and zero rows staged in shared memory first; packed int4
// adds (x_lo nib_lo + x_hi nib_hi) and x_lo + x_hi over the thread's rows
// of a group in fp32 -- as (x_lo (128 + nib_lo) + x_hi (128 + nib_hi))
// less 128 (x_lo + x_hi), one PRMT a nibble -- then the group's scale and
// zero on them. Sums are
// added in a fixed order: a thread's rows in order, the row lanes in
// order, the cluster's S blocks in rank order.
template <typename T, int P, int G>
__global__ void __launch_bounds__(THREADS, 2) bgg_stream_kernel(Args a) {
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int WESZ = P == PLAN_STREAM ? ESZ : 1;
  constexpr int TW = SPIECE / WESZ;         // tile columns
  constexpr int VEC = 16 / WESZ;            // a chunk's columns
  constexpr int GROWS = P == PLAN_INT4 ? G / 2 : G;
  constexpr int IPG = GROWS / SRL;          // a thread's rows of a group
  constexpr int CG = stream_xs(P) / G;      // groups a chunk
  static_assert(GROWS % SRL == 0, "whole row lanes a group");
  extern __shared__ __align__(128) unsigned char sm[];
  const StreamLayout lay(ESZ, P, G);
  uint4* ring = reinterpret_cast<uint4*>(sm);
  const T* xs = reinterpret_cast<const T*>(sm + lay.xs);
  const float* szs = reinterpret_cast<const float*>(sm + lay.sz);
  int* sidx = reinterpret_cast<int*>(sm + lay.idx);
  float* part = reinterpret_cast<float*>(sm + lay.part);

  const int tid = threadIdx.x, S = a.S;
  const int split = static_cast<int>(blockIdx.x) % S;
  int wi = 0, t = static_cast<int>(blockIdx.x) / S, c0 = 0;
  while (t >= (a.n[wi] + TW - 1) / TW) {
    t -= (a.n[wi] + TW - 1) / TW;
    c0 += a.n[wi++];
  }
  const int N = a.n[wi], off = t * TW, valid = min(TW, N - off);
  c0 += off;
  const int q = tid % SCPR, rl = tid / SCPR;
  const bool live = q * VEC < valid;
  const int nb = a.K / G;
  const size_t krows = P == PLAN_INT4 ? a.K / 2 : a.K;
  const unsigned char* wsrc =
      static_cast<const unsigned char*>(a.w[wi]) +
      (static_cast<size_t>(a.layer) * krows * N + off + q * VEC) * WESZ;
  const float* szsrc =
      P == PLAN_INT4
          ? a.sz[wi] + static_cast<size_t>(a.layer) * nb * 2 * N + off
          : nullptr;
  const unsigned char* xsrc = static_cast<const unsigned char*>(a.xpack);
  const int j0 = split_lo(a.k_keep, S, split);
  const int mine = split_lo(a.k_keep, S, split + 1) - j0;

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  for (int cb = 0; cb < mine; cb += CG) {
    const int ng = min(CG, mine - cb);
    for (int u = tid; u < ng; u += THREADS)
      sidx[u] = min(max(__ldg(a.idx + j0 + cb + u), 0), nb - 1);
    __syncthreads();
    // group 0: the chunk's input values and (int4) scale and zero rows
    constexpr int XCH = G * ESZ / 16;       // 16-byte chunks a group's x
    for (int c = tid; c < ng * XCH; c += THREADS)
      cp_async16(sm + lay.xs + c * 16,
                 xsrc + static_cast<size_t>(j0 + cb + c / XCH) * LANES *
                            ESZ + (c % XCH) * 16);
    if constexpr (P == PLAN_INT4) {
      // a scale or zero row's 16-byte chunk ch (columns 4ch..4ch+3: chunk
      // j = ch % 4 of thread q = ch / 4's 16) lands at j * SCPR + q, so a
      // thread's four loads of a row are conflict-free across a warp
      constexpr int ZCH = TW / 4;           // 16-byte chunks a sz row
      for (int c = tid; c < ng * 2 * ZCH; c += THREADS) {
        const int r = c / ZCH, ch = c % ZCH;
        if (ch * 4 < valid)
          cp_async16(sm + lay.sz + (r * ZCH + (ch % 4) * SCPR + ch / 4) * 16,
                     szsrc + (static_cast<size_t>(sidx[r / 2]) * 2 + r % 2) *
                                 N + ch * 4);
      }
    }
    cp_async_commit();
    // groups 1, 2, ...: this thread's rows, SNST - 1 ahead
    const int nit = ng * IPG;
    auto copy_row = [&](int it) {
      if (it < nit && live)
        cp_async16(&ring[(it % SNST) * THREADS + tid],
                   wsrc + (static_cast<size_t>(sidx[it / IPG]) * GROWS + rl +
                           (it % IPG) * SRL) * N * WESZ);
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < SNST - 1; ++i) copy_row(i);
    cp_async_wait<SNST - 2>();              // the staged chunk and row 0
    __syncthreads();
    float p[P == PLAN_INT4 ? VEC : 1], sx = 0.f;
#pragma unroll
    for (int e = 0; e < (P == PLAN_INT4 ? VEC : 1); ++e) p[e] = 0.f;
    for (int it = 0; it < nit; ++it) {
      cp_async_wait<SNST - 2>();            // row it has landed
      copy_row(it + SNST - 1);              // into the slot row it - 1 left
      const uint4 raw = ring[(it % SNST) * THREADS + tid];
      const int u = it / IPG, l = rl + (it % IPG) * SRL;
      const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
      if constexpr (P == PLAN_INT4) {
        const float xlo = to_f(xs[u * G + l]);
        const float xhi = to_f(xs[u * G + G / 2 + l]);
        sx += xlo + xhi;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const uint32_t lo = wd[h] & 0x0F0F0F0Fu, hi = (wd[h] >> 4) &
                                                       0x0F0F0F0Fu;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            p[h * 4 + k] = fmaf(xhi, nib128_f(hi, k),
                                fmaf(xlo, nib128_f(lo, k), p[h * 4 + k]));
        }
        if (it % IPG == IPG - 1) {          // the group's last row here
          const float4* sc =
              reinterpret_cast<const float4*>(szs + u * 2 * TW) + q;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 s4 = sc[j * SCPR], z4 = sc[TW / 4 + j * SCPR];
            const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
            const float zv[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int e = j * 4 + k;
              acc[e] = fmaf(fmaf(-128.f, sx, p[e]), sv[k],
                            fmaf(sx, zv[k], acc[e]));
              p[e] = 0.f;
            }
          }
          sx = 0.f;
        }
      } else {
        const float x = to_f(xs[u * G + l]);
        if constexpr (P == PLAN_INT8) {
#pragma unroll
          for (int h = 0; h < 4; ++h)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              acc[h * 4 + k] = fmaf(x, i8_f(wd[h], k), acc[h * 4 + k]);
        } else {
          const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = fmaf(x, to_f(v[e]), acc[e]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();                        // the chunk's staging is free
  }

  // fixed-order sums: the row lanes in order, then the cluster's blocks
  // in rank order, each finishing TW / S of the tile's columns
  float* red = reinterpret_cast<float*>(sm);        // [SRL][TW]
#pragma unroll
  for (int e = 0; e < VEC; ++e) red[rl * TW + q * VEC + e] = acc[e];
  __syncthreads();
  for (int c = tid; c < TW; c += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < SRL; ++r) s += red[r * TW + c];
    part[c] = s;
    if (S == 1 && c < valid) a.out[c0 + c] = s;
  }
  if (S > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                         // every block's sums are in
    const int cw = TW / S;
    for (int c = split * cw + tid; c < (split + 1) * cw; c += THREADS) {
      float s = 0.f;
      for (int r = 0; r < S; ++r) s += cluster.map_shared_rank(part, r)[c];
      if (c < valid) a.out[c0 + c] = s;
    }
    cluster.sync();                         // no peer reads `part` after
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

int tiles_of(const int (&n)[3], int tw) {
  return (n[0] + tw - 1) / tw + (n[1] + tw - 1) / tw + (n[2] + tw - 1) / tw;
}

// The launch plan of either form, from shapes only: {form (0 the one-row
// stream, R == 1; 1 the rows form on the tensor cores, R == 8), S, ring
// stages, shared bytes (-1 where nothing fits)}.
struct FullPlan { int form, S, nst, smem; };

FullPlan full_plan(int esz, int plan, int G, const int (&n)[3], int k_keep,
                   int R, int n_sms) {
  FullPlan f = {R == 1 ? 0 : 1, 0, 0, -1};
  if (R == 1) {
    const StreamLayout lay(esz, plan, G);
    const int tiles = tiles_of(n, lay.tw);
    if (tiles <= 0 || k_keep < 1) return f;
    f.S = stream_splits(tiles, n_sms);
    f.nst = SNST;
    f.smem = lay.total;
    return f;
  }
  const BggPlan p = bgg_plan(esz, plan, G, tiles_of(n, TC), k_keep, n_sms);
  f.S = p.S;
  f.nst = p.nst;
  f.smem = p.smem;
  return f;
}

template <typename T, int P, int G>
int launch(const Args& a0, cudaStream_t stream) {
  const FullPlan p = full_plan(static_cast<int>(sizeof(T)), P, G, a0.n,
                               a0.k_keep, a0.R, device_sms());
  if (p.smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a = a0;
  a.S = p.S;
  a.nst = p.nst;
  auto fn = p.form == 0 ? bgg_stream_kernel<T, P, G> : bgg_kernel<T, P, G>;
  static bool attr_set[2] = {false, false};
  if (!attr_set[p.form]) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set[p.form] = true;
  }
  const int tw = p.form == 0 ? StreamLayout(sizeof(T), P, G).tw : TC;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_of(a.n, tw) * p.S, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fn, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int dispatch_plan(int plan, const Args& a, cudaStream_t s) {
  switch (plan) {
    case PLAN_STREAM: return launch<T, PLAN_STREAM, G>(a, s);
    case PLAN_INT8: return launch<T, PLAN_INT8, G>(a, s);
    case PLAN_INT4:
      if constexpr (G >= 64)
        return launch<T, PLAN_INT4, G>(a, s);
      else
        return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int plan, const Args& a, int G, cudaStream_t s) {
  switch (G) {
    case 32: return dispatch_plan<T, 32>(plan, a, s);
    case 64: return dispatch_plan<T, 64>(plan, a, s);
    case 128: return dispatch_plan<T, 128>(plan, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The launch plan for a stream of type dtype (0 fp32, 1 bf16), weight
// plan `plan`, group size G, output widths n0..n2 (n_w of them), k_keep,
// xpack's rows R (1: the one-row stream; 8: the rows form) and an SM
// count: out = {form, S, ring stages, shared bytes a block}; shared bytes
// -1 where no plan fits.
extern "C" int teal_block_gather_plan(int dtype, int plan, int G, int n0,
                                      int n1, int n2, int n_w, int k_keep,
                                      int R, int n_sms, int* out) {
  const int n[3] = {n0, n_w > 1 ? n1 : 0, n_w > 2 ? n2 : 0};
  const FullPlan p = full_plan(dtype == 0 ? 4 : 2, plan, G, n, k_keep, R,
                               n_sms);
  out[0] = p.form;
  out[1] = p.S;
  out[2] = p.nst;
  out[3] = p.smem;
  return 0;
}

// The kept groups [out[0], out[1]) that split s of S takes of k_keep
// (both forms).
extern "C" int teal_block_gather_split(int k_keep, int S, int s, int* out) {
  out[0] = split_lo(k_keep, S, s);
  out[1] = split_lo(k_keep, S, s + 1);
  return 0;
}

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
  a.R = R;
  a.rows = rows;
  a.S = 1;
  a.nst = 2;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(plan, a, G, s)
                    : dispatch<__nv_bfloat16>(plan, a, G, s);
}
