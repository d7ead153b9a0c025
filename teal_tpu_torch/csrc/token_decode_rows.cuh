// K7's rows form: one decode step of B = 2..16 rows through the whole layer
// stack in ONE persistent launch, in three weight plans (template parameter
// P, `common.cuh`'s Plan): weights, stream and cache arrays of one type
// (fp32 or bf16), or with a bf16 stream and cache all seven projections
// int8 {"q" [L, K, N], "scale" [L, N]} or packed int4 at quant group 128
// {"qp" [L, K/2, N], "sz" [L, K/128, 2, N]}. The counterpart of
// `_token_kernel` with `batch` = B (teal_tpu/ops/token_block.py:186-340,
// 371-386): every row is a sequence at its own position pos[b], with its
// own RoPE row and cache row b of [L, B, Hkv, T, 128]; the rows share one
// kept set per stage, picked by the group score pooled over the rows (the
// max over rows of each row's max |x| in the group, `select_groups_batched`,
// block_gemv.py:874) under the unified rule, and each kept slab is read
// once for all rows. With `seq` (the reference's `seq_block`) the rows are
// the consecutive positions pos[0] + i of ONE sequence in cache row 0 of
// [L, 1, Hkv, T, 128]: in each layer every row's K/V is written before any
// row's attention reads the cache, and row i attends to [lo_i, pos[0] + i)
// through the cache plus its own term in fp32 (`attn_stage(cache_rows=(0,)
// * B)`, attn_block.py:118-127; K2's seq_block form).
//
// The kernel's body is this header; `token_decode_rows.cu` builds the array
// plans and `token_decode_rows_quant.cu` the quantized ones, each its own
// library (nvcc builds them at once).
//
// The structure is K7's (`token_decode.cuh`, whose helpers this file
// shares): a cooperative grid of thread-block clusters, one block an SM,
// eight worker warps and a TMA producer warp; head-owned clusters (a kv
// head's q|k|v and attention) where Hkv clusters fit, else the other plan;
// column-owned o, gate|up and down stages whose clusters' partial sums are
// added in rank order through distributed shared memory; grid barriers
// after attention, o, gate|up and down (and q|k|v in the other plan).
// What the rows change:
//   - the B rows of the stream, of the attention output and of the
//     intermediate live in the workspace (L2), not in shared memory (16
//     rows of the 7B's intermediate are 352 KB). Two stream buffers take
//     turns: a residual stage reads the current one and writes the other;
//   - selection, once per cluster: block `rank` takes 1/C of the groups;
//     for a folded stage it pushes its per-row sums of squares into every
//     peer (row scales from the C parts in rank order), then its pooled
//     group scores; every block of the grid holds the same scores and
//     runs the same ballot scan (K1's rows prologue, select_gather_gemv.cu:
//     724);
//   - a unit of columns is 128 bytes of a slab row (64 bf16 or 32 fp32
//     columns; 128 int8 or packed-int4 columns, the quantized plans' unit
//     of batch-1 K7). A gather slot holds two TMA boxes of 64 rows x 128
//     bytes with the 128-byte swizzle and, stored beside them by the
//     producer warp from generic loads through L2 (other blocks wrote
//     them before the last grid barrier; staged by 1-D bulk copies, the
//     arrays plan's launches differ at B < 8 even with proxy fences on
//     both sides of the barrier: tools/k7_determinism.py on the variant
//     of tools/k7_rows_bulk_variant.py), the rows' input at the slot's rows,
//     [B][128 or 64] of T (rows padded by 16 bytes). Arrays and int8: the
//     two boxes are a group's 128 rows of a unit, or for gate|up the same
//     64 rows of both weights (two slots a group). Packed int4: a box is a
//     group's 64 packed rows (weight rows p and p + 64 in a byte), one box
//     a slot (gate|up: gate's and up's), each beside its group's [scale,
//     zero] rows of the unit's columns (a 2 x 128 fp32 box, swizzled);
//   - bf16 stream: mma.sync m16n8k16 with the rows as M (rows >= B zeroed
//     in registers), each warp 16 of the slot's rows as K (gate|up: warps
//     0-3 gate, 4-7 up) and all n-tiles of the unit (8 for 64 bf16
//     columns, 16 for 128 quantized ones); the folded norm (row scale and
//     gain, with the reference's two roundings) goes on the A fragments in
//     registers. int8 values and nibbles become bf16 exactly (`i8x2_bf16`,
//     `minus128`, as K1's rows form, select_gather_gemv.cu:716). int4 adds
//     (x @ nib) scale + sum(x) zero a warp's 16 rows of a group, sum(x)
//     from one more MMA against ones (K1's rows form's order); int8's
//     per-channel scale multiplies the cluster's fp32 sums in the stage
//     writers (before RoPE, the residual and silu: `scale_ref`,
//     token_block.py:431-446). fp32: FMAs, a lane 4 rows x 4 columns. The
//     warps' sums of a unit are added in warp order;
//   - q|k|v sums go to the workspace for every plan (the head-owned plan
//     orders them for its cluster with a cluster barrier, not a grid one);
//   - attention: a warp a (row, kv head): LPR lanes a cache row, chunks of
//     RPW * UA rows, the two passes of `attention` (the same rounding
//     points: one max, weights rounded to T), the scores kept in the
//     warp's slice of the unit sums' shared memory where they fit. With
//     `seq`, the cluster of kv head h (h mod the clusters) takes all its
//     rows: every row's K/V written, a cluster barrier, then every row's
//     attention; a position other than pos[0] + i traps, as K2's SEQ form;
//   - the epilogues write each (row, column) once: q|k|v sums (fp32),
//     T(sums + h) into the other stream buffer, T(silu(gate) * up).
// A stage that keeps no group skips as K7 does (o and down leave the
// stream as it is; gate|up makes the intermediate 0, so down selects on
// zero scores and skips its gather). Every sum has a fixed order; no data
// atomics. The plan comes from shapes and the card's resident clusters
// (`rows_plan`, exported as `teal_token_plan_rows` / `_rows_q` and mirrored
// by the wrapper's `_token_plan(..., rows=B)`).
#pragma once

#include "token_decode.cuh"

namespace {

constexpr int MAXB = 16;               // rows: the MMA's M
constexpr int RBOX = 64;               // rows of a box (128 bytes each)
constexpr int UA_MAX = 8;              // cache rows in flight a lane

// columns of a unit (a box row of 128 bytes): 64 bf16, 32 fp32, 128 int8
// or packed int4
__host__ __device__ constexpr int rows_unit(int plan, int esz) {
  return plan == PLAN_STREAM ? 128 / esz : 128;
}
// bytes of a slot's boxes: two, and for int4 two groups' [scale, zero]
// rows (1024-byte multiples: the swizzle's period)
__host__ __device__ constexpr int rows_boxes(int plan) {
  return 2 * BOXB + (plan == PLAN_INT4 ? 2 * SZB : 0);
}
// bytes of a staged input row (a group of T, +16 so that ldmatrix's rows
// fall on distinct banks) and of a slot's staged rows
__host__ __device__ constexpr int rows_xs(int esz) { return HD * esz + 16; }
__host__ __device__ constexpr int rows_xslot(int esz) {
  return MAXB * rows_xs(esz);
}
// attention: cache rows in flight a lane (fewer for many query heads,
// whose scores and PV sums take registers) and rows of a warp's chunk
__host__ __device__ constexpr int rows_ua(int GH) {
  return GH <= 2 ? UA_MAX : UA_MAX * 2 / GH;
}
__host__ __device__ constexpr int rows_chunk(int esz, int GH) {
  return 32 / (HD * esz / 16) * rows_ua(GH);
}

// Shared memory, bytes: the ring's boxes [nslot][`rows_boxes`] (1024-byte
// aligned, the swizzle's period), the staged input rows [nslot][16][XS],
// full and empty mbarriers, the block's partial sums `part` [NW][B][cluster
// columns] fp32 (read by the peers), the warps' sums of a unit [8][16][unit]
// fp32, the peers' sums of squares [MAXC][16], the row scales [16], the
// group scores, the kept groups and count, MISC floats of scratch.
struct RowsLayout {
  int xring, bars, part, red, ssq, rs, scores, idx, misc, total;
  __host__ __device__ RowsLayout(int plan, int esz, int D, int I, int capmax,
                                 int partf, int nslot) {
    xring = nslot * rows_boxes(plan);
    bars = xring + nslot * rows_xslot(esz);
    part = bars + 2 * MAXSLOT * 8;
    red = part + partf * 4;
    ssq = red + NWORK * MAXB * rows_unit(plan, esz) * 4;
    rs = ssq + MAXC * MAXB * 4;
    scores = rs + MAXB * 4;
    idx = scores + pad4(imax(D, I) / HD) * 4;
    misc = idx + pad4(capmax + 1) * 4;
    total = misc + MISC * 4;
  }
};

// Workspace, bytes from its (256-byte aligned) base: the grid barrier's
// counter, the q|k|v sums [B][(Hq + 2 Hkv) 128] fp32, the two stream
// buffers [B][D], the attention output [B][Hq 128] and the intermediate
// [B][I] of T.
struct RowsWs {
  size_t bar, qkv, h, h2, attn, inter, total;
  __host__ __device__ RowsWs(int esz, int B, int D, int I, int Hq, int Hkv) {
    bar = 0;
    qkv = 256;
    h = al256(qkv + static_cast<size_t>(B) * (Hq + 2 * Hkv) * HD * 4);
    h2 = al256(h + static_cast<size_t>(B) * D * esz);
    attn = al256(h2 + static_cast<size_t>(B) * D * esz);
    inter = al256(attn + static_cast<size_t>(B) * Hq * HD * esz);
    total = al256(inter + static_cast<size_t>(B) * I * esz);
  }
};

// The rows form's plan: the structure (C, clusters, head-owned) of
// `token_plan`; units of 128 bytes; `part` holds B rows of the largest NW x
// (columns of a cluster) of the stages; the ring takes what shared memory
// is left, up to MAXSLOT slots of their boxes and staged rows, at least
// two. NS = the rows of a warp's attention chunk. The quantized plans take
// a bf16 stream only.
TokPlan rows_plan(int plan, int esz, int B, int D, int I, int Hq, int Hkv,
                  int T, int capmax, int n_sms, const int* nc) {
  TokPlan p = {0, 0, 0, 0, 0, 0, 0, -1, 0};
  if ((esz != 2 && esz != 4) || plan < PLAN_STREAM || plan > PLAN_INT4 ||
      (plan != PLAN_STREAM && esz != 2) || B < 2 || B > MAXB || D <= 0 ||
      I <= 0 || D % HD || I % HD || Hkv <= 0 || Hq != D / HD || Hq % Hkv ||
      MAXGH % (Hq / Hkv) || T < 1 || capmax < 1 ||
      capmax > imax(D, I) / HD)
    return p;
  const int GH = Hq / Hkv;
  const Structure sc = token_structure(Hkv, n_sms, nc);
  if (sc.C == 0) return p;
  const int C = sc.C, NC = sc.NC, head = sc.head;
  const int uw = rows_unit(plan, esz);
  auto most = [&](int cols, int nw) { return nw * cdiv(cols / uw, NC) * uw; };
  const int partf = B * imax(imax(most(D, 1), most(I, 2)),
                             head ? (GH + 2) * HD
                                  : most((Hq + 2 * Hkv) * HD, 1));
  const int rest = RowsLayout(plan, esz, D, I, capmax, partf, 0).total;
  const int nslot = imin(MAXSLOT, (SMEM_MAX - rest) /
                                      (rows_boxes(plan) + rows_xslot(esz)));
  if (nslot < 2) return p;
  p = {C, NC, head, NC * C, nslot, rows_chunk(esz, GH), partf,
       RowsLayout(plan, esz, D, I, capmax, partf, nslot).total,
       RowsWs(esz, B, D, I, Hq, Hkv).total};
  return p;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(addr), "f"(v)
               : "memory");
}

// The kept groups of a stage whose input rows x [B][K] (T, the workspace)
// are folded with `gain` (the rms_norm; null: taken as they are), or all
// zero (x null: the intermediate of a gate|up stage that kept nothing),
// every block the same: block `rank` of the cluster takes groups [g0, g1),
// a warp a group, each lane the same 16-byte chunk of every row (all its
// loads in flight at once); it pushes its rows' sums of squares (a
// group's in a butterfly, the groups added in order in `tmp`) into every
// peer (the row scales `rs` from the C parts in rank order), then its
// pooled scores (max over rows and the group of |selection input|); warp
// 0 scans. Block 0 records the kept count and groups in `sel` row (l,
// st). Returns the count.
template <typename T>
__device__ __forceinline__ int select_rows(const Args& a, const T* x, int K,
                                        const T* gain, float thr, int cap,
                                        float* ssq, float* rs, float* scores,
                                        int* idx, float* tmp, int rank,
                                        int C, int l, int st) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // a chunk: 8 / 4
  constexpr int CPR = HD / EPC;             // chunks of a group's row
  constexpr int RPL = 32 / CPR;             // rows a warp's pass: 2 / 1
  constexpr int NL = MAXB / RPL;            // chunks a lane, at most
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = K / HD, B = a.B;
  const int g0 = split_lo(nb, C, rank), g1 = split_lo(nb, C, rank + 1);
  const int cc = lane % CPR, rl = lane / CPR;
  // the lane's chunk cc of group g's rows rl + RPL i (zeros past B)
  auto load = [&](int g, uint4 (&c)[NL]) {
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int b = rl + RPL * i;
      c[i] = b < B ? __ldcg(reinterpret_cast<const uint4*>(
                                x + static_cast<size_t>(b) * K + g * HD) +
                            cc)
                   : make_uint4(0, 0, 0, 0);
    }
  };
  if (x != nullptr && gain != nullptr) {
    for (int g = g0 + warp; g < g1; g += NWARPS) {
      uint4 c[NL];
      load(g, c);
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        float v[EPC];
        unpack16(c[i], v);
        float ss = 0.f;
#pragma unroll
        for (int e = 0; e < EPC; ++e) ss = fmaf(v[e], v[e], ss);
#pragma unroll
        for (int o = 1; o < CPR; o <<= 1)
          ss += __shfl_xor_sync(0xffffffffu, ss, o);
        const int b = rl + RPL * i;
        if (cc == 0 && b < B) tmp[(g - g0) * MAXB + b] = ss;
      }
    }
    __syncthreads();
    if (tid < B) {
      float ss = 0.f;
      for (int g = 0; g < g1 - g0; ++g) ss += tmp[g * MAXB + tid];
      for (int q = 0; q < C; ++q)
        st_cluster(mapa(smem_u32(ssq + rank * MAXB + tid), q), ss);
    }
    cluster_sync();
    // rsqrtf, as K1's rows form and the batch-1 fold
    if (tid < MAXB) {
      float s = 0.f;
      for (int r = 0; r < C; ++r) s += ssq[r * MAXB + tid];
      rs[tid] = tid < B ? rsqrtf(s / static_cast<float>(K) + a.eps) : 0.f;
    }
    __syncthreads();
  }
  if (!a.fixed) {
    if (x == nullptr) {
      for (int g = tid; g < nb; g += THREADS) scores[g] = 0.f;
      __syncthreads();
    } else {
      for (int g = g0 + warp; g < g1; g += NWARPS) {
        uint4 c[NL];
        load(g, c);
        float gv[EPC];
        if (gain != nullptr)
          unpack16(__ldg(reinterpret_cast<const uint4*>(gain + g * HD) + cc),
                   gv);
        float m = 0.f;
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          const int b = rl + RPL * i;
          if (b < B) {
            float v[EPC];
            unpack16(c[i], v);
#pragma unroll
            for (int e = 0; e < EPC; ++e)
              m = fmaxf(m, fabsf(gain == nullptr
                                     ? v[e]
                                     : rnd<T>(rnd<T>(v[e] * rs[b]) * gv[e])));
          }
        }
        m = warp_max(m);
        if (lane < C) st_cluster(mapa(smem_u32(scores + g), lane), m);
      }
      cluster_sync();
    }
  }
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

// One 16-byte chunk of a swizzled box row (128-byte rows, the 128-byte
// swizzle: chunk c of row r at chunk c ^ (r & 7)).
__device__ __forceinline__ uint4 ld_sw(const unsigned char* box, int row,
                                       int chunk) {
  return *reinterpret_cast<const uint4*>(box + row * 128 +
                                         ((chunk ^ (row & 7)) << 4));
}

// The quantized plans' warp sums of a unit, [MAXB][128] a warp: (row b,
// column c) at column c ^ 8 ((c / 32) mod 4) ^ b of row b (a permutation
// of the row), so that a warp's accumulator stores (rows b0..b0+7 at
// columns 32 q + t, q = 0..3) fall on 32 distinct banks.
__device__ __forceinline__ int rows_rix(int b, int c) {
  return b * 128 + (c ^ (((c >> 5) & 3) << 3) ^ b);
}

// This block's share of a gather stage for B rows: for each unit of the
// cluster's columns, the sums over this block's slots of x[b][row] *
// W[layer, row, columns], into part [NW][B][cluster columns]. A slot is one
// kept group (NW = 1, or packed int4: its 128 rows) or half of one (NW = 2
// of arrays and int8: its 64 rows of gate and of up); the slots of a unit
// are cut over the C blocks in rank order. The producer warp's lane 0
// waits for a free slot and arms it, lanes 0 and 1 issue the boxes (int4:
// each with its group's [scale, zero] box), then the warp loads the rows'
// input at the slot's rows and stores it beside the boxes, and lane 0
// arrives a second time. `gain` (or null) and `rs` fold the input (the
// rms_norm) in registers. Returns the ring position past the stage.
template <typename T, int NW, int P>
__device__ __forceinline__ Ring gather_rows(
    const Args& a, const Maps& maps, const Stage& st, int layer, const T* x,
    int K, const T* gain, const float* rs, const int* idx, int count,
    int rank, int C, int nslot, unsigned char* sm, int xring, uint32_t bars,
    float* part, float* red, Ring q) {
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int UW = rows_unit(P, ESZ);     // columns of a unit
  constexpr int XS = rows_xs(ESZ);
  constexpr int XSLOT = rows_xslot(ESZ);
  constexpr int SLOTB = rows_boxes(P);
  constexpr int SPG = NW == 1 || P == PLAN_INT4 ? 1 : 2;   // slots a group
  constexpr int KR = HD / SPG;              // inputs (weight rows) a slot
  constexpr int HALF = KR / 2;              // the second k-half's rows
  constexpr int NT = P == PLAN_STREAM ? 8 : 16;   // n-tiles of a unit (MMA)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = a.B, ncol = st.nu * UW;
  const int nsl = SPG * count;
  const int r0 = split_lo(nsl, C, rank), r1 = split_lo(nsl, C, rank + 1);
  if (warp == NWORK) {                   // the producer
    const uint64_t policy = evict_first();
    constexpr int TX = P == PLAN_INT4 ? NW * (BOXB + SZB) : 2 * BOXB;
    constexpr int XCH = KR * ESZ / 16;     // 16-byte chunks of a row's input
    constexpr int XPL = MAXB * XCH / 32;   // chunks a lane, at most
    for (int t = 0; t < st.nu; ++t) {
      int m0 = st.map[0], m1 = st.map[1], col = (st.u0 + t) * UW;
      if (NW == 1) {
        unit_src<UW>(st, st.u0 + t, m0, col);
        m1 = m0;
      }
      for (int r = r0; r < r1; ++r) {
        const int g = idx[r / SPG];
        const int half = SPG == 1 ? 0 : (r & 1);
        // the rows' input at the slot's rows: generic loads through L2
        // (the rows were written by other blocks before the last grid
        // barrier; bulk copies of them raced: see the header), all of a
        // lane's in flight while the slot is awaited, stored beside the
        // boxes once it is free; lane 0's second arrival publishes them
        uint4 xv[XPL];
#pragma unroll
        for (int i = 0; i < XPL; ++i) {
          const int j = lane + 32 * i, b = j / XCH;
          if (b < B)
            xv[i] = __ldcg(reinterpret_cast<const uint4*>(
                               x + static_cast<size_t>(b) * K + g * HD +
                               half * KR) +
                           j % XCH);
        }
        const uint32_t full = bars + q.s * 8;
        if (lane == 0) {
          mbar_wait_bounded(bars + (MAXSLOT + q.s) * 8, q.ph ^ 1u);
          mbar_expect_tx(full, TX);
        }
        __syncwarp();
        const uint32_t box = smem_u32(sm) + q.s * SLOTB;
        if (P == PLAN_INT4) {
          if (lane < NW) {                 // a group's 64 packed rows
            const int m = lane == 0 ? m0 : m1;
            tma_load(box + lane * BOXB, &maps.m[m], col,
                     layer * (K / 2) + g * (HD / 2), full, policy);
            tma_load3(box + 2 * BOXB + lane * SZB, &maps.m[7 + m], col,
                      (layer * (K / HD) + g) * 2, full, policy);
          }
        } else {
          const int row = layer * K + g * HD + half * KR;
          if (lane == 0)
            tma_load(box, &maps.m[m0], col, row, full, policy);
          else if (lane == 1)
            tma_load(box + BOXB, &maps.m[m1], col,
                     row + (NW == 1 ? RBOX : 0), full, policy);
        }
#pragma unroll
        for (int i = 0; i < XPL; ++i) {
          const int j = lane + 32 * i, b = j / XCH;
          if (b < B)
            *reinterpret_cast<uint4*>(sm + xring + q.s * XSLOT + b * XS +
                                      (j % XCH) * 16) = xv[i];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(full);
        q.next(nslot);
      }
    }
    return q;
  }
  // NW == 2: warps 0-3 take gate's box, 4-7 up's; wi = the warp's slice
  const int wi = NW == 1 ? warp : (warp & 3);
  const int wb = NW == 1 ? 0 : (warp >> 2);
  const int qd = lane & 3, rw = lane >> 2;
  for (int t = 0; t < st.nu; ++t) {
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
    for (int r = r0; r < r1; ++r) {
      mbar_wait_bounded(bars + q.s * 8, q.ph);
      const unsigned char* slot = sm + q.s * SLOTB;
      const unsigned char* xt = sm + xring + q.s * XSLOT;
      const int g = idx[r / SPG];
      const int half = SPG == 1 ? 0 : (r & 1);
      const T* gp = gain == nullptr ? nullptr : gain + g * HD + half * KR;
      // A: the 16 rows' inputs at k-indices k0..k0+7 and k1..k1+7 of the
      // slot, folded (the selection input) and zero past B
      auto a_frag = [&](int k0, int k1, uint32_t (&af)[4]) {
        const int mi = lane >> 3;
        ldsm_x4(af, xt + ((lane & 7) + (mi & 1) * 8) * XS +
                        ((mi >> 1) ? k1 : k0) * 2);
        if (gp != nullptr) {
          const uint32_t glo =
              __ldg(reinterpret_cast<const unsigned*>(gp + k0 + 2 * qd));
          const uint32_t ghi =
              __ldg(reinterpret_cast<const unsigned*>(gp + k1 + 2 * qd));
          af[0] = sel2(af[0], rs[rw], glo);
          af[1] = sel2(af[1], rs[rw + 8], glo);
          af[2] = sel2(af[2], rs[rw], ghi);
          af[3] = sel2(af[3], rs[rw + 8], ghi);
        }
        if (rw >= B) af[0] = af[2] = 0u;
        if (rw + 8 >= B) af[1] = af[3] = 0u;
      };
      if constexpr (P == PLAN_STREAM && ESZ == 2) {
        // k-index i < 8: the slot's row 8 wi + i; i >= 8: row HALF + 8 wi
        // + i - 8 (NW = 1: box 1's row 8 wi + i - 8)
        uint32_t af[4];
        a_frag(8 * wi, HALF + 8 * wi, af);
        const unsigned char* bx0 = slot + wb * BOXB;
        const unsigned char* bx1 = slot + (NW == 1 ? BOXB : wb * BOXB);
        const int ra = 8 * wi + 2 * qd;
        const int rb = (NW == 1 ? 0 : HALF) + 8 * wi + 2 * qd;
        const uint4 v0 = ld_sw(bx0, ra, rw), v1 = ld_sw(bx0, ra + 1, rw);
        const uint4 v2 = ld_sw(bx1, rb, rw), v3 = ld_sw(bx1, rb + 1, rw);
        const uint32_t e0[4] = {v0.x, v0.y, v0.z, v0.w};
        const uint32_t e1[4] = {v1.x, v1.y, v1.z, v1.w};
        const uint32_t e2[4] = {v2.x, v2.y, v2.z, v2.w};
        const uint32_t e3[4] = {v3.x, v3.y, v3.z, v3.w};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint32_t sp = (nt & 1) ? 0x7632u : 0x5410u;
          mma16816(acc[nt], af, __byte_perm(e0[nt >> 1], e1[nt >> 1], sp),
                   __byte_perm(e2[nt >> 1], e3[nt >> 1], sp));
        }
      } else if constexpr (P == PLAN_STREAM) {
        // fp32: lane = (row quad bq, column chunk c); the warp's 16 rows
        // 16 wi .. 16 wi + 15 of its box (NW = 1: box warp / 4)
        const int bq = lane >> 3, c = lane & 7;
        const unsigned char* box = slot + (warp >> 2) * BOXB;
        const int br0 = 16 * (warp & 3);
        const int xk0 = NW == 1 ? 16 * warp : 16 * wi;
        if (4 * bq < B) {
#pragma unroll 4
          for (int i = 0; i < 16; ++i) {
            const int br = br0 + i;
            const float4 w4 = *reinterpret_cast<const float4*>(
                box + br * 128 + ((c ^ (br & 7)) << 4));
            const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
            const float gv = gp == nullptr ? 1.f : to_f(__ldg(gp + xk0 + i));
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int b = 4 * bq + j;
              float xv = *reinterpret_cast<const float*>(xt + b * XS +
                                                         (xk0 + i) * 4);
              if (gp != nullptr) xv = (xv * rs[b]) * gv;
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[j][e] = fmaf(xv, wv[e], acc[j][e]);
            }
          }
        }
      } else if constexpr (P == PLAN_INT8) {
        // as bf16 arrays, 16 n-tiles of 128 columns: n-tile t's column n
        // is the unit's column 16 n + t, a lane's 16-byte chunk rw of the
        // slot's rows ra, ra + 1 (k 2qd, 2qd + 1) and rb, rb + 1
        uint32_t af[4];
        a_frag(8 * wi, HALF + 8 * wi, af);
        const unsigned char* bx0 = slot + wb * BOXB;
        const unsigned char* bx1 = slot + (NW == 1 ? BOXB : wb * BOXB);
        const int ra = 8 * wi + 2 * qd;
        const int rb = (NW == 1 ? 0 : HALF) + 8 * wi + 2 * qd;
        const uint4 v0 = ld_sw(bx0, ra, rw), v1 = ld_sw(bx0, ra + 1, rw);
        const uint4 v2 = ld_sw(bx1, rb, rw), v3 = ld_sw(bx1, rb + 1, rw);
        const uint32_t e0[4] = {v0.x, v0.y, v0.z, v0.w};
        const uint32_t e1[4] = {v1.x, v1.y, v1.z, v1.w};
        const uint32_t e2[4] = {v2.x, v2.y, v2.z, v2.w};
        const uint32_t e3[4] = {v3.x, v3.y, v3.z, v3.w};
#pragma unroll
        for (int nt = 0; nt < 16; ++nt)
          mma16816(acc[nt], af,
                   i8x2_bf16(e0[nt >> 2], e1[nt >> 2], nt & 3),
                   i8x2_bf16(e2[nt >> 2], e3[nt >> 2], nt & 3));
      } else {
        // packed int4: a k-step is packed rows pr0..pr0+7 of the warp's
        // box, their low nibbles k-indices 0..7 (weight rows pr0 + i), the
        // high ones 8..15 (rows 64 + pr0 + i). NW = 1: warp w's rows 8 w;
        // NW = 2: 16 wi and 16 wi + 8 of gate's (warps 0-3) or up's box.
        // Each k-step adds (x @ nib) scale + sum(x) zero, sum(x) from an
        // MMA against ones (K1's rows form's order); a lane's columns 32 qd
        // + t and 32 qd + 16 + t take their scale and zero from line qd
        // and 4 + qd of the swizzled [scale, zero] box
        const unsigned char* bx = slot + wb * BOXB;
        const unsigned char* zb = slot + 2 * BOXB + wb * SZB;
#pragma unroll
        for (int ks = 0; ks < (NW == 1 ? 1 : 2); ++ks) {
          const int pr0 = NW == 1 ? 8 * warp : 16 * wi + 8 * ks;
          uint32_t af[4];
          a_frag(pr0, HD / 2 + pr0, af);
          float sx[4] = {0.f, 0.f, 0.f, 0.f};
          mma16816(sx, af, 0x3F803F80u, 0x3F803F80u);
          const uint4 p0 = ld_sw(bx, pr0 + 2 * qd, rw);
          const uint4 p1 = ld_sw(bx, pr0 + 2 * qd + 1, rw);
          const uint32_t w0[4] = {p0.x, p0.y, p0.z, p0.w};
          const uint32_t w1[4] = {p1.x, p1.y, p1.z, p1.w};
#pragma unroll
          for (int t4 = 0; t4 < 4; ++t4) {
            const float4 se = *reinterpret_cast<const float4*>(
                zb + qd * 128 + ((t4 ^ qd) << 4));
            const float4 so = *reinterpret_cast<const float4*>(
                zb + qd * 128 + (((4 + t4) ^ qd) << 4));
            const float4 ze = *reinterpret_cast<const float4*>(
                zb + (4 + qd) * 128 + ((t4 ^ (4 + qd)) << 4));
            const float4 zo = *reinterpret_cast<const float4*>(
                zb + (4 + qd) * 128 + (((4 + t4) ^ (4 + qd)) << 4));
            const float sev[4] = {se.x, se.y, se.z, se.w};
            const float sov[4] = {so.x, so.y, so.z, so.w};
            const float zev[4] = {ze.x, ze.y, ze.z, ze.w};
            const float zov[4] = {zo.x, zo.y, zo.z, zo.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              // bytes 0, 1: packed row 2qd's byte k; 2, 3: row 2qd + 1's
              const uint32_t v = __byte_perm(w0[t4], w1[t4],
                                             k | (k << 4) | ((4 + k) << 8) |
                                                 ((4 + k) << 12));
              float p[4] = {0.f, 0.f, 0.f, 0.f};
              mma16816(p, af, minus128((v & 0x000F000Fu) | 0x43004300u),
                       minus128(((v >> 4) & 0x000F000Fu) | 0x43004300u));
              float* c = acc[4 * t4 + k];
              c[0] = fmaf(p[0], sev[k], fmaf(sx[0], zev[k], c[0]));
              c[1] = fmaf(p[1], sov[k], fmaf(sx[1], zov[k], c[1]));
              c[2] = fmaf(p[2], sev[k], fmaf(sx[2], zev[k], c[2]));
              c[3] = fmaf(p[3], sov[k], fmaf(sx[3], zov[k], c[3]));
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + (MAXSLOT + q.s) * 8);
      q.next(nslot);
    }
    // unit t's sums: the warps' sums in warp order (NW = 2: warps 0-3 for
    // gate, 4-7 for up)
    constexpr int PER = NWORK / NW;
    if constexpr (P == PLAN_STREAM && ESZ == 2) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int b = rw + 8 * (i >> 1);
          const int c = (2 * qd + (i & 1)) * 8 + nt;
          red[(warp * MAXB + b) * UW + c] = acc[nt][i];
        }
    } else if constexpr (P == PLAN_STREAM) {
      const int bq = lane >> 3, c = lane & 7;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[(warp * MAXB + 4 * bq + j) * UW + 4 * c + e] = acc[j][e];
    } else {
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          red[warp * MAXB * UW +
              rows_rix(rw + 8 * (i >> 1), 16 * (2 * qd + (i & 1)) + nt)] =
              acc[nt][i];
    }
    workers_sync();
    for (int j = tid; j < NW * B * UW; j += WORKERS) {
      const int w = j / (B * UW), b = (j / UW) % B, c = j % UW;
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < PER; ++k)
        sum += P == PLAN_STREAM
                   ? red[((w * PER + k) * MAXB + b) * UW + c]
                   : red[(w * PER + k) * MAXB * UW + rows_rix(b, c)];
      part[(w * B + b) * ncol + t * UW + c] = sum;
    }
    workers_sync();
  }
  return q;
}

// The cluster's sums of stage `st` for B rows (after a cluster barrier):
// block `rank` adds, over the cluster's blocks in rank order, its slice of
// the cluster's columns for every row and writes each once: EPI_QKV the
// fp32 sums to the q|k|v rows (`dst` [B][D + 2 kvw]) at their q|k|v
// column, EPI_RES T(sums + h) (h = `hin` [B][D]) into `dst` and `dst2`
// (or null), EPI_SILU T(silu(gate) * up) into `dst` [B][I]. int8 first
// multiplies each sum by its column's per-channel scale at `layer` (gate
// and up each by their own).
template <typename T, int P>
__device__ __forceinline__ void epilogue_rows(const Args& a, int kind,
                                           const Stage& st,
                                           const float* part, int rank,
                                           int C, int layer, const T* hin,
                                           void* dst, void* dst2, int kvw) {
  constexpr int UW = rows_unit(P, static_cast<int>(sizeof(T)));
  const int B = a.B, D = a.D, I = a.I;
  const int ncol = st.nu * UW;
  const uint32_t pb = smem_u32(part);
  const int j0 = split_lo(ncol, C, rank), nj = split_lo(ncol, C, rank + 1) -
                                              j0;
  for (int i = static_cast<int>(threadIdx.x); i < B * nj; i += THREADS) {
    const int b = i / nj, j = j0 + i % nj;
    const uint32_t addr[2] = {pb + (b * ncol + j) * 4,
                              pb + ((B + b) * ncol + j) * 4};
    const bool ok[2] = {true, kind == EPI_SILU};
    float s[2];
    cluster_sums(addr, ok, C, s);
    const int c = st.u0 * UW + j;
    int p = 0, off = c;                    // the column's weight and column
    while (p < 2 && off >= st.n[p]) off -= st.n[p++];
    const int m = st.map[p];
    if constexpr (P == PLAN_INT8) {
      const int col = st.c0[p] + off;
      s[0] *= __ldg(a.wscale[m] + static_cast<size_t>(layer) * a.wn[m] +
                    col);
      if (kind == EPI_SILU)
        s[1] *= __ldg(a.wscale[st.map[1]] +
                      static_cast<size_t>(layer) * a.wn[st.map[1]] + col);
    }
    if (kind == EPI_QKV) {
      const int qc = (m == 0 ? 0 : m == 1 ? D : D + kvw) + st.c0[p] + off;
      __stcg(static_cast<float*>(dst) + static_cast<size_t>(b) *
                                            (D + 2 * kvw) + qc, s[0]);
    } else if (kind == EPI_RES) {
      const size_t at = static_cast<size_t>(b) * D + c;
      const T v = from_f<T>(s[0] + to_f(__ldcg(hin + at)));
      st_cg(static_cast<T*>(dst) + at, v);
      if (dst2 != nullptr) static_cast<T*>(dst2)[at] = v;
    } else {
      st_cg(static_cast<T*>(dst) + static_cast<size_t>(b) * I + c,
            from_f<T>(s[0] * (1.0f / (1.0f + expf(-s[0]))) * s[1]));
    }
  }
}

// What a call of `attention_rows` does: write the row's K/V and attend
// (each row its own cache row), only write, or only attend (seq: every
// row's K/V written before any row attends).
enum AttnMode { ATT_BOTH = 0, ATT_WRITE = 1, ATT_READ = 2 };

// Row b's attention for kv head hk, by one warp: RoPE on the row's q|k|v
// sums (the workspace), the current K/V written at pos[b] of cache row b
// (seq: of cache row 0), then two passes over the live rows [lo, pos) in
// chunks of RPW * UA rows (LPR lanes a row, UA rows in flight a lane), as
// K7's one-row `attention`: the scores of q rounded to T and ONE max M
// over them and the current token, then each row's weight exp(s - M)
// rounded to T for PV and the sum of the unrounded ones; the output in T
// into the attention rows. The scores are kept in the warp's `sbuf` (nsb
// floats) where they fit, else scored again in the second pass. `mode`
// (AttnMode): ATT_WRITE stops after the K/V write, ATT_READ skips it.
template <typename T, int QG>
__device__ __forceinline__ void attention_rows(const Args& a,
                                            const RowsWs& wl, int l, int b,
                                            int hk, float* sbuf, int nsb,
                                            int mode) {
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int VE = 16 / ESZ;              // a lane's dimensions
  constexpr int LPR = HD / VE;              // lanes a cache row: 16 / 32
  constexpr int RPW = 32 / LPR;             // rows a pass: 2 / 1
  constexpr int GH = QG;
  constexpr int UA = rows_ua(GH);
  constexpr int CH = RPW * UA;
  const int lane = threadIdx.x & 31, li = lane % LPR, rr = lane / LPR;
  const int pos = a.pos[b];
  if (pos < 0 || pos >= a.T || (a.seq && pos != a.pos[0] + b)) __trap();
  const int Hq = a.Hq, Hkv = a.Hkv;
  const float* src = reinterpret_cast<const float*>(a.ws + wl.qkv) +
                     static_cast<size_t>(b) * (Hq + 2 * Hkv) * HD;
  const float* cs = a.cs + static_cast<size_t>(b) * 2 * HD;
  const int d0 = li * VE;
  // a lane's VE dimensions of a head's row, RoPE'd: the partner
  // dimensions (d +- 64) are lane li ^ LPR / 2's
  auto roped = [&](const float* row, float (&v)[VE]) {
    float x[VE];
#pragma unroll
    for (int e = 0; e < VE; e += 4) {
      const float4 r = __ldcg(reinterpret_cast<const float4*>(row + d0 + e));
      x[e] = r.x; x[e + 1] = r.y; x[e + 2] = r.z; x[e + 3] = r.w;
    }
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const float o = __shfl_xor_sync(0xffffffffu, x[e], LPR / 2);
      const int d = d0 + e;
      const float rot = d < HD / 2 ? -o : o;
      v[e] = rope_term(x[e], rot, __ldg(cs + d), __ldg(cs + HD + d));
    }
  };
  float kn[VE], vn[VE];
  roped(src + (Hq + hk) * HD, kn);
#pragma unroll
  for (int e = 0; e < VE; e += 4) {
    const float4 r = __ldcg(reinterpret_cast<const float4*>(
        src + (Hq + Hkv + hk) * HD + d0 + e));
    vn[e] = r.x; vn[e + 1] = r.y; vn[e + 2] = r.z; vn[e + 3] = r.w;
  }
  const int crows = a.seq ? 1 : a.B;        // the cache's rows
  const size_t slab =
      ((static_cast<size_t>(l) * crows + (a.seq ? 0 : b)) * Hkv + hk) *
      a.T * HD;
  T* kcache = static_cast<T*>(a.kc) + slab;
  T* vcache = static_cast<T*>(a.vc) + slab;
  // row pos: read by no warp of this layer before every row's is written
  // (seq: the other rows' warps read it through L2 after a cluster
  // barrier, so it is stored there, as the q|k|v sums are)
  if (mode != ATT_READ && rr == 0) {
    T kt[VE], vt[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      kt[e] = from_f<T>(kn[e]);
      vt[e] = from_f<T>(vn[e]);
    }
    __stcg(reinterpret_cast<uint4*>(kcache + static_cast<size_t>(pos) * HD +
                                    d0),
           *reinterpret_cast<const uint4*>(kt));
    __stcg(reinterpret_cast<uint4*>(vcache + static_cast<size_t>(pos) * HD +
                                    d0),
           *reinterpret_cast<const uint4*>(vt));
  }
  if (mode == ATT_WRITE) return;
  // q scaled, the current token's score (fp32) and q rounded to T
  float qr[GH][VE], sc[GH];
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    float qv[VE];
    roped(src + (hk * GH + g) * HD, qv);
    float p = 0.f;
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      qv[e] = __fmul_rn(qv[e], a.scale);
      qr[g][e] = rnd<T>(qv[e]);
      p = fmaf(qv[e], kn[e], p);
    }
#pragma unroll
    for (int o = 1; o < LPR; o <<= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    sc[g] = p;
  }
  const int lo = a.window > 0 ? max(pos - a.window + 1, 0) : 0;
  const int n = pos - lo;
  const int nsr = nsb / GH;                 // scores a query row keeps
  const bool keep = n <= nsr;
  auto load = [&](T* cache, int base, uint4 (&c)[UA]) {
#pragma unroll
    for (int u = 0; u < UA; ++u) {
      const int t = base + rr + u * RPW;
      c[u] = t < n ? __ldcg(reinterpret_cast<const uint4*>(
                         cache + static_cast<size_t>(lo + t) * HD + d0))
                   : make_uint4(0, 0, 0, 0);
    }
  };
  auto score = [&](const uint4 (&kv)[UA], float (&s)[UA][GH]) {
#pragma unroll
    for (int u = 0; u < UA; ++u) {
      float k[VE];
      unpack16(kv[u], k);
#pragma unroll
      for (int g = 0; g < GH; ++g) {
        float p = 0.f;
#pragma unroll
        for (int e = 0; e < VE; ++e) p = fmaf(qr[g][e], k[e], p);
#pragma unroll
        for (int o = 1; o < LPR; o <<= 1)
          p += __shfl_xor_sync(0xffffffffu, p, o);
        s[u][g] = p;
      }
    }
  };
  // pass 1: the max of each query row (the next chunk's rows in flight
  // while a chunk is scored)
  float m[GH];
#pragma unroll
  for (int g = 0; g < GH; ++g) m[g] = sc[g];
  uint4 kv[UA];
  load(kcache, 0, kv);
  for (int base = 0; base < n; base += CH) {
    float s[UA][GH];
    uint4 nx[UA];
    load(kcache, base + CH, nx);
    score(kv, s);
#pragma unroll
    for (int u = 0; u < UA; ++u) kv[u] = nx[u];
#pragma unroll
    for (int u = 0; u < UA; ++u) {
      const int t = base + rr + u * RPW;
      if (t < n) {
#pragma unroll
        for (int g = 0; g < GH; ++g) {
          m[g] = fmaxf(m[g], s[u][g]);
          if (keep && li == 0) sbuf[g * nsr + t] = s[u][g];
        }
      }
    }
  }
  if (RPW == 2)
#pragma unroll
    for (int g = 0; g < GH; ++g)
      m[g] = fmaxf(m[g], __shfl_xor_sync(0xffffffffu, m[g], 16));
  __syncwarp();
  // pass 2: weights rounded to T for PV, the sum of the unrounded ones
  float acc[GH][VE], den[GH];
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    den[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[g][e] = 0.f;
  }
  uint4 vv[UA];
  load(vcache, 0, vv);
  for (int base = 0; base < n; base += CH) {
    float s[UA][GH];
    if (!keep) {
      load(kcache, base, kv);
      score(kv, s);
    }
    uint4 cur[UA];
#pragma unroll
    for (int u = 0; u < UA; ++u) cur[u] = vv[u];
    load(vcache, base + CH, vv);          // the next chunk's V rows
#pragma unroll
    for (int u = 0; u < UA; ++u) {
      const int t = base + rr + u * RPW;
      float v[VE];
      unpack16(cur[u], v);
#pragma unroll
      for (int g = 0; g < GH; ++g) {
        const float sv = keep ? (t < n ? sbuf[g * nsr + t] : 0.f) : s[u][g];
        const float e = t < n ? expf(sv - m[g]) : 0.f;
        den[g] += e;
        const float w = rnd<T>(e);
#pragma unroll
        for (int j = 0; j < VE; ++j) acc[g][j] = fmaf(w, v[j], acc[g][j]);
      }
    }
  }
  __syncwarp();                  // sbuf: the warp's next (row, kv head)
  T* attn = reinterpret_cast<T*>(a.ws + wl.attn) +
            static_cast<size_t>(b) * Hq * HD;
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    if (RPW == 2) {
      den[g] += __shfl_xor_sync(0xffffffffu, den[g], 16);
#pragma unroll
      for (int e = 0; e < VE; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], 16);
    }
    const float ec = expf(sc[g] - m[g]);
    const float inv = 1.0f / (den[g] + ec);
    T o[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e)
      o[e] = from_f<T>((acc[g][e] + ec * vn[e]) * inv);
    if (rr == 0)
      __stcg(reinterpret_cast<uint4*>(attn + (hk * GH + g) * HD + d0),
             *reinterpret_cast<const uint4*>(o));
  }
}

// The rows form of K7 (see the header of this file). QG: the query heads
// a kv head (1, 2, 4 or 8); P: the weight plan (the quantized plans with
// T = bf16).
template <typename T, int QG, int P>
__global__ void __launch_bounds__(THREADS, 1)
    token_rows_kernel(const __grid_constant__ Maps maps,
                      const __grid_constant__ Args a) {
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int UW = rows_unit(P, ESZ);
  static_assert(P == PLAN_STREAM || ESZ == 2, "quantized plans: bf16");
  extern __shared__ __align__(1024) unsigned char sm[];
  const int tid = threadIdx.x, b = blockIdx.x, warp = tid >> 5;
  const int rank = cluster_rank(), cid = cluster_index();
  const int D = a.D, I = a.I, C = a.C, B = a.B, GH = QG;
  const RowsLayout lay(P, ESZ, D, I, a.capmax, a.partf, a.nslot);
  const RowsWs wl(ESZ, B, D, I, a.Hq, a.Hkv);
  unsigned* bar = reinterpret_cast<unsigned*>(a.ws + wl.bar);
  const uint32_t bars = smem_u32(sm + lay.bars);
  if (tid == 0) {
    for (int s = 0; s < a.nslot; ++s) {
      // full: the boxes' arrival with their bytes, and the producer's
      // once the rows' input is stored
      mbar_init(bars + s * 8, 2);
      mbar_init(bars + (MAXSLOT + s) * 8, NWORK);
    }
    mbar_init_fence();
  }
  cluster_sync();
  unsigned nbar = 0;
  auto grid_barrier = [&]() {
    barrier(bar, (nbar + 1) * a.grid, nullptr);
    ++nbar;
  };
  float* part = reinterpret_cast<float*>(sm + lay.part);
  float* red = reinterpret_cast<float*>(sm + lay.red);
  float* ssq = reinterpret_cast<float*>(sm + lay.ssq);
  float* rs = reinterpret_cast<float*>(sm + lay.rs);
  float* scores = reinterpret_cast<float*>(sm + lay.scores);
  int* idx = reinterpret_cast<int*>(sm + lay.idx);
  float* wqkv = reinterpret_cast<float*>(a.ws + wl.qkv);
  T* hbuf[2] = {reinterpret_cast<T*>(a.ws + wl.h),
                reinterpret_cast<T*>(a.ws + wl.h2)};
  T* wattn = reinterpret_cast<T*>(a.ws + wl.attn);
  T* winter = reinterpret_cast<T*>(a.ws + wl.inter);
  const T* na = static_cast<const T*>(a.na);
  const T* nm = static_cast<const T*>(a.nm);
  const int Hq = a.Hq, Hkv = a.Hkv, NC = a.NC;
  const int kvw = Hkv * HD;
  Ring ring = {0, 0u};
  const Stage head_qkv = {{0, 1, 2}, {cid * GH * HD, cid * HD, cid * HD},
                          {GH * HD, HD, HD}, D, 0, (GH + 2) * HD / UW};
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
  // gather stage i on x (folded with gain where given), then the
  // cluster's sums of it
  auto run = [&](int l, int i, const Stage& st, int count, int kind,
                 const T* x, int K, const T* gain, const T* hin, void* dst,
                 void* dst2) {
    if (i == 2)
      ring = gather_rows<T, 2, P>(a, maps, st, l, x, K, gain, rs, idx,
                                  count, rank, C, a.nslot, sm, lay.xring,
                                  bars, part, red, ring);
    else
      ring = gather_rows<T, 1, P>(a, maps, st, l, x, K, gain, rs, idx,
                                  count, rank, C, a.nslot, sm, lay.xring,
                                  bars, part, red, ring);
    __syncthreads();
    cluster_sync();
    epilogue_rows<T, P>(a, kind, st, part, rank, C, l, hin, dst, dst2, kvw);
  };
  const T* cur = static_cast<const T*>(a.x);   // the stream's rows
  auto other = [&]() { return cur == hbuf[0] ? hbuf[1] : hbuf[0]; };
  for (int l = 0; l < a.L; ++l) {
    const float thr[4] = {__ldg(a.thr + l * 7), __ldg(a.thr + l * 7 + 3),
                          __ldg(a.thr + l * 7 + 4), __ldg(a.thr + l * 7 + 6)};
    const bool last = l + 1 == a.L;
    const T* gna = na + static_cast<size_t>(l) * D;
    const T* gnm = nm + static_cast<size_t>(l) * D;
    // 1. q|k|v on the folded attention norm (run also at count 0: its
    // sums are then 0), then attention
    const int c0 = select_rows(a, cur, D, gna, thr[0], a.cap[0], ssq, rs,
                               scores, idx, red, rank, C, l, 0);
    run(l, 0, a.head ? head_qkv : stage(0), c0, EPI_QKV, cur, D, gna, cur,
        wqkv, nullptr);
    // attention: a warp a (row, kv head), its scores in its slice of
    // `red` (free between the gathers). Head-owned, and with `seq` in
    // either plan, kv head h's rows run on cluster h mod NC (with seq:
    // every row's K/V written, a cluster barrier, then every row's
    // attention); else the (row, kv head) units spread over the grid
    if (a.head)
      cluster_sync();                      // the cluster's q|k|v rows
    else
      grid_barrier();
    float* sbuf = red + warp * MAXB * UW;
    const bool grouped = a.head || a.seq;
    const int nunit = grouped ? (cid < Hkv ? cdiv(Hkv - cid, NC) : 0) * B
                              : B * Hkv;
    const int first = (grouped ? rank : b) * NWORK + warp;
    const int step = (grouped ? C : a.grid) * NWORK;
    for (int pass = 0; pass < (a.seq ? 2 : 1); ++pass) {
      if (pass == 1) cluster_sync();       // every row's K/V is written
      const int mode = a.seq ? (pass == 0 ? ATT_WRITE : ATT_READ) : ATT_BOTH;
      if (warp < NWORK)
        for (int u = first; u < nunit; u += step)
          attention_rows<T, QG>(a, wl, l, grouped ? u % B : u / Hkv,
                                grouped ? cid + u / B * NC : u % Hkv, sbuf,
                                MAXB * UW, mode);
    }
    grid_barrier();
    // 2. o, its sums added to the stream (skipped where it keeps no group)
    const int c1 = select_rows(a, static_cast<const T*>(wattn), Hq * HD,
                               static_cast<const T*>(nullptr), thr[1],
                               a.cap[1], ssq, rs, scores, idx, red, rank, C,
                               l, 1);
    if (c1 > 0) {
      T* nxt = other();
      run(l, 1, stage(1), c1, EPI_RES, wattn, D, nullptr, cur, nxt, nullptr);
      grid_barrier();
      cur = nxt;
    }
    // 3. gate|up on the folded mlp norm: T(silu(gate) * up)
    const int c2 = select_rows(a, cur, D, gnm, thr[2], a.cap[2], ssq, rs,
                               scores, idx, red, rank, C, l, 2);
    if (c2 > 0) {
      run(l, 2, stage(2), c2, EPI_SILU, cur, D, gnm, cur, winter, nullptr);
      grid_barrier();
    }
    // 4. down on the intermediate (zero where gate|up kept nothing: its
    // scores are 0 and the stream stays), its sums added to the stream;
    // its barrier is never skipped
    const int c3 = select_rows(
        a, c2 > 0 ? static_cast<const T*>(winter) : nullptr, I,
        static_cast<const T*>(nullptr), thr[3], a.cap[3], ssq, rs, scores,
        idx, red, rank, C, l, 3);
    if (c2 > 0 && c3 > 0) {
      T* nxt = other();
      run(l, 3, stage(3), c3, EPI_RES, winter, I, nullptr, cur, nxt,
          last ? a.out : nullptr);
      grid_barrier();
      cur = nxt;
    } else {
      if (last)
        for (size_t i = static_cast<size_t>(b) * THREADS + tid;
             i < static_cast<size_t>(B) * D;
             i += static_cast<size_t>(a.grid) * THREADS)
          static_cast<T*>(a.out)[i] = __ldcg(cur + i);
      grid_barrier();
    }
  }
  cluster_sync();              // no peer reads this block's shared memory
}

// --- host side -------------------------------------------------------------

// The rows kernel of (T, GH, P), its attribute set once.
template <typename T, int QG, int P>
const void* rows_fn() {
  static bool set = false;
  auto fn = token_rows_kernel<T, QG, P>;
  if (!set) {
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX) != cudaSuccess)
      return nullptr;
    set = true;
  }
  return reinterpret_cast<const void*>(fn);
}

// The rows kernel of (plan, dtype, GH): defined by the translation unit
// that builds it (`token_decode_rows.cu`: the arrays,
// `token_decode_rows_quant.cu`: int8 and int4), null for the others.
const void* rows_kernel_of(int plan, int dtype, int GH);

bool rows_form_ok(int plan, int dtype, int GH) {
  return form_ok(plan, dtype) && GH >= 1 && MAXGH % GH == 0;
}

// The card's resident clusters of each size C of the rows kernel of
// (plan, dtype, GH) at one block an SM (asked once a device).
const int* rows_cluster_table(int plan, int dtype, int GH) {
  static int table[64][16][MAXC + 1];
  static bool done[64][16];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return nullptr;
  const int k = (plan == PLAN_STREAM ? (dtype == 0 ? 0 : 4)
                                     : 4 + 4 * plan) + __builtin_ctz(GH);
  int* nc = table[dev][k];
  if (!done[dev][k]) {
    const void* fn = rows_kernel_of(plan, dtype, GH);
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

// The resident clusters of C blocks of the rows kernel of (plan, dtype,
// GH) on the current device; -1 where the kernel's attributes cannot be
// set.
int rows_clusters_impl(int plan, int dtype, int GH, int C) {
  if (!rows_form_ok(plan, dtype, GH) || C < 0 || C > MAXC) return -1;
  const int* nc = rows_cluster_table(plan, dtype, GH);
  return nc == nullptr ? -1 : nc[C];
}

// The rows form's plan into out int32 [11] (as `teal_token_plan`; NS: the
// rows of a warp's attention chunk). Returns 0, or -1 where the shapes
// take no plan.
int rows_plan_impl(int plan, int dtype, int B, int D, int I, int Hq,
                   int Hkv, int T, int capmax, int n_sms, int L, int* out) {
  if (!heads_ok(Hq, Hkv) || !rows_form_ok(plan, dtype, Hq / Hkv) || L < 1)
    return -1;
  const int* nc = rows_cluster_table(plan, dtype, Hq / Hkv);
  if (nc == nullptr) return -1;
  const TokPlan p = rows_plan(plan, dtype == 0 ? 4 : 2, B, D, I, Hq, Hkv, T,
                              capmax, n_sms, nc);
  if (p.smem < 0) return -1;
  const int v[11] = {p.grid, THREADS, p.smem, static_cast<int>(p.ws),
                     (p.head ? NBAR - 1 : NBAR) * L, 0, p.C, p.NC, p.head,
                     p.nslot, p.NS};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

// One decode step of B rows through the L layers in weight plan `plan`
// (x, out [B, D]; pos [B]; cs [B, 2, 128]; caches [L, B, Hkv, T, 128], or
// with seq [L, 1, Hkv, T, 128]): w the seven weights (int4: qp), sz
// int4's seven sz stacks, sc int8's seven scale stacks (null where the
// plan has none). The caller checks shapes, types and contiguity and
// allocates `ws` (the plan's workspace bytes); window 0 means none; fixed
// keeps groups 0..cap-1. Returns the launch's error, or -1 where no plan
// or no tensor map can be made.
int rows_decode_impl(int plan, int dtype, int B, const void* x,
                     const void* thr, const void* pos, const void* cs,
                     const void* na, const void* nm,
                     const void* const (&w)[7], const void* const (&sz)[7],
                     const void* const (&sc)[7], void* kc, void* vc,
                     void* out, void* sel, void* ws, int L, int D, int I,
                     int Hq, int Hkv, int T, int window,
                     const int (&caps)[4], int fixed, int seq, float eps,
                     int n_sms, void* stream) {
  cudaGetLastError();
  int capmax = 0;
  for (int c : caps) capmax = imax(capmax, c);
  bool given = true;
  for (int i = 0; i < 7; ++i)
    given = given && w[i] != nullptr &&
            (plan != PLAN_INT4 || sz[i] != nullptr) &&
            (plan != PLAN_INT8 || sc[i] != nullptr);
  if (!given || !heads_ok(Hq, Hkv) ||
      !rows_form_ok(plan, dtype, Hq / Hkv) || L < 1 || caps[0] < 1 ||
      caps[0] > D / HD || caps[1] < 1 || caps[1] > D / HD || caps[2] < 1 ||
      caps[2] > D / HD || caps[3] < 1 || caps[3] > I / HD)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* nc = rows_cluster_table(plan, dtype, Hq / Hkv);
  if (nc == nullptr) return -1;
  const int esz = dtype == 0 ? 4 : 2;
  const TokPlan p = rows_plan(plan, esz, B, D, I, Hq, Hkv, T, capmax, n_sms,
                              nc);
  EncodeTiled fn = encode_tiled();
  if (p.smem < 0 || fn == nullptr) return -1;
  const int kn[7][2] = {{D, D}, {D, Hkv * HD}, {D, Hkv * HD}, {D, D},
                        {D, I}, {D, I}, {I, D}};
  // boxes of 64 rows x 128 bytes with the 128-byte swizzle (int4: 64 packed
  // rows, and its sz maps); the maps of the last call's weights are kept
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
    for (int i = 0; i < 7; ++i) {
      const long long LK = static_cast<long long>(L) * kn[i][0];
      const bool ok =
          plan == PLAN_STREAM
              ? encode(fn, &maps.m[i], w[i],
                       esz == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       esz, LK, kn[i][1], 128 / esz, RBOX,
                       CU_TENSOR_MAP_SWIZZLE_128B)
              : encode(fn, &maps.m[i], w[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                       plan == PLAN_INT4 ? LK / 2 : LK, kn[i][1], 128, RBOX,
                       CU_TENSOR_MAP_SWIZZLE_128B) &&
                    (plan != PLAN_INT4 ||
                     encode_sz(fn, &maps.m[7 + i], sz[i], LK / HD * 2,
                               kn[i][1]));
      if (!ok) return -1;
    }
    for (int i = 0; i < 7; ++i) {
      key[i] = w[i];
      key[7 + i] = sz[i];
    }
    for (int i = 0; i < 6; ++i) key_shape[i] = shape[i];
  }
  Args a = {};
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
  a.stamps = nullptr;
  a.ws = static_cast<unsigned char*>(ws);
  a.L = L;
  a.D = D;
  a.I = I;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.T = T;
  a.window = window;
  a.fixed = fixed;
  a.empty = 0;
  a.B = B;
  a.seq = seq;
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
  cudaError_t e = cudaMemsetAsync(ws, 0, 256, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  config(cfg, attr, p.C, p.grid, s);
  const void* k = rows_kernel_of(plan, dtype, Hq / Hkv);
  if (k == nullptr) return -1;
  void* params[2] = {&maps, &a};
  e = cudaLaunchKernelExC(&cfg, k, params);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
