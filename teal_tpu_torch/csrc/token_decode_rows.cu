// K7's rows form: one decode step of B = 2..16 sequences through the whole
// layer stack in ONE persistent launch, weights, stream and cache arrays of
// one type (fp32 or bf16). The counterpart of `_token_kernel` with
// `batch` = B (teal_tpu/ops/token_block.py:186-340, 371-386): every row is
// a sequence at its own position pos[b], with its own RoPE row and cache
// row b of [L, B, Hkv, T, 128]; the rows share one kept set per stage,
// picked by the group score pooled over the rows (the max over rows of
// each row's max |x| in the group, `select_groups_batched`,
// block_gemv.py:874) under the unified rule, and each kept slab is read
// once for all rows.
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
//   - a gather slot holds two TMA boxes of 64 rows x 128 bytes with the
//     128-byte swizzle (a group's 128 rows of a 128-byte unit of columns,
//     or for gate|up the same 64 rows of both weights) and, copied beside
//     them by the producer with 1-D bulk copies, the rows' input at those
//     rows, [B][128 or 64] of T (rows padded by 16 bytes);
//   - bf16: mma.sync m16n8k16 with the rows as M (rows >= B zeroed in
//     registers), each warp 16 of the slot's rows as K (gate|up: warps 0-3
//     gate, 4-7 up) and all 8 n-tiles of the unit's 64 columns; the folded
//     norm (row scale and gain, with the reference's two roundings) goes
//     on the A fragments in registers. fp32: FMAs, a lane 4 rows x 4
//     columns. The warps' sums of a unit are added in warp order;
//   - q|k|v sums go to the workspace for every plan (the head-owned plan
//     orders them for its cluster with a cluster barrier, not a grid one);
//   - attention: a warp a (row, kv head): LPR lanes a cache row, chunks of
//     RPW * UA rows, the two passes of `attention` (the same rounding
//     points: one max, weights rounded to T), the scores kept in the
//     warp's slice of the unit sums' shared memory where they fit;
//   - the epilogues write each (row, column) once: q|k|v sums (fp32),
//     T(sums + h) into the other stream buffer, T(silu(gate) * up).
// A stage that keeps no group skips as K7 does (o and down leave the
// stream as it is; gate|up makes the intermediate 0, so down selects on
// zero scores and skips its gather). Every sum has a fixed order; no data
// atomics. The plan comes from shapes and the card's resident clusters
// (`rows_plan`, exported as `teal_token_plan_rows` and mirrored by the
// wrapper's `_token_plan(..., rows=B)`).
#include "token_decode.cuh"

namespace {

// this library builds the rows kernels alone (the batch-1 plans are
// `token_decode.cu`'s and `token_decode_quant.cu`'s)
const void* kernel_of(int, int, int) { return nullptr; }

constexpr int MAXB = 16;               // rows: the MMA's M
constexpr int RBOX = 64;               // rows of a box (128 bytes each)
constexpr int UA_MAX = 8;              // cache rows in flight a lane

// columns of a unit (a box row of 128 bytes): 64 bf16, 32 fp32
__host__ __device__ constexpr int rows_unit(int esz) { return 128 / esz; }
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

// Shared memory, bytes: the ring's boxes [nslot][2][8 KB] (1024-byte
// aligned, the swizzle's period), the staged input rows [nslot][16][XS],
// full and empty mbarriers, the block's partial sums `part` [NW][B][cluster
// columns] fp32 (read by the peers), the warps' sums of a unit [8][16][unit]
// fp32, the peers' sums of squares [MAXC][16], the row scales [16], the
// group scores, the kept groups and count, MISC floats of scratch.
struct RowsLayout {
  int xring, bars, part, red, ssq, rs, scores, idx, misc, total;
  __host__ __device__ RowsLayout(int esz, int D, int I, int capmax, int partf,
                                 int nslot) {
    xring = nslot * 2 * BOXB;
    bars = xring + nslot * rows_xslot(esz);
    part = bars + 2 * MAXSLOT * 8;
    red = part + partf * 4;
    ssq = red + NWORK * MAXB * rows_unit(esz) * 4;
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
// is left, up to MAXSLOT slots of two boxes and their staged rows, at
// least two. NS = the rows of a warp's attention chunk.
TokPlan rows_plan(int esz, int B, int D, int I, int Hq, int Hkv, int T,
                  int capmax, int n_sms, const int* nc) {
  TokPlan p = {0, 0, 0, 0, 0, 0, 0, -1, 0};
  if ((esz != 2 && esz != 4) || B < 2 || B > MAXB || D <= 0 || I <= 0 ||
      D % HD || I % HD || Hkv <= 0 || Hq != D / HD || Hq % Hkv ||
      MAXGH % (Hq / Hkv) || T < 1 || capmax < 1 ||
      capmax > imax(D, I) / HD)
    return p;
  const int GH = Hq / Hkv;
  const Structure sc = token_structure(Hkv, n_sms, nc);
  if (sc.C == 0) return p;
  const int C = sc.C, NC = sc.NC, head = sc.head;
  const int uw = rows_unit(esz);
  auto most = [&](int cols, int nw) { return nw * cdiv(cols / uw, NC) * uw; };
  const int partf = B * imax(imax(most(D, 1), most(I, 2)),
                             head ? (GH + 2) * HD
                                  : most((Hq + 2 * Hkv) * HD, 1));
  const int rest = RowsLayout(esz, D, I, capmax, partf, 0).total;
  const int nslot =
      imin(MAXSLOT, (SMEM_MAX - rest) / (2 * BOXB + rows_xslot(esz)));
  if (nslot < 2) return p;
  p = {C, NC, head, NC * C, nslot, rows_chunk(esz, GH), partf,
       RowsLayout(esz, D, I, capmax, partf, nslot).total,
       RowsWs(esz, B, D, I, Hq, Hkv).total};
  return p;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(addr), "f"(v)
               : "memory");
}

// generic-proxy writes of global memory before later async-proxy (TMA /
// bulk copy) reads of it, and the other way round
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// One thread: `bytes` (a multiple of 16) from global `src` into shared
// `dst` (both 16-byte aligned), completing on mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Four consecutive elements of T from global memory through L2, as fp32.
template <typename T>
__device__ __forceinline__ void ld4(const T* p, float (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 r = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  } else {
    const uint2 r = __ldcg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(r.x << 16);
    v[1] = __uint_as_float(r.x & 0xffff0000u);
    v[2] = __uint_as_float(r.y << 16);
    v[3] = __uint_as_float(r.y & 0xffff0000u);
  }
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

// This block's share of a gather stage for B rows: for each unit of the
// cluster's columns, the sums over this block's slots of x[b][row] *
// W[layer, row, columns], into part [NW][B][cluster columns]. A slot is one
// kept group (NW = 1: its 128 rows, two boxes) or half of one (NW = 2: its
// 64 rows of gate and of up); the slots of a unit are cut over the C
// blocks in rank order. The producer warp's lane 0 waits for a free slot
// and arms it, lanes 0 and 1 issue the boxes, lanes 2..B+1 copy row b's
// input at the slot's rows. `gain` (or null) and `rs` fold the input (the
// rms_norm) in registers. Returns the ring position past the stage.
template <typename T, int NW>
__device__ __forceinline__ Ring gather_rows(
    const Args& a, const Maps& maps, const Stage& st, int layer, const T* x,
    int K, const T* gain, const float* rs, const int* idx, int count,
    int rank, int C, int nslot, unsigned char* sm, int xring, uint32_t bars,
    float* part, float* red, Ring q) {
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int UW = rows_unit(ESZ);        // columns of a unit
  constexpr int XS = rows_xs(ESZ);
  constexpr int XSLOT = rows_xslot(ESZ);
  constexpr int KR = NW == 1 ? HD : HD / 2;  // kept rows a slot
  constexpr int HALF = KR / 2;              // the second k-half's rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = a.B, ncol = st.nu * UW;
  const int nsl = NW == 1 ? count : 2 * count;
  const int r0 = split_lo(nsl, C, rank), r1 = split_lo(nsl, C, rank + 1);
  if (warp == NWORK) {                   // the producer
    fence_proxy_global();                // the input rows: other blocks'
    const uint64_t policy = evict_first();
    for (int t = 0; t < st.nu; ++t) {
      int m0 = st.map[0], m1 = st.map[1], col = (st.u0 + t) * UW;
      if (NW == 1) {
        unit_src<UW>(st, st.u0 + t, m0, col);
        m1 = m0;
      }
      for (int r = r0; r < r1; ++r) {
        const int g = idx[NW == 1 ? r : r >> 1];
        const int half = NW == 1 ? 0 : (r & 1);
        const uint32_t full = bars + q.s * 8;
        if (lane == 0) {
          mbar_wait_bounded(bars + (MAXSLOT + q.s) * 8, q.ph ^ 1u);
          mbar_expect_tx(full, 2 * BOXB + B * KR * ESZ);
        }
        __syncwarp();
        const int row = layer * K + g * HD + half * KR;
        const uint32_t box = smem_u32(sm) + q.s * 2 * BOXB;
        if (lane == 0)
          tma_load(box, &maps.m[m0], col, row, full, policy);
        else if (lane == 1)
          tma_load(box + BOXB, &maps.m[m1], col, row + (NW == 1 ? RBOX : 0),
                   full, policy);
        else if (lane < 2 + B)
          bulk_load(smem_u32(sm + xring) + q.s * XSLOT + (lane - 2) * XS,
                    x + static_cast<size_t>(lane - 2) * K + g * HD +
                        half * KR,
                    KR * ESZ, full);
        q.next(nslot);
      }
    }
    return q;
  }
  // NW == 2: warps 0-3 take gate's box, 4-7 up's; wi = the warp's slice
  const int wi = NW == 1 ? warp : (warp & 3);
  const int wb = NW == 1 ? 0 : (warp >> 2);
  for (int t = 0; t < st.nu; ++t) {
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
    for (int r = r0; r < r1; ++r) {
      mbar_wait_bounded(bars + q.s * 8, q.ph);
      const unsigned char* slot = sm + q.s * 2 * BOXB;
      const unsigned char* xt = sm + xring + q.s * XSLOT;
      const int g = idx[NW == 1 ? r : r >> 1];
      const int half = NW == 1 ? 0 : (r & 1);
      const T* gp = gain == nullptr ? nullptr : gain + g * HD + half * KR;
      if constexpr (ESZ == 2) {
        // k-index i < 8: the slot's row 8 wi + i; i >= 8: row HALF + 8 wi
        // + i - 8 (NW = 1: box 1's row 8 wi + i - 8)
        const int k0 = 8 * wi, k1 = HALF + 8 * wi;
        uint32_t af[4];
        {
          const int mi = lane >> 3;
          ldsm_x4(af, xt + ((lane & 7) + (mi & 1) * 8) * XS +
                          ((mi >> 1) ? k1 : k0) * 2);
        }
        const int qd = lane & 3, rw = lane >> 2;
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
        const unsigned char* bx0 = slot + wb * BOXB;
        const unsigned char* bx1 = slot + (NW == 1 ? BOXB : wb * BOXB);
        const int ra = 8 * wi + 2 * qd;
        const int rb = (NW == 1 ? 0 : HALF) + 8 * wi + 2 * qd;
        const int n = lane >> 2;
        const uint4 v0 = ld_sw(bx0, ra, n), v1 = ld_sw(bx0, ra + 1, n);
        const uint4 v2 = ld_sw(bx1, rb, n), v3 = ld_sw(bx1, rb + 1, n);
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
      } else {
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
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + (MAXSLOT + q.s) * 8);
      q.next(nslot);
    }
    // unit t's sums: the warps' sums in warp order (NW = 2: warps 0-3 for
    // gate, 4-7 for up)
    if constexpr (ESZ == 2) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int b = (lane >> 2) + 8 * (i >> 1);
          const int c = (2 * (lane & 3) + (i & 1)) * 8 + nt;
          red[(warp * MAXB + b) * UW + c] = acc[nt][i];
        }
    } else {
      const int bq = lane >> 3, c = lane & 7;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[(warp * MAXB + 4 * bq + j) * UW + 4 * c + e] = acc[j][e];
    }
    workers_sync();
    for (int j = tid; j < NW * B * UW; j += WORKERS) {
      const int w = j / (B * UW), b = (j / UW) % B, c = j % UW;
      float sum = 0.f;
      constexpr int PER = NWORK / NW;
#pragma unroll
      for (int k = 0; k < PER; ++k)
        sum += red[((w * PER + k) * MAXB + b) * UW + c];
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
// (or null), EPI_SILU T(silu(gate) * up) into `dst` [B][I].
template <typename T>
__device__ __forceinline__ void epilogue_rows(int kind, const Stage& st,
                                           const float* part, int rank,
                                           int C, int B, const T* hin,
                                           void* dst, void* dst2, int D,
                                           int I, int kvw) {
  constexpr int UW = rows_unit(static_cast<int>(sizeof(T)));
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
    if (kind == EPI_QKV) {
      int p = 0, off = c;                  // the column's weight and column
      while (p < 2 && off >= st.n[p]) off -= st.n[p++];
      const int m = st.map[p];
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

// Row b's attention for kv head hk, by one warp: RoPE on the row's q|k|v
// sums (the workspace), the current K/V written at pos[b] of cache row b,
// then two passes over the live rows [lo, pos) in chunks of RPW * UA rows
// (LPR lanes a row, UA rows in flight a lane), as K7's one-row
// `attention`: the scores of q rounded to T and ONE max M over them and
// the current token, then each row's weight exp(s - M) rounded to T for
// PV and the sum of the unrounded ones; the output in T into the
// attention rows. The scores are kept in the warp's `sbuf` (nsb floats)
// where they fit, else scored again in the second pass.
template <typename T, int QG>
__device__ __forceinline__ void attention_rows(const Args& a,
                                            const RowsWs& wl, int l, int b,
                                            int hk, float* sbuf, int nsb) {
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int VE = 16 / ESZ;              // a lane's dimensions
  constexpr int LPR = HD / VE;              // lanes a cache row: 16 / 32
  constexpr int RPW = 32 / LPR;             // rows a pass: 2 / 1
  constexpr int GH = QG;
  constexpr int UA = rows_ua(GH);
  constexpr int CH = RPW * UA;
  const int lane = threadIdx.x & 31, li = lane % LPR, rr = lane / LPR;
  const int pos = a.pos[b];
  if (pos < 0 || pos >= a.T) __trap();
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
  const size_t slab =
      ((static_cast<size_t>(l) * a.B + b) * Hkv + hk) * a.T * HD;
  T* kcache = static_cast<T*>(a.kc) + slab;
  T* vcache = static_cast<T*>(a.vc) + slab;
  if (rr == 0) {                 // row pos: read by no warp of this layer
    T kt[VE], vt[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      kt[e] = from_f<T>(kn[e]);
      vt[e] = from_f<T>(vn[e]);
    }
    *reinterpret_cast<uint4*>(kcache + static_cast<size_t>(pos) * HD + d0) =
        *reinterpret_cast<const uint4*>(kt);
    *reinterpret_cast<uint4*>(vcache + static_cast<size_t>(pos) * HD + d0) =
        *reinterpret_cast<const uint4*>(vt);
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
// a kv head (1, 2, 4 or 8).
template <typename T, int QG>
__global__ void __launch_bounds__(THREADS, 1)
    token_rows_kernel(const __grid_constant__ Maps maps,
                      const __grid_constant__ Args a) {
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int UW = rows_unit(ESZ);
  extern __shared__ __align__(1024) unsigned char sm[];
  const int tid = threadIdx.x, b = blockIdx.x, warp = tid >> 5;
  const int rank = cluster_rank(), cid = cluster_index();
  const int D = a.D, I = a.I, C = a.C, B = a.B, GH = QG;
  const RowsLayout lay(ESZ, D, I, a.capmax, a.partf, a.nslot);
  const RowsWs wl(ESZ, B, D, I, a.Hq, a.Hkv);
  unsigned* bar = reinterpret_cast<unsigned*>(a.ws + wl.bar);
  const uint32_t bars = smem_u32(sm + lay.bars);
  if (tid == 0) {
    for (int s = 0; s < a.nslot; ++s) {
      mbar_init(bars + s * 8, 1);
      mbar_init(bars + (MAXSLOT + s) * 8, NWORK);
    }
    mbar_init_fence();
  }
  cluster_sync();
  unsigned nbar = 0;
  auto grid_barrier = [&]() {
    fence_proxy_global();        // this block's writes, read by TMA next
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
      ring = gather_rows<T, 2>(a, maps, st, l, x, K, gain, rs, idx, count,
                               rank, C, a.nslot, sm, lay.xring, bars, part,
                               red, ring);
    else
      ring = gather_rows<T, 1>(a, maps, st, l, x, K, gain, rs, idx, count,
                               rank, C, a.nslot, sm, lay.xring, bars, part,
                               red, ring);
    __syncthreads();
    cluster_sync();
    epilogue_rows<T>(kind, st, part, rank, C, B, hin, dst, dst2, D, I, kvw);
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
    // `red` (free between the gathers)
    float* sbuf = red + warp * MAXB * UW;
    if (a.head) {
      cluster_sync();                      // the cluster's q|k|v rows
      if (warp < NWORK)
        for (int r = rank * NWORK + warp; r < B; r += C * NWORK)
          attention_rows<T, QG>(a, wl, l, r, cid, sbuf, MAXB * UW);
    } else {
      grid_barrier();
      if (warp < NWORK)
        for (int u = b * NWORK + warp; u < B * Hkv; u += a.grid * NWORK)
          attention_rows<T, QG>(a, wl, l, u / Hkv, u % Hkv, sbuf,
                                MAXB * UW);
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

// The rows kernel of (dtype, GH), its attribute set once.
template <typename T, int QG>
const void* rows_fn() {
  static bool set = false;
  auto fn = token_rows_kernel<T, QG>;
  if (!set) {
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX) != cudaSuccess)
      return nullptr;
    set = true;
  }
  return reinterpret_cast<const void*>(fn);
}

const void* rows_kernel_of(int dtype, int GH) {
  switch ((dtype == 0 ? 0 : 4) + __builtin_ctz(GH)) {
    case 0: return rows_fn<float, 1>();
    case 1: return rows_fn<float, 2>();
    case 2: return rows_fn<float, 4>();
    case 3: return rows_fn<float, 8>();
    case 4: return rows_fn<__nv_bfloat16, 1>();
    case 5: return rows_fn<__nv_bfloat16, 2>();
    case 6: return rows_fn<__nv_bfloat16, 4>();
    default: return rows_fn<__nv_bfloat16, 8>();
  }
}

// The card's resident clusters of each size C of the rows kernel of
// (dtype, GH) at one block an SM (asked once a device).
const int* rows_cluster_table(int dtype, int GH) {
  static int table[64][8][MAXC + 1];
  static bool done[64][8];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return nullptr;
  const int k = (dtype == 0 ? 0 : 4) + __builtin_ctz(GH);
  int* nc = table[dev][k];
  if (!done[dev][k]) {
    const void* fn = rows_kernel_of(dtype, GH);
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

bool rows_form_ok(int dtype, int GH) {
  return (dtype == 0 || dtype == 1) && GH >= 1 && MAXGH % GH == 0;
}

}  // namespace

// The resident clusters of C blocks of the rows kernel of (dtype 0 fp32 /
// 1 bf16, GH query heads a kv head) on the current device. -1 where the
// kernel's attributes cannot be set.
extern "C" int teal_token_clusters_rows(int dtype, int GH, int C) {
  if (!rows_form_ok(dtype, GH) || C < 0 || C > MAXC) return -1;
  const int* nc = rows_cluster_table(dtype, GH);
  return nc == nullptr ? -1 : nc[C];
}

// The rows form's plan for dtype at B rows and these shapes on n_sms SMs
// and the current device's resident clusters, into out int32 [11] (as
// `teal_token_plan`; NS: the rows of a warp's attention chunk). Returns 0,
// or -1 where the shapes take no plan.
extern "C" int teal_token_plan_rows(int dtype, int B, int D, int I, int Hq,
                                    int Hkv, int T, int window, int capmax,
                                    int n_sms, int L, int* out) {
  (void)window;
  if (!heads_ok(Hq, Hkv) || !rows_form_ok(dtype, Hq / Hkv) || L < 1)
    return -1;
  const int* nc = rows_cluster_table(dtype, Hq / Hkv);
  if (nc == nullptr) return -1;
  const TokPlan p = rows_plan(dtype == 0 ? 4 : 2, B, D, I, Hq, Hkv, T,
                              capmax, n_sms, nc);
  if (p.smem < 0) return -1;
  const int v[11] = {p.grid, THREADS, p.smem, static_cast<int>(p.ws),
                     (p.head ? NBAR - 1 : NBAR) * L, 0, p.C, p.NC, p.head,
                     p.nslot, p.NS};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

// One decode step of B rows through the L layers (x, out [B, D]; pos [B];
// cs [B, 2, 128]; caches [L, B, Hkv, T, 128]). The caller checks shapes,
// types and contiguity and allocates `ws` (the plan's workspace bytes);
// window 0 means none; fixed keeps groups 0..cap-1. Returns the launch's
// error, or -1 where no plan or no tensor map can be made.
extern "C" int teal_token_decode_rows(
    int dtype, int B, const void* x, const void* thr, const void* pos,
    const void* cs, const void* na, const void* nm, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* wg,
    const void* wu, const void* wd, void* kc, void* vc, void* out, void* sel,
    void* ws, int L, int D, int I, int Hq, int Hkv, int T, int window,
    int cap0, int cap1, int cap2, int cap3, int fixed, float eps, int n_sms,
    void* stream) {
  cudaGetLastError();
  const void* const w[7] = {wq, wk, wv, wo, wg, wu, wd};
  const int caps[4] = {cap0, cap1, cap2, cap3};
  int capmax = 0;
  for (int c : caps) capmax = imax(capmax, c);
  bool given = true;
  for (int i = 0; i < 7; ++i) given = given && w[i] != nullptr;
  if (!given || !heads_ok(Hq, Hkv) || !rows_form_ok(dtype, Hq / Hkv) ||
      L < 1 || caps[0] < 1 || caps[0] > D / HD || caps[1] < 1 ||
      caps[1] > D / HD || caps[2] < 1 || caps[2] > D / HD || caps[3] < 1 ||
      caps[3] > I / HD)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* nc = rows_cluster_table(dtype, Hq / Hkv);
  if (nc == nullptr) return -1;
  const int esz = dtype == 0 ? 4 : 2;
  const TokPlan p = rows_plan(esz, B, D, I, Hq, Hkv, T, capmax, n_sms, nc);
  EncodeTiled fn = encode_tiled();
  if (p.smem < 0 || fn == nullptr) return -1;
  const int kn[7][2] = {{D, D}, {D, Hkv * HD}, {D, Hkv * HD}, {D, D},
                        {D, I}, {D, I}, {I, D}};
  // boxes of 64 rows x 128 bytes with the 128-byte swizzle; the maps of
  // the last call's weights are kept
  static Maps maps;
  static const void* key[7] = {};
  static int key_shape[5] = {-1};
  const int shape[5] = {esz, L, D, I, Hkv};
  bool same = true;
  for (int i = 0; i < 7; ++i) same = same && key[i] == w[i];
  for (int i = 0; i < 5; ++i) same = same && key_shape[i] == shape[i];
  if (!same) {
    key_shape[0] = -1;
    for (int i = 0; i < 7; ++i)
      if (!encode(fn, &maps.m[i], w[i],
                  esz == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  esz, static_cast<long long>(L) * kn[i][0], kn[i][1],
                  128 / esz, RBOX, CU_TENSOR_MAP_SWIZZLE_128B))
        return -1;
    for (int i = 0; i < 7; ++i) key[i] = w[i];
    for (int i = 0; i < 5; ++i) key_shape[i] = shape[i];
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
  cudaError_t e = cudaMemsetAsync(ws, 0, 256, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  config(cfg, attr, p.C, p.grid, s);
  const void* k = rows_kernel_of(dtype, Hq / Hkv);
  if (k == nullptr) return -1;
  void* params[2] = {&maps, &a};
  e = cudaLaunchKernelExC(&cfg, k, params);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
