// K6: causal flash-attention forward over a pos-0 prompt (prefill).
//
// Replaces `_flash_prefill_attention` (teal_tpu/models/llama.py:138-149),
// which calls the Pallas TPU library kernel
// `jax.experimental.pallas.ops.tpu.flash_attention` with causal=True,
// sm_scale = 1/sqrt(D) and the KV heads repeated for GQA. What it
// computes, and keeps here:
//   - q [B, Hq, S, D] against the fresh k / v [B, Hkv, S, D] of the same
//     prompt, query row i seeing keys 0..i (plain causal masking: the
//     prompt starts at position 0);
//   - scores scaled by 1/sqrt(D); q head h reads kv head h / (Hq / Hkv),
//     and KV is never repeated in memory;
//   - an fp32 online softmax (running max and sum per query row), fp32
//     accumulators, the output in the q / cache type;
//   - no [S, S] score matrix in device memory (537 MB a layer in fp32 at
//     Llama-2-7B and S = 2048, as the plain `_attention` builds it).
//
// What bounds it on the H100: operations. At S = 2048, Hq = 32, D = 128
// the causal half of QK^T and PV is 2 * S^2 * D * Hq ~= 3.4e10 FLOP a
// layer, ~0.035 ms at the 989 TFLOP/s bf16 tensor-core peak; q, k, v and
// the output move ~67 MB, ~0.020 ms at 3.35 TB/s.
//
// bf16 design (`flash_prefill_wgmma`, one launch a call): a persistent
// grid of one block an SM walks the (q head, batch row, 128-row query
// tile) list, longest rows first, in rounds that reverse every other time
// (a snake, which evens out the causal tiles' work); a block of three
// warpgroups runs the next tile's loads under the last one's epilogue.
//   - Warpgroup 2 is the producer: its registers drop to 24 a thread
//     (setmaxnreg) and one thread issues every copy through the TMA: a
//     tile's Q, then its K and V tiles 0..the diagonal (causal skips the
//     upper half) into a ring of NST stages that runs on across tiles.
//     Every stage has full and empty mbarriers for K and for V, so K tile
//     i + NST loads once QK^T of tile i is done, before PV of it is.
//     Tensor maps are 3-D over [B * H, S, 128] with boxes of 64 columns
//     (128 bytes, the span of the 128-byte swizzle) and 128 rows, two a
//     tile, so rows past S come in as zeros and never from the next head.
//   - Warpgroups 0 and 1 are consumers (240 registers a thread), 64 query
//     rows each. S = Q K^T is `wgmma` m64n128k16 with both operands in
//     shared memory (K-major, as stored); the fp32 scores go through the
//     online softmax in base 2 in registers (only the diagonal tile is
//     masked), are rounded to bf16 -- the plain version rounds the
//     probabilities to the value type -- and are the register A operand
//     of O += P V, `wgmma` m64n128k16 with V from shared memory in its
//     MN-major layout (the transpose bit). O and the softmax state stay in
//     fp32 registers. A consumer issues QK^T of key tile i and PV of tile
//     i - 1 together and runs tile i's softmax while PV runs; the two
//     consumers take turns to issue (named barriers), so one's products
//     run under the other's softmax.
//   - A last half tile (S % 128 == 64) reads zero rows past S, masks
//     those keys by causality and stores no row past S.
// fp32 design (`flash_prefill_fp32`, so an fp32 model on the card also
// runs a kernel): one block of 4 warps per 64-row query tile, K and V
// tiles copied with cp.async; two threads per query row, each scoring
// every key over half of D (the halves added with one shuffle), both
// keeping the row's softmax state and half of its output columns.
// Sums run in a fixed order and nothing is atomic: the result does not
// depend on scheduling.
#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is taken at run
                   // time through cudaGetDriverEntryPoint

#include "common.cuh"

using namespace teal;

namespace {

constexpr int D = 128;  // head dim

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, Hq, Hkv, S;
  int tiles;         // bf16: 128-row query tiles a (head, batch row)
  float scale_log2;  // 1/sqrt(D) * log2(e): softmax in base 2
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// --- bf16: wgmma on a TMA ring, warp-specialised --------------------------

constexpr int TQ = 128;                 // query rows a tile
constexpr int TK = 128;                 // keys a tile
constexpr int NST = 2;                  // ring stages
constexpr int WG = 128;                 // threads a warpgroup
constexpr int WS_THREADS = 3 * WG;      // consumers 0, 1; producer 2
constexpr uint32_t TILE_BYTES = TK * D * 2;     // a Q, K or V tile: 32 KB
constexpr uint32_t HALF_BYTES = TILE_BYTES / 2;  // its 64-column half
constexpr uint32_t ROW_BYTES = 128;     // a half's row: 64 bf16
static_assert(TQ == TK, "the diagonal tile of query tile t is key tile t");

// Shared memory from a 1024-byte aligned base (the 128-byte swizzle's
// period): Q, then NST stages of K and V, then the barriers.
struct Layout {
  static constexpr uint32_t q = 0;
  __host__ __device__ static constexpr uint32_t k(int s) {
    return TILE_BYTES * (1 + 2 * s);
  }
  __host__ __device__ static constexpr uint32_t v(int s) {
    return TILE_BYTES * (2 + 2 * s);
  }
  static constexpr uint32_t bars = TILE_BYTES * (1 + 2 * NST);
  // q_full, q_empty, then k_full, v_full, k_empty and v_empty [NST] each
  static constexpr uint32_t bytes = bars + 8 * (2 + 4 * NST);
  static constexpr uint32_t launch = bytes + 1024;  // alignment slack
};

// A wgmma shared-memory matrix descriptor, 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from touching accumulators across an async wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// d (64 x 128 fp32 across the warpgroup) (+)= A (64 x 16, shared, K-major)
// * B (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128 fp32) += A (64 x 16 bf16, registers: the mma.m16n8k16 A
// fragment of each warp's 16 rows) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q K^T for this warpgroup's 64 rows against a 128-key tile: 8 steps
// of 16 along D; step kk is 32 bytes into the rows of half kk / 4. Both
// tiles K-major, swizzled: 8-row groups 1024 bytes apart.
__device__ __forceinline__ void qk_wgmma(float (&s)[64], uint32_t q_addr,
                                         uint32_t k_addr) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * HALF_BYTES + (kk & 3) * 32;
    wgmma_ss(s, sw128_desc(q_addr + off, 16, 1024),
             sw128_desc(k_addr + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V: 8 steps of 16 keys (2048 bytes of V rows each); V's tile is
// MN-major (D contiguous): its two 64-column halves HALF_BYTES apart,
// 8-key groups 1024 bytes apart.
__device__ __forceinline__ void pv_wgmma(float (&o)[64],
                                         const uint32_t (&p)[TK / 16][4],
                                         uint32_t v_addr) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk)
    wgmma_rs(o, p[kk], sw128_desc(v_addr + kk * 16 * ROW_BYTES, HALF_BYTES,
                                  1024));
  wgmma_commit();
}

// One thread: a box {64 columns, 128 rows, 1} at (c0, row, slab) into
// shared `dst`, completing on mbarrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int row, int slab,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(row),
         "r"(slab), "r"(bar)
      : "memory");
}

// The online softmax of one 128-key tile in base 2, in registers: s holds
// this thread's raw scores of rows r0 and r0 + 8 (the m64n128 accumulator
// layout: s[4j + e] is row r0 + 8 (e / 2), key 8j + 2 tg + e % 2); m, l
// the rows' running max (raw score units) and sum. On return s holds the
// unnormalised weights exp2(s * c - m * c), alpha the factor that carries
// the previous output over. MASK: the diagonal tile (key > query out).
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float c, int r0, int tg) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < TK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK && 8 * j + 2 * tg + (e & 1) > r0 + 8 * (e >> 1))
        s[4 * j + e] = neg_inf();
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  float mc[2], ls[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2f((m[r] - mx[r]) * c);  // 0 on the first tile
    m[r] = mx[r];
    mc[r] = mx[r] * c;
  }
#pragma unroll
  for (int j = 0; j < TK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(s[4 * j + e], c, -mc[e >> 1]));
      s[4 * j + e] = p;
      ls[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
}

// The weights rounded to bf16: the accumulators of key chunks 2kk and
// 2kk + 1 are the A fragment of PV's step kk.
__device__ __forceinline__ void pack_p(uint32_t (&p)[TK / 16][4],
                                       const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// The block's n-th query tile, longest rows first: tile u of the list
// (qt from the last down; heads, then batch rows, within a qt), blocks
// taking the list in rounds of gridDim.x, in reverse order every other
// round (a snake, which evens out the causal tiles' work). False past the
// end.
struct Tile {
  int qt, slab_q, slab_kv;
};
__device__ __forceinline__ bool tile_at(const Args& a, int n, Tile& t) {
  const int G = gridDim.x, HB = a.Hq * a.B;
  const int u = n * G + ((n & 1) ? G - 1 - blockIdx.x : blockIdx.x);
  if (u >= a.tiles * HB) return false;
  const int hb = u % HB, h = hb % a.Hq, b = hb / a.Hq;
  t.qt = a.tiles - 1 - u / HB;
  t.slab_q = b * a.Hq + h;
  t.slab_kv = b * a.Hkv + h / (a.Hq / a.Hkv);
  return true;
}

__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_prefill_wgmma(const __grid_constant__ CUtensorMap qm,
                        const __grid_constant__ CUtensorMap km,
                        const __grid_constant__ CUtensorMap vm, Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + Layout::bars;
  auto q_full = [&]() { return bars; };
  auto q_empty = [&]() { return bars + 8; };
  auto k_full = [&](int s) { return bars + 8 * (2 + s); };
  auto v_full = [&](int s) { return bars + 8 * (2 + NST + s); };
  auto k_empty = [&](int s) { return bars + 8 * (2 + 2 * NST + s); };
  auto v_empty = [&](int s) { return bars + 8 * (2 + 3 * NST + s); };

  if (threadIdx.x == 0) {
    mbar_init(q_full(), 1);
    mbar_init(q_empty(), 8);  // one arrival a consumer warp
    for (int s = 0; s < NST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);
      mbar_init(v_empty(s), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  Tile t;
  if (wg == 2) {
    // producer: one thread issues every copy. The ring runs on across the
    // block's tiles: the kv-th K/V tile goes into stage kv % NST once the
    // consumers' QK^T (for K) or PV (for V) of tile kv - NST is done; a
    // tile's Q once every QK^T of the previous tile is.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 2 * WG) {
      // one tile (two 64-column boxes) of rows `row` into `dst`
      auto tma_tile = [&](uint32_t bar, uint32_t dst, const CUtensorMap* m,
                          int slab, int row) {
        mbar_expect_tx(bar, TILE_BYTES);
        tma_load(dst, m, 0, row, slab, bar);
        tma_load(dst + HALF_BYTES, m, 64, row, slab, bar);
      };
      int kv = 0;
      for (int n = 0; tile_at(a, n, t); ++n) {
        if (n > 0) mbar_wait(q_empty(), (n - 1) & 1);
        tma_tile(q_full(), base + Layout::q, &qm, t.slab_q, t.qt * TQ);
        for (int i = 0; i <= t.qt; ++i, ++kv) {
          const int st = kv % NST;
          const uint32_t ph = ((kv / NST) & 1) ^ 1;  // kv - NST released
          if (kv >= NST) mbar_wait(k_empty(st), ph);
          tma_tile(k_full(st), base + Layout::k(st), &km, t.slab_kv, i * TK);
          if (kv >= NST) mbar_wait(v_empty(st), ph);
          tma_tile(v_full(st), base + Layout::v(st), &vm, t.slab_kv, i * TK);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows 64 * wg .. + 63 of a tile.
    // Step i issues QK^T of key tile i and PV of key tile i - 1 back to
    // back, then runs tile i's softmax while PV runs. The two consumers
    // take turns to issue (named barriers 1 and 2), so one's products
    // run under the other's softmax.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int tg = lane & 3;
    const int r0 = 64 * wg + 16 * warp + (lane >> 2);  // rows r0, r0 + 8
    const uint32_t sq = base + Layout::q + 64 * wg * ROW_BYTES;
    const float c = a.scale_log2;
    const int bar_mine = 1 + wg, bar_other = 2 - wg;
    auto turn = [&]() {
      asm volatile("bar.sync %0, 256;\n" ::"r"(bar_mine) : "memory");
    };
    auto pass = [&]() {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(bar_other) : "memory");
    };
    if (wg == 1) pass();  // consumer 0 issues first

    float oacc[64], sacc[64] = {};
    uint32_t pf[TK / 16][4];
    float mrow[2], lrow[2], alpha[2];
    int kv = 0;
    for (int n = 0; tile_at(a, n, t); ++n) {
      const int nkt = t.qt + 1;  // key tiles 0..the diagonal
#pragma unroll
      for (int j = 0; j < 64; ++j) oacc[j] = 0.f;
      mrow[0] = mrow[1] = neg_inf();
      lrow[0] = lrow[1] = 0.f;

      mbar_wait(q_full(), n & 1);
      const int st0 = kv % NST;
      mbar_wait(k_full(st0), (kv / NST) & 1);
      turn();
      qk_wgmma(sacc, sq, base + Layout::k(st0));
      pass();
      wgmma_wait<0>();
      fence_regs(sacc);
      if (lane == 0) mbar_arrive(k_empty(st0));
      if (t.qt == 0)
        softmax_tile<true>(sacc, mrow, lrow, alpha, c, r0, tg);
      else
        softmax_tile<false>(sacc, mrow, lrow, alpha, c, r0, tg);
      pack_p(pf, sacc);
      for (int i = 1; i < nkt; ++i) {
        const int ks = (kv + i) % NST, vs = (kv + i - 1) % NST;
        const uint32_t sk = base + Layout::k(ks), sv = base + Layout::v(vs);
        mbar_wait(k_full(ks), ((kv + i) / NST) & 1);
        mbar_wait(v_full(vs), ((kv + i - 1) / NST) & 1);
        turn();
        qk_wgmma(sacc, sq, sk);
        pv_wgmma(oacc, pf, sv);
        pass();
        wgmma_wait<1>();  // QK^T done
        fence_regs(sacc);
        if (lane == 0) mbar_arrive(k_empty(ks));
        if (i == t.qt)
          softmax_tile<true>(sacc, mrow, lrow, alpha, c, r0, tg);
        else
          softmax_tile<false>(sacc, mrow, lrow, alpha, c, r0, tg);
        wgmma_wait<0>();  // PV done
        fence_regs(oacc);
        fence_regs(pf);
        if (lane == 0) mbar_arrive(v_empty(vs));
#pragma unroll
        for (int j = 0; j < 64; ++j) oacc[j] *= alpha[(j >> 1) & 1];
        pack_p(pf, sacc);
      }
      if (lane == 0) mbar_arrive(q_empty());  // every QK^T of the tile done
      const int vs = (kv + nkt - 1) % NST;
      mbar_wait(v_full(vs), ((kv + nkt - 1) / NST) & 1);
      turn();
      pv_wgmma(oacc, pf, base + Layout::v(vs));
      Tile next;
      if (wg == 0 || tile_at(a, n + 1, next)) pass();  // none after the last
      wgmma_wait<0>();
      fence_regs(oacc);
      fence_regs(pf);
      if (lane == 0) mbar_arrive(v_empty(vs));
      kv += nkt;

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
        lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
        inv[r] = 1.f / lrow[r];
      }
      auto* op = static_cast<__nv_bfloat16*>(a.out) +
                 (static_cast<size_t>(t.slab_q) * a.S + t.qt * TQ) * D;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (t.qt * TQ + row >= a.S) continue;  // a last half tile
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(op + row * D + 8 * j + 2 * tg) =
              pack_bf16(oacc[4 * j + 2 * r] * inv[r],
                        oacc[4 * j + 2 * r + 1] * inv[r]);
      }
    }
  }
}

// --- fp32: plain FMAs -------------------------------------------------------

constexpr int BQ = 64;        // query rows a block
constexpr int BK = 64;        // key rows a tile (== BQ: the diagonal tile
                              // of query tile t is key tile t)
constexpr int THREADS = 128;  // 4 warps

// Shared-memory row stride in elements: D plus 16 bytes.
template <typename T>
struct Ld {
  static constexpr int value = D + 16 / static_cast<int>(sizeof(T));
};

// Copy 64 rows of D elements (consecutive in global memory) into shared
// memory at row stride Ld<T>.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src) {
  constexpr int EPC = 16 / sizeof(T);  // elements a 16-byte chunk
  constexpr int CPR = D / EPC;         // chunks a row
#pragma unroll
  for (int c = threadIdx.x; c < BK * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * EPC;
    cp_async16(dst + r * Ld<T>::value + col,
               src + static_cast<size_t>(r) * D + col);
  }
}

__device__ void fma_body(const Args& a, const float* qp, const float* kp,
                         const float* vp, float* op, int qt,
                         unsigned char* smem) {
  constexpr int LD = Ld<float>::value;
  constexpr int HALF = D / 2;
  auto* sq = reinterpret_cast<float*>(smem);
  float* sk = sq + BQ * LD;
  float* sv = sk + BK * LD;
  const int r = threadIdx.x >> 1;          // query row in the tile
  const int c0 = (threadIdx.x & 1) * HALF;  // this thread's half of D

  load_tile(sq, qp);
  load_tile(sk, kp);
  cp_async_commit();
  load_tile(sv, vp);
  cp_async_commit();

  float o[HALF];
#pragma unroll
  for (int d = 0; d < HALF; ++d) o[d] = 0.f;
  float m = neg_inf(), l = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    cp_async_wait<1>();
    __syncthreads();
    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) s[j] = 0.f;
#pragma unroll
    for (int d = 0; d < HALF; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(sq + r * LD + c0 + d);
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(sk + j * LD + c0 + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }
    const bool diag = kt == qt;
    float mx = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      // the two halves' partial dots, added in the same order by both
      // threads of the row
      float x = (s[j] + __shfl_xor_sync(0xffffffffu, s[j], 1)) * a.scale_log2;
      if (diag && j > r) x = neg_inf();
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float alpha = exp2f(m - mx);
    m = mx;
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = exp2f(s[j] - m);
      ls += s[j];
    }
    l = l * alpha + ls;
#pragma unroll
    for (int d = 0; d < HALF; ++d) o[d] *= alpha;

    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BK; ++j)
#pragma unroll
      for (int d = 0; d < HALF; d += 4) {
        const float4 vv =
            *reinterpret_cast<const float4*>(sv + j * LD + c0 + d);
        o[d] = fmaf(s[j], vv.x, o[d]);
        o[d + 1] = fmaf(s[j], vv.y, o[d + 1]);
        o[d + 2] = fmaf(s[j], vv.z, o[d + 2]);
        o[d + 3] = fmaf(s[j], vv.w, o[d + 3]);
      }
    __syncthreads();
    if (kt < qt) {
      load_tile(sk, kp + static_cast<size_t>(kt + 1) * BK * D);
      cp_async_commit();
      load_tile(sv, vp + static_cast<size_t>(kt + 1) * BK * D);
      cp_async_commit();
    }
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < HALF; d += 4)
    *reinterpret_cast<float4*>(op + r * D + c0 + d) =
        make_float4(o[d] * inv, o[d + 1] * inv, o[d + 2] * inv,
                    o[d + 3] * inv);
}

__global__ void __launch_bounds__(THREADS) flash_prefill_fp32(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // longest rows first
  const int hk = h / (a.Hq / a.Hkv);
  const size_t qoff = ((static_cast<size_t>(b) * a.Hq + h) * a.S +
                       static_cast<size_t>(qt) * BQ) * D;
  const size_t kvoff = (static_cast<size_t>(b) * a.Hkv + hk) * a.S * D;
  fma_body(a, static_cast<const float*>(a.q) + qoff,
           static_cast<const float*>(a.k) + kvoff,
           static_cast<const float*>(a.v) + kvoff,
           static_cast<float*>(a.out) + qoff, qt, smem);
}

constexpr int FP32_SMEM = 3 * BQ * Ld<float>::value * sizeof(float);

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

// A tensor map over bf16 [slabs, S, 128]: boxes of 64 columns and `rows`
// rows of one slab, 128-byte swizzle, zeros past S.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* p, int slabs,
            int S, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(slabs)};
  const cuuint64_t strides[2] = {D * 2ull, static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launch of each type: blocks, threads a block, dynamic shared
// bytes. fp32: one block a (head, batch row, 64-row query tile), grid
// (Hq, B, S / 64). bf16: a persistent grid of min(tiles, SMs) blocks over
// the (head, batch row, 128-row query tile) list.
struct Launch {
  int tiles, blocks, threads, smem;
};
Launch plan(int dtype, int B, int Hq, int S, int sms) {
  if (dtype == 0) return {S / BQ, B * Hq * (S / BQ), THREADS, FP32_SMEM};
  const int tiles = (S + TQ - 1) / TQ;
  const int total = B * Hq * tiles;
  return {tiles, total < sms ? total : sms, WS_THREADS,
          static_cast<int>(Layout::launch)};
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

int launch_fp32(const Args& a, cudaStream_t stream) {
  const Launch p = plan(0, a.B, a.Hq, a.S, 0);
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_fp32, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_prefill_fp32<<<dim3(a.Hq, a.B, p.tiles), p.threads, p.smem,
                       stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgmma(Args a, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const Launch p = plan(1, a.B, a.Hq, a.S, sms);
  a.tiles = p.tiles;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qm, km, vm;
  if (!encode(fn, &qm, a.q, a.B * a.Hq, a.S, TQ) ||
      !encode(fn, &km, a.k, a.B * a.Hkv, a.S, TK) ||
      !encode(fn, &vm, a.v, a.B * a.Hkv, a.S, TK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_prefill_wgmma<<<p.blocks, p.threads, p.smem, stream>>>(qm, km, vm,
                                                              a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (q, k, v and the output share it). q / out:
// [B, Hq, S, 128], k / v: [B, Hkv, S, 128], all contiguous and 16-byte
// aligned. The caller checks shapes: head dim 128, Hq % Hkv == 0,
// S % 64 == 0. scale: the score scale (1/sqrt(128)).
extern "C" int teal_flash_prefill(int dtype, const void* q, const void* k,
                                  const void* v, void* out, int B, int Hq,
                                  int Hkv, int S, float scale, void* stream) {
  cudaGetLastError();  // clear any stale error of this library
  if (S % BQ != 0 || S <= 0 || B <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.S = S;
  a.tiles = 0;
  a.scale_log2 = scale * 1.4426950408889634f;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_fp32(a, s) : launch_wgmma(a, s);
}

// The launch plan of `teal_flash_prefill` for (dtype, B, Hq, S) on a card
// of `sms` SMs: out[0..3] the query tiles a (head, batch row), blocks,
// threads a block, dynamic shared bytes. Returns 0.
extern "C" int teal_flash_prefill_plan(int dtype, int B, int Hq, int S,
                                       int sms, int* out) {
  const Launch p = plan(dtype, B, Hq, S, sms);
  out[0] = p.tiles;
  out[1] = p.blocks;
  out[2] = p.threads;
  out[3] = p.smem;
  return 0;
}
