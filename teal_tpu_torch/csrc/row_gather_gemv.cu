// K4: unstructured row-gather GEMV (the exact elementwise TEAL rule).
//
// Replaces the Pallas kernel `_kernel` of `row_gather_gemv`
// (teal_tpu/ops/gather_gemv.py:61), whose grid steps one weight row at a
// time. It computes
//   out[n] = sum over slots i < nnz_cap of xc[i] * W[idx[i], n]
// with fp32 sums, cast to W's type: idx and xc are the compacted
// survivors of `|x| > t` (`gather_gemv.compact_indices`), padded and
// overflow slots carrying xc == 0.
//
// What bounds it on the H100: bytes. A slot with xc != 0 needs one weight
// row (8 KB for a 4096-wide bf16 output, 22 KB for 11008), against 2 * N
// flops; a slot with xc == 0 needs nothing. So the kernel has to keep
// enough row bytes in flight on every SM (about 3.35 TB/s x 1 us / 132 =
// 25 KB) with nothing but the rows on the critical path.
//
// Design (the launch plan `plan` below, mirrored by the wrapper's
// `gather_gemv._plan` and exported as `teal_row_gather_plan`):
//   - a block owns a tile of TW output columns, 256 bytes of each row
//     (bf16 128 columns, fp32 64; the last tile masks columns past N), and
//     one of S contiguous ranges of the slots, in order; the S blocks of a
//     tile form a thread-block cluster (S <= 8, the largest power of two
//     keeping the grid within two blocks an SM: 32 tiles x 8 at N = 4096,
//     86 x 2 at 11008);
//   - the block brings its slots' idx and xc into shared memory CH at a
//     time and drops the xc == 0 slots with a block prefix count, which
//     keeps the slot order; indices are clamped to [0, K) there, so a bad
//     index reads a wrong row, never outside W;
//   - the streaming loop has no branch on the data and no dependent
//     global load: thread (row lane rl, chunk q) copies 16 bytes of the
//     survivors rl, rl + 16, ... into its own slots of a ring of NST
//     stages in shared memory with cp.async, NST - 1 ahead (28 KB of rows
//     in flight a block), and does its FMAs on what it copied itself, so
//     the loop needs no block barrier;
//   - partial sums are added in a fixed order: over a thread's survivors
//     in slot order, over the 16 row lanes in order through shared memory,
//     then over the S blocks of the cluster in rank order through
//     distributed shared memory. No atomics; two calls give the same bits.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace teal;

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int PIECE = 256;           // bytes of a row a block reads
constexpr int CPR = PIECE / 16;      // 16-byte chunks of a row piece
constexpr int RL = THREADS / CPR;    // row lanes
constexpr int NST = 8;               // ring stages
constexpr int CH = 2048;             // slots compacted at a time
constexpr int PER = CH / THREADS;    // slots a thread compacts
constexpr int MAXS = 8;              // blocks a cluster
constexpr int SMEM_MAX = 232448;     // a block's shared memory on Hopper

// Shared memory, bytes: the ring [NST][THREADS] x 16 (after the loop the
// row lanes' sums [RL][TW] fp32), the compacted indices and values [CH]
// each, the warps' counts, the block's sums [TW] fp32 (read by the
// cluster's peers).
struct Layout {
  int ring, cidx, cx, wsum, part, total;
  __host__ __device__ explicit Layout(int esz) {
    ring = 0;
    cidx = NST * THREADS * 16;
    cx = cidx + CH * 4;
    wsum = cx + CH * 4;
    part = wsum + 64;
    total = part + PIECE / esz * 4;
  }
};

struct RggPlan { int tw, S, nst, ch, smem; };

// The launch plan from shapes only: TW = 256 bytes of columns, S the
// largest power of two <= MAXS with ceil(N / TW) * S <= 2 * n_sms (at
// least 1), the ring depth, the compaction chunk and the shared bytes.
RggPlan plan(int esz, int N, int n_sms) {
  RggPlan p;
  p.tw = PIECE / esz;
  const int tiles = (N + p.tw - 1) / p.tw;
  p.S = 1;
  while (p.S < MAXS && tiles * p.S * 2 <= 2 * n_sms) p.S *= 2;
  p.nst = NST;
  p.ch = CH;
  p.smem = Layout(esz).total;
  return p;
}

struct Args {
  const int* idx;
  const float* xc;
  const void* w;
  void* out;
  int K, N, nnz, S;
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) rgg_kernel(Args a) {
  constexpr int ESZ = static_cast<int>(sizeof(T));
  constexpr int VEC = 16 / ESZ;      // columns a chunk
  constexpr int TW = PIECE / ESZ;    // columns a tile
  extern __shared__ __align__(128) unsigned char sm[];
  const Layout lay(ESZ);
  uint4* ring = reinterpret_cast<uint4*>(sm + lay.ring);
  int* cidx = reinterpret_cast<int*>(sm + lay.cidx);
  float* cx = reinterpret_cast<float*>(sm + lay.cx);
  int* wsum = reinterpret_cast<int*>(sm + lay.wsum);
  float* part = reinterpret_cast<float*>(sm + lay.part);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = a.S, N = a.N, K = a.K;
  const int split = static_cast<int>(blockIdx.x) % S;
  const int c0 = static_cast<int>(blockIdx.x) / S * TW;
  const int q = tid % CPR, rl = tid / CPR;
  const int col = c0 + q * VEC;
  const bool live = col < N;
  const T* W = static_cast<const T*>(a.w) + col;
  const int s0 = split_lo(a.nnz, S, split);
  const int s1 = split_lo(a.nnz, S, split + 1);

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  for (int base = s0; base < s1; base += CH) {
    // 1. compaction of slots [base, base + CH): thread t takes PER
    // consecutive slots; a block prefix count over the threads in order
    // places the survivors in slot order
    const int n = min(CH, s1 - base);
    int kk[PER];
    float xv[PER];
    int cnt = 0;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int s = tid * PER + e;
      xv[e] = s < n ? __ldg(a.xc + base + s) : 0.f;
      kk[e] = s < n ? min(max(__ldg(a.idx + base + s), 0), K - 1) : 0;
      cnt += xv[e] != 0.f;
    }
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int pos = incl - cnt, total = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      pos += w < warp ? wsum[w] : 0;
      total += wsum[w];
    }
#pragma unroll
    for (int e = 0; e < PER; ++e)
      if (xv[e] != 0.f) {
        cidx[pos] = kk[e];
        cx[pos] = xv[e];
        ++pos;
      }
    __syncthreads();

    // 2. the stream: this thread's survivors rl, rl + RL, ... through its
    // own ring slots, NST - 1 copies ahead
    const int mine = total > rl ? (total - rl + RL - 1) / RL : 0;
    auto copy_row = [&](int i) {
      if (i < mine && live)
        cp_async16(&ring[(i % NST) * THREADS + tid],
                   W + static_cast<size_t>(cidx[rl + i * RL]) * N);
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < NST - 1; ++i) copy_row(i);
    for (int i = 0; i < mine; ++i) {
      cp_async_wait<NST - 2>();      // survivor i has landed
      copy_row(i + NST - 1);            // into the slot survivor i - 1 left
      const uint4 raw = ring[(i % NST) * THREADS + tid];
      const float x = cx[rl + i * RL];
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(x, to_f(v[e]), acc[e]);
    }
    cp_async_wait<0>();
    __syncthreads();                 // cidx, cx and wsum are free again
  }

  // 3. fixed-order sums: the row lanes in order, then the cluster's blocks
  // in rank order, each block finishing TW / S of the tile's columns
  float* red = reinterpret_cast<float*>(sm + lay.ring);   // [RL][TW]
#pragma unroll
  for (int e = 0; e < VEC; ++e) red[rl * TW + q * VEC + e] = acc[e];
  __syncthreads();
  if (tid < TW) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < RL; ++r) s += red[r * TW + tid];
    part[tid] = s;
    if (S == 1 && c0 + tid < N)
      static_cast<T*>(a.out)[c0 + tid] = from_f<T>(s);
  }
  if (S > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                  // every block's sums are in
    const int cw = TW / S;
    if (tid < cw) {
      const int c = split * cw + tid;
      float s = 0.f;
      for (int r = 0; r < S; ++r) s += cluster.map_shared_rank(part, r)[c];
      if (c0 + c < N) static_cast<T*>(a.out)[c0 + c] = from_f<T>(s);
    }
    cluster.sync();                  // no peer reads this block's sums after
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

template <typename T>
int launch(const Args& a0, cudaStream_t stream) {
  const RggPlan p = plan(static_cast<int>(sizeof(T)), a0.N, device_sms());
  if (p.smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Args a = a0;
  a.S = p.S;
  auto fn = rgg_kernel<T>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + p.tw - 1) / p.tw * p.S, 1, 1);
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

}  // namespace

// The launch plan for weights of type dtype (0 fp32, 1 bf16), an output
// width N and an SM count: out = {tile columns, splits S (the cluster),
// ring stages, compaction chunk, shared bytes a block}. K and nnz do not
// change it (the slots are cut into S ranges, then CH at a time).
extern "C" int teal_row_gather_plan(int dtype, int N, int n_sms, int* out) {
  const RggPlan p = plan(dtype == 0 ? 4 : 2, N, n_sms);
  out[0] = p.tw;
  out[1] = p.S;
  out[2] = p.nst;
  out[3] = p.ch;
  out[4] = p.smem;
  return 0;
}

// The slots [out[0], out[1]) that split s of S takes of nnz slots.
extern "C" int teal_row_gather_split(int nnz, int S, int s, int* out) {
  out[0] = split_lo(nnz, S, s);
  out[1] = split_lo(nnz, S, s + 1);
  return 0;
}

// dtype: 0 fp32, 1 bf16 (weights and output). The caller checks shapes:
// N % 32 == 0, w 16-byte aligned, idx and xc of length nnz.
extern "C" int teal_row_gather_gemv(int dtype, const void* idx,
                                    const void* xc, const void* w, void* out,
                                    int K, int N, int nnz, void* stream) {
  cudaGetLastError();  // clear any stale error of this library
  Args a;
  a.idx = static_cast<const int*>(idx);
  a.xc = static_cast<const float*>(xc);
  a.w = w;
  a.out = out;
  a.K = K;
  a.N = N;
  a.nnz = nnz;
  a.S = 1;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(a, s) : launch<__nv_bfloat16>(a, s);
}
