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
// Design (simple and right first; wgmma, TMA and warp specialisation
// are later work). One block of 4 warps per (q head, batch row, 64-row
// query tile); the tile index runs slowest and the longest rows start
// first, so the short diagonal tiles fill the tail. The block loads its
// Q tile and then walks the key tiles 0..its own diagonal (causal skips
// the upper half), each K and V tile copied to shared memory with
// cp.async (V arrives while QK^T runs), rows padded by 16 bytes so that
// ldmatrix and float4 reads of eight rows hit distinct banks.
//   - bf16: each warp owns 16 query rows. QK^T and PV run on
//     mma.sync.m16n8k16 (fp32 accumulators) with operands from shared
//     memory through ldmatrix (V transposed on load); Q stays in
//     registers; P is rounded to bf16 before PV, as the plain version
//     rounds the probabilities to the value type.
//   - fp32: plain FMAs in the same loop: two threads per query row, each
//     scoring every key over half of D (the halves are added with one
//     shuffle), both keeping the row's softmax state and half of its
//     output columns. So an fp32 model on the card also runs a kernel.
// Sums run in a fixed order and nothing is atomic: the result does not
// depend on scheduling.
#include <type_traits>

#include "common.cuh"

using namespace teal;

namespace {

constexpr int D = 128;        // head dim
constexpr int BQ = 64;        // query rows a block
constexpr int BK = 64;        // key rows a tile (== BQ: the diagonal tile
                              // of query tile t is key tile t)
constexpr int THREADS = 128;  // 4 warps

// Shared-memory row stride in elements: D plus 16 bytes.
template <typename T>
struct Ld {
  static constexpr int value = D + 16 / static_cast<int>(sizeof(T));
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int Hq, Hkv, S;
  float scale_log2;  // 1/sqrt(D) * log2(e): softmax in base 2
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

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

// --- bf16: mma.sync.m16n8k16 ------------------------------------------------

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * g + tg. An
// accumulator c[4] holds rows g (c0, c1) and g + 8 (c2, c3) at columns
// 2 * tg + {0, 1}; an A operand a[4] holds rows g / g + 8 at columns
// 2 * tg + {0, 1} (a0 / a1) and 8 + 2 * tg + {0, 1} (a2 / a3), so the
// accumulators of two adjacent 8-key score tiles are the A operand of
// one 16-key step of PV.
__device__ void mma_body(const Args& a, const __nv_bfloat16* qp,
                         const __nv_bfloat16* kp, const __nv_bfloat16* vp,
                         __nv_bfloat16* op, int qt, unsigned char* smem) {
  constexpr int LD = Ld<__nv_bfloat16>::value;
  auto* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = sq + BQ * LD;
  __nv_bfloat16* sv = sk + BK * LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int row0 = warp * 16;  // this warp's first query row in the tile

  load_tile(sq, qp);
  load_tile(sk, kp);
  cp_async_commit();
  load_tile(sv, vp);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt <= qt; ++kt) {
    cp_async_wait<1>();  // Q and this K tile have landed; V may not have
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], sq + (row0 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
    }

    // scores of this warp's 16 rows against the tile's 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        uint32_t b[4];
        ldsm_x4(b, sk + (j * 8 + (lane & 7)) * LD + kk * 16 + (lane >> 3) * 8);
        mma16816(s[j], qf[kk], b[0], b[1]);
        mma16816(s[j], qf[kk + 1], b[2], b[3]);
      }
    }

    // online softmax in base 2; the diagonal tile masks key > query
    const bool diag = kt == qt;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[j][e] * a.scale_log2;
        if (diag && j * 8 + 2 * tg + (e & 1) > row0 + g + 8 * r) x = neg_inf();
        s[j][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        ls[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pf[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

    cp_async_wait<0>();  // the V tile has landed
    __syncthreads();
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t b[4];
        ldsm_x4_t(b, sv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                         jd * 16 + (lane >> 4) * 8);
        mma16816(o[2 * jd], pf[kk], b[0], b[1]);
        mma16816(o[2 * jd + 1], pf[kk], b[2], b[3]);
      }
    __syncthreads();  // every warp is done with this K and V tile
    if (kt < qt) {
      load_tile(sk, kp + static_cast<size_t>(kt + 1) * BK * D);
      cp_async_commit();
      load_tile(sv, vp + static_cast<size_t>(kt + 1) * BK * D);
      cp_async_commit();
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * tg;
    *reinterpret_cast<uint32_t*>(op + (row0 + g) * D + col) =
        pack_bf16(o[n][0] * inv[0], o[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(op + (row0 + g + 8) * D + col) =
        pack_bf16(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
}

// --- fp32: plain FMAs -------------------------------------------------------

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

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_prefill_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // longest rows first
  const int hk = h / (a.Hq / a.Hkv);
  const size_t qoff = ((static_cast<size_t>(b) * a.Hq + h) * a.S +
                       static_cast<size_t>(qt) * BQ) * D;
  const size_t kvoff = (static_cast<size_t>(b) * a.Hkv + hk) * a.S * D;
  const T* qp = static_cast<const T*>(a.q) + qoff;
  const T* kp = static_cast<const T*>(a.k) + kvoff;
  const T* vp = static_cast<const T*>(a.v) + kvoff;
  T* op = static_cast<T*>(a.out) + qoff;
  if constexpr (std::is_same<T, float>::value)
    fma_body(a, qp, kp, vp, op, qt, smem);
  else
    mma_body(a, qp, kp, vp, op, qt, smem);
}

template <typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int smem = 3 * BQ * Ld<T>::value * static_cast<int>(sizeof(T));
  cudaFuncSetAttribute(flash_prefill_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  flash_prefill_kernel<T>
      <<<dim3(a.Hq, B, a.S / BQ), THREADS, smem, stream>>>(a);
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
  if (S % BQ != 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.S = S;
  a.scale_log2 = scale * 1.4426950408889634f;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(a, B, s)
                    : launch<__nv_bfloat16>(a, B, s);
}
