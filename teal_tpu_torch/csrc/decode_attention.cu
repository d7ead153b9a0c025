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
//   - the softmax is fp32 with the max taken over the slab and the
//     current token; the weights are rounded to the cache type before
//     the PV product (attn_block.py:298-307), the denominator sums the
//     unrounded weights;
//   - k_new (post-RoPE) and v_new are written, cast to the cache type,
//     at row `pos` of layer `layer`; the output is in the cache type.
//
// What bounds it on the H100: bytes. It reads the live rows of one
// layer's K and V once (2 * pos * Hkv * 128 elements) and does 4 flops
// per element read, far below the ridge point, so HBM bandwidth is the
// roofline; at short context one launch's fixed cost dominates instead.
//
// Design. One block per (batch row, kv head): it owns that head's cache
// row `pos`, which it alone writes and no block reads, so there is no
// race between the update and the reads. The block keeps the whole score
// row of its GH query heads in shared memory (GH * T floats), so the
// softmax is one exact pass: scores, block max, exp and block sum (both
// in a fixed order), then PV with one thread per head dimension, each
// summing over t in order. Each warp scores 4 cache rows per step with
// 8-byte loads so several rows are in flight. T is not split across
// blocks; a later split needs a fixed-order second combine pass.
#include "common.cuh"

using namespace teal;

namespace {

constexpr int D = 128;        // head dim
constexpr int THREADS = 128;  // one thread per head dimension
constexpr int MAXG = 8;       // query heads per kv head
constexpr int UR = 4;         // cache rows per warp step

struct Args {
  const float* q;    // [B, Hq, D]   raw (pre-RoPE) fp32
  const float* kn;   // [B, Hkv, D]  raw (pre-RoPE) fp32
  const float* vn;   // [B, Hkv, D]  fp32
  const float* cs;   // [B, 2, D]    cos row, sin row
  void* kc;          // [L, B, Hkv, T, D]
  void* vc;
  const int* pos;    // [B]
  void* out;         // [B, Hq, D]
  int B, Hq, Hkv, T, layer, window;
  float scale;
};

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&r);
  v[0] = to_f(e[0]); v[1] = to_f(e[1]); v[2] = to_f(e[2]); v[3] = to_f(e[3]);
}

// x * cos + rotate_half(x) * sin, rounded as separate products and a sum
// (no fused multiply-add), so the written cache row matches the plain
// version bit for bit.
__device__ __forceinline__ float rope(const float* row, int d, float c,
                                      float s) {
  const float rot = d < D / 2 ? -row[d + D / 2] : row[d - D / 2];
  return __fadd_rn(__fmul_rn(row[d], c), __fmul_rn(rot, s));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) attn_kernel(Args a) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int lane = d & 31, warp = d >> 5;
  const int GH = a.Hq / a.Hkv;
  float* qf = smem;                 // [GH, D] post-RoPE, scaled, fp32
  float* qr = qf + GH * D;          // [GH, D] the same rounded to T
  float* knf = qr + GH * D;         // [D] post-RoPE current key
  float* vnf = knf + D;             // [D] current value
  float* sc = vnf + D;              // [MAXG] current-token scores
  float* ec = sc + MAXG;            // [MAXG] current-token weight
  float* den = ec + MAXG;           // [MAXG] softmax denominator
  float* scratch = den + MAXG;      // [32]
  float* s = scratch + 32;          // [GH, T] slab scores, then weights

  const int p = a.pos[b];
  if (p < 0 || p >= a.T) __trap();
  const int lo = a.window > 0 ? max(p - a.window + 1, 0) : 0;
  const int n = p - lo;             // live slab rows: lo .. p-1
  const size_t slab =
      (static_cast<size_t>(a.layer) * a.B + b) * a.Hkv + h;
  T* kcache = static_cast<T*>(a.kc) + slab * a.T * D;
  T* vcache = static_cast<T*>(a.vc) + slab * a.T * D;

  // prologue: RoPE (fp32), q scale
  {
    const float c = a.cs[(b * 2) * D + d], sn = a.cs[(b * 2 + 1) * D + d];
    for (int g = 0; g < GH; ++g) {
      const float* row = a.q + (static_cast<size_t>(b) * a.Hq + h * GH + g) * D;
      const float v = __fmul_rn(rope(row, d, c, sn), a.scale);
      qf[g * D + d] = v;
      qr[g * D + d] = rnd<T>(v);
    }
    const size_t kv = (static_cast<size_t>(b) * a.Hkv + h) * D;
    knf[d] = rope(a.kn + kv, d, c, sn);
    vnf[d] = a.vn[kv + d];
  }
  __syncthreads();

  // slab scores: warp w takes rows w*UR .. w*UR+UR-1, then strides by 4*UR
  for (int t0 = warp * UR; t0 < n; t0 += 4 * UR) {
    float kv[UR][4];
#pragma unroll
    for (int u = 0; u < UR; ++u)
      if (t0 + u < n)
        load4(kcache + static_cast<size_t>(lo + t0 + u) * D + lane * 4, kv[u]);
#pragma unroll
    for (int u = 0; u < UR; ++u) {
      if (t0 + u >= n) break;
      for (int g = 0; g < GH; ++g) {
        const float* qg = qr + g * D + lane * 4;
        float part = qg[0] * kv[u][0];
        part = fmaf(qg[1], kv[u][1], part);
        part = fmaf(qg[2], kv[u][2], part);
        part = fmaf(qg[3], kv[u][3], part);
        part = warp_sum(part);
        if (lane == 0) s[g * a.T + t0 + u] = part;
      }
    }
  }
  // current token, fp32
  for (int g = warp; g < GH; g += THREADS / 32) {
    const float* qg = qf + g * D + lane * 4;
    const float* kg = knf + lane * 4;
    float part = qg[0] * kg[0];
    part = fmaf(qg[1], kg[1], part);
    part = fmaf(qg[2], kg[2], part);
    part = fmaf(qg[3], kg[3], part);
    part = warp_sum(part);
    if (lane == 0) sc[g] = part;
  }
  __syncthreads();

  // softmax over slab + current token, in fixed order
  for (int g = 0; g < GH; ++g) {
    float m = __int_as_float(0xff800000);  // -inf
    for (int t = d; t < n; t += THREADS) m = fmaxf(m, s[g * a.T + t]);
    m = fmaxf(block_max(m, scratch), sc[g]);
    float sum = 0.f;
    for (int t = d; t < n; t += THREADS) {
      const float e = expf(s[g * a.T + t] - m);
      s[g * a.T + t] = rnd<T>(e);
      sum += e;
    }
    sum = block_sum(sum, scratch);
    if (d == 0) {
      const float e = expf(sc[g] - m);
      ec[g] = e;
      den[g] = sum + e;
    }
  }
  __syncthreads();

  // PV: thread d sums over t in order
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;
#pragma unroll 8
  for (int t = 0; t < n; ++t) {
    const float v = to_f(vcache[static_cast<size_t>(lo + t) * D + d]);
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < GH) acc[g] = fmaf(s[g * a.T + t], v, acc[g]);
  }
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < GH)
      out[(static_cast<size_t>(b) * a.Hq + h * GH + g) * D + d] =
          from_f<T>((acc[g] + ec[g] * vnf[d]) * (1.0f / den[g]));

  // in-place write of the current token (row p: read by no block)
  kcache[static_cast<size_t>(p) * D + d] = from_f<T>(knf[d]);
  vcache[static_cast<size_t>(p) * D + d] = from_f<T>(vnf[d]);
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const int GH = a.Hq / a.Hkv;
  const size_t smem =
      sizeof(float) * (2 * GH * D + 2 * D + 3 * MAXG + 32 +
                       static_cast<size_t>(GH) * a.T);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(attn_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  attn_kernel<T><<<dim3(a.Hkv, a.B), THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (the cache type). window 0 means none. The caller
// checks shapes: head dim 128, Hq % Hkv == 0, Hq / Hkv <= 8, and that the
// score row GH * T fits shared memory.
extern "C" int teal_decode_attention(
    int dtype, const void* q, const void* k_new, const void* v_new,
    const void* cs, void* kc, void* vc, const void* pos, void* out, int B,
    int Hq, int Hkv, int T, int layer, int window, float scale,
    void* stream) {
  cudaGetLastError();  // clear any stale error of this library
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
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(a, s) : launch<__nv_bfloat16>(a, s);
}
