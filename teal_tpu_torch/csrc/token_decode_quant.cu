// K7's quantized plans with a bf16 stream and cache: int8 {"q", "scale"}
// and packed int4 at quant group 128 {"qp", "sz"}, all seven projections
// of one plan (the kernel is `token_decode.cuh`; `token_decode.cu` builds
// the array plans). Entry points as `token_decode.cu`'s, with the plan (1
// int8, 2 packed int4) first and the seven weights' sz (int4) and scale
// (int8) stacks.
#include "token_decode.cuh"

namespace {

const void* kernel_of(int plan, int dtype, int GH) {
  if (dtype != 1 || (plan != PLAN_INT8 && plan != PLAN_INT4)) return nullptr;
  switch ((plan == PLAN_INT8 ? 0 : 4) + __builtin_ctz(GH)) {
    case 0: return kernel_fn<__nv_bfloat16, 1, PLAN_INT8>();
    case 1: return kernel_fn<__nv_bfloat16, 2, PLAN_INT8>();
    case 2: return kernel_fn<__nv_bfloat16, 4, PLAN_INT8>();
    case 3: return kernel_fn<__nv_bfloat16, 8, PLAN_INT8>();
    case 4: return kernel_fn<__nv_bfloat16, 1, PLAN_INT4>();
    case 5: return kernel_fn<__nv_bfloat16, 2, PLAN_INT4>();
    case 6: return kernel_fn<__nv_bfloat16, 4, PLAN_INT4>();
    default: return kernel_fn<__nv_bfloat16, 8, PLAN_INT4>();
  }
}

}  // namespace

// `teal_token_clusters` for plan (1 int8, 2 packed int4), bf16.
extern "C" int teal_token_clusters_q(int plan, int GH, int C) {
  return clusters_impl(plan, 1, GH, C);
}

// `teal_token_plan` for plan (1 int8, 2 packed int4), bf16 (MoE: int8
// only).
extern "C" int teal_token_plan_q(int plan, int D, int I, int Hq, int Hkv,
                                 int T, int window, int capmax, int n_sms,
                                 int L, int E, int KE, int* out) {
  return plan_impl(plan, 1, D, I, Hq, Hkv, T, window, capmax, n_sms, L, E,
                   KE, out);
}

// `teal_token_decode` for plan (1 int8, 2 packed int4) with a bf16 stream
// and cache: w0-w6 int8 q [L, K, N] or int4 qp [L, K/2, N]; sz0-sz6 int4's
// fp32 [L, K/128, 2, N] (null for int8); sc0-sc6 int8's fp32 [L, N] (null
// for int4). MoE (int8 only): w4-w6 the expert stacks' q [L, E, K, N] and
// sc4-sc6 their scales [L, E, N].
extern "C" int teal_token_decode_q(
    int plan, const void* x, const void* thr, const void* pos,
    const void* cs, const void* na, const void* nm, const void* w0,
    const void* w1, const void* w2, const void* w3, const void* w4,
    const void* w5, const void* w6, const void* sz0, const void* sz1,
    const void* sz2, const void* sz3, const void* sz4, const void* sz5,
    const void* sz6, const void* sc0, const void* sc1, const void* sc2,
    const void* sc3, const void* sc4, const void* sc5, const void* sc6,
    const void* router, void* kc, void* vc, void* out, void* sel,
    void* routes, void* stamps, void* ws, int L, int D, int I, int Hq,
    int Hkv, int T, int window, int cap0, int cap1, int cap2, int cap3,
    int fixed, int E, int KE, float eps, int n_sms, int empty, void* stream) {
  const void* const w[7] = {w0, w1, w2, w3, w4, w5, w6};
  const void* const sz[7] = {sz0, sz1, sz2, sz3, sz4, sz5, sz6};
  const void* const sc[7] = {sc0, sc1, sc2, sc3, sc4, sc5, sc6};
  const int caps[4] = {cap0, cap1, cap2, cap3};
  return decode_impl(plan, 1, x, thr, pos, cs, na, nm, w, sz, sc, router, kc,
                     vc, out, sel, routes, stamps, ws, L, D, I, Hq, Hkv, T,
                     window, caps, fixed, E, KE, eps, n_sms, empty, stream);
}
