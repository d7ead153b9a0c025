// K7's rows form with a bf16 stream and cache and all seven projections
// int8 {"q", "scale"} or packed int4 at quant group 128 {"qp", "sz"} (the
// kernel is `token_decode_rows.cuh`; `token_decode_rows.cu` builds the
// array rows). Entry points as `token_decode_rows.cu`'s, with the plan (1
// int8, 2 packed int4) first and the seven weights' sz (int4) and scale
// (int8) stacks.
#include "token_decode_rows.cuh"

namespace {

// this library builds the quantized rows kernels alone
const void* kernel_of(int, int, int) { return nullptr; }

const void* rows_kernel_of(int plan, int dtype, int GH) {
  if (dtype != 1 || (plan != PLAN_INT8 && plan != PLAN_INT4)) return nullptr;
  switch ((plan == PLAN_INT8 ? 0 : 4) + __builtin_ctz(GH)) {
    case 0: return rows_fn<__nv_bfloat16, 1, PLAN_INT8>();
    case 1: return rows_fn<__nv_bfloat16, 2, PLAN_INT8>();
    case 2: return rows_fn<__nv_bfloat16, 4, PLAN_INT8>();
    case 3: return rows_fn<__nv_bfloat16, 8, PLAN_INT8>();
    case 4: return rows_fn<__nv_bfloat16, 1, PLAN_INT4>();
    case 5: return rows_fn<__nv_bfloat16, 2, PLAN_INT4>();
    case 6: return rows_fn<__nv_bfloat16, 4, PLAN_INT4>();
    default: return rows_fn<__nv_bfloat16, 8, PLAN_INT4>();
  }
}

}  // namespace

// `teal_token_clusters_rows` for plan (1 int8, 2 packed int4), bf16.
extern "C" int teal_token_clusters_rows_q(int plan, int GH, int C) {
  return rows_clusters_impl(plan, 1, GH, C);
}

// `teal_token_plan_rows` for plan (1 int8, 2 packed int4), bf16.
extern "C" int teal_token_plan_rows_q(int plan, int B, int D, int I, int Hq,
                                      int Hkv, int T, int window, int capmax,
                                      int n_sms, int L, int* out) {
  (void)window;
  return rows_plan_impl(plan, 1, B, D, I, Hq, Hkv, T, capmax, n_sms, L, out);
}

// `teal_token_decode_rows` for plan (1 int8, 2 packed int4) with a bf16
// stream and cache: w0-w6 int8 q [L, K, N] or int4 qp [L, K/2, N]; sz0-sz6
// int4's fp32 [L, K/128, 2, N] (null for int8); sc0-sc6 int8's fp32 [L, N]
// (null for int4).
extern "C" int teal_token_decode_rows_q(
    int plan, int B, const void* x, const void* thr, const void* pos,
    const void* cs, const void* na, const void* nm, const void* w0,
    const void* w1, const void* w2, const void* w3, const void* w4,
    const void* w5, const void* w6, const void* sz0, const void* sz1,
    const void* sz2, const void* sz3, const void* sz4, const void* sz5,
    const void* sz6, const void* sc0, const void* sc1, const void* sc2,
    const void* sc3, const void* sc4, const void* sc5, const void* sc6,
    void* kc, void* vc, void* out, void* sel, void* ws, int L, int D, int I,
    int Hq, int Hkv, int T, int window, int cap0, int cap1, int cap2,
    int cap3, int fixed, int seq, float eps, int n_sms, void* stream) {
  const void* const w[7] = {w0, w1, w2, w3, w4, w5, w6};
  const void* const sz[7] = {sz0, sz1, sz2, sz3, sz4, sz5, sz6};
  const void* const sc[7] = {sc0, sc1, sc2, sc3, sc4, sc5, sc6};
  const int caps[4] = {cap0, cap1, cap2, cap3};
  return rows_decode_impl(plan, 1, B, x, thr, pos, cs, na, nm, w, sz, sc,
                          kc, vc, out, sel, ws, L, D, I, Hq, Hkv, T, window,
                          caps, fixed, seq, eps, n_sms, stream);
}
