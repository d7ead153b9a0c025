// K7's array plans: weights, stream and cache of one type, fp32 or bf16
// (the kernel is `token_decode.cuh`; `token_decode_quant.cu` builds the
// int8 and packed-int4 plans as a library of its own).
#include "token_decode.cuh"

namespace {

const void* kernel_of(int plan, int dtype, int GH) {
  if (plan != PLAN_STREAM) return nullptr;
  switch ((dtype == 0 ? 0 : 4) + __builtin_ctz(GH)) {
    case 0: return kernel_fn<float, 1, PLAN_STREAM>();
    case 1: return kernel_fn<float, 2, PLAN_STREAM>();
    case 2: return kernel_fn<float, 4, PLAN_STREAM>();
    case 3: return kernel_fn<float, 8, PLAN_STREAM>();
    case 4: return kernel_fn<__nv_bfloat16, 1, PLAN_STREAM>();
    case 5: return kernel_fn<__nv_bfloat16, 2, PLAN_STREAM>();
    case 6: return kernel_fn<__nv_bfloat16, 4, PLAN_STREAM>();
    default: return kernel_fn<__nv_bfloat16, 8, PLAN_STREAM>();
  }
}

}  // namespace

// The resident clusters of C blocks of the kernel of (dtype 0 fp32 / 1
// bf16, GH query heads a kv head) on the current device: the table the
// plan reads. -1 where the kernel's attributes cannot be set.
extern "C" int teal_token_clusters(int dtype, int GH, int C) {
  return clusters_impl(PLAN_STREAM, dtype, GH, C);
}

// The plan for dtype (0 fp32, 1 bf16) at these shapes on n_sms SMs and the
// current device's resident clusters, with E experts of which KE are
// routed a token (0, 0: a dense MLP), into out int32 [11]: grid, threads,
// shared bytes, workspace bytes, grid barriers a token ((2 + 2 KE) L
// head-owned, (3 + 2 KE) L other; KE 1 for a dense MLP), kv-head barriers
// a token (0), C, clusters, head-owned (1 / 0), ring slots, NS. Returns 0,
// or -1 where the shapes take no plan (out untouched).
extern "C" int teal_token_plan(int dtype, int D, int I, int Hq, int Hkv,
                               int T, int window, int capmax, int n_sms,
                               int L, int E, int KE, int* out) {
  return plan_impl(PLAN_STREAM, dtype, D, I, Hq, Hkv, T, window, capmax,
                   n_sms, L, E, KE, out);
}

// One token through the L layers. The caller checks shapes, types and
// contiguity and allocates `ws` (the plan's workspace bytes); window 0
// means none; fixed keeps groups 0..cap-1; empty runs the barriers alone.
// MoE (E > 0 experts, KE routed): router [L, D, E] fp32, wg / wu / wd the
// expert stacks [L, E, K, N], routes [L, KE] int32 (or null) receives the
// routed pseudo-layers; E = 0 (router null): a dense MLP. Returns the
// launch's error, or -1 where no plan or no tensor map can be made.
extern "C" int teal_token_decode(
    int dtype, const void* x, const void* thr, const void* pos,
    const void* cs, const void* na, const void* nm, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* wg,
    const void* wu, const void* wd, const void* router, void* kc, void* vc,
    void* out, void* sel, void* routes, void* stamps, void* ws, int L, int D,
    int I, int Hq, int Hkv, int T, int window, int cap0, int cap1, int cap2,
    int cap3, int fixed, int E, int KE, float eps, int n_sms, int empty,
    void* stream) {
  const void* const w[7] = {wq, wk, wv, wo, wg, wu, wd};
  const void* const none[7] = {};
  const int caps[4] = {cap0, cap1, cap2, cap3};
  return decode_impl(PLAN_STREAM, dtype, x, thr, pos, cs, na, nm, w, none,
                     none, router, kc, vc, out, sel, routes, stamps, ws, L, D,
                     I, Hq, Hkv, T, window, caps, fixed, E, KE, eps, n_sms,
                     empty, stream);
}
