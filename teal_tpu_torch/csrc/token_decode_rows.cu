// K7's rows form for weights, stream and cache arrays of one type, fp32 or
// bf16 (the kernel is `token_decode_rows.cuh`; `token_decode_rows_quant.cu`
// builds the int8 and packed-int4 rows as a library of its own).
#include "token_decode_rows.cuh"

namespace {

// this library builds the rows kernels alone (the batch-1 plans are
// `token_decode.cu`'s and `token_decode_quant.cu`'s)
const void* kernel_of(int, int, int) { return nullptr; }

const void* rows_kernel_of(int plan, int dtype, int GH) {
  if (plan != PLAN_STREAM) return nullptr;
  switch ((dtype == 0 ? 0 : 4) + __builtin_ctz(GH)) {
    case 0: return rows_fn<float, 1, PLAN_STREAM>();
    case 1: return rows_fn<float, 2, PLAN_STREAM>();
    case 2: return rows_fn<float, 4, PLAN_STREAM>();
    case 3: return rows_fn<float, 8, PLAN_STREAM>();
    case 4: return rows_fn<__nv_bfloat16, 1, PLAN_STREAM>();
    case 5: return rows_fn<__nv_bfloat16, 2, PLAN_STREAM>();
    case 6: return rows_fn<__nv_bfloat16, 4, PLAN_STREAM>();
    default: return rows_fn<__nv_bfloat16, 8, PLAN_STREAM>();
  }
}

}  // namespace

// The resident clusters of C blocks of the rows kernel of (dtype 0 fp32 /
// 1 bf16, GH query heads a kv head) on the current device. -1 where the
// kernel's attributes cannot be set.
extern "C" int teal_token_clusters_rows(int dtype, int GH, int C) {
  return rows_clusters_impl(PLAN_STREAM, dtype, GH, C);
}

// The rows form's plan for dtype at B rows and these shapes on n_sms SMs
// and the current device's resident clusters, into out int32 [11] (as
// `teal_token_plan`; NS: the rows of a warp's attention chunk). Returns 0,
// or -1 where the shapes take no plan.
extern "C" int teal_token_plan_rows(int dtype, int B, int D, int I, int Hq,
                                    int Hkv, int T, int window, int capmax,
                                    int n_sms, int L, int* out) {
  (void)window;
  return rows_plan_impl(PLAN_STREAM, dtype, B, D, I, Hq, Hkv, T, capmax,
                        n_sms, L, out);
}

// One decode step of B rows through the L layers (x, out [B, D]; pos [B];
// cs [B, 2, 128]; caches [L, B, Hkv, T, 128], or with seq the rows'
// consecutive positions pos[0] + i of one sequence in [L, 1, Hkv, T,
// 128]). The caller checks shapes, types and contiguity and allocates
// `ws` (the plan's workspace bytes); window 0 means none; fixed keeps
// groups 0..cap-1. Returns the launch's error, or -1 where no plan or no
// tensor map can be made.
extern "C" int teal_token_decode_rows(
    int dtype, int B, const void* x, const void* thr, const void* pos,
    const void* cs, const void* na, const void* nm, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* wg,
    const void* wu, const void* wd, void* kc, void* vc, void* out, void* sel,
    void* ws, int L, int D, int I, int Hq, int Hkv, int T, int window,
    int cap0, int cap1, int cap2, int cap3, int fixed, int seq, float eps,
    int n_sms, void* stream) {
  const void* const w[7] = {wq, wk, wv, wo, wg, wu, wd};
  const void* const none[7] = {};
  const int caps[4] = {cap0, cap1, cap2, cap3};
  return rows_decode_impl(PLAN_STREAM, dtype, B, x, thr, pos, cs, na, nm, w,
                          none, none, kc, vc, out, sel, ws, L, D, I, Hq, Hkv,
                          T, window, caps, fixed, seq, eps, n_sms, stream);
}
