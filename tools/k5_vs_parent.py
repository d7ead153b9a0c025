#!/usr/bin/env python3
"""K5 (Mixtral routing) of this tree against an older K5, in turns, on one
H100.

    python3 tools/k5_vs_parent.py DIR [--rounds N] [--variants]
        [--no-steps] [--no-pdl]

DIR holds the older K5's two sources, as `git show` writes them:

    mkdir -p build/parent_k5
    for f in moe_route.cu common.cuh; do
      git show 9ee1652:teal_tpu_torch/csrc/$f > build/parent_k5/$f; done

Both libraries export the same C entry point (`teal_moe_route`), so the
older one is swapped in under the same Python wrapper: the same checks,
arguments and launches. With random inputs from seed 0 it
  1. holds both kernels to the plain version (`chip_smoke.check_k5`'s
     shapes and cases) and logs how many xn elements of each differ from
     the plain version's;
  2. with `--variants`: this tree's kernel beside copies of its source
     with one text substitution each (`VARIANTS`: the cluster's size, the
     block's threads; the steps this design took or left: the norm's
     partials pushed to the peers over a cluster barrier, the pick by
     repeated shuffles, four sums a thread with a butterfly, x's sum in
     16-byte loads; and, for their time only, cuts of each part: the
     router's, the gain's and x's reads, the logits, rank 0's pick), at
     Mixtral's shapes (E 8 and E 64, bf16), the best of two readings;
  3. times both in turns (this, older, older, this), `--rounds` times
     over, at Mixtral's shapes (D 4096, E 8, k 2) on a bf16 and an fp32
     stream and at (E 16, k 4) and (E 64, k 8) on a bf16 stream, each call
     on another layer of a router stack twice the L2 (queued, back to
     back: `chip_smoke.cuda_ms`), beside the launch floor (an empty kernel
     of one block and an empty 8-block cluster, timed the same way,
     `chip_smoke.launch_floor_ms`) and the bytes bound;
  4. unless `--no-steps`, profiles the Mixtral int8 decode step (32
     layers) and the bf16 one (8 layers) in turns at `chip_smoke.py`'s
     thresholds (picked on the plain token path, column 6 at 0): K5's
     kernel sum, the step's device time (the sum of its kernels and the
     union of their intervals), its wall time and the idle share;
  5. unless `--no-pdl`, the same int8 step in turns with this tree's K5
     built with programmatic dependent launch (`PDL_CUTS`: the router and
     gain reads issued before `griddepcontrol.wait`, the launch allowed
     to start before the kernel ahead of it ends), read by the union of
     the kernels' intervals (K5's own time includes its wait).
Prints a line a reading and, last, one JSON object of them all.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import chip_smoke as cs  # noqa: E402
from older_kernels import build_older  # noqa: E402

TURNS = ("this", "older", "older", "this")
SOURCE = "moe_route.cu"
# (D, E, k_exp, stream type) of the timings
TIME_SHAPES = ((4096, 8, 2, "bf16"), (4096, 8, 2, "fp32"),
               (4096, 16, 4, "bf16"), (4096, 64, 8, "bf16"))
# programmatic dependent launch: the router and gain reads issued, then
# griddepcontrol.wait before x is read; the launch allows the early start
PDL_CUTS = [
    ("""#pragma unroll
  for (int i = 0; i < MAXR; ++i)
    if (tid + i * THREADS < n) xv[i] = to_f(x[tid + i * THREADS]);""",
     """  asm volatile("griddepcontrol.wait;\\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < MAXR; ++i)
    if (tid + i * THREADS < n) xv[i] = to_f(x[tid + i * THREADS]);"""),
    ("""  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;""",
     """  cudaLaunchAttribute attr[2];
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;"""),
    ("""  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fn, a);""",
     """  cfg.numAttrs = 2;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fn, a);""")]
# (anchor, replacement) cuts of this tree's source
VARIANTS = {
    "cluster of 4": [("constexpr int MAXC = 8; ",
                      "constexpr int MAXC = 4; ")],
    "one block": [("constexpr int MAXC = 8; ", "constexpr int MAXC = 1; "),
                  ("constexpr int MAXR = 4; ", "constexpr int MAXR = 16; ")],
    "512 threads": [("constexpr int THREADS = 256;",
                     "constexpr int THREADS = 512;")],
    "norm partials pushed to the peers": [
        ("""  const T* xall = static_cast<const T*>(a.x);
  float s = 0.f;
#pragma unroll 16
  for (int d = tid; d < D; d += THREADS) {
    const float v = to_f(xall[d]);
    s = fmaf(v, v, s);
  }
  s = block_sum(s, scratch);
""",
         """  float* ssq = part;                    // free until the logits
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < MAXR; ++i)
    if (tid + i * THREADS < n) ss = fmaf(xv[i], xv[i], ss);
  for (int r = tid + MAXR * THREADS; r < n; r += THREADS) {
    const float v = to_f(x[r]);
    ss = fmaf(v, v, ss);
  }
  ss = block_sum(ss, scratch);
  cluster_wait();
  if (tid < C) cluster.map_shared_rank(ssq, tid)[rank] = ss;
  cluster.sync();
  float s = 0.f;
  for (int r = 0; r < C; ++r) s += ssq[r];
"""),
        ("""  __syncthreads();
  cluster_wait();                       // every peer has started
""", """  __syncthreads();
""")],
    "four sums a thread, a butterfly where E divides 32": [(
        """  if (tid < TE) {
    float acc = 0.f;
    const int dr = TE / E;
    for (int f = tid, r = tid / E; f < cnt; f += TE, r += dr)
      acc = fmaf(xs[r], slab[f], acc);
    part[tid] = acc;
  }
  __syncthreads();
  if (tid < E) {
    float b = 0.f;
    for (int t = tid; t < TE; t += E) b += part[t];
""",
        """  const bool fly = 32 % E == 0;
  if (tid < TE) {
    const int dr = TE / E;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int f = tid, r = tid / E;
    for (; f + 3 * TE < cnt; f += 4 * TE, r += 4 * dr) {
      a0 = fmaf(xs[r], slab[f], a0);
      a1 = fmaf(xs[r + dr], slab[f + TE], a1);
      a2 = fmaf(xs[r + 2 * dr], slab[f + 2 * TE], a2);
      a3 = fmaf(xs[r + 3 * dr], slab[f + 3 * TE], a3);
    }
    for (; f < cnt; f += TE, r += dr) a0 = fmaf(xs[r], slab[f], a0);
    float acc = (a0 + a1) + (a2 + a3);
    if (fly) {
      for (int o = 16; o >= E; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane < E) part[warp * E + lane] = acc;
    } else {
      part[tid] = acc;
    }
  }
  __syncthreads();
  if (tid < E) {
    float b = 0.f;
    if (fly)
      for (int w = 0; w < THREADS / 32; ++w) b += part[w * E + tid];
    else
      for (int t = tid; t < TE; t += E) b += part[t];
""")],
    "pick by repeated shuffles": [(
        """  float* lg = part;                     // [E] the logits""",
        """  float* lg = part;
  auto better = [](float& v, int& e, float v2, int e2) {
    if (v2 > v || (v2 == v && e2 < e)) {
      v = v2;
      e = e2;
    }
  };"""), (
        """  __syncwarp();
  int p0 = 0, p1 = 0;
  for (int q = 0; q < E; ++q) {
    const float u = lg[q];
    p0 += u > v0 || (u == v0 && q < lane);
    p1 += u > v1 || (u == v1 && q < lane + 32);
  }
  const int k = a.k_exp, base = a.layer * E;
  if (lane < E && p0 < k) {
    sel[p0] = v0;
    a.eidx[p0] = base + lane;
  }
  if (lane + 32 < E && p1 < k) {
    sel[p1] = v1;
    a.eidx[p1] = base + lane + 32;
  }
  __syncwarp();
  if (lane < k) {
    float den = 0.f;
    for (int t = 0; t < k; ++t) den += expf(sel[t] - sel[0]);
    a.w[lane] = expf(sel[lane] - sel[0]) / den;
  }
""", """  (void)sel;
  bool t0 = lane >= E, t1 = lane + 32 >= E;
  float top = 0.f, mine = ninf;
  int pick = 0;
  for (int t = 0; t < a.k_exp; ++t) {
    float v = ninf;
    int e = 1 << 30;
    if (!t0) better(v, e, v0, lane);
    if (!t1) better(v, e, v1, lane + 32);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      better(v, e, __shfl_xor_sync(0xffffffffu, v, o),
             __shfl_xor_sync(0xffffffffu, e, o));
    if (t == 0) top = v;
    if (lane == t) {
      mine = v;
      pick = e;
    }
    if (e == lane) t0 = true;
    if (e == lane + 32) t1 = true;
  }
  const float ex = lane < a.k_exp ? expf(mine - top) : 0.f;
  float den = 0.f;
  for (int t = 0; t < a.k_exp; ++t) den += __shfl_sync(0xffffffffu, ex, t);
  if (lane < a.k_exp) {
    a.eidx[lane] = a.layer * E + pick;
    a.w[lane] = ex / den;
  }
""")],
    "x sum in 16-byte loads": [(
        """#pragma unroll 16
  for (int d = tid; d < D; d += THREADS) {
    const float v = to_f(xall[d]);
    s = fmaf(v, v, s);
  }
""", """  constexpr int V = 16 / sizeof(T);
#pragma unroll 4
  for (int c = tid; c < D / V; c += THREADS) {
    const uint4 raw = reinterpret_cast<const uint4*>(xall)[c];
    const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int q = 0; q < V; ++q) s = fmaf(to_f(el[q]), to_f(el[q]), s);
  }
""")],
    # timing only (wrong results): what each part of a call costs
    "router read cut": [(
        "    cp_async16(slab + head + 4 * j, src + head + 4 * j);\n",
        "    (void)src;\n")],
    "gain read cut": [(
        "    if (tid + i * THREADS < n) gv[i] = to_f(g[tid + i * THREADS]);\n",
        "    gv[i] = 1.f;\n")],
    "x sum cut": [("    const float v = to_f(xall[d]);\n",
                   "    const float v = 1.f;\n")],
    "logits cut": [(
        """    for (int f = tid, r = tid / E; f < cnt; f += TE, r += dr)
      acc = fmaf(xs[r], slab[f], acc);
""", "    (void)dr;\n")],
    "rank 0's pick cut": [("  if (rank != 0 || warp != 0) return;\n",
                           "  return;\n")],
}
VARIANT_SHAPES = ((4096, 8, 2, "bf16"), (4096, 64, 8, "bf16"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the entry point's argtypes (this tree's signature)."""
    from teal_tpu_torch import _build

    fn = lib.teal_moe_route
    fn.argtypes = _build.SIGNATURES[("moe_route", "teal_moe_route")]
    fn.restype = ctypes.c_int
    return lib


def built(src_dir: str, tag: str, cuts=()) -> ctypes.CDLL:
    """K5 from `src_dir` (with the (anchor, replacement) `cuts` applied)
    built with nvcc into `build/k5_<tag>/`."""
    src = Path(src_dir)
    if cuts:
        text = (src / SOURCE).read_text()
        for anchor, repl in cuts:
            if anchor not in text:
                raise SystemExit(f"anchor not found: {anchor!r}")
            text = text.replace(anchor, repl)
        src = ROOT / "build" / f"k5_{tag}_src"
        src.mkdir(parents=True, exist_ok=True)
        (src / SOURCE).write_text(text)
        (src / "common.cuh").write_text(
            (Path(src_dir) / "common.cuh").read_text())
    return bind(build_older(str(src), SOURCE, f"k5_{tag}"))


@contextlib.contextmanager
def k5_library(lib):
    """Run K5's wrapper on `lib` inside the block; a function in its
    place (the CPU rehearsal's plain version) replaces the wrapper."""
    from teal_tpu_torch import _build
    from teal_tpu_torch.ops import token_block as tb

    if not isinstance(lib, ctypes.CDLL):
        wrapper = tb.moe_route
        tb.moe_route = lib
        try:
            yield
        finally:
            tb.moe_route = wrapper
        return
    this = _build.load()["moe_route"]
    _build._libs["moe_route"] = lib
    try:
        yield
    finally:
        _build._libs["moe_route"] = this


def k5_call(D, E, k, dtype, device, gen):
    """fn(i): K5 at (D, E, k) on another layer of a router stack of at
    least `chip_smoke.K5_TIME_BYTES` at every call, and the bound."""
    import torch

    from teal_tpu_torch.ops import token_block as tb

    Lr = max(2 * (cs.K5_TIME_ITERS + 2),
             math.ceil(cs.K5_TIME_BYTES / (D * E * 4)))
    router = torch.randn(Lr, D, E, generator=gen, device=device) * 0.02
    norm = (1 + 0.1 * torch.randn(Lr, D, generator=gen, device=device)
            ).to(dtype)
    x = torch.randn(D, generator=gen, device=device).to(dtype)
    base = [0]

    def call(i):
        base[0] += 1
        return tb.moe_route(x, norm, router, base[0] % Lr, k)

    nbytes = 3 * D * x.element_size() + D * E * 4 + 2 * k * 4
    return call, cs.bound_ms(nbytes, 2 * D * E)[0]


def variants(libs, device, gen):
    """Each library of `libs` at `VARIANT_SHAPES` (the best of two
    readings; None where the variant has no plan for the shape): {name:
    {shape: ms}}."""
    import torch

    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    calls = {f"D{D} E{E} k{k} {dt}": k5_call(D, E, k, dtypes[dt], device,
                                            gen)[0]
             for D, E, k, dt in VARIANT_SHAPES}

    def best(fn):
        try:
            return min(cs.cuda_ms(fn, cs.K5_TIME_ITERS)[0] for _ in range(2))
        except RuntimeError as e:          # the launch refused the shape
            cs.log(f"[k5 variants] {e}")
            return None

    out = {}
    for name, lib in libs.items():
        with k5_library(lib):
            out[name] = {c: best(fn) for c, fn in calls.items()}
        cs.log(f"[k5 variants] {name}: " + ", ".join(
            f"{c} {ms}" for c, ms in out[name].items()) + " ms")
    return out


def kernel_turns(libs, device, gen, rounds):
    """{shape: {who: [ms, ...], "bound_ms": b}} in turns, beside the
    launch floor read before and after each round."""
    import torch

    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    calls = {f"D{D} E{E} k{k} {dt}": k5_call(D, E, k, dtypes[dt], device,
                                            gen)
             for D, E, k, dt in TIME_SHAPES}
    got = {c: {w: [] for w in libs} for c in calls}
    floors = []
    for _ in range(rounds):
        floors.append(cs.launch_floor_ms())
        for who in TURNS:
            with k5_library(libs[who]):
                for c, (fn, _) in calls.items():
                    got[c][who].append(cs.cuda_ms(fn, cs.K5_TIME_ITERS)[0])
        floors.append(cs.launch_floor_ms())
    for c, t in got.items():
        t["bound_ms"] = calls[c][1]
        cs.log(f"[k5 turns] {c:22s} this "
               f"{[round(v, 5) for v in t['this']]} older "
               f"{[round(v, 5) for v in t['older']]} ms (bound "
               f"{t['bound_ms']:.6f} ms)")
    cs.log("[k5 turns] launch floor (one block, 8-block cluster) ms: "
           + ", ".join(f"({a:.5f}, {b:.5f})" for a, b in floors))
    return dict(calls=got, floor_ms=floors)


def step_readings(step, iters: int = 3):
    """One decode step's readings: wall ms (host clock, synchronised),
    and from torch.profiler the sum of its kernels' times, the union of
    their intervals and K5's sum, per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.time_range.end > e.time_range.start)
    union, hi = 0.0, -math.inf
    for a, b, _ in spans:
        if b > hi:
            union += b - max(a, hi)
            hi = b
    total = sum(b - a for a, b, _ in spans)
    k5 = sum(b - a for a, b, n in spans if "route_kernel" in n)
    return dict(wall_ms=wall, sum_ms=total / 1e3 / iters,
                union_ms=union / 1e3 / iters, k5_ms=k5 / 1e3 / iters,
                idle_share=max(0.0, 1.0 - union / 1e3 / iters / wall))


def step_turns(params, cfg, th, device, rope, name, libs, rounds):
    """One decode step at pos 40 (token 7, an empty cache) in turns:
    {who: [readings, ...]}."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama

    sp = SparsityConfig(**cs.MAIN_SP)
    x = torch.full((1, 1), 7, device=device)
    kv = llama.KVCache.init(cfg, 1, cs.MAX_SEQ, llama.compute_dtype(params),
                            device)

    def step():
        llama.forward(params, x, kv, 40, th, cfg=cfg, sp=sp, rope=rope)

    whos = list(libs)
    order = (whos[0], whos[1], whos[1], whos[0])
    out = {w: [] for w in whos}
    for _ in range(rounds):
        for who in order:
            with k5_library(libs[who]):
                out[who].append(step_readings(step))
    for who, v in out.items():
        cs.log(f"[steps turns] {name} {who}: K5 ms "
               f"{[round(r['k5_ms'], 4) for r in v]}, device (kernel sum) "
               f"ms {[round(r['sum_ms'], 3) for r in v]}, device (union) ms "
               f"{[round(r['union_ms'], 3) for r in v]}, wall ms "
               f"{[round(r['wall_ms'], 2) for r in v]}, idle "
               f"{[round(r['idle_share'], 3) for r in v]}")
    return out


def run_steps(cfg, device, libs, rounds, gen, pdl=None):
    """Mixtral as `chip_smoke.MOE_RUNS` builds it (int8 at cfg's depth,
    bf16 cut), thresholds picked on the plain token path (every layer of
    the kernel path held to it), then the decode step in turns; with
    `pdl` also this K5 against its PDL build on the int8 step."""
    import numpy as np
    import torch

    from teal_tpu_torch.models import llama

    rope = llama.precompute_rope(cfg, cs.MAX_SEQ, device)
    out = {}
    for plan, layers in cs.MOE_RUNS:
        mcfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers)
        params, _ = cs.mixtral_params(mcfg, gen, device, plan == "int8")
        rng = np.random.default_rng(10)
        prompt = rng.integers(1, mcfg.vocab_size, cs.PROMPT_LENS[0])
        cache, tok, pos = cs.prefill(params, mcfg, prompt[None], device,
                                     rope)
        th, worst, _ = cs.hold_token_layers(params, mcfg, cache, tok, pos,
                                            rope, device)
        cs.log(f"[steps] Mixtral {plan} at {mcfg.n_layers} layers: every "
               f"layer held to the plain token path (worst {worst:.2e} of "
               "scale)")
        name = f"Mixtral {plan}"
        out[name] = step_turns(params, mcfg, th, device, rope, name, libs,
                               rounds)
        if pdl is not None and plan == "int8":
            out[f"{name} PDL"] = step_turns(
                params, mcfg, th, device, rope, f"{name} PDL",
                {"this": libs["this"], "pdl": pdl}, rounds)
        del params, cache
        torch.cuda.empty_cache()
    return out


def run(device, libs, rounds: int, seed: int = 0, do_steps: bool = True,
        pdl=None, var_libs=None):
    """The readings of `libs` {"this", "older"} (K5 libraries; to rehearse
    on the CPU, `moe_route` and its plain version)."""
    import torch

    from teal_tpu_torch.config import get_model_config

    gen = torch.Generator(device=device).manual_seed(seed)
    out = {"rounds": rounds, "max_abs_err": {}, "xn_differ": {}}
    for who, lib in libs.items():
        with k5_library(lib):
            err, differ = cs.check_k5(device, gen, plan=who == "this")
        out["max_abs_err"][who], out["xn_differ"][who] = err, differ
        cs.log(f"[k5 check] {who}: max_abs_err {err:.3e}; xn elements "
               f"that differ from the plain version's: {differ}")
    if var_libs:
        out["variants"] = variants(dict(this=libs["this"], **var_libs),
                                   device, gen)
    out["kernels"] = kernel_turns(libs, device, gen, rounds)
    if do_steps:
        out["steps"] = run_steps(get_model_config(cs.MOE_MODEL), device,
                                 libs, rounds, gen, pdl)
    return out


def main() -> int:
    import torch

    from teal_tpu_torch import _build

    ap = argparse.ArgumentParser()
    ap.add_argument("older", help="directory of the older K5's sources")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--no-steps", action="store_true")
    ap.add_argument("--no-pdl", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k5_vs_parent: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    libs = {"this": _build.load()["moe_route"],
            "older": built(args.older, "older")}
    pdl = (None if args.no_pdl or args.no_steps
           else built(str(_build.CSRC), "pdl", PDL_CUTS))
    var_libs = ({name: built(str(_build.CSRC), f"v{i}", cuts)
                 for i, (name, cuts) in enumerate(VARIANTS.items())}
                if args.variants else None)
    out = run(torch.device("cuda", 0), libs, args.rounds,
              do_steps=not args.no_steps, pdl=pdl, var_libs=var_libs)
    print(card, flush=True)
    print(json.dumps(dict(out, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
