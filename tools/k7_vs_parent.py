#!/usr/bin/env python3
"""K7 (the whole-token decode kernel) of this tree against an older K7, in
turns, on one H100.

    python3 tools/k7_vs_parent.py DIR [--rounds N] [--iters N]
        [--variants [NAME ...]] [--no-parent] [--no-loop] [--caps-only]
        [--pos P ...] [--save DIR] [--no-hold]

DIR holds the older K7's two sources, as `git show` writes them:

    mkdir -p build/parent_k7
    for f in token_decode.cu common.cuh; do
      git show 2c8250c:teal_tpu_torch/csrc/$f > build/parent_k7/$f; done

Both libraries export `teal_token_decode` and `teal_token_plan` (the
workspace bytes at out[3]); this tree's take the MoE arguments the older
one lacks (router, routes, E, KE: passed as none here), so each is bound
to its own signature and called through ctypes with a workspace of its
own plan's size (the older plan's partials are larger). On Llama-2-7B
(bf16 random weights from seed 0, 32 layers, as `chip_smoke.py` builds
them) it
  1. holds each library's K7 to the plain version (`token_kernel_plain`)
     on the first two layers at pos 2047 of a 2048-row cache of random
     rows: the same kept groups, the stream within 2e-2 of its largest
     value;
  2. times, in turns (this, older, older, this) and `--rounds` times
     over, one token alone (CUDA events over `--iters` launches queued
     behind a sleep) and as a CUDA graph replay (one K7 node), at phase
     4's thresholds (`chip_smoke.calibrate_and_check` on the calibration
     token of phase 4's first prompt) and at every stage's cap
     (thresholds 0), each at pos 40 of a 512-row cache and at pos 2047 of
     a 2048-row one (the same inputs for both libraries);
  3. unless `--no-loop`, the K1/K2 loop's decode graph
     (`token_decode(token_fused=False)`) at the same points once a round;
  4. with `--variants`, copies of this tree's source with one
     substitution each (`VARIANTS`; all of them when no name is given),
     each held as in 1 (`--no-hold` for the cuts that change results)
     and timed alone in turns with this tree's at the same points
     (`--no-parent` skips the older library);
  5. this tree's trace at each point (`token_kernel(stamps=)`,
     `k7_phases`; `--save DIR` keeps each as .npy).
`--pos` picks the positions (a cache of 512 rows below 512, else 2048).
It prints a line a reading, the card's name and power limit, and last
one JSON object of them all. It imports no JAX. ~6 min with the parent,
the loop and no variants.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import chip_smoke as cs  # noqa: E402

TURNS = ("this", "older", "older", "this")
SOURCE = "token_decode.cu"
HEADER = "token_decode.cuh"      # the kernel's body since it took the
                                 # quantized plans (absent in the parent)

# (anchor, replacement) cuts of this tree's source (its .cu and header)
VARIANTS = {
    "L2 promotion none": [(
        "CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
        "CU_TENSOR_MAP_L2_PROMOTION_NONE")],
    "L2 promotion 256B": [(
        "CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
        "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")],
    "weights evict-normal": [(
        "createpolicy.fractional.L2::evict_first.b64",
        "createpolicy.fractional.L2::evict_normal.b64")],
    "11 ring slots": [(
        "constexpr int MAXSLOT = 8;", "constexpr int MAXSLOT = 11;")],
    "other plan": [(
        "const int head = ch > 0 &&", "const int head = false && ch > 0 &&")],
    "head plan on every resident cluster": [(
        "const int C = head ? ch : co, NC = head ? Hkv : nc[C];",
        "const int C = head ? ch : co, NC = nc[C];")],
    "nothing inlined": [(
        "__device__ __forceinline__ Ring gather(",
        "__device__ __noinline__ Ring gather("), (
        "__device__ __forceinline__ void attention(",
        "__device__ __noinline__ void attention("), (
        "__device__ __forceinline__ void barrier(",
        "__device__ __noinline__ void barrier("), (
        "__device__ __forceinline__ int select_stage(",
        "__device__ __noinline__ int select_stage("), (
        "__device__ __forceinline__ void fold(",
        "__device__ __noinline__ void fold("), (
        "__device__ __forceinline__ void load_cg(",
        "__device__ __noinline__ void load_cg("), (
        "__device__ __forceinline__ void epilogue(",
        "__device__ __noinline__ void epilogue(")],
    "attention not inlined": [(
        "__device__ __forceinline__ void attention(",
        "__device__ __noinline__ void attention(")],
    "no cluster sums (wrong results)": [(
        "    epilogue<T, P>(a, kind, st, part, rank, C, wlay, h, dst, dst2, "
        "wt);\n",
        "")],
}


def bind(lib: ctypes.CDLL, moe: bool) -> ctypes.CDLL:
    """Set the entry points' argtypes: this tree's signatures, or (`moe`
    False, the older library) the same without the MoE arguments (the
    router after the weights, routes after sel, E and KE after fixed;
    E and KE before the plan's out)."""
    from teal_tpu_torch import _build

    sig = {fn: _build.SIGNATURES[("token_decode", fn)]
           for fn in ("teal_token_decode", "teal_token_plan")}
    if not moe:
        d, p = sig["teal_token_decode"], sig["teal_token_plan"]
        sig = {"teal_token_decode": d[:14] + d[15:19] + d[20:34] + d[36:],
               "teal_token_plan": p[:10] + p[12:]}
    for fn, argtypes in sig.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.moe_args = moe
    return lib


def build_all(jobs):
    """{tag: CDLL}: each (tag, source dir, cuts) built with the port's nvcc
    flags into `build/k7_<tag>/`, one nvcc each, all at once."""
    from teal_tpu_torch import _build

    procs = {}
    for tag, src_dir, cuts in jobs:
        src = Path(src_dir)
        out = ROOT / "build" / f"k7_{tag}"
        out.mkdir(parents=True, exist_ok=True)
        files = [SOURCE] + ([HEADER] if (src / HEADER).exists() else [])
        texts = {f: (src / f).read_text() for f in files}
        for anchor, repl in cuts:
            hit = [f for f in files if anchor in texts[f]]
            if not hit:
                raise SystemExit(f"anchor not found: {anchor!r}")
            for f in hit:
                texts[f] = texts[f].replace(anchor, repl)
        for f, text in texts.items():
            (out / f).write_text(text)
        (out / "common.cuh").write_text((src / "common.cuh").read_text())
        so = out / f"libk7_{tag}.so"
        procs[tag] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-o", str(so),
             str(out / SOURCE)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (so, proc) in procs.items():
        text, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {tag}:\n{text}")
        libs[tag] = bind(ctypes.CDLL(str(so)), tag != "parent")
    return libs


class Point:
    """One token's inputs: 7B weights, thresholds, a cache and pos."""

    def __init__(self, params, cfg, th, kc, vc, pos, device):
        import torch

        from teal_tpu_torch.config import SparsityConfig
        from teal_tpu_torch.models import llama

        lay = params["layers"]
        self.cfg, self.th, self.kc, self.vc = cfg, th, kc, vc
        self.ws = tuple(lay[n] for n in cs.PROJ_NAMES)
        self.norms = (lay["attn_norm"], lay["mlp_norm"])
        self.caps = llama.token_path_caps(cfg, SparsityConfig(**cs.MAIN_SP))
        rope = llama.precompute_rope(cfg, kc.shape[3], device)
        self.pos = torch.tensor([pos], dtype=torch.int32, device=device)
        self.rope = llama._rope_rows(rope[0], rope[1], self.pos)
        self.h = params["embed"][7].to(torch.bfloat16)
        self.out = torch.empty_like(self.h)

    def args(self):
        return (self.h, self.th, self.ws, *self.norms, self.rope, self.kc,
                self.vc, self.pos)

    def kw(self):
        return dict(caps=self.caps, n_heads=self.cfg.n_heads,
                    norm_eps=self.cfg.norm_eps, window=self.cfg.sliding_window)

    def call(self, lib, sel=None):
        """fn(i): one K7 launch of `lib` on these inputs (its own plan's
        workspace)."""
        import torch

        from teal_tpu_torch import _build

        c, L = self.cfg, self.kc.shape[0]
        sms = _build.sm_count(self.h.device.index)
        out = (ctypes.c_int * 11)()
        moe = lib.moe_args          # a dense MLP: no router, E = KE = 0
        rc = lib.teal_token_plan(1, c.dim, c.intermediate_size, c.n_heads,
                                 c.n_kv_heads, self.kc.shape[3], 0,
                                 max(self.caps), sms, L,
                                 *((0, 0) if moe else ()), out)
        cs.check(rc == 0, f"no K7 plan: {rc}")
        work = torch.empty(out[3], dtype=torch.uint8, device=self.h.device)
        args = (1, self.h.data_ptr(), self.th.data_ptr(), self.pos.data_ptr(),
                self.rope.data_ptr(), *(n.data_ptr() for n in self.norms),
                *(w.data_ptr() for w in self.ws),
                *((None,) if moe else ()), self.kc.data_ptr(),
                self.vc.data_ptr(), self.out.data_ptr(),
                None if sel is None else sel.data_ptr(),
                *((None,) if moe else ()), None,
                work.data_ptr(), L, c.dim, c.intermediate_size, c.n_heads,
                c.n_kv_heads, self.kc.shape[3], 0, *self.caps, 0,
                *((0, 0) if moe else ()), c.norm_eps, sms, 0)

        def fn(i):
            err = lib.teal_token_decode(
                *args, torch.cuda.current_stream().cuda_stream)
            cs.check(err == 0, f"K7 launch failed with {err}")
        fn.work = work
        return fn


def graph_of(fn):
    """A CUDA graph of fn(0) (two warm-up calls on a side stream first)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn(0)
    return graph


def hold(lib, params, cfg, device, gen):
    """`lib`'s K7 on the first two layers at pos 2047 of a 2048-row cache
    against the plain version: (kept groups equal, error, scale)."""
    import torch

    from teal_tpu_torch.ops import token_block as tb

    cut = dict(params, layers={k: v[:2] for k, v in params["layers"].items()})
    shape = (2, 1, cfg.n_kv_heads, 2048, 128)
    kc = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    p = Point(cut, cfg, torch.zeros((2, 7), device=device), kc.clone(),
              vc.clone(), 2047, device)
    sels = [torch.zeros((2, 4, 1 + max(p.caps)), dtype=torch.int32,
                        device=device) for _ in range(2)]
    p.call(lib, sels[0])(0)
    want = tb.token_kernel_plain(p.h, p.th, p.ws, *p.norms, p.rope, kc, vc,
                                 p.pos, sel=sels[1], **p.kw())
    torch.cuda.synchronize()
    err = float((p.out.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return bool(torch.equal(*sels)), err, scale


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent_dir")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variants", nargs="*")
    ap.add_argument("--no-parent", action="store_true")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--caps-only", action="store_true")
    ap.add_argument("--save", help="a directory for this tree's traces "
                    "(.npy, one a point)")
    ap.add_argument("--no-hold", action="store_true",
                    help="time variants that change results (no hold)")
    ap.add_argument("--pos", type=int, nargs="*", default=[40, 2047])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k7_vs_parent: no CUDA device", file=sys.stderr)
        return 2
    from teal_tpu_torch import _build
    from teal_tpu_torch.config import SparsityConfig, get_model_config
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import token_block as tb

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    names = ([] if args.variants is None
             else list(args.variants) or list(VARIANTS))
    jobs = [("this", str(ROOT / "teal_tpu_torch" / "csrc"), [])]
    if not args.no_parent:
        jobs.append(("older", args.parent_dir, []))
    jobs += [(f"v{i}", str(ROOT / "teal_tpu_torch" / "csrc"), VARIANTS[n])
             for i, n in enumerate(names)]
    _build.load()
    libs = build_all(jobs)
    tags = {f"v{i}": n for i, n in enumerate(names)}
    res = {"card": cs.card_line(), "hold": {}, "points": {}}

    cfg = get_model_config("7B")
    gen = torch.Generator(device=device).manual_seed(0)
    params = llama.init_params(cfg, gen, torch.bfloat16, device)
    for tag, lib in libs.items():
        same, err, scale = hold(lib, params, cfg, device, gen)
        res["hold"][tags.get(tag, tag)] = dict(same_kept=same, err=err,
                                               scale=scale)
        print(f"[hold] {tags.get(tag, tag)}: 2 layers at pos 2047, kept "
              f"groups equal {same}, error {err:.3e} of {scale:.3e}")
        cs.check(args.no_hold or (same and err <= 2e-2 * scale),
                 f"{tag} differs from the plain version")

    caps = llama.token_path_caps(cfg, SparsityConfig(**cs.MAIN_SP))
    ths = {"caps": torch.zeros((cfg.n_layers, 7), device=device)}
    if not args.caps_only:
        rope = llama.precompute_rope(cfg, cs.MAX_SEQ, device)
        prompt = cs.main_prompts(cfg, 0)[0]
        cache, tok, pos = cs.calibration_token(
            params, cfg, prompt, llama.KVCache.init(cfg, 1, cs.MAX_SEQ,
                                                    torch.bfloat16, device),
            rope, device)
        ths["phase 4"], _, _ = cs.calibrate_and_check(params, cfg, cache, tok,
                                                      pos, rope, caps, device)
        del cache
    for th_name, th in ths.items():
        for pos, T in ((p, 512 if p < 512 else 2048) for p in args.pos):
            shape = (cfg.n_layers, 1, cfg.n_kv_heads, T, 128)
            kc = torch.randn(shape, generator=gen, device=device).to(
                torch.bfloat16)
            vc = torch.randn(shape, generator=gen, device=device).to(
                torch.bfloat16)
            p = Point(params, cfg, th, kc, vc, pos, device)
            calls = {tags.get(t, t): p.call(lib) for t, lib in libs.items()}
            graphs = {w: graph_of(fn) for w, fn in calls.items()}
            key = f"{th_name}, pos {pos}"
            got = {w: {"ms": [], "graph_ms": []} for w in calls}
            if not args.no_loop:
                loop = graph_of(lambda i: tb.token_decode(
                    *p.args(), token_fused=False, **p.kw()))
                got["loop graph"] = {"graph_ms": []}
            order = [w for w in TURNS if w in calls] + [
                w for n in names for w in ("this", n, n, "this")]
            for _ in range(args.rounds):
                for w in order:
                    got[w]["ms"].append(cs.cuda_ms(calls[w], args.iters)[0])
                    got[w]["graph_ms"].append(cs.cuda_ms(
                        lambda i, g=graphs[w]: g.replay(), args.iters)[0])
                if not args.no_loop:
                    got["loop graph"]["graph_ms"].append(cs.cuda_ms(
                        lambda i: loop.replay(), args.iters)[0])
            sel = torch.zeros((cfg.n_layers, 4, 1 + max(caps)),
                              dtype=torch.int32, device=device)
            p.call(libs["this"], sel)(0)
            torch.cuda.synchronize()
            nbytes, _ = cs.k7_bound(sel, cfg, pos, 2)
            got["bound_ms"] = nbytes / cs.HBM_BYTES_PER_S * 1e3
            stamps = tb.token_trace(p.h, p.kc, p.ws, cfg.n_heads, p.caps)
            tb.token_kernel(*p.args(), stamps=stamps, **p.kw())
            torch.cuda.synchronize()
            trace = tb.k7_phases(stamps)
            res.setdefault("traces", {})[key] = trace
            print(f"[{key}] this tree's trace, us over the layers: "
                  + ", ".join(f"{k} {v[0]:.1f}/{v[1]:.1f}"
                              if isinstance(v, tuple) else f"{k} {v:.1f}"
                              for k, v in trace.items()))
            if args.save:
                import numpy as np

                name = f"k7_trace_{th_name.replace(' ', '')}_{pos}.npy"
                np.save(Path(args.save) / name, stamps.cpu().numpy())
            got["kept_mean"] = sel[:, :, 0].float().mean(0).tolist()
            res["points"][key] = got
            for w, r in got.items():
                if isinstance(r, dict):
                    print(f"[{key}] {w}: " + "; ".join(
                        f"{k} {[round(x, 4) for x in v]}"
                        for k, v in r.items()))
            print(f"[{key}] bound {got['bound_ms']:.4f} ms, mean kept "
                  f"{[round(k, 2) for k in got['kept_mean']]}")
            del calls, graphs, kc, vc, p
            if not args.no_loop:
                del loop
            torch.cuda.empty_cache()
    print(res["card"])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
