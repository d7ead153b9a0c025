#!/usr/bin/env python3
"""The gather GEMVs K4 (`row_gather_gemv`) and K3 (`block_gather_gemv`)
of this tree against older ones, in turns, on one H100.

    python3 tools/gathers_vs_parent.py DIR [--rounds N] [--variants]
        [--no-steps]

DIR holds the older kernels' sources, as `git show` writes them:

    mkdir -p build/parent_gathers
    for f in row_gather_gemv.cu block_gather_gemv.cu common.cuh; do
      git show aaaeeb6:teal_tpu_torch/csrc/$f > build/parent_gathers/$f
    done

Both libraries of each kernel export the same C entry point, so the older
one is swapped in under the same Python wrapper: the same checks,
arguments and launches. At the 7B shapes (bf16 random weights from seed
0; each call on another of the 32 layers' weights, so calls do not share
L2) it
  1. with `--variants`: where the older K4 and K3 spend their time.
     Variants of the older sources, each with one text substitution,
     timed beside them (the best of two readings; cut variants compute
     wrong results and serve only as timings): K4 "no idx load" (the slot
     is the row: no load of idx before the row's), "no index chain" (also
     no load of xc: every fifth slot is zero, as many rows as the median
     threshold keeps); K3 int4 "no scale / zero loads";
  2. holds both kernels of each pair to the plain versions
     (`chip_smoke.check_k4` with its edge cases, `chip_smoke.check_k3`
     with 1, 4 and 8 rows; two calls bit-identical);
  3. times, in turns (this, older, older, this) and `--rounds` times
     over, K4 at the seven projections (median |x|) and K3 at path A's
     four stages in the bf16, int8 and packed-int4 (G = 64) plans at 1
     and 4 rows (k_keep == cap), with the GB/s each moves;
  4. unless `--no-steps`, profiles one step of paths C, A, A-b4 and
     Q4-loop in turns: the kernel's device time (its
     kernels' sum), the step's device time and its wall time.
Prints a line a reading and, last, one JSON object of them all.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import chip_smoke as cs  # noqa: E402
from older_kernels import build_older  # noqa: E402

TURNS = ("this", "older", "older", "this")
STEMS = {"k4": ("row_gather_gemv", "teal_row_gather_gemv"),
         "k3": ("block_gather_gemv", "teal_block_gather_gemv")}

# (anchor, replacement) cuts of the older sources (commit aaaeeb6)
_K4_IDX = "      const int k = min(max(__ldg(idx + r), 0), K - 1);\n"
_K4_XC = "    const float xv = __ldg(xc + r);\n"
_K3_SZ = ("      load8(SZ + static_cast<size_t>(g) * 2 * N, sc);\n"
          "      load8(SZ + static_cast<size_t>(g) * 2 * N + N, zr);\n")
VARIANTS = {
    "k4": {"no idx load": [(_K4_IDX, "      const int k = r % K;\n")],
           "no index chain": [(_K4_IDX, "      const int k = r % K;\n"),
                              (_K4_XC, "    const float xv = (r % 5) ? "
                                       "1.f : 0.f;\n")]},
    "k3": {"int4: no scale / zero loads": [
        (_K3_SZ, "#pragma unroll\n      for (int e = 0; e < 8; ++e) {\n"
                 "        sc[e] = 1.f;\n        zr[e] = 0.f;\n      }\n")]},
}


def bind(lib: ctypes.CDLL, which: str) -> ctypes.CDLL:
    """Set the entry point's argtypes (this tree's signature)."""
    from teal_tpu_torch import _build

    stem, fn_name = STEMS[which]
    fn = getattr(lib, fn_name)
    fn.argtypes = _build.SIGNATURES[(stem, fn_name)]
    fn.restype = ctypes.c_int
    return lib


def older(src_dir: str, which: str, cuts=(), tag: str = "older"):
    """The older kernel (with `cuts` applied) built with nvcc into
    `build/<which>_<tag>/`."""
    stem = STEMS[which][0]
    src = Path(src_dir)
    if cuts:
        text = (src / f"{stem}.cu").read_text()
        for anchor, repl in cuts:
            if anchor not in text:
                raise SystemExit(f"{which}: anchor not found: {anchor!r}")
            text = text.replace(anchor, repl)
        src = ROOT / "build" / f"{which}_{tag}_src"
        src.mkdir(parents=True, exist_ok=True)
        (src / f"{stem}.cu").write_text(text)
        (src / "common.cuh").write_text(
            (Path(src_dir) / "common.cuh").read_text())
    return bind(build_older(str(src), f"{stem}.cu", f"{which}_{tag}"),
                which)


@contextlib.contextmanager
def library(which: str, lib):
    """Run the wrapper of `which` (k3, k4) on `lib` inside the block."""
    from teal_tpu_torch import _build

    stem = STEMS[which][0]
    this = _build.load()[stem]
    _build._libs[stem] = lib
    try:
        yield
    finally:
        _build._libs[stem] = this


def k4_calls(params, cfg, device, gen):
    """{projection: (call fn(i), bytes read)} at the seven K4 calls."""
    from teal_tpu_torch.ops import gather_gemv as gg

    L, out = cfg.n_layers, {}
    for n in cs.PROJ_NAMES:
        w3 = params["layers"][n]
        N = w3.shape[2]
        _, idx, vals, _, nnz_cap = cs.k4_inputs(w3[0], gen, device, 0.5)
        rows = int((vals != 0).sum())
        out[n] = ((lambda i, idx=idx, vals=vals, w3=w3:
                   gg.row_gather_gemv(idx, vals, w3[i % L])),
                  rows * N * 2 + nnz_cap * 8 + N * 2)
    return out


def k3_calls(qparams, plan, cfg, device, gen):
    """{f"{plan} {stage} rows={r}": (call fn(i), bytes read)} at path A's
    four stages, 1 and 4 rows, k_keep == cap."""
    import torch

    from teal_tpu_torch.ops import block_gemv as bg

    L, out = cfg.n_layers, {}
    for name, st in cs.loop_stages(qparams, cfg).items():
        ws, G, cap = st["ws"], st["G"], st["cap"]
        K, Ns = bg._in_dim(ws[0]), [bg._width(w) for w in ws]
        for rows in (1, 4):
            x = torch.randn(rows, K, generator=gen, device=device).bfloat16()
            idx, xpack = (bg.select_groups(x, G, cap) if rows == 1 else
                          bg.select_groups_batched(x, G, cap))
            nbytes = (cs.plan_bytes(ws, G, cap, None) + idx.numel() * 4
                      + xpack.numel() * 2 + rows * sum(Ns) * 4)
            out[f"{plan} {name} rows={rows}"] = (
                (lambda i, idx=idx, xpack=xpack, ws=ws, G=G, rows=rows:
                 bg.block_gather_gemv_multi(idx, xpack, ws, i % L, G,
                                            rows)), nbytes)
    return out


def best_ms(call, n: int = 2) -> float:
    return min(cs.cuda_ms(call, 64)[0] for _ in range(n))


def variants(src_dir, which, calls):
    """The older kernel and its cut variants at `calls`: {variant: {call:
    ms}} (the best of two readings)."""
    out = {}
    libs = {"as is": older(src_dir, which)}
    for name, cuts in VARIANTS[which].items():
        libs[name] = older(src_dir, which, cuts,
                           tag="v" + str(len(libs)))
    for name, lib in libs.items():
        with library(which, lib):
            out[name] = {c: best_ms(fn) for c, (fn, _) in calls.items()}
        cs.log(f"[{which} variants] {name}: " + ", ".join(
            f"{c} {ms:.4f}" for c, ms in out[name].items())
               + f"; sum {sum(out[name].values()):.4f} ms")
    return out


def turns(libs, which, calls, rounds):
    """{call: {who: [ms, ...]}} in turns."""
    got = {c: {w: [] for w in libs} for c in calls}
    for _ in range(rounds):
        for who in TURNS:
            with library(which, libs[who]):
                for c, (fn, _) in calls.items():
                    got[c][who].append(cs.cuda_ms(fn, 64)[0])
    for c, (_, nbytes) in calls.items():
        t = got[c]
        cs.log(f"[{which} turns] {c}: this {[round(v, 4) for v in t['this']]}"
               f" older {[round(v, 4) for v in t['older']]} ms; this "
               f"{nbytes / min(t['this']) / 1e6:.0f} GB/s, older "
               f"{nbytes / min(t['older']) / 1e6:.0f} GB/s at best")
    for who in libs:
        per = [sum(got[c][who][k] for c in calls)
               for k in range(len(got[next(iter(calls))][who]))]
        cs.log(f"[{which} turns] sum of {len(calls)} calls, {who}: "
               f"{[round(v, 4) for v in per]} ms")
    return got


def steps(params, cfg, device, rope, runs, libs, rounds):
    """Profiled decode steps in turns: {run: {who: [(kernel ms, device ms,
    wall ms), ...]}}; `runs` are `chip_smoke.time_decode_step` runs, each
    with the swapped kernel ("k3" or "k4") last, whose device time is
    read; `libs`: {who: {which: lib}}."""
    out = {r[0]: {w: [] for w in libs} for r in runs}
    for _ in range(rounds):
        for who in TURNS:
            with contextlib.ExitStack() as stack:
                for which, lib in libs[who].items():
                    stack.enter_context(library(which, lib))
                for run in runs:
                    got = cs.time_decode_step(params, cfg, [run[:-1]],
                                              device, rope)[run[0]]
                    out[run[0]][who].append((got[f"{run[-1]}_ms"],
                                             got["device_ms"],
                                             got["wall_ms"]))
    for name, got in out.items():
        for who, v in got.items():
            cs.log(f"[steps turns] {name} {who}: kernel ms "
                   f"{[round(k, 4) for k, _, _ in v]}, device ms "
                   f"{[round(d, 3) for _, d, _ in v]}, wall ms "
                   f"{[round(w, 2) for _, _, w in v]}")
    return out


def main() -> int:
    import torch

    from teal_tpu_torch import _build
    from teal_tpu_torch.config import get_model_config
    from teal_tpu_torch.models import llama

    ap = argparse.ArgumentParser()
    ap.add_argument("older", help="directory of the older kernels' sources")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--no-steps", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gathers_vs_parent: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    device = torch.device("cuda", 0)
    libs = {which: {"this": _build.load()[STEMS[which][0]],
                    "older": older(args.older, which)} for which in STEMS}
    cfg = get_model_config("7B")
    gen = torch.Generator(device=device).manual_seed(0)
    params = llama.init_params(cfg, gen, torch.bfloat16, device)
    out = {"rounds": args.rounds, "card": card}

    k4 = k4_calls(params, cfg, device, gen)
    k3 = k3_calls(params, "bf16", cfg, device, gen)
    if args.variants:
        out["variants k4"] = variants(args.older, "k4", k4)
        out["variants k3"] = variants(
            args.older, "k3",
            k3_calls(cs.quantize_on_card(params, "int4-g64")[0], "int4",
                     cfg, device, gen))
    for which, check in (("k4", lambda: cs.check_k4(params, cfg, device,
                                                    gen)),
                         ("k3", lambda: cs.check_k3(params, cfg, device,
                                                    gen, (1, 4, 8)))):
        for who, lib in libs[which].items():
            with library(which, lib):
                out[f"max_abs_err {which} {who}"] = check()
    out["k4 turns"] = turns(libs["k4"], "k4", k4, args.rounds)
    out["k3 turns"] = {"bf16": turns(libs["k3"], "k3", k3, args.rounds)}
    for kind, plan in (("int8", "int8"), ("int4-g64", "int4")):
        q, _ = cs.quantize_on_card(params, kind)
        out["k3 turns"][plan] = turns(libs["k3"], "k3",
                                      k3_calls(q, plan, cfg, device, gen),
                                      args.rounds)
        if plan == "int4" and not args.no_steps:
            q4 = q
        else:
            del q
    torch.cuda.empty_cache()
    if not args.no_steps:
        rope = llama.precompute_rope(cfg, cs.MAX_SEQ, device)
        loop = cs.loop_paths(params, cfg, device, 0, rope,
                             paths={n: cs.LOOP_PATHS[n]
                                    for n in ("A", "A-b4", "C")},
                             launches=cs.LOOP_LAUNCHES)
        runs = [(f"path {n}", *cs.LOOP_PATHS[n], loop[n]["th"], w)
                for n, w in (("C", "k4"), ("A", "k3"), ("A-b4", "k3"))]
        by_who = {w: {k: libs[k][w] for k in STEMS} for w in ("this",
                                                              "older")}
        out["steps"] = steps(params, cfg, device, rope, runs, by_who,
                             args.rounds)
        th0 = llama.zero_thresholds(cfg, device)
        out["steps q4"] = steps(q4, cfg, device, rope,
                                [("path Q4-loop", cs.LOOP_PATHS["A"][0], 1,
                                  th0, "k3")], by_who, args.rounds)
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
