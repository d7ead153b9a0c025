#!/usr/bin/env python3
"""K1's single row (the select + gather GEMV of one decode row) of this
tree against an older K1, in turns, on one H100.

    python3 tools/k1_vs_parent.py DIR [--rounds N] [--variants]
        [--no-steps] [--no-moe | --moe-only]

DIR holds the older K1's two sources, as `git show` writes them:

    mkdir -p build/parent_k1s
    for f in select_gather_gemv.cu common.cuh; do
      git show 3aedd1a:teal_tpu_torch/csrc/$f > build/parent_k1s/$f; done

Both libraries export the same C entry point (`teal_select_gather_gemv`),
so the older one is swapped in under the same Python wrapper: the same
checks, arguments and launches. With random weights from seed 0 (bf16
Llama-2-7B, its int8 and packed-int4 G = 128 copies quantized on the
card; Mixtral-8x7B in int8 at 32 layers and in bf16 at 8, as
`chip_smoke.py` builds them), each call on another layer's (or
pseudo-layer's) weights, so calls do not share L2, it
  1. holds both kernels to the plain version (`chip_smoke.check_k1` in
     the three plans, `chip_smoke.check_k1_groups` at G = 32 / 64, and
     `chip_smoke.check_k1_moe` on the Mixtral copies);
  2. with `--variants`: this tree's kernel beside copies of its source
     with one text substitution each (`VARIANTS`: the split rule, the
     ring's depth, the tile's width), at the 7B stages in the three
     plans;
  3. times, in turns (this, older, older, this) and `--rounds` times
     over, the token path's four stages (`chip_smoke.STAGES`, count ==
     cap, the folded norm and epilogues of the token path) in the bf16,
     int8 and packed-int4 plans, path B's four stages at G = 32 / 64 (no
     epilogue), and a routed expert's two calls (gate|up, down with the
     weighted residual, device pseudo-layer) of Mixtral int8 and bf16;
  4. unless `--no-steps`, profiles one decode step in turns -- main,
     Q8-main, Q4-main on the 7B copies and, unless `--no-moe`, Mixtral
     int8 at 32 layers -- with every threshold at 0, so each K1 call
     keeps cap groups (the most bytes its cap allows): K1's device time
     (its kernels' sum), the step's device time and its wall time.
`--moe-only` skips the 7B parts, `--no-moe` Mixtral's. Prints a line a
reading and, last, one JSON object of them all.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import chip_smoke as cs  # noqa: E402
from older_kernels import build_older  # noqa: E402

TURNS = ("this", "older", "older", "this")
SOURCE = "select_gather_gemv.cu"

# (anchor, replacement) cuts of this tree's source
VARIANTS = {
    "grid to two blocks an SM": [(
        "  while (S < SMAXS && tiles * 2 * S <= n_sms) S *= 2;\n",
        "  while (S < SMAXS && tiles * S <= n_sms) S *= 2;\n")],
    "ring of 12 stages": [(
        "constexpr int SNST = 8;              // ring stages\n",
        "constexpr int SNST = 12;             // ring stages\n")],
    "512-byte tiles": [(
        "constexpr int PIECE = 256;           // bytes of a slab row a block "
        "reads\n",
        "constexpr int PIECE = 512;           // bytes of a slab row a block "
        "reads\n")],
}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the entry point's argtypes (this tree's signature)."""
    from teal_tpu_torch import _build

    fn = lib.teal_select_gather_gemv
    fn.argtypes = _build.SIGNATURES[("select_gather_gemv",
                                     "teal_select_gather_gemv")]
    fn.restype = ctypes.c_int
    return lib


def built(src_dir: str, tag: str, cuts=()) -> ctypes.CDLL:
    """K1 from `src_dir` (with `cuts` applied) built with nvcc into
    `build/k1s_<tag>/`."""
    src = Path(src_dir)
    if cuts:
        text = (src / SOURCE).read_text()
        for anchor, repl in cuts:
            if anchor not in text:
                raise SystemExit(f"anchor not found: {anchor!r}")
            text = text.replace(anchor, repl)
        src = ROOT / "build" / f"k1s_{tag}_src"
        src.mkdir(parents=True, exist_ok=True)
        (src / SOURCE).write_text(text)
        (src / "common.cuh").write_text(
            (Path(src_dir) / "common.cuh").read_text())
    return bind(build_older(str(src), SOURCE, f"k1s_{tag}"))


@contextlib.contextmanager
def k1_library(lib):
    """Run K1's wrapper on `lib` inside the block; a function in its
    place (the CPU rehearsal's plain version) replaces the wrapper."""
    from teal_tpu_torch import _build
    from teal_tpu_torch.ops import block_gemv as bg

    if not isinstance(lib, ctypes.CDLL):
        wrapper = bg.select_gather_gemv
        bg.select_gather_gemv = lib
        try:
            yield
        finally:
            bg.select_gather_gemv = wrapper
        return
    this = _build.load()["select_gather_gemv"]
    _build._libs["select_gather_gemv"] = lib
    try:
        yield
    finally:
        _build._libs["select_gather_gemv"] = this


def token_calls(qparams, cfg, caps, device, gen, plan):
    """{f"{plan} {stage}": call fn(i)}: the token path's four K1 calls at
    count == cap on layer i % L."""
    import torch

    from teal_tpu_torch.ops import block_gemv as bg

    L, out = cfg.n_layers, {}
    for name, cap in zip(cs.STAGES, caps):
        spec = cs.stage_specs(qparams, cfg)[name]
        K = bg._in_dim(spec["ws"][0])
        x, thr, res = cs.k1_inputs(spec, cfg, K, cap, gen, device,
                                   torch.bfloat16, 0)
        kw = dict(norm=spec["norm"], norm_eps=cfg.norm_eps, res=res,
                  silu=spec["silu"], scales=spec["scales"])
        out[f"{plan} {name}"] = (
            lambda i, x=x, thr=thr, ws=spec["ws"], cap=cap, kw=kw:
            bg.select_gather_gemv(x, thr, ws, i % L, cap, **kw))
    return out


def group_calls(params, cfg, device, gen):
    """{f"G={G} {stage}": call fn(i)}: path B's four K1 calls at G = 32 /
    64 (count == cap, no epilogue) on layer i % L."""
    import torch

    from teal_tpu_torch.ops import block_gemv as bg

    L, out = cfg.n_layers, {}
    for name, st in cs.loop_stages(params, cfg).items():
        ws, G, cap = st["ws"], st["G"], st["cap"]
        K = bg._in_dim(ws[0])
        x, thr, _ = cs.k1_inputs(st, cfg, K, cap, gen, device,
                                 torch.bfloat16, 0, G)
        kw = dict(G=G, norm=st["norm"], norm_eps=cfg.norm_eps)
        out[f"G={G} {name}"] = (
            lambda i, x=x, thr=thr, ws=ws, cap=cap, kw=kw:
            bg.select_gather_gemv(x, thr, ws, i % L, cap, **kw))
    return out


def moe_calls(params, cfg, caps, device, gen, plan):
    """{f"moe {plan} {stage}": call fn(i)}: a routed expert's two K1
    calls at count == cap on pseudo-layer i % (L * E), read on the
    device."""
    import torch

    from teal_tpu_torch.ops import block_gemv as bg

    LE, out = cfg.n_layers * cfg.n_experts, {}
    eidxs = [torch.tensor([0, pl], dtype=torch.int32, device=device)
             for pl in range(LE)]
    for name, cap in (("gate|up", caps[2]), ("down", caps[3])):
        spec = cs.moe_stage_specs(params, cfg)[name]
        x, thr, _, kw = cs.moe_k1_args(spec, cfg, cap, cap, gen, device,
                                       [0, 0])
        out[f"moe {plan} {name}"] = (
            lambda i, x=x, thr=thr, ws=spec["ws"], cap=cap, kw=kw:
            bg.select_gather_gemv(x, thr, ws, eidxs[i % LE], cap, **kw))
    return out


def turns(libs, calls, rounds):
    """{call: {who: [ms, ...]}} in turns, with each layer's sum logged."""
    got = {c: {w: [] for w in libs} for c in calls}
    for _ in range(rounds):
        for who in TURNS:
            with k1_library(libs[who]):
                for c, fn in calls.items():
                    got[c][who].append(cs.cuda_ms(fn, 64)[0])
    for c, t in got.items():
        cs.log(f"[k1 turns] {c:18s} this {[round(v, 4) for v in t['this']]}"
               f" older {[round(v, 4) for v in t['older']]} ms")
    for who in libs:
        per = [sum(got[c][who][k] for c in calls)
               for k in range(len(got[next(iter(calls))][who]))]
        cs.log(f"[k1 turns] sum of {len(calls)} calls, {who}: "
               f"{[round(v, 4) for v in per]} ms")
    return got


def variants(libs, calls):
    """Each library of `libs` at `calls` (the best of two readings):
    {name: {call: ms}}."""
    out = {}
    for name, lib in libs.items():
        with k1_library(lib):
            out[name] = {c: min(cs.cuda_ms(fn, 64)[0] for _ in range(2))
                         for c, fn in calls.items()}
        cs.log(f"[k1 variants] {name}: " + ", ".join(
            f"{c} {ms:.4f}" for c, ms in out[name].items())
            + f"; sum {sum(out[name].values()):.4f} ms")
    return out


def steps(params, cfg, device, rope, name, libs, rounds):
    """One profiled decode step at pos 40 with zero thresholds, in turns:
    {who: [(K1 ms, device ms, wall ms), ...]}."""
    from teal_tpu_torch.models import llama

    th = llama.zero_thresholds(cfg, device)
    out = {w: [] for w in libs}
    for _ in range(rounds):
        for who in TURNS:
            with k1_library(libs[who]):
                got = cs.time_decode_step(params, cfg,
                                          [(name, cs.MAIN_SP, 1, th)],
                                          device, rope)[name]
            out[who].append((got["k1_ms"], got["device_ms"], got["wall_ms"]))
    for who, v in out.items():
        cs.log(f"[steps turns] {name} {who}: K1 ms "
               f"{[round(k, 4) for k, _, _ in v]}, device ms "
               f"{[round(d, 3) for _, d, _ in v]}, wall ms "
               f"{[round(w, 2) for _, _, w in v]}")
    return out


def run(cfg, device, libs, rounds: int, seed: int = 0, var_libs=None,
        do_steps: bool = True, moe_cfg=None):
    """The readings of `libs` {"this", "older"} (K1 libraries; to
    rehearse on the CPU, `select_gather_gemv` and its plain version) at
    `cfg`'s shapes; Mixtral's at `moe_cfg` unless it is None."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama

    gen = torch.Generator(device=device).manual_seed(seed)
    params = llama.init_params(cfg, gen, torch.bfloat16, device)
    caps = llama.token_path_caps(cfg, SparsityConfig(**cs.MAIN_SP))
    rope = llama.precompute_rope(cfg, cs.MAX_SEQ, device)
    out = {"rounds": rounds, "caps": list(caps)}
    quant = {"bf16": params}
    for kind in ("int8", "int4-g128"):
        quant[kind.split("-")[0]] = cs.quantize_on_card(params, kind)[0]

    errs = {}
    for who, lib in libs.items():
        with k1_library(lib):
            for plan, qp in quant.items():
                errs[f"{who} {plan}"] = cs.check_k1(qp, cfg, caps, device,
                                                    gen, tag=f"k1 {who} "
                                                    f"{plan}")
            errs[f"{who} G=32/64"] = cs.check_k1_groups(
                params, cfg, device, gen, tag=f"k1g {who}")
    out["max_abs_err"] = errs

    calls = {}
    for plan, qp in quant.items():
        calls.update(token_calls(qp, cfg, caps, device, gen, plan))
    if var_libs:
        out["variants"] = variants(dict(this=libs["this"], **var_libs),
                                   calls)
    calls.update(group_calls(params, cfg, device, gen))
    out["stages"] = turns(libs, calls, rounds)
    if do_steps:
        out["steps"] = {
            name: steps(qp, cfg, device, rope, name, libs, rounds)
            for name, qp in (("main", quant["bf16"]),
                             ("Q8-main", quant["int8"]),
                             ("Q4-main", quant["int4"]))}
    del params, quant
    torch.cuda.empty_cache()
    if moe_cfg is not None:
        out.update(run_moe(moe_cfg, device, libs, rounds, gen, do_steps))
    return out


def run_moe(cfg, device, libs, rounds, gen, do_steps):
    """Mixtral as `chip_smoke.MOE_RUNS` builds it (int8 at cfg's depth,
    bf16 cut): K1's MoE forms held to the plain version and timed in
    turns, then (int8) the decode step."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama

    caps = llama.token_path_caps(cfg, SparsityConfig(**cs.MAIN_SP))
    rope = llama.precompute_rope(cfg, cs.MAX_SEQ, device)
    out = {"moe_stages": {}, "moe_max_abs_err": {}}
    for plan, layers in cs.MOE_RUNS:
        mcfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers)
        params, _ = cs.mixtral_params(mcfg, gen, device, plan == "int8")
        for who, lib in libs.items():
            with k1_library(lib):
                out["moe_max_abs_err"][f"{who} {plan}"] = cs.check_k1_moe(
                    params, mcfg, caps, device, gen, plan)
        out["moe_stages"][plan] = turns(
            libs, moe_calls(params, mcfg, caps, device, gen, plan), rounds)
        if do_steps and plan == "int8":
            out["moe_step"] = steps(params, mcfg, device, rope,
                                    f"Mixtral {plan}", libs, rounds)
        del params
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    from teal_tpu_torch import _build
    from teal_tpu_torch.config import get_model_config

    ap = argparse.ArgumentParser()
    ap.add_argument("older", help="directory of the older K1's sources")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--no-steps", action="store_true")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--no-moe", action="store_true")
    only.add_argument("--moe-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_vs_parent: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    libs = {"this": _build.load()["select_gather_gemv"],
            "older": built(args.older, "older")}
    var_libs = ({name: built(str(_build.CSRC), f"v{i}", cuts)
                 for i, (name, cuts) in enumerate(VARIANTS.items())}
                if args.variants else None)
    device = torch.device("cuda", 0)
    moe_cfg = None if args.no_moe else get_model_config(cs.MOE_MODEL)
    if args.moe_only:
        gen = torch.Generator(device=device).manual_seed(0)
        out = dict(rounds=args.rounds, **run_moe(
            moe_cfg, device, libs, args.rounds, gen, not args.no_steps))
    else:
        out = run(get_model_config("7B"), device, libs, args.rounds,
                  var_libs=var_libs, do_steps=not args.no_steps,
                  moe_cfg=moe_cfg)
    print(card, flush=True)
    print(json.dumps(dict(out, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
