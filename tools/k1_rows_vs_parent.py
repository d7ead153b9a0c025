#!/usr/bin/env python3
"""K1's rows form (the batched select + gather GEMV) of this tree against
an older K1, in turns, on one H100.

    python3 tools/k1_rows_vs_parent.py DIR [--rounds N]

DIR holds the older K1's two sources, as `git show` writes them:

    mkdir -p build/parent_k1
    for f in select_gather_gemv.cu common.cuh; do
      git show 107fc93:teal_tpu_torch/csrc/$f > build/parent_k1/$f; done

Both libraries export the same C entry point (`teal_select_gather_gemv`),
so the older one is swapped in under the same Python wrapper: the same
checks, arguments and launches.

At the 7B shapes (bf16 random weights from seed 0; each call on another
of the 32 layers' weights, so calls do not share L2), it
  1. holds both kernels to the plain version (`chip_smoke.check_k1_rows`,
     bf16: B = 2, 3, 8, 16, five selection regimes, two calls
     bit-identical);
  2. splits a rows call at B = 16, bf16, count == cap (spiky rows,
     `chip_smoke.rows_input`), for both kernels: as the kernel table times
     it (the folded norm where the stage has one, scores); `fixed` (no
     scores); `fixed` without the norm; `fixed` without the norm at cap 1;
  3. times, in turns (this, older, older, this) and `--rounds` times over,
     the four stages at B = 8 and 16 in the bf16, int8 and packed-int4
     (G = 128) plans, count == cap, and at B = 1 (the single-row kernel,
     the main path's);
  4. profiles one server decode step at B = 16, in turns: K1's device
     time (its kernels' sum) and the step's device time, with the
     thresholds `chip_smoke.server_phase` picks on the plain path for its
     first 16 admitted requests; once on those requests (kept counts near
     cap) and once as phase 9 times the step (token 7 at positions 40,
     44, ... on an empty cache), whose kept counts it logs.
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
SPLIT = ("table", "fixed", "fixed, no norm", "fixed, no norm, cap 1")


def older_k1(src_dir: str) -> ctypes.CDLL:
    """The older K1 built with nvcc into `build/k1_older/`, its entry
    point bound with this tree's signature."""
    from teal_tpu_torch import _build

    lib = build_older(src_dir, "select_gather_gemv.cu", "k1_older")
    fn = lib.teal_select_gather_gemv
    fn.argtypes = _build.SIGNATURES[("select_gather_gemv",
                                     "teal_select_gather_gemv")]
    fn.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def k1_library(lib):
    """Run K1's wrapper on `lib` inside the block."""
    from teal_tpu_torch import _build

    this = _build.load()["select_gather_gemv"]
    _build._libs["select_gather_gemv"] = lib
    try:
        yield
    finally:
        _build._libs["select_gather_gemv"] = this


def rows_calls(params, cfg, caps, device, gen, B, variant="table"):
    """{stage: fn(i)}: one rows call of each stage at B rows on layer
    i % L, count == cap (cap 1 in the last split variant)."""
    import torch

    from teal_tpu_torch.ops import block_gemv as bg

    L, out = cfg.n_layers, {}
    for name, cap in zip(cs.STAGES, caps):
        spec = cs.stage_specs(params, cfg)[name]
        K = bg._in_dim(spec["ws"][0])
        c = 1 if variant.endswith("cap 1") else cap
        x, thr, res = cs.rows_input(spec, cfg, K, B, c, gen, device,
                                    torch.bfloat16, 0)
        kw = dict(norm=None if "no norm" in variant else spec["norm"],
                  norm_eps=cfg.norm_eps, res=res, silu=spec["silu"],
                  scales=spec["scales"], fixed=variant.startswith("fixed"))

        def call(i, x=x, thr=thr, ws=spec["ws"], c=c, kw=kw):
            return bg.select_gather_gemv(x, thr, ws, i % L, c, **kw)

        out[name] = call
    return out


def in_turns(libs, calls, rounds):
    """{stage: {who: [ms, ...]}} over `rounds` rounds of `TURNS`."""
    got = {name: {who: [] for who in libs} for name in calls}
    for _ in range(rounds):
        for who in TURNS:
            with k1_library(libs[who]):
                for name, fn in calls.items():
                    got[name][who].append(cs.cuda_ms(fn, 64)[0])
    return got


def admitted_server(params, cfg, device, seed, rope):
    """The first 16 requests of `chip_smoke.server_phase`'s workload
    admitted, and the thresholds it picks on the plain path over their
    first decode step (every layer held to it). Returns (thresholds, the
    engine)."""
    import numpy as np
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine import ContinuousBatchingEngine

    rng = np.random.default_rng(seed + 4)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(cs.SERVER_PROMPT[0],
                                     cs.SERVER_PROMPT[1] + 1,
                                     cs.SERVER_REQUESTS)]
    new = [int(n) for n in rng.integers(8, 17, cs.SERVER_REQUESTS)]
    eng = ContinuousBatchingEngine(
        cfg, params, slots=cs.SERVER_SLOTS, max_seq=cs.MAX_SEQ,
        sp=SparsityConfig(**cs.MAIN_SP), temperature=0.0,
        cache_dtype=torch.bfloat16, device=device)
    for p, n in zip(prompts[:cs.SERVER_SLOTS], new[:cs.SERVER_SLOTS]):
        eng.submit(p, n)
    eng._admit()
    th, _, _ = cs.hold_token_layers(params, cfg, eng.cache, eng.cur,
                                    eng.pos, rope, device)
    return th, eng


def step_k1(params, cfg, device, rope, th, eng=None, b=16):
    """One profiled server decode step at batch b: (K1's device ms, the
    step's device ms). On `eng`'s admitted requests, else token 7 at
    positions 40, 44, ... on an empty cache."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama

    if eng is None:
        x = torch.full((b, 1), 7, device=device)
        kv = llama.KVCache.init(cfg, b, cs.MAX_SEQ, torch.bfloat16, device)
        pos = [40 + 4 * i for i in range(b)]
    else:
        x = torch.from_numpy(eng.cur[:, None]).to(device)
        kv, pos = eng.cache, eng.pos.tolist()

    def step():
        llama.forward(params, x, kv, pos, th, cfg=cfg,
                      sp=SparsityConfig(**cs.MAIN_SP), rope=rope)

    step()
    dev, rows = cs.profile_device(step, 3)
    return sum(t for k, t in rows if "sgg_" in k), dev


def run(cfg, device, libs, rounds: int, seed: int = 0):
    """The readings of `libs` {"this", "older"} (K1 libraries) at `cfg`'s
    shapes."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama

    gen = torch.Generator(device=device).manual_seed(seed)
    params = llama.init_params(cfg, gen, torch.bfloat16, device)
    caps = llama.token_path_caps(cfg, SparsityConfig(**cs.MAIN_SP))
    rope = llama.precompute_rope(cfg, cs.MAX_SEQ, device)
    out = {"rounds": rounds, "caps": list(caps)}

    for who, lib in libs.items():
        with k1_library(lib):
            cs.check_k1_rows(params, cfg, caps, device, gen,
                             tag=f"k1 rows {who}")

    split = {}
    for variant in SPLIT:
        calls = rows_calls(params, cfg, caps, device, gen, 16, variant)
        split[variant] = in_turns(libs, calls, 1)
        for name, got in split[variant].items():
            cs.log(f"[k1 split] B=16 bf16 {name:8s} {variant:22s} "
                   + "  ".join(f"{w} {sum(v) / len(v):.4f} ms"
                               for w, v in got.items()))
    out["split"] = split

    plans = {}
    for kind in ("bf16", "int8", "int4-g128"):
        qp = params if kind == "bf16" else cs.quantize_on_card(params,
                                                               kind)[0]
        for B in (1, 8, 16):
            got = in_turns(libs, rows_calls(qp, cfg, caps, device, gen, B),
                           rounds)
            plans[f"{kind} B={B}"] = got
            for name, r in got.items():
                cs.log(f"[k1 turns] {kind} B={B} {name:8s} this {r['this']} "
                       f"older {r['older']}")
            layer = {w: [sum(got[n][w][i] for n in got)
                         for i in range(len(got[cs.STAGES[0]][w]))]
                     for w in libs}
            cs.log(f"[k1 turns] {kind} B={B} one layer: this "
                   f"{layer['this']} older {layer['older']}")
        if qp is not params:
            del qp
            torch.cuda.empty_cache()
    out["plans"] = plans

    th, eng = admitted_server(params, cfg, device, seed, rope)
    out["step_kept_b16"] = {
        name: c for name, c in zip(cs.STAGES, cs.step_kept_counts(
            params, cfg, th, device, rope).T.tolist())}
    for name, on in (("step_b16", None), ("step_b16_admitted", eng)):
        steps = {w: [] for w in libs}
        for _ in range(rounds):
            for who in TURNS:
                with k1_library(libs[who]):
                    steps[who].append(step_k1(params, cfg, device, rope, th,
                                              on))
        for who, got in steps.items():
            cs.log(f"[k1 turns] {name} {who}: K1 ms a step "
                   f"{[round(k, 4) for k, _ in got]}, device ms "
                   f"{[round(d, 4) for _, d in got]}")
        out[name] = steps
    return out


def main() -> int:
    import torch

    from teal_tpu_torch import _build
    from teal_tpu_torch.config import get_model_config

    ap = argparse.ArgumentParser()
    ap.add_argument("older", help="directory of the older K1's sources")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_rows_vs_parent: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    libs = {"this": _build.load()["select_gather_gemv"],
            "older": older_k1(args.older)}
    out = run(get_model_config("7B"), torch.device("cuda", 0), libs,
              args.rounds)
    print(card, flush=True)
    print(json.dumps(dict(out, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
