#!/usr/bin/env python3
"""K7's rows form launched many times on the same inputs, on one H100:
how many launches differ from the first, bit for bit.

    python3 tools/k7_determinism.py [--root DIR] [--tag NAME] [--layers N]
        [--launches N] [--rows B ...] [--seq S ...]
        [--plans arrays int8 int4] [--iters N]

It imports `teal_tpu_torch` from `--root` (default: this checkout), so the
same probe runs on another commit's tree unpacked beside it (`git archive
<commit> | tar -x -C build/parent`, then `--root build/parent`). On
Llama-2-7B's widths at `--layers` layers (random bf16 weights from seed 0;
int8: all seven quantized; int4: packed at group 128), with fixed
selection at full caps (every group kept, `block_verify`'s selection), it
runs `token_kernel` `--launches` times for each B of `--rows` (row i a
sequence of its own at position 40 + 4 i) and each S of `--seq` (the
seq_block form: positions 40..40+S-1 of one sequence in cache row 0), each
launch on fresh copies of the same cache of random rows, and counts the
launches whose output or written caches differ from the first launch's
(with the first layer where a cache differs). A form that the tree at
`--root` lacks (an older commit: no seq_block, no quantized rows) is
reported as absent. It then times each case (CUDA events over `--iters`
launches behind a sleep). It prints a line a case, the card's name and
power limit, and last one JSON object. It imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

T_CACHE = 256                    # cache rows
SLEEP_CYCLES = 1_000_000_000     # ~0.5 s of GPU clock: covers the enqueue


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_ms(fn, iters: int) -> float:
    """ms a launch: CUDA events around `iters` launches queued behind a
    sleep kernel, after two launches of warm-up."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run_case(params, cfg, B, seq, launches, iters, gen, device):
    """`launches` launches of one case on the same inputs: (launches that
    differ from the first, first layer whose cache differs or None,
    ms a launch)."""
    import torch

    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import token_block as tb

    L, dt = cfg.n_layers, torch.bfloat16
    lay = params["layers"]
    ws = tuple(lay[n] for n in ("wq", "wk", "wv", "wo", "wgate", "wup",
                                "wdown"))
    caps = (cfg.dim // 128,) * 3 + (cfg.intermediate_size // 128,)
    shape = (L, 1 if seq else B, cfg.n_kv_heads, T_CACHE, 128)
    kc = torch.randn(shape, generator=gen, device=device).to(dt)
    vc = torch.randn(shape, generator=gen, device=device).to(dt)
    pos = torch.tensor([40 + (1 if seq else 4) * i for i in range(B)],
                       dtype=torch.int32, device=device)
    rope = llama.precompute_rope(cfg, T_CACHE, device)
    rows = llama._rope_rows(rope[0], rope[1], pos)
    toks = torch.randint(1, cfg.vocab_size, (B,), generator=gen,
                         device=device)
    h = params["embed"][toks].to(dt)
    th = torch.zeros((L, 7), device=device)
    kw = dict(caps=caps, n_heads=cfg.n_heads, norm_eps=cfg.norm_eps,
              fixed_sel=True)
    if seq:
        kw["seq_block"] = True

    def launch(k, v):
        return tb.token_kernel(h, th, ws, lay["attn_norm"], lay["mlp_norm"],
                               rows, k, v, pos, **kw)
    first, differ, layer = None, 0, None
    for _ in range(launches):
        k, v = kc.clone(), vc.clone()
        out = launch(k, v)
        if first is None:
            first = (out, k, v)
            continue
        if not (torch.equal(out, first[0]) and torch.equal(k, first[1])
                and torch.equal(v, first[2])):
            differ += 1
            bad = [l for l in range(L) if not (torch.equal(k[l], first[1][l])
                                               and torch.equal(v[l],
                                                               first[2][l]))]
            if bad:
                layer = bad[0] if layer is None else min(layer, bad[0])
    k, v = kc.clone(), vc.clone()
    ms = kernel_ms(lambda: launch(k, v), iters)
    return differ, layer, ms


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--launches", type=int, default=30)
    ap.add_argument("--rows", type=int, nargs="*", default=[2, 5, 16])
    ap.add_argument("--seq", type=int, nargs="*", default=[2, 5, 8])
    ap.add_argument("--plans", nargs="*", default=["arrays", "int8", "int4"],
                    choices=["arrays", "int8", "int4"])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k7_determinism: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from teal_tpu_torch import _build
    from teal_tpu_torch.config import get_model_config
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import quant
    from teal_tpu_torch.ops import token_block as tb

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.load()
    print(f"[{args.tag}] build {time.perf_counter() - t0:.1f} s from "
          f"{_build.CSRC}")
    has_seq = "seq_block" in inspect.signature(tb.token_kernel).parameters
    cfg = dataclasses.replace(get_model_config("7B"), n_layers=args.layers)
    out = {"card": card_line(), "tag": args.tag, "root": args.root,
           "layers": args.layers, "launches": args.launches, "cases": []}
    for plan in args.plans:
        gen = torch.Generator(device=device).manual_seed(0)
        params = llama.init_params(cfg, gen, torch.bfloat16, device)
        if plan == "int8":
            params = quant.quantize_params_int8(params)
        elif plan == "int4":
            params = quant.pack_int4_params(
                quant.quantize_params_int4(params, 128), 128)
        cases = ([("rows", B) for B in args.rows]
                 + [("seq", S) for S in args.seq])
        for form, B in cases:
            r = dict(plan=plan, form=form, B=B)
            if form == "seq" and not has_seq:
                r["absent"] = "no seq_block in this tree"
            else:
                try:
                    r["differ"], r["first_layer"], r["ms"] = run_case(
                        params, cfg, B, form == "seq", args.launches,
                        args.iters, gen, device)
                except (RuntimeError, TypeError, ValueError) as e:
                    r["absent"] = str(e).splitlines()[0][:160]
            out["cases"].append(r)
            if "absent" in r:
                print(f"[{args.tag}] {plan} {form} B {B}: absent "
                      f"({r['absent']})")
            else:
                print(f"[{args.tag}] {plan} {form} B {B}: {r['differ']} of "
                      f"{args.launches - 1} launches differ from the first "
                      f"(first layer {r['first_layer']}); {r['ms']:.4f} ms "
                      f"a launch")
        del params
        torch.cuda.empty_cache()
    print(out["card"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
