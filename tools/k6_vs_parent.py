#!/usr/bin/env python3
"""K6 (causal flash-attention prefill) of this tree against an older K6,
in turns, on one H100.

    python3 tools/k6_vs_parent.py DIR [--rounds N]

DIR holds the older K6's two sources, as `git show` writes them:

    mkdir -p build/parent_k6
    for f in flash_prefill.cu common.cuh; do
      git show 4275878:teal_tpu_torch/csrc/$f > build/parent_k6/$f; done

Both libraries export the same C entry point (`teal_flash_prefill`), so
the older one is swapped in under the same Python wrapper: the same
checks, arguments and launches.

It
  1. holds both kernels to the plain version a (head, query) row at a
     time (`chip_smoke.check_k6`: bf16 at S = 256, 320, 2048, 2560, MHA
     32/32 and GQA 32/8, 2^-6 a row; fp32 at 256, 1e-4 a row; two calls
     bit-identical);
  2. times, in turns (this, older, older, this) and `--rounds` times
     over, K6 at the four shapes of the kernel table's row 8 (S = 2048
     and 2560, MHA 32/32 and GQA 32/8, bf16, `chip_smoke.K6_SETS` input
     sets in turn), and SDPA (causal, GQA) once a round;
  3. profiles the 2k dense prefill of the 7B (bf16 random weights from
     seed 0; `llama.forward` with `causal_prefill`, embedding to logits)
     in turns: K6's device time (its kernels' sum), the prefill's device
     time (every kernel's sum) and its wall.
Prints a line a reading and, last, one JSON object of them all.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import chip_smoke as cs  # noqa: E402
from older_kernels import build_older  # noqa: E402

TURNS = ("this", "older", "older", "this")
PREFILL = 2048


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set K6's entry point's argtypes (this tree's signature)."""
    from teal_tpu_torch import _build

    fn = lib.teal_flash_prefill
    fn.argtypes = _build.SIGNATURES[("flash_prefill", "teal_flash_prefill")]
    fn.restype = ctypes.c_int
    return lib


def older_k6(src_dir: str) -> ctypes.CDLL:
    """The older K6 built with nvcc into `build/k6_older/`."""
    return bind(build_older(src_dir, "flash_prefill.cu", "k6_older"))


@contextlib.contextmanager
def k6_library(lib):
    """Run K6's wrapper on `lib` inside the block."""
    from teal_tpu_torch import _build

    this = _build.load()["flash_prefill"]
    _build._libs["flash_prefill"] = lib
    try:
        yield
    finally:
        _build._libs["flash_prefill"] = this


def shape_calls(device, gen):
    """{shape: (K6 call fn(i), SDPA call fn(i), flops)} at row 8's four
    shapes, each over `chip_smoke.K6_SETS` input sets in turn."""
    import torch
    import torch.nn.functional as F

    from teal_tpu_torch.ops.flash_prefill import flash_prefill_attention

    out = {}
    for S in cs.K6_TIME_S:
        for Hq, Hkv in cs.K6_HEADS:
            sets = [cs.k6_inputs(S, Hq, Hkv, gen, device, torch.bfloat16)
                    for _ in range(cs.K6_SETS)]

            def k6(i, sets=sets):
                return flash_prefill_attention(*sets[i % len(sets)])

            def sdpa(i, sets=sets):
                return F.scaled_dot_product_attention(
                    *sets[i % len(sets)], is_causal=True, enable_gqa=True)

            out[f"S={S} Hq={Hq} Hkv={Hkv}"] = (
                k6, sdpa, 4 * 128 * Hq * S * (S + 1) / 2)
    return out


def prefill_k6(params, cfg, device, rope):
    """One profiled 2k dense prefill through K6: (K6's device ms, the
    prefill's device ms, its wall ms)."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama

    toks = torch.randint(1, cfg.vocab_size, (1, PREFILL), device=device,
                         generator=torch.Generator(device=device)
                         .manual_seed(1))
    zero = llama.zero_thresholds(cfg, device)

    def step():
        cache = llama.KVCache.init(cfg, 1, PREFILL, torch.bfloat16, device)
        llama.forward(params, toks, cache, 0, zero, cfg=cfg,
                      sp=SparsityConfig(), rope=rope, causal_prefill=True)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    dev, rows = cs.profile_device(step, 2)
    return sum(t for k, t in rows if "flash_prefill" in k), dev, wall


def run(device, libs, rounds: int, seed: int = 0):
    """The readings of `libs` {"this", "older"} (K6 libraries)."""
    import torch

    from teal_tpu_torch.config import get_model_config
    from teal_tpu_torch.models import llama

    gen = torch.Generator(device=device).manual_seed(seed)
    out = {"rounds": rounds}
    for who, lib in libs.items():
        with k6_library(lib):
            out[f"max_abs_err {who}"] = cs.check_k6(device, gen)

    calls = shape_calls(device, gen)
    turns = {name: {who: [] for who in libs} for name in calls}
    sdpa = {name: [] for name in calls}
    for _ in range(rounds):
        for who in TURNS:
            with k6_library(libs[who]):
                for name, (k6, _, _) in calls.items():
                    turns[name][who].append(cs.cuda_ms(k6, 32)[0])
        for name, (_, lib_call, _) in calls.items():
            sdpa[name].append(cs.cuda_ms(lib_call, 32)[0])
    for name, got in turns.items():
        flops = calls[name][2]
        cs.log(f"[k6 turns] {name}: this {got['this']} older {got['older']}"
               f" SDPA {sdpa[name]} ms; this "
               f"{flops / min(got['this']) / 1e9:.1f} TFLOP/s at its best")
    out["turns"], out["sdpa"] = turns, sdpa
    del calls
    torch.cuda.empty_cache()

    cfg = get_model_config("7B")
    params = llama.init_params(cfg, gen, torch.bfloat16, device)
    rope = llama.precompute_rope(cfg, PREFILL, device)
    steps = {w: [] for w in libs}
    for _ in range(rounds):
        for who in TURNS:
            with k6_library(libs[who]):
                steps[who].append(prefill_k6(params, cfg, device, rope))
    for who, got in steps.items():
        cs.log(f"[k6 turns] {PREFILL}-token prefill {who}: K6 device ms "
               f"{[round(k, 4) for k, _, _ in got]}, device ms "
               f"{[round(d, 3) for _, d, _ in got]}, wall ms "
               f"{[round(w, 3) for _, _, w in got]}")
    out["prefill"] = steps
    return out


def main() -> int:
    import torch

    from teal_tpu_torch import _build

    ap = argparse.ArgumentParser()
    ap.add_argument("older", help="directory of the older K6's sources")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k6_vs_parent: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    libs = {"this": _build.load()["flash_prefill"],
            "older": older_k6(args.older)}
    out = run(torch.device("cuda", 0), libs, args.rounds)
    print(card, flush=True)
    print(json.dumps(dict(out, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
