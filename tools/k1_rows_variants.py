#!/usr/bin/env python3
"""Where K1's rows form spends its time: variants of this tree's kernel,
each with one part cut out, timed beside it on one H100.

    python3 tools/k1_rows_variants.py

Each variant is this tree's `csrc/select_gather_gemv.cu` with one text
substitution, built with the port's nvcc flags into `build/k1_variants/`
and swapped in under the same Python wrapper. Cut variants compute wrong
results and serve only as timings:
  - "no arithmetic": the per-group compute (fragments, MMAs, FMAs) skipped;
  - "no input rows": the per-stage copies of the group's input rows and
    gains skipped (the weights still stream);
  - "after scan": the kernel returns after the kept set is known;
  - "after loop": the kernel returns after the last group's arithmetic;
  - "L2 prefetch": the weight rows of the group 4 stages ahead prefetched
    into L2 (a complete kernel).
At the 7B shapes (bf16 random weights from seed 0, each call on another
of the 32 layers), B = 16, count == cap on spiky rows
(`chip_smoke.rows_input`): bf16 as the kernel table times it, `fixed`
without the norm, and `fixed` without the norm at cap 1; int8 and packed
int4 (G = 128) as the table times them. The best of two readings each.
Prints a line a reading and, last, one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import chip_smoke as cs  # noqa: E402
import k1_rows_vs_parent as kt  # noqa: E402
from older_kernels import build_older  # noqa: E402

CSRC = ROOT / "teal_tpu_torch" / "csrc"
SCAN = "  const int count = select_scan(a, scores, nb, idx, idx + a.cap);\n"
LOOP = "    fetch(j + NST - 1);\n    compute(sm + (j % NST) * lay.stage);\n"
LOOP_END = "  cp_async_wait<0>();\n  __syncthreads();\n\n  // 3. fixed-order"
XROWS = ("      unsigned char* xd = st + NW * lay.wslab;\n"
         "      for (int c = tid; c < B * CPG; c += THREADS)")
FETCH = "  auto fetch = [&](int j) {\n    if (j < mine) {\n"
PREFETCH = """  auto fetch = [&](int j) {
    if (j + 4 < mine && tid < WROWS * NW) {
      const unsigned char* pp =
          static_cast<const unsigned char*>(a.w[wsel[tid / WROWS]]) +
          ((layer * krows + static_cast<size_t>(idx[j0 + j + 4]) * WROWS +
            tid % WROWS) * N + off) * WESZ;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(pp));
    }
    if (j < mine) {
"""


def variants(src: str):
    """{name: source text}; each substitution must apply exactly once."""
    subs = {
        "no arithmetic": (LOOP, LOOP.replace(
            "    compute(", "    if (a.K < 0) compute(")),
        "no input rows": (XROWS, XROWS.replace(
            "      for (int c", "      if (a.K < 0) for (int c")),
        "after scan": (SCAN, SCAN + "  if (a.K > 0) return;\n"),
        "after loop": (LOOP_END, LOOP_END.replace(
            "  __syncthreads();\n", "  __syncthreads();\n"
            "  if (a.K > 0) return;\n", 1)),
        "L2 prefetch": (FETCH, PREFETCH),
    }
    out = {}
    for name, (old, new) in subs.items():
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: its anchor is not in the "
                               "kernel source exactly once")
        out[name] = src.replace(old, new)
    return out


def build(name: str, text: str) -> ctypes.CDLL:
    from teal_tpu_torch import _build

    stem = "k1_var_" + name.replace(" ", "_")
    d = ROOT / "build" / "k1_variants" / stem
    d.mkdir(parents=True, exist_ok=True)
    (d / "select_gather_gemv.cu").write_text(text)
    (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
    lib = build_older(str(d), "select_gather_gemv.cu", stem)
    fn = lib.teal_select_gather_gemv
    fn.argtypes = _build.SIGNATURES[("select_gather_gemv",
                                     "teal_select_gather_gemv")]
    fn.restype = ctypes.c_int
    return lib


def timed(libs, calls):
    """{stage: {who: best ms of two readings}}."""
    out = {name: {} for name in calls}
    for who, lib in libs.items():
        with kt.k1_library(lib):
            for name, fn in calls.items():
                out[name][who] = min(cs.cuda_ms(fn, 64)[0] for _ in range(2))
    return out


def main() -> int:
    import torch

    from teal_tpu_torch import _build
    from teal_tpu_torch.config import SparsityConfig, get_model_config
    from teal_tpu_torch.models import llama

    if not torch.cuda.is_available():
        print("k1_rows_variants: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    libs = {"this": _build.load()["select_gather_gemv"]}
    src = (CSRC / "select_gather_gemv.cu").read_text()
    libs.update({name: build(name, text)
                 for name, text in variants(src).items()})
    device = torch.device("cuda", 0)
    cfg = get_model_config("7B")
    gen = torch.Generator(device=device).manual_seed(0)
    params = llama.init_params(cfg, gen, torch.bfloat16, device)
    caps = llama.token_path_caps(cfg, SparsityConfig(**cs.MAIN_SP))
    out = {}
    runs = [("bf16", v) for v in ("table", "fixed, no norm",
                                  "fixed, no norm, cap 1")]
    runs += [("int8", "table"), ("int4-g128", "table")]
    for kind, variant in runs:
        qp = params if kind == "bf16" else cs.quantize_on_card(params,
                                                               kind)[0]
        got = timed(libs, kt.rows_calls(qp, cfg, caps, device, gen, 16,
                                        variant))
        key = f"{kind} {variant}"
        out[key] = got
        for name, r in got.items():
            cs.log(f"[k1 variants] {key:28s} {name:8s} "
                   + "  ".join(f"{w} {ms:.4f}" for w, ms in r.items()))
        layer = {w: sum(got[n][w] for n in got) for w in libs}
        cs.log(f"[k1 variants] {key:28s} layer    "
               + "  ".join(f"{w} {ms:.4f}" for w, ms in layer.items()))
        if qp is not params:
            del qp
            torch.cuda.empty_cache()
    print(card, flush=True)
    print(json.dumps(dict(variants=out, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
