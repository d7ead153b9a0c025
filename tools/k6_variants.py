#!/usr/bin/env python3
"""Where K6 (causal flash-attention prefill) spends its time: variants of
a K6 source, each with one part cut out, timed beside it on one H100.

    python3 tools/k6_variants.py [--older DIR]

Each variant is K6's `flash_prefill.cu` with one text substitution, built
with the port's nvcc flags into `build/k6_variants/` and swapped in under
the same Python wrapper. The source is this tree's, or with `--older`
the one in DIR (`git show <commit>:teal_tpu_torch/csrc/flash_prefill.cu`
and `common.cuh`, as `tools/k6_vs_parent.py` takes them). Each body has
its own anchors: `VARIANTS` names the set for the bf16 body of commit
4275878 (`mma.sync`, one block of 4 warps a 64-row query tile) and for
this tree's (`wgmma` on a TMA ring, a producer warp). Cut variants
compute wrong results and serve only as timings:
  - "no loads": the first K / V tiles reused, no further tile is loaded;
  - "no QK^T": the score products skipped (scores stay 0);
  - "no exp2f": the softmax weights taken without the exponential;
  - "no PV": the products with V skipped;
  - "loads only": no QK^T, no PV and no exponential.
At the four shapes of the kernel table's row 8 (S = 2048 and 2560, MHA
32/32 and GQA 32/8, bf16), the best of two readings each. Prints a line
a reading and, last, one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import chip_smoke as cs  # noqa: E402
import k6_vs_parent as kp  # noqa: E402
from older_kernels import build_older  # noqa: E402

CSRC = ROOT / "teal_tpu_torch" / "csrc"

# mma.sync body (commit 4275878): (anchor, replacement) per cut
_MMA_QK = ("        mma16816(s[j], qf[kk], b[0], b[1]);\n"
           "        mma16816(s[j], qf[kk + 1], b[2], b[3]);\n")
_MMA_PV = ("        mma16816(o[2 * jd], pf[kk], b[0], b[1]);\n"
           "        mma16816(o[2 * jd + 1], pf[kk], b[2], b[3]);\n")
_MMA_EXP = "        const float p = exp2f(s[j][e] - m[e >> 1]);\n"
_MMA_LOAD = ("    __syncthreads();  // every warp is done with this K and V "
             "tile\n    if (kt < qt) {\n")
MMA_CUTS = {
    "no loads": [(_MMA_LOAD, _MMA_LOAD.replace("kt < qt", "kt < qt && "
                                               "a.S < 0"))],
    "no QK^T": [(_MMA_QK, "        if (a.S < 0) {\n" + _MMA_QK
                 + "        }\n")],
    "no exp2f": [(_MMA_EXP, _MMA_EXP.replace("exp2f", ""))],
    "no PV": [(_MMA_PV, "        if (a.S < 0) {\n" + _MMA_PV
               + "        }\n")],
}
MMA_CUTS["loads only"] = (MMA_CUTS["no QK^T"] + MMA_CUTS["no exp2f"]
                          + MMA_CUTS["no PV"])

# wgmma body (this tree)
_WG_LOADS = [f"          tma_tile({x}_full(st), base + Layout::{x}(st), "
             f"&{x}m, t.slab_kv, i * TK);\n" for x in "kv"]
_WG_QK = ["        qk_wgmma(sacc, sq, sk);\n",
          "      qk_wgmma(sacc, sq, base + Layout::k(st0));\n"]
_WG_PV = ["        pv_wgmma(oacc, pf, sv);\n",
          "      pv_wgmma(oacc, pf, base + Layout::v(vs));\n"]
_WG_EXP = "      const float p = exp2f(fmaf(s[4 * j + e], c, -mc[e >> 1]));\n"


def _skipped(line: str) -> str:
    """The statement on `line` run only where S < 0 (never)."""
    body = line.lstrip()
    return (line[:len(line) - len(body)] + "{ if (a.S < 0) "
            + body.rstrip("\n") + " }\n")


WG_CUTS = {
    "no loads": [(ld, ld.replace("tma_tile(", "if (kv < NST) tma_tile(")
                  + f"          else mbar_arrive({x}_full(st));\n")
                 for ld, x in zip(_WG_LOADS, "kv")],
    "no QK^T": [(ln, _skipped(ln)) for ln in _WG_QK],
    "no exp2f": [(_WG_EXP, _WG_EXP.replace("exp2f", ""))],
    "no PV": [(ln, _skipped(ln)) for ln in _WG_PV],
}
WG_CUTS["loads only"] = (WG_CUTS["no QK^T"] + WG_CUTS["no exp2f"]
                         + WG_CUTS["no PV"])

VARIANTS = {"mma.sync (4275878)": MMA_CUTS, "wgmma": WG_CUTS}


def variants(src: str):
    """(body name, {variant: source text}) for the body whose anchors
    `src` holds; each substitution must apply exactly once."""
    for body, cuts in VARIANTS.items():
        anchors = {a for subs in cuts.values() for a, _ in subs}
        if all(src.count(a) == 1 for a in anchors):
            out = {}
            for name, subs in cuts.items():
                text = src
                for old, new in subs:
                    text = text.replace(old, new)
                out[name] = text
            return body, out
    raise RuntimeError("no variant set's anchors are each in the K6 source "
                       "exactly once")


def build(name: str, text: str, common: str) -> ctypes.CDLL:
    stem = "k6_var_" + "".join(c if c.isalnum() else "_" for c in name)
    d = ROOT / "build" / "k6_variants" / stem
    d.mkdir(parents=True, exist_ok=True)
    (d / "flash_prefill.cu").write_text(text)
    (d / "common.cuh").write_text(common)
    return kp.bind(build_older(str(d), "flash_prefill.cu", stem))


def main() -> int:
    import torch

    from teal_tpu_torch import _build

    ap = argparse.ArgumentParser()
    ap.add_argument("--older", help="directory of an older K6's sources "
                    "(default: this tree's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k6_variants: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    src_dir = Path(args.older) if args.older else CSRC
    src = (src_dir / "flash_prefill.cu").read_text()
    common = (src_dir / "common.cuh").read_text()
    body, texts = variants(src)
    _build.load()
    libs = {"as is": (kp.older_k6(str(src_dir)) if args.older
                      else _build.load()["flash_prefill"])}
    libs.update({name: build(name, text, common)
                 for name, text in texts.items()})
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    calls = kp.shape_calls(device, gen)
    out = {}
    for name, (k6, sdpa, flops) in calls.items():
        got = {}
        for who, lib in libs.items():
            with kp.k6_library(lib):
                got[who] = min(cs.cuda_ms(k6, 32)[0] for _ in range(2))
        got["SDPA"] = min(cs.cuda_ms(sdpa, 32)[0] for _ in range(2))
        out[name] = got
        cs.log(f"[k6 variants] {body} {name}: "
               + "  ".join(f"{w} {ms:.4f}" for w, ms in got.items())
               + f"  ({flops / got['as is'] / 1e9:.1f} TFLOP/s as is)")
    print(card, flush=True)
    print(json.dumps(dict(body=body, variants=out, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
