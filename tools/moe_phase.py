#!/usr/bin/env python3
"""`chip_smoke.py` phase 10 alone on one H100: Mixtral-8x7B (int8 at 32
layers, bf16 at 8) through K7's MoE form and the K1/K2/K5 loop.

    python3 tools/moe_phase.py

Builds the kernels, then runs `chip_smoke.moe_phase` as the whole script
does after freeing the 7B: K5 and K1's MoE forms against their plain
versions, each copy's token path held to the plain path, K7's MoE form
(plan, every layer held, repeated launches bit-identical, times, K7
against the loop on one call in turns, both decode graphs), three
requests through the main path, tok/s and the kernels' times. Prints the
phase's results as one JSON line, then the card's name and power limit.
Exits non-zero when a check fails or no card is present.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("moe_phase: no CUDA device", file=sys.stderr)
        return 2
    from teal_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    card = cs.card_line()
    _build.load()
    cs.log(f"[build] {_build.build_seconds:.1f} s")
    gen = torch.Generator(device=device).manual_seed(0)
    entries, res = cs.moe_phase(device, gen, 0)
    for r in res.values():
        r.pop("graph", None)
    cs.log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(dict(kernels=entries, moe=res, card=card)), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
