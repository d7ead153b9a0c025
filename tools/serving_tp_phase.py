#!/usr/bin/env python3
"""`chip_smoke.py` phase 16 alone on one H100: the server on a tensor-
parallel group of two ranks started through torchrun's `env://`, the
kernel-tp leg, and `bench_chained` on one main-path decode step.

    python3 tools/serving_tp_phase.py

Builds the kernels, draws the 7B's bf16 weights from seed 0, times one
main-path decode step with `time_decode_step` and `bench_chained` at zero
thresholds (phase 4's calibration is not run here), frees the weights,
then runs `chip_smoke.serving_tp_phase` (its K1 / K2 rows stand beside
phase 15's times only in the whole script). Prints the phase's results
as one JSON line, then the card's name and power limit. Exits non-zero
when a check fails or no card is present.
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
        print("serving_tp_phase: no CUDA device", file=sys.stderr)
        return 2
    from teal_tpu_torch import _build
    from teal_tpu_torch.config import get_model_config
    from teal_tpu_torch.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    card = cs.card_line()
    _build.load()
    cs.log(f"[build] {_build.build_seconds:.1f} s")
    cfg = get_model_config("7B")
    gen = torch.Generator(device=device).manual_seed(0)
    params = llama.init_params(cfg, gen, torch.bfloat16, device)
    rope = llama.precompute_rope(cfg, cs.MAX_SEQ, device)
    th = llama.zero_thresholds(cfg, device)
    step = cs.time_decode_step(params, cfg, [("sparse", cs.MAIN_SP, 1, th)],
                               device, rope)
    bench = cs.p16_bench_step(params, cfg, th, device, rope, step)
    del params
    torch.cuda.empty_cache()
    entries, res = cs.serving_tp_phase(device, gen, 0, card, [], bench)
    cs.log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(dict(kernels=entries, serving_tp=res, card=card)),
          flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
