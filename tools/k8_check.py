#!/usr/bin/env python3
"""K8 (`csrc/attn_block.cu`, the one-row attention stage) alone on one
H100: its plan, its checks against the plain version and, with `--time`,
its times beside K1's q|k|v call + K2 on the same inputs, in turns;
with `--clusters`, K8 in clusters of 2-8 blocks at the 7B's 32 kv heads,
in turns.

    python3 tools/k8_check.py [--time] [--clusters]

Builds every kernel library (`_build.load`) and prints K8's `ptxas`
report; then runs `chip_smoke.check_k8` (every `K8_CASES` shape, position
and selection regime, and the plan's residency readings) and, with `--time`,
`chip_smoke.time_k8` on random 7B bf16 q|k|v stacks of all 32 layers
(phase 7's K8 entry). `--clusters` plans K8 for SM counts that give the
7B's 32 kv heads clusters of C = 2, 3, 4, 5, 6 and 8 blocks, reads how
many such clusters the card keeps resident, checks each launch against
the plain version and times them in turns (CUDA events, bf16 at G 128 and
32, pos 511 and 2047). Prints the card's name and power limit last.
Exits non-zero when a check fails or no card is present.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SWEEP_C = (2, 3, 4, 5, 6, 8)


def sms_for(C, G, K, Hq, Hkv, cap):
    """The smallest SM count whose K8 plan (bf16 arrays) has clusters of
    C blocks: the plan is made for that count, so the sweep times any C
    whatever the plan's rule."""
    from teal_tpu_torch.ops import attn_block as ab

    for n in range(1, 4097):
        plan = ab.k8_plan(1, 0, G, K, Hq, Hkv, cap, n)
        if plan is not None and plan[0] == C:
            return n
    raise ValueError(f"no SM count gives clusters of {C}")


def clusters_turns(cfg, device, gen):
    """K8 at the 7B's widths (bf16, 32 layers, zero thresholds) in
    clusters of each C of `SWEEP_C` (the plan made for `sms_for(C)` SMs):
    the card's residency reading for that C, one `k8_case`, then every C
    timed in turns (CUDA events). Returns one row a case."""
    from unittest import mock

    import torch

    from teal_tpu_torch import _build
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import attn_block as ab
    from teal_tpu_torch.ops.sparsify import group_capacity

    K, Hq, Hkv, L = cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    x = torch.randn(K, generator=gen, device=device).to(torch.bfloat16)
    thr = torch.zeros((), device=device)
    norm = (1 + 0.1 * torch.randn(L, K, generator=gen, device=device)).to(
        torch.bfloat16)
    ws = cs.k8_weights(K, Hq, Hkv, L, "bf16", 128, gen, device,
                       torch.bfloat16)
    resident = _build.load()["attn_block"].teal_attn_block_clusters
    shipped = ab.k8_plan(1, 0, 128, K, Hq, Hkv, group_capacity(
        K // 128, cs.K8_KEEP), _build.sm_count(device.index))[0]
    rows = []
    for G, p, T in ((128, 511, 512), (32, 511, 512), (128, 2047, 2048)):
        cap = group_capacity(K // G, cs.K8_KEEP)
        kc = torch.randn(L, 1, Hkv, T, 128, generator=gen,
                         device=device).bfloat16()
        vc = torch.randn(L, 1, Hkv, T, 128, generator=gen,
                         device=device).bfloat16()
        rope_t = llama.precompute_rope(cfg, T, device)
        row = torch.stack([rope_t[0][p], rope_t[1][p]])[None].contiguous()
        pos = torch.tensor([p], dtype=torch.int32, device=device)
        sms = {C: sms_for(C, G, K, Hq, Hkv, cap) for C in SWEEP_C}
        smem = ab.k8_plan(1, 0, G, K, Hq, Hkv, cap, sms[SWEEP_C[0]])[2]
        res = {C: resident(1, 0, Hq // Hkv, C, smem) for C in SWEEP_C}

        def under(C, fn):
            with mock.patch.object(_build, "sm_count",
                                   lambda i, _n=sms[C]: _n):
                return fn()

        for C in SWEEP_C:
            under(C, lambda: cs.k8_case(
                f"K8 C={C} G{G} pos={p}", x, thr, ws, 0, cap, norm, kc, vc,
                pos, row, n_heads=Hq, window=None, G=G, fixed=False,
                tol=cs.K8_ROW_TOL["bfloat16"]))

        def reading(C):
            return under(C, lambda: cs.cuda_ms(
                lambda i: ab.attn_block(x, thr, *ws, i % L, cap, norm,
                                        cfg.norm_eps, kc, vc, pos, row,
                                        n_heads=Hq, G=G),
                cs.K8_TIME_ITERS)[0])

        turns = cs.in_turns(SWEEP_C, 2, reading)
        rows.append(dict(G=G, pos=p, T=T, cap=cap, smem=smem, shipped=shipped,
                         resident=res, ms=turns))
        cs.log(f"[clusters] K8 bf16 G{G} pos={p} (T={T}, cap {cap}, {smem} "
               f"shared bytes; the card's plan C = {shipped}): " + "; ".join(
                   f"C = {C} ({Hkv * C} blocks, {res[C]} clusters "
                   f"resident) {[round(t, 5) for t in turns[C]]} ms"
                   for C in SWEEP_C) + " in turns")
        del kc, vc
    return rows


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--clusters", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k8_check: no CUDA device", file=sys.stderr)
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
    k8 = False
    for line in _build.ptxas_report:
        if "Compiling entry function" in line:
            k8 = "attn_block_kernel" in line
        if k8:
            cs.log(f"[build] {line.strip()}")
    cfg = get_model_config("7B")
    gen = torch.Generator(device=device).manual_seed(0)
    res = {"max_abs_err": cs.check_k8(cfg, device, gen)}
    cs.log(f"[k8] checks passed at {time.perf_counter() - t0:.1f} s")
    if args.time:
        params = llama.init_params(cfg, gen, torch.bfloat16, device)
        res["entry"] = cs.time_k8(params, cfg, device, gen,
                                  {"loop": (0, 1)}, res["max_abs_err"])
    if args.clusters:
        res["clusters"] = clusters_turns(cfg, device, gen)
    cs.log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(dict(res, card=card)), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
