#!/usr/bin/env python3
"""K7 on one H100 against its plain version, at one row and in its rows
form, on a cut of Llama-2-7B's widths (random weights from a seed).

    python3 tools/k7_rows_check.py [--layers N] [--rows B ...]
        [--pos P ...] [--gqa] [--iters N] [--dtypes bf16 fp32] [--no-hold]
        [--plan arrays|int8|int4] [--seq-block]

For each dtype (bf16, fp32), each B of `--rows` (1: the one-row kernel)
and each start position P of `--pos` (row i at P + 4 i, or P - 4 i where
that passes the cache, of 2048 rows of random values), it runs
`token_kernel` and `token_kernel_plain` on the same inputs at thresholds 0 (every group
survives, the first `cap` kept), at small positive thresholds ("half":
0.1 for q|k|v and gate|up, 0.02 / 0.01 for o / down, which random inputs
mostly pass) and at thresholds no group passes ("none": the step's fixed
costs: selection, attention, barriers), and holds the kernel's kept groups equal to the plain
version's, its output and written cache rows within 2e-2 (bf16) or 1e-4
(fp32) of their largest magnitude; then times the kernel (CUDA events
over `--iters` launches) and checks K7's plan in the wrapper against the
kernel's (`teal_token_plan_rows` / `teal_token_plan`). `--gqa` takes 8 kv
heads (GQA 32/8); `--no-hold` times without the plain version (for a
source variant that cuts a part out, whose results are wrong). `--plan
int8` / `int4` quantizes the bf16 weights on the card (all seven int8, or
packed int4 at group 128; fp32 is skipped) and checks their plans
(`teal_token_plan_rows_q` / `teal_token_plan_q`). `--seq-block` runs the
rows as the consecutive positions P..P+B-1 of one sequence in cache row 0
(K7's seq_block form, `block_verify`'s chunk: the fixed selection at full
caps, so only the "zero" thresholds run). It prints a line a case, the
card's name and power limit, and last one JSON object. It imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def check_plan(h, kc, ws, cfg, caps):
    """The wrapper's plan equal to the kernel's for this call's shapes."""
    import torch

    from teal_tpu_torch import _build
    from teal_tpu_torch.ops import token_block as tb

    B = h.shape[0] if h.dim() == 2 else 1
    sms = _build.sm_count(h.device.index)
    out = (ctypes.c_int * 11)()
    code = 1 if h.dtype == torch.bfloat16 else 0
    wplan = tb.k7_weight_plan(ws)
    L, _, Hkv, T, _ = kc.shape
    shape = (cfg.dim, cfg.intermediate_size, cfg.n_heads, Hkv, T, 0,
             max(caps), sms, L, out)
    libs = _build.load()
    if B > 1 and wplan:
        rc = libs["token_decode_rows_quant"].teal_token_plan_rows_q(
            wplan, B, *shape)
    elif B > 1:
        rc = libs["token_decode_rows"].teal_token_plan_rows(code, B, *shape)
    elif wplan:
        rc = libs["token_decode_quant"].teal_token_plan_q(wplan, *shape)
    else:
        rc = libs["token_decode"].teal_token_plan(code, *shape)
    want = tb.token_plan(h, kc, ws, cfg.n_heads, caps)
    cs.check(rc == 0 and want is not None and tuple(out) == tuple(want),
             f"K7 plan B {B}: kernel {rc} {list(out)}, wrapper {want}")
    return want


def run_case(params, cfg, dt, B, pos0, th, gen, device, iters, hold=True,
             seq=False):
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import token_block as tb

    L, T = cfg.n_layers, 2048
    lay = params["layers"]
    ws = tuple(lay[n] for n in cs.PROJ_NAMES)
    caps = ((cfg.dim // 128,) * 3 + (cfg.intermediate_size // 128,) if seq
            else llama.token_path_caps(cfg, SparsityConfig(**cs.MAIN_SP)))
    shape = (L, 1 if seq else B, cfg.n_kv_heads, T, 128)
    kc = torch.randn(shape, generator=gen, device=device).to(dt)
    vc = torch.randn(shape, generator=gen, device=device).to(dt)
    step = 1 if seq else 4 if pos0 + 4 * (B - 1) < T else -4
    pos = torch.tensor([pos0 + step * i for i in range(B)],
                       dtype=torch.int32, device=device)
    rope = llama.precompute_rope(cfg, T, device)
    rows = llama._rope_rows(rope[0], rope[1], pos)
    toks = torch.randint(1, cfg.vocab_size, (B,), generator=gen,
                         device=device)
    h = params["embed"][toks].to(dt)
    if B == 1:
        h = h.reshape(cfg.dim)
    kw = dict(caps=caps, n_heads=cfg.n_heads, norm_eps=cfg.norm_eps,
              fixed_sel=seq, seq_block=seq)
    plan = check_plan(h, kc, ws, cfg, caps)
    sels = [torch.zeros((L, 4, 1 + max(caps)), dtype=torch.int32,
                        device=device) for _ in range(2)]
    caches = [(kc.clone(), vc.clone()) for _ in range(2)]
    if not hold:
        ms, _ = cs.cuda_ms(lambda i: tb.token_kernel(
            h, th, ws, lay["attn_norm"], lay["mlp_norm"], rows, kc, vc, pos,
            **kw), iters)
        return dict(B=B, pos=pos.tolist(), same_kept=None, kept_mean=[],
                    plan=plan._asdict(), ms=ms)
    got = tb.token_kernel(h, th, ws, lay["attn_norm"], lay["mlp_norm"], rows,
                          *caches[0], pos, sel=sels[0], **kw)
    want = tb.token_kernel_plain(h, th, ws, lay["attn_norm"],
                                 lay["mlp_norm"], rows, *caches[1], pos,
                                 sel=sels[1], **kw)
    torch.cuda.synchronize()
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    same = bool(torch.equal(*sels))
    res = dict(B=B, pos=pos.tolist(), same_kept=same,
               kept_mean=sels[0][:, :, 0].float().mean(0).tolist(),
               plan=plan._asdict())
    if same:
        for name, g, w in (("out", got, want), ("k", caches[0][0],
                                                 caches[1][0]),
                           ("v", caches[0][1], caches[1][1])):
            err = float((g.float() - w.float()).abs().max())
            scale = float(w.float().abs().max())
            res[f"{name}_rel"] = err / scale
            cs.check(err <= tol * scale, f"K7 B {B} pos {pos0} {dt}: {name} "
                     f"error {err:.3e} of {scale:.3e}")
    else:
        diff = (sels[0] != sels[1]).nonzero()[:4].tolist()
        print(f"  kept groups differ at (layer, stage, slot) {diff}: "
              f"{sels[0][diff[0][0], diff[0][1]].tolist()} vs "
              f"{sels[1][diff[0][0], diff[0][1]].tolist()}")
    ms, _ = cs.cuda_ms(lambda i: tb.token_kernel(
        h, th, ws, lay["attn_norm"], lay["mlp_norm"], rows, kc, vc, pos,
        **kw), iters)
    res["ms"] = ms
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--rows", type=int, nargs="*", default=[1, 2, 8, 16])
    ap.add_argument("--pos", type=int, nargs="*", default=[40, 2000])
    ap.add_argument("--gqa", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtypes", nargs="*", default=["bf16", "fp32"])
    ap.add_argument("--no-hold", action="store_true")
    ap.add_argument("--plan", choices=["arrays", "int8", "int4"],
                    default="arrays")
    ap.add_argument("--seq-block", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k7_rows_check: no CUDA device", file=sys.stderr)
        return 2
    from teal_tpu_torch import _build
    from teal_tpu_torch.config import get_model_config
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import quant

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    _build.load()
    print(f"[build] {_build.build_seconds:.1f} s")
    cfg = dataclasses.replace(get_model_config("7B"), n_layers=args.layers,
                              **(dict(n_kv_heads=8) if args.gqa else {}))
    out = {"card": cs.card_line(), "cases": [], "plan": args.plan,
           "seq_block": args.seq_block}
    fails = 0
    for dname in args.dtypes:
        dt = torch.bfloat16 if dname == "bf16" else torch.float32
        if args.plan != "arrays" and dt != torch.bfloat16:
            print(f"[{dname}] skipped: {args.plan} weights take a bf16 "
                  "stream")
            continue
        gen = torch.Generator(device=device).manual_seed(0)
        params = llama.init_params(cfg, gen, dt, device)
        if args.plan == "int8":
            params = quant.quantize_params_int8(params)
        elif args.plan == "int4":
            params = quant.pack_int4_params(
                quant.quantize_params_int4(params, 128), 128)
        ths = {"zero": torch.zeros((cfg.n_layers, 7), device=device),
               "half": torch.tensor([[0.1, 0.1, 0.1, 0.02, 0.1, 0.1, 0.01]]
                                    * cfg.n_layers, device=device),
               "none": torch.full((cfg.n_layers, 7), 1e9, device=device)}
        if args.seq_block:            # the fixed selection reads none
            ths = {"zero": ths["zero"]}
        for th_name, th in ths.items():
            for B in args.rows:
                for p in args.pos:
                    try:
                        r = run_case(params, cfg, dt, B, p, th, gen, device,
                                     args.iters, not args.no_hold,
                                     args.seq_block)
                    except Exception as e:      # noqa: BLE001 - reported
                        fails += 1
                        print(f"[{dname} {th_name} B {B} pos {p}] FAILED: "
                              f"{e}")
                        continue
                    r.update(dtype=dname, th=th_name)
                    out["cases"].append(r)
                    print(f"[{dname} {args.plan}"
                          f"{' seq' if args.seq_block else ''} {th_name} B "
                          f"{B} pos {p}] kept equal "
                          f"{r['same_kept']}, out {r.get('out_rel')}, k "
                          f"{r.get('k_rel')}, v {r.get('v_rel')}, "
                          f"{r['ms']:.4f} ms, kept "
                          f"{[round(k, 2) for k in r['kept_mean']]}, plan "
                          f"{tuple(r['plan'].values())}")
        del params
        torch.cuda.empty_cache()
    print(out["card"])
    print(json.dumps(out))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
