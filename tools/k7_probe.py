#!/usr/bin/env python3
"""K7 (`token_block.token_kernel`) on one H100, alone and beside the K1/K2
loop's decode graph.

Run from the repository root on a machine with one card and the CUDA
toolkit:

    python3 tools/k7_probe.py [--plan bf16|int8|int4] [--layers 32]
        [--turns 2] [--iters 20]

On Llama-2-7B shapes (bf16 weights N(0, 0.02^2) from a seed, with
`--plan int8` or `int4` quantized on the card by `ops/quant` as the
Q8-main and Q4-main parameters are, int4 at quant group 128; a bf16
stream; a zero cache of 512 rows, pos 40, thresholds at which every
stage keeps its cap: the most work a token can take), it prints:
  - the build's seconds and K7's registers and stack from `ptxas`;
  - K7's plan from the kernel (`teal_token_plan`) beside the wrapper's;
  - K7 against its plain version on 2 layers at pos 2047 of a 2048-row
    cache (kept groups equal, the stream within 2e-2 of its scale);
  - in turns, ms a token (CUDA events over `--iters` calls) of K7 and of
    a CUDA graph of the K1/K2 loop (`token_decode(token_fused=False)`)
    on the same inputs, and of a graph holding K7 (one kernel node);
  - the barrier floor (`token_kernel(empty=True)`) and block 0's trace of
    the layer phases (`token_kernel(stamps=)`, `k7_phases`);
then the card's name and power limit. It imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def events_ms(torch, fn, iters: int) -> float:
    """ms a call of fn() from CUDA events around `iters` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_of(torch, fn):
    """A CUDA graph of fn() (two warm-up calls on a side stream first)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    graph.instantiate()
    return graph


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--plan", choices=("bf16", "int8", "int4"),
                    default="bf16")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--save", help="write the trace (int64 [L, width]) "
                    "there as .npy")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k7_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from teal_tpu_torch import _build
    from teal_tpu_torch.ops import block_gemv as bg
    from teal_tpu_torch.ops import quant
    from teal_tpu_torch.ops import token_block as tb
    from teal_tpu_torch.utils.profiling import graph_kernels

    dev = torch.device("cuda", 0)
    _build.load()
    print(f"build {_build.build_seconds:.1f} s")
    for i, line in enumerate(_build.ptxas_report):
        if "token_kernel" in line:
            print(" ".join(_build.ptxas_report[i:i + 3]).replace(
                "ptxas info    : ", ""))
    sms = _build.sm_count(0)

    L, D, I, Hq, Hkv, T = args.layers, 4096, 11008, 32, 32, 512
    caps = (16, 16, 16, 43)
    wplan = {"bf16": bg.PLAN_STREAM, "int8": bg.PLAN_INT8,
             "int4": bg.PLAN_INT4}[args.plan]
    out = (ctypes.c_int * 11)()
    if wplan == bg.PLAN_STREAM:
        rc = _build.load()["token_decode"].teal_token_plan(
            1, D, I, Hq, Hkv, T, 0, max(caps), sms, L, 0, 0, out)
    else:
        rc = _build.load()["token_decode_quant"].teal_token_plan_q(
            wplan, D, I, Hq, Hkv, T, 0, max(caps), sms, L, 0, 0, out)
    clusters = tb.k7_clusters(dev, torch.bfloat16, Hq // Hkv, wplan)
    print(f"plan {args.plan}: resident clusters of C blocks: {clusters}")
    want = tb._token_plan(2, D, I, Hq, Hkv, T, None, max(caps), L, sms,
                          clusters, wplan)
    print(f"plan: kernel {rc} {list(out)}, wrapper {want}")

    g = torch.Generator(device=dev).manual_seed(1)
    dt = torch.bfloat16
    ws = tuple((torch.randn(L, k, n, generator=g, device=dev) * 0.02).to(dt)
               for k, n in ((D, D), (D, 128 * Hkv), (D, 128 * Hkv), (D, D),
                            (D, I), (D, I), (I, D)))
    if wplan != bg.PLAN_STREAM:
        names = ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown")
        tree = {"lm_head": ws[0][0], "layers": dict(zip(names, ws))}
        del ws
        tree = (quant.quantize_params_int8(tree) if wplan == bg.PLAN_INT8
                else quant.pack_int4_params(
                    quant.quantize_params_int4(tree, 128), 128))
        ws = tuple(tree["layers"][n] for n in names)
        del tree
        torch.cuda.empty_cache()

    def first(w, n):
        return ({k: v[:n] for k, v in w.items()} if isinstance(w, dict)
                else w[:n])
    na = torch.ones(L, D, device=dev, dtype=dt)
    nm = torch.ones(L, D, device=dev, dtype=dt)
    h = torch.randn(D, generator=g, device=dev).to(dt)
    rope = torch.rand(1, 2, 128, generator=g, device=dev)
    th = torch.zeros(L, 7, device=dev)
    kw = dict(caps=caps, n_heads=Hq)

    # K7 against its plain version on 2 layers at pos 2047 of 2048 rows
    kc = torch.randn(2, 1, Hkv, 2048, 128, generator=g, device=dev).to(dt)
    vc = torch.randn(2, 1, Hkv, 2048, 128, generator=g, device=dev).to(dt)
    p = torch.tensor([2047], dtype=torch.int32, device=dev)
    outs, sels = [], []
    for f in (tb.token_kernel, tb.token_kernel_plain):
        sel = torch.zeros(2, 4, 1 + max(caps), dtype=torch.int32, device=dev)
        outs.append(f(h, th[:2].contiguous(), tuple(first(w, 2) for w in ws),
                      na[:2], nm[:2], rope, kc.clone(), vc.clone(), p,
                      sel=sel, **kw))
        sels.append(sel)
    err = float((outs[0].float() - outs[1].float()).abs().max())
    scale = float(outs[1].float().abs().max())
    ok = torch.equal(*sels) and err <= 2e-2 * scale
    print(f"K7 vs plain, 2 layers at pos 2047: kept groups equal "
          f"{torch.equal(*sels)}, error {err:.3e} of {scale:.3e} "
          f"({'ok' if ok else 'FAILED'})")
    del kc, vc

    kc = torch.zeros(L, 1, Hkv, T, 128, device=dev, dtype=dt)
    vc = torch.zeros_like(kc)
    p = torch.tensor([40], dtype=torch.int32, device=dev)
    args7 = (h, th, ws, na, nm, rope, kc, vc, p)
    k7 = lambda: tb.token_kernel(*args7, **kw)               # noqa: E731
    loop = graph_of(torch, lambda: tb.token_decode(*args7, token_fused=False,
                                                   **kw))
    k7g = graph_of(torch, k7)
    nodes = graph_kernels(k7g)
    print(f"K7's graph: {nodes}")
    for turn in range(args.turns):
        for name, fn in (("K7", k7), ("K1/K2 loop graph", loop.replay),
                         ("K7 graph", k7g.replay)):
            print(f"turn {turn}: {name} {events_ms(torch, fn, args.iters):.4f}"
                  f" ms a token")
    floor = events_ms(torch, lambda: tb.token_kernel(*args7, empty=True,
                                                     **kw), args.iters)
    stamps = tb.token_trace(h, kc, ws, Hq, caps)
    tb.token_kernel(*args7, stamps=stamps, **kw)
    torch.cuda.synchronize()
    print(f"barrier floor {floor:.4f} ms a token")
    if args.save:
        import numpy as np

        np.save(args.save, stamps.cpu().numpy())
    print("the trace, us summed over the layers (block 0's phases: "
          "work/whole; spans; every block's barrier arrivals): " + ", ".join(
              f"{k} {v[0]:.1f}/{v[1]:.1f}" if isinstance(v, tuple)
              else f"{k} {v:.1f}" for k, v in tb.k7_phases(stamps).items()))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
