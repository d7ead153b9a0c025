#!/usr/bin/env python3
"""On-card check of the PyTorch port (`teal_tpu_torch`) on one NVIDIA H100.

Run from the repository root:

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (`nvcc`), imports nothing of
JAX, and exits non-zero -- printing no result -- when there is no card,
when the port's package is missing beside it, or when any check fails.

Phases:
  1. build the port's CUDA kernels from `teal_tpu_torch/csrc` (one `nvcc`
     per source, all at once) and print the build time and `ptxas` report;
  2. K1 (`select_gather_gemv`) against its plain version, bf16, at the four
     Llama-2-7B stage shapes, for count < cap, count == cap with groups
     under the threshold, and more survivors than cap: identical kept
     sets, outputs within 1e-4 (fp32 q|k|v) or 2^-7 (bf16 epilogues) of
     the reference's largest magnitude; no group score within 1e-2
     relative of its threshold;
  3. K2 (`decode_attention`) against its plain version at 7B (Hq=Hkv=32,
     T=512) and at GQA with a window (Hq=32, Hkv=8, window=64), pos in
     {0, 7, 255, 256, 511}: the whole cache after the call equal bit for
     bit (row pos holds the written value), outputs within 1e-2 of the
     reference's largest magnitude;
  4. end to end: `Generator` on the 7B config with bf16 random weights made
     on the card from a seeded `torch.Generator` and the main-path
     `SparsityConfig`, thresholds calibrated on the plain path for one
     token; layer 0 of the kernel path against the plain path (2e-2 of
     the largest magnitude); three greedy requests (prompt lengths 5, 17,
     40; 16 new tokens each) with the launch counts reset just before and
     read just after: K1 4*L and K2 L launches per decoded token; dense
     and sparse decode tok/s;
  5. the layer loop's kernels at the 7B stage shapes of its paths, against
     their plain versions: K1 at G=32 / 64 (path B's four stages, with the
     folded norm on q|k|v and gate|up; the three selection regimes of
     phase 2, identical kept sets, 1e-4 of scale), K3
     (`block_gather_gemv_multi`, path A's four stages, 1 and 8 input
     rows, 1e-4 of scale) and K4 (`row_gather_gemv`, the seven
     projections, survivor count below and above nnz_cap, 2^-7 of scale);
  6. the layer-loop paths end to end on the 7B config: A (top-k at G=32,
     batch 1 and 4), B (threshold at G=32) and C (unstructured gather).
     Thresholds picked on the plain path for one token (group thresholds
     for B, elementwise at the median for C); every layer of the kernel
     path held to the plain path -- the same `layer_forward` with each
     kernel wrapper swapped for its plain version -- on the same layer
     input (2e-2 of the largest magnitude); three greedy requests per
     path with the launch counts reset just before and read just after:
     per decode step A: K3 4*L and K2 L, B: K1 4*L and K2 L, C: K4 7*L;
  7. per-kernel times on the card beside their plain version, the
     library call and the memory bound, the logits head's time, and the
     decode step's device and wall time on every path, printed as one
     `kernels` JSON line.

The line before the last is the card's name and power limit from
`nvidia-smi`; the last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}`.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak
MAIN_SP = dict(enabled=True, kernel="block", block_size=128,
               block_keep_frac=0.5, block_thresholding=True)
TWIN_SP = dict(MAIN_SP, kernel="masked_dense", mode="group")
STAGES = ("qkv", "o", "gate|up", "down")
PROMPT_LENS = (5, 17, 40)
NEW_TOKENS = 16
MAX_SEQ = 512
# the layer loop's sparse decode paths: (SparsityConfig, batch)
LOOP_PATHS = {
    "A": (dict(enabled=True, kernel="block"), 1),
    "A-b4": (dict(enabled=True, kernel="block"), 4),
    "B": (dict(enabled=True, kernel="block", block_size=32,
               block_keep_frac=0.5, block_thresholding=True), 1),
    "C": (dict(enabled=True, kernel="gather"), 1),
}
# kernel launches per layer and decode step on each path: K1, K2, K3, K4
LOOP_LAUNCHES = {"A": (0, 1, 4, 0), "A-b4": (0, 1, 4, 0), "B": (4, 1, 0, 0),
                 "C": (0, 0, 0, 7)}
LOOP_NEW_TOKENS = 8
PROJ_NAMES = ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


SLEEP_CYCLES = 1_000_000_000     # ~0.5 s of GPU clock: covers the enqueue


def cuda_ms(fn, iters: int, warmup: int = 2, queued: bool = True):
    """Milliseconds per call of fn(i): CUDA events around `iters` calls,
    after `warmup` calls.

    queued=True measures the device alone: a sleep kernel holds the stream
    while the host enqueues every call, so the calls then run back to back
    and Python's per-call time stays out of the reading. Returns
    (device ms per call, host ms per call to enqueue). The host time must
    stay under the sleep, or the reading would include host gaps.
    queued=False (for functions that wait for the card themselves, like
    the plain versions) returns (ms per call, same)."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    host = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    dev = start.elapsed_time(end) / iters
    if not queued:
        return dev, dev
    check(host < 300.0, f"enqueue took {host:.1f} ms, longer than the sleep "
          "kernel: the device reading would include host gaps")
    return dev, host / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- phase 2: K1 -------------------------------------------------------

def stage_specs(params, cfg):
    """The four K1 calls of one layer: weights, folded norm, epilogue and
    the threshold column each reads."""
    lay = params["layers"]
    return {
        "qkv": dict(ws=(lay["wq"], lay["wk"], lay["wv"]),
                    norm=lay["attn_norm"], res=False, silu=False, col=0),
        "o": dict(ws=(lay["wo"],), norm=None, res=True, silu=False, col=3),
        "gate|up": dict(ws=(lay["wgate"], lay["wup"]),
                        norm=lay["mlp_norm"], res=False, silu=True, col=4),
        "down": dict(ws=(lay["wdown"],), norm=None, res=True, silu=False,
                     col=6),
    }


def spiky_input(K: int, gen, device, dtype, G: int = 128):
    """x whose G-wide group scores are 1.05**rank (rank a permutation of
    the groups) over uniform noise in [-0.5, 0.5]: adjacent scores differ
    by 5%, so a threshold between them is > 2% from every score."""
    import torch

    nb = K // G
    x = torch.rand(nb, G, generator=gen, device=device) - 0.5
    levels = 1.05 ** torch.randperm(nb, generator=gen, device=device).float()
    col = torch.randint(0, G, (nb,), generator=gen, device=device)
    sign = torch.randint(0, 2, (nb,), generator=gen, device=device) * 2 - 1
    x[torch.arange(nb, device=device), col] = levels * sign
    return x.reshape(K).to(dtype)


def threshold_for(scores, n_surv: int):
    """A threshold with exactly `n_surv` scores above it, halfway (in
    ratio) between two neighbours; returns (thr, least relative margin)."""
    v = scores.float().sort(descending=True).values
    if n_surv >= v.numel():
        thr = float(v[-1]) * 0.9
    else:
        thr = math.sqrt(float(v[n_surv - 1]) * float(v[n_surv]))
    margin = float(((scores.float() - thr).abs() / thr).min())
    return thr, margin


def k1_inputs(spec, cfg, K, n_surv, gen, device, dtype, layer, G=128):
    import torch

    from teal_tpu_torch.ops.block_gemv import group_scores, selection_input

    x = spiky_input(K, gen, device, dtype, G)
    xs = selection_input(x, spec["norm"], layer, cfg.norm_eps)
    thr, margin = threshold_for(group_scores(xs.float()[None], G), n_surv)
    check(margin > 1e-2, f"a group score lies within {margin:.2e} of the "
          "threshold")
    n_out = sum(w.shape[2] for w in spec["ws"])
    res = (torch.randn(n_out, generator=gen, device=device).to(dtype)
           if spec["res"] else None)
    return x, torch.tensor(thr, dtype=torch.float32, device=device), res


def check_k1(params, cfg, caps, device, gen):
    """K1 against its plain version at the four stage shapes, three
    selection regimes each. Returns the largest absolute error."""
    import torch

    from teal_tpu_torch.ops import block_gemv as bg

    layer = cfg.n_layers // 2
    worst = 0.0
    for name, cap in zip(STAGES, caps):
        spec = stage_specs(params, cfg)[name]
        K = spec["ws"][0].shape[1]
        nb = K // 128
        for case, n_surv in (("count<cap", max(1, cap // 2)),
                             ("count==cap", cap),
                             ("overflow", min(nb, cap + max(1, nb // 4)))):
            x, thr, res = k1_inputs(spec, cfg, K, n_surv, gen, device,
                                    params["layers"]["wq"].dtype, layer)
            kw = dict(norm=spec["norm"], norm_eps=cfg.norm_eps, res=res,
                      silu=spec["silu"])
            got, gidx, gcnt = bg.select_gather_gemv(x, thr, spec["ws"],
                                                    layer, cap, **kw)
            want, widx, wcnt = bg.select_gather_gemv_plain(
                x, thr, spec["ws"], layer, cap, **kw)
            n = int(wcnt[0])
            check(n == min(n_surv, cap) and int(gcnt[0]) == n,
                  f"K1 {name} {case}: count {int(gcnt[0])} vs plain {n}, "
                  f"expected {min(n_surv, cap)}")
            check(bool((gidx == widx).all()),
                  f"K1 {name} {case}: kept sets differ")
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            tol = (1e-4 if got.dtype == torch.float32 else 2 ** -7) * scale
            check(err <= tol, f"K1 {name} {case}: max error {err:.3e} > "
                  f"{tol:.3e}")
            worst = max(worst, err)
            log(f"[k1] {name:8s} K={K:5d} N={want.numel():5d} cap={cap:2d} "
                f"{case:10s} kept={n:2d} max_abs_err={err:.3e} "
                f"(scale {scale:.3e})")
    return worst


# --- phase 3: K2 -------------------------------------------------------

def check_k2(cfg, device, gen, rope):
    """K2 against its plain version. Returns the largest absolute error."""
    import torch

    from teal_tpu_torch.ops.decode_attention import (decode_attention,
                                                     decode_attention_plain)

    T, L, layer = MAX_SEQ, 2, 1
    worst = 0.0
    for Hq, Hkv, window in ((cfg.n_heads, cfg.n_kv_heads, None),
                            (32, 8, 64)):
        shape = (L, 1, Hkv, T, 128)
        kc = torch.randn(shape, generator=gen, device=device).bfloat16()
        vc = torch.randn(shape, generator=gen, device=device).bfloat16()
        for p in (0, 7, 255, 256, T - 1):
            q = torch.randn(1, Hq, 128, generator=gen, device=device)
            kn = torch.randn(1, Hkv, 128, generator=gen, device=device)
            vn = torch.randn(1, Hkv, 128, generator=gen, device=device)
            row = torch.stack([rope[0][p], rope[1][p]])[None].contiguous()
            k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            got = decode_attention(q, kn, vn, k1, v1, layer, p,
                                   window=window, rope=row)
            want = decode_attention_plain(
                q, kn, vn, k2, v2, layer,
                torch.tensor([p], dtype=torch.int32, device=device),
                window=window, rope=row)
            check(torch.equal(k1, k2) and torch.equal(v1, v2),
                  f"K2 Hkv={Hkv} pos={p}: caches differ after the write")
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            check(err <= 1e-2 * scale, f"K2 Hkv={Hkv} pos={p}: max error "
                  f"{err:.3e} > {1e-2 * scale:.3e}")
            worst = max(worst, err)
            log(f"[k2] Hq={Hq} Hkv={Hkv} window={window} pos={p:3d} "
                f"max_abs_err={err:.3e} (scale {scale:.3e})")
    return worst


# --- phase 4: end to end ------------------------------------------------

def pick_threshold(scores, cap: int) -> float:
    """A group threshold that keeps 30-50% of the groups (at most cap), in
    the widest ratio gap between neighbouring scores."""
    v = scores.float().sort(descending=True).values.tolist()
    nb = len(v)
    hi = min(cap, nb - 1)
    best = None
    for lo in (max(2, round(0.3 * nb)), 1):
        for n in range(min(lo, hi), hi + 1):
            ratio = v[n - 1] / v[n] if v[n] > 0 else math.inf
            if best is None or ratio > best[0]:
                best = (ratio, n)
        if best[0] >= 1.02:
            break
    n = best[1]
    return math.sqrt(v[n - 1] * v[n]) if v[n] > 0 else v[n - 1] / 2


def calibrate_and_check(params, cfg, cache, tok, pos, rope, caps, device):
    """For one decode token, layer by layer on the plain (masked-dense
    group) path: pick each stage's threshold from the input that stage
    sees given the thresholds before it; then run the kernel path's layer
    (`token_block.layer_decode`, 5 launches) on the same layer input and
    hold its output and written cache rows to the plain layer's within
    2e-2 of their largest magnitude, and its kept counts to [1, cap].

    Returns (thresholds [L, 7], kept counts [L, 4], worst relative error)."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import token_block
    from teal_tpu_torch.ops.block_gemv import group_scores

    twin = SparsityConfig(**TWIN_SP)
    lay = params["layers"]
    ws = tuple(lay[n] for n in
               ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown"))
    th = torch.zeros((cfg.n_layers, 7), dtype=torch.float32, device=device)
    k, v = cache.k.clone(), cache.v.clone()            # plain path
    kk, vk = cache.k.clone(), cache.v.clone()          # kernel path
    cos, sin = rope[0][pos][None, None], rope[1][pos][None, None]
    row = torch.stack([rope[0][pos], rope[1][pos]])[None]
    pos_t = torch.full((1,), pos, dtype=torch.int32, device=device)
    pos_l = pos_t.long()
    h = params["embed"][tok].reshape(1, 1, cfg.dim)
    inputs = ((("self_attn", "h1"), (0, 1, 2), caps[0]),
              (("self_attn", "h2"), (3,), caps[1]),
              (("mlp", "h1"), (4, 5), caps[2]),
              (("mlp", "h2"), (6,), caps[3]))
    counts, worst = [], 0.0
    for i in range(cfg.n_layers):
        lp = {n: w[i] for n, w in lay.items()}
        for (grp, name), cols, cap in inputs:
            _, _, _, got = llama.layer_forward(h, lp, k[i], v[i], pos_l, cos,
                                               sin, cfg, twin, th[i],
                                               capture=True)
            s = group_scores(got[grp][name].reshape(1, -1).float(), 128)
            th[i, list(cols)] = pick_threshold(s, cap)
        want, _, _, _ = llama.layer_forward(h, lp, k[i], v[i], pos_l, cos,
                                            sin, cfg, twin, th[i])
        got = token_block.layer_decode(
            h.reshape(cfg.dim), i, th, ws, lay["attn_norm"],
            lay["mlp_norm"], row, kk, vk, pos_t, caps=caps,
            n_heads=cfg.n_heads, norm_eps=cfg.norm_eps,
            window=cfg.sliding_window, counts=counts)
        for what, g, w in (("hidden", got, want.reshape(-1)),
                           ("k row", kk[i, 0, :, pos], k[i, 0, :, pos]),
                           ("v row", vk[i, 0, :, pos], v[i, 0, :, pos])):
            err = float((g.float() - w.float()).abs().max())
            scale = float(w.float().abs().max())
            check(err <= 2e-2 * scale, f"layer {i} {what}: kernel vs plain "
                  f"max error {err:.3e} > {2e-2 * scale:.3e}")
            worst = max(worst, err / scale)
            if i in (0, cfg.n_layers - 1):
                log(f"[e2e] layer {i} kernel vs plain {what}: "
                    f"max_abs_err={err:.3e} (scale {scale:.3e})")
        h = want
    kept = torch.stack(counts).cpu()                       # [L, 4]
    check(bool((kept >= 1).all()) and all(
        bool((kept[:, j] <= caps[j]).all()) for j in range(4)),
        f"kept counts outside [1, cap]: {kept.tolist()}")
    return th, kept, worst


def _wrappers():
    """Every kernel wrapper, in the order K1, K2, K3, K4."""
    from teal_tpu_torch.ops.block_gemv import (block_gather_gemv_multi,
                                               select_gather_gemv)
    from teal_tpu_torch.ops.decode_attention import decode_attention
    from teal_tpu_torch.ops.gather_gemv import row_gather_gemv

    return (select_gather_gemv, decode_attention, block_gather_gemv_multi,
            row_gather_gemv)


def reset_launches():
    for f in _wrappers():
        f.launches = 0


def read_launches():
    """Launch counts (K1, K2, K3, K4)."""
    return tuple(f.launches for f in _wrappers())


def check_launches(k1: int, k2: int, L: int, decoded: int) -> None:
    check(k1 == 4 * L * decoded and k2 == L * decoded,
          f"launches K1={k1} K2={k2}, expected {4 * L * decoded} and "
          f"{L * decoded} for {decoded} decoded tokens")


def end_to_end(params, cfg, caps, device, seed):
    import numpy as np
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine import Generator
    from teal_tpu_torch.engine.generate import _pad_len
    from teal_tpu_torch.models import llama

    dt = params["layers"]["wq"].dtype
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in PROMPT_LENS]
    sparse = Generator(cfg, params, sp=SparsityConfig(**MAIN_SP),
                       max_seq=MAX_SEQ, cache_dtype=dt, temperature=0.0,
                       device=device)
    dense = Generator(cfg, params, sp=SparsityConfig(), max_seq=MAX_SEQ,
                      cache_dtype=dt, temperature=0.0, device=device)
    L = cfg.n_layers

    # calibration token: dense prefill of the first prompt, then its
    # first decode position
    p0 = prompts[0]
    cache = sparse.new_cache()
    padded = torch.zeros((1, _pad_len(len(p0))), dtype=torch.int64)
    padded[0, :len(p0)] = torch.from_numpy(p0)
    zero = llama.zero_thresholds(cfg, device)
    logits, cache = llama.forward(params, padded.to(device), cache, 0, zero,
                                  cfg=cfg, sp=SparsityConfig(),
                                  rope=sparse.rope)
    tok = int(logits[0, len(p0) - 1].argmax())
    pos = len(p0)
    t0 = time.perf_counter()
    th, kept, worst = calibrate_and_check(params, cfg, cache, tok, pos,
                                          sparse.rope, caps, device)
    log(f"[e2e] thresholds picked and every layer of the kernel path held "
        f"to the plain path (same layer input; worst error {worst:.2e} of "
        f"scale, tolerance 2e-2) in {time.perf_counter() - t0:.2f} s")
    log("[e2e] thresholds (qkv, o, gate|up, down) min/max over layers: "
        + ", ".join(f"{float(th[:, c].min()):.4g}/{float(th[:, c].max()):.4g}"
                    for c in (0, 3, 4, 6)))
    for j, name in enumerate(STAGES):
        log(f"[e2e] kept groups {name:8s}: min {int(kept[:, j].min())} "
            f"max {int(kept[:, j].max())} of cap {caps[j]}")

    # the main path: three requests, counts reset just before
    sparse.generate(prompts[0], 4, thresholds=th)          # warm-up
    dense.generate(prompts[0], 4)
    reset_launches()
    outs = [sparse.generate(p, NEW_TOKENS, thresholds=th) for p in prompts]
    k1, k2, k3, k4 = read_launches()
    decoded = len(prompts) * (NEW_TOKENS - 1)
    check_launches(k1, k2, L, decoded)
    check(k3 == k4 == 0, f"the main path launched K3 {k3} and K4 {k4} times")
    log(f"[e2e] main path: {len(prompts)} requests, {decoded} decoded "
        f"tokens, K1 launches {k1} ({k1 // max(decoded, 1)}/token), "
        f"K2 launches {k2} ({k2 // max(decoded, 1)}/token)")
    for p, (toks, st) in zip(prompts, outs):
        check(toks.shape == (1, len(p) + NEW_TOKENS)
              and bool((toks >= 0).all() and (toks < cfg.vocab_size).all()),
              f"bad tokens {toks.shape}")
        log(f"[e2e] prompt {len(p):2d}: new tokens "
            f"{toks[0, len(p):].tolist()} sparse {st.tokens_per_s:.2f} tok/s")
    # logits of one more sparse step: finite, of the expected shape
    lg, _ = llama.forward(params, torch.tensor([[tok]], device=device),
                          llama.KVCache(cache.k.clone(), cache.v.clone()),
                          pos, th, cfg=cfg, sp=SparsityConfig(**MAIN_SP),
                          rope=sparse.rope)
    check(tuple(lg.shape) == (1, 1, cfg.vocab_size)
          and bool(torch.isfinite(lg).all()), "sparse logits not finite")

    # decode speed, in turns: dense, sparse, sparse, dense
    speeds = {"dense": [], "sparse": []}
    for kind in ("dense", "sparse", "sparse", "dense"):
        g = dense if kind == "dense" else sparse
        _, st = g.generate(prompts[2], 32,
                           thresholds=None if kind == "dense" else th)
        speeds[kind].append(st.tokens_per_s)
    return (k1, k2, decoded), speeds, th


def time_decode_step(params, cfg, runs, device, rope, iters: int = 3):
    """One decode `forward` (embedding to logits) at pos 40 for each run
    (kind, sparsity kwargs, batch, thresholds): device time (the sum of
    kernel times from torch.profiler) and wall time per step (host clock,
    synchronised, without the profiler). A step launches more kernels
    than the launch queue holds, so the sleep-queued timing of `cuda_ms`
    cannot apply."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama

    dt = params["layers"]["wq"].dtype
    out = {}
    for kind, sp_kw, b, th in runs:
        sp = SparsityConfig(**sp_kw)
        tok = torch.full((b, 1), 7, device=device)
        cache = llama.KVCache.init(cfg, b, MAX_SEQ, dt, device)

        def step():
            llama.forward(params, tok, cache, 40, th, cfg=cfg, sp=sp,
                          rope=rope)

        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                step()
            torch.cuda.synchronize()
        # kernel events only: an operator's event, and the span the
        # profiler draws on the device for an annotated operator (e.g.
        # "aten::mm"), repeat the device time of the kernels inside them
        rows = sorted(((e.key, e.self_device_time_total / 1e3 / iters)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)
                       and e.self_device_time_total > 0),
                      key=lambda r: -r[1])
        dev = sum(t for _, t in rows)
        out[kind] = dict(device_ms=dev, wall_ms=wall,
                         idle_share=max(0.0, 1.0 - dev / wall))
        log(f"[time] one {kind} decode step (forward at pos 40): device "
            f"{dev:.3f} ms (sum of kernel times), wall {wall:.3f} ms, "
            f"device idle {out[kind]['idle_share']:.1%}; top: "
            + "; ".join(f"{k[:48]} {t:.3f} ms" for k, t in rows[:4]))
    return out


# --- phase 5: the layer loop's kernels ----------------------------------

def loop_stages(params, cfg):
    """The four projection stages of a layer-loop layer at the default
    block size 32 (paths A and B): weights, folded norm (path B), group
    size (`effective_block_size`: 32, and 64 for down at 7B) and
    capacity at keep 0.5."""
    from teal_tpu_torch.ops.block_gemv import (block_capacity,
                                               effective_block_size)

    lay = params["layers"]
    out = {}
    for name, ws, norm in (
            ("qkv", ("wq", "wk", "wv"), "attn_norm"), ("o", ("wo",), None),
            ("gate|up", ("wgate", "wup"), "mlp_norm"),
            ("down", ("wdown",), None)):
        K = lay[ws[0]].shape[1]
        G = effective_block_size(32, K)
        out[name] = dict(ws=tuple(lay[n] for n in ws), res=False,
                         norm=None if norm is None else lay[norm], G=G,
                         cap=block_capacity(K // G, 0.5))
    return out


def rel_check(what: str, got, want, rel: float) -> float:
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    check(err <= rel * scale, f"{what}: max error {err:.3e} > "
          f"{rel * scale:.3e}")
    return err


def check_k1_groups(params, cfg, device, gen):
    """K1 at G = 32 / 64 (no epilogue, path B's four stages) against its
    plain version, three selection regimes each. Returns the largest
    absolute error."""
    from teal_tpu_torch.ops import block_gemv as bg

    layer = cfg.n_layers // 2
    dt = params["layers"]["wq"].dtype
    worst = 0.0
    for name, st in loop_stages(params, cfg).items():
        K, G, cap = st["ws"][0].shape[1], st["G"], st["cap"]
        nb = K // G
        for case, n_surv in (("count<cap", max(1, cap // 2)),
                             ("count==cap", cap),
                             ("overflow", min(nb, cap + max(1, nb // 4)))):
            x, thr, _ = k1_inputs(st, cfg, K, n_surv, gen, device, dt,
                                  layer, G)
            kw = dict(G=G, norm=st["norm"], norm_eps=cfg.norm_eps)
            got, gidx, gcnt = bg.select_gather_gemv(x, thr, st["ws"], layer,
                                                    cap, **kw)
            want, widx, wcnt = bg.select_gather_gemv_plain(
                x, thr, st["ws"], layer, cap, **kw)
            n = int(wcnt[0])
            check(n == min(n_surv, cap) and int(gcnt[0]) == n,
                  f"K1@G{G} {name} {case}: count {int(gcnt[0])} vs plain "
                  f"{n}, expected {min(n_surv, cap)}")
            check(bool((gidx == widx).all()),
                  f"K1@G{G} {name} {case}: kept sets differ")
            err = rel_check(f"K1@G{G} {name} {case}", got, want, 1e-4)
            worst = max(worst, err)
            log(f"[k1g] {name:8s} G={G:3d} K={K:5d} N={want.numel():5d} "
                f"cap={cap:3d} {case:10s} kept={n:3d} max_abs_err={err:.3e} "
                f"(scale {float(want.abs().max()):.3e})")
    return worst


def check_k3(params, cfg, device, gen):
    """K3 against its plain version at path A's four stages, top-k
    selections of random inputs with 1 and 8 rows. Returns the largest
    absolute error."""
    import torch

    from teal_tpu_torch.ops import block_gemv as bg

    layer = cfg.n_layers // 2
    dt = params["layers"]["wq"].dtype
    worst = 0.0
    for name, st in loop_stages(params, cfg).items():
        K, G, cap = st["ws"][0].shape[1], st["G"], st["cap"]
        for rows in (1, 8):
            x = torch.randn(rows, K, generator=gen, device=device).to(dt)
            idx, xpack = (bg.select_groups(x, G, cap) if rows == 1 else
                          bg.select_groups_batched(x, G, cap))
            got = bg.block_gather_gemv_multi(idx, xpack, st["ws"], layer, G,
                                             rows)
            want = bg.block_gather_gemv_multi_plain(idx, xpack, st["ws"],
                                                    layer, G, rows)
            err = rel_check(f"K3 {name} rows={rows}", got, want, 1e-4)
            worst = max(worst, err)
            log(f"[k3] {name:8s} G={G:3d} K={K:5d} N={want.shape[1]:5d} "
                f"k_keep={cap:3d} rows={rows} max_abs_err={err:.3e} "
                f"(scale {float(want.abs().max()):.3e})")
    return worst


def k4_inputs(w, gen, device, quantile: float):
    """A random input row for K4 on w [K, N], its compaction at the
    elementwise threshold at `quantile` of |x| and the survivor count."""
    import torch

    from teal_tpu_torch.ops import gather_gemv as gg

    K = w.shape[0]
    nnz_cap = max(1, int(K * 0.625))
    x = torch.randn(K, generator=gen, device=device).to(w.dtype)
    thr = torch.quantile(x.float().abs(), quantile)
    idx, vals = gg.compact_indices(x, thr, nnz_cap)
    return x, idx, vals, int((x.float().abs() > thr).sum()), nnz_cap


def check_k4(params, cfg, device, gen):
    """K4 against its plain version at the seven projections, with the
    survivor count below and above nnz_cap. Returns the largest absolute
    error."""
    from teal_tpu_torch.ops import gather_gemv as gg

    layer = cfg.n_layers // 2
    worst = 0.0
    for n in PROJ_NAMES:
        w = params["layers"][n][layer]
        for case, q in (("count<cap", 0.5), ("count>cap", 0.25)):
            _, idx, vals, count, nnz_cap = k4_inputs(w, gen, device, q)
            check((count > nnz_cap) == (case == "count>cap"),
                  f"K4 {n} {case}: {count} survivors of cap {nnz_cap}")
            got = gg.row_gather_gemv(idx, vals, w)
            want = gg.row_gather_gemv_plain(idx, vals, w)
            err = rel_check(f"K4 {n} {case}", got, want, 2 ** -7)
            worst = max(worst, err)
            log(f"[k4] {n:5s} K={w.shape[0]:5d} N={w.shape[1]:5d} "
                f"nnz_cap={nnz_cap} {case:9s} survivors={count} "
                f"max_abs_err={err:.3e} (scale "
                f"{float(want.float().abs().max()):.3e})")
    return worst


# --- phase 6: the layer loop's paths end to end ----------------------------

@contextlib.contextmanager
def plain_path():
    """Inside the block, every kernel wrapper the layer loop calls is its
    plain PyTorch version: the same `layer_forward` then runs on the card
    without a kernel of the port."""
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import attn_block
    from teal_tpu_torch.ops import block_gemv as bg
    from teal_tpu_torch.ops import decode_attention as da
    from teal_tpu_torch.ops import gather_gemv as gg

    swaps = [(bg, "select_gather_gemv", bg.select_gather_gemv_plain),
             (attn_block, "select_gather_gemv", bg.select_gather_gemv_plain),
             (bg, "block_gather_gemv_multi",
              bg.block_gather_gemv_multi_plain),
             (gg, "row_gather_gemv", gg.row_gather_gemv_plain),
             (llama, "decode_attention", da.decode_attention_plain),
             (attn_block, "decode_attention", da.decode_attention_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    before = read_launches()
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    check(read_launches() == before, "the plain path launched a kernel")


def prefill(params, cfg, toks, device, rope):
    """Dense prefill of prompts toks [b, t] (numpy). Returns (cache, the
    greedy next tokens [b, 1], their position t)."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine.generate import _pad_len
    from teal_tpu_torch.models import llama

    b, t = toks.shape
    cache = llama.KVCache.init(cfg, b, MAX_SEQ, params["layers"]["wq"].dtype,
                               device)
    padded = torch.zeros((b, _pad_len(t)), dtype=torch.int64)
    padded[:, :t] = torch.from_numpy(toks)
    logits, cache = llama.forward(params, padded.to(device), cache, 0,
                                  llama.zero_thresholds(cfg, device),
                                  cfg=cfg, sp=SparsityConfig(), rope=rope)
    return cache, logits[:, t - 1].argmax(-1)[:, None], t


def loop_thresholds(caps, rule: str, th_row, stage: int):
    """Set the threshold columns of stage `stage` (q|k|v, o, gate|up, down)
    from its captured input: "group" picks a group threshold at the
    stage's group size and capacity (`pick_threshold`), "elem" the
    median |x|."""
    from teal_tpu_torch.ops.block_gemv import (block_capacity,
                                               effective_block_size,
                                               group_scores)

    grp, name, cols = (("self_attn", "h1", (0, 1, 2)),
                       ("self_attn", "h2", (3,)), ("mlp", "h1", (4, 5)),
                       ("mlp", "h2", (6,)))[stage]
    x = caps[grp][name].float().reshape(-1)
    if rule == "group":
        G = effective_block_size(32, x.numel())
        thr = pick_threshold(group_scores(x[None], G),
                             block_capacity(x.numel() // G, 0.5))
    else:
        thr = float(x.abs().median())
    th_row[list(cols)] = thr


def hold_loop_layers(params, cfg, name, cache, toks, pos, rope, device):
    """For one decode step of path `name` on the cache after a prefill:
    pick the thresholds layer by layer on the plain path (B: group
    thresholds, C: elementwise at the median; A needs none), then run
    each layer of the kernel path on the plain path's layer input and
    hold its output and written cache rows to the plain layer's within
    2e-2 of their largest magnitude.

    Returns (thresholds [L, 7], worst relative error)."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama

    sp_kw, b = LOOP_PATHS[name]
    sp = SparsityConfig(**sp_kw)
    rule = {"B": "group", "C": "elem"}.get(name)
    fused = llama.can_fused_decode(1, b, cfg, MAX_SEQ, sp,
                                   sp.kernel == "block")
    th = torch.zeros((cfg.n_layers, 7), dtype=torch.float32, device=device)
    k, v = cache.k.clone(), cache.v.clone()            # plain path
    kk, vk = cache.k.clone(), cache.v.clone()          # kernel path
    pos_t = torch.full((b,), pos, dtype=torch.int64, device=device)
    cos, sin = rope[0][pos_t][:, None], rope[1][pos_t][:, None]
    h = params["embed"][toks].to(params["layers"]["wq"].dtype)
    worst = 0.0
    for i in range(cfg.n_layers):
        lp = {n: w[i] for n, w in params["layers"].items()}
        args = (pos_t, cos, sin, cfg, sp)
        with plain_path():
            for stage in range(4 if rule else 0):
                _, _, _, caps = llama.layer_forward(
                    h, lp, k[i], v[i], *args, th[i], capture=True,
                    fused_attn=fused)
                loop_thresholds(caps, rule, th[i], stage)
            want, _, _, _ = llama.layer_forward(h, lp, k[i], v[i], *args,
                                                th[i], fused_attn=fused)
        got, _, _, _ = llama.layer_forward(h, lp, kk[i], vk[i], *args, th[i],
                                           fused_attn=fused)
        for what, g, w in (("hidden", got, want),
                           ("k rows", kk[i, :, :, pos], k[i, :, :, pos]),
                           ("v rows", vk[i, :, :, pos], v[i, :, :, pos])):
            err = rel_check(f"path {name} layer {i} {what}: kernel vs plain",
                            g, w, 2e-2)
            worst = max(worst, err / float(w.float().abs().max()))
            if i in (0, cfg.n_layers - 1):
                log(f"[loop] {name} layer {i} kernel vs plain {what}: "
                    f"max_abs_err={err:.3e} (scale "
                    f"{float(w.float().abs().max()):.3e})")
        h = want
    return th, worst


def loop_paths(params, cfg, device, seed, rope):
    """Phase 6 for every path of `LOOP_PATHS`. Returns {path: results}."""
    import numpy as np

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine import Generator

    rng = np.random.default_rng(seed + 1)
    dt = params["layers"]["wq"].dtype
    L = cfg.n_layers
    out = {}
    for name, (sp_kw, b) in LOOP_PATHS.items():
        prompts = [rng.integers(1, cfg.vocab_size, (b, n))
                   for n in PROMPT_LENS]
        cache, tok, pos = prefill(params, cfg, prompts[0], device, rope)
        t0 = time.perf_counter()
        th, worst = hold_loop_layers(params, cfg, name, cache, tok, pos,
                                     rope, device)
        log(f"[loop] path {name} (batch {b}): every layer of the kernel path "
            f"held to the plain path (worst error {worst:.2e} of scale, "
            f"tolerance 2e-2) in {time.perf_counter() - t0:.2f} s")
        gen = Generator(cfg, params, sp=SparsityConfig(**sp_kw),
                        max_seq=MAX_SEQ, batch=b, cache_dtype=dt,
                        temperature=0.0, device=device)
        gen.generate(prompts[0], 3, thresholds=th)          # warm-up
        reset_launches()
        outs = [gen.generate(p, LOOP_NEW_TOKENS, thresholds=th)
                for p in prompts]
        counts = read_launches()
        steps = len(prompts) * (LOOP_NEW_TOKENS - 1)
        want = tuple(n * L * steps for n in LOOP_LAUNCHES[name])
        check(counts == want, f"path {name}: launches (K1, K2, K3, K4) "
              f"{counts}, expected {want} for {steps} decode steps")
        for p, (toks, st) in zip(prompts, outs):
            check(toks.shape == (b, p.shape[1] + LOOP_NEW_TOKENS)
                  and bool((toks >= 0).all() and (toks < cfg.vocab_size)
                           .all()), f"path {name}: bad tokens {toks.shape}")
        log(f"[loop] path {name}: {len(prompts)} requests, {steps} decode "
            f"steps, launches per step (K1, K2, K3, K4) "
            f"{tuple(c // steps for c in counts)}; tok/s "
            + ", ".join(f"{st.tokens_per_s * b:.2f}" for _, st in outs)
            + f"; first request's new tokens "
            f"{outs[0][0][0, prompts[0].shape[1]:].tolist()}")
        out[name] = dict(th=th, worst=worst, launches=counts, steps=steps,
                         tok_s=[st.tokens_per_s * b for _, st in outs])
    return out


# --- phase 7: kernel times ------------------------------------------------

def time_kernels(params, cfg, caps, device, gen, rope, launches, errs):
    import torch
    import torch.nn.functional as F

    from teal_tpu_torch.ops import block_gemv as bg
    from teal_tpu_torch.ops.decode_attention import (decode_attention,
                                                     decode_attention_plain)

    dt = params["layers"]["wq"].dtype
    esz = torch.finfo(dt).bits // 8
    L = cfg.n_layers
    stages = []
    for name, cap in zip(STAGES, caps):
        spec = stage_specs(params, cfg)[name]
        K = spec["ws"][0].shape[1]
        x, thr, res = k1_inputs(spec, cfg, K, cap, gen, device, dt, 0)
        kw = dict(norm=spec["norm"], norm_eps=cfg.norm_eps, res=res,
                  silu=spec["silu"])
        ws = spec["ws"]
        n_tot = sum(w.shape[2] for w in ws)
        n_out = ws[0].shape[2] if spec["silu"] else n_tot
        out_bytes = n_out * (esz if (spec["res"] or spec["silu"]) else 4)
        nbytes = (cap * 128 * n_tot * esz + K * esz * (2 if spec["norm"]
                  is not None else 1) + (n_out * esz if spec["res"] else 0)
                  + out_bytes)
        b_ms, b_by = bound_ms(nbytes, 2 * cap * 128 * n_tot)
        # every call reads another layer's weights: no L2 reuse
        k_ms, host_ms = cuda_ms(lambda i: bg.select_gather_gemv(
            x, thr, ws, i % L, cap, **kw), 64)
        p_ms, _ = cuda_ms(lambda i: bg.select_gather_gemv_plain(
            x, thr, ws, i % L, cap, **kw), 5, warmup=1, queued=False)
        x2 = x.reshape(1, K)
        lib_ms = sum(cuda_ms(lambda i, w=w: torch.matmul(x2, w[i % L]),
                             64)[0] for w in ws)
        stages.append(dict(stage=name, K=K, N=n_tot, cap=cap, ms=k_ms,
                           plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=lib_ms, host_ms=host_ms))
        log(f"[time] K1 {name:8s} kernel {k_ms:.4f} ms (host enqueue "
            f"{host_ms:.4f} ms)  plain {p_ms:.4f} ms  torch.matmul full keep"
            f" {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}, "
            f"{nbytes / 1e6:.2f} MB)")

    # K2 at 7B (MHA: SDPA needs no GQA expansion), pos = T-1, a 32-layer
    # cache so that calls do not share L2
    Hq, Hkv, T = cfg.n_heads, cfg.n_kv_heads, MAX_SEQ
    p = T - 1
    kc = torch.randn((L, 1, Hkv, T, 128), generator=gen, device=device).to(dt)
    vc = torch.randn((L, 1, Hkv, T, 128), generator=gen, device=device).to(dt)
    q = torch.randn(1, Hq, 128, generator=gen, device=device)
    kn = torch.randn(1, Hkv, 128, generator=gen, device=device)
    vn = torch.randn(1, Hkv, 128, generator=gen, device=device)
    row = torch.stack([rope[0][p], rope[1][p]])[None].contiguous()
    pos_t = torch.tensor([p], dtype=torch.int32, device=device)
    nbytes = (2 * p * Hkv * 128 * esz + (Hq + 2 * Hkv) * 128 * 4
              + 2 * 128 * 4 + Hq * 128 * esz + 2 * Hkv * 128 * esz)
    a_ms, a_by = bound_ms(nbytes, 4 * Hq * p * 128)
    k2_ms, k2_host = cuda_ms(lambda i: decode_attention(
        q, kn, vn, kc, vc, i % L, pos_t, rope=row), 64)
    k2_plain, _ = cuda_ms(lambda i: decode_attention_plain(
        q, kn, vn, kc, vc, i % L, pos_t, rope=row), 5, warmup=1,
        queued=False)
    q4 = q.to(dt)[:, :, None]
    k2_lib, _ = cuda_ms(lambda i: F.scaled_dot_product_attention(
        q4, kc[i % L][:, :, :p + 1], vc[i % L][:, :, :p + 1]), 64)
    log(f"[time] K2 pos={p} kernel {k2_ms:.4f} ms (host enqueue "
        f"{k2_host:.4f} ms)  plain {k2_plain:.4f} ms  "
        f"SDPA {k2_lib:.4f} ms  bound {a_ms:.4f} ms ({a_by}, "
        f"{nbytes / 1e6:.2f} MB)")

    (k1n, k2n, decoded) = launches
    per_layer = {key: sum(s[key] for s in stages)
                 for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    log(f"[time] kernel time per token, summed over stages and layers: "
        f"{L * (per_layer['ms'] + k2_ms):.3f} ms (bound "
        f"{L * (per_layer['bound_ms'] + a_ms):.3f} ms)")
    return {"kernels": [
        dict(name="select_gather_gemv", route="cuda",
             source="teal_tpu_torch/csrc/select_gather_gemv.cu",
             replaces="teal_tpu/ops/block_gemv.py:761",
             launches=k1n, launches_per_token=k1n / decoded,
             max_abs_err=errs[0], ms=per_layer["ms"],
             kernel_ms=per_layer["ms"],
             plain_ms=per_layer["plain_ms"], bound_ms=per_layer["bound_ms"],
             bound_by=("bytes" if all(s["bound_by"] == "bytes"
                                      for s in stages) else "operations"),
             library_ms=per_layer["library_ms"],
             timed="one layer's four calls (qkv, o, gate|up, down) at "
                   "count == cap, summed", stages=stages),
        dict(name="decode_attention", route="cuda",
             source="teal_tpu_torch/csrc/decode_attention.cu",
             replaces="teal_tpu/ops/decode_attention.py:444",
             launches=k2n, launches_per_token=k2n / decoded,
             max_abs_err=errs[1], ms=k2_ms, kernel_ms=k2_ms,
             plain_ms=k2_plain,
             bound_ms=a_ms, bound_by=a_by, library_ms=k2_lib,
             timed=f"Hq={Hq} Hkv={Hkv} T={T} pos={p}"),
    ]}


def _stage_row(name, **kw):
    log(f"[time] {name:26s} kernel {kw['ms']:.4f} ms (host enqueue "
        f"{kw['host_ms']:.4f} ms)  plain {kw['plain_ms']:.4f} ms  "
        f"torch.matmul full keep {kw['library_ms']:.4f} ms  bound "
        f"{kw['bound_ms']:.4f} ms ({kw['bound_by']}, "
        f"{kw['mbytes']:.2f} MB)")
    return dict(stage=name, **kw)


def _summed(stages, name, source, replaces, launches, steps, err, timed):
    per_layer = {key: sum(s[key] for s in stages)
                 for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, launches_per_token=launches / steps,
                max_abs_err=err, kernel_ms=per_layer["ms"],
                bound_by=("bytes" if all(s["bound_by"] == "bytes"
                                         for s in stages) else "operations"),
                timed=timed, stages=stages, **per_layer)


def time_loop_kernels(params, cfg, device, gen, loop, errs):
    """K1 at G = 32 / 64, K3 and K4 at the stage shapes of their paths, each
    call on another layer's weights (no L2 reuse): kernel, plain version,
    `torch.matmul` at full keep, and the memory bound. Returns the three
    `kernels` entries."""
    import torch

    from teal_tpu_torch.ops import block_gemv as bg
    from teal_tpu_torch.ops import gather_gemv as gg

    dt = params["layers"]["wq"].dtype
    esz = torch.finfo(dt).bits // 8
    L = cfg.n_layers
    k1g, k3 = [], []
    for name, st in loop_stages(params, cfg).items():
        ws, G, cap = st["ws"], st["G"], st["cap"]
        K = ws[0].shape[1]
        n_tot = sum(w.shape[2] for w in ws)
        x2 = torch.randn(1, K, generator=gen, device=device).to(dt)
        lib_ms = sum(cuda_ms(lambda i, w=w: torch.matmul(x2, w[i % L]),
                             64)[0] for w in ws)
        # K1 at G, no epilogue, count == cap (path B)
        x, thr, _ = k1_inputs(st, cfg, K, cap, gen, device, dt, 0, G)
        kw = dict(G=G, norm=st["norm"], norm_eps=cfg.norm_eps)
        nbytes = (cap * G * n_tot * esz + K * esz * (1 if st["norm"] is None
                                                     else 2) + n_tot * 4)
        b_ms, b_by = bound_ms(nbytes, 2 * cap * G * n_tot)
        ms, host = cuda_ms(lambda i: bg.select_gather_gemv(
            x, thr, ws, i % L, cap, **kw), 64)
        p_ms, _ = cuda_ms(lambda i: bg.select_gather_gemv_plain(
            x, thr, ws, i % L, cap, **kw), 5, warmup=1, queued=False)
        k1g.append(_stage_row(f"K1 G={G} {name}", K=K, N=n_tot, cap=cap,
                              ms=ms, host_ms=host, plain_ms=p_ms,
                              bound_ms=b_ms, bound_by=b_by,
                              library_ms=lib_ms, mbytes=nbytes / 1e6))
        # K3 at k_keep == cap, 1 row (path A); 4 rows of an 8-row xpack
        # (path A at batch 4) beside it
        row = {}
        for rows in (1, 4):
            xr = torch.randn(rows, K, generator=gen, device=device).to(dt)
            idx, xpack = (bg.select_groups(xr, G, cap) if rows == 1 else
                          bg.select_groups_batched(xr, G, cap))
            nbytes = (cap * G * n_tot * esz + idx.numel() * 4
                      + xpack.numel() * esz + rows * n_tot * 4)
            b_ms, b_by = bound_ms(nbytes, 2 * rows * cap * G * n_tot)
            ms, host = cuda_ms(lambda i: bg.block_gather_gemv_multi(
                idx, xpack, ws, i % L, G, rows), 64)
            p_ms, _ = cuda_ms(lambda i: bg.block_gather_gemv_multi_plain(
                idx, xpack, ws, i % L, G, rows), 5, warmup=1, queued=False)
            row[rows] = dict(ms=ms, host_ms=host, plain_ms=p_ms,
                             bound_ms=b_ms, bound_by=b_by, mbytes=nbytes / 1e6)
        k3.append(_stage_row(f"K3 G={G} {name} rows=1", K=K, N=n_tot,
                             k_keep=cap, library_ms=lib_ms, **row[1],
                             rows4=row[4]))
        log(f"[time] {'K3 rows=4 ' + name:26s} kernel {row[4]['ms']:.4f} ms "
            f" plain {row[4]['plain_ms']:.4f} ms  bound "
            f"{row[4]['bound_ms']:.4f} ms")
    k4 = []
    for n in PROJ_NAMES:
        w3 = params["layers"][n]
        K, N = w3.shape[1:]
        x, idx, vals, count, nnz_cap = k4_inputs(w3[0], gen, device, 0.5)
        rows_read = int((vals != 0).sum())
        nbytes = rows_read * N * esz + nnz_cap * 8 + N * esz
        b_ms, b_by = bound_ms(nbytes, 2 * rows_read * N)
        ms, host = cuda_ms(lambda i: gg.row_gather_gemv(idx, vals,
                                                        w3[i % L]), 64)
        p_ms, _ = cuda_ms(lambda i: gg.row_gather_gemv_plain(
            idx, vals, w3[i % L]), 5, warmup=1, queued=False)
        lib_ms, _ = cuda_ms(lambda i: torch.matmul(x[None], w3[i % L]), 64)
        k4.append(_stage_row(f"K4 {n} ({rows_read} rows)", K=K, N=N,
                             nnz_cap=nnz_cap, rows_read=rows_read, ms=ms,
                             host_ms=host, plain_ms=p_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms,
                             mbytes=nbytes / 1e6))
    src = "teal_tpu_torch/csrc/"
    out = [
        _summed(k1g, "fused_select_gather_gemv", src + "select_gather_gemv.cu",
                "teal_tpu/ops/block_gemv.py:682", loop["B"]["launches"][0],
                loop["B"]["steps"], errs[0],
                "K1 at G=32/64 (path B): one layer's four calls (qkv, o, "
                "gate|up, down) at count == cap, no epilogue, summed"),
        _summed(k3, "block_gather_gemv_multi", src + "block_gather_gemv.cu",
                "teal_tpu/ops/block_gemv.py:354", loop["A"]["launches"][2],
                loop["A"]["steps"], errs[1],
                "path A: one layer's four calls at k_keep == cap, 1 row, "
                "summed"),
        _summed(k4, "row_gather_gemv", src + "row_gather_gemv.cu",
                "teal_tpu/ops/gather_gemv.py:61", loop["C"]["launches"][3],
                loop["C"]["steps"], errs[2],
                "path C: one layer's seven calls, elementwise threshold at "
                "the median |x| (count < nnz_cap), summed"),
    ]
    out[1]["launches_a_b4"] = loop["A-b4"]["launches"][2]
    for e in out:
        log(f"[time] {e['name']}: one layer {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms, torch.matmul {e['library_ms']:.4f} ms, "
            f"bound {e['bound_ms']:.4f} ms")
    return out


def time_lm_head(params, cfg, device, gen):
    """The logits head of one decode step (h [1, 1, dim] -> fp32 logits)."""
    import torch

    from teal_tpu_torch.models import llama

    h = torch.randn(1, 1, cfg.dim, generator=gen, device=device).to(
        params["lm_head"].dtype)
    ms, _ = cuda_ms(lambda i: llama._lm_head(params, h), 64)
    log(f"[time] lm_head (bf16 GEMV, fp32 output) {ms:.4f} ms")
    return ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "teal_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: teal_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from teal_tpu_torch import _build
    from teal_tpu_torch.config import SparsityConfig, get_model_config
    from teal_tpu_torch.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_line()
    log(f"[env] torch {torch.__version__} CUDA {torch.version.cuda} card "
        f"{torch.cuda.get_device_name(0)} ({card})")

    _build.load()
    log(f"[build] {_build.build_seconds:.1f} s")
    for line in _build.ptxas_report:
        log(f"[build] {line.strip()}")

    cfg = get_model_config("7B")
    seed = 0
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen, torch.bfloat16, device)
    torch.cuda.synchronize()
    log(f"[init] 7B bf16 random weights on the card in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    caps = llama.token_path_caps(cfg, SparsityConfig(**MAIN_SP))
    rope = llama.precompute_rope(cfg, MAX_SEQ, device)

    e1 = check_k1(params, cfg, caps, device, gen)
    e2 = check_k2(cfg, device, gen, rope)
    e_loop = (check_k1_groups(params, cfg, device, gen),
              check_k3(params, cfg, device, gen),
              check_k4(params, cfg, device, gen))
    launches, speeds, th = end_to_end(params, cfg, caps, device, seed)
    log(f"[e2e] decode tok/s (prompt 40, 32 new tokens, Python loop, no "
        f"CUDA graph): dense {speeds['dense']} sparse {speeds['sparse']} "
        f"on {card}")
    loop = loop_paths(params, cfg, device, seed, rope)
    step = time_decode_step(
        params, cfg, [("sparse", MAIN_SP, 1, th), ("dense", {}, 1, th)]
        + [(f"path {n}", sp_kw, b, loop[n]["th"])
           for n, (sp_kw, b) in LOOP_PATHS.items()], device, rope)
    line = time_kernels(params, cfg, caps, device, gen, rope, launches,
                        (e1, e2))
    line["kernels"] += time_loop_kernels(params, cfg, device, gen, loop,
                                         e_loop)
    line["lm_head_ms"] = time_lm_head(params, cfg, device, gen)
    line["decode_tok_s"] = speeds
    line["decode_tok_s_loop_paths"] = {n: r["tok_s"] for n, r in loop.items()}
    line["decode_step_ms"] = step
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
