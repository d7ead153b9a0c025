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
  5. per-kernel times on the card beside their plain version, the
     library call and the memory bound, printed as one `kernels` JSON line.

The line before the last is the card's name and power limit from
`nvidia-smi`; the last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}`.
"""

from __future__ import annotations

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


def spiky_input(K: int, gen, device, dtype):
    """x whose group scores are 1.05**rank (rank a permutation of the
    groups) over uniform noise in [-0.5, 0.5]: adjacent scores differ by
    5%, so a threshold between them is > 2% from every score."""
    import torch

    nb = K // 128
    x = torch.rand(nb, 128, generator=gen, device=device) - 0.5
    levels = 1.05 ** torch.randperm(nb, generator=gen, device=device).float()
    col = torch.randint(0, 128, (nb,), generator=gen, device=device)
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


def k1_inputs(spec, cfg, K, n_surv, gen, device, dtype, layer):
    import torch

    from teal_tpu_torch.ops.block_gemv import group_scores, selection_input

    x = spiky_input(K, gen, device, dtype)
    xs = selection_input(x, spec["norm"], layer, cfg.norm_eps)
    thr, margin = threshold_for(group_scores(xs.float()[None], 128), n_surv)
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


def reset_launches():
    from teal_tpu_torch.ops.block_gemv import select_gather_gemv
    from teal_tpu_torch.ops.decode_attention import decode_attention

    select_gather_gemv.launches = 0
    decode_attention.launches = 0


def read_launches():
    from teal_tpu_torch.ops.block_gemv import select_gather_gemv
    from teal_tpu_torch.ops.decode_attention import decode_attention

    return select_gather_gemv.launches, decode_attention.launches


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
    k1, k2 = read_launches()
    decoded = len(prompts) * (NEW_TOKENS - 1)
    check_launches(k1, k2, L, decoded)
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


def time_decode_step(params, cfg, th, device, rope, iters: int = 3):
    """One decode `forward` (embedding to logits) at pos 40, sparse main
    path and dense: device time (the sum of kernel times from
    torch.profiler) and wall time per step (host clock, synchronised,
    without the profiler). A step launches more kernels than the launch
    queue holds, so the sleep-queued timing of `cuda_ms` cannot apply."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama

    dt = params["layers"]["wq"].dtype
    tok = torch.tensor([[7]], device=device)
    out = {}
    for kind, sp in (("sparse", SparsityConfig(**MAIN_SP)),
                     ("dense", SparsityConfig())):
        cache = llama.KVCache.init(cfg, 1, MAX_SEQ, dt, device)

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


# --- phase 5: kernel times ------------------------------------------------

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
    launches, speeds, th = end_to_end(params, cfg, caps, device, seed)
    log(f"[e2e] decode tok/s (prompt 40, 32 new tokens, Python loop, no "
        f"CUDA graph): dense {speeds['dense']} sparse {speeds['sparse']} "
        f"on {card}")
    step = time_decode_step(params, cfg, th, device, rope)
    line = time_kernels(params, cfg, caps, device, gen, rope, launches,
                        (e1, e2))
    line["decode_tok_s"] = speeds
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
