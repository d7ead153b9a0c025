#!/usr/bin/env python3
"""K2 (decode attention) of this tree against an older K2, in turns, on
one H100.

    python3 tools/k2_vs_parent.py DIR [--rounds N]

DIR holds the older K2's two sources, as `git show` writes them:

    mkdir -p build/parent_k2
    for f in decode_attention.cu common.cuh; do
      git show 18d1aea:teal_tpu_torch/csrc/$f > build/parent_k2/$f; done

The older library is bound with the C entry point of commit 18d1aea (20
arguments: no split count and no slot groups); a K2 with another entry
point needs another binding in `older_k2`.

At the 7B's shapes (bf16 caches, 32 layers so that calls do not share
L2) it times, in turns (this, older, older, this) and `--rounds` times
over: K2 alone at pos 40 and 511 of a 512-row cache, pos 2047 of a
2048-row one, 16 rows at positions 31..511, seq_block S = 8 at pos 500,
and GQA 32/8 at pos 511 and 2047. Then one main-path decode step (bf16
random weights from seed 0 and `chip_smoke.py`'s phase-4 thresholds) at
pos 40, and at pos 2000 on a 2000-token prompt's cache, with K2's device
time summed over the step by the profiler. Each K2 is first held to the
plain version on every row (`chip_smoke.row_check`). Prints a line a
reading and, last, one JSON object of them all.
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
from older_kernels import build_older  # noqa: E402

TURNS = ("this", "older", "older", "this")


def older_k2(src_dir: str):
    """The older K2 built with nvcc into `build/k2_older/`, as a function
    of `decode_attention`'s arguments."""
    import torch

    fn = build_older(src_dir, "decode_attention.cu",
                     "k2_older").teal_decode_attention
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, I, I, P]
    fn.restype = I

    def call(q, kn, vn, kc, vc, layer, pos, *, rope, window=None,
             seq_block=False):
        B, Hq, D = q.shape
        out = torch.empty((B, Hq, D), dtype=kc.dtype, device=kc.device)
        err = fn(1 if kc.dtype == torch.bfloat16 else 0, q.data_ptr(),
                 kn.data_ptr(), vn.data_ptr(), rope.data_ptr(),
                 kc.data_ptr(), vc.data_ptr(), pos.data_ptr(),
                 out.data_ptr(), B, Hq, kc.shape[2], kc.shape[3], layer,
                 window or 0, 1.0 / D ** 0.5, q.stride(0), kn.stride(0),
                 int(seq_block), torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, f"the older K2 failed to launch: {err}")
        return out

    return call


def k2_inputs(cfg, device, gen, rope):
    """{row: (q, k_new, v_new, kc, vc, pos), kwargs} at the rows timed."""
    import torch

    from teal_tpu_torch.models import llama

    L, Hq, Hkv = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads
    out = {}
    for name, (hq, hkv), p, T in (
            ("pos 40", (Hq, Hkv), 40, 512), ("pos 511", (Hq, Hkv), 511, 512),
            ("pos 2047", (Hq, Hkv), 2047, 2048),
            ("GQA 32/8 pos 511", (32, 8), 511, 512),
            ("GQA 32/8 pos 2047", (32, 8), 2047, 2048)):
        kc, vc = (torch.randn((L, 1, hkv, T, 128), generator=gen,
                              device=device).bfloat16() for _ in range(2))
        q = torch.randn(1, hq, 128, generator=gen, device=device)
        kn, vn = (torch.randn(1, hkv, 128, generator=gen, device=device)
                  for _ in range(2))
        row = torch.stack([rope[0][p], rope[1][p]])[None].contiguous()
        pos = torch.tensor([p], dtype=torch.int32, device=device)
        out[name] = (q, kn, vn, kc, vc, pos), dict(rope=row)
    for name, seq in (("16 rows", False), ("seq_block S=8 pos 500", True)):
        S = 8 if seq else 16
        kc, vc, q, kn, vn = cs.k2_rows_inputs(L, 1 if seq else S, S, Hq, Hkv,
                                              gen, device, torch.bfloat16)
        p0 = cs.MAX_SEQ - 12
        pos = (torch.arange(p0, p0 + S, device=device) if seq else
               torch.linspace(31, cs.MAX_SEQ - 1, S, device=device).round())
        pos = pos.to(torch.int32)
        out[name] = ((q, kn, vn, kc, vc, pos),
                     dict(rope=llama._rope_rows(rope[0], rope[1], pos),
                          seq_block=seq))
    return out


def hold(name, fn, args, kw):
    """fn on layer 0 against the plain version: the cache bit for bit,
    each (row, head) within `chip_smoke.K2_ROW_TOL` of its largest value."""
    import torch

    from teal_tpu_torch.ops.decode_attention import decode_attention_plain

    q, kn, vn, kc, vc, pos = args
    k1, v1, k2, v2 = kc[:1].clone(), vc[:1].clone(), kc[:1].clone(), \
        vc[:1].clone()
    got = fn(q, kn, vn, k1, v1, 0, pos, **kw)
    want = decode_attention_plain(q, kn, vn, k2, v2, 0, pos, **kw)
    cs.check(torch.equal(k1, k2) and torch.equal(v1, v2),
             f"{name}: caches differ after the write")
    cs.row_check(name, got, want, cs.K2_ROW_TOL["bfloat16"])


def run(cfg, device, fns, rounds: int):
    """The readings of `fns` {"this", "older"} at `cfg`'s shapes."""
    import numpy as np
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import attn_block

    gen = torch.Generator(device=device).manual_seed(0)
    params = llama.init_params(cfg, gen, torch.bfloat16, device)
    rope = llama.precompute_rope(cfg, 2048, device)

    rows = {}
    for name, (a, kw) in k2_inputs(cfg, device, gen, rope).items():
        for who, fn in fns.items():
            hold(f"K2 {who} {name}", fn, a, kw)
        got = {who: [] for who in fns}
        for _ in range(rounds):
            for who in TURNS:
                q, kn, vn, kc, vc, pos = a
                ms, _ = cs.cuda_ms(lambda i: fns[who](
                    q, kn, vn, kc, vc, i % cfg.n_layers, pos, **kw), 64)
                got[who].append(ms)
        rows[name] = got
        cs.log(f"[k2 turns] {name}: this {got['this']} older {got['older']}")

    # the main step at pos 40 and at pos 2000 of a long prompt's cache
    sp = SparsityConfig(**cs.MAIN_SP)
    caps = llama.token_path_caps(cfg, sp)
    short = llama.precompute_rope(cfg, cs.MAX_SEQ, device)
    cache, tok, pos = cs.calibration_token(
        params, cfg, cs.main_prompts(cfg, 0)[0],
        llama.KVCache.init(cfg, 1, cs.MAX_SEQ, torch.bfloat16, device),
        short, device)
    th, _, _ = cs.calibrate_and_check(params, cfg, cache, tok, pos, short,
                                      caps, device)
    prompt = np.random.default_rng(11).integers(1, cfg.vocab_size,
                                                cs.LONG_PROMPT)
    padded = torch.zeros((1, 2048), dtype=torch.int64)
    padded[0, :cs.LONG_PROMPT] = torch.from_numpy(prompt)
    lg, long_cache = llama.forward(
        params, padded.to(device),
        llama.KVCache.init(cfg, 1, 2048, torch.bfloat16, device), 0,
        llama.zero_thresholds(cfg, device), cfg=cfg, sp=SparsityConfig(),
        rope=rope, causal_prefill=True)
    long_tok = lg[:, cs.LONG_PROMPT - 1:cs.LONG_PROMPT].argmax(-1)
    del lg
    steps = {}
    this = attn_block.decode_attention
    try:
        for _ in range(rounds):
            for who in TURNS:
                attn_block.decode_attention = fns[who]
                for name, run, kw in (
                        ("step pos 40", ("main", cs.MAIN_SP, 1, th), {}),
                        (f"step pos {cs.LONG_PROMPT}",
                         ("main", cs.MAIN_SP, 1, th, cs.LONG_PROMPT),
                         dict(cache=long_cache, tok=long_tok))):
                    r = cs.time_decode_step(
                        params, cfg, [run], device,
                        rope if kw else short, **kw)["main"]
                    steps.setdefault(name, {w: [] for w in fns})[who].append(
                        {k: r[k] for k in ("k2_ms", "device_ms", "wall_ms")})
    finally:
        attn_block.decode_attention = this
    for name, got in steps.items():
        for who in fns:
            cs.log(f"[k2 turns] {name} {who}: K2 ms a step "
                   f"{[g['k2_ms'] for g in got[who]]}, device ms "
                   f"{[g['device_ms'] for g in got[who]]}")
    return {"rounds": rounds, "k2": rows, "steps": steps}


def main() -> int:
    import torch

    from teal_tpu_torch import _build
    from teal_tpu_torch.config import get_model_config
    from teal_tpu_torch.ops.decode_attention import decode_attention

    ap = argparse.ArgumentParser()
    ap.add_argument("older", help="directory of the older K2's sources")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_vs_parent: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    _build.load()
    out = run(get_model_config("7B"), torch.device("cuda", 0),
              {"this": decode_attention, "older": older_k2(args.older)},
              args.rounds)
    print(card, flush=True)
    print(json.dumps(dict(out, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
