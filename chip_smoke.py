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
  2. K1's single-row launch plan in the wrapper equal to the kernel's
     (`check_k1_plan`); K1 (`select_gather_gemv`) against its plain
     version, bf16, at the four
     Llama-2-7B stage shapes, for count < cap, count == cap with groups
     under the threshold, and more survivors than cap: identical kept
     sets, outputs within 1e-4 (fp32 q|k|v) or 2^-7 (bf16 epilogues) of
     the reference's largest magnitude; no group score within 1e-2
     relative of its threshold;
  3. K2 (`decode_attention`) against its plain version at 7B (Hq=Hkv=32,
     T=512) and at GQA with a window (Hq=32, Hkv=8, window=64), bf16 and
     fp32, pos in {0, 1, 7, 255, 256, 511}: the whole cache after the call
     equal bit for bit (row pos holds the written value), two identical
     calls equal bit for bit, each (row, head) output within 2^-6 (bf16)
     or 1e-5 (fp32) of its row's largest value (`k2_check`); the
     wrapper's shared-memory size equal to the kernel's for every plan
     shape (`check_k2_layout`);
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
     (`block_gather_gemv_multi`, path A's four stages, 1, 4 and 8 input
     rows, k_keep == cap, 1 and below the stage's split count; 1-3
     weights of widths 256 / 96 / 32 at G = 32, 64, 128; 1e-4 of scale)
     and K4 (`row_gather_gemv`, the seven projections, survivor count
     below and above nnz_cap; one slot, three slots, no survivor and
     indices outside [0, K) on the wq and wdown shapes; N = 32 and 1056;
     2^-7 of scale), two calls bit-identical everywhere;
  6. the layer-loop paths end to end on the 7B config: A (top-k at G=32,
     batch 1 and 4), B (threshold at G=32) and C (unstructured gather).
     Thresholds picked on the plain path for one token (group thresholds
     for B, elementwise at the median for C); every layer of the kernel
     path held to the plain path -- the same `layer_forward` with each
     kernel wrapper swapped for its plain version -- on the same layer
     input (2e-2 of the largest magnitude; where that fails on one top-k
     flip that rounding explains -- one group moved, the selection's
     input within 2 ulps of the plain path's, measured -- against the
     plain layer run on the kernel path's kept groups, at the same 2e-2);
     three greedy requests per
     path with the launch counts reset just before and read just after:
     per decode step A: K3 4*L and K2 L, B: K1 4*L and K2 L, C: K4 7*L;
  7. per-kernel times on the card beside their plain version, the
     library call and the memory bound (and the GB/s a gather moves), the
     logits head's time, and the decode step's device and wall time on
     every path with K1-K4's shares of it;
  8. the weight-only quantized paths, each copy quantized on the card from
     the bf16 params by the port's `quant` functions and freed after its
     paths: int8 (Q8-main: the main-path config on the token path; Q8-loop:
     path A's config, K3 then the scale), packed int4 at group 128 (Q4-main)
     and at group 64 (Q4-loop: path A's config at G = 64). K1 with the int8
     / int4 plan against its plain version at the token path's stage
     shapes (three selection regimes, int8 scales in the epilogue) and at
     G = 32/64, K3 at path A's stage shapes with 1 and 4 rows (identical
     kept sets; 1e-4 of scale for fp32 outputs, 2^-7 for bf16 epilogues);
     every 7B layer of each path held to its plain path (2e-2 of scale);
     three greedy requests per path (8 new tokens) with the launches per
     step asserted (main paths: K1 4*L + K2 L; loop paths: K3 4*L + K2 L);
     the decode step, the plan kernels' times beside their bound, plain
     version, `torch.matmul` on the bf16 weights and PyTorch's own
     weight-only GEMV, and the quantized logits head; with each plan also
     K1's rows form (phase 9's checks) and a batch-16 token path
     (Q8-main-b16, Q4-main-b16: three requests, 4*L K1 + L K2 a step);
  9. the batched token path and its two entry points, at full depth:
     K1's rows form against its plain version at the token path's stage
     shapes for B in {2, 3, 8, 16} (the three selection regimes on pooled
     scores, `fixed` and no survivor; identical kept sets; 1e-4 / 2^-7 of
     scale; two identical calls bit-identical), K2
     with 16 rows at distinct positions (two at 0) and in its seq_block
     form (S = 8 and 16 at pos 0, 5, 492; MHA and GQA with a window;
     `k2_check`); the continuous-batching server
     (`engine/serving.py`, 16 slots, 24 greedy requests of 5-120 prompt
     and 8-16 new tokens, one-shot and chunked admission), its thresholds
     picked on the plain path and every layer of a B = 16 decode step
     held to the plain path (2e-2), 4*L K1 + L K2 launches per decode
     step at every batch, aggregate decode tok/s and the step's wall and
     device time at B = 1, 8, 16; `block_verify` at S = 4, 8, 12 after a
     prefill, every layer of each chunk held to its plain version,
     ceil(S/8) * (4*L K1 + L K2) launches, logits against the dense
     forward and against its plain version (2e-2 of scale); each K1
     stage's kept count in the timed B = 16 step; the rows forms' times
     beside their bound (and the share of it), plain version and library
     call at B = 8 and 16;
 10. Mixtral-8x7B (MoE) on the token path, after the 7B weights are freed:
     K5's launch plan in the wrapper equal to the kernel's; K5
     (`moe_route`) against its plain version on a bf16 stream and fp32
     routers at Mixtral's D = 4096 with (E, k) = (8, 2), (4, 1), (16, 4),
     (64, 8), at D = 1020 (no multiple of the cluster's 8 blocks) and at
     D = 1000, E = 1 (router slabs off 16 bytes): identical routed
     experts, also where two router columns tie (the lower expert wins);
     xn within one bf16 ulp, with the count of elements that differ at
     all; weights within 1e-6;
     then an int8 copy at all 32 layers and a bf16 copy at 8 layers, full
     width, each built on the card one layer at a time (int8: drawn in
     bf16 and quantized layer by layer; peak memory logged): K1's MoE
     forms against the plain version (pseudo-layer read on the device, up
     to 255; gate|up without a norm; down with the weighted residual;
     three selection regimes; identical kept sets, 2^-7 of scale), every
     layer of one decode step held to the plain token path (thresholds of
     columns 0, 3, 4 picked there, column 6 at 0; 2e-2 of scale; the same
     routed experts), three greedy requests with 6*L K1 + L K2 + L K5
     launches a decoded token (256 at 32 layers), tok/s at keep 0.5
     against 1.0, the decode step's device and wall time, and K5's and the
     MoE K1 calls' times beside their bound and yardsticks (K5 beside an
     empty launch of one block and of an 8-block cluster); K2 at
     Mixtral's heads (GQA 32/8) at pos 511 and 2047 beside SDPA with
     `enable_gqa` and its bound;
 11. long prompts (run before phase 10, on the resident bf16 7B params):
     K6's launch plan in the wrapper equal to the kernel's; K6
     (`flash_prefill_attention`) against its plain version, each
     (head, query) row within a tolerance of its own largest value: bf16
     at S = 256, 320 (a last half query tile), 2048, 2560 (Hq/Hkv 32/32
     and 32/8, 2^-6 a row) and at phase 12's capture shape (B 2, S 2048,
     32/32), fp32 at S = 256 (1e-4 a row), a second
     call bit-identical to the first; every layer of a 2048-token
     prefill through K6 held to the plain path on the same layer input
     (the attention
     output 2^-6 a row, the layer output 2e-2 of scale); `Generator` with
     a 2000-token prompt
     (padded to 2048) and 16 greedy tokens on the main path, asserting
     exactly L K6 launches for the long prefill besides 4*L K1 + L K2 a
     token (the short prompts of phases 4-10 assert none); the 2k
     prefill's seconds and peak memory with K6 against the plain
     `_attention` path, in turns; one main-path decode step at pos 2000
     on the prompt's cache, profiled (K2's share); `eval_ppl` at context 2048 + window
     512 over a 4096-token stream (4 windows), bf16 dense and at phase
     4's thresholds, and on an fp32 copy through K6's fp32 path against
     the plain path (each window's NLL within 1e-4 relative); K6's times
     at S = 2048 and 2560 beside its plain version, SDPA (causal, GQA)
     and its bound, and the share of the bound; K2 at pos 2047 of a
     2048-row cache and K2's split sweep (S forced to 1, 2, 4, 8 at pos
     40, 511 and 2047, 7B heads);
 12. calibration (run after phase 11, on the resident bf16 7B params):
     `calibration.calibrate` over all 32 layers with 2 x 2048 seeded
     tokens (the reference takes 10 x 2048), group sizes 32, 64 and 128,
     each layer's capture attention through K6 (exactly 32 K6 launches
     and no other kernel), and its peak memory; every layer's capture at
     that shape (B 2, S 2048) held to the plain path, its kernel side
     timed alone to split calibrate's seconds into device capture and
     host histograms; uniform group thresholds at
     sparsity 0.5 (`group_thresholds_for_uniform`, G 128) decoding phase
     4's three prompts on the main path (128 K1 + 32 K2 launches a token;
     every layer of a step held to the plain path at those thresholds,
     the kept counts equal to the plain path's, or apart by one group
     whose score lies within two ulps of the threshold, the plain layer
     then run again on the kernel's count; each stage's surviving and
     kept shares printed, not gated); on a 2-layer cut of the same
     weights at full widths with 2048 tokens: `run_greedy` to effective
     sparsity 0.5 (K6 once a layer forward), the greedy elementwise and
     group thresholds, the cut decoded at the greedy group thresholds;
     magnitude channel permutations (G 128) folded in, the permuted
     model's dense logits on an fp32 copy within 1e-4 of scale of the
     unpermuted ones, the permuted cut calibrated and decoded; GPTQ
     (sequential, group 128) with every projection's reconstruction error
     below round-to-nearest's on the same inputs, packed and decoded on
     Q4-main through K1's int4 plan; every decode held layer by layer;
 13. speculative decoding (run after phase 12, on the resident bf16 7B
     params at phase 4's thresholds; `speculative_phase`): self-speculation
     with one shared cache at k = 4, the draft the main-path config (K1's
     single row, K2), the dense verify through `block_verify` (K1's fixed
     rows form, K2's seq_block): phase 4's three prompts and the third
     again with the draft at keep 1.0, 32 tokens each at temperature 0,
     4*L K1 + L K2 launches a draft step and a verify chunk, every emitted
     token the argmax of its verify row and the cache rows of the emitted
     tokens the verify's bit for bit; the first round's verify rerun equal
     to the recorded one, each layer held to the plain path (2e-2), and
     on an fp32 copy held to the plain path (2e-2 of scale); t_round,
     tok/s beside dense decode in turns, mean accepted; `forced_alpha`
     0.5 and 0.9, the realized acceptance within 4 binomial standard
     deviations; `device_loop=True, adaptive_k=True` giving the host
     loop's tokens;
 14. the CLI (`teal_tpu_torch.cli.main` in-process, `cli_phase`) on a
     2-layer cut of the 7B config at full widths, random weights from
     seed 0: generate dense, calibrate (2 x 2048 tokens, 1 K6 launch a
     layer), generate sparse at its thresholds (`--kernel block
     --group-thresholds --block-size 128`), self-speculation with
     --metrics and --profile (a non-empty trace), ppl at 2048 + 512, eval
     of a task file whose contexts pass 128 tokens (K6), quantize int4
     and generate from its store (K1's int4 plan), each command's launch
     counts asserted, its seconds and peak memory printed; and one sparse
     `python -m teal_tpu_torch.cli generate` as a subprocess, exit 0;
 15. parallelism (`teal_tpu_torch/parallel/`, `parallel_phase`, last, with
     no model of the main process on the card): a group of 4 rank
     processes on cuda:0 through gloo (`p15_spawn`; a rank that fails or
     a group that outlives its timeout fails the phase and the other
     ranks are killed), each building its shard of random weights a layer
     at a time from the seed: tp 2 at Llama-2-7B's full widths and 32
     layers (`tp_prefill` of 256 tokens, L K6 launches a rank; 16 greedy
     `tp_kernel_decode` steps at thresholds picked on the plain path, 4*L
     K1 + L K2 a step a rank), packed int4 at tp 2 (the down shard
     5504 = 43 x 128 through K1's int4 plan), tp 4 at batch 1 (down at G
     64) and at batch 4 with per-row positions through K3 (4*L K3 + L K2
     a step), Mixtral's widths at tp 2 in bf16 (qkv and o through K1, each
     routed expert's gate|up and down through K3: 2*L K1 + 4*L K3 + L K2
     a step), on 2-layer cuts; each run's launches counted just around its
     prefill and decode steps, the logits the same on every rank, and one
     more step held layer by layer to the plain path of the same TP
     function on the same input (`p15_hold`: the stream after the o and
     the down reductions and the cache rows within 2e-2 of scale, K1's
     kept counts the plain path's or a flip `explain_count_flip`
     explains, the streams bit-identical across ranks); `sp_prefill` of
     2048 tokens at sp 2 and `pp_forward` at pp 2 (4 layers, 2
     microbatches), fp32, held to single-device prefill / `forward`
     within 1e-4 of scale; then NCCL at world size 1 in this process (one
     `tp_kernel_decode` step held to the layer loop, 2e-2); then, alone
     on the card, K1 at the tp 2 and tp 4 stage shapes against its plain
     version (three selection regimes) and timed beside its bound and
     `torch.matmul` at full keep, K2 at 16 heads beside SDPA and K6 at 16
     heads and S = 2048 beside SDPA; each run's seconds and each rank's
     peak memory, and the tp 2 decode tok/s labelled as a number of 2
     ranks sharing one card through gloo, not a TP speed;
 16. the server on a tp group (`serving_tp_phase`, after phase 15): two
     rank processes started as torchrun starts them on two nodes of one
     rank each (RANK r, WORLD_SIZE 2, LOCAL_RANK 0, GROUP_RANK r,
     MASTER_ADDR / MASTER_PORT), through `env://` and gloo, both on
     cuda:0 from LOCAL_RANK (`p16_spawn`); on `global_mesh(tp=2)`
     `ContinuousBatchingEngine(mesh=...)` at Llama-2-7B's widths and 32
     layers in bf16 (4 slots; a one-shot server of a 300-token prompt,
     padded to 512 and admitted through K6 on the rank's 16 heads, L
     launches a rank, and three short ones; a chunked server,
     `prefill_chunk=16`, of a 40-token prompt and a short one; 8 new
     tokens each): launches counted around each server, every forward's
     stream and every token bit-identical across ranks, the rank's cache
     on 16 heads, the first decode step's logits within 2e-2 of scale of
     the single-process server on the same weights (`p16_first_step`);
     the same on a 2-layer fp32 cut, whose tokens must equal the single
     process's; then the kernel-tp leg (`p15_tp_run` at tp 2 on the cut,
     K1 and K2, held layer by layer); its seconds, peak GiB and tok/s
     (labelled as 2 processes sharing one card); K6 timed at S 512 and 16
     heads; and, on the resident 7B after phase 4, one main-path decode
     step timed by `utils.bench_utils.bench_chained` (16 vs 64 steps)
     beside `time_decode_step`'s reading (`p16_bench_step`);
all printed as one `kernels` JSON line, with the card in it (and the
results of phases 12-16 under "calibration", "speculative", "cli",
"parallel" and "serving_tp");
besides, one main-path
decode step with every kernel swapped for its plain version is profiled
("decode_step_ms" "sparse, plain kernels").

The line before the last is the card's name and power limit from
`nvidia-smi`; the last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Tuple

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
# kernel launches per layer and decode step on each path: K1, K2, K3, K4,
# K5, K6 (K6 runs only in the prefill of a prompt of 256 or more tokens:
# none for these requests' short prompts)
LOOP_LAUNCHES = {"A": (0, 1, 4, 0, 0, 0), "A-b4": (0, 1, 4, 0, 0, 0),
                 "B": (4, 1, 0, 0, 0, 0), "C": (0, 0, 0, 7, 0, 0)}
LOOP_NEW_TOKENS = 8
PROJ_NAMES = ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown")
STAGE_WEIGHTS = {"qkv": ("wq", "wk", "wv"), "o": ("wo",),
                 "gate|up": ("wgate", "wup"), "down": ("wdown",)}
# the weight-only quantized paths: (quantization, SparsityConfig, batch);
# "int4-g128" / "int4-g64": int4 at that group, packed at block size 128 /
# 32 (quant group == gather group: no requantization)
QUANT_PATHS = {
    "Q8-main": ("int8", MAIN_SP, 1),
    "Q8-main-b16": ("int8", MAIN_SP, 16),
    "Q8-loop": ("int8", LOOP_PATHS["A"][0], 1),
    "Q4-main": ("int4-g128", MAIN_SP, 1),
    "Q4-main-b16": ("int4-g128", MAIN_SP, 16),
    "Q4-loop": ("int4-g64", LOOP_PATHS["A"][0], 1),
}
QUANT_LAUNCHES = {"Q8-main": (4, 1, 0, 0, 0, 0),
                  "Q8-main-b16": (4, 1, 0, 0, 0, 0),
                  "Q8-loop": (0, 1, 4, 0, 0, 0), "Q4-main": (4, 1, 0, 0, 0, 0),
                  "Q4-main-b16": (4, 1, 0, 0, 0, 0),
                  "Q4-loop": (0, 1, 4, 0, 0, 0)}


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
    """The four K1 calls of one token-path layer: K1 operands (and the
    int8 scales K1's epilogue applies), folded norm, epilogue and the
    threshold column each reads."""
    from teal_tpu_torch.ops.token_block import stage_operands

    lay = params["layers"]
    ops, sc = stage_operands(tuple(lay[n] for n in PROJ_NAMES))

    def scales(*i):
        return None if sc is None else tuple(sc[j] for j in i)

    return {
        "qkv": dict(ws=ops[0:3], scales=scales(0, 1, 2),
                    norm=lay["attn_norm"], res=False, silu=False, col=0),
        "o": dict(ws=ops[3:4], scales=scales(3), norm=None, res=True,
                  silu=False, col=3),
        "gate|up": dict(ws=ops[4:6], scales=scales(4, 5),
                        norm=lay["mlp_norm"], res=False, silu=True, col=4),
        "down": dict(ws=ops[6:7], scales=scales(6), norm=None, res=True,
                     silu=False, col=6),
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

    from teal_tpu_torch.ops.block_gemv import (_width, group_scores,
                                               selection_input)

    x = spiky_input(K, gen, device, dtype, G)
    xs = selection_input(x, spec["norm"], layer, cfg.norm_eps)
    thr, margin = threshold_for(group_scores(xs.float()[None], G), n_surv)
    check(margin > 1e-2, f"a group score lies within {margin:.2e} of the "
          "threshold")
    n_out = sum(_width(w) for w in spec["ws"])
    res = (torch.randn(n_out, generator=gen, device=device).to(dtype)
           if spec["res"] else None)
    return x, torch.tensor(thr, dtype=torch.float32, device=device), res


def check_k1_plan(cfg, caps):
    """The wrapper's single-row plan (`block_gemv._sgg_plan`: splits,
    cluster, ring stages, shared bytes) equal to the kernel's
    (`teal_sgg_plan`) at the token path's four stage shapes and path B's,
    for both stream types, the three weight plans and caps 1 to nb, on
    this card's SM count."""
    import ctypes

    import torch

    from teal_tpu_torch import _build
    from teal_tpu_torch.ops import block_gemv as bg

    fn = _build.load()["select_gather_gemv"].teal_sgg_plan
    sms = _build.sm_count(torch.cuda.current_device())
    D, I = cfg.dim, cfg.intermediate_size
    kv = cfg.n_kv_heads * cfg.head_dim
    shapes = {"qkv": (D, (D, kv, kv), 1), "o": (D, (D,), 1),
              "gate|up": (D, (I, I), 2), "down": (I, (D,), 1)}
    n = 0
    for name, (K, ns, nw) in shapes.items():
        padded = list(ns) + [0] * (3 - len(ns))
        for G in (128, bg.effective_block_size(32, K)):
            nb = K // G
            for cap in sorted({1, nb // 2, nb, *caps}):
                if cap > nb:
                    continue
                for code, esz in ((0, 4), (1, 2)):
                    for plan in (0, 1, 2):
                        out = (ctypes.c_int * 4)()
                        fn(code, plan, int(nw == 2), G, *padded, len(ns), K,
                           cap, sms, out)
                        want = bg._sgg_plan(esz, plan, nw, G, ns, K, cap, sms)
                        check(want is not None and tuple(out) == want,
                              f"K1 plan at {name} G={G} cap={cap} esz={esz} "
                              f"plan={plan}: the kernel's {tuple(out)}, the "
                              f"wrapper's {want}")
                        n += 1
    log(f"[k1] the wrapper's single-row plan equals the kernel's at all {n} "
        f"(stage, G, cap, type, weight plan) shapes checked ({sms} SMs); "
        "bf16 at G = 128, cap " + ", ".join(
            f"{name} {bg._sgg_plan(2, 0, nw, 128, ns, K, cap, sms)[:2]}"
            for (name, (K, ns, nw)), cap in zip(shapes.items(), caps))
        + " as (S, C)")


def check_k1(params, cfg, caps, device, gen, tag="k1"):
    """K1 against its plain version at the four stage shapes, three
    selection regimes each, with the params' weight plan (and int8's
    scale epilogue). Returns the largest absolute error."""
    import torch

    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import block_gemv as bg

    layer = cfg.n_layers // 2
    worst = 0.0
    for name, cap in zip(STAGES, caps):
        spec = stage_specs(params, cfg)[name]
        K = bg._in_dim(spec["ws"][0])
        nb = K // 128
        for case, n_surv in (("count<cap", max(1, cap // 2)),
                             ("count==cap", cap),
                             ("overflow", min(nb, cap + max(1, nb // 4)))):
            x, thr, res = k1_inputs(spec, cfg, K, n_surv, gen, device,
                                    llama.compute_dtype(params), layer)
            kw = dict(norm=spec["norm"], norm_eps=cfg.norm_eps, res=res,
                      silu=spec["silu"], scales=spec["scales"])
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
            log(f"[{tag}] {name:8s} K={K:5d} N={want.numel():5d} cap={cap:2d} "
                f"{case:10s} kept={n:2d} max_abs_err={err:.3e} "
                f"(scale {scale:.3e})")
    return worst


# --- phase 3: K2 -------------------------------------------------------

# K2 against its plain version, a (row, head) output at a time: bf16 two
# ulps of the row's largest value (each side rounds its output to bf16,
# and the weights e to bf16 before PV from scores summed in other
# orders); fp32 1e-5 of it.
K2_ROW_TOL = {"bfloat16": 2 ** -6, "float32": 1e-5}


def k2_check(what, q, kn, vn, kc, vc, layer, pos, **kw):
    """K2 twice and its plain version on copies of the caches: the whole
    cache after the call equal bit for bit, the two calls' outputs equal
    bit for bit, each (row, head) output within `K2_ROW_TOL` of its row's
    largest value. Returns (largest absolute error, worst row ratio)."""
    import torch

    from teal_tpu_torch.ops.decode_attention import (decode_attention,
                                                     decode_attention_plain)

    if not torch.is_tensor(pos):
        pos = torch.tensor([pos], dtype=torch.int32, device=kc.device)
    outs = []
    for _ in range(2):
        k1, v1 = kc.clone(), vc.clone()
        outs.append(decode_attention(q, kn, vn, k1, v1, layer, pos, **kw))
    k2, v2 = kc.clone(), vc.clone()
    want = decode_attention_plain(q, kn, vn, k2, v2, layer, pos, **kw)
    check(torch.equal(k1, k2) and torch.equal(v1, v2),
          f"{what}: caches differ after the write")
    check(torch.equal(outs[0], outs[1]),
          f"{what}: two identical calls gave different outputs")
    tol = K2_ROW_TOL[str(kc.dtype).split(".")[-1]]
    return row_check(what, outs[0], want, tol)


def check_k2_layout():
    """The wrapper's shared-memory size (`_smem_bytes`, which `_plan`
    fits) equal to the kernel's `Layout::total`
    (`teal_decode_attention_smem`) for every plan shape: both cache
    types, GH 1-8, one row or a seq_block group of B <= 16 slots, S 1-8,
    short and long T."""
    from teal_tpu_torch import _build
    from teal_tpu_torch.ops import decode_attention as da

    smem = _build.load()["decode_attention"].teal_decode_attention_smem
    n = 0
    for code, esz in ((0, 4), (1, 2)):
        for GH in (1, 2, 4, 8):
            for B in range(1, da.MAX_SEQ_BLOCK + 1):
                for slots, nreb in {(1, 0), *((g, B - 1)
                                              for g in range(1, B + 1))}:
                    for T in (1, 7, 64, 100, 512, 2048, 4096, 12000):
                        for S in (1, 2, 4, 8):
                            want = smem(code, GH, slots, nreb, T, S)
                            check(da._smem_bytes(esz, GH, slots, nreb, T, S)
                                  == want, f"K2 shared memory: the wrapper "
                                  f"and the kernel disagree at esz={esz} "
                                  f"GH={GH} slots={slots} T={T} S={S}")
                            n += 1
    log(f"[k2] the wrapper's shared-memory size equals the kernel's "
        f"layout in all {n} plan shapes checked")


def check_k2(cfg, device, gen, rope):
    """K2 against its plain version (`k2_check`), bf16 and fp32. Returns
    the largest absolute error."""
    import torch

    if device.type == "cuda":
        check_k2_layout()
    T, L, layer = MAX_SEQ, 2, 1
    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        for Hq, Hkv, window in ((cfg.n_heads, cfg.n_kv_heads, None),
                                (32, 8, 64)):
            shape = (L, 1, Hkv, T, 128)
            kc = torch.randn(shape, generator=gen, device=device).to(dt)
            vc = torch.randn(shape, generator=gen, device=device).to(dt)
            for p in (0, 1, 7, T // 2 - 1, T // 2, T - 1):
                q = torch.randn(1, Hq, 128, generator=gen, device=device)
                kn = torch.randn(1, Hkv, 128, generator=gen, device=device)
                vn = torch.randn(1, Hkv, 128, generator=gen, device=device)
                row = torch.stack([rope[0][p], rope[1][p]])[None].contiguous()
                err, ratio = k2_check(f"K2 {dt} Hkv={Hkv} pos={p}", q, kn, vn,
                                      kc, vc, layer, p, window=window,
                                      rope=row)
                if dt == torch.bfloat16:
                    worst = max(worst, err)
                log(f"[k2] {str(dt)[6:]} Hq={Hq} Hkv={Hkv} window={window} "
                    f"pos={p:3d} max_abs_err={err:.3e} worst row "
                    f"{ratio:.2e} of its largest value (tolerance "
                    f"{K2_ROW_TOL[str(dt)[6:]]:g}); two calls identical")
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
    """Every kernel wrapper, in the order K1, K2, K3, K4, K5, K6."""
    from teal_tpu_torch.ops.block_gemv import (block_gather_gemv_multi,
                                               select_gather_gemv)
    from teal_tpu_torch.ops.decode_attention import decode_attention
    from teal_tpu_torch.ops.flash_prefill import flash_prefill_attention
    from teal_tpu_torch.ops.gather_gemv import row_gather_gemv
    from teal_tpu_torch.ops.token_block import moe_route

    return (select_gather_gemv, decode_attention, block_gather_gemv_multi,
            row_gather_gemv, moe_route, flash_prefill_attention)


def reset_launches():
    for f in _wrappers():
        f.launches = 0


def read_launches():
    """Launch counts (K1, K2, K3, K4, K5, K6)."""
    return tuple(f.launches for f in _wrappers())


def check_launches(counts, L: int, decoded: int, long_prefills: int = 0):
    """The main path's launch counts (K1, K2, K3, K4, K5, K6) after
    `decoded` token-path decode steps and prefills of which
    `long_prefills` had 256 or more tokens: 4*L K1 and L K2 a token, L K6
    a long prefill (none for a short one), no other kernel."""
    want = (4 * L * decoded, L * decoded, 0, 0, 0, L * long_prefills)
    check(tuple(counts) == want, f"launches (K1, K2, K3, K4, K5, K6) "
          f"{tuple(counts)}, expected {want} for {decoded} decoded tokens "
          f"and {long_prefills} prefill(s) of 256 or more tokens")


def main_prompts(cfg, seed):
    """Phase 4's three seeded prompts (`PROMPT_LENS` tokens)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n) for n in PROMPT_LENS]


def calibration_token(params, cfg, prompt, cache, rope, device):
    """The dense prefill of `prompt` into `cache`: (cache, the next
    token, its position), phase 4's calibration token."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine.generate import _pad_len
    from teal_tpu_torch.models import llama

    padded = torch.zeros((1, _pad_len(len(prompt))), dtype=torch.int64)
    padded[0, :len(prompt)] = torch.from_numpy(prompt)
    zero = llama.zero_thresholds(cfg, device)
    logits, cache = llama.forward(params, padded.to(device), cache, 0, zero,
                                  cfg=cfg, sp=SparsityConfig(), rope=rope)
    return cache, int(logits[0, len(prompt) - 1].argmax()), len(prompt)


def end_to_end(params, cfg, caps, device, seed):
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine import Generator
    from teal_tpu_torch.models import llama

    dt = params["layers"]["wq"].dtype
    prompts = main_prompts(cfg, seed)
    sparse = Generator(cfg, params, sp=SparsityConfig(**MAIN_SP),
                       max_seq=MAX_SEQ, cache_dtype=dt, temperature=0.0,
                       device=device)
    dense = Generator(cfg, params, sp=SparsityConfig(), max_seq=MAX_SEQ,
                      cache_dtype=dt, temperature=0.0, device=device)
    L = cfg.n_layers

    # calibration token: dense prefill of the first prompt, then its
    # first decode position
    cache, tok, pos = calibration_token(params, cfg, prompts[0],
                                        sparse.new_cache(), sparse.rope,
                                        device)
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
    k1, k2, *_ = counts = read_launches()
    decoded = len(prompts) * (NEW_TOKENS - 1)
    check_launches(counts, L, decoded)         # short prompts: no K6
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


def profile_device(fn, iters: int):
    """Device time of fn() per call from torch.profiler: (the sum of the
    kernel times in ms, [(kernel, ms)] largest first). Kernel events only:
    an operator's event, and the span the profiler draws on the device
    for an annotated operator (e.g. "aten::mm"), repeat the device time
    of the kernels inside them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / iters)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    return sum(t for _, t in rows), rows


def time_decode_step(params, cfg, runs, device, rope, iters: int = 3,
                     cache=None, tok=None):
    """One decode `forward` (embedding to logits) for each run (kind,
    sparsity kwargs, batch, thresholds[, positions]; at pos 40 where no
    positions are given) on `cache` with input `tok` (default: an empty
    `MAX_SEQ`-row cache and token 7): device time (the sum of kernel
    times from torch.profiler) and wall time per step (host clock,
    synchronised, without the profiler). A step launches more kernels
    than the launch queue holds, so the sleep-queued timing of `cuda_ms`
    cannot apply."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama

    dt = llama.compute_dtype(params)
    out = {}
    for kind, sp_kw, b, th, *pos in runs:
        sp = SparsityConfig(**sp_kw)
        x = torch.full((b, 1), 7, device=device) if tok is None else tok
        kv = (llama.KVCache.init(cfg, b, MAX_SEQ, dt, device)
              if cache is None else cache)
        pos = pos[0] if pos else 40

        def step():
            llama.forward(params, x, kv, pos, th, cfg=cfg, sp=sp, rope=rope)

        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
        dev, rows = profile_device(step, iters)
        k2 = sum(t for k, t in rows if "attn_kernel" in k)
        k1 = sum(t for k, t in rows if "sgg_" in k)
        k3 = sum(t for k, t in rows if "bgg_" in k)
        k4 = sum(t for k, t in rows if "rgg_kernel" in k)
        k5 = sum(t for k, t in rows if "route_kernel" in k)
        out[kind] = dict(device_ms=dev, wall_ms=wall,
                         idle_share=max(0.0, 1.0 - dev / wall), k2_ms=k2,
                         k1_ms=k1, k3_ms=k3, k4_ms=k4, k5_ms=k5)
        log(f"[time] one {kind} decode step (batch {b}): device "
            f"{dev:.3f} ms (sum of kernel times), wall {wall:.3f} ms, "
            f"device idle {out[kind]['idle_share']:.1%}; K1 {k1:.3f} ms, "
            f"K2 {k2:.3f} ms ({k2 / dev:.1%} of device), K3 {k3:.3f} ms, "
            f"K4 {k4:.3f} ms, K5 {k5:.3f} ms; top: "
            + "; ".join(f"{k[:48]} {t:.3f} ms" for k, t in rows[:4]))
    return out


# --- phase 5: the layer loop's kernels ----------------------------------

def loop_stages(params, cfg):
    """The four projection stages of a layer-loop layer at the default
    block size 32 (paths A and B): kernel operands (int8 without its
    scale, which the layer loop applies after the kernel), folded norm
    (path B), group size (`_shared_group_size`: 32, and 64 for down at 7B;
    64 for packed int4) and capacity at keep 0.5."""
    from teal_tpu_torch.ops import block_gemv as bg

    lay = params["layers"]
    out = {}
    for name, ws, norm in (
            ("qkv", ("wq", "wk", "wv"), "attn_norm"), ("o", ("wo",), None),
            ("gate|up", ("wgate", "wup"), "mlp_norm"),
            ("down", ("wdown",), None)):
        raw, _ = bg._kernel_operands([lay[n] for n in ws])
        K = bg._in_dim(raw[0])
        G = bg._shared_group_size(raw, 32, K)
        out[name] = dict(ws=tuple(raw), res=False,
                         norm=None if norm is None else lay[norm], G=G,
                         cap=bg.block_capacity(K // G, 0.5))
    return out


def rel_check(what: str, got, want, rel: float) -> float:
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    check(err <= rel * scale, f"{what}: max error {err:.3e} > "
          f"{rel * scale:.3e}")
    return err


def row_check(what: str, got, want, rel: float) -> Tuple[float, float]:
    """Per row of the last axis: each row's largest error within `rel` of
    that row's largest |want|. Returns (largest absolute error, largest
    ratio of a row's error to its scale)."""
    diff = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    bad = int((diff > rel * scale).sum())
    ratio = float((diff / scale.clamp_min(1e-30)).max())
    check(bad == 0, f"{what}: {bad} of {diff.numel()} rows with an error "
          f"above {rel:g} of the row's largest value (worst "
          f"{ratio:.3e})")
    return float(diff.max()), ratio


def check_k1_groups(params, cfg, device, gen, tag="k1g"):
    """K1 at G = 32 / 64 (no epilogue, path B's four stages) against its
    plain version, three selection regimes each. Returns the largest
    absolute error."""
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import block_gemv as bg

    layer = cfg.n_layers // 2
    dt = llama.compute_dtype(params)
    worst = 0.0
    for name, st in loop_stages(params, cfg).items():
        K, G, cap = bg._in_dim(st["ws"][0]), st["G"], st["cap"]
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
            log(f"[{tag}] {name:8s} G={G:3d} K={K:5d} N={want.numel():5d} "
                f"cap={cap:3d} {case:10s} kept={n:3d} max_abs_err={err:.3e} "
                f"(scale {float(want.abs().max()):.3e})")
    return worst


def check_k3(params, cfg, device, gen, rows_list=(1, 4, 8), tag="k3"):
    """K3 against its plain version at path A's four stages, top-k
    selections of random inputs with each of `rows_list` rows, at k_keep
    == cap, 1 and below the stage's split count; then 1-3 weights of
    widths 256 / 96 / 32 (a masked half tile) at every G. Two calls
    bit-identical everywhere. Returns the largest absolute error."""
    import torch

    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import block_gemv as bg

    layer = cfg.n_layers // 2
    dt = llama.compute_dtype(params)
    esz = torch.finfo(dt).bits // 8
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    worst = 0.0

    def case(what, ws, K, G, rows, k_keep, lay):
        x = torch.randn(rows, K, generator=gen, device=device).to(dt)
        idx, xpack = (bg.select_groups(x, G, k_keep) if rows == 1 else
                      bg.select_groups_batched(x, G, k_keep))
        got = bg.block_gather_gemv_multi(idx, xpack, ws, lay, G, rows)
        again = bg.block_gather_gemv_multi(idx, xpack, ws, lay, G, rows)
        check(torch.equal(got, again), f"K3 {what}: two calls differ")
        want = bg.block_gather_gemv_multi_plain(idx, xpack, ws, lay, G,
                                                rows)
        return rel_check(f"K3 {what}", got, want, 1e-4), want

    for name, st in loop_stages(params, cfg).items():
        ws, G, cap = st["ws"], st["G"], st["cap"]
        K = bg._in_dim(ws[0])
        for rows in rows_list:
            S = bg._bgg_plan(esz, bg._plan(ws[0]), G,
                             [bg._width(w) for w in ws], cap,
                             1 if rows == 1 else 8, sms)[1]
            for k_keep in sorted({cap, 1, max(1, min(S - 1, K // G))},
                                 reverse=True):
                err, want = case(f"{name} rows={rows} k_keep={k_keep}", ws,
                                 K, G, rows, k_keep, layer)
                worst = max(worst, err)
                log(f"[{tag}] {name:8s} G={G:3d} K={K:5d} "
                    f"N={want.shape[1]:5d} k_keep={k_keep:3d} (S={S}) "
                    f"rows={rows} max_abs_err={err:.3e} (scale "
                    f"{float(want.abs().max()):.3e}); two calls identical")
    small = [(torch.randn(2, 1024, n, generator=gen, device=device) * 0.05)
             .to(dt) for n in (256, 96, 32)]
    for G in bg.GROUP_SIZES:
        for n_w in (1, 2, 3):
            for rows in rows_list:
                err, _ = case(f"widths {[w.shape[2] for w in small[:n_w]]} "
                              f"G={G} rows={rows}", small[:n_w], 1024, G,
                              rows, 3, 1)
                worst = max(worst, err)
    log(f"[{tag}] widths 256 / 96 / 32 (n_w 1-3), G 32 / 64 / 128, k_keep "
        f"3, rows {rows_list}: within 1e-4 of scale, two calls identical")
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


def k4_case(what, idx, vals, w):
    """K4 against its plain version (on the clamped indices) within 2^-7
    of scale, two calls bit-identical. Returns (error, plain result)."""
    import torch

    from teal_tpu_torch.ops import gather_gemv as gg

    got = gg.row_gather_gemv(idx, vals, w)
    again = gg.row_gather_gemv(idx, vals, w)
    check(torch.equal(got, again), f"K4 {what}: two calls differ")
    want = gg.row_gather_gemv_plain(idx.clamp(0, w.shape[0] - 1), vals, w)
    return rel_check(f"K4 {what}", got, want, 2 ** -7), want


def check_k4(params, cfg, device, gen):
    """K4 against its plain version at the seven projections, with the
    survivor count below and above nnz_cap; then the edge cases on the
    wq and wdown shapes (one slot, fewer slots than the cluster's
    splits, no survivor, indices outside [0, K)) and on small widths
    (N = 32, and 1056: a last tile past N). Two calls bit-identical
    everywhere. Returns the largest absolute error."""
    import torch

    layer = cfg.n_layers // 2
    worst = 0.0
    for n in PROJ_NAMES:
        w = params["layers"][n][layer]
        for case, q in (("count<cap", 0.5), ("count>cap", 0.25)):
            _, idx, vals, count, nnz_cap = k4_inputs(w, gen, device, q)
            check((count > nnz_cap) == (case == "count>cap"),
                  f"K4 {n} {case}: {count} survivors of cap {nnz_cap}")
            err, want = k4_case(f"{n} {case}", idx, vals, w)
            worst = max(worst, err)
            log(f"[k4] {n:5s} K={w.shape[0]:5d} N={w.shape[1]:5d} "
                f"nnz_cap={nnz_cap} {case:9s} survivors={count} "
                f"max_abs_err={err:.3e} (scale "
                f"{float(want.float().abs().max()):.3e}); two calls "
                f"identical")
    edges = []
    for n in ("wq", "wdown"):
        w = params["layers"][n][layer]
        K = w.shape[0]
        _, idx, vals, _, _ = k4_inputs(w, gen, device, 0.5)
        bad = torch.randint(-3 * K, 3 * K, idx.shape, generator=gen,
                            device=device, dtype=torch.int32)
        edges += [(f"{n} nnz=1", idx[:1].clone(), vals[:1].clone(), w),
                  (f"{n} nnz=3", idx[:3].clone(), vals[:3].clone(), w),
                  (f"{n} every xc zero", idx, torch.zeros_like(vals), w)]
        if w.is_cuda:          # the kernel clamps; the plain version does not
            edges.append((f"{n} idx outside [0, K)", torch.where(
                torch.arange(idx.numel(), device=device) % 3 == 0, bad, idx),
                vals, w))
    for N in (32, 1056):
        w = (torch.randn(3072, N, generator=gen, device=device) * 0.05).to(
            params["layers"]["wq"].dtype)
        _, idx, vals, _, _ = k4_inputs(w, gen, device, 0.5)
        edges.append((f"N={N}", idx, vals, w))
    for what, idx, vals, w in edges:
        err, _ = k4_case(what, idx, vals, w)
        worst = max(worst, err)
    log(f"[k4] edge cases ({', '.join(e[0] for e in edges)}): within 2^-7 "
        f"of scale, two calls identical")
    return worst


# --- phase 6: the layer loop's paths end to end ----------------------------

@contextlib.contextmanager
def plain_path(k1=None):
    """Inside the block, every kernel wrapper the layer loop and the token
    path call is its plain PyTorch version (K1's is `k1` where given): the
    same `layer_forward` / `layer_decode` then runs on the card without a
    kernel of the port."""
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import attn_block, token_block
    from teal_tpu_torch.ops import block_gemv as bg
    from teal_tpu_torch.ops import decode_attention as da
    from teal_tpu_torch.ops import flash_prefill as fp
    from teal_tpu_torch.ops import gather_gemv as gg
    from teal_tpu_torch.parallel import tp_kernel

    k1 = k1 or bg.select_gather_gemv_plain
    swaps = [(bg, "select_gather_gemv", k1),
             (attn_block, "select_gather_gemv", k1),
             (token_block, "select_gather_gemv", k1),
             (bg, "block_gather_gemv_multi",
              bg.block_gather_gemv_multi_plain),
             (gg, "row_gather_gemv", gg.row_gather_gemv_plain),
             (llama, "decode_attention", da.decode_attention_plain),
             (attn_block, "decode_attention", da.decode_attention_plain),
             (tp_kernel, "decode_attention", da.decode_attention_plain),
             (token_block, "moe_route", token_block.moe_route_plain),
             (llama, "flash_prefill_attention",
              fp.flash_prefill_attention_plain)]
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


FLIP_ULPS = 2                    # a flip's input: rounding-level apart


@contextlib.contextmanager
def topk_selections(replay=None):
    """Inside the block, the layer loop's top-k selections
    (`block_gemv.select_groups` / `select_groups_batched` without a
    threshold) are recorded in call order into the yielded list as (kept
    groups, the selection's input, its group scores); with `replay` (such
    a list) each call keeps that list's groups instead of its own.
    Threshold selections pass through."""
    import torch

    from teal_tpu_torch.ops import block_gemv as bg

    rec = []
    saved = {n: getattr(bg, n) for n in ("select_groups",
                                         "select_groups_batched")}

    def selector(name):
        def select(x, G, k_keep, threshold=None):
            idx, xpack = saved[name](x, G, k_keep, threshold)
            if threshold is not None:
                return idx, xpack
            scores = (bg.group_scores(x, G) if name == "select_groups"
                      else bg._pooled_scores(x, G))
            rows = x.reshape(-1, x.shape[-1])
            if replay is not None:
                idx = replay[len(rec)][0]
                xg = rows.reshape(rows.shape[0], -1, G)[:, idx.long()]
                xpack = torch.zeros_like(xpack)
                xpack[:, :rows.shape[0], :G] = xg.transpose(0, 1)
            rec.append((idx, rows.clone(), scores))
            return idx, xpack
        return select

    for n in saved:
        setattr(bg, n, selector(n))
    try:
        yield rec
    finally:
        for n, f in saved.items():
            setattr(bg, n, f)


def _ulp(v: float, dtype) -> float:
    """One unit in the last place of `dtype` at magnitude v (the
    smallest normal number's at 0)."""
    import torch

    fi = torch.finfo(dtype)
    return 2.0 ** math.floor(math.log2(max(v, fi.tiny))) * fi.eps


def explain_flip(got_sel, want_sel):
    """Whether the kernel path's top-k selections differ from the plain
    path's by a flip that rounding explains, measured on both paths'
    inputs to the selection: exactly one selection kept other groups, by
    exactly one group (a in the plain path's set, b in the kernel path's);
    the kernel path's input to that selection is within FLIP_ULPS units in
    the last place of the plain path's, at its largest magnitude and, on
    the two groups' elements, at their group scores; and the plain path's
    cut gap (score a - score b) is no larger than the two scores moved
    between the two inputs. Returns (explained, what was measured)."""
    import torch

    moved = [j for j, (g, w) in enumerate(zip(got_sel, want_sel))
             if not torch.equal(g[0], w[0])]
    if len(moved) != 1:
        return False, f"{len(moved)} selections kept other groups"
    j = moved[0]
    gi, xg, sg = got_sel[j]
    wi, xw, sw = want_sel[j]
    b = gi[~torch.isin(gi, wi)].long()
    a = wi[~torch.isin(wi, gi)].long()
    if a.numel() != 1 or b.numel() != 1:
        return False, f"selection {j}: {a.numel()} groups moved"
    scale = float(xw.float().abs().max())
    dx = float((xg.float() - xw.float()).abs().max())
    dx_ulps = dx / _ulp(scale, xw.dtype)
    G = xw.shape[-1] // sw.numel()
    local = 0.0
    for grp in (a, b):
        cols = slice(int(grp) * G, int(grp) * G + G)
        d = float((xg[:, cols].float() - xw[:, cols].float()).abs().max())
        local = max(local, d / _ulp(float(sw[grp].float()), xw.dtype))
    gap = float(sw[a].float() - sw[b].float())
    shift = float((sg[a].float() - sw[a].float()).abs()
                  + (sg[b].float() - sw[b].float()).abs())
    what = (f"selection {j}: group {int(a)} -> {int(b)}; input "
            f"{dx_ulps:.2f} ulps off at its scale {scale:.3e}, the two "
            f"groups' elements {local:.2f} ulps at their scores; plain cut "
            f"gap {gap:.3e} (relative {gap / float(sw[a].float()):.2e}), "
            f"the two scores moved {shift:.3e}")
    return (dx_ulps <= FLIP_ULPS and local <= FLIP_ULPS and gap <= shift,
            what)


def prefill(params, cfg, toks, device, rope):
    """Dense prefill of prompts toks [b, t] (numpy). Returns (cache, the
    greedy next tokens [b, 1], their position t)."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine.generate import _pad_len
    from teal_tpu_torch.models import llama

    b, t = toks.shape
    cache = llama.KVCache.init(cfg, b, MAX_SEQ, llama.compute_dtype(params),
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


def hold_loop_layers(params, cfg, name, sp, b, cache, toks, pos, rope,
                     device):
    """For one decode step of layer-loop path `name` (config sp, batch b)
    on the cache after a prefill: pick the thresholds layer by layer on
    the plain path (B: group thresholds, C: elementwise at the median;
    the top-k paths need none), then run each layer of the kernel path on
    the plain path's layer input and hold its output and written cache
    rows to the plain layer's within 2e-2 of their largest magnitude.
    Where that fails and the top-k selections differ by one flip that
    rounding explains (`explain_flip`, measured on both paths' inputs to
    the selection), the plain layer runs again on the kernel path's kept
    groups and the kernel layer is held to that at the same 2e-2; any
    other failure stands.

    Returns (thresholds [L, 7], worst relative error)."""
    import torch

    from teal_tpu_torch.models import llama

    rule = {"B": "group", "C": "elem"}.get(name)
    fused = llama.can_fused_decode(1, b, cfg, MAX_SEQ, sp,
                                   sp.kernel == "block")
    th = torch.zeros((cfg.n_layers, 7), dtype=torch.float32, device=device)
    k, v = cache.k.clone(), cache.v.clone()            # plain path
    kk, vk = cache.k.clone(), cache.v.clone()          # kernel path
    pos_t = torch.full((b,), pos, dtype=torch.int64, device=device)
    cos, sin = rope[0][pos_t][:, None], rope[1][pos_t][:, None]
    h = params["embed"][toks].to(llama.compute_dtype(params))
    worst = 0.0
    for i in range(cfg.n_layers):
        lp = {n: llama._leaf(w, lambda a: a[i])
              for n, w in params["layers"].items()}
        args = (pos_t, cos, sin, cfg, sp)
        with plain_path():
            for stage in range(4 if rule else 0):
                _, _, _, caps = llama.layer_forward(
                    h, lp, k[i], v[i], *args, th[i], capture=True,
                    fused_attn=fused)
                loop_thresholds(caps, rule, th[i], stage)
            with topk_selections() as want_sel:
                want, _, _, _ = llama.layer_forward(h, lp, k[i], v[i], *args,
                                                    th[i], fused_attn=fused)
        with topk_selections() as got_sel:
            got, _, _, _ = llama.layer_forward(h, lp, kk[i], vk[i], *args,
                                               th[i], fused_attn=fused)
        held = want
        if not all(float((g.float() - w.float()).abs().max())
                   <= 2e-2 * float(w.float().abs().max())
                   for g, w in ((got, want), (kk[i, :, :, pos], k[i, :, :, pos]),
                                (vk[i, :, :, pos], v[i, :, :, pos]))):
            # a top-k cut between two group scores a rounding apart moves
            # one group when the selection's input is a rounding off (the
            # kernels' fp32 sums in another order than the plain path's)
            ok, what = explain_flip(got_sel, want_sel)
            log(f"[loop] {name} layer {i}: the hold of 2e-2 fails; top-k "
                f"{what}; {'a flip' if ok else 'not a flip'} within "
                f"{FLIP_ULPS} ulps")
            if ok:
                with plain_path(), topk_selections(replay=got_sel):
                    held, _, _, _ = llama.layer_forward(
                        h, lp, k[i], v[i], *args, th[i], fused_attn=fused)
                log(f"[loop] {name} layer {i}: the plain layer run again on "
                    f"the kernel path's kept groups")
        for what, g, w in (("hidden", got, held),
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


def picking_k1(x, thr, ws, layer, cap, *, G=128, norm=None, norm_eps=1e-5,
               **kw):
    """K1's plain version that first sets its threshold (`thr`, a view into
    the [L, 7] table) from the input it sees (`pick_threshold` on the
    group scores, pooled over the rows) -- except the MoE down stage (the
    weighted residual), whose column 6 stays 0 as the reference's
    calibration leaves it."""
    from teal_tpu_torch.ops import block_gemv as bg

    if kw.get("route_w") is None:
        xs = bg.selection_input(x, norm, layer, norm_eps)
        scores = xs.float().abs().reshape(-1, xs.shape[-1] // G, G).amax(-1)
        thr.fill_(pick_threshold(scores.amax(0), cap))
    return bg.select_gather_gemv_plain(x, thr, ws, layer, cap, G=G,
                                       norm=norm, norm_eps=norm_eps, **kw)


def recording_k1(rec, override=None):
    """K1's plain version that appends, for each call, (its group scores
    [nb] fp32, its threshold, its kept count, the selection input's type)
    to `rec`; with `override` {call: threshold}, that call of the block
    selects at the given threshold instead."""
    import torch

    from teal_tpu_torch.ops import block_gemv as bg

    def k1(x, thr, ws, layer, cap, *, G=128, norm=None, norm_eps=1e-5,
           **kw):
        if override is not None and len(rec) in override:
            thr = torch.full_like(thr, override[len(rec)])
        out = bg.select_gather_gemv_plain(x, thr, ws, layer, cap, G=G,
                                          norm=norm, norm_eps=norm_eps, **kw)
        xs = bg.selection_input(x, norm, layer, norm_eps)
        nb = xs.shape[-1] // G
        scores = xs.float().abs().reshape(-1, nb, G).amax(-1).amax(0)
        rec.append((scores, float(thr), int(out[2]), xs.dtype))
        return out
    return k1


def explain_count_flip(rec, got, want):
    """Whether the kernel path's kept counts `got` differ from the plain
    path's `want` (one layer's K1 calls, recorded by `recording_k1` in
    `rec`) by a threshold flip that rounding explains: exactly one call
    kept one group more or fewer, and the plain path's nearest group score
    on the other side of that call's threshold is within FLIP_ULPS units
    in the last place (of the selection input's type) of it. Returns
    (explained, what was measured, {call: the threshold at which the plain
    path keeps the kernel path's count})."""
    import numpy as np

    moved = [j for j in range(len(want)) if got[j] != want[j]]
    if len(moved) != 1 or abs(int(got[moved[0]]) - int(want[moved[0]])) != 1:
        return False, f"kept counts {got} vs {want}", {}
    j = moved[0]
    scores, thr, _, dt = rec[j]
    more = int(got[j]) > int(want[j])
    side = scores[scores <= thr] if more else scores[scores > thr]
    if side.numel() == 0:
        return False, f"call {j}: no group on the other side", {}
    s = float(side.max() if more else side.min())
    ulps = abs(s - thr) / _ulp(abs(thr), dt)
    new = (float(np.nextafter(np.float32(s), np.float32(-np.inf)))
           if more else s)
    what = (f"call {j}: the kernel kept {'one more' if more else 'one fewer'}"
            f" group; the plain path's nearest score {s:.6e} is {ulps:.2f} "
            f"ulps from the threshold {thr:.6e}")
    return ulps <= FLIP_ULPS, what, {j: new}


def hold_token_layers(params, cfg, cache, tok, pos, rope, device, *,
                      verify: bool = False, th=None, shares=None):
    """For one decode step of the token path on a cache after prefills,
    layer by layer: run the plain token-path layer (`layer_decode` under
    `plain_path`), each K1 stage picking its threshold from the input it
    sees (pooled over the rows), or at the given thresholds `th` [L, 7]
    (calibrated ones; with `shares`, each K1 call's survivors and kept
    count recorded by `recording_k1`); then run the kernel path's layer
    on the same layer input and hold its output and written cache rows to
    the plain layer's within 2e-2 of their largest magnitude, and its kept
    counts to [1, cap] (picked thresholds) or to the plain path's kept
    counts, at most cap (given thresholds, which may keep no group).
    Where at given thresholds one K1 call kept one group more or fewer
    than the plain path and a plain score lies within FLIP_ULPS of the
    threshold (`explain_count_flip`), the plain layer runs again at a
    threshold moved past that score, must keep the kernel path's counts,
    and the kernel layer is held to that at the same 2e-2; any other
    difference fails.

    tok: B tokens, one per row; pos: B positions (an int for B = 1). Each
    row is a sequence in its own cache row, or with `verify` the rows are
    consecutive positions of one sequence (`block_verify`'s chunk: fixed
    full selection, `seq_block`, no thresholds picked). Mixtral (batch 1):
    the layer's K5 too, whose routed experts must be the plain path's.

    Returns (thresholds [L, 7], worst relative error, the plain path's
    cache after the step as (k, v))."""
    import numpy as np
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import token_block

    lay = params["layers"]
    ws = tuple(lay[n] for n in PROJ_NAMES)
    caps = ((cfg.dim // 128,) * 3 + (cfg.intermediate_size // 128,)
            if verify else llama.token_path_caps(cfg, SparsityConfig(**MAIN_SP)))
    picked = th is None
    if picked:
        th = torch.zeros((cfg.n_layers, 7), dtype=torch.float32,
                         device=device)
        k1 = None if verify else picking_k1
    k, v = cache.k.clone(), cache.v.clone()            # plain path
    kk, vk = cache.k.clone(), cache.v.clone()          # kernel path
    pos_t = torch.as_tensor(np.asarray(pos).reshape(-1),
                            dtype=torch.int32).to(device)
    B = pos_t.numel()
    rows = llama._rope_rows(rope[0], rope[1], pos_t)
    h = params["embed"][torch.as_tensor(tok).reshape(-1).to(device)].to(
        llama.compute_dtype(params))
    h = h.reshape(cfg.dim) if B == 1 else h.reshape(B, cfg.dim)
    cb = (torch.zeros if verify else torch.arange)(B, device=device).long()
    pl = pos_t.long()
    kw = dict(caps=caps, n_heads=cfg.n_heads, norm_eps=cfg.norm_eps,
              window=cfg.sliding_window, fixed_sel=verify, seq_block=verify)
    cap_cols = caps
    if cfg.n_experts:
        ws = (*ws[:4], *(token_block.expert_stacks(w) for w in ws[4:]))
        kw.update(router=lay["router"], k_exp=cfg.n_experts_per_tok)
        cap_cols = caps[:2] + caps[2:] * cfg.n_experts_per_tok
    counts, plain_counts, worst = [], [], 0.0
    for i in range(cfg.n_layers):
        routes = ([], [])                       # plain, kernel
        rec = []
        with plain_path(k1=k1 if picked else recording_k1(rec)):
            want = token_block.layer_decode(
                h, i, th, ws, lay["attn_norm"], lay["mlp_norm"], rows, k, v,
                pos_t, counts=plain_counts, routes=routes[0], **kw)
        got = token_block.layer_decode(
            h, i, th, ws, lay["attn_norm"], lay["mlp_norm"], rows, kk, vk,
            pos_t, counts=counts, routes=routes[1], **kw)
        held = want
        if not picked:
            if shares is not None:
                shares.extend((float((sc > t).float().mean()), c,
                               sc.numel()) for sc, t, c, _ in rec)
            g_kept = counts[-1].tolist()
            if g_kept != plain_counts[-1].tolist():
                ok, what, override = explain_count_flip(
                    rec, g_kept, plain_counts[-1].tolist())
                log(f"[calib] layer {i}: {what}; "
                    f"{'a flip' if ok else 'not a flip'} within {FLIP_ULPS} "
                    "ulps")
                check(ok, f"layer {i}: kept counts {g_kept} vs the plain "
                      f"path's {plain_counts[-1].tolist()}: {what}")
                again = []
                with plain_path(k1=recording_k1([], override)):
                    held = token_block.layer_decode(
                        h, i, th, ws, lay["attn_norm"], lay["mlp_norm"],
                        rows, k, v, pos_t, counts=again, **kw)
                check(again[0].tolist() == g_kept, f"layer {i}: the plain "
                      f"layer run again keeps {again[0].tolist()}, the "
                      f"kernel path {g_kept}")
                plain_counts[-1] = again[0]
                log(f"[calib] layer {i}: the plain layer run again at the "
                    f"moved threshold keeps the kernel path's counts")
        if cfg.n_experts:
            check(all(torch.equal(a, b) for a, b in zip(*routes)),
                  f"layer {i}: routed pseudo-layers {routes[1][0].tolist()} "
                  f"vs the plain path's {routes[0][0].tolist()}")
            if i in (0, cfg.n_layers - 1):
                log(f"[moe] layer {i}: routed experts "
                    f"{[e - i * cfg.n_experts for e in routes[1][0].tolist()]}"
                    " on both paths")
        for what, g, w in (("hidden", got, held),
                           ("k rows", kk[i, cb, :, pl], k[i, cb, :, pl]),
                           ("v rows", vk[i, cb, :, pl], v[i, cb, :, pl])):
            err = rel_check(f"token path (B={B}{', verify' if verify else ''})"
                            f" layer {i} {what}: kernel vs plain", g, w, 2e-2)
            # a qkv stage that keeps no group writes zero rows (given
            # thresholds); rel_check then required err == 0
            scale = float(w.float().abs().max())
            worst = max(worst, err / scale if scale else 0.0)
        h = want
    kept = torch.stack(counts).cpu()              # [L, len(cap_cols)]
    check(all(bool((kept[:, j] <= c).all()) for j, c in enumerate(cap_cols)),
          f"kept counts above cap: {kept.tolist()}")
    if picked:
        check(bool((kept >= 1).all()), f"kept counts below 1: "
              f"{kept.tolist()}")
    else:
        # given thresholds may keep no group of a stage (see phase 12);
        # the kernel must keep what the plain path keeps (after a flip,
        # the plain layer run again)
        want_kept = torch.stack(plain_counts).cpu()
        check(torch.equal(kept, want_kept), f"kept counts {kept.tolist()} "
              f"vs the plain path's {want_kept.tolist()}")
    log(f"[token] B={B}{' verify' if verify else ''}: kept groups a K1 "
        f"call, mean over the {cfg.n_layers} layers "
        f"{[round(float(c), 2) for c in kept.float().mean(0)]} of caps "
        f"{list(cap_cols)}")
    return th, worst, (k, v)


def loop_paths(params, cfg, device, seed, rope, paths=None, launches=None):
    """Phase 6 for every path of `paths` (name: (SparsityConfig kwargs,
    batch); `LOOP_PATHS` by default), each held layer by layer on the
    token path or the layer loop, as `forward` routes it, with the launch
    counts per step of `launches`. Returns {path: results}."""
    import numpy as np

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine import Generator
    from teal_tpu_torch.models import llama

    paths = paths or LOOP_PATHS
    launches = launches or LOOP_LAUNCHES
    rng = np.random.default_rng(seed + 1)
    dt = llama.compute_dtype(params)
    L = cfg.n_layers
    out = {}
    for name, (sp_kw, b) in paths.items():
        sp = SparsityConfig(**sp_kw)
        prompts = [rng.integers(1, cfg.vocab_size, (b, n))
                   for n in PROMPT_LENS]
        cache, tok, pos = prefill(params, cfg, prompts[0], device, rope)
        t0 = time.perf_counter()
        fused = llama.can_fused_decode(
            1, b, cfg, MAX_SEQ, sp, (sp.enabled and sp.kernel == "block")
            or llama._is_int4_packed(params["layers"]["wq"]))
        if llama.can_token_decode(params, cfg, sp, 1, b, dt,
                                  fused_attn=fused):
            th, worst, _ = hold_token_layers(params, cfg, cache, tok,
                                             [pos] * b, rope, device)
        else:
            th, worst = hold_loop_layers(params, cfg, name, sp, b, cache,
                                         tok, pos, rope, device)
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
        want = tuple(n * L * steps for n in launches[name])
        check(counts == want, f"path {name}: launches (K1, K2, K3, K4, K5, "
              f"K6) "
              f"{counts}, expected {want} for {steps} decode steps")
        for p, (toks, st) in zip(prompts, outs):
            check(toks.shape == (b, p.shape[1] + LOOP_NEW_TOKENS)
                  and bool((toks >= 0).all() and (toks < cfg.vocab_size)
                           .all()), f"path {name}: bad tokens {toks.shape}")
        log(f"[loop] path {name}: {len(prompts)} requests, {steps} decode "
            f"steps, launches per step (K1, K2, K3, K4, K5, K6) "
            f"{tuple(c // steps for c in counts)}; tok/s "
            + ", ".join(f"{st.tokens_per_s * b:.2f}" for _, st in outs)
            + f"; first request's new tokens "
            f"{outs[0][0][0, prompts[0].shape[1]:].tolist()}")
        out[name] = dict(th=th, worst=worst, launches=counts, steps=steps,
                         tok_s=[st.tokens_per_s * b for _, st in outs])
    return out


# --- phase 7: kernel times ------------------------------------------------

def time_kernels(params, cfg, caps, device, gen, rope, launches, errs):
    L = cfg.n_layers
    stages = time_k1_plan(params, params, cfg, caps, device, gen, "bf16")

    (k1n, k2n, decoded) = launches
    k2 = time_k2(cfg, device, gen, rope, k2n, decoded, errs[1])
    per_layer = {key: sum(s[key] for s in stages)
                 for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    log(f"[time] kernel time per token, summed over stages and layers: "
        f"{L * (per_layer['ms'] + k2['ms']):.3f} ms (bound "
        f"{L * (per_layer['bound_ms'] + k2['bound_ms']):.3f} ms)")
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
        k2,
    ]}


def time_k2(cfg, device, gen, rope, launches, steps, err, name=None,
            heads=None, T=None):
    """K2 at pos T-1 of a bf16 cache of T rows (default: the rope tables'
    length), at the 7B heads or `heads` (Hq, Hkv), a 32-layer cache so
    that calls do not share L2: one `k2_check`, then the kernel, plain
    version, SDPA (with `enable_gqa` where Hq != Hkv) and the bound. Returns the `kernels`
    entry (max_abs_err: the larger of `err` and this check's)."""
    import torch
    import torch.nn.functional as F

    from teal_tpu_torch.ops.decode_attention import (
        _plan, decode_attention, decode_attention_plain)

    L, esz = cfg.n_layers, 2
    Hq, Hkv = heads or (cfg.n_heads, cfg.n_kv_heads)
    T = T or rope[0].shape[0]
    p = T - 1
    shape = (L, 1, Hkv, T, 128)
    kc = torch.randn(shape, generator=gen, device=device).bfloat16()
    vc = torch.randn(shape, generator=gen, device=device).bfloat16()
    q = torch.randn(1, Hq, 128, generator=gen, device=device)
    kn = torch.randn(1, Hkv, 128, generator=gen, device=device)
    vn = torch.randn(1, Hkv, 128, generator=gen, device=device)
    row = torch.stack([rope[0][p], rope[1][p]])[None].contiguous()
    pos_t = torch.tensor([p], dtype=torch.int32, device=device)
    e, ratio = k2_check(f"K2 Hq={Hq} Hkv={Hkv} pos={p}", q, kn, vn, kc[:1],
                        vc[:1], 0, pos_t, rope=row)
    err = max(err, e)
    nbytes = (2 * p * Hkv * 128 * esz + (Hq + 2 * Hkv) * 128 * 4
              + 2 * 128 * 4 + Hq * 128 * esz + 2 * Hkv * 128 * esz)
    b_ms, b_by = bound_ms(nbytes, 4 * Hq * p * 128)
    ms, host = cuda_ms(lambda i: decode_attention(
        q, kn, vn, kc, vc, i % L, pos_t, rope=row), 64)
    p_ms, _ = cuda_ms(lambda i: decode_attention_plain(
        q, kn, vn, kc, vc, i % L, pos_t, rope=row), 5, warmup=1,
        queued=False)
    q4 = q.to(torch.bfloat16)[:, :, None]
    lib, _ = cuda_ms(lambda i: F.scaled_dot_product_attention(
        q4, kc[i % L][:, :, :p + 1], vc[i % L][:, :, :p + 1],
        enable_gqa=Hq != Hkv), 64)
    S, _ = _plan(1, Hq, Hkv, T, False, esz,
                 torch.cuda.get_device_properties(device).multi_processor_count)
    log(f"[time] K2 Hq={Hq} Hkv={Hkv} pos={p} (T={T}, S={S}) kernel "
        f"{ms:.4f} ms (host enqueue {host:.4f} ms)  plain {p_ms:.4f} ms  "
        f"SDPA {lib:.4f} ms  bound {b_ms:.4f} ms ({b_by}, "
        f"{nbytes / 1e6:.2f} MB, {b_ms / ms:.1%} of it); worst row "
        f"{ratio:.2e}")
    return dict(name=name or "decode_attention", route="cuda",
                source="teal_tpu_torch/csrc/decode_attention.cu",
                replaces="teal_tpu/ops/decode_attention.py:444",
                launches=launches, launches_per_token=launches / steps,
                max_abs_err=err, ms=ms, kernel_ms=ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib, splits=S, timed=f"Hq={Hq} Hkv={Hkv} T={T} pos={p}")


K2_SWEEP = ((40, 512), (511, 512), (2047, 2048))   # (pos, T)


def k2_sweep(cfg, device, gen, rope):
    """K2 at 7B (Hq = Hkv = 32, bf16, one row) with the split count forced
    to 1, 2, 4 and 8, at pos 40 and 511 of a 512-row cache (the main
    path) and pos 2047 of a 2048-row one (the long-prompt decode); every
    forced S passes `k2_check` first. Returns {pos: {S: ms, "rule": S}}."""
    import torch

    from teal_tpu_torch.ops import decode_attention as da

    L, Hq, Hkv = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rule = da._splits
    out = {}
    for p, T in K2_SWEEP:
        shape = (L, 1, Hkv, T, 128)
        kc = torch.randn(shape, generator=gen, device=device).bfloat16()
        vc = torch.randn(shape, generator=gen, device=device).bfloat16()
        q = torch.randn(1, Hq, 128, generator=gen, device=device)
        kn = torch.randn(1, Hkv, 128, generator=gen, device=device)
        vn = torch.randn(1, Hkv, 128, generator=gen, device=device)
        row = torch.stack([rope[0][p], rope[1][p]])[None].contiguous()
        pos = torch.tensor([p], dtype=torch.int32, device=device)
        res = {"rule": rule(1, Hkv, T, False, sms)}
        try:
            for S in (1, 2, 4, 8):
                da._splits = lambda *a, _S=S, **k: _S
                k2_check(f"K2 sweep S={S} pos={p}", q, kn, vn, kc[:1],
                         vc[:1], 0, pos, rope=row)
                res[S], _ = cuda_ms(lambda i: da.decode_attention(
                    q, kn, vn, kc, vc, i % L, pos, rope=row), 64)
        finally:
            da._splits = rule
        out[p] = res
        log(f"[k2 sweep] pos={p} T={T}: "
            + "  ".join(f"S={S} {res[S]:.4f} ms" for S in (1, 2, 4, 8))
            + f"  (rule: S={res['rule']})")
    return out


def _stage_row(name, **kw):
    gb_s = f", {kw['gb_s']:.0f} GB/s" if "gb_s" in kw else ""
    log(f"[time] {name:26s} kernel {kw['ms']:.4f} ms (host enqueue "
        f"{kw['host_ms']:.4f} ms{gb_s})  plain {kw['plain_ms']:.4f} ms  "
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
    k1g = []
    for name, st in loop_stages(params, cfg).items():
        # K1 at G, no epilogue, count == cap (path B)
        ws, G, cap = st["ws"], st["G"], st["cap"]
        K, n_tot = ws[0].shape[1], sum(w.shape[2] for w in ws)
        x, thr, _ = k1_inputs(st, cfg, K, cap, gen, device, dt, 0, G)
        x2 = x.reshape(1, K)
        kw = dict(G=G, norm=st["norm"], norm_eps=cfg.norm_eps)
        nbytes = (plan_bytes(ws, G, cap, None) + n_tot * 4
                  + K * esz * (1 if st["norm"] is None else 2))
        k1g.append(_plan_row(
            f"K1 G={G} {name}", nbytes, 2 * cap * G * n_tot,
            lambda i: bg.select_gather_gemv(x, thr, ws, i % L, cap, **kw),
            lambda i: bg.select_gather_gemv_plain(x, thr, ws, i % L, cap,
                                                  **kw),
            sum(cuda_ms(lambda i, w=w: torch.matmul(x2, w[i % L]), 64)[0]
                for w in ws), None, K=K, N=n_tot, cap=cap))
    k3 = time_k3_plan(params, params, cfg, device, gen, "bf16")
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
                             mbytes=nbytes / 1e6,
                             gb_s=nbytes / ms / 1e6))
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


def time_lm_head(params, cfg, device, gen, what="bf16 GEMV, fp32 output"):
    """The logits head of one decode step (h [1, 1, dim] -> fp32 logits)."""
    import torch

    from teal_tpu_torch.models import llama

    h = torch.randn(1, 1, cfg.dim, generator=gen, device=device).to(
        llama.compute_dtype(params))
    ms, _ = cuda_ms(lambda i: llama._lm_head(params, h), 64)
    log(f"[time] lm_head ({what}) {ms:.4f} ms")
    return ms


# --- phase 8: the weight-only quantized paths -------------------------------

def quantize_on_card(params, kind: str):
    """The seeded bf16 params quantized on the card by the port's own
    `quant` functions (`QUANT_PATHS` names the kinds). Returns (params,
    seconds)."""
    import torch

    from teal_tpu_torch.ops import quant

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if kind == "int8":
        q = quant.quantize_params_int8(params)
    else:
        g = int(kind.split("-g")[1])
        q = quant.pack_int4_params(quant.quantize_params_int4(params, g),
                                   block_size=128 if g == 128 else 32)
    torch.cuda.synchronize()
    return q, time.perf_counter() - t0


def plan_bytes(ws, G: int, cap: int, scales) -> int:
    """Bytes of the kept slabs of one call's weights (packed int4: the
    half-height slab and its [scale, zero] row), plus int8 scales read."""
    from teal_tpu_torch.ops import block_gemv as bg

    n = 0
    for w in ws:
        N = bg._width(w)
        n += (cap * (G // 2 * N + 2 * N * 4) if isinstance(w, dict)
              else cap * G * N * w.element_size())
        n += 0 if scales is None else N * 4
    return n


def quant_library_ms(plan: str, K: int, Ns, device, gen, rows: int = 1):
    """PyTorch's own weight-only GEMV at full keep on random weights of a
    stage's shapes with `rows` input rows, summed over its weights, each
    call on one of 4 copies in turn (not L2-resident):
    `torch._weight_int8pack_mm` for int8, `torch._weight_int4pack_mm`
    (group 128) for int4. Timed only, never called by the port. None for
    bf16, and where the installed PyTorch has no CUDA kernel for it."""
    import torch

    if plan not in ("int8", "int4"):
        return None

    x = torch.randn(rows, K, generator=gen, device=device).bfloat16()
    total = 0.0
    try:
        for N in Ns:
            if plan == "int8":
                ws = [torch.randint(-128, 128, (N, K), generator=gen,
                                    device=device, dtype=torch.int8)
                      for _ in range(4)]
                sc = torch.rand(N, generator=gen, device=device).bfloat16()

                def fn(i, ws=ws, sc=sc):
                    return torch._weight_int8pack_mm(x, ws[i % 4], sc)
            else:
                ws = [torch._convert_weight_to_int4pack(
                    torch.randint(0, 256, (N, K // 2), generator=gen,
                                  device=device, dtype=torch.uint8), 8)
                    for _ in range(4)]
                sz = torch.rand(K // 128, N, 2, generator=gen,
                                device=device).bfloat16()

                def fn(i, ws=ws, sz=sz):
                    return torch._weight_int4pack_mm(x, ws[i % 4], 128, sz)
            total += cuda_ms(fn, 64)[0]
    except (RuntimeError, AttributeError, TypeError,
            NotImplementedError) as e:
        log(f"[time] {plan} library GEMV unavailable on this PyTorch: "
            f"{str(e).splitlines()[0][:120]}")
        torch.cuda.synchronize()
        return None
    return total


def _plan_row(name, nbytes, flops, kernel, plain, lib, q_lib, **kw):
    b_ms, b_by = bound_ms(nbytes, flops)
    ms, host = cuda_ms(kernel, 64)
    p_ms, _ = cuda_ms(plain, 5, warmup=1, queued=False)
    row = _stage_row(name, ms=ms, host_ms=host, plain_ms=p_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib, mbytes=nbytes / 1e6,
                     gb_s=nbytes / ms / 1e6, quant_library_ms=q_lib, **kw)
    if q_lib is not None:
        log(f"[time] {'':26s} {('int8' if 'int8' in name else 'int4')}"
            f"pack_mm full keep {q_lib:.4f} ms")
    return row


def time_k1_plan(qparams, params, cfg, caps, device, gen, plan):
    """K1 with a weight plan at the token path's four stage shapes (count
    == cap, epilogues and int8 scales), each call on another layer's
    weights: kernel, plain version, `torch.matmul` on the bf16 weights and
    PyTorch's weight-only GEMV at full keep, and the bound."""
    import torch

    from teal_tpu_torch.ops import block_gemv as bg

    L, esz, rows = cfg.n_layers, 2, []
    for name, cap in zip(STAGES, caps):
        spec = stage_specs(qparams, cfg)[name]
        ws = spec["ws"]
        K, Ns = bg._in_dim(ws[0]), [bg._width(w) for w in ws]
        x, thr, res = k1_inputs(spec, cfg, K, cap, gen, device,
                                torch.bfloat16, 0)
        kw = dict(norm=spec["norm"], norm_eps=cfg.norm_eps, res=res,
                  silu=spec["silu"], scales=spec["scales"])
        n_out = Ns[0] if spec["silu"] else sum(Ns)
        nbytes = (plan_bytes(ws, 128, cap, spec["scales"])
                  + K * esz * (1 if spec["norm"] is None else 2)
                  + (n_out * esz if spec["res"] else 0)
                  + n_out * (esz if (spec["res"] or spec["silu"]) else 4))
        x2 = x.reshape(1, K)
        lib = sum(cuda_ms(lambda i, w=params["layers"][n]:
                          torch.matmul(x2, w[i % L]), 64)[0]
                  for n in STAGE_WEIGHTS[name])
        rows.append(_plan_row(
            f"K1[{plan}] {name}", nbytes, 2 * cap * 128 * sum(Ns),
            lambda i: bg.select_gather_gemv(x, thr, ws, i % L, cap, **kw),
            lambda i: bg.select_gather_gemv_plain(x, thr, ws, i % L, cap,
                                                  **kw),
            lib, quant_library_ms(plan, K, Ns, device, gen), K=K,
            N=sum(Ns), cap=cap))
    return rows


def time_k3_plan(qparams, params, cfg, device, gen, plan):
    """K3 with a weight plan at path A's four stage shapes (k_keep == cap;
    1 row, and 4 rows of an 8-row xpack beside it), as `time_k1_plan`."""
    import torch

    from teal_tpu_torch.ops import block_gemv as bg

    L, esz, out = cfg.n_layers, 2, []
    for name, st in loop_stages(qparams, cfg).items():
        ws, G, cap = st["ws"], st["G"], st["cap"]
        K, Ns = bg._in_dim(ws[0]), [bg._width(w) for w in ws]
        x2 = torch.randn(1, K, generator=gen, device=device).bfloat16()
        lib = sum(cuda_ms(lambda i, w=params["layers"][n]:
                          torch.matmul(x2, w[i % L]), 64)[0]
                  for n in STAGE_WEIGHTS[name])
        q_lib = quant_library_ms(plan, K, Ns, device, gen)
        row = {}
        for rows in (1, 4):
            xr = torch.randn(rows, K, generator=gen, device=device).bfloat16()
            idx, xpack = (bg.select_groups(xr, G, cap) if rows == 1 else
                          bg.select_groups_batched(xr, G, cap))
            nbytes = (plan_bytes(ws, G, cap, None) + idx.numel() * 4
                      + xpack.numel() * esz + rows * sum(Ns) * 4)
            row[rows] = _plan_row(
                f"K3[{plan}] G={G} {name} rows={rows}", nbytes,
                2 * rows * cap * G * sum(Ns),
                lambda i: bg.block_gather_gemv_multi(idx, xpack, ws, i % L,
                                                     G, rows),
                lambda i: bg.block_gather_gemv_multi_plain(
                    idx, xpack, ws, i % L, G, rows),
                lib, q_lib, K=K, N=sum(Ns), k_keep=cap)
        out.append(dict(row[1], rows4={k: row[4][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "gb_s")}))
    return out


def time_quant_head(qparams, plan, cfg, device, gen):
    """The quantized logits head (PyTorch ops, as the reference's is XLA's:
    int8 values in bf16 then the GEMV and the scale; int4 dequantized to
    bf16 then the GEMV) beside its bound (the quantized head's bytes read
    once) and PyTorch's weight-only GEMV at the same shape."""
    head = qparams["lm_head"]
    ms = time_lm_head(qparams, cfg, device, gen,
                      f"{plan} {sorted(head)}, fp32 output")
    nbytes = sum(t.numel() * t.element_size() for t in head.values())
    b_ms, b_by = bound_ms(nbytes + cfg.dim * 2 + cfg.vocab_size * 4,
                          2 * cfg.dim * cfg.vocab_size)
    lib = quant_library_ms(plan, cfg.dim, [cfg.vocab_size], device, gen)
    log(f"[time] lm_head {plan}: {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{nbytes / 1e6:.1f} MB), PyTorch weight-only GEMV {lib}")
    return dict(ms=ms, bound_ms=b_ms, bound_by=b_by, quant_library_ms=lib)


def plan_entry(stages, name, source, replaces, launches, steps, err, timed):
    """A `kernels` line entry from per-stage rows (one layer, summed)."""
    e = _summed(stages, name, source, replaces, launches, steps, err, timed)
    q = [s["quant_library_ms"] for s in stages]
    e["quant_library_ms"] = None if None in q else sum(q)
    log(f"[time] {name}: one layer {e['ms']:.4f} ms, plain "
        f"{e['plain_ms']:.4f} ms, torch.matmul bf16 {e['library_ms']:.4f} "
        f"ms, PyTorch weight-only GEMV {e['quant_library_ms']}, bound "
        f"{e['bound_ms']:.4f} ms")
    return e


def quant_paths(params, cfg, caps, device, gen, seed, rope):
    """Phase 8: for each quantization of `QUANT_PATHS`, quantize the bf16
    params on the card, hold K1 (token-path stage shapes with the scale
    epilogue, and G = 32/64) and K3 (path A's stage shapes, 1 and 4 rows)
    with that weight plan to their plain versions, run its paths
    (`loop_paths`: every 7B layer held to the plain path, three greedy
    requests, launch counts), time one decode step at pos 40, the plan's
    kernels and the quantized logits head; then free the copy. Returns
    (kernels entries, {path: results}, extra results)."""
    import torch

    src = "teal_tpu_torch/csrc/"
    entries, results, extra = [], {}, {}
    for kind in ("int8", "int4-g128", "int4-g64"):
        plan = kind.split("-")[0]
        names = [n for n, v in QUANT_PATHS.items() if v[0] == kind]
        torch.cuda.reset_peak_memory_stats()
        qp, q_s = quantize_on_card(params, kind)
        log(f"[quant] {kind}: quantized on the card in {q_s:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        errs = {}
        if kind != "int4-g64":
            errs["k1"] = check_k1(qp, cfg, caps, device, gen,
                                  tag=f"k1 {plan}")
            errs["rows"] = check_k1_rows(qp, cfg, caps, device, gen,
                                         tag=f"k1 rows {plan}")
        if kind != "int4-g128":
            k1g = check_k1_groups(qp, cfg, device, gen, tag=f"k1g {plan}")
            errs["k1"] = max(errs.get("k1", 0.0), k1g)
            errs["k3"] = check_k3(qp, cfg, device, gen, rows_list=(1, 4),
                                  tag=f"k3 {plan}")
            for e in entries:      # int4's K1 entry came from the G=128 copy
                if e["name"] == f"select_gather_gemv[{plan}]":
                    e["max_abs_err"] = max(e["max_abs_err"], k1g)
        runs = loop_paths(qp, cfg, device, seed, rope,
                          paths={n: QUANT_PATHS[n][1:] for n in names},
                          launches=QUANT_LAUNCHES)
        results.update(runs)
        extra.update({f"decode_step_ms {k}": v for k, v in time_decode_step(
            qp, cfg, [(n, *QUANT_PATHS[n][1:], runs[n]["th"])
                      for n in names], device, rope).items()})
        for n in names:
            r = runs[n]
            if n.endswith("-b16"):
                entries.append(time_rows_kernels(
                    qp, params, cfg, caps, device, gen, rope, plan,
                    r["launches"][0], r["steps"], errs["rows"]))
            elif n.endswith("-main"):
                entries.append(plan_entry(
                    time_k1_plan(qp, params, cfg, caps, device, gen, plan),
                    f"select_gather_gemv[{plan}]",
                    src + "select_gather_gemv.cu",
                    "teal_tpu/ops/block_gemv.py:761", r["launches"][0],
                    r["steps"], errs["k1"],
                    f"{n}: one layer's four calls at count == cap, summed"))
            else:
                entries.append(plan_entry(
                    time_k3_plan(qp, params, cfg, device, gen, plan),
                    f"block_gather_gemv_multi[{plan}]",
                    src + "block_gather_gemv.cu",
                    "teal_tpu/ops/block_gemv.py:354", r["launches"][2],
                    r["steps"], errs["k3"],
                    f"{n}: one layer's four calls at k_keep == cap, 1 row, "
                    "summed"))
        if kind != "int4-g64":
            extra[f"lm_head {plan}"] = time_quant_head(qp, plan, cfg,
                                                       device, gen)
        extra[f"peak_gib {kind}"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"[quant] {kind}: peak {extra[f'peak_gib {kind}']:.2f} GiB "
            "allocated")
        del qp
        torch.cuda.empty_cache()
    return entries, results, extra


# --- phase 9: the batched token path, the server and block_verify ---------

ROWS = (2, 3, 8, 16)             # K1 rows forms checked
SERVER_SLOTS = 16
SERVER_REQUESTS = 24
SERVER_CHUNK = 32
SERVER_PROMPT = (5, 120)         # prompt lengths, inclusive
VERIFY_S = (4, 8, 12)
STEP_BATCHES = (1, 8, 16)


def rows_input(spec, cfg, K, B, n_surv, gen, device, dtype, layer):
    """B rows over uniform noise in [-0.5, 0.5] where group g has its spike
    (1.05**rank, rank a permutation of the groups) in row g % B, so that
    every group's pooled score comes from one row; a threshold with
    exactly `n_surv` pooled scores (of the selection input) above it, more
    than 1e-2 from each (n_surv = 0: twice the largest); and a [B, N]
    residual where the stage has one."""
    import torch

    from teal_tpu_torch.ops.block_gemv import _width, selection_input

    nb = K // 128
    g = torch.arange(nb, device=device)
    for _ in range(8):
        x = torch.rand(B, nb, 128, generator=gen, device=device) - 0.5
        lv = 1.05 ** torch.randperm(nb, generator=gen, device=device).float()
        col = torch.randint(0, 128, (nb,), generator=gen, device=device)
        sign = torch.randint(0, 2, (nb,), generator=gen, device=device) * 2 - 1
        x[g % B, g, col] = lv * sign
        x = x.reshape(B, K).to(dtype)
        xs = selection_input(x, spec["norm"], layer, cfg.norm_eps)
        pooled = xs.float().abs().reshape(B, nb, 128).amax(-1).amax(0)
        if n_surv == 0:
            thr, margin = 2.0 * float(pooled.max()), 0.5
            break
        thr, margin = threshold_for(pooled, n_surv)
        if margin > 1e-2:
            break
    check(margin > 1e-2, f"a pooled group score lies within {margin:.2e} "
          "of the threshold")
    n_out = sum(_width(w) for w in spec["ws"])
    res = (torch.randn(B, n_out, generator=gen, device=device).to(dtype)
           if spec["res"] else None)
    return x, torch.tensor(thr, dtype=torch.float32, device=device), res


def check_k1_rows(params, cfg, caps, device, gen, tag="k1 rows"):
    """K1's rows form against its plain version at the token path's four
    stage shapes for B in `ROWS`: the three selection regimes on pooled
    scores, `fixed` and no survivor, with the params' weight plan; two
    identical calls must give identical bits. Returns the largest absolute
    error."""
    import torch

    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import block_gemv as bg

    layer = cfg.n_layers // 2
    dt = llama.compute_dtype(params)
    worst = 0.0
    for B in ROWS:
        for name, cap in zip(STAGES, caps):
            spec = stage_specs(params, cfg)[name]
            K = bg._in_dim(spec["ws"][0])
            nb = K // 128
            for case, n_surv in (("count<cap", max(1, cap // 2)),
                                 ("count==cap", cap),
                                 ("overflow", min(nb, cap + max(1, nb // 4))),
                                 ("fixed", cap), ("none", 0)):
                fixed = case == "fixed"
                x, thr, res = rows_input(spec, cfg, K, B, n_surv, gen, device,
                                         dt, layer)
                kw = dict(norm=spec["norm"], norm_eps=cfg.norm_eps, res=res,
                          silu=spec["silu"], scales=spec["scales"],
                          fixed=fixed)
                got, gidx, gcnt = bg.select_gather_gemv(x, thr, spec["ws"],
                                                        layer, cap, **kw)
                again = bg.select_gather_gemv(x, thr, spec["ws"], layer, cap,
                                              **kw)
                check(all(torch.equal(u, v) for u, v in
                          zip((got, gidx, gcnt), again)),
                      f"K1 rows B={B} {name} {case}: two identical calls "
                      "differ")
                want, widx, wcnt = bg.select_gather_gemv_plain(
                    x, thr, spec["ws"], layer, cap, **kw)
                n = int(wcnt[0])
                check(n == min(n_surv, cap) and int(gcnt[0]) == n,
                      f"K1 rows B={B} {name} {case}: count {int(gcnt[0])} vs "
                      f"plain {n}, expected {min(n_surv, cap)}")
                check(bool((gidx == widx).all()),
                      f"K1 rows B={B} {name} {case}: kept sets differ")
                err = rel_check(f"K1 rows B={B} {name} {case}", got, want,
                                1e-4 if got.dtype == torch.float32
                                else 2 ** -7)
                worst = max(worst, err)
                log(f"[{tag}] B={B:2d} {name:8s} K={K:5d} "
                    f"N={want.shape[-1]:5d} cap={cap:2d} {case:10s} "
                    f"kept={n:2d} max_abs_err={err:.3e} (scale "
                    f"{float(want.float().abs().max()):.3e})")
    return worst


def k2_rows_inputs(L, Bc, S, Hq, Hkv, gen, device, dtype):
    import torch

    kc = torch.randn((L, Bc, Hkv, MAX_SEQ, 128), generator=gen,
                     device=device).to(dtype)
    vc = torch.randn((L, Bc, Hkv, MAX_SEQ, 128), generator=gen,
                     device=device).to(dtype)
    qkv = torch.randn(S, (Hq + 2 * Hkv) * 128, generator=gen, device=device)
    q = qkv[:, :Hq * 128].view(S, Hq, 128)
    kn = qkv[:, Hq * 128:(Hq + Hkv) * 128].view(S, Hkv, 128)
    vn = qkv[:, (Hq + Hkv) * 128:].view(S, Hkv, 128)
    return kc, vc, q, kn, vn


def check_k2_rows(cfg, device, gen, rope):
    """K2 with 16 rows at distinct positions (some at 0), and its
    seq_block form (S = 8 and 16 consecutive positions of cache row 0 at
    pos 0, 5 and T-20), at 7B (MHA) and at GQA with a window (Hq=32,
    Hkv=8, window=64), q/k/v as strided views of one [S, n_tot] block as
    the token path passes them: `k2_check` (caches and two calls bit for
    bit, each row within `K2_ROW_TOL`). Returns the largest absolute
    error."""
    import torch

    from teal_tpu_torch.models import llama

    L, layer, worst = 2, 1, 0.0
    cases = [("B=16", 16, None)] + [(f"seq_block S={S} pos={p0}", S, p0)
                                    for S in (8, 16)
                                    for p0 in (0, 5, MAX_SEQ - 20)]
    for Hq, Hkv, window in ((cfg.n_heads, cfg.n_kv_heads, None),
                            (32, 8, 64)):
        for name, S, p0 in cases:
            seq = p0 is not None
            kc, vc, q, kn, vn = k2_rows_inputs(L, 1 if seq else S, S, Hq, Hkv,
                                               gen, device, torch.bfloat16)
            if seq:
                pos = torch.arange(p0, p0 + S, device=device)
            else:
                pos = torch.randperm(MAX_SEQ, generator=gen,
                                     device=device)[:S]
                pos[:2] = 0
            pos = pos.to(torch.int32)
            rows = llama._rope_rows(rope[0], rope[1], pos)
            err, ratio = k2_check(f"K2 {name} Hkv={Hkv}", q, kn, vn, kc, vc,
                                  layer, pos, window=window, rope=rows,
                                  seq_block=seq)
            worst = max(worst, err)
            log(f"[k2 rows] Hq={Hq} Hkv={Hkv} window={window} {name} "
                f"max_abs_err={err:.3e}, worst row {ratio:.2e} of its "
                f"largest value; two calls identical")
    return worst


def check_step_launches(params, cfg, th, device, rope):
    """One batched decode `forward` at every B of `STEP_BATCHES` (distinct
    positions): exactly 4*L K1 and L K2 launches, no other port kernel,
    finite logits of the expected shape."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama

    L = cfg.n_layers
    for b in STEP_BATCHES:
        cache = llama.KVCache.init(cfg, b, MAX_SEQ, torch.bfloat16, device)
        pos = [40 + 4 * i for i in range(b)]
        reset_launches()
        lg, _ = llama.forward(params, torch.full((b, 1), 7, device=device),
                              cache, pos, th, cfg=cfg,
                              sp=SparsityConfig(**MAIN_SP), rope=rope)
        got = read_launches()
        check(got == (4 * L, L, 0, 0, 0, 0), f"batch {b}: launches (K1, K2, "
              f"K3, K4, K5, K6) {got} in one decode step, expected "
              f"{(4 * L, L, 0, 0, 0, 0)}")
        check(tuple(lg.shape) == (b, 1, cfg.vocab_size)
              and bool(torch.isfinite(lg).all()), f"batch {b}: bad logits")
    log(f"[serve] one decode step at batch {STEP_BATCHES}: launches (K1, "
        f"K2, K3, K4, K5, K6) = {(4 * L, L, 0, 0, 0, 0)} each")


def server_phase(params, cfg, device, seed, rope):
    """The continuous-batching server at 7B: `SERVER_SLOTS` slots,
    `SERVER_REQUESTS` greedy requests (prompts of 5-120 tokens, 8-16 new
    tokens), so that requests join as slots free up. Thresholds are picked
    on the plain path over the first 16 admitted requests' first decode
    step, every layer of which is held to the plain path at B = 16. Then
    the workload runs with one-shot admission and with
    `prefill_chunk=SERVER_CHUNK`, launch counts reset just before and read
    just after: 4*L K1 + L K2 per decode step, nothing else. Returns
    (thresholds, results)."""
    import numpy as np
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine import ContinuousBatchingEngine

    rng = np.random.default_rng(seed + 4)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(SERVER_PROMPT[0], SERVER_PROMPT[1] + 1,
                                     SERVER_REQUESTS)]
    new = [int(n) for n in rng.integers(8, 17, SERVER_REQUESTS)]
    L = cfg.n_layers

    def engine(th=None, chunk=None):
        return ContinuousBatchingEngine(
            cfg, params, slots=SERVER_SLOTS, max_seq=MAX_SEQ,
            sp=SparsityConfig(**MAIN_SP), thresholds=th, temperature=0.0,
            cache_dtype=torch.bfloat16, prefill_chunk=chunk, device=device)

    eng = engine()
    for p, n in zip(prompts[:SERVER_SLOTS], new[:SERVER_SLOTS]):
        eng.submit(p, n)
    eng._admit()
    t0 = time.perf_counter()
    th, worst, _ = hold_token_layers(params, cfg, eng.cache, eng.cur,
                                     eng.pos, rope, device)
    log(f"[serve] thresholds picked on the plain path and every layer of "
        f"the batched token path (B = {SERVER_SLOTS}, positions "
        f"{sorted(eng.pos.tolist())}) held to it (worst error {worst:.2e} "
        f"of scale, tolerance 2e-2) in {time.perf_counter() - t0:.2f} s")
    # the same step timed on the admitted requests (kept counts as logged
    # above), beside phase 9's step on token 7 at fixed positions
    admitted = time_decode_step(
        params, cfg, [(f"server batch {SERVER_SLOTS}, admitted requests",
                       MAIN_SP, SERVER_SLOTS, th, eng.pos.tolist())],
        device, rope, cache=eng.cache,
        tok=torch.from_numpy(eng.cur[:, None]).to(device))
    del eng
    check_step_launches(params, cfg, th, device, rope)

    out = {"worst": worst, "admitted_step": admitted}
    for chunk in (None, SERVER_CHUNK):
        eng = engine(th, chunk)
        decode = []                   # (active slots, wall s) per step
        step_fn = eng._decode_step

        def timed_step(step_fn=step_fn, eng=eng, decode=decode):
            n = sum(r is not None for r in eng.active)
            t = time.perf_counter()
            toks = step_fn()          # ends on the host: synchronised
            decode.append((n, time.perf_counter() - t))
            return toks

        eng._decode_step = timed_step
        for p, n in zip(prompts, new):
            eng.submit(p, n)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        done = eng.run()
        wall = time.perf_counter() - t0
        got = read_launches()
        steps = len(decode)
        # prompts of at most 120 tokens: no K6 in one-shot admission
        want = (4 * L * steps, L * steps, 0, 0, 0, 0)
        check(got == want, f"server (chunk {chunk}): launches (K1, K2, K3, "
              f"K4, K5, K6) {got}, expected {want} for {steps} decode steps")
        check(len(done) == SERVER_REQUESTS and all(
            len(r.out) == n and all(0 <= t < cfg.vocab_size for t in r.out)
            for r, n in zip(sorted(done, key=lambda r: r.id), new)),
            f"server (chunk {chunk}): requests unfinished or bad tokens")
        toks = sum(n for n, _ in decode)
        dec_s = sum(t for _, t in decode)
        key = "oneshot" if chunk is None else f"chunk{chunk}"
        out[key] = dict(
            steps=steps, launches=got, wall_s=wall, decode_tokens=toks,
            decode_s=dec_s, decode_tok_s=toks / dec_s,
            step_ms_full=1e3 * float(np.mean([t for n, t in decode
                                               if n == SERVER_SLOTS] or [0])),
            steps_full=sum(n == SERVER_SLOTS for n, _ in decode),
            outs=[r.out for r in sorted(done, key=lambda r: r.id)])
        log(f"[serve] {key}: {SERVER_REQUESTS} requests in {wall:.2f} s, "
            f"{steps} decode steps (launches K1 {got[0]}, K2 {got[1]}: "
            f"{got[0] // steps} + {got[1] // steps} a step), {toks} decoded "
            f"tokens, aggregate decode {toks / dec_s:.1f} tok/s, a step with "
            f"all {SERVER_SLOTS} slots active "
            + (f"{out[key]['step_ms_full']:.2f} ms" if out[key]["step_ms_full"]
               else "n/a (never all active)"))
    a, b = out["oneshot"]["outs"], out[f"chunk{SERVER_CHUNK}"]["outs"]
    same = sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb))
    log(f"[serve] one-shot vs chunked admission: {same} of "
        f"{sum(map(len, a))} greedy tokens equal (bf16 prefills of other "
        f"shapes round differently)")
    out["tokens_equal"] = (same, sum(map(len, a)))
    return th, out


def to_fp32(tree):
    """A copy of a parameter tree with every tensor in fp32."""
    if isinstance(tree, dict):
        return {k: to_fp32(v) for k, v in tree.items()}
    return tree.float()


def verify_phase(params, cfg, device, seed, rope):
    """`block_verify` at S in `VERIFY_S` after a dense prefill of 40
    tokens: every layer of each chunk held to its plain version (2e-2 of
    scale), ceil(S/8) * (4*L K1 + L K2) launches, finite logits. The
    logits of all 32 bf16 layers are compared with the dense forward and
    with `block_verify` on the plain versions, and reported: random bf16
    weights turn each layer's rounding differences (the per-layer holds'
    ~1e-3 of scale) into several 1e-2 of the logits' scale after 32
    layers, so that comparison is no check. The end-to-end check runs the
    same positions on an fp32 copy of the weights and cache, where
    `block_verify`'s logits must match the dense forward's within 2e-2 of
    scale. Returns results."""
    import numpy as np
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama

    rng = np.random.default_rng(seed + 5)
    L = cfg.n_layers
    cache, _, pos = prefill(params, cfg, rng.integers(1, cfg.vocab_size,
                                                      (1, 40)), device, rope)
    zero = llama.zero_thresholds(cfg, device)
    out, toks_s = {}, {}
    for S in VERIFY_S:
        check(llama.can_block_verify(params, cfg, S), f"S={S}: gate refused")
        toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, S)))
        toks = toks_s[S] = toks.to(device)
        n_chunks = -(-S // 8)
        sizes = [S // n_chunks + (1 if j < S % n_chunks else 0)
                 for j in range(n_chunks)]
        kv, off, worst = cache, 0, 0.0
        for ss in sizes:                 # each chunk on the plain cache
            _, w, kv = hold_token_layers(
                params, cfg, llama.KVCache(*kv), toks[0, off:off + ss],
                list(range(pos + off, pos + off + ss)), rope, device,
                verify=True)
            worst, off = max(worst, w), off + ss
        runs = {}
        for kind in ("kernel", "plain", "dense"):
            c = llama.KVCache(cache.k.clone(), cache.v.clone())
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            if kind == "dense":
                lg, _ = llama.forward(params, toks, c, pos, zero, cfg=cfg,
                                      sp=SparsityConfig(), rope=rope)
            elif kind == "plain":
                with plain_path():
                    lg, _ = llama.block_verify(params, toks, c, pos, zero,
                                               cfg=cfg, rope=rope)
            else:
                lg, _ = llama.block_verify(params, toks, c, pos, zero,
                                           cfg=cfg, rope=rope)
            torch.cuda.synchronize()
            runs[kind] = (lg, time.perf_counter() - t0, read_launches())
        lg, wall, got = runs["kernel"]
        want = (n_chunks * 4 * L, n_chunks * L, 0, 0, 0, 0)
        check(got == want, f"block_verify S={S}: launches {got}, expected "
              f"{want}")
        check(tuple(lg.shape) == (1, S, cfg.vocab_size)
              and bool(torch.isfinite(lg).all()), f"S={S}: bad logits")
        rel = {k: float((lg - runs[k][0]).abs().max()
                        / runs[k][0].abs().max()) for k in ("plain", "dense")}
        out[S] = dict(launches=got, worst=worst, wall_ms=wall * 1e3,
                      dense_wall_ms=runs["dense"][1] * 1e3,
                      bf16_err_dense=rel["dense"],
                      bf16_err_plain=rel["plain"])
        log(f"[verify] S={S} ({n_chunks} chunk(s) {sizes}): every layer held "
            f"to the plain version (worst {worst:.2e} of scale); launches "
            f"(K1, K2, K3, K4, K5, K6) {got}; bf16 logits after {L} layers "
            f"vs "
            f"the dense forward {rel['dense']:.2e} of scale, vs the plain "
            f"version {rel['plain']:.2e} (reported, not checked); wall "
            f"{wall * 1e3:.1f} ms (dense forward {runs['dense'][1] * 1e3:.1f}"
            " ms)")
    p32 = to_fp32(params)
    for S, toks in toks_s.items():
        lgs = []
        for verify in (True, False):
            c = llama.KVCache(cache.k.float(), cache.v.float())
            lgs.append(llama.block_verify(p32, toks, c, pos, zero, cfg=cfg,
                                          rope=rope)[0] if verify else
                       llama.forward(p32, toks, c, pos, zero, cfg=cfg,
                                     sp=SparsityConfig(), rope=rope)[0])
        err = rel_check(f"fp32 block_verify S={S} logits vs the dense "
                        "forward", lgs[0], lgs[1], 2e-2)
        out[S]["fp32_err_dense"] = err / float(lgs[1].abs().max())
        log(f"[verify] S={S} fp32 copy, all {L} layers: block_verify logits "
            f"vs the dense forward {out[S]['fp32_err_dense']:.2e} of scale "
            "(tolerance 2e-2)")
    del p32
    torch.cuda.empty_cache()
    return out


def time_rows_kernels(qparams, params, cfg, caps, device, gen, rope, plan,
                      launches, steps, err):
    """K1's rows form at B = 8 and 16 with a weight plan at the token
    path's four stage shapes (count == cap): kernel, plain version,
    `torch.matmul` of [B, K] @ [K, N] on the bf16 weights at full keep,
    PyTorch's weight-only GEMV with B rows (int8 / int4), and the bound
    (the kept weights once, plus the B rows in and out). Returns the
    `kernels` entry (B = 16 at its top level, B = 8 under "b8")."""
    import torch

    from teal_tpu_torch.ops import block_gemv as bg

    L, esz = cfg.n_layers, 2
    per_b = {}
    for B in (8, 16):
        rows = []
        for name, cap in zip(STAGES, caps):
            spec = stage_specs(qparams, cfg)[name]
            ws = spec["ws"]
            K, Ns = bg._in_dim(ws[0]), [bg._width(w) for w in ws]
            x, thr, res = rows_input(spec, cfg, K, B, cap, gen, device,
                                     torch.bfloat16, 0)
            kw = dict(norm=spec["norm"], norm_eps=cfg.norm_eps, res=res,
                      silu=spec["silu"], scales=spec["scales"])
            n_out = Ns[0] if spec["silu"] else sum(Ns)
            nbytes = (plan_bytes(ws, 128, cap, spec["scales"])
                      + B * K * esz + (K * esz if spec["norm"] is not None
                                       else 0)
                      + (B * n_out * esz if spec["res"] else 0)
                      + B * n_out * (esz if (spec["res"] or spec["silu"])
                                     else 4))
            lib = sum(cuda_ms(lambda i, w=params["layers"][n]:
                              torch.matmul(x, w[i % L]), 64)[0]
                      for n in STAGE_WEIGHTS[name])
            rows.append(_plan_row(
                f"K1 rows[{plan}] B={B} {name}", nbytes,
                2 * B * cap * 128 * sum(Ns),
                lambda i: bg.select_gather_gemv(x, thr, ws, i % L, cap, **kw),
                lambda i: bg.select_gather_gemv_plain(x, thr, ws, i % L, cap,
                                                      **kw),
                lib, quant_library_ms(plan, K, Ns, device, gen, rows=B),
                K=K, N=sum(Ns), cap=cap, rows=B))
            r = rows[-1]
            r["bound_share"] = r["bound_ms"] / r["ms"]
            log(f"[time] {'':26s} {r['bound_share']:.1%} of the bound; "
                f"{r['ms'] / r['library_ms']:.2f}x torch.matmul")
        per_b[B] = rows
    e = plan_entry(per_b[16], f"select_gather_gemv[rows {plan}]",
                   "teal_tpu_torch/csrc/select_gather_gemv.cu",
                   "teal_tpu/ops/token_block.py:518", launches, steps, err,
                   "rows form: one layer's four calls at B = 16 (B = 8 under "
                   "b8) at count == cap, summed")
    q8 = [r["quant_library_ms"] for r in per_b[8]]
    e["b8"] = dict({k: sum(r[k] for r in per_b[8])
                    for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
                   quant_library_ms=None if None in q8 else sum(q8),
                   stages=per_b[8])
    for d in (e, e["b8"]):
        d["bound_share"] = d["bound_ms"] / d["ms"]
    log(f"[time] {e['name']}: {e['bound_share']:.1%} of the bound at B = "
        f"16; at B = 8 one layer {e['b8']['ms']:.4f} ms, bound "
        f"{e['b8']['bound_ms']:.4f} ms ({e['b8']['bound_share']:.1%}), "
        f"torch.matmul {e['b8']['library_ms']:.4f} ms, PyTorch weight-only "
        f"GEMV {e['b8']['quant_library_ms']}")
    return e


def time_k2_rows(cfg, device, gen, rope, launches, steps, err, name):
    """K2 at 16 rows at positions spread over the cache (the server's
    shape) or in its seq_block form (S = 8 at pos 500, the verify path's),
    after a `k2_check`, its plain version, `scaled_dot_product_attention` with the equivalent
    mask and the bound. Returns the `kernels` entry."""
    import torch
    import torch.nn.functional as F

    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops.decode_attention import (decode_attention,
                                                     decode_attention_plain)

    L, Hq, Hkv, esz = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, 2
    seq = name == "seq_block"
    S = 8 if seq else 16
    kc, vc, q, kn, vn = k2_rows_inputs(L, 1 if seq else S, S, Hq, Hkv, gen,
                                       device, torch.bfloat16)
    p0 = MAX_SEQ - 12
    pos = (torch.arange(p0, p0 + S, device=device) if seq else
           torch.linspace(31, MAX_SEQ - 1, S, device=device).round())
    pos = pos.to(torch.int32)
    rows = llama._rope_rows(rope[0], rope[1], pos)
    kw = dict(rope=rows, seq_block=seq)
    e, ratio = k2_check(f"K2 {name}", q, kn, vn, kc[:2], vc[:2], 1, pos,
                        **kw)
    err = max(err, e)
    pl = pos.long()
    live = p0 if seq else int(pos.sum())           # cache rows read
    nbytes = (2 * live * Hkv * 128 * esz + S * (Hq + 2 * Hkv) * 128 * 4
              + S * 2 * 128 * 4 + S * Hq * 128 * esz + 2 * S * Hkv * 128 * esz)
    b_ms, b_by = bound_ms(nbytes, 4 * Hq * 128 * int(pos.sum()))
    ms, host = cuda_ms(lambda i: decode_attention(
        q, kn, vn, kc, vc, i % L, pos, **kw), 64)
    p_ms, _ = cuda_ms(lambda i: decode_attention_plain(
        q, kn, vn, kc, vc, i % L, pos, **kw), 3, warmup=1, queued=False)
    t = torch.arange(MAX_SEQ, device=device)
    if seq:       # query i sees cache rows t <= p0 + i
        qs = q.to(torch.bfloat16).transpose(0, 1)[None]      # [1, Hq, S, D]
        mask = (t[None, :] <= pl[:, None])[None, None]
        lib, _ = cuda_ms(lambda i: F.scaled_dot_product_attention(
            qs, kc[i % L], vc[i % L], attn_mask=mask), 64)
    else:         # row b sees its own cache row up to pos[b]
        qs = q.to(torch.bfloat16)[:, :, None]                # [B, Hq, 1, D]
        mask = (t[None, :] <= pl[:, None])[:, None, None]
        lib, _ = cuda_ms(lambda i: F.scaled_dot_product_attention(
            qs, kc[i % L], vc[i % L], attn_mask=mask), 64)
    timed = (f"seq_block S={S} at pos {p0}.." if seq else
             f"B={S} rows at positions {pos.tolist()}")
    log(f"[time] K2 {name} ({timed}) kernel {ms:.4f} ms (host enqueue "
        f"{host:.4f} ms)  plain {p_ms:.4f} ms  SDPA {lib:.4f} ms  bound "
        f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB, {b_ms / ms:.1%} of "
        f"it); worst row {ratio:.2e}")
    return dict(name=f"decode_attention[{name}]", route="cuda",
                source="teal_tpu_torch/csrc/decode_attention.cu",
                replaces="teal_tpu/ops/attn_block.py:94", launches=launches,
                launches_per_token=launches / steps, max_abs_err=err, ms=ms,
                kernel_ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, timed=timed)


def step_kept_counts(params, cfg, th, device, rope, b: int = 16):
    """The kept count of every K1 call in one server decode step at batch
    b (the step `time_decode_step` times: token 7 at positions 40, 44, ...
    on an empty cache, the server's thresholds), read from the kernels'
    count outputs. Returns [L, 4] counts (qkv, o, gate|up, down)."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import attn_block, token_block

    counts = []
    real = token_block.select_gather_gemv

    def recording(*args, **kw):
        out = real(*args, **kw)
        counts.append(out[2])
        return out

    cache = llama.KVCache.init(cfg, b, MAX_SEQ, torch.bfloat16, device)
    try:
        token_block.select_gather_gemv = attn_block.select_gather_gemv = \
            recording
        llama.forward(params, torch.full((b, 1), 7, device=device), cache,
                      [40 + 4 * i for i in range(b)], th, cfg=cfg,
                      sp=SparsityConfig(**MAIN_SP), rope=rope)
    finally:
        token_block.select_gather_gemv = attn_block.select_gather_gemv = real
    kept = torch.cat(counts).reshape(cfg.n_layers, 4).cpu()
    caps = llama.token_path_caps(cfg, SparsityConfig(**MAIN_SP))
    for j, name in enumerate(STAGES):
        c = kept[:, j].float()
        log(f"[serve] kept groups in one batch-{b} decode step, {name}: "
            f"mean {float(c.mean()):.2f} (min {int(c.min())}, max "
            f"{int(c.max())}) of cap {caps[j]}, {float(c.mean()) / caps[j]:.1%}")
    return kept


def batched_phase(params, cfg, caps, device, gen, seed, rope):
    """Phase 9 on the bf16 params. Returns (kernels entries, results)."""
    e_k1 = check_k1_rows(params, cfg, caps, device, gen)
    e_k2 = check_k2_rows(cfg, device, gen, rope)
    th, serve = server_phase(params, cfg, device, seed, rope)
    verify = verify_phase(params, cfg, device, seed, rope)
    steps = time_decode_step(
        params, cfg, [(f"server batch {b}", MAIN_SP, b, th,
                       [40 + 4 * i for i in range(b)]) for b in STEP_BATCHES],
        device, rope)
    for b in STEP_BATCHES:
        r = steps[f"server batch {b}"]
        log(f"[serve] decode step at batch {b}: {b / r['wall_ms'] * 1e3:.1f} "
            f"tok/s from its wall time ({r['wall_ms']:.3f} ms wall, "
            f"{r['device_ms']:.3f} ms device, idle {r['idle_share']:.1%})")
    kept = step_kept_counts(params, cfg, th, device, rope)
    one = serve["oneshot"]
    v_launch = sum(r["launches"][1] for r in verify.values())
    v_steps = sum(-(-S // 8) for S in VERIFY_S)
    entries = [
        time_rows_kernels(params, params, cfg, caps, device, gen, rope,
                          "bf16", one["launches"][0], one["steps"], e_k1),
        time_k2_rows(cfg, device, gen, rope, one["launches"][1],
                     one["steps"], e_k2, "B=16"),
        time_k2_rows(cfg, device, gen, rope, v_launch, v_steps, e_k2,
                     "seq_block"),
    ]
    results = dict(
        server={k: ({kk: vv for kk, vv in v.items() if kk != "outs"}
                    if isinstance(v, dict) else v) for k, v in serve.items()},
        verify=verify, decode_step_ms=steps,
        step_kept_b16={name: kept[:, j].tolist()
                       for j, name in enumerate(STAGES)})
    return entries, results, th


# --- phase 11: long prompts: K6, the 2k prefill and eval_ppl ----------------

LONG_PROMPT = 2000               # tokens; the Generator pads it to 2048
LONG_NEW_TOKENS = 16
K6_HEADS = ((32, 32), (32, 8))   # (Hq, Hkv): Llama-2-7B; Mixtral / Mistral
K6_CHECK_S = (256, 320, 2048, 2560)   # 320: a last half query tile
K6_TIME_S = (2048, 2560)
K6_SETS = 4                      # input sets timed in turn (> L2 at S 2048)
PPL_CONTEXT, PPL_WINDOW, PPL_TOKENS = 2048, 512, 4096
# K6 in bf16 against its plain version, a (head, query) row at a time:
# two bf16 ulps of the row's largest value. Each side rounds its output
# to bf16 (one ulp is at most 2^-7 of the value); the probabilities are
# rounded to bf16 before PV on both sides, but at different points (the
# kernel the running, unnormalised weights, the plain version the
# normalised ones), each weight within 2^-9 of its value, which moves a
# row by far less than an ulp.
K6_BF16_ROW_TOL = 2 ** -6


def k6_inputs(S, Hq, Hkv, gen, device, dtype, B=1):
    """Random q [B, Hq, S, 128] and k / v [B, Hkv, S, 128]."""
    import torch

    return tuple(torch.randn(B, h, S, 128, generator=gen,
                             device=device).to(dtype)
                 for h in (Hq, Hkv, Hkv))


def check_k6_plan():
    """The wrapper's launch plan (`flash_prefill._plan`: query tiles,
    blocks, threads, shared bytes) equal to the kernel's
    (`teal_flash_prefill_plan`) for both types, B = 1 and 2, Hq = 8 and
    32, S = 64..4096, on this card's SM count."""
    import ctypes

    import torch

    from teal_tpu_torch import _build
    from teal_tpu_torch.ops import flash_prefill as fp

    fn = _build.load()["flash_prefill"].teal_flash_prefill_plan
    sms = _build.sm_count(torch.cuda.current_device())
    n = 0
    for dt in (torch.float32, torch.bfloat16):
        for B, Hq in ((1, 32), (2, 32), (1, 8)):
            for S in range(64, 4097, 64):
                out = (ctypes.c_int * 4)()
                fn(fp._DTYPE_CODE[dt], B, Hq, S, sms, out)
                tiles, _, blocks, threads, smem = fp._plan(dt, B, Hq, S, sms)
                want = (tiles, blocks, threads, smem)
                check(tuple(out) == want and smem <= fp.SMEM_LIMIT,
                      f"K6 plan at {dt} B={B} Hq={Hq} S={S}: the kernel's "
                      f"{tuple(out)}, the wrapper's {want}")
                n += 1
    log(f"[k6] the wrapper's launch plan equals the kernel's at all {n} "
        f"(type, B, Hq, S) shapes checked ({sms} SMs)")


def check_k6(device, gen):
    """K6 against its plain version, each (head, query) row held alone:
    bf16 at `K6_CHECK_S`, MHA and GQA, and at the calibration capture's
    shape (phase 12: B, S = `CALIB_BATCH`, the 7B's heads), the row's
    largest error within `K6_BF16_ROW_TOL` of the row's largest |value|;
    fp32 at S = 256 within 1e-4 of it (the FMA path: fp32 throughout, only
    the order of the sums differs); a second call bit-identical to the
    first. Returns the largest absolute error in bf16."""
    import torch

    from teal_tpu_torch.ops.flash_prefill import (
        flash_prefill_attention, flash_prefill_attention_plain)

    cases = [(torch.bfloat16, 1, S, Hq, Hkv, K6_BF16_ROW_TOL)
             for S in K6_CHECK_S for Hq, Hkv in K6_HEADS]
    cases.append((torch.bfloat16, *CALIB_BATCH, *K6_HEADS[0],
                  K6_BF16_ROW_TOL))
    cases += [(torch.float32, 1, 256, Hq, Hkv, 1e-4) for Hq, Hkv in K6_HEADS]
    worst = 0.0
    for dt, B, S, Hq, Hkv, rel in cases:
        what = f"K6 {dt} B={B} S={S} Hq={Hq} Hkv={Hkv}"
        q, k, v = k6_inputs(S, Hq, Hkv, gen, device, dt, B)
        got = flash_prefill_attention(q, k, v)
        want = flash_prefill_attention_plain(q, k, v)
        check(got.dtype == dt and got.shape == q.shape,
              f"{what}: output {got.dtype} {tuple(got.shape)}")
        check(torch.equal(flash_prefill_attention(q, k, v), got),
              f"{what}: two calls differ")
        err, ratio = row_check(what, got, want, rel)
        if dt == torch.bfloat16:
            worst = max(worst, err)
        log(f"[k6] {str(dt)[6:]:8s} B={B} S={S:4d} Hq={Hq} Hkv={Hkv:2d} "
            f"max_abs_err={err:.3e}, worst row {ratio:.3e} of the row's "
            f"largest value (tolerance {rel:g} a row); two calls "
            f"bit-identical")
    return worst


def time_k6(device, gen, launches, prefills, err, seqs=K6_TIME_S,
            heads=K6_HEADS, name="flash_prefill_attention"):
    """K6 at the 7B and GQA shapes (`heads`), S in `seqs`, bf16, `K6_SETS`
    input sets in turn: kernel, plain version, SDPA (causal, GQA) and the
    bound (the causal half of QK^T and PV at the bf16 peak; q, k, v and
    the output once). Returns the `kernels` entry (the first shape at its
    top level, every shape under "shapes")."""
    import torch
    import torch.nn.functional as F

    from teal_tpu_torch.ops.flash_prefill import (
        flash_prefill_attention, flash_prefill_attention_plain)

    rows = []
    for S in seqs:
        for Hq, Hkv in heads:
            sets = [k6_inputs(S, Hq, Hkv, gen, device, torch.bfloat16)
                    for _ in range(K6_SETS)]
            flops = 4 * 128 * Hq * S * (S + 1) / 2
            nbytes = (2 * Hq + 2 * Hkv) * S * 128 * 2
            b_ms, b_by = bound_ms(nbytes, flops)
            ms, host = cuda_ms(lambda i: flash_prefill_attention(
                *sets[i % K6_SETS]), 32)
            p_ms, _ = cuda_ms(lambda i: flash_prefill_attention_plain(
                *sets[i % K6_SETS]), 3, warmup=1, queued=False)
            lib, _ = cuda_ms(lambda i: F.scaled_dot_product_attention(
                *sets[i % K6_SETS], is_causal=True, enable_gqa=True), 32)
            rows.append(dict(S=S, Hq=Hq, Hkv=Hkv, ms=ms, host_ms=host,
                             plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                             bound_share=b_ms / ms, library_ms=lib,
                             tflop_s=flops / ms / 1e9))
            log(f"[time] K6 S={S} Hq={Hq} Hkv={Hkv:2d} kernel {ms:.4f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.1%} of the "
                f"bound, {ms / lib:.2f}x SDPA; host enqueue {host:.4f} ms)  "
                f"plain {p_ms:.4f} ms  SDPA {lib:.4f} ms  bound {b_ms:.4f} ms "
                f"({b_by}, {nbytes / 1e6:.1f} MB)")
    top = rows[0]
    return dict(name=name, route="cuda",
                source="teal_tpu_torch/csrc/flash_prefill.cu",
                replaces="teal_tpu/models/llama.py:138", launches=launches,
                launches_per_prefill=launches / prefills, max_abs_err=err,
                kernel_ms=top["ms"],
                timed=f"S={top['S']} Hq={top['Hq']} Hkv={top['Hkv']} bf16 "
                      "(one layer's prefill attention); every timed shape "
                      "under shapes",
                shapes=rows, **{k: top[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "bound_share",
                    "library_ms")})


def hold_prefill_layers(params, cfg, toks, rope, device, tag="[long]"):
    """Every layer of a pos-0 dense prefill of toks [B, S] through K6
    (`layer_forward` with `causal_prefill` and `capture`: what
    `calibrate` runs a layer) held to the plain path (the same layer
    under `plain_path`: K6's plain version) on the same layer input: the
    attention output (attn h2) a (head, query) row at a time within
    `K6_BF16_ROW_TOL` of the row's largest value, the layer's output
    within 2e-2 of scale, one K6 launch a layer. Returns (the worst row
    ratio of the attention output, the seconds of the kernel path's
    layers, each synchronised)."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama

    b, s = toks.shape
    dt = llama.compute_dtype(params)
    sp = SparsityConfig()
    th = torch.zeros(7, dtype=torch.float32, device=device)
    pos_t = torch.zeros(b, dtype=torch.int64, device=device)
    positions = torch.arange(s, device=device).expand(b, s)
    cos, sin = rope[0][positions], rope[1][positions]
    h = params["embed"][toks].to(dt)
    shape = (b, cfg.n_kv_heads, s, cfg.head_dim)
    heads = (b, s, cfg.n_heads, cfg.head_dim)
    worst, kernel_s = 0.0, 0.0
    for i in range(cfg.n_layers):
        lp = {n: llama._leaf(w, lambda a: a[i])
              for n, w in params["layers"].items()}
        caches = [torch.zeros(shape, dtype=dt, device=device)
                  for _ in range(4)]
        with plain_path():
            want, _, _, wcap = llama.layer_forward(
                h, lp, caches[0], caches[1], pos_t, cos, sin, cfg, sp, th,
                capture=True, causal_prefill=True)
        before = read_launches()[5]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, _, _, gcap = llama.layer_forward(
            h, lp, caches[2], caches[3], pos_t, cos, sin, cfg, sp, th,
            capture=True, causal_prefill=True)
        torch.cuda.synchronize()
        kernel_s += time.perf_counter() - t0
        check(read_launches()[5] == before + 1,
              f"prefill layer {i}: K6 launched {read_launches()[5] - before} "
              "times, expected once")
        err, ratio = row_check(
            f"prefill B={b} S={s} layer {i} attention: kernel vs plain",
            gcap["self_attn"]["h2"].reshape(heads),
            wcap["self_attn"]["h2"].reshape(heads), K6_BF16_ROW_TOL)
        worst = max(worst, ratio)
        h_err = rel_check(f"prefill B={b} S={s} layer {i} output: kernel vs "
                          "plain", got, want, 2e-2)
        if i in (0, cfg.n_layers - 1):
            log(f"{tag} prefill B={b} layer {i} kernel vs plain: attention "
                f"max_abs_err={err:.3e}, worst row {ratio:.3e} of its "
                f"largest value; layer output max_abs_err={h_err:.3e} "
                f"(scale {float(want.float().abs().max()):.3e})")
        h = want
    return worst, kernel_s


def long_prompt_run(params, cfg, device, seed, th):
    """Llama-2-7B, bf16, `Generator` on the main path: a `LONG_PROMPT`
    prompt padded to 2048 (K6 in every layer of its prefill, each layer
    held to the plain path), then `LONG_NEW_TOKENS` greedy tokens on the
    token path with the launch counts reset just before and read just
    after; the 2k prefill's seconds and peak memory with K6 against the
    plain `_attention` path, in turns. Returns results."""
    import numpy as np
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine import Generator
    from teal_tpu_torch.engine.generate import _pad_len
    from teal_tpu_torch.models import llama

    L = cfg.n_layers
    T = _pad_len(LONG_PROMPT)
    check(llama._can_flash_prefill(T, cfg.head_dim, cfg.sliding_window)
          and not llama._can_flash_prefill(_pad_len(max(PROMPT_LENS)),
                                           cfg.head_dim, cfg.sliding_window),
          "the K6 gate: the long prompt must take it, the short ones not")
    prompt = np.random.default_rng(seed + 11).integers(1, cfg.vocab_size,
                                                       LONG_PROMPT)
    gen = Generator(cfg, params, sp=SparsityConfig(**MAIN_SP), max_seq=T,
                    cache_dtype=torch.bfloat16, temperature=0.0,
                    device=device)
    padded = torch.zeros((1, T), dtype=torch.int64)
    padded[0, :LONG_PROMPT] = torch.from_numpy(prompt)
    padded = padded.to(device)
    t0 = time.perf_counter()
    worst, _ = hold_prefill_layers(params, cfg, padded, gen.rope, device)
    log(f"[long] every layer of the {T}-token prefill through K6 held to the "
        f"plain path (attention: worst row {worst:.2e} of its largest value, "
        f"tolerance {K6_BF16_ROW_TOL:g} a row) in "
        f"{time.perf_counter() - t0:.2f} s")

    gen.generate(prompt[:300], 2, thresholds=th)           # warm-up
    reset_launches()
    toks, st = gen.generate(prompt, LONG_NEW_TOKENS, thresholds=th)
    counts = read_launches()
    decoded = LONG_NEW_TOKENS - 1
    check_launches(counts, L, decoded, long_prefills=1)
    check(toks.shape == (1, LONG_PROMPT + LONG_NEW_TOKENS)
          and bool((toks >= 0).all() and (toks < cfg.vocab_size).all()),
          f"bad tokens {toks.shape}")
    log(f"[long] {LONG_PROMPT}-token prompt (padded to {T}), "
        f"{LONG_NEW_TOKENS} greedy tokens: launches (K1, K2, K3, K4, K5, K6) "
        f"{counts}; prefill {st.prefill_s:.4f} s (time to first token), "
        f"decode {st.tokens_per_s:.2f} tok/s at pos {LONG_PROMPT}-"
        f"{LONG_PROMPT + decoded - 1}; new tokens "
        f"{toks[0, LONG_PROMPT:].tolist()}")

    # the 2k prefill alone (dense forward, embedding to logits): K6
    # against the plain `_attention` path, in turns
    zero = llama.zero_thresholds(cfg, device)
    runs = {"kernel": [], "plain": []}
    last = {}
    for kind in ("kernel", "plain", "plain", "kernel", "kernel", "plain"):
        cache = gen.new_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lg, _ = llama.forward(params, padded, cache, 0, zero, cfg=cfg,
                              sp=SparsityConfig(), rope=gen.rope,
                              causal_prefill=kind == "kernel")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        last[kind] = lg[0, LONG_PROMPT - 1].float()
        runs[kind].append(dict(s=sec, peak_gib=peak / 2 ** 30,
                               peak_over_resident_gib=(peak - base) / 2 ** 30))
        del lg, cache
    for kind in runs:                    # the first of each: a warm-up
        runs[kind] = runs[kind][1:]
    device_ms = {}
    for kind in ("kernel", "plain"):
        def step():
            llama.forward(params, padded, gen.new_cache(), 0, zero, cfg=cfg,
                          sp=SparsityConfig(), rope=gen.rope,
                          causal_prefill=kind == "kernel")
        dev, rows = profile_device(step, 2)
        wall = sum(r["s"] for r in runs[kind]) / len(runs[kind]) * 1e3
        device_ms[kind] = dict(device_ms=dev, wall_ms=wall,
                               idle_share=max(0.0, 1.0 - dev / wall),
                               top=[(k, t) for k, t in rows[:6]])
        log(f"[long] {T}-token prefill via "
            f"{'K6' if kind == 'kernel' else 'the plain _attention'}: "
            f"device {dev:.3f} ms (sum of kernel times), wall {wall:.3f} ms, "
            f"device idle {device_ms[kind]['idle_share']:.1%}; top: "
            + "; ".join(f"{k[:48]} {t:.3f} ms" for k, t in rows[:6]))
    rel = float((last["kernel"] - last["plain"]).abs().max()
                / last["plain"].abs().max())
    # one main-path decode step at pos LONG_PROMPT on the prompt's own
    # cache (a K6 prefill), profiled: K2's share of the step
    lg, cache = llama.forward(params, padded, gen.new_cache(), 0, zero,
                              cfg=cfg, sp=SparsityConfig(), rope=gen.rope,
                              causal_prefill=True)
    tok = lg[:, LONG_PROMPT - 1:LONG_PROMPT].argmax(-1)
    del lg
    step = time_decode_step(params, cfg, [(f"pos {LONG_PROMPT}", MAIN_SP, 1,
                                           th, LONG_PROMPT)], device,
                            gen.rope, cache=cache, tok=tok)
    del cache
    for kind, rs in runs.items():
        log(f"[long] {T}-token prefill via "
            f"{'K6' if kind == 'kernel' else 'the plain _attention'}: "
            + ", ".join(f"{r['s']:.4f} s" for r in rs) + "; peak "
            + ", ".join(f"{r['peak_gib']:.2f} GiB "
                        f"(+{r['peak_over_resident_gib']:.2f})" for r in rs))
    log(f"[long] last prompt position's bf16 logits, K6 vs plain after {L} "
        f"layers: {rel:.2e} of scale (reported, not checked: 32 random bf16 "
        f"layers; each layer is held above)")
    return dict(launches=counts, decoded=decoded, worst=worst,
                prefill_s=st.prefill_s, tok_s=st.tokens_per_s,
                prefill=runs, prefill_device=device_ms,
                decode_step=step[f"pos {LONG_PROMPT}"],
                logits_rel_kernel_vs_plain=rel)


def ppl_run(params, cfg, device, seed, th):
    """`eval_ppl` on the 7B at context `PPL_CONTEXT` + window `PPL_WINDOW`
    over a `PPL_TOKENS`-token seeded stream: the bf16 model through K6,
    dense and with the group thresholds `th` on every window's prefill
    (the masked-dense group twin), K6 launched once a layer and window;
    then an fp32 copy through K6's fp32 path against the plain path, each
    window's NLL within 1e-4 relative. Returns results."""
    import numpy as np
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.eval import ppl

    L = cfg.n_layers
    ids = np.random.default_rng(seed + 12).integers(0, cfg.vocab_size,
                                                    PPL_TOKENS)
    n_win = len(list(ppl.windows(PPL_TOKENS, PPL_CONTEXT, PPL_WINDOW)))
    kw = dict(context_size=PPL_CONTEXT, window_size=PPL_WINDOW,
              device=device)
    out = {}

    def run(p, sp_kw, thr, kind):
        torch.cuda.synchronize()
        before = read_launches()
        t0 = time.perf_counter()
        with plain_path() if kind == "plain" else contextlib.nullcontext():
            nlls = ppl.window_nlls(p, cfg, ids, sp=SparsityConfig(**sp_kw),
                                   thresholds=thr, **kw)
        sec = time.perf_counter() - t0
        counts = tuple(a - b for a, b in zip(read_launches(), before))
        want = (0, 0, 0, 0, 0, 0 if kind == "plain" else L * n_win)
        check(counts == want, f"eval_ppl ({kind}): launches {counts}, "
              f"expected {want} for {n_win} windows")
        check(len(nlls) == n_win and all(np.isfinite(nlls)),
              f"eval_ppl ({kind}): window NLLs {nlls}")
        return nlls, sec

    for name, sp_kw, thr in (("bf16 dense", {}, None),
                             ("bf16 sparse", dict(TWIN_SP, apply_prefill=True),
                              th)):
        nlls, sec = run(params, sp_kw, thr, "kernel")
        out[name] = dict(ppl=float(np.exp(np.mean(nlls))), nlls=nlls, s=sec)
        log(f"[ppl] {name}: ppl {out[name]['ppl']:.4f} over {n_win} windows "
            f"of {PPL_CONTEXT} + {PPL_WINDOW} tokens (window NLLs "
            f"{[round(x, 5) for x in nlls]}), {sec:.2f} s")
    p32 = to_fp32(params)
    got, sec_k = run(p32, {}, None, "kernel")
    want, sec_p = run(p32, {}, None, "plain")
    del p32
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    check(rel <= 1e-4, f"fp32 eval_ppl: a window NLL through K6 is {rel:.2e} "
          f"relative from the plain path's (tolerance 1e-4): {got} vs {want}")
    out["fp32 dense"] = dict(ppl=float(np.exp(np.mean(got))), nlls=got,
                             nlls_plain=want, worst_rel=rel, s=sec_k,
                             s_plain=sec_p)
    log(f"[ppl] fp32 copy, dense: ppl {out['fp32 dense']['ppl']:.4f}; window "
        f"NLLs through K6 {[round(x, 6) for x in got]} vs the plain path "
        f"{[round(x, 6) for x in want]}: worst {rel:.2e} relative "
        f"(tolerance 1e-4); {sec_k:.2f} s vs {sec_p:.2f} s")
    return out


def long_prompt_phase(params, cfg, device, gen, seed, th):
    """Phase 11 on the resident bf16 7B params (`th`: the main path's
    thresholds from phase 4). Returns (kernels entries, results)."""
    from teal_tpu_torch.models import llama

    t0 = time.perf_counter()
    check_k6_plan()
    err = check_k6(device, gen)
    long = long_prompt_run(params, cfg, device, seed, th)
    ppl_res = ppl_run(params, cfg, device, seed, th)
    rope = llama.precompute_rope(cfg, 2048, device)
    k2n, steps = long["launches"][1], long["decoded"]
    entries = [time_k6(device, gen, long["launches"][5], 1, err),
               time_k2(cfg, device, gen, rope, k2n, steps, 0.0,
                       "decode_attention[pos 2047]")]
    sweep = k2_sweep(cfg, device, gen, rope)
    log(f"[long] phase 11 in {time.perf_counter() - t0:.1f} s")
    return entries, dict(long_prompt=long, ppl=ppl_res, k2_sweep=sweep)


# --- phase 12: calibration, the greedy allocation, permutations, GPTQ -------

CALIB_BATCH = (2, 2048)          # tokens; the reference takes 10 x 2048
CALIB_SPARSITY = 0.5             # uniform group sparsity of part 2
CUT_LAYERS = 2                   # the greedy / permutation / GPTQ cut
CUT_BATCH = (1, 2048)
GREEDY_TARGET = 0.5              # effective sparsity of the greedy run
CALIB_DIR = ROOT / "build" / "chip_smoke_calibration"


def calib_decode(params, cfg, th, device, seed, what, shares=None):
    """Hold every layer of one main-path decode step (the first prompt's
    next token after a dense prefill) at thresholds `th` [L, 7] to the
    plain path (`hold_token_layers`), then decode phase 4's three prompts
    on the main path with them, counts set to 0 just before: 4*L K1 and
    L K2 a decoded token. Returns (worst hold error, tok/s per prompt)."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine import Generator
    from teal_tpu_torch.models import llama

    dt = llama.compute_dtype(params)
    gen = Generator(cfg, params, sp=SparsityConfig(**MAIN_SP),
                    max_seq=MAX_SEQ, cache_dtype=dt, temperature=0.0,
                    device=device)
    prompts = main_prompts(cfg, seed)
    cache, tok, pos = calibration_token(params, cfg, prompts[0],
                                        gen.new_cache(), gen.rope, device)
    _, worst, _ = hold_token_layers(params, cfg, cache, tok, pos, gen.rope,
                                    device, th=th, shares=shares)
    gen.generate(prompts[0], 4, thresholds=th)              # warm-up
    reset_launches()
    outs = [gen.generate(p, NEW_TOKENS, thresholds=th) for p in prompts]
    decoded = len(prompts) * (NEW_TOKENS - 1)
    check_launches(read_launches(), cfg.n_layers, decoded)
    for p, (toks, _) in zip(prompts, outs):
        check(toks.shape == (1, len(p) + NEW_TOKENS)
              and bool((toks >= 0).all() and (toks < cfg.vocab_size).all()),
              f"{what}: bad tokens {toks.shape}")
    tok_s = [st.tokens_per_s for _, st in outs]
    log(f"[calib] {what}: every layer of a decode step held to the plain "
        f"path (worst error {worst:.2e} of scale, tolerance 2e-2); "
        f"{len(prompts)} requests, {decoded} decoded tokens, "
        f"{4 * cfg.n_layers} K1 + {cfg.n_layers} K2 launches a token; "
        f"tok/s {', '.join(f'{t:.2f}' for t in tok_s)}")
    return worst, tok_s


def stage_shares(shares, L: int, target: float):
    """Each stage's mean share of surviving groups (before the cap) and of
    kept groups over the L layers of one held step, beside the target."""
    out = {}
    for j, name in enumerate(STAGES):
        rows = shares[j::4]
        check(len(rows) == L, f"{len(shares)} K1 calls recorded for {L} "
              "layers")
        surv = sum(r[0] for r in rows) / L
        kept = sum(r[1] / r[2] for r in rows) / L
        out[name] = dict(survivors=surv, kept=kept)
        log(f"[calib] {name:8s}: surviving groups {surv:.3f}, kept "
            f"{kept:.3f} (cap {MAIN_SP['block_keep_frac']}), target kept "
            f"share {1 - target:.2f}")
    return out


def phase_launches(what: str, k6: int):
    """The counts since the last reset: `k6` K6 launches, nothing else."""
    counts = read_launches()
    check(counts == (0, 0, 0, 0, 0, k6), f"{what}: launches (K1, K2, K3, "
          f"K4, K5, K6) {counts}, expected {(0, 0, 0, 0, 0, k6)}")
    return counts


def greedy_forwards(rows) -> int:
    """The layer forwards `greedyopt.process_layer` ran for one layer, read
    from its results.csv rows: the dense target, then each step's trials
    (one for each projection still below sparsity 1 at the step's start)
    and its uniform baseline."""
    from teal_tpu_torch.calibration.thresholds import PROJS

    n, prev = 1, {p: 0.0 for p in PROJS}
    for row in rows:
        n += sum(prev[p] < 1 for p in PROJS) + 1
        prev = row
    return n


def gptq_vs_rtn(seen):
    """Each projection's GPTQ reconstruction error below round-to-nearest's
    (`tests/test_gptq.py::test_gptq_beats_rtn`'s claim) on the input
    `gptq_quantize_model` calibrated it on: `seen` holds its
    `on_projection` calls (layer, name, w, x, GPTQ weight). Returns
    {projection: [(gptq, rtn) per layer]}."""
    from teal_tpu_torch.ops import gptq

    errs = {}
    for l, name, w, x, wq in seen:
        e_g = gptq.reconstruction_error(w, wq, x)
        e_r = gptq.reconstruction_error(w, gptq.rtn_quantize_int4(w, wq.group),
                                        x)
        check(e_g < e_r, f"GPTQ layer {l} {name}: reconstruction error "
              f"{e_g:.4e} not below round-to-nearest's {e_r:.4e}")
        errs.setdefault(name, []).append((e_g, e_r))
    log("[calib] GPTQ's reconstruction error over round-to-nearest's, "
        "each projection (layer 0 / 1 / ...): "
        + ", ".join(f"{n} " + " / ".join(f"{g / r:.3f}" for g, r in v)
                    for n, v in errs.items()))
    return errs


def calibration_phase(params, cfg, device, seed):
    """Phase 12 on the resident bf16 7B params: the port's calibration run
    as a user of TEAL runs it, its captures through K6.
      1. `calibrate` over all layers with `CALIB_BATCH` tokens (group
         sizes `model_group_sizes(cfg, 32)` and 128): L K6 launches and no
         other; its seconds and peak memory; then every layer's capture at
         that shape held to the plain path (`hold_prefill_layers`), whose
         kernel side, timed alone, splits calibrate's seconds into device
         capture and host histograms;
      2. uniform group thresholds at `CALIB_SPARSITY` (G 128) on the main
         path (`calib_decode`), with each stage's survivor and kept shares;
      3. on a `CUT_LAYERS`-layer cut of the same weights at full widths:
         `calibrate` with the layer inputs saved and `run_greedy` to an
         effective sparsity of `GREEDY_TARGET` (K6 once per layer forward),
         `thresholds_for_greedy` / `group_thresholds_for_greedy`, and the
         cut decoded on the main path at the greedy group thresholds;
      4. `compute_permutations` (magnitude, G 128) and
         `apply_permutations` on the cut: the permuted model's dense
         logits on an fp32 copy within 1e-4 of scale of the unpermuted
         ones; the permuted cut calibrated and decoded on the main path;
      5. `gptq_quantize_model(sequential=True)` on the cut (`CUT_BATCH`
         tokens), every projection's error below round-to-nearest's on its
         calibration input (`gptq_vs_rtn`), `pack_int4_params` and Q4-main
         decode through K1's int4 plan.
    Every decode holds every layer of a step to the plain path. Returns
    the results for the JSON line."""
    import shutil

    import numpy as np
    import torch

    from teal_tpu_torch.calibration import calibrate, greedyopt, thresholds
    from teal_tpu_torch.calibration.gptq_runner import gptq_quantize_model
    from teal_tpu_torch.calibration.permute import (apply_permutations,
                                                    compute_permutations)
    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import quant

    t_phase = time.perf_counter()
    L = cfg.n_layers
    rng = np.random.default_rng(seed + 12)
    gs = tuple(sorted(set(thresholds.model_group_sizes(cfg, 32)) | {128}))
    shutil.rmtree(CALIB_DIR, ignore_errors=True)
    res = {"batch": list(CALIB_BATCH), "group_sizes": list(gs),
           "cut_layers": CUT_LAYERS, "cut_batch": list(CUT_BATCH)}

    def secs(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # 1. calibrate over every layer
    out = str(CALIB_DIR / "full")
    tokens = rng.integers(1, cfg.vocab_size, CALIB_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    calibrate(params, cfg, tokens, out, group_sizes=gs,
              save_layer_inputs=False)
    res["calibrate_s"] = secs(t0)
    res["calibrate_launches"] = phase_launches("calibrate", L)
    res["calibrate_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    worst, capture_s = hold_prefill_layers(
        params, cfg, torch.from_numpy(tokens).to(device),
        llama.precompute_rope(cfg, CALIB_BATCH[1], device), device,
        tag="[calib]")
    log(f"[calib] every layer's capture at B={CALIB_BATCH[0]} "
        f"S={CALIB_BATCH[1]} through K6 held to the plain path (attention: "
        f"worst row {worst:.2e} of its largest value, tolerance "
        f"{K6_BF16_ROW_TOL:g} a row) in {time.perf_counter() - t0:.2f} s")
    res["capture_hold_worst_row"] = worst
    res["calibrate_capture_s"] = capture_s
    res["calibrate_host_s"] = res["calibrate_s"] - capture_s
    log(f"[calib] calibrate: {L} layers x {CALIB_BATCH[0]} x "
        f"{CALIB_BATCH[1]} tokens, group sizes {gs}, in "
        f"{res['calibrate_s']:.2f} s (device capture "
        f"{capture_s:.2f} s, the same {L} captures timed alone in the "
        f"hold; host histograms and files {res['calibrate_host_s']:.2f} s), "
        f"peak {res['calibrate_peak_gib']:.2f} GiB allocated; launches "
        f"(K1..K6) {res['calibrate_launches']}")

    # 2. uniform calibrated group thresholds on the main path
    th_np = thresholds.group_thresholds_for_uniform(
        os.path.join(out, "histograms"), cfg, CALIB_SPARSITY, group_size=128)
    check(th_np.shape == (L, 7) and bool(np.isfinite(th_np).all())
          and bool((th_np > 0).all()), f"calibrated thresholds {th_np}")
    log("[calib] group thresholds at sparsity 0.5 (qkv, o, gate|up, down) "
        "min/max over layers: " + ", ".join(
            f"{th_np[:, c].min():.4g}/{th_np[:, c].max():.4g}"
            for c in (0, 3, 4, 6)))
    shares = []
    worst, tok_s = calib_decode(params, cfg, torch.from_numpy(th_np).to(
        device), device, seed, f"calibrated decode ({L} layers)", shares)
    res["decode"] = dict(worst=worst, tok_s=tok_s,
                         shares=stage_shares(shares, L, CALIB_SPARSITY))

    # 3. the greedy allocation on a cut of the same weights
    ccfg = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    cut = dict(params, layers={k: v[:CUT_LAYERS]
                               for k, v in params["layers"].items()})
    root = str(CALIB_DIR / "cut")
    ctoks = rng.integers(1, cfg.vocab_size, CUT_BATCH)
    reset_launches()
    t0 = time.perf_counter()
    calibrate(cut, ccfg, ctoks, root, group_sizes=gs)
    res["cut_calibrate_s"] = secs(t0)
    t0 = time.perf_counter()
    greedyopt.run_greedy(cut, ccfg, root, target_sparsity=GREEDY_TARGET)
    res["greedy_s"] = secs(t0)
    steps, n_fwd = [], 0
    for l in range(CUT_LAYERS):
        rows = thresholds.read_greedy_csv(
            os.path.join(root, "lookup", f"layer-{l}", "results.csv"))
        check(rows and rows[-1]["Effective Sparsity"] >= GREEDY_TARGET,
              f"greedy layer {l} stopped short of {GREEDY_TARGET}")
        steps.append(len(rows))
        n_fwd += greedy_forwards(rows)
        log(f"[calib] greedy layer {l}: {len(rows)} steps to effective "
            f"sparsity {rows[-1]['Effective Sparsity']:.4f}, error "
            f"{rows[-1]['Activation Error']:.4g} (uniform baseline "
            f"{rows[-1]['Baseline Error']:.4g}), sparsities "
            + " ".join(f"{p} {rows[-1][p]:.3f}" for p in thresholds.PROJS))
    res["greedy_launches"] = phase_launches("calibrate + run_greedy",
                                            CUT_LAYERS + n_fwd)
    res["greedy_steps"] = steps
    res["greedy_forwards"] = n_fwd
    log(f"[calib] cut calibrate {res['cut_calibrate_s']:.2f} s, run_greedy "
        f"{res['greedy_s']:.2f} s ({n_fwd} layer forwards, "
        f"{res['greedy_launches'][5]} K6 launches with the calibration's)")
    th_e = thresholds.thresholds_for_greedy(root, ccfg, GREEDY_TARGET)
    th_g = thresholds.group_thresholds_for_greedy(root, ccfg, GREEDY_TARGET,
                                                  block_size=128)
    for name, t in (("elementwise", th_e), ("group", th_g)):
        check(t.shape == (CUT_LAYERS, 7) and bool(np.isfinite(t).all())
              and bool((t >= 0).all()), f"greedy {name} thresholds {t}")
    log(f"[calib] greedy thresholds at {GREEDY_TARGET}: elementwise "
        f"{np.round(th_e, 4).tolist()}, group {np.round(th_g, 4).tolist()}")
    worst, tok_s = calib_decode(cut, ccfg, torch.from_numpy(th_g).to(device),
                                device, seed, "greedy decode (cut)")
    res["greedy_decode"] = dict(worst=worst, tok_s=tok_s)
    th_cut = torch.from_numpy(thresholds.group_thresholds_for_uniform(
        os.path.join(root, "histograms"), ccfg, CALIB_SPARSITY,
        group_size=128)).to(device)

    # 4. channel permutations on the cut
    reset_launches()
    t0 = time.perf_counter()
    perms = compute_permutations(cut, ccfg, ctoks, method="magnitude",
                                 block_size=128)
    pcut = apply_permutations(cut, perms, ccfg)
    res["permute_s"] = secs(t0)
    phase_launches("compute_permutations", CUT_LAYERS)
    ids = torch.from_numpy(ctoks[:, :64]).to(device)
    logits = []
    for tree in (cut, pcut):
        f32 = to_fp32(tree)
        cache = llama.KVCache.init(ccfg, 1, ids.shape[1], torch.float32,
                                   device)
        lg, _ = llama.forward(f32, ids, cache, 0,
                              llama.zero_thresholds(ccfg, device), cfg=ccfg,
                              sp=SparsityConfig())
        logits.append(lg)
        del f32, cache
    err = float((logits[1] - logits[0]).abs().max())
    scale = float(logits[0].abs().max())
    check(err <= 1e-4 * scale, f"permuted fp32 logits off by {err:.3e} "
          f"(scale {scale:.3e}, tolerance 1e-4 of it)")
    res["permuted_fp32_err"] = err / scale
    log(f"[calib] permutations (magnitude, G 128) computed and folded in "
        f"{res['permute_s']:.2f} s; permuted fp32 dense logits vs "
        f"unpermuted: max error {err:.3e} of scale {scale:.3e}")
    pout = str(CALIB_DIR / "permuted")
    calibrate(pcut, ccfg, ctoks, pout, group_sizes=(128,),
              save_layer_inputs=False)
    th_p = torch.from_numpy(thresholds.group_thresholds_for_uniform(
        os.path.join(pout, "histograms"), ccfg, CALIB_SPARSITY,
        group_size=128)).to(device)
    worst, tok_s = calib_decode(pcut, ccfg, th_p, device, seed,
                                "permuted decode (cut)")
    res["permuted_decode"] = dict(worst=worst, tok_s=tok_s)
    del pcut, logits

    # 5. GPTQ on the cut
    reset_launches()
    seen = []
    t0 = time.perf_counter()
    q = gptq_quantize_model(cut, ccfg, ctoks, group=128, sequential=True,
                            on_projection=lambda *a: seen.append(a))
    res["gptq_s_per_layer"] = secs(t0) / CUT_LAYERS
    phase_launches("gptq_quantize_model", 2 * CUT_LAYERS)
    log(f"[calib] GPTQ (sequential, group 128, {CUT_BATCH[1]} tokens): "
        f"{res['gptq_s_per_layer']:.2f} s a layer")
    errs = gptq_vs_rtn(seen)
    del seen
    res["gptq_over_rtn"] = {n: [g / r for g, r in v] for n, v in errs.items()}
    q4 = quant.pack_int4_params(q, block_size=128)
    del q
    worst, tok_s = calib_decode(q4, ccfg, th_cut, device, seed,
                                "GPTQ Q4-main decode (cut)")
    res["gptq_decode"] = dict(worst=worst, tok_s=tok_s)
    del q4, cut
    torch.cuda.empty_cache()
    shutil.rmtree(CALIB_DIR, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"[calib] phase 12 in {res['phase_s']:.1f} s")
    return res


# --- phase 13: speculative decoding at 7B ------------------------------------

SPEC_K = 4
SPEC_NEW_TOKENS = 32
SPEC_ALPHAS = (0.5, 0.9)
SPEC_ALPHA_NEW_TOKENS = 96
# a temperature-0 draw (probs at temperature 1e-5) takes a token other
# than the argmax with a probability below exp(-20) unless its logit lies
# within this of the largest
SPEC_NEAR_TIE = 20 * 1e-5


@contextlib.contextmanager
def recording_verify(rec):
    """Inside the block, each `llama.block_verify` call appends (its first
    position, its logits [S, V] fp32, the cache it wrote into, and the K/V
    rows it wrote) to `rec`."""
    from teal_tpu_torch.models import llama

    orig = llama.block_verify

    def verify(params, tokens, cache, pos, *a, **kw):
        lg, c = orig(params, tokens, cache, pos, *a, **kw)
        s = tokens.shape[1]
        rec.append(dict(pos=int(pos), tokens=tokens.clone(),
                        logits=lg[0].float().clone(), cache=c,
                        k=c.k[:, 0, :, pos:pos + s].clone(),
                        v=c.v[:, 0, :, pos:pos + s].clone()))
        return lg, c

    llama.block_verify = verify
    try:
        yield
    finally:
        llama.block_verify = orig


def check_spec_rounds(rec, toks, what):
    """The checks of one temperature-0 speculative generation (all tokens
    `toks`) against its recorded verifies: every token a round emitted is
    the argmax of its verify row (or lies within `SPEC_NEAR_TIE` of it,
    counted), and the cache rows pos..pos+m-1 of the round's m emitted
    tokens hold the verify's K/V bit for bit at the end. Returns (rounds
    checked, tokens checked, near ties)."""
    import torch

    cache = rec[0]["cache"]
    n_tok = near = 0
    for r, v in enumerate(rec):
        pos = v["pos"]
        end = rec[r + 1]["pos"] if r + 1 < len(rec) else len(toks) - 1
        m = end - pos
        check(1 <= m <= v["logits"].shape[0], f"{what} round {r}: {m} "
              f"tokens emitted by a verify of {v['logits'].shape[0]}")
        lg = v["logits"][:m]
        emitted = torch.as_tensor(toks[pos + 1:pos + 1 + m],
                                  device=lg.device)
        top = lg.max(-1).values
        got = lg.gather(-1, emitted[:, None])[:, 0]
        exact = lg.argmax(-1) == emitted
        check(bool((exact | (got >= top - SPEC_NEAR_TIE)).all()),
              f"{what} round {r}: emitted {emitted.tolist()}, verify argmax "
              f"{lg.argmax(-1).tolist()}")
        near += int((~exact).sum())
        n_tok += m
        for name in ("k", "v"):
            rows = getattr(cache, name)[:, 0, :, pos:pos + m]
            check(torch.equal(rows, v[name][:, :, :m]), f"{what} round {r}: "
                  f"cache {name} rows {pos}..{pos + m - 1} are not the "
                  "verify's")
    return len(rec), n_tok, near


def spec_launches(got, L: int, live: int, rounds: int, what: str):
    """K1 4*L and K2 L a live draft step and a verify chunk (k + 1 <= 8
    positions: one chunk a round), no other kernel."""
    want = (4 * L * (live + rounds), L * (live + rounds), 0, 0, 0, 0)
    check(tuple(got) == want, f"{what}: launches (K1, K2, K3, K4, K5, K6) "
          f"{tuple(got)}, expected {want} for {live} draft steps and "
          f"{rounds} verifies")


def spec_run(params, cfg, prompt, n, device, th, seed, draft=MAIN_SP,
             **kw):
    """One speculative generation on the resident 7B: self-speculation on
    one shared cache, the draft the `draft` config (the main path's) at
    `th`, the dense verify through `block_verify`, synchronised and timed.
    Returns (tokens, stats, wall seconds)."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine.speculative import speculative_generate
    from teal_tpu_torch.models import llama

    kw.setdefault("temperature", 0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, st = speculative_generate(
        params, params, cfg, cfg, prompt, n, speculate_k=SPEC_K,
        max_seq=MAX_SEQ, draft_sp=SparsityConfig(**draft),
        draft_thresholds=th, cache_dtype=llama.compute_dtype(params),
        generator=torch.Generator(device=device).manual_seed(seed),
        device=device, **kw)
    torch.cuda.synchronize()
    return toks, st, time.perf_counter() - t0


def speculative_phase(params, cfg, device, seed, th, speeds):
    """Phase 13 on the resident bf16 7B at phase 4's thresholds `th`:
    self-speculation with a shared cache (k = `SPEC_K`; the draft the
    main-path config, the dense verify through `block_verify`):
      1. phase 4's three prompts, `SPEC_NEW_TOKENS` new tokens each, and
         the third again with the draft at keep 1.0 and zero thresholds
         (whose proposals the verify accepts; at least one must be), at
         temperature 0 with every verify recorded (`recording_verify`):
         per round 4*L K1 + L K2 a draft step and a verify chunk
         (`spec_launches`); every emitted token the argmax of its verify
         row and the cache rows of the emitted tokens the verify's
         (`check_spec_rounds`); then the same generation unrecorded and
         timed (the same tokens): t_round, tok/s, mean accepted;
      2. the first round's verify rerun on the final cache (the rows
         before it are the prefill's): the logits equal to the recorded
         ones, every layer of the chunk held to the plain path
         (`hold_token_layers(verify=True)`, 2e-2 of scale); the bf16
         logits beside the plain path's reported; the same verify on an
         fp32 copy of the weights and cache through the kernels held to
         the plain path within 2e-2 of scale (in bf16 the 32 random
         layers drift the logits several 1e-2 apart, phase 9);
      3. dense decode (`Generator`) and speculation on the 40-token prompt
         in turns; `forced_alpha` at `SPEC_ALPHAS` (`SPEC_ALPHA_NEW_TOKENS`
         tokens): tok/s and the realized acceptance (accepted over
         attempted draws), within 4 binomial standard deviations of alpha;
      4. `device_loop=True, adaptive_k=True`: the host loop's tokens,
         k_eff_final and alpha_hat_final.
    Returns the results for the JSON line."""
    import numpy as np
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine import Generator
    from teal_tpu_torch.models import llama

    t_phase = time.perf_counter()
    L = cfg.n_layers
    prompts = main_prompts(cfg, seed)
    res = {"k": SPEC_K, "new_tokens": SPEC_NEW_TOKENS, "runs": []}
    spec_run(params, cfg, prompts[0], 8, device, th, seed)      # warm-up

    # 1. three requests, and the third again with the draft at keep 1.0
    # (zero thresholds: a dense draft through the same kernels, whose
    # proposals the verify accepts), checked, then timed
    host_toks = []
    zero = llama.zero_thresholds(cfg, device)
    cases = [(f"prompt {len(p)}", p, MAIN_SP, th) for p in prompts]
    cases.append((f"prompt {len(prompts[2])} keep 1.0", prompts[2],
                  dict(MAIN_SP, block_keep_frac=1.0), zero))
    for i, (what, p, draft, dth) in enumerate(cases):
        rec = []
        reset_launches()
        with recording_verify(rec):
            toks, st, _ = spec_run(params, cfg, p, SPEC_NEW_TOKENS, device,
                                   dth, seed, draft=draft)
        got = read_launches()
        rounds = len(st["accepted_per_step"])
        check(len(rec) == rounds, f"spec {what}: {len(rec)} block_verify "
              f"calls for {rounds} rounds")
        spec_launches(got, L, SPEC_K * rounds, rounds, f"spec {what}")
        check(toks.shape == (len(p) + SPEC_NEW_TOKENS,)
              and bool((toks >= 0).all() and (toks < cfg.vocab_size).all()),
              f"spec {what}: bad tokens {toks.shape}")
        _, n_tok, near = check_spec_rounds(rec, toks, f"spec {what}")
        toks2, st2, wall = spec_run(params, cfg, p, SPEC_NEW_TOKENS, device,
                                    dth, seed, draft=draft)
        check(np.array_equal(toks, toks2) and st2 == st, f"spec {what}: the "
              "timed run differs from the checked one")
        run = dict(what=what, prompt=len(p), rounds=rounds,
                   mean_accepted=st["mean_accepted"],
                   accepted=st["accepted_per_step"], launches=got,
                   wall_s=wall, t_round_ms=wall * 1e3 / rounds,
                   tok_s=st["new_tokens"] / wall, near_ties=near,
                   new_tokens=toks[len(p):].tolist())
        res["runs"].append(run)
        host_toks.append(toks)
        log(f"[spec] {what}: {rounds} rounds, mean accepted "
            f"{st['mean_accepted']:.3f} {st['accepted_per_step']}; launches "
            f"(K1, K2, K3, K4, K5, K6) {got} = {SPEC_K + 1} x (4L K1 + L K2) "
            f"a round; {n_tok} emitted tokens each the argmax of its verify "
            f"row ({near} within {SPEC_NEAR_TIE:g} of it), the emitted "
            f"rows of the cache the verifies' bit for bit; t_round "
            f"{run['t_round_ms']:.2f} ms, {run['tok_s']:.2f} tok/s")
        if i == 0:
            first = rec[0]
        del rec
    check(res["runs"][-1]["mean_accepted"] > 0, "spec: the keep-1.0 draft "
          "had no proposal accepted")
    res["keep1_same_tokens"] = bool(np.array_equal(host_toks[2],
                                                   host_toks[3]))
    log(f"[spec] the keep-1.0 draft's tokens equal the main-path draft's on "
        f"the same prompt (both the dense verify's argmax; reported): "
        f"{res['keep1_same_tokens']}")

    # 2. the first round's verify on the same inputs
    pos, stoks = first["pos"], first["tokens"]
    S = stoks.shape[1]
    rope = llama.precompute_rope(cfg, MAX_SEQ, device)
    base = first["cache"]
    c = llama.KVCache(base.k.clone(), base.v.clone())
    lg, _ = llama.block_verify(params, stoks, c, pos, zero, cfg=cfg,
                               rope=rope)
    check(torch.equal(lg[0].float(), first["logits"]), "spec: the first "
          "round's verify rerun differs from the recorded one")
    _, worst, _ = hold_token_layers(
        params, cfg, llama.KVCache(base.k.clone(), base.v.clone()),
        stoks[0], list(range(pos, pos + S)), rope, device, verify=True)
    with plain_path():
        plg, _ = llama.block_verify(
            params, stoks, llama.KVCache(base.k.clone(), base.v.clone()),
            pos, zero, cfg=cfg, rope=rope)
    bf16_rel = float((lg - plg).abs().max() / plg.abs().max())
    del c, plg
    p32 = to_fp32(params)
    lgs = []
    for plain in (False, True):
        c = llama.KVCache(base.k.float(), base.v.float())
        with plain_path() if plain else contextlib.nullcontext():
            lgs.append(llama.block_verify(p32, stoks, c, pos, zero, cfg=cfg,
                                          rope=rope)[0])
        del c
    err = rel_check("spec: fp32 verify logits vs the plain path", lgs[0],
                    lgs[1], 2e-2)
    fp32_rel = err / float(lgs[1].abs().max())
    del p32, lgs, first, base
    torch.cuda.empty_cache()
    res.update(verify_worst=worst, verify_bf16_rel_plain=bf16_rel,
               verify_fp32_rel_plain=fp32_rel)
    log(f"[spec] first round's verify (S = {S} at pos {pos}) rerun on the "
        f"final cache: logits equal to the recorded ones; every layer held "
        f"to the plain path (worst {worst:.2e} of scale, tolerance 2e-2); "
        f"bf16 logits vs the plain path {bf16_rel:.2e} of scale (reported); "
        f"fp32 copy through the kernels vs the plain path {fp32_rel:.2e} of "
        f"scale (tolerance 2e-2)")

    # 3. dense decode and speculation in turns; forced acceptance rates
    dense = Generator(cfg, params, sp=SparsityConfig(), max_seq=MAX_SEQ,
                      cache_dtype=llama.compute_dtype(params),
                      temperature=0.0,
                      device=device)
    turns = {"dense": [], "spec": []}
    for kind in ("dense", "spec", "spec", "dense"):
        if kind == "dense":
            turns[kind].append(dense.generate(
                prompts[2], SPEC_NEW_TOKENS)[1].tokens_per_s)
        else:
            _, st, wall = spec_run(params, cfg, prompts[2], SPEC_NEW_TOKENS,
                                   device, th, seed)
            turns[kind].append(st["new_tokens"] / wall)
    res["tok_s_in_turns"] = turns
    res["phase4_tok_s"] = speeds
    log(f"[spec] tok/s in turns (prompt 40, {SPEC_NEW_TOKENS} tokens; "
        f"speculation counts the prefill in its wall): dense decode "
        f"{turns['dense']}, speculation {turns['spec']}; phase 4: dense "
        f"{speeds['dense']}, main-path sparse {speeds['sparse']}")
    res["forced"] = {}
    for alpha in SPEC_ALPHAS:
        reset_launches()
        _, st, wall = spec_run(params, cfg, prompts[2],
                               SPEC_ALPHA_NEW_TOKENS, device, th, seed,
                               forced_alpha=alpha)
        acc = np.asarray(st["accepted_per_step"])
        rounds = len(acc)
        spec_launches(read_launches(), L, SPEC_K * rounds, rounds,
                      f"spec forced_alpha {alpha}")
        att = acc + (acc < SPEC_K)
        rate, n = float(acc.sum() / att.sum()), int(att.sum())
        sd = math.sqrt(alpha * (1 - alpha) / n)
        check(abs(rate - alpha) <= 4 * sd, f"spec forced_alpha {alpha}: "
              f"realized acceptance {rate:.4f} over {n} draws, more than 4 "
              f"standard deviations ({sd:.4f}) away")
        res["forced"][str(alpha)] = dict(
            rounds=rounds, mean_accepted=st["mean_accepted"], rate=rate,
            draws=n, sd=sd, wall_s=wall, t_round_ms=wall * 1e3 / rounds,
            tok_s=st["new_tokens"] / wall)
        log(f"[spec] forced_alpha {alpha}: {rounds} rounds, mean accepted "
            f"{st['mean_accepted']:.3f}, realized acceptance {rate:.4f} over "
            f"{n} draws (alpha {alpha} +- 4 x {sd:.4f}); t_round "
            f"{wall * 1e3 / rounds:.2f} ms, {st['new_tokens'] / wall:.2f} "
            "tok/s")

    # 4. the device loop with adaptive depth
    reset_launches()
    toks, st, wall = spec_run(params, cfg, prompts[0], SPEC_NEW_TOKENS,
                              device, th, seed, device_loop=True,
                              adaptive_k=True)
    k1, k2, *rest = got = read_launches()
    check(np.array_equal(toks, host_toks[0]), "spec: the adaptive device "
          "loop's tokens differ from the host loop's")
    r = st["rounds"]
    check(k1 == 4 * k2 and 4 * L * r <= k1 <= 4 * L * (SPEC_K + 1) * r
          and not any(rest), f"spec adaptive: launches {got} for {r} rounds")
    res["adaptive"] = dict(rounds=r, k_eff_final=st["k_eff_final"],
                           alpha_hat_final=st["alpha_hat_final"],
                           mean_accepted=st["mean_accepted"],
                           draft_steps=k2 // L - r, wall_s=wall,
                           tok_s=st["new_tokens"] / wall, launches=got)
    log(f"[spec] device_loop + adaptive_k (prompt 5): the host loop's "
        f"tokens; {r} rounds, {k2 // L - r} draft steps, k_eff_final "
        f"{st['k_eff_final']}, alpha_hat_final {st['alpha_hat_final']:.4f}, "
        f"mean accepted {st['mean_accepted']:.3f}, "
        f"{st['new_tokens'] / wall:.2f} tok/s")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"[spec] phase 13 in {res['phase_s']:.1f} s")
    return res


# --- phase 14: the CLI at 7B widths -------------------------------------------

CLI_MODEL = ("7B", 2)             # --model, --n-layers
CLI_DIR = ROOT / "build" / "chip_smoke_cli"
CLI_CALIB = (2, 2048)            # calibrate --batch, --seq-len
CLI_PPL = (4096, 2048, 512)      # ppl --num-tokens, --context-size,
                                 # --window-size
CLI_NEW_TOKENS = 16
CLI_QUERY = ("A long context for the scorer: " * 8).strip()  # 247 bytes


def cli_run(argv, what):
    """`teal_tpu_torch.cli.main(argv)` in-process with its output captured,
    the launch counts reset just before and read just after. Returns
    (stdout, stderr, seconds, launches, peak GiB)."""
    import io

    import torch

    from teal_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            cli.main(argv)
    except SystemExit as e:
        raise SmokeFailure(f"cli {what}: exit {e.code}\n{err.getvalue()}")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[cli] {what}: {secs:.2f} s, peak {peak:.2f} GiB, launches (K1, K2, "
        f"K3, K4, K5, K6) {got}; stderr tail "
        f"{err.getvalue().strip().splitlines()[-1:]}")
    return out.getvalue(), err.getvalue(), secs, got, peak


def gen_count(err: str) -> int:
    """The new-token count of `generate`'s stats line on stderr."""
    return int(err.split("[")[-1].split(" tokens")[0])


def cli_phase(device):
    """Phase 14: `teal_tpu_torch.cli.main` in-process at the 7B widths on a
    `CLI_MODEL[1]`-layer cut (`--random-init`, seed 0), each command with
    the launch counts reset just before and read just after, its seconds
    and peak memory: generate dense (no kernel); calibrate (`CLI_CALIB`
    synthetic tokens, group size 128: one K6 launch a layer); generate
    sparse at its group thresholds (`--kernel block --group-thresholds
    --block-size 128`: 4*L K1 + L K2 a decoded token, with --metrics);
    self-speculation (`--speculate-k 4 --self-speculate`, with --metrics
    and --profile: a non-empty trace directory; (k + 1) * (4*L K1 + L K2)
    a round); ppl at `CLI_PPL` (K6 L a window); eval of a task file whose
    contexts pass 128 tokens (K6 L a scored sequence and L for the
    generated one's prefill); quantize --mode int4, then generate from
    its store (K1's int4 plan after the repack, 4*L K1 + L K2 a token);
    and one sparse generate as a subprocess, `python -m
    teal_tpu_torch.cli`, exit 0. Returns the results for the JSON line."""
    import shutil

    import torch

    from teal_tpu_torch.eval.ppl import windows

    t_phase = time.perf_counter()
    model, L = CLI_MODEL
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    base = ["--model", model, "--n-layers", str(L), "--device", device.type]
    init = base + ["--random-init"]
    gen = ["--prompt", "Hello, my name is", "--max-new-tokens",
           str(CLI_NEW_TOKENS), "--temperature", "0", "--max-seq", "512"]
    hist = str(CLI_DIR / "calib" / "histograms")
    sparse = ["--kernel", "block", "--block-size", "128",
              "--group-thresholds", "--sparsity", "0.5", "--hist-path", hist]
    metrics, prof = CLI_DIR / "metrics.jsonl", CLI_DIR / "trace"
    decoded = CLI_NEW_TOKENS - 1
    res = {}

    def run(name, argv, want=None):
        out, err, secs, got, peak = cli_run(argv, name)
        if want is not None:
            check(got == want, f"cli {name}: launches {got}, expected {want}")
        res[name] = dict(s=secs, peak_gib=peak, launches=got)
        return out, err, got

    _, err, _ = run("generate dense", ["generate"] + init + gen,
                    (0, 0, 0, 0, 0, 0))
    check(gen_count(err) == CLI_NEW_TOKENS, f"cli generate dense: {err}")
    out, _, _ = run("calibrate", ["calibrate"] + init + [
        "--output-path", str(CLI_DIR / "calib"), "--batch",
        str(CLI_CALIB[0]), "--seq-len", str(CLI_CALIB[1]),
        "--no-layer-inputs", "--group-sizes", "128"], (0, 0, 0, 0, 0, L))
    check(all(os.path.isdir(os.path.join(hist, f"layer-{l}"))
              for l in range(L)), f"cli calibrate: no histograms in {hist}")
    tok_path = (4 * L * decoded, L * decoded, 0, 0, 0, 0)
    _, err, _ = run("generate sparse", ["generate"] + init + gen + sparse
                    + ["--metrics", str(metrics)], tok_path)
    check(gen_count(err) == CLI_NEW_TOKENS, f"cli generate sparse: {err}")
    _, err, got = run("generate speculative", ["generate"] + init + gen + [
        "--speculate-k", "4", "--self-speculate", "--block-size", "128",
        "--metrics", str(metrics), "--profile", str(prof)])
    per_round = 5 * 4 * L
    check(got[0] > 0 and got[0] % per_round == 0 and got[0] == 4 * got[1]
          and not any(got[2:]), f"cli speculative: launches {got}")
    check(f"{CLI_NEW_TOKENS} tokens" in err and "mean accepted" in err,
          f"cli speculative: {err}")
    check(prof.is_dir() and any(prof.iterdir()), "cli speculative: empty "
          "trace directory")
    lines = [json.loads(l) for l in metrics.read_text().splitlines()]
    check(len(lines) == 2 and lines[1]["speculate_k"] == 4,
          f"cli metrics: {lines}")
    res["generate speculative"].update(
        rounds=got[0] // per_round,
        mean_accepted=lines[1]["mean_accepted"],
        trace_files=sorted(p.name for p in prof.iterdir()))
    n_tok, ctx, win = CLI_PPL
    n_win = len(list(windows(n_tok, ctx, win)))
    out, _, _ = run("ppl", ["ppl"] + init + [
        "--num-tokens", str(n_tok), "--context-size", str(ctx),
        "--window-size", str(win)], (0, 0, 0, 0, 0, L * n_win))
    ppl = float(out.split("dense ppl: ")[1].split()[0])
    check(math.isfinite(ppl) and ppl > 1, f"cli ppl: {out}")
    res["ppl"]["value"] = ppl
    task = CLI_DIR / "task.json"
    task.write_text(json.dumps([
        {"name": "mc", "type": "multiple_choice", "docs": [
            {"query": CLI_QUERY, "choices": [" one", " two"], "gold": 0},
            {"query": CLI_QUERY + "?", "choices": [" yes", " no"],
             "gold": 1}]},
        {"name": "gen", "type": "generate", "until": ["\n"],
         "max_gen_toks": 4, "docs": [{"query": CLI_QUERY, "target": "x"}]}]))
    out, _, _ = run("eval", ["eval"] + init + ["--task-file", str(task)],
                    (0, 0, 0, 0, 0, 5 * L))
    ev = json.loads(out)
    check(sorted(ev) == ["gen", "mc"] and 0 <= ev["mc"]["acc"] <= 1,
          f"cli eval: {ev}")
    res["eval"]["results"] = ev
    q4 = str(CLI_DIR / "q4")
    run("quantize int4", ["quantize"] + init + ["--mode", "int4",
                                                "--output-path", q4],
        (0, 0, 0, 0, 0, 0))
    _, err, _ = run("generate int4", ["generate"] + base + [
        "--checkpoint", q4] + gen + sparse, tok_path)
    check(gen_count(err) == CLI_NEW_TOKENS, f"cli generate int4: {err}")

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "teal_tpu_torch.cli", "generate"] + init
        + gen + sparse, cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"cli subprocess: exit {proc.returncode}\n"
          f"{proc.stderr[-3000:]}")
    check(gen_count(proc.stderr) == CLI_NEW_TOKENS,
          f"cli subprocess: {proc.stderr[-2000:]}")
    res["subprocess generate sparse"] = dict(s=secs, rc=proc.returncode)
    log(f"[cli] python -m teal_tpu_torch.cli generate (sparse, "
        f"{CLI_NEW_TOKENS} tokens) as a subprocess: exit 0 in {secs:.2f} s; "
        f"stderr tail {proc.stderr.strip().splitlines()[-1:]}")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"[cli] phase 14 in {res['phase_s']:.1f} s")
    return res


# --- phase 10: Mixtral-8x7B on the token path's MoE branch -----------------

MOE_MODEL = "Mixtral-8x7B"
# (weights, layers): int8 at full depth, bf16 at 8 layers (full width)
MOE_RUNS = (("int8", None), ("bf16", 8))
MOE_ROUTE_LAYERS = 4             # K5 checked on synthetic routers
MOE_PSEUDO = {"int8": (255, 100, 0), "bf16": (63, 20, 0)}


def mixtral_params(cfg, gen, device, int8: bool):
    """Mixtral at cfg's width and depth, random weights drawn on the card
    from `gen` one layer at a time: each layer by the port's `init_params`
    in bf16 (at a vocabulary of 8: the embedding and head are drawn once
    after) and, with `int8`, quantized by `quantize_params_int8` before the
    next is drawn, so that no bf16 copy of the whole model is ever held.
    Returns (params, seconds)."""
    import dataclasses

    import torch

    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import quant

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = dataclasses.replace(cfg, n_layers=1, vocab_size=8)
    L, layers = cfg.n_layers, {}
    for i in range(L):
        lp = llama.init_params(one, gen, torch.bfloat16, device)
        if int8:
            lp = quant.quantize_params_int8(lp)
        for name, leaf in lp["layers"].items():
            if name not in layers:
                layers[name] = llama._leaf(leaf, lambda a: torch.empty(
                    (L, *a.shape[1:]), dtype=a.dtype, device=device))
            dst = layers[name]
            for key in (leaf if isinstance(leaf, dict) else (None,)):
                d, s = (dst, leaf) if key is None else (dst[key], leaf[key])
                d[i] = s[0]
        del lp
    V, D = cfg.vocab_size, cfg.dim
    embed = (torch.randn((V, D), generator=gen, device=device)
             * 0.02).bfloat16()
    head = (torch.randn((D, V), generator=gen, device=device)
            * 0.02).bfloat16()
    if int8:
        q = quant.quantize_int8(head)
        head = {"q": q.q, "scale": q.scale}
    params = {"embed": embed, "layers": layers, "lm_head": head,
              "final_norm": torch.ones(D, dtype=torch.bfloat16,
                                       device=device)}
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


# K5's check shapes (D, E, k_exp): Mixtral's and three (E, k) at its D,
# a D that is no multiple of the cluster's split (1020 over 8 blocks), and
# D = 1000 at E = 1, whose blocks' router slabs start off 16 bytes
K5_CHECK_SHAPES = ((4096, 8, 2), (4096, 4, 1), (4096, 16, 4), (4096, 64, 8),
                   (1020, 8, 2), (1000, 1, 1))
# K5's plan held to the kernel's at these D and E
K5_PLAN_D = (1, 100, 255, 1000, 1020, 1024, 4096, 6144, 8192, 16384)
K5_PLAN_E = (1, 4, 8, 16, 64, 65)


def check_k5_plan():
    """The wrapper's K5 plan (`token_block._route_plan`: cluster, rows a
    block, shared bytes) equal to the kernel's (`teal_moe_route_plan`)."""
    import torch

    from teal_tpu_torch import _build
    from teal_tpu_torch.ops import token_block as tb

    lib = _build.load()["moe_route"]
    out = torch.zeros(3, dtype=torch.int32)
    for D in K5_PLAN_D:
        for E in K5_PLAN_E:
            lib.teal_moe_route_plan(D, E, out.data_ptr())
            got, want = tuple(int(v) for v in out), tb._route_plan(D, E)
            check(got[2] == -1 if want is None else got == want,
                  f"K5 plan at D = {D}, E = {E}: kernel {got}, wrapper "
                  f"{want}")
    log(f"[k5] plan equal to the kernel's at D in {K5_PLAN_D}, E in "
        f"{K5_PLAN_E}")


def k5_cases(E: int, k: int):
    """K5's check cases at E experts: (name, {expert: router column as a
    multiple of xn}, the experts expected first): random routers; experts
    1 and E - 1 equal and on top; expert 0 on top and 1, E - 1 tied for
    second (the lower expert must win each tie)."""
    cases = [("random", {}, None)]
    if E >= 3:
        cases += [("tie first", {1: 4e-3, E - 1: 4e-3}, [1, E - 1]),
                  ("tie second", {0: 8e-3, 1: 4e-3, E - 1: 4e-3},
                   [0, 1, E - 1])]
    return [(n, cols, None if want is None else want[:k])
            for n, cols, want in cases]


def check_k5(device, gen, shapes=K5_CHECK_SHAPES, plan: bool = True):
    """K5 against its plain version on a bf16 stream and fp32 routers of
    `MOE_ROUTE_LAYERS` layers at each (D, E, k_exp) of `shapes`:
    identical routed pseudo-layers, xn within one bf16 ulp, weights
    within 1e-6, the lower expert winning every tie (`k5_cases`). Logs
    how many xn elements differ from the plain version's at all. With
    `plan`, first `check_k5_plan`. Returns (the largest absolute error,
    {shape: (differing xn elements, xn elements)})."""
    import torch

    from teal_tpu_torch.ops import token_block as tb

    if plan:
        check_k5_plan()
    Lr = MOE_ROUTE_LAYERS
    worst, differ = 0.0, {}
    for D, E, k in shapes:
        router = torch.randn(Lr, D, E, generator=gen, device=device) * 0.02
        norm = (1 + 0.1 * torch.randn(Lr, D, generator=gen, device=device)
                ).bfloat16()
        n_diff = n_all = 0
        for li in range(Lr):
            x = torch.randn(D, generator=gen, device=device).bfloat16()
            xn = tb.moe_route_plain(x, norm, router, li, 1)[0].float()
            for case, cols, want_e in k5_cases(E, k):
                r = router.clone()
                for e, c in cols.items():
                    r[li, :, e] = xn * c
                got = tb.moe_route(x, norm, r, li, k)
                want = tb.moe_route_plain(x, norm, r, li, k)
                ge = [e - li * E for e in got[1].tolist()]
                we = [e - li * E for e in want[1].tolist()]
                what = f"K5 D {D} E {E} k {k} layer {li} {case}"
                check(ge == we and (want_e is None
                                    or ge[:len(want_e)] == want_e),
                      f"{what}: experts {ge}, plain {we}, expected "
                      f"{want_e}")
                ulp = torch.finfo(torch.bfloat16).eps * want[0].float().abs()
                d_xn = (got[0].float() - want[0].float()).abs()
                check(bool((d_xn <= ulp).all()), f"{what}: xn differs by "
                      f"more than one bf16 ulp")
                d_w = float((got[2] - want[2]).abs().max())
                check(d_w <= 1e-6, f"{what}: weights differ by {d_w:.3e}")
                worst = max(worst, d_w, float(d_xn.max()))
                n_diff += int((d_xn > 0).sum())
                n_all += D
                if li == 0:
                    log(f"[k5] {what:32s} experts {ge} weights "
                        f"{[round(w, 6) for w in got[2].tolist()]} xn "
                        f"max_abs_err {float(d_xn.max()):.3e} weights "
                        f"max_abs_err {d_w:.3e}")
        differ[f"{D}x{E}k{k}"] = (n_diff, n_all)
        log(f"[k5] D {D} E {E} k {k}: routed experts equal to the plain "
            f"version's in {Lr} layers x {len(k5_cases(E, k))} cases; xn "
            f"elements that differ from the plain version's at all: "
            f"{n_diff} of {n_all} (each within one bf16 ulp)")
    return worst, differ


def moe_stage_specs(params, cfg):
    """K1's two calls of a routed expert on the token path: operands as
    the pseudo-layer stacks [L*E, K, N] (`expert_stacks`), int8 scales,
    no norm; gate|up with silu, down with the weighted residual."""
    from teal_tpu_torch.ops.token_block import expert_stacks, stage_operands

    lay = params["layers"]
    ops, sc = stage_operands(tuple(
        expert_stacks(lay[n]) if n in ("wgate", "wup", "wdown") else lay[n]
        for n in PROJ_NAMES))
    return {"gate|up": dict(ws=ops[4:6], norm=None, res=False, silu=True,
                            scales=None if sc is None else sc[4:6]),
            "down": dict(ws=ops[6:7], norm=None, res=True, silu=False,
                         scales=None if sc is None else sc[6:7])}


def moe_k1_args(spec, cfg, cap, n_surv, gen, device, pl):
    """Inputs of one MoE K1 call (`k1_inputs`: spiky input, threshold with
    n_surv survivors, residual) and its keyword arguments: the device
    pseudo-layers `pl` read at slot 1, routing weights for the down
    stage."""
    import torch

    from teal_tpu_torch.ops import block_gemv as bg

    K = bg._in_dim(spec["ws"][0])
    x, thr, res = k1_inputs(spec, cfg, K, n_surv, gen, device,
                            torch.bfloat16, 0)
    eidx = torch.tensor(pl, dtype=torch.int32, device=device)
    kw = dict(slot=1, silu=spec["silu"], scales=spec["scales"], res=res)
    if spec["res"]:
        kw["route_w"] = torch.tensor([0.375, 0.625], device=device)
    return x, thr, eidx, kw


def check_k1_moe(params, cfg, caps, device, gen, plan):
    """K1's MoE forms against the plain version at the expert shapes
    (gate|up K = dim, N = 2 * intermediate; down K = intermediate, N =
    dim): the pseudo-layer read on the device (`MOE_PSEUDO`, the largest
    of the stacks among them, for the 64-bit offsets), gate|up without a
    norm, down with the weighted residual, three selection regimes each:
    identical kept sets, outputs within 2^-7 of scale. Returns the
    largest absolute error."""
    from teal_tpu_torch.ops import block_gemv as bg

    worst = 0.0
    for name, cap in (("gate|up", caps[2]), ("down", caps[3])):
        spec = moe_stage_specs(params, cfg)[name]
        nb = bg._in_dim(spec["ws"][0]) // 128
        for pl in MOE_PSEUDO[plan]:
            for case, n_surv in (("count<cap", max(1, cap // 2)),
                                 ("count==cap", cap),
                                 ("overflow", min(nb, cap + max(1, nb // 4)))):
                x, thr, eidx, kw = moe_k1_args(spec, cfg, cap, n_surv, gen,
                                               device, [0, pl])
                got, gidx, gcnt = bg.select_gather_gemv(
                    x, thr, spec["ws"], eidx, cap, **kw)
                want, widx, wcnt = bg.select_gather_gemv_plain(
                    x, thr, spec["ws"], eidx, cap, **kw)
                n = int(wcnt[0])
                check(n == min(n_surv, cap) and int(gcnt[0]) == n,
                      f"K1 moe {plan} {name} {case}: count {int(gcnt[0])} "
                      f"vs plain {n}, expected {min(n_surv, cap)}")
                check(bool((gidx == widx).all()),
                      f"K1 moe {plan} {name} {case}: kept sets differ")
                err = rel_check(f"K1 moe {plan} {name} pseudo-layer {pl} "
                                f"{case}", got, want, 2 ** -7)
                worst = max(worst, err)
                log(f"[k1 moe {plan}] {name:8s} pseudo-layer {pl:3d} "
                    f"cap={cap:2d} {case:10s} kept={n:2d} max_abs_err="
                    f"{err:.3e} (scale {float(want.float().abs().max()):.3e})")
    return worst


K5_TIME_BYTES = 96e6             # a timing's router stack: twice the L2
K5_TIME_ITERS = 64


def launch_floor_ms():
    """The least a launch of K5's shape costs, timed as K5 is (queued,
    back to back): an empty kernel of one block and an empty cluster of
    8 blocks (256 threads each). Returns (one block ms, cluster ms)."""
    import torch

    from teal_tpu_torch import _build

    lib = _build.load()["moe_route"]
    stream = torch.cuda.current_stream().cuda_stream

    def empty(blocks, cluster):
        _build.check(lib.teal_empty_launch(blocks, cluster, stream),
                     "empty launch")

    return tuple(cuda_ms(lambda i, b=b, c=c: empty(b, c), K5_TIME_ITERS)[0]
                 for b, c in ((1, 0), (8, 1)))


def time_k5(D, E, k, dtype, device, gen, what, eps=1e-5):
    """K5 at (D, E, k) on a `dtype` stream, each call on another layer of
    a router stack of at least `K5_TIME_BYTES` (and twice a timing's
    calls), so that no call finds its router in L2, as none does in a
    decode step: kernel (queued), plain version, bound and the launch
    floor (`launch_floor_ms`). Returns the row."""
    import torch

    from teal_tpu_torch.ops import token_block as tb

    Lr = max(2 * (K5_TIME_ITERS + 2), math.ceil(K5_TIME_BYTES / (D * E * 4)))
    router = torch.randn(Lr, D, E, generator=gen, device=device) * 0.02
    norm = (1 + 0.1 * torch.randn(Lr, D, generator=gen, device=device)
            ).to(dtype)
    x = torch.randn(D, generator=gen, device=device).to(dtype)
    base = [0]

    def call(i):
        base[0] += 1
        return tb.moe_route(x, norm, router, base[0] % Lr, k, eps)

    esz = x.element_size()
    nbytes = 3 * D * esz + D * E * 4 + 2 * k * 4
    b_ms, b_by = bound_ms(nbytes, 2 * D * E)
    ms, host = cuda_ms(call, K5_TIME_ITERS)
    p_ms, _ = cuda_ms(lambda i: tb.moe_route_plain(
        x, norm, router, i % Lr, k, eps), 5, warmup=1, queued=False)
    one, cluster = launch_floor_ms()
    log(f"[time] {what} D {D} E {E} k {k} {str(dtype)[6:]}: kernel "
        f"{ms:.4f} ms (host enqueue {host:.4f} ms)  plain {p_ms:.4f} ms  "
        f"bound {b_ms:.6f} ms ({b_by}, {nbytes / 1e6:.3f} MB)  launch floor "
        f"{one:.4f} ms one block, {cluster:.4f} ms an 8-block cluster "
        f"(K5 {ms / cluster:.2f}x the cluster's)")
    del router, norm
    return dict(ms=ms, host_ms=host, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, mbytes=nbytes / 1e6,
                floor_one_block_ms=one, floor_cluster_ms=cluster)


def time_moe_kernels(params, cfg, caps, device, gen, plan):
    """K5 (`time_k5`) and K1's two MoE calls at Mixtral's shapes (count ==
    cap), each call on another layer or pseudo-layer (no L2 reuse):
    kernel, plain version, bound and yardsticks (K1: `torch.matmul` of the
    bf16 expert weights at full keep, and `torch._weight_int8pack_mm` for
    int8; K5: the launch floor, no single PyTorch call routes). Returns
    (K5 row, K1 rows)."""
    import torch

    from teal_tpu_torch.ops import block_gemv as bg

    L, E = cfg.n_layers, cfg.n_experts
    LE, esz = L * E, 2
    k5 = time_k5(cfg.dim, E, cfg.n_experts_per_tok, torch.bfloat16, device,
                 gen, f"K5 moe_route [{plan}]", cfg.norm_eps)
    rows = []
    for name, cap in (("gate|up", caps[2]), ("down", caps[3])):
        spec = moe_stage_specs(params, cfg)[name]
        ws = spec["ws"]
        K, Ns = bg._in_dim(ws[0]), [bg._width(w) for w in ws]
        n_out = Ns[0]
        x, thr, _, kw = moe_k1_args(spec, cfg, cap, cap, gen, device, [0, 0])
        eidxs = [torch.tensor([0, pl], dtype=torch.int32, device=device)
                 for pl in range(LE)]
        nbytes = (plan_bytes(ws, 128, cap, spec["scales"]) + K * esz
                  + n_out * esz * (2 if spec["res"] else 1) + 8)
        # the bf16 weights of the yardstick: the params' own, or 4 random
        # copies of each for int8 (not L2-resident in turn)
        if plan == "bf16":
            lib_ws = [[w[pl] for pl in range(LE)] for w in ws]
        else:
            lib_ws = [[(torch.randn(K, N, generator=gen, device=device)
                        * 0.02).bfloat16() for _ in range(4)] for N in Ns]
        x2 = x.reshape(1, K)
        lib = sum(cuda_ms(lambda i, w=w: torch.matmul(x2, w[i % len(w)]),
                          64)[0] for w in lib_ws)
        del lib_ws
        rows.append(_plan_row(
            f"K1[moe {plan}] {name}", nbytes, 2 * cap * 128 * sum(Ns),
            lambda i: bg.select_gather_gemv(x, thr, ws, eidxs[i % LE], cap,
                                            **kw),
            lambda i: bg.select_gather_gemv_plain(x, thr, ws, eidxs[i % LE],
                                                  cap, **kw),
            lib, quant_library_ms(plan, K, Ns, device, gen), K=K, N=sum(Ns),
            cap=cap))
    return k5, rows


def moe_run(cfg, plan, device, gen, seed, rope):
    """Phase 10 for one Mixtral copy: build it on the card, hold K1's MoE
    forms to the plain version, pick the thresholds (columns 0, 3 and 4;
    6 stays 0) on the plain token path and hold every layer of one decode
    step to it (2e-2 of scale, the same routed experts), run three greedy
    requests (dense prefill on the layer loop, decode on the token path)
    with 6 K1 + 1 K2 + 1 K5 launches a layer and token, and time the
    decode step (keep 0.5 and 1.0), tok/s in turns and the kernels.
    Returns (kernels rows, results)."""
    import numpy as np
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine import Generator
    from teal_tpu_torch.models import llama

    torch.cuda.reset_peak_memory_stats()
    params, build_s = mixtral_params(cfg, gen, device, plan == "int8")
    L = cfg.n_layers
    log(f"[moe {plan}] {MOE_MODEL} at {L} layers, full width, built on the "
        f"card one layer at a time in {build_s:.1f} s: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    sp = SparsityConfig(**MAIN_SP)
    check(llama.can_token_decode(params, cfg, sp, 1, 1, torch.bfloat16),
          f"moe {plan}: the token path refuses the MoE decode")
    caps = llama.token_path_caps(cfg, sp)
    err_k1 = check_k1_moe(params, cfg, caps, device, gen, plan)

    rng = np.random.default_rng(seed + 10)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in PROMPT_LENS]
    cache, tok, pos = prefill(params, cfg, prompts[0][None], device, rope)
    t0 = time.perf_counter()
    th, worst, _ = hold_token_layers(params, cfg, cache, tok, pos, rope,
                                     device)
    log(f"[moe {plan}] thresholds (columns 0, 3, 4; column 6 at 0) picked "
        f"on the plain token path and every layer of the kernel path held "
        f"to it with the same routed experts (worst error {worst:.2e} of "
        f"scale, tolerance 2e-2) in {time.perf_counter() - t0:.2f} s")

    gens = {keep: Generator(cfg, params, sp=SparsityConfig(
        **dict(MAIN_SP, block_keep_frac=keep)), max_seq=MAX_SEQ,
        cache_dtype=torch.bfloat16, temperature=0.0, device=device)
        for keep in (0.5, 1.0)}
    zero = llama.zero_thresholds(cfg, device)
    gens[0.5].generate(prompts[0], 3, thresholds=th)          # warm-up
    reset_launches()
    outs = [gens[0.5].generate(p, NEW_TOKENS, thresholds=th)
            for p in prompts]
    got = read_launches()
    decoded = len(prompts) * (NEW_TOKENS - 1)
    k_exp = cfg.n_experts_per_tok
    want = ((2 + 2 * k_exp) * L * decoded, L * decoded, 0, 0, L * decoded, 0)
    check(got == want, f"moe {plan}: launches (K1, K2, K3, K4, K5, K6) {got}, "
          f"expected {want} for {decoded} decoded tokens")
    for p, (toks, st) in zip(prompts, outs):
        check(toks.shape == (1, len(p) + NEW_TOKENS)
              and bool((toks >= 0).all() and (toks < cfg.vocab_size).all()),
              f"moe {plan}: bad tokens {toks.shape}")
    log(f"[moe {plan}] {len(prompts)} requests, {decoded} decoded tokens, "
        f"launches a token (K1, K2, K3, K4, K5, K6) "
        f"{tuple(c // decoded for c in got)}; first request's new tokens "
        f"{outs[0][0][0, len(prompts[0]):].tolist()}")
    lg, _ = llama.forward(params, tok, llama.KVCache(cache.k.clone(),
                                                     cache.v.clone()),
                          pos, th, cfg=cfg, sp=sp, rope=rope)
    check(tuple(lg.shape) == (1, 1, cfg.vocab_size)
          and bool(torch.isfinite(lg).all()), f"moe {plan}: bad logits")

    speeds = {0.5: [], 1.0: []}
    for keep in (1.0, 0.5, 0.5, 1.0):
        _, st = gens[keep].generate(prompts[2], 32, thresholds=(
            th if keep == 0.5 else zero))
        speeds[keep].append(st.tokens_per_s)
    log(f"[moe {plan}] decode tok/s (prompt 40, 32 new tokens, in turns): "
        f"keep 0.5 {speeds[0.5]}, keep 1.0 {speeds[1.0]}")
    step = time_decode_step(params, cfg, [
        (f"moe {plan} keep 0.5", MAIN_SP, 1, th),
        (f"moe {plan} keep 1.0", dict(MAIN_SP, block_keep_frac=1.0), 1,
         zero)], device, rope)
    k5, k1_rows = time_moe_kernels(params, cfg, caps, device, gen, plan)
    results = dict(layers=L, build_s=build_s, worst=worst, launches=got,
                   decoded=decoded, err_k1=err_k1,
                   tok_s={str(k): v for k, v in speeds.items()},
                   decode_step_ms=step,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   new_tokens=[o[0][0, len(p):].tolist()
                               for p, o in zip(prompts, outs)])
    del params, gens, cache
    torch.cuda.empty_cache()
    return k5, k1_rows, results


def moe_phase(device, gen, seed):
    """Phase 10: K5 against its plain version, then `moe_run` on the int8
    and bf16 copies of `MOE_RUNS`, then K2 at Mixtral's heads. Returns
    (kernels entries, results)."""
    import dataclasses

    from teal_tpu_torch.config import get_model_config
    from teal_tpu_torch.models import llama

    full = get_model_config(MOE_MODEL)
    rope = llama.precompute_rope(full, MAX_SEQ, device)
    err_k5, k5_differ = check_k5(device, gen)
    entries, results, k5_rows = [], {}, {}
    src = "teal_tpu_torch/csrc/"
    for plan, layers in MOE_RUNS:
        cfg = dataclasses.replace(full, n_layers=layers or full.n_layers)
        k5_rows[plan], k1_rows, results[plan] = moe_run(cfg, plan, device,
                                                        gen, seed, rope)
        r = results[plan]
        entries.append(plan_entry(
            k1_rows, f"select_gather_gemv[moe {plan}]",
            src + "select_gather_gemv.cu", "teal_tpu/ops/token_block.py:274",
            r["launches"][0], r["decoded"], r["err_k1"],
            f"{MOE_MODEL} {plan} at {cfg.n_layers} layers: one routed "
            "expert's two calls (gate|up, down with the weighted residual; "
            "device pseudo-layer) at count == cap, summed; launches are all "
            "of K1's on that path (qkv, o and 2 per routed expert)"))
    r8 = results["int8"]
    entries.append(dict(
        name="moe_route", route="cuda", source=src + "moe_route.cu",
        replaces="teal_tpu/ops/token_block.py:131",
        launches=r8["launches"][4],
        launches_per_token=r8["launches"][4] / r8["decoded"],
        max_abs_err=err_k5, kernel_ms=k5_rows["int8"]["ms"],
        timed=f"{MOE_MODEL} int8: one layer's routing (D = {full.dim}, E = "
              f"{full.n_experts}, {full.n_experts_per_tok} routed, bf16 "
              "stream), each call on another layer of a router stack twice "
              "the L2; bf16 copy under bf16; floor: empty launches",
        bf16={k: k5_rows["bf16"][k] for k in ("ms", "plain_ms")},
        xn_differ=k5_differ,
        **{k: k5_rows["int8"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "floor_one_block_ms", "floor_cluster_ms")}))
    # K2 at Mixtral's heads (GQA 32/8), launched on the int8 path above
    rope = llama.precompute_rope(full, 2048, device)
    for T in (MAX_SEQ, 2048):
        entries.append(time_k2(full, device, gen, rope, r8["launches"][1],
                               r8["decoded"], 0.0,
                               f"decode_attention[GQA 32/8 pos {T - 1}]",
                               T=T))
    return entries, results


# --- phase 15: parallelism on torch.distributed ------------------------

P15_WORLD = 4                    # rank processes sharing the card (gloo)
P15_DEPTH = 32                   # layers of the tp 2 run at 7B widths
P15_PROMPT = 256                 # its tp_prefill (K6 on 16 heads a layer)
P15_STEPS = 16                   # its decode steps
P15_CUT = 2                      # layers of the int4, tp 4 and Mixtral runs
P15_CUT_PROMPT = 8
P15_CUT_STEPS = 4
P15_B4_PROMPT = 40               # tp 4, batch 4: decode at pos 40, 37, 33, 29
P15_SP_TOKENS = 2048             # sp 2 prefill of a 2-layer cut (fp32)
P15_PP = dict(layers=4, n_micro=2, batch=2, tokens=64)   # pp 2 (fp32)
P15_TIMEOUT_S = 480              # the rank group, start-up included
P15_DIR = ROOT / "build" / "chip_smoke_parallel"
P15_SHARD_LAYERS = 8             # weight stacks of the shard timings (> L2)
P15_LABEL = ("2 ranks sharing one card through gloo, host-staged "
             "collectives; not a TP speed")


def _p15_sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _p15_peak(device, reset: bool = False) -> float:
    """Peak GiB allocated on the card since the last reset (0 on the CPU,
    where a rehearsal runs)."""
    import torch

    if device.type != "cuda":
        return 0.0
    if reset:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    return torch.cuda.max_memory_allocated() / 2**30


def p15_layer(cfg, i, seed, device, dtype, int4=False):
    """Layer i's full weights as one-layer stacks, drawn on the card from a
    generator seeded by (seed, i): the same on every rank. int4: the seven
    projections packed at group 128 (`quant.pack_int4`)."""
    import torch

    from teal_tpu_torch.ops import quant

    gen = torch.Generator(device=device).manual_seed(seed * 1000 + i)
    D, I, KV, E = cfg.dim, cfg.intermediate_size, cfg.kv_dim, cfg.n_experts

    def w(k, n):
        return (torch.randn((k, n), generator=gen, device=device)
                * 0.02).to(dtype)

    lay = {"attn_norm": torch.ones((1, D), dtype=dtype, device=device),
           "mlp_norm": torch.ones((1, D), dtype=dtype, device=device),
           "wq": w(D, D)[None], "wk": w(D, KV)[None], "wv": w(D, KV)[None],
           "wo": w(D, D)[None]}
    shapes = {"wgate": (D, I), "wup": (D, I), "wdown": (I, D)}
    if E:
        lay["router"] = torch.randn((1, D, E), generator=gen,
                                    device=device) * 0.02
        for n, (k, m) in shapes.items():
            lay[n] = torch.stack([w(k, m) for _ in range(E)])[None]
    else:
        lay.update({n: w(k, m)[None] for n, (k, m) in shapes.items()})
    if int4:
        for n in PROJ_NAMES:
            p = quant.pack_int4(quant.quantize_int4(lay[n][0].float(), 128))
            lay[n] = {k: v[None] for k, v in p.items()}
    return lay


def _stack_into(dst, src, i, L):
    """Layer i of the stacks `dst` (made on first use) from `src`'s
    one-layer stacks; returns dst."""
    import torch

    if isinstance(src, dict):
        dst = {} if dst is None else dst
        for k, v in src.items():
            dst[k] = _stack_into(dst.get(k), v, i, L)
        return dst
    if dst is None:
        dst = torch.empty((L,) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
    dst[i] = src[0]
    return dst


def p15_model(cfg, mesh, seed, device, dtype=None, int4=False):
    """Random weights of `cfg` from `seed`, a layer at a time: this rank's
    tp shards (`tp.param_specs`; the head colwise, the embedding and the
    final norm whole), or with mesh None the whole tree."""
    import torch

    from teal_tpu_torch.parallel import tp

    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(seed * 1000 + 999)
    V, D = cfg.vocab_size, cfg.dim
    embed = (torch.randn((V, D), generator=gen, device=device)
             * 0.02).to(dtype)
    head = (torch.randn((D, V), generator=gen, device=device)
            * 0.02).to(dtype)
    if mesh is not None:
        tp.check_divisible(cfg, mesh.axis_size("tp"))
    layers = None
    for i in range(cfg.n_layers):
        lay = p15_layer(cfg, i, seed, device, dtype, int4)
        if mesh is not None:
            specs = tp.param_specs(cfg, {"layers": lay, "lm_head": head})
            lay = tp.shard_tree(lay, specs["layers"], mesh)
        layers = _stack_into(layers, lay, i, cfg.n_layers)
    if mesh is not None:
        head = tp.shard_tensor(head, tp.param_specs(cfg)["lm_head"], mesh)
    return {"embed": embed, "layers": layers,
            "final_norm": torch.ones((D,), dtype=dtype, device=device),
            "lm_head": head}


def p15_cache(cfg, mesh, batch, T, device, dtype=None):
    """A zero cache: this rank's heads (tp) of every layer, or the whole
    cache with mesh None."""
    import torch

    from teal_tpu_torch.models.llama import KVCache

    tp = 1 if mesh is None else mesh.axis_size("tp")
    shape = (cfg.n_layers, batch, cfg.n_kv_heads // tp, T, cfg.head_dim)
    return KVCache(*(torch.zeros(shape, dtype=dtype or torch.bfloat16,
                                 device=device) for _ in range(2)))


def p15_hold(params, cfg, sp, mesh, tok, pos, cache, th, what):
    """One decode step of `tp_decode_layer`, layer by layer: the plain
    path (every kernel swapped for its plain version) and the kernel path
    on the same layer input and cache; the stream after the o and the
    down reductions and the written cache rows held within 2e-2 of scale,
    K1's kept counts equal to the plain path's (or one group apart by a
    flip `explain_count_flip` measures within FLIP_ULPS, the plain layer
    then run again past that score on every rank); and the kernel path's
    streams the same on every rank bit for bit. Returns the worst error
    relative to scale."""
    import torch

    from teal_tpu_torch.models import llama
    from teal_tpu_torch.models.llama import KVCache
    from teal_tpu_torch.ops import block_gemv as bg
    from teal_tpu_torch.parallel import tp_kernel

    g = mesh.group("tp")
    dev = tok.device
    B = tok.shape[0]
    pos_b = torch.tensor([pos] * B if isinstance(pos, int) else pos,
                         dtype=torch.int32, device=dev)
    cos, sin = llama.precompute_rope(cfg, cache.max_seq, dev)
    rope = llama._rope_rows(cos, sin, pos_b)
    h = params["embed"][tok].to(llama.compute_dtype(params))
    real_k1 = bg.select_gather_gemv
    rows = torch.arange(B, device=dev)
    pl = pos_b.long()
    kw = dict(cfg=cfg, sp=sp, mesh=mesh)

    def clone():
        return KVCache(cache.k.clone(), cache.v.clone())

    worst = 0.0
    for i in range(cfg.n_layers):
        rec, kept = [], []
        cp, ck = clone(), clone()
        with plain_path(k1=recording_k1(rec)):
            mid_p, out_p = tp_kernel.tp_decode_layer(params, h, cp, i, pos_b,
                                                     rope, th, **kw)

        def counting(*a, **k):
            out = real_k1(*a, **k)
            kept.append(int(out[2].reshape(-1)[0]))
            return out

        # the wrapper counts its launches under the module's name
        counting.launches = 0
        bg.select_gather_gemv = counting
        try:
            mid_k, out_k = tp_kernel.tp_decode_layer(params, h, ck, i, pos_b,
                                                     rope, th, **kw)
        finally:
            bg.select_gather_gemv = real_k1
        want = [r[2] for r in rec]
        override = {}
        if kept != want:
            ok, msg, override = explain_count_flip(rec, kept, want)
            log(f"[p15] {what} layer {i}: {msg}; "
                f"{'a flip' if ok else 'not a flip'} within {FLIP_ULPS} ulps")
            check(ok, f"{what} layer {i}: kept counts {kept} vs the plain "
                  f"path's {want}: {msg}")
        # a rerun runs the layer's reductions, so every rank takes part
        flips = g.reduce_sum(torch.tensor([float(bool(override))],
                                          device=dev))
        if float(flips[0]) > 0:
            again = []
            cp = clone()
            with plain_path(k1=recording_k1(again, override)):
                mid_p, out_p = tp_kernel.tp_decode_layer(
                    params, h, cp, i, pos_b, rope, th, **kw)
            check([r[2] for r in again] == kept, f"{what} layer {i}: the "
                  f"plain layer run again keeps {[r[2] for r in again]}, "
                  f"the kernel path {kept}")
        for name, got, ref in (
                ("stream after o", mid_k, mid_p),
                ("stream after down", out_k, out_p),
                ("k rows", ck.k[i, rows, :, pl], cp.k[i, rows, :, pl]),
                ("v rows", ck.v[i, rows, :, pl], cp.v[i, rows, :, pl])):
            err = rel_check(f"{what} layer {i} {name}: kernel vs plain", got,
                            ref, 2e-2)
            scale = float(ref.float().abs().max())
            worst = max(worst, err / scale if scale else 0.0)
        for name, t in (("o", mid_k), ("down", out_k)):
            check(all(torch.equal(p, t) for p in g.parts(t)),
                  f"{what} layer {i}: the stream after the {name} reduction "
                  "differs between ranks")
        h = out_p
    return worst


def p15_tp_run(what, cfg, mesh, seed, device, *, prompt, steps, batch=1,
               int4=False, batch_pos=None):
    """One TP configuration on this rank: weights, thresholds picked on
    the plain path for one step after a prefill (each rank's rowwise
    picks replaced by tp rank 0's), then the counted main path --
    `tp_prefill` of the prompt and `steps` greedy `tp_kernel_decode`
    steps, the launch counts reset just before and read just after --
    the logits the same on every rank, and one more step held layer by
    layer (`p15_hold`). batch_pos: the rows' positions of a batched step
    after a prompt of `prompt` tokens for every row (each row decodes
    at its own depth)."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.parallel import tp_kernel

    if not mesh.member:
        return None
    _p15_peak(device, reset=True)
    t0 = time.perf_counter()
    params = p15_model(cfg, mesh, seed, device, int4=int4)
    L, T = cfg.n_layers, MAX_SEQ
    sp = SparsityConfig(**MAIN_SP)
    g = mesh.group("tp")
    gen = torch.Generator(device=device).manual_seed(seed + 15)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=device)
    th = torch.zeros((L, 7), dtype=torch.float32, device=device)
    args = dict(cfg=cfg, sp=sp, mesh=mesh)
    # K1's thresholds, picked on row 0 at its first decode position (a
    # batch of rows runs K3 at the same table)
    scratch = p15_cache(cfg, mesh, 1, T, device)
    logits, _ = tp_kernel.tp_prefill(params, toks[:1], scratch, th, **args)
    with plain_path(k1=picking_k1):
        tp_kernel.tp_kernel_decode(params, torch.argmax(logits[:, -1:], -1),
                                   scratch, prompt, th, **args)
    th = g.broadcast(th, 0)
    del scratch
    build_s = time.perf_counter() - t0

    cache = p15_cache(cfg, mesh, batch, T, device)
    _p15_sync(device)
    reset_launches()
    t1 = time.perf_counter()
    logits, cache = tp_kernel.tp_prefill(params, toks, cache, th, **args)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    _p15_sync(device)
    t2 = time.perf_counter()
    prefill_counts = read_launches()
    for s in range(steps):
        p = [q + s for q in batch_pos] if batch_pos else prompt + s
        logits, cache = tp_kernel.tp_kernel_decode(params, tok, cache, p, th,
                                                   **args)
        tok = torch.argmax(logits[:, -1:], dim=-1)
    _p15_sync(device)
    t3 = time.perf_counter()
    counts = tuple(a - b for a, b in zip(read_launches(), prefill_counts))
    long = llama._can_flash_prefill(prompt, cfg.head_dim,
                                    cfg.sliding_window)
    # K3: four stages a layer for a batch of rows; gate|up and down of
    # each routed expert
    k3 = (4 if batch > 1 else 0) + 2 * cfg.n_experts_per_tok
    k1 = 0 if batch > 1 else (2 if cfg.n_experts else 4)
    want = (k1 * L * steps, L * steps, k3 * L * steps, 0, 0, 0)
    want_pre = (0, 0, 0, 0, 0, L if long else 0)
    if device.type != "cuda":   # a rehearsal: plain versions count nothing
        want, want_pre = (0,) * 6, (0,) * 6
    check(prefill_counts == want_pre, f"{what}: the prefill launched "
          f"{prefill_counts}, expected {want_pre}")
    check(counts == want, f"{what}: {steps} decode steps launched (K1, K2, "
          f"K3, K4, K5, K6) {counts}, expected {want}")
    check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (
        batch, 1, cfg.vocab_size), f"{what}: logits {tuple(logits.shape)}")
    check(all(torch.equal(p, logits) for p in g.parts(logits)),
          f"{what}: the logits differ between ranks")
    nxt = [q + steps for q in batch_pos] if batch_pos else prompt + steps
    worst = p15_hold(params, cfg, sp, mesh, tok, nxt, cache, th, what)
    res = dict(layers=L, build_s=build_s, prefill_s=t2 - t1,
               decode_s=t3 - t2, tok_s=steps * batch / (t3 - t2),
               prefill_launches=list(prefill_counts), launches=list(counts),
               steps=steps, worst_rel=worst, peak_gib=_p15_peak(device),
               seconds=time.perf_counter() - t0)
    del params, cache
    torch.cuda.empty_cache()
    return res


def p15_sp_run(cfg, mesh, seed, device):
    """`sp_prefill` of P15_SP_TOKENS tokens over the sp ranks (fp32, whole
    params on each); on sp rank 0 the cache and the last chunk's logits
    held to single-device `forward` with `causal_prefill` (K6's fp32 path)
    within 1e-4 of scale; the logits and cache the same on every rank."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.parallel import sp as spm

    if not mesh.member:
        return None
    _p15_peak(device, reset=True)
    t0 = time.perf_counter()
    f32 = torch.float32
    params = p15_model(cfg, None, seed, device, dtype=f32)
    S = P15_SP_TOKENS
    gen = torch.Generator(device=device).manual_seed(seed + 16)
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                         device=device)
    th = llama.zero_thresholds(cfg, device)
    sp = SparsityConfig()
    cache = p15_cache(cfg, None, 1, S, device, f32)
    reset_launches()
    t1 = time.perf_counter()
    logits, cache = spm.sp_prefill(params, toks, cache, 0, th, cfg=cfg,
                                   sp=sp, mesh=mesh)
    _p15_sync(device)
    t2 = time.perf_counter()
    check(read_launches() == (0,) * 6, f"sp prefill launched "
          f"{read_launches()}: K6 is skipped under seq_group")
    g = mesh.group("sp")
    for name, t in (("logits", logits), ("k", cache.k), ("v", cache.v)):
        check(all(torch.equal(p, t) for p in g.parts(t)),
              f"sp prefill: {name} differ between ranks")
    errs = {}
    if g.index == 0:
        ref_cache = p15_cache(cfg, None, 1, S, device, f32)
        ref, ref_cache = llama.forward(params, toks, ref_cache, 0, th,
                                       cfg=cfg, sp=sp, causal_prefill=True)
        half = S // g.size * (g.size - 1)
        for name, got, want in (
                ("last chunk's logits", logits[:, half:], ref[:, half:]),
                ("k cache", cache.k, ref_cache.k),
                ("v cache", cache.v, ref_cache.v)):
            errs[name] = rel_check(f"sp prefill {name} vs single-device "
                                   "prefill", got, want, 1e-4) / float(
                                       want.abs().max())
    res = dict(layers=cfg.n_layers, tokens=S, prefill_s=t2 - t1,
               rel_err=errs, peak_gib=_p15_peak(device),
               seconds=time.perf_counter() - t0)
    del params, cache
    torch.cuda.empty_cache()
    return res


def p15_pp_run(cfg, mesh, seed, device):
    """`pp_forward` over the pp ranks (fp32, P15_PP's microbatches), the
    logits the same on every rank; on each stage its cache slab and the
    logits held to single-device `forward` within 1e-4 of scale."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.parallel import pp as ppm

    if not mesh.member:
        return None
    _p15_peak(device, reset=True)
    t0 = time.perf_counter()
    f32 = torch.float32
    full = p15_model(cfg, None, seed, device, dtype=f32)
    local = ppm.pp_shard_params(full, mesh, cfg)
    B, S, T = P15_PP["batch"], P15_PP["tokens"], 2 * P15_PP["tokens"]
    gen = torch.Generator(device=device).manual_seed(seed + 17)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=device)
    th = llama.zero_thresholds(cfg, device)
    sp = SparsityConfig()
    cache = ppm.pp_shard_cache(p15_cache(cfg, None, B, T, device, f32), mesh)
    t1 = time.perf_counter()
    logits, cache = ppm.pp_forward(local, toks, cache, 0, th, cfg=cfg, sp=sp,
                                   mesh=mesh, n_micro=P15_PP["n_micro"])
    _p15_sync(device)
    t2 = time.perf_counter()
    g = mesh.group("pp")
    check(all(torch.equal(p, logits) for p in g.parts(logits)),
          "pp forward: the logits differ between ranks")
    ref_cache = p15_cache(cfg, None, B, T, device, f32)
    ref, ref_cache = llama.forward(full, toks, ref_cache, 0, th, cfg=cfg,
                                   sp=sp)
    lo = g.index * cache.k.shape[0]
    errs = {}
    for name, got, want in (
            ("logits", logits, ref),
            ("k slab", cache.k, ref_cache.k[lo:lo + cache.k.shape[0]]),
            ("v slab", cache.v, ref_cache.v[lo:lo + cache.v.shape[0]])):
        errs[name] = rel_check(f"pp stage {g.index} {name} vs single-device "
                               "forward", got, want, 1e-4) / float(
                                   want.abs().max())
    res = dict(layers=cfg.n_layers, stage=g.index, forward_s=t2 - t1,
               rel_err=errs, peak_gib=_p15_peak(device),
               seconds=time.perf_counter() - t0)
    del full, local, cache
    torch.cuda.empty_cache()
    return res


def p15_rank(rank: int, world: int, init: str, out_dir: str, seed: int,
             device: str = "cuda:0", shrink=None) -> None:
    """A rank of phase 15's gloo group on `device` (every rank on cuda:0):
    every run in turn (each builds its mesh on every rank; ranks outside
    it wait), then its results as JSON in out_dir. Runs in a process
    `p15_spawn` started. shrink: ModelConfig overrides for both models
    (a CPU rehearsal at small widths)."""
    import torch

    sys.path.insert(0, str(ROOT))
    from teal_tpu_torch import _build
    from teal_tpu_torch.config import get_model_config
    from teal_tpu_torch.parallel import (initialize_distributed, make_pp_mesh,
                                         make_sp_mesh, make_tp_mesh)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = initialize_distributed(init_method=f"file://{init}",
                                    world_size=world, rank=rank,
                                    backend="gloo", device=device)
    if device.type == "cuda":
        _build.load()
    rep = dataclasses.replace
    b7 = get_model_config("7B", **(shrink or {}))
    cut = rep(b7, n_layers=P15_CUT)
    moe = get_model_config("Mixtral-8x7B", n_layers=P15_CUT,
                           **(shrink or {}))
    runs = (
        ("tp2 7B", lambda: p15_tp_run(
            "tp2 7B", rep(b7, n_layers=P15_DEPTH),
            make_tp_mesh(2, ranks=[0, 1]), seed, device, prompt=P15_PROMPT,
            steps=P15_STEPS)),
        ("tp2 7B int4", lambda: p15_tp_run(
            "tp2 7B int4", cut, make_tp_mesh(2, ranks=[0, 1]), seed, device,
            prompt=P15_CUT_PROMPT, steps=P15_CUT_STEPS, int4=True)),
        ("tp4 7B", lambda: p15_tp_run(
            "tp4 7B", cut, make_tp_mesh(4), seed, device,
            prompt=P15_CUT_PROMPT, steps=P15_CUT_STEPS)),
        ("tp4 7B batch 4", lambda: p15_tp_run(
            "tp4 7B batch 4", cut, make_tp_mesh(4), seed, device,
            prompt=P15_B4_PROMPT, steps=P15_CUT_STEPS, batch=4,
            batch_pos=[P15_B4_PROMPT - d for d in (0, 3, 7, 11)])),
        ("tp2 Mixtral", lambda: p15_tp_run(
            "tp2 Mixtral", moe, make_tp_mesh(2, ranks=[0, 1]), seed, device,
            prompt=P15_CUT_PROMPT, steps=P15_CUT_STEPS)),
        ("sp2", lambda: p15_sp_run(cut, make_sp_mesh(2, ranks=[0, 1]), seed,
                                   device)),
        ("pp2", lambda: p15_pp_run(
            rep(b7, n_layers=P15_PP["layers"]),
            make_pp_mesh(2, ranks=[0, 1]), seed, device)),
    )
    out = {}
    for name, run in runs:
        res = run()
        if res is not None:
            out[name] = res
            log(f"[p15 r{rank}] {name}: {res['seconds']:.1f} s, peak "
                f"{res['peak_gib']:.2f} GiB")
    tmp = Path(out_dir) / f"rank{rank}.json.tmp"
    tmp.write_text(json.dumps(out))
    tmp.rename(Path(out_dir) / f"rank{rank}.json")
    torch.distributed.destroy_process_group()


def run_group(target, arglists, out_dir: Path, timeout: float, what: str):
    """A gloo group: one spawned process a rank running target(*args) for
    each args of `arglists`, each rank writing rank<r>.json into out_dir.
    A rank that exits non-zero, or a group that outlives `timeout`, fails
    the phase, and every other rank is killed. Returns each rank's
    results."""
    import multiprocessing
    import shutil

    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=args) for args in arglists]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        while True:
            codes = [p.exitcode for p in procs]
            if any(c not in (None, 0) for c in codes):
                raise SmokeFailure(f"{what}: a rank failed (exit codes "
                                   f"{codes})")
            if all(c == 0 for c in codes):
                break
            if time.perf_counter() - t0 > timeout:
                raise SmokeFailure(f"{what}: the ranks did not finish in "
                                   f"{timeout} s (exit codes {codes})")
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
    res = [json.loads((out_dir / f"rank{r}.json").read_text())
           for r in range(len(procs))]
    log(f"[{what}] the group of {len(procs)} ranks took "
        f"{time.perf_counter() - t0:.1f} s")
    return res


def p15_spawn(seed: int, device: str = "cuda:0", shrink=None):
    """Phase 15's gloo group: P15_WORLD rank processes on `device`
    (`p15_rank`, through `run_group`). Returns each rank's results."""
    return run_group(p15_rank, [
        (r, P15_WORLD, str(P15_DIR / "init"), str(P15_DIR), seed, device,
         shrink) for r in range(P15_WORLD)], P15_DIR, P15_TIMEOUT_S,
        "phase 15")


def p15_nccl(device, seed, shrink=None):
    """NCCL at world size 1 in this process: one `tp_kernel_decode` step on
    a 2-layer cut at 7B widths (zero thresholds: every group survives, the
    first cap kept, so both paths keep the same groups), its launches
    (K1 4*L, K2 L), its logits and cache rows held to the single-device
    layer loop (`forward` off the token path) within 2e-2 of scale."""
    import torch
    import torch.distributed as dist

    from teal_tpu_torch.config import SparsityConfig, get_model_config
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.parallel import initialize_distributed, tp_kernel

    init = P15_DIR / "nccl_init"
    initialize_distributed(init_method=f"file://{init}", world_size=1,
                           rank=0, device=str(device))
    try:
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        cfg = get_model_config("7B", n_layers=P15_CUT, **(shrink or {}))
        mesh = tp_kernel.make_tp_mesh(1)
        params = p15_model(cfg, mesh, seed, device)
        sp = SparsityConfig(**MAIN_SP)
        th = llama.zero_thresholds(cfg, device)
        tok = torch.tensor([[7]], device=device)
        c_tp = p15_cache(cfg, mesh, 1, MAX_SEQ, device)
        c_ref = p15_cache(cfg, None, 1, MAX_SEQ, device)
        reset_launches()
        got, c_tp = tp_kernel.tp_kernel_decode(params, tok, c_tp, 0, th,
                                               cfg=cfg, sp=sp, mesh=mesh)
        counts = read_launches()
        L = cfg.n_layers
        check(counts == (4 * L, L, 0, 0, 0, 0), f"NCCL tp 1: launches "
              f"{counts}, expected {(4 * L, L, 0, 0, 0, 0)}")
        loop = sp.replace(packed_pipeline=False, token_fused=False)
        check(not llama.can_token_decode(params, cfg, loop, 1, 1,
                                         torch.bfloat16), "the reference "
              "forward must run the layer loop")
        want, c_ref = llama.forward(params, tok, c_ref, 0, th, cfg=cfg,
                                    sp=loop)
        errs = {name: rel_check(f"NCCL tp 1 {name} vs the layer loop", g, w,
                                2e-2) / float(w.float().abs().max())
                for name, g, w in (("logits", got, want),
                                   ("k row", c_tp.k[:, :, :, 0],
                                    c_ref.k[:, :, :, 0]),
                                   ("v row", c_tp.v[:, :, :, 0],
                                    c_ref.v[:, :, :, 0]))}
        log(f"[p15] NCCL world 1: one tp_kernel_decode step, launches "
            f"{counts}; relative errors against the layer loop "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        del params
        return dict(launches=list(counts), rel_err=errs)
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()


def p15_shard_specs(cfg, tp: int):
    """The four K1 calls of a layer of `tp_kernel_decode` on a tp shard:
    (stage, K, output widths)."""
    D, I, KV = cfg.dim, cfg.intermediate_size, cfg.kv_dim
    return (("qkv", D, (D // tp, KV // tp, KV // tp)), ("o", D // tp, (D,)),
            ("gate|up", D, (I // tp, I // tp)), ("down", I // tp, (D,)))


def p15_time_k1(cfg, device, gen, tp: int):
    """K1 as `tp_kernel_decode` calls it on a tp shard (no norm fold, no
    epilogue, fp32 sums; G from `effective_block_size(128, K)`, cap at
    keep 0.5) at the 7B's stage shapes: against its plain version in the
    three selection regimes (identical kept sets, 1e-4 of scale), then
    timed at count == cap, each call on another of P15_SHARD_LAYERS
    layers: kernel, plain version, `torch.matmul` at full keep, and the
    bytes bound. Returns (the stage rows, the largest error)."""
    import torch

    from teal_tpu_torch.ops import block_gemv as bg

    rows, worst, Lw = [], 0.0, P15_SHARD_LAYERS
    for name, K, Ns in p15_shard_specs(cfg, tp):
        G = bg.effective_block_size(128, K)
        nb = K // G
        cap = bg.block_capacity(nb, 0.5)
        ws = [(torch.randn((Lw, K, N), generator=gen, device=device)
               * 0.02).bfloat16() for N in Ns]
        for case, n_surv in (("count<cap", max(1, cap // 2)),
                             ("count==cap", cap),
                             ("overflow", min(nb, cap + max(1, nb // 4)))):
            x = spiky_input(K, gen, device, torch.bfloat16, G)
            thr, margin = threshold_for(bg.group_scores(x.float()[None], G),
                                        n_surv)
            check(margin > 1e-2, f"a group score lies within {margin:.2e} "
                  "of the threshold")
            thr = torch.tensor(thr, dtype=torch.float32, device=device)
            got, gidx, gcnt = bg.select_gather_gemv(x, thr, ws, 1, cap, G=G)
            want, widx, wcnt = bg.select_gather_gemv_plain(x, thr, ws, 1,
                                                           cap, G=G)
            check(int(gcnt[0]) == int(wcnt[0]) == min(n_surv, cap)
                  and bool((gidx == widx).all()),
                  f"K1 tp{tp} {name} {case}: kept sets differ")
            err = rel_check(f"K1 tp{tp} {name} {case}", got, want, 1e-4)
            worst = max(worst, err)
        nbytes = cap * G * sum(Ns) * 2 + K * 2 + sum(Ns) * 4
        x2 = x.reshape(1, K)
        lib = sum(cuda_ms(lambda i, w=w: torch.matmul(x2, w[i % Lw]), 64)[0]
                  for w in ws)
        rows.append(_plan_row(
            f"K1[tp{tp}] {name} G={G}", nbytes, 2 * cap * G * sum(Ns),
            lambda i: bg.select_gather_gemv(x, thr, ws, i % Lw, cap, G=G),
            lambda i: bg.select_gather_gemv_plain(x, thr, ws, i % Lw, cap,
                                                  G=G),
            lib, None, K=K, N=sum(Ns), cap=cap, G=G))
        del ws
    return rows, worst


def parallel_phase(device, gen, seed, card, shrink=None):
    """Phase 15: the gloo rank group (`p15_spawn`: TP at 7B widths through
    K1, K2 and K6, packed int4, tp 4 with K3 at batch 4, Mixtral's
    experts through K3, sp and pp prefill), NCCL at world size 1
    (`p15_nccl`), then, alone on the card, the shard-shape kernels' times
    (K1 at the tp 2 and tp 4 stage shapes, K2 at 16 heads, K6 at 16 heads
    and S = 2048). Returns (kernels entries, results)."""
    import torch

    from teal_tpu_torch.config import get_model_config
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops.flash_prefill import (
        flash_prefill_attention, flash_prefill_attention_plain)

    torch.cuda.empty_cache()
    ranks = p15_spawn(seed, str(device), shrink)
    r0 = ranks[0]
    for name, res in r0.items():
        peaks = [round(r[name]["peak_gib"], 2) for r in ranks if name in r]
        log(f"[p15] {name}: {res['seconds']:.1f} s on rank 0, peak GiB a "
            f"rank {peaks}; " + ", ".join(
                f"{k} {v}" for k, v in res.items()
                if k not in ("seconds", "peak_gib")))
    main = r0["tp2 7B"]
    log(f"[p15] tp2 7B ({main['layers']} layers): {main['tok_s']:.2f} tok/s "
        f"over {main['steps']} decode steps ({P15_LABEL}; {card})")
    nccl = p15_nccl(device, seed, shrink) if device.type == "cuda" else None

    cfg = get_model_config("7B", **(shrink or {}))
    k1 = {}
    for tp in (2, 4):
        k1[tp] = p15_time_k1(cfg, device, gen, tp)
    steps = main["steps"]
    src = "teal_tpu_torch/csrc/"
    entries = [_summed(
        k1[2][0], "select_gather_gemv[tp2 shard]", src +
        "select_gather_gemv.cu", "teal_tpu/ops/block_gemv.py:682",
        main["launches"][0], steps, k1[2][1],
        "one layer's four calls of tp_kernel_decode on a tp 2 shard of the "
        "7B (qkv N 6144, o K 2048, gate|up N 11008, down K 5504 at G 128) "
        "at count == cap, summed; launches of the tp2 7B run, a rank")]
    tp4 = r0["tp4 7B"]
    entries.append(_summed(
        k1[4][0], "select_gather_gemv[tp4 shard]", src +
        "select_gather_gemv.cu", "teal_tpu/ops/block_gemv.py:682",
        tp4["launches"][0], tp4["steps"], k1[4][1],
        "the same on a tp 4 shard (qkv N 3072, o K 1024, gate|up N 5504, "
        "down K 2752 at G 64); launches of the tp4 7B run (2 layers), a "
        "rank"))
    rope = llama.precompute_rope(cfg, MAX_SEQ, device)
    entries.append(time_k2(cfg, device, gen, rope, main["launches"][1],
                           steps, 0.0, "decode_attention[tp2: 16 heads]",
                           heads=(16, 16)))
    q, k, v = k6_inputs(2048, 16, 16, gen, device, torch.bfloat16)
    err6, _ = row_check("K6 S=2048 Hq=Hkv=16", flash_prefill_attention(
        q, k, v), flash_prefill_attention_plain(q, k, v), K6_BF16_ROW_TOL)
    entries.append(time_k6(device, gen, main["prefill_launches"][5], 1, err6,
                           seqs=(2048,), heads=((16, 16),),
                           name="flash_prefill_attention[tp2: 16 heads]"))
    return entries, dict(ranks=ranks, nccl=nccl, label=P15_LABEL)


# --- phase 16: the server on a tp group, launched over two "nodes" ---------

P16_WORLD = 2                    # two "nodes" of one rank each, both cuda:0
P16_DEPTH = 32                   # layers of the bf16 server at 7B widths
P16_CUT = 2                      # layers of the fp32 server and kernel-tp
P16_SLOTS = 4
P16_MAX_SEQ = 640
P16_LONG = 300                   # tokens; padded to 512: K6 at admission
P16_CHUNKED = 40                 # tokens, admitted under prefill_chunk=16
P16_CHUNK = 16
P16_SHORT = (5, 11, 17, 9)
P16_NEW = 8                      # new tokens a request
P16_LOGIT_TOL = 2e-2             # first decode step vs single process
P16_TIMEOUT_S = 480              # the rank group, start-up included
P16_DIR = ROOT / "build" / "chip_smoke_serving_tp"
P16_BENCH = dict(n_short=16, n_long=64, reps=5)
P16_LABEL = ("2 processes sharing one card through gloo, host-staged "
             "collectives; not a TP speed")


def p16_requests(cfg, seed):
    """Phase 16's six seeded requests of P16_NEW tokens: the one-shot
    server's (short, P16_LONG tokens, short, short) and the chunked
    server's (short, P16_CHUNKED tokens)."""
    import numpy as np

    rng = np.random.default_rng(seed + 16)

    def req(n):
        return rng.integers(1, cfg.vocab_size, n).tolist(), P16_NEW

    s = P16_SHORT
    return ([req(s[0]), req(P16_LONG), req(s[1]), req(s[2])],
            [req(s[3]), req(P16_CHUNKED)])


@contextlib.contextmanager
def p16_recording():
    """Records, while open, the final-normed stream of every `forward`
    (the input of `llama._lm_head`), the top two logits at every position
    of every prompt forward, and the input tokens and logits of every
    decode step (one token a slot)."""
    import torch

    from teal_tpu_torch.models import llama

    rec = dict(streams=[], prompts=[], decode=[])
    head, fwd = llama._lm_head, llama.forward

    def lm_head(params, h):
        rec["streams"].append(h.clone())
        return head(params, h)

    def forward(params, tokens, *a, **k):
        out = fwd(params, tokens, *a, **k)
        if tokens.shape[1] == 1:
            rec["decode"].append((tokens.clone(), out[0].clone()))
        else:
            rec["prompts"].append(torch.topk(out[0][0], 2, dim=-1).values)
        return out

    llama._lm_head, llama.forward = lm_head, forward
    try:
        yield rec
    finally:
        llama._lm_head, llama.forward = head, fwd


def p16_serve(cfg, params, device, mesh, subs, chunk):
    """Serve `subs` to their end: (each request's tokens, seconds, the
    engine)."""
    from teal_tpu_torch.engine import ContinuousBatchingEngine
    from teal_tpu_torch.models import llama

    eng = ContinuousBatchingEngine(
        cfg, params, slots=P16_SLOTS, max_seq=P16_MAX_SEQ,
        cache_dtype=llama.compute_dtype(params), prefill_chunk=chunk,
        device=device, mesh=mesh)
    for prompt, n in subs:
        eng.submit(prompt, n)
    _p15_sync(device)
    t0 = time.perf_counter()
    done = eng.run()
    _p15_sync(device)
    secs = time.perf_counter() - t0
    outs = [r.out for r in sorted(done, key=lambda r: r.id)]
    check([len(o) for o in outs] == [n for _, n in subs],
          f"served {[len(o) for o in outs]} tokens, expected "
          f"{[n for _, n in subs]}")
    return outs, secs, eng


def p16_first_step(rec, ref):
    """The first decode step of the one-shot server on the tp group (`rec`)
    against the single process's (`ref`): the largest error relative to
    the scale of the single process's logits, over the slots whose input
    tokens agree, and how many agree."""
    (tok, got), (rtok, want) = rec["decode"][0], ref["decode"][0]
    same = (tok == rtok).reshape(-1)
    if not bool(same.any()):
        return None, 0
    scale = float(want[same].abs().max())
    return float((got[same] - want[same]).abs().max()) / scale, \
        int(same.sum())


def p16_hold(shard, full, cfg, mesh, eng, one, rec, device):
    """The tp server's layers held to the single process's on the same
    input, one layer at a time (on tp rank 0, which holds the whole
    weights `full`; both ranks run the sharded layer, and each layer's
    next input is the single process's output, broadcast): the long
    prompt's admission prefill (`causal_prefill`, K6 on the rank's heads
    against K6 on every head; the layer output and the cache rows it
    writes, gathered over the heads), then the one-shot server's first
    decode step (slot b holds request b at pos len(prompt b), its cache
    as the engine left it, gathered; the layer output), then the head.
    Each within P16_LOGIT_TOL of scale. Returns the worst errors
    relative to scale."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine.generate import _pad_len
    from teal_tpu_torch.models import llama

    g = mesh.group("tp")
    sp = SparsityConfig()
    th = llama.zero_thresholds(cfg, device)
    dt = llama.compute_dtype(shard)
    worst = dict(prefill=0.0, decode=0.0, head=0.0)

    def layer(tree, i):
        return {k: llama._leaf(v, lambda a: a[i])
                for k, v in tree["layers"].items()}

    def held(what, pairs):
        for name, got, want in pairs:
            err = rel_check(f"{what} {name}: tp 2 vs one process", got, want,
                            P16_LOGIT_TOL)
            scale = float(want.float().abs().max())
            key = what.split()[0]
            worst[key] = max(worst[key], err / scale if scale else 0.0)

    prompt = one[1][0]
    S = _pad_len(len(prompt))
    toks = torch.zeros((1, S), dtype=torch.long, device=device)
    toks[0, :len(prompt)] = torch.tensor(prompt, device=device)
    cos_t, sin_t = llama.precompute_rope(cfg, S, device)
    at = torch.arange(S, device=device)[None]
    pos0 = torch.zeros(1, dtype=torch.long, device=device)
    h = shard["embed"][toks].to(dt)
    Dh, H = cfg.head_dim, cfg.n_kv_heads
    for i in range(cfg.n_layers):
        kc, vc = (torch.zeros((1, H // g.size, S, Dh), dtype=dt,
                              device=device) for _ in range(2))
        out, kc, vc, _ = llama.layer_forward(
            h, layer(shard, i), kc, vc, pos0, cos_t[at], sin_t[at], cfg, sp,
            th[i], causal_prefill=True, tp_group=g)
        kg, vg = g.all_gather(kc, 1), g.all_gather(vc, 1)
        ref = torch.empty_like(out)
        if full is not None:
            kr, vr = (torch.zeros((1, H, S, Dh), dtype=dt, device=device)
                      for _ in range(2))
            ref, kr, vr, _ = llama.layer_forward(
                h, layer(full, i), kr, vr, pos0, cos_t[at], sin_t[at], cfg,
                sp, th[i], causal_prefill=True)
            held(f"prefill layer {i}", (("output", out, ref), ("k", kg, kr),
                                        ("v", vg, vr)))
        h = g.broadcast(ref, 0)

    pos = torch.tensor([len(p) for p, _ in one], device=device)
    T = int(pos.max()) + 1
    cos_t, sin_t = llama.precompute_rope(cfg, T, device)
    cos, sin = cos_t[pos[:, None]], sin_t[pos[:, None]]
    h = shard["embed"][rec["decode"][0][0]].to(dt)
    for i in range(cfg.n_layers):
        kc = eng.cache.k[i, :, :, :T].clone()
        vc = eng.cache.v[i, :, :, :T].clone()
        kg, vg = g.all_gather(kc, 1), g.all_gather(vc, 1)
        out, _, _, _ = llama.layer_forward(h, layer(shard, i), kc, vc, pos,
                                           cos, sin, cfg, sp, th[i],
                                           tp_group=g)
        ref = torch.empty_like(out)
        if full is not None:
            ref, _, _, _ = llama.layer_forward(h, layer(full, i), kg, vg, pos,
                                               cos, sin, cfg, sp, th[i])
            held(f"decode layer {i}", (("output", out, ref),))
        h = g.broadcast(ref, 0)
    logits = g.all_gather(llama._lm_head(shard, llama.rms_norm(
        h, shard["final_norm"], cfg.norm_eps)), -1)
    if full is not None:
        held("head", (("logits", logits, llama._lm_head(full, llama.rms_norm(
            h, full["final_norm"], cfg.norm_eps))),))
    return worst


def p16_serve_run(what, cfg, mesh, seed, device, dtype, exact: bool):
    """The server on the tp group at `cfg` (weights drawn a layer at a
    time from the seed, this rank's shards): the one-shot and the chunked
    server, their launches counted around each run (K6 once a layer for
    the long prompt, nothing else), the cache on n_kv_heads / tp heads,
    every forward's stream and every request's tokens the same on every
    rank bit for bit; the layers held to the single process's on the same
    inputs (`p16_hold`); then on tp rank 0 the single-process servers on
    the whole weights: with `exact`, the same tokens and the first decode
    step's logits within P16_LOGIT_TOL of scale (in bf16 both are
    measured: rounding at other points compounds over the layers)."""
    import torch

    g = mesh.group("tp")
    L = cfg.n_layers
    card = device.type == "cuda"
    one, chunked = p16_requests(cfg, seed)
    _p15_peak(device, reset=True)
    t0 = time.perf_counter()
    params = p15_model(cfg, mesh, seed, device, dtype=dtype)
    build_s = time.perf_counter() - t0
    res = dict(layers=L, dtype=str(dtype).split(".")[-1], build_s=build_s)
    with p16_recording() as rec:
        reset_launches()
        outs1, s1, eng1 = p16_serve(cfg, params, device, mesh, one, None)
        res["launches"] = list(read_launches())
        reset_launches()
        outs2, s2, eng2 = p16_serve(cfg, params, device, mesh, chunked,
                                    P16_CHUNK)
        res["chunked_launches"] = list(read_launches())
    want = (0, 0, 0, 0, 0, L if card else 0)
    check(tuple(res["launches"]) == want, f"{what}: the one-shot server "
          f"launched (K1, K2, K3, K4, K5, K6) {res['launches']}, expected "
          f"{want}")
    check(tuple(res["chunked_launches"]) == (0,) * 6, f"{what}: the chunked "
          f"server launched {res['chunked_launches']}, expected none")
    heads = cfg.n_kv_heads // g.size
    for eng in (eng1, eng2):
        check(eng.cache.k.shape[2] == heads, f"{what}: the rank's cache has "
              f"{eng.cache.k.shape[2]} heads, expected {heads}")
    res["peak_gib"] = _p15_peak(device)
    for i, t in enumerate(rec["streams"]):
        check(all(torch.equal(p, t) for p in g.parts(t)),
              f"{what}: forward {i}'s stream differs between ranks")
    flat = torch.tensor([t for o in outs1 + outs2 for t in o], device=device)
    check(all(torch.equal(p, flat) for p in g.parts(flat)),
          f"{what}: the sampled tokens differ between ranks")
    n_new = sum(len(o) for o in outs1 + outs2)
    res.update(seconds_oneshot=s1, seconds_chunked=s2,
               tok_s=n_new / (s1 + s2), streams=len(rec["streams"]),
               outs=outs1 + outs2)
    full = (p15_model(cfg, None, seed, device, dtype=dtype)
            if g.index == 0 else None)
    t1 = time.perf_counter()
    res["hold_rel"] = p16_hold(params, full, cfg, mesh, eng1, one, rec,
                               device)
    res["hold_s"] = time.perf_counter() - t1
    del params, eng1, eng2
    if card:
        torch.cuda.empty_cache()
    if full is not None:
        with p16_recording() as ref:
            souts1, ss1, _ = p16_serve(cfg, full, device, None, one, None)
            souts2, ss2, _ = p16_serve(cfg, full, device, None, chunked,
                                       P16_CHUNK)
        agree = sum(a == b for o, so in zip(outs1 + outs2, souts1 + souts2)
                    for a, b in zip(o, so))
        err, rows = p16_first_step(rec, ref)
        res.update(single_tok_s=n_new / (ss1 + ss2), tokens_agree=agree,
                   tokens=n_new, first_step_rel_err=err,
                   first_step_rows=rows)
        log(f"[p16] {what}: {agree} of {n_new} tokens as in one process; "
            f"the first decode step {err if err is None else f'{err:.2e}'} "
            f"of scale over {rows} slots; "
            "layers held to one process (worst, of scale): "
            + ", ".join(f"{k} {v:.2e}" for k, v in res["hold_rel"].items()))
        if exact:
            check(outs1 + outs2 == souts1 + souts2, f"{what}: tokens "
                  f"{outs1 + outs2} on the tp group, {souts1 + souts2} in "
                  "one process")
            check(err is not None and err <= P16_LOGIT_TOL, f"{what}: the "
                  f"first decode step's logits are {err} of scale from the "
                  "single process's")
        del full, ref
        if card:
            torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    return res


def p16_rank(rank: int, env: dict, out_dir: str, seed: int,
             device: str = "cuda", shrink=None) -> None:
    """A rank of phase 16's group, started as torchrun starts a rank on
    its own node (`env`: RANK, WORLD_SIZE, LOCAL_RANK 0, ...), through
    `env://`: the bf16 server at P16_DEPTH layers, the fp32 server on a
    P16_CUT-layer cut, then the kernel-tp leg (`p15_tp_run`) on the same
    cut, then its results as JSON in out_dir. Runs in a process
    `p16_spawn` started."""
    import torch

    os.environ.update(env)
    sys.path.insert(0, str(ROOT))
    from teal_tpu_torch import _build
    from teal_tpu_torch.config import get_model_config
    from teal_tpu_torch.parallel import global_mesh, initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = initialize_distributed(backend="gloo", device=device,
                                 timeout=P16_TIMEOUT_S)
    import torch.distributed.distributed_c10d as c10d

    check(c10d._default_pg_init_method == "env://" and
          torch.distributed.get_rank() == rank,
          f"rank {rank} started through {c10d._default_pg_init_method}")
    if dev.type == "cuda":
        check(dev == torch.device("cuda", 0), f"rank {rank} on {dev}: "
              "LOCAL_RANK is 0 on every node")
        _build.load()
    mesh = global_mesh(tp=P16_WORLD)
    b7 = get_model_config("7B", **(shrink or {}))
    rep = dataclasses.replace
    cut = rep(b7, n_layers=P16_CUT)
    out = dict(device=str(dev), env={k: os.environ[k] for k in env})
    out["serve"] = p16_serve_run("tp2 server 7B bf16",
                                 rep(b7, n_layers=P16_DEPTH), mesh, seed,
                                 dev, torch.bfloat16, exact=False)
    out["serve_fp32"] = p16_serve_run("tp2 server 7B fp32 cut", cut, mesh,
                                      seed, dev, torch.float32, exact=True)
    out["kernel_tp"] = p15_tp_run("p16 kernel-tp tp2 7B", cut, mesh, seed,
                                  dev, prompt=P15_CUT_PROMPT,
                                  steps=P15_CUT_STEPS)
    for name in ("serve", "serve_fp32", "kernel_tp"):
        log(f"[p16 r{rank}] {name}: {out[name]['seconds']:.1f} s, peak "
            f"{out[name]['peak_gib']:.2f} GiB")
    tmp = Path(out_dir) / f"rank{rank}.json.tmp"
    tmp.write_text(json.dumps(out))
    tmp.rename(Path(out_dir) / f"rank{rank}.json")
    torch.distributed.destroy_process_group()


def p16_spawn(seed: int, device: str = "cuda", shrink=None):
    """Phase 16's group: P16_WORLD ranks as torchrun starts them on as many
    nodes of one rank each (RANK r, WORLD_SIZE, LOCAL_RANK 0,
    LOCAL_WORLD_SIZE 1, GROUP_RANK r, MASTER_ADDR 127.0.0.1 and a free
    MASTER_PORT), through `run_group`."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    envs = [dict(RANK=str(r), WORLD_SIZE=str(P16_WORLD), LOCAL_RANK="0",
                 LOCAL_WORLD_SIZE="1", GROUP_RANK=str(r),
                 GROUP_WORLD_SIZE=str(P16_WORLD), ROLE_RANK=str(r),
                 ROLE_WORLD_SIZE=str(P16_WORLD), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port)) for r in range(P16_WORLD)]
    return run_group(p16_rank, [(r, envs[r], str(P16_DIR), seed, device,
                                 shrink) for r in range(P16_WORLD)],
                     P16_DIR, P16_TIMEOUT_S, "phase 16")


def p16_bench_step(params, cfg, th, device, rope, step):
    """One main-path decode step (the token path at pos 40, phase 4's
    thresholds `th`) timed by `bench_chained` (each step's token the
    argmax of the step before, the thresholds the carry's float leaf),
    beside `time_decode_step`'s reading `step`; its launches counted
    around it (4*L K1 and L K2 a step)."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.utils.bench_utils import bench_chained

    sp = SparsityConfig(**MAIN_SP)
    cache = llama.KVCache.init(cfg, 1, MAX_SEQ, llama.compute_dtype(params),
                               device)

    def one(c):
        logits, _ = llama.forward(params, c["tok"], cache, 40, c["th"],
                                  cfg=cfg, sp=sp, rope=rope)
        return {"tok": torch.argmax(logits[:, -1:], dim=-1), "th": c["th"]}

    reset_launches()
    s = bench_chained(one, {"tok": torch.full((1, 1), 7, device=device),
                            "th": th}, **P16_BENCH)
    counts = read_launches()
    n = (P16_BENCH["n_short"] + P16_BENCH["n_long"]) * (P16_BENCH["reps"]
                                                         + 1)
    L = cfg.n_layers
    want = (4 * L * n, L * n, 0, 0, 0, 0) if device.type == "cuda" \
        else (0,) * 6
    check(counts == want, f"bench_chained's steps launched {counts}, "
          f"expected {want}")
    ref = step["sparse"]
    log(f"[p16] bench_chained: one main-path decode step {s * 1e3:.4f} ms "
        f"(median slope of {P16_BENCH['n_long']} vs {P16_BENCH['n_short']} "
        f"host-loop steps, {P16_BENCH['reps']} pairs; includes the host's "
        f"launches); time_decode_step: wall {ref['wall_ms']:.4f} ms, device "
        f"{ref['device_ms']:.4f} ms")
    return dict(ms=s * 1e3, time_decode_step_wall_ms=ref["wall_ms"],
                time_decode_step_device_ms=ref["device_ms"],
                launches=list(counts), **P16_BENCH)


def serving_tp_phase(device, gen, seed, card, p_entries, bench, shrink=None):
    """Phase 16: the group of `p16_spawn` (the tp 2 server at 7B widths,
    bf16 at P16_DEPTH layers and fp32 on a cut, then the kernel-tp leg),
    then K6 alone at the server's admission shape (S 512, 16 heads).
    p_entries: phase 15's kernels entries, whose K1 / K2 tp 2 times stand
    beside this phase's kernel-tp launches. Returns (kernels entries,
    results)."""
    import torch

    from teal_tpu_torch.ops.flash_prefill import (
        flash_prefill_attention, flash_prefill_attention_plain)

    ranks = p16_spawn(seed, "cuda" if device.type == "cuda" else "cpu",
                      shrink)
    r0 = ranks[0]
    for name in ("serve", "serve_fp32", "kernel_tp"):
        peaks = [round(r[name]["peak_gib"], 2) for r in ranks]
        res = r0[name]
        log(f"[p16] {name} ({res['layers']} layers): {res['seconds']:.1f} s on "
            f"rank 0, peak GiB a rank {peaks}; launches (K1, K2, K3, K4, K5, "
            f"K6) a rank: {res['launches']}"
            + (f", chunked {res['chunked_launches']}"
               if "chunked_launches" in res else ""))
    for name in ("serve", "serve_fp32"):
        res = r0[name]
        log(f"[p16] {name}: {res['tok_s']:.2f} tok/s on the tp 2 group "
            f"({P16_LABEL}), {res['single_tok_s']:.2f} tok/s in one process; "
            f"{card}")
    entries = []
    launches = r0["serve"]["launches"][5]
    if device.type == "cuda":
        q, k, v = k6_inputs(512, 16, 16, gen, device, torch.bfloat16)
        err, _ = row_check("K6 S=512 Hq=Hkv=16", flash_prefill_attention(
            q, k, v), flash_prefill_attention_plain(q, k, v),
            K6_BF16_ROW_TOL)
        entries.append(time_k6(
            device, gen, launches, 1, err, seqs=(512,), heads=((16, 16),),
            name="flash_prefill_attention[p16 server tp2: 16 heads, S 512]"))
        ktp = r0["kernel_tp"]
        for e in p_entries:
            if e["name"] in ("select_gather_gemv[tp2 shard]",
                             "decode_attention[tp2: 16 heads]"):
                i = 0 if e["name"].startswith("select") else 1
                entries.append(dict(
                    e, name=e["name"].replace("[", "[p16 kernel-tp, "),
                    launches=ktp["launches"][i],
                    launches_per_token=ktp["launches"][i] / ktp["steps"],
                    timed=e.get("timed", "") + "; times of phase 15 in this "
                    "run, launches of phase 16's kernel-tp leg (2 layers), a "
                    "rank"))
    return entries, dict(ranks=ranks, bench=bench, label=P16_LABEL)


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

    check_k1_plan(cfg, caps)
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
    with plain_path():          # row 2's plain version: one plain step
        step.update(time_decode_step(
            params, cfg, [("sparse, plain kernels", MAIN_SP, 1, th)],
            device, rope))
    bench = p16_bench_step(params, cfg, th, device, rope, step)
    line = time_kernels(params, cfg, caps, device, gen, rope, launches,
                        (e1, e2))
    line["kernels"] += time_loop_kernels(params, cfg, device, gen, loop,
                                         e_loop)
    line["lm_head_ms"] = time_lm_head(params, cfg, device, gen)
    line["decode_tok_s"] = speeds
    line["decode_tok_s_loop_paths"] = {n: r["tok_s"] for n, r in loop.items()}
    line["decode_step_ms"] = step
    b_entries, line["batched"], _ = batched_phase(params, cfg, caps, device,
                                                  gen, seed, rope)
    line["kernels"] += b_entries
    q_entries, q_runs, q_extra = quant_paths(params, cfg, caps, device, gen,
                                             seed, rope)
    line["kernels"] += q_entries
    line["decode_tok_s_quant_paths"] = {n: r["tok_s"]
                                        for n, r in q_runs.items()}
    line["quant"] = q_extra
    l_entries, line["long_prompts"] = long_prompt_phase(params, cfg, device,
                                                        gen, seed, th)
    line["kernels"] += l_entries
    line["calibration"] = calibration_phase(params, cfg, device, seed)
    line["speculative"] = speculative_phase(params, cfg, device, seed, th,
                                            speeds)
    line["cli"] = cli_phase(device)
    # phase 10 needs the card's memory for int8 Mixtral-8x7B (46 GB)
    del params
    torch.cuda.empty_cache()
    m_entries, line["moe"] = moe_phase(device, gen, seed)
    line["kernels"] += m_entries
    p_entries, line["parallel"] = parallel_phase(device, gen, seed, card)
    line["kernels"] += p_entries
    s_entries, line["serving_tp"] = serving_tp_phase(device, gen, seed, card,
                                                     p_entries, bench)
    line["kernels"] += s_entries
    line["card"] = card
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
