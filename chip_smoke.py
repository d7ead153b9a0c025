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
     read just after: L K8 and 3*L K1 launches per decoded token (the
     one-row loop, phase 21); dense and sparse decode tok/s;
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
     per decode step A: K3 4*L and K2 L, B: K8 L and K1 3*L, C: K4 7*L;
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
     step asserted (Q8-main: K1 4*L + K2 L; Q4-main: K8 L + K1 3*L; loop
     paths: K3 4*L + K2 L);
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
     exactly L K6 launches for the long prefill besides L K8 + 3*L K1 a
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
     L K8 + 3*L K1 launches a draft step and one K7 a verify chunk, every
     emitted
     token the argmax of its verify row and the cache rows of the emitted
     tokens the verify's bit for bit; the first round's verify rerun equal
     to the recorded one, each layer held to the plain path (2e-2), and
     on an fp32 copy held to the plain path (2e-2 of scale); t_round,
     tok/s beside dense decode in turns, mean accepted; `forced_alpha`
     0.5 and 0.9, the realized acceptance within 4 binomial standard
     deviations; `device_loop=True, adaptive_k=True` giving the host
     loop's tokens (the wrappers launching each captured depth's round
     twice, at its warm-up and its capture); the round graphs
     (`device_loop=True`) against the host round loop at temperature 0,
     at temperature 1 from one seed and at forced_alpha 0.9, in turns:
     the same tokens, new_tokens, mean accepted and rounds, the wrappers'
     launches those of the warm-up and the capture, one replayed round's
     kernel nodes (k x (L K8 + 3*L K1) and one K7),
     t_round of both loops;
 14. the CLI (`teal_tpu_torch.cli.main` in-process, `cli_phase`) on a
     2-layer cut of the 7B config at full widths, random weights from
     seed 0: generate dense, calibrate (2 x 2048 tokens, 1 K6 launch a
     layer), generate sparse at its thresholds (`--kernel block
     --group-thresholds --block-size 128`; through the decode step's
     CUDA graph: the wrappers launch at the capture only, 3 x (4*L K1 +
     L K2), where the host loop would launch that a token),
     self-speculation with --metrics and --profile (a non-empty trace), ppl at 2048 + 512, eval
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
 17. the on-device decode loop (`Generator.generate(on_device_loop=True)`,
     the default: the decode step captured once as a CUDA graph and
     replayed once a token; `graph_route`), on every route the script's
     `Generator` drives, inside the phase that holds its params: the main
     path and dense decode on the resident bf16 7B after phase 4 at its
     thresholds (`device_loop_phase`), paths A, A-b4, B and C (phase 6),
     Q8-main, Q8-main-b16, Q8-loop, Q4-main, Q4-main-b16 and Q4-loop
     (phase 8), Mixtral int8 at 32 layers and bf16 at 8 (phase 10): the
     launch counts reset just before the capture and read just after (two
     warm-up steps and the captured one: 3 x the step's launches); three
     prompts x 16 tokens (8 on the paths of phases 6 and 8) from the host
     loop and from the graph, at
     temperature 0 and at 0.8 from one generator seed, the tokens equal;
     one replay's K1-K6 executions from the profiler's kernel records,
     never more than the step's launches (main: L K8 + 3*L K1 = 128,
     gated equal; Mixtral: 6*L K1 + L K2 + L K5 = 256; later phases'
     traces have dropped a few records, reported); the replayed step's
     device time, wall
     time and idle share; tok/s of both loops in three turns (of twice
     those tokens);
 18. K7, the whole token in one launch (`k7_phase`, on the resident bf16 7B
     after phase 17, at phase 4's thresholds). The batch-1 bf16 checks of
     phases 4-17 pin the K1/K2 loop (`LOOP_SP`: `token_fused=False`, the
     reference's packed pipeline) and check what they checked before K7;
     batched, int8, int4 and Mixtral routes keep `MAIN_SP` (K7 takes the
     batched bf16 rows since phase 19's slice: the server's step is one
     K7 launch); the CLI of phase 14 builds its own config and takes K7
     (one launch a step, k a speculative round). Phase 18 drives the main
     path as a user calls it (`MAIN_SP`, token_fused unset): K7's plan in
     the wrapper equal to the kernel's on the card's resident clusters
     (`check_k7_plan`: 7B, Mistral-7B with its window, the tiny test
     configs; the 7B's head-owned, 4 grid and no kv-head barriers a
     layer); every layer of K7 alone, on a one-layer slice of the
     stack, held to the plain layer on the same input (output and written
     K/V rows within 2e-2 of scale, kept counts and groups equal or a
     one-group flip `explain_count_flip` explains; `hold_k7_layers`); the
     same for 2 layers at pos 2047 of a 2048-row cache, and one 2-layer
     launch against `token_kernel_plain`; each layer of a 2-layer GQA
     model at the 7B's width (Hq 32 / Hkv 8, random weights) held the same
     way at pos 2047 (`k7_gqa_hold`); phase 4's three prompts through
     K7 (host loop, counts set to 0 just before: one K7 and no K1-K6 a
     decoded token) and through the K1/K2 loop: bf16 agreement reported,
     tokens equal on a 2-layer fp32 cut at 7B widths; the two decode
     graphs' nodes (one K7 node; 4 L K1 + L K2) and, in turns, a replay's
     device and wall ms, idle share and tok/s; K7's kernel ms, plain ms,
     bound (this token's kept groups), barrier floor (`empty`) and the
     trace (`stamps`: block 0's layer phases, every block's arrival at
     every grid barrier), and its time at pos 2047 of a 2048-row cache;
     self-speculation with the K7 draft (k + 1 K7 launches a round: the
     draft steps and the verify chunk, phase 20); a 2-layer cut of llama-3-70b's widths (64/8 heads, D 8192,
     I 28672; random weights, packed int4 at group 128) at pos 8191 of
     an 8192-row cache, which K7 could not plan before its attention
     walked the cache in chunks (`k7_fault31`: the plan in the wrapper
     equal to the kernel's, the route K7, each layer held to the plain
     path, one launch against the K1/K2 loop);
 19. K7's rows form (`token_decode_rows.cu`), inside phase 9 after the
     server picked its thresholds: its plan in the wrapper equal to the
     kernel's (`check_k7_rows_plan`: B 2, 8, 16 at the 7B, Mistral-7B and
     llama-3-70b's widths); every 7B layer held to the plain path at B =
     2, 8 and 16, row i at 40 + 4 i on a cache of random rows (output and
     each row's written K/V within 2e-2 of scale, kept groups equal or an
     explained one-group flip), and the first two layers in fp32 at B =
     16 (`k7_rows_holds`); the server's one-shot and chunked runs with one
     K7 launch a decode step and no K1-K6; the B = 16 step through K7 and
     with token_fused=False in turns (device and wall ms, idle, tok/s;
     `server_turns`); K7's rows form's kernel ms, plain ms and bound at B =
     16 (`k7_rows_times`);
 20. K7's rows form with int8 and packed-int4 weights and its seq_block
     form (`token_decode_rows.cuh`, the quantized kernels built by
     `token_decode_rows_quant.cu`). In phase 8, on each quantized copy
     (int8; int4 at group 128): the Q·-main-b16 server steps one K7 launch
     a step and no K1-K6 (`QUANT_K7`, also in their decode graph: one K7
     node); every 7B layer held at B = 2, 8 and 16 (`k7_rows_holds`);
     the B = 16 call through K7 and through the K1/K2 loop
     (`token_decode(token_fused=False)`) on the same inputs in turns
     (`k7_loop_turns`: device and wall ms, idle); K7's kernel ms, plain ms
     and bound (`k7_rows_times`); `block_verify` at S = 5 and 12, every
     layer of each chunk through K7's seq_block form held to the plain
     path (`k7_quant_verify`, `k7_verify_holds`) and ceil(S/8) K7
     launches. In phase 9, `block_verify` at S = 4, 8, 12 takes one K7
     launch a chunk and no K1-K6, each chunk's layers held through K7 as
     well as on the K1/K2 loop; the S = 8 chunk through K7 and the loop in
     turns; the seq_block form's kernel ms, plain ms and bound
     (`k7_seq_times`). In phase 13, every verify chunk is one K7 launch
     (the draft k x (4L K1 + L K2)): the launch counts, the round graphs'
     kernel nodes (one K7 node a round) and the first round's chunk held
     through K7;
 21. K8, the one-row attention stage in one launch (`csrc/attn_block.cu`,
     `check_k8` after phase 3): its plan in the wrapper equal to the
     kernel's (`check_k8_plan`: 1296 shapes, among them the 70b cut's);
     K8 against its plain version at the 7B's width: bf16 and fp32 arrays
     at G 128 and 32, packed int4 at G 128, MHA 32/32 and GQA 32/8 with a
     window of 64, pos 0, 1, 127, 128, 511 of a 512-row cache and 2047 of
     a 2048-row one, each in the three selection regimes of phase 2 and
     `fixed`: identical kept sets and counts, the written k/v row within
     2^-7 (bf16) or 1e-4 (fp32) of its scale and every other cache row
     bit for bit, each head's output within 2^-6 / 1e-4 of its largest
     value, two calls bit for bit (`k8_case`). The one-row loop (phases
     4, 6's path B, 8's Q4-main, 11-13, 16's bench step, 17's main graph,
     18's loop legs, fault 3.1's loop, Mixtral's bf16 loop) launches L K8
     and no K2 a step, its graphs hold L K8 nodes (`k8_nodes`), and the
     plain path swaps K8 for `attn_block_plain`. In phase 7 K8's times
     (`time_k8`): 7B bf16 at G 128 and 32 and int4 at G 128, pos 511 and
     2047, beside K1's q|k|v call + K2 on the same inputs in turns, its
     plain version and its bound;
all printed as one `kernels` JSON line, with the card in it (and the
results of phases 12-18 under "calibration", "speculative", "cli",
"parallel", "serving_tp", "device_loop" and "k7");
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
# the loop at batch 1 (`token_fused=False`, the reference's packed
# pipeline, where MAIN_SP takes K7 for fp32 / bf16 arrays and, with a bf16
# stream, all-int8 and packed int4 at group 128): the batch-1 checks of
# phases 4-17 and phase 8's Q8-main and Q4-main hold it as they did before
# K7 (Q4-main: the K1/K2 loop; Q8-main: the model's layer loop, where the
# reference sends int8 with token_fused False, also 4 K1 + 1 K2 a layer);
# batched and Mixtral routes keep MAIN_SP, whose route K7 leaves unchanged
# (token_fused=False would send them to the layer loop)
LOOP_SP = dict(MAIN_SP, token_fused=False)
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
                 "B": (3, 0, 0, 0, 0, 0), "C": (0, 0, 0, 7, 0, 0)}
# K8 launches per layer and decode step: the one-row attention stage
# (`attn_block.attn_block`) of path B and of the one-row K1/K8 loop
LOOP_K8 = {"B": 1}
# the one-row loop's launches a layer (`token_fused=False` or the layer
# loop at batch 1, arrays or packed int4): K8, then K1 for o, gate|up and
# down; no K2
LOOP_ROW = (3, 0, 0, 0, 0, 0)
LOOP_NEW_TOKENS = 8
PROJ_NAMES = ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown")
STAGE_WEIGHTS = {"qkv": ("wq", "wk", "wv"), "o": ("wo",),
                 "gate|up": ("wgate", "wup"), "down": ("wdown",)}
# the weight-only quantized paths: (quantization, SparsityConfig, batch);
# "int4-g128" / "int4-g64": int4 at that group, packed at block size 128 /
# 32 (quant group == gather group: no requantization)
QUANT_PATHS = {
    "Q8-main": ("int8", LOOP_SP, 1),
    "Q8-main-b16": ("int8", MAIN_SP, 16),
    "Q8-loop": ("int8", LOOP_PATHS["A"][0], 1),
    "Q4-main": ("int4-g128", LOOP_SP, 1),
    "Q4-main-b16": ("int4-g128", MAIN_SP, 16),
    "Q4-loop": ("int4-g64", LOOP_PATHS["A"][0], 1),
}
QUANT_LAUNCHES = {"Q8-main": (4, 1, 0, 0, 0, 0),
                  "Q8-main-b16": (0, 0, 0, 0, 0, 0),
                  "Q8-loop": (0, 1, 4, 0, 0, 0), "Q4-main": LOOP_ROW,
                  "Q4-main-b16": (0, 0, 0, 0, 0, 0),
                  "Q4-loop": (0, 1, 4, 0, 0, 0)}
# K8 launches per layer and step: Q4-main's one-row loop (int8's attention
# stays K1 + K2)
QUANT_K8 = {"Q4-main": 1}
# K7 launches a decode step (not a layer): the quantized server steps of 16
# rows take K7's int8 / int4 rows form, one launch a step and no K1-K6
QUANT_K7 = {"Q8-main-b16": 1, "Q4-main-b16": 1}


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


# --- phase 21 (beside phases 2 and 3): K8, the attention stage ------------

# K8's check shapes at the 7B's width (K 4096, head_dim 128, keep 0.5):
# (tag, stream type, weights, G, Hq, Hkv, window, T, positions)
K8_POS = (0, 1, 127, 128, 511)
K8_CASES = (
    ("bf16 G128", "bfloat16", "array", 128, 32, 32, None, 512, K8_POS),
    ("bf16 G32", "bfloat16", "array", 32, 32, 32, None, 512, K8_POS),
    ("fp32 G128", "float32", "array", 128, 32, 32, None, 512, K8_POS),
    ("fp32 G32", "float32", "array", 32, 32, 32, None, 512, K8_POS),
    ("int4 G128", "bfloat16", "int4", 128, 32, 32, None, 512, K8_POS),
    ("bf16 GQA 32/8 w64", "bfloat16", "array", 128, 32, 8, 64, 512, K8_POS),
    ("fp32 GQA 32/8 w64", "float32", "array", 32, 32, 8, 64, 512, K8_POS),
    ("bf16 T2048", "bfloat16", "array", 128, 32, 32, None, 2048, (2047,)),
    ("int4 GQA T2048", "bfloat16", "int4", 128, 32, 8, None, 2048, (2047,)),
)
K8_KEEP = 0.5
# K8 against its plain version: each (head) output row within this of its
# row's largest value (bf16: each side rounds its output, and its weights
# before PV, to bf16 from scores summed in other orders); the written k/v
# row within K8_ROW_TOL's second column of the row's scale
K8_ROW_TOL = {"bfloat16": (2 ** -6, 2 ** -7), "float32": (1e-4, 1e-4)}
# K8's timed cases: (tag, weights, G, pos, T) on the resident 7B's layers
K8_TIMES = (("bf16 G128", "array", 128, 511, 512),
            ("bf16 G32", "array", 32, 511, 512),
            ("int4 G128", "int4", 128, 511, 512),
            ("bf16 G128", "array", 128, 2047, 2048),
            ("bf16 G32", "array", 32, 2047, 2048),
            ("int4 G128", "int4", 128, 2047, 2048))
K8_TIME_ITERS = 64
K8_INT4_LAYERS = 8               # int4 q|k|v stacks timed (> L2 together)


# the slice's K8 shapes: (what, `k8_plan`'s stream type code, weight plan,
# G, K, Hq, Hkv, cap)
K8_SLICE_PLANS = (("7B path B", 1, 0, 32, 4096, 32, 32, 64),
                  ("7B loop", 1, 0, 128, 4096, 32, 32, 16),
                  ("7B fp32", 0, 0, 128, 4096, 32, 32, 16),
                  ("7B int4", 1, 2, 128, 4096, 32, 32, 16),
                  ("GQA 32/8", 1, 0, 128, 4096, 32, 8, 16),
                  ("70b int4", 1, 2, 128, 8192, 64, 8, 32))


def check_k8_plan():
    """The wrapper's K8 plan (`attn_block.k8_plan`: C, grid, shared bytes,
    or none) equal to the kernel's (`teal_attn_block_plan`) on this card's
    SM count: both stream types, K 1024-32768 (one block an SM at 32768),
    every G and weight plan, caps 1, nb / 2 and nb, GH 1-8 and Hkv 1-64;
    the rule's premise against the card's reading (`teal_attn_block_
    clusters`): every instance (stream type, weight plan, GH) holds
    `k8_blocks_an_sm` blocks an SM; and every shape of `K8_SLICE_PLANS`
    has a plan whose Hkv clusters are all resident at once (one wave).
    Logs the readings for clusters of 1-8 at the 7B. Returns the number of
    shapes checked."""
    import torch

    from teal_tpu_torch import _build
    from teal_tpu_torch.ops import attn_block as ab

    sms = _build.sm_count(torch.cuda.current_device())
    n = 0
    for code in (0, 1):
        for K in (4096, 8192, 1024, 32768):
            for plan in (0, 2):
                for G in (32, 64, 128):
                    nb = K // G
                    for cap in sorted({1, nb // 2, nb}):
                        for Hq, Hkv in ((32, 32), (32, 8), (64, 8), (4, 2),
                                        (8, 1), (12, 4), (48, 48), (64, 64),
                                        (16, 16)):
                            shape = (code, plan, G, K, Hq, Hkv, cap)
                            want = ab.k8_plan(*shape, sms)
                            got = ab.k8_card_plan(*shape, sms)
                            check(got == want, f"K8 plan at {shape}: the "
                                  f"kernel's {got}, the wrapper's {want}")
                            n += 1
    clusters = _build.load()["attn_block"].teal_attn_block_clusters
    for code in (0, 1):
        for plan in (0, 2):
            for GH in ab.K8_HEAD_GROUPS:
                smem = ab._k8_smem(4096, 128, 16, GH)
                want = ab.k8_blocks_an_sm(code, plan, GH, smem) * sms
                got = clusters(code, plan, GH, 1, smem)
                check(got == want, f"K8 instance (dtype {code}, plan {plan}"
                      f", GH {GH}) at {smem} shared bytes: the card holds "
                      f"{got} blocks, the plan counts {want}")
    plans = []
    for what, *shape in K8_SLICE_PLANS:
        code, plan, Hq, Hkv = shape[0], shape[1], shape[4], shape[5]
        got = ab.k8_plan(*shape, sms)
        check(got is not None, f"K8 has no plan for {what} {shape}")
        C, _, smem = got
        res = clusters(code, plan, Hq // Hkv, C, smem)
        check(res >= Hkv, f"K8 {what}: {res} clusters of {C} resident, "
              f"fewer than its {Hkv} kv heads (a second wave)")
        plans.append(f"{what} {got} ({res} resident)")
    log(f"[k8] the wrapper's plan equals the kernel's at all {n} shapes "
        f"checked ({sms} SMs); every instance holds the blocks an SM the "
        f"plan counts; (C, grid, shared bytes): {'; '.join(plans)}")
    for what, code, plan in (("bf16", 1, 0), ("int4", 1, 2)):
        smem = ab._k8_smem(4096, 128, 16, 1)
        got = {C: clusters(code, plan, 1, C, smem) for C in range(1, 9)}
        log(f"[k8] 7B {what} ({smem} shared bytes a block): clusters of C "
            f"blocks the card keeps resident (cudaOccupancyMaxActive"
            f"Clusters) {got}")
    return n


def k8_weights(K, Hq, Hkv, L, kind, G, gen, device, dtype):
    """Random q|k|v stacks [L, K, N] of `dtype`, or (int4) those drawn in
    bf16 quantized at group G and packed (`quant.pack_int4`)."""
    import torch

    from teal_tpu_torch.ops import quant

    ws = []
    for n in (Hq * 128, Hkv * 128, Hkv * 128):
        w = (torch.randn(L, K, n, generator=gen, device=device) * 0.02)
        if kind == "int4":
            packs = [quant.pack_int4(quant.quantize_int4(w[i], G))
                     for i in range(L)]
            ws.append({k: torch.stack([p[k] for p in packs])
                       for k in ("qp", "sz")})
        else:
            ws.append(w.to(dtype))
        del w
    return ws


def k8_input(K, G, L, layer, gen, device, dtype):
    """A spiky stream (`spiky_input`) and attention-norm gains [L, K] of 1
    +- 0.1, exactly 1 at each group's spike: the selection input's scores
    keep the spikes' 5% spacing."""
    import torch

    x = spiky_input(K, gen, device, dtype, G)
    norm = 1 + 0.1 * torch.randn(L, K, generator=gen, device=device)
    peak = (x.float().abs().reshape(-1, G).argmax(-1)
            + torch.arange(K // G, device=device) * G)
    norm[:, peak] = 1.0
    return x, norm.to(dtype)


def k8_case(what, x, thr, ws, layer, cap, norm, kc, vc, pos, rope, *,
            n_heads, window, G, fixed, tol):
    """K8 twice and its plain version on copies of the caches: the same
    kept groups and count, the two calls bit for bit (outputs, kept sets,
    caches), the written k/v row within tol[1] of its scale and every other
    cache row bit for bit, each (head) output row within tol[0] of its
    largest value. Returns (largest output error, worst row ratio, kept
    count)."""
    import torch

    from teal_tpu_torch.ops.attn_block import attn_block, attn_block_plain

    kw = dict(n_heads=n_heads, window=window, G=G, fixed=fixed)
    runs = []
    for _ in range(2):
        k1, v1 = kc.clone(), vc.clone()
        runs.append((*attn_block(x, thr, *ws, layer, cap, norm, 1e-5, k1,
                                 v1, pos, rope, **kw), k1, v1))
    k2, v2 = kc.clone(), vc.clone()
    want, widx, wcnt = attn_block_plain(x, thr, *ws, layer, cap, norm, 1e-5,
                                        k2, v2, pos, rope, **kw)
    a, b = runs
    check(all(torch.equal(u, w) for u, w in zip(a, b)),
          f"{what}: two identical calls differ")
    out, idx, cnt, k1, v1 = a
    check(torch.equal(idx, widx) and torch.equal(cnt, wcnt),
          f"{what}: kept {int(cnt[0])} {idx.tolist()}, plain "
          f"{int(wcnt[0])} {widx.tolist()}")
    p = int(pos[0])
    for name, got, ref in (("k", k1, k2), ("v", v1, v2)):
        rel_check(f"{what}: the written {name} row", got[layer, :, :, p],
                  ref[layer, :, :, p], tol[1])
        got, ref = got.clone(), ref.clone()
        got[layer, :, :, p] = 0
        ref[layer, :, :, p] = 0
        check(torch.equal(got, ref), f"{what}: {name} cache rows other "
              "than pos differ")
    err, ratio = row_check(what, out.view(n_heads, 128),
                           want.view(n_heads, 128), tol[0])
    return err, ratio, int(cnt[0])


def check_k8(cfg, device, gen):
    """K8 (`attn_block`) against its plain version (`k8_case`) at
    `K8_CASES`, each position with the three selection regimes of phase 2
    (count < cap, count == cap with groups under the threshold, more
    survivors than cap) and `fixed`; its plan against the kernel's
    (`check_k8_plan`). Returns the largest bf16 output error."""
    import torch

    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops.block_gemv import group_scores, selection_input
    from teal_tpu_torch.ops.sparsify import group_capacity

    if device.type == "cuda":
        check_k8_plan()
    K, L, layer = cfg.dim, 2, 1
    ropes = {T: llama.precompute_rope(cfg, T, device)
             for T in {c[7] for c in K8_CASES}}
    worst = 0.0
    for tag, dts, kind, G, Hq, Hkv, window, T, poss in K8_CASES:
        dt = getattr(torch, dts)
        nb = K // G
        cap = group_capacity(nb, K8_KEEP)
        ws = k8_weights(K, Hq, Hkv, L, kind, G, gen, device, dt)
        kc = torch.randn(L, 1, Hkv, T, 128, generator=gen,
                         device=device).to(dt)
        vc = torch.randn(L, 1, Hkv, T, 128, generator=gen,
                         device=device).to(dt)
        for p in poss:
            pos = torch.tensor([p], dtype=torch.int32, device=device)
            rope = torch.stack([ropes[T][0][p], ropes[T][1][p]])[None]
            line = []
            for regime, n_surv in (("count<cap", max(1, cap // 2)),
                                   ("count==cap", cap),
                                   ("overflow", min(nb, cap + nb // 4)),
                                   ("fixed", cap)):
                x, norm = k8_input(K, G, L, layer, gen, device, dt)
                xs = selection_input(x, norm, layer, 1e-5)
                thr, margin = threshold_for(group_scores(xs.float()[None],
                                                         G), n_surv)
                check(regime == "fixed" or margin > 1e-2, f"K8 {tag}: a "
                      f"group score lies within {margin:.2e} of the "
                      "threshold")
                what = f"K8 {tag} pos={p} {regime}"
                err, ratio, kept = k8_case(
                    what, x, torch.tensor(thr, device=device), ws, layer,
                    cap, norm, kc, vc, pos, rope.contiguous(), n_heads=Hq,
                    window=window, G=G, fixed=regime == "fixed",
                    tol=K8_ROW_TOL[dts])
                check(kept == min(n_surv, cap), f"{what}: kept {kept}, "
                      f"expected {min(n_surv, cap)}")
                if dt == torch.bfloat16:
                    worst = max(worst, err)
                line.append(f"{regime} kept {kept} err {err:.2e} row "
                            f"{ratio:.1e}")
            log(f"[k8] {tag} (G={G} cap={cap} {Hq}/{Hkv} window={window} "
                f"T={T}) pos={p}: " + "; ".join(line)
                + "; kept sets equal, two calls identical")
        del ws, kc, vc
        torch.cuda.empty_cache()
    return worst


def k8_bound(K, G, cap, Hq, Hkv, p, esz, int4: bool):
    """K8's least time on the card (`bound_ms`) for a call keeping `cap`
    groups at pos p: the kept slab rows of q|k|v (int4: half a byte an
    element and each kept group's scale and zero rows), the live cache
    rows of K and V, the gains and the stream, the cos|sin row, the output
    and the written k/v rows; 2 flops a kept weight and 4 a live cache
    element of each query head. Returns (ms, "bytes" or "operations",
    bytes)."""
    n = (Hq + 2 * Hkv) * 128
    w = cap * G * n // 2 + cap * 2 * n * 4 if int4 else cap * G * n * esz
    nbytes = (w + 2 * p * Hkv * 128 * esz + 2 * K * esz + 2 * 128 * 4
              + Hq * 128 * esz + 2 * Hkv * 128 * esz)
    ms, by = bound_ms(nbytes, 2 * cap * G * n + 4 * Hq * p * 128)
    return ms, by, nbytes


def time_k8(params, cfg, device, gen, launches, err):
    """K8 on the resident 7B's q|k|v stacks (bf16, every layer in turn so
    that calls do not share L2; int4 on `K8_INT4_LAYERS` layers quantized
    at group 128) at `K8_TIMES`, zero thresholds (count == cap): one
    `k8_case`, then its time and that of K1's q|k|v call followed by K2 on
    the same inputs, in turns (K8, K1 + K2, K1 + K2, K8; CUDA events behind
    a sleep, `cuda_ms`), the plain version's and the bound. Returns the
    `kernels` entry (launches: `launches`, {route: (K8 launches, steps)}
    of the main path's runs)."""
    import torch

    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import attn_block as ab
    from teal_tpu_torch.ops import block_gemv as bg
    from teal_tpu_torch.ops import decode_attention as da
    from teal_tpu_torch.ops import quant
    from teal_tpu_torch.ops.sparsify import group_capacity

    lay = params["layers"]
    K, Hq, Hkv = cfg.dim, cfg.n_heads, cfg.n_kv_heads
    norm = lay["attn_norm"]
    arrays = (lay["wq"], lay["wk"], lay["wv"])
    nl4 = K8_INT4_LAYERS
    int4 = [{k: torch.stack([quant.pack_int4(quant.quantize_int4(
        w[i], 128))[k] for i in range(nl4)]) for k in ("qp", "sz")}
        for w in arrays]
    x = torch.randn(K, generator=gen, device=device).to(torch.bfloat16)
    thr = torch.zeros((), device=device)
    rows, worst = [], err
    for tag, kind, G, p, T in K8_TIMES:
        ws = int4 if kind == "int4" else arrays
        L = nl4 if kind == "int4" else cfg.n_layers
        nrm = norm[:L].contiguous()
        cap = group_capacity(K // G, K8_KEEP)
        kc = torch.randn(L, 1, Hkv, T, 128, generator=gen,
                         device=device).bfloat16()
        vc = torch.randn(L, 1, Hkv, T, 128, generator=gen,
                         device=device).bfloat16()
        rope_t = llama.precompute_rope(cfg, T, device)
        row = torch.stack([rope_t[0][p], rope_t[1][p]])[None].contiguous()
        pos = torch.tensor([p], dtype=torch.int32, device=device)
        e, ratio, kept = k8_case(f"K8 timed {tag} pos={p}", x, thr, ws, 0,
                                 cap, nrm, kc, vc, pos,
                                 row, n_heads=Hq, window=None, G=G,
                                 fixed=False, tol=K8_ROW_TOL["bfloat16"])
        check(kept == cap, f"K8 timed {tag}: kept {kept} of cap {cap}")
        worst = max(worst, e)
        nq, nk = Hq * 128, Hkv * 128

        def k8(i):
            ab.attn_block(x, thr, *ws, i % L, cap, nrm, cfg.norm_eps, kc,
                          vc, pos, row, n_heads=Hq, G=G)

        def k1k2(i):
            qkv, _, _ = bg.select_gather_gemv(x, thr, ws, i % L, cap, G=G,
                                              norm=nrm,
                                              norm_eps=cfg.norm_eps)
            r = qkv.view(1, -1)
            da.decode_attention(r[:, :nq].view(1, Hq, 128),
                                r[:, nq:nq + nk].view(1, Hkv, 128),
                                r[:, nq + nk:].view(1, Hkv, 128), kc, vc,
                                i % L, pos, rope=row)
        turns = in_turns(("k8", "k1+k2"), 2, lambda r: cuda_ms(
            k8 if r == "k8" else k1k2, K8_TIME_ITERS)[0])
        p_ms, _ = cuda_ms(lambda i: ab.attn_block_plain(
            x, thr, *ws, i % L, cap, nrm, cfg.norm_eps, kc, vc, pos, row,
            n_heads=Hq, G=G), 5, warmup=1, queued=False)
        b_ms, b_by, nbytes = k8_bound(K, G, cap, Hq, Hkv, p, 2,
                                      kind == "int4")
        ms = min(turns["k8"])
        rows.append(dict(case=f"{tag} pos={p} T={T}", G=G, cap=cap, pos=p,
                         ms=ms, k8_turns=turns["k8"],
                         k1_k2_turns=turns["k1+k2"], plain_ms=p_ms,
                         bound_ms=b_ms, bound_by=b_by, mbytes=nbytes / 1e6))
        log(f"[time] K8 {tag} pos={p} (T={T}, cap {cap}): kernel "
            f"{[round(t, 4) for t in turns['k8']]} ms in turns with K1 + K2 "
            f"{[round(t, 4) for t in turns['k1+k2']]} ms; plain {p_ms:.4f} "
            f"ms; bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB, "
            f"{b_ms / ms:.1%} of it); worst row {ratio:.2e}")
        del kc, vc
        torch.cuda.empty_cache()
    del int4
    main = rows[0]
    n8, steps = launches["loop"]
    return dict(name="attn_block", route="cuda",
                source="teal_tpu_torch/csrc/attn_block.cu",
                replaces="teal_tpu/ops/attn_block.py:605", launches=n8,
                launches_per_token=n8 / steps,
                launches_path_b=launches.get("B"), on_main_path=False,
                max_abs_err=worst, ms=main["ms"], kernel_ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None,
                timed=f"7B bf16 G=128 cap {main['cap']} pos 511 (T 512), "
                      "zero thresholds", cases=rows)


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
    """Set the launch counts of K1-K6, K7 and K8 to 0."""
    from teal_tpu_torch.ops.attn_block import attn_block
    from teal_tpu_torch.ops.token_block import token_kernel

    for f in _wrappers():
        f.launches = 0
    token_kernel.launches = 0
    attn_block.launches = 0


def k7_launches() -> int:
    """K7's launch count (phases 14 and 18 read it beside K1-K6's)."""
    from teal_tpu_torch.ops.token_block import token_kernel

    return token_kernel.launches


def k8_launches() -> int:
    """K8's launch count (the one-row attention stage, read beside
    K1-K6's wherever the one-row loop runs)."""
    from teal_tpu_torch.ops.attn_block import attn_block

    return attn_block.launches


def read_launches():
    """Launch counts (K1, K2, K3, K4, K5, K6)."""
    return tuple(f.launches for f in _wrappers())


def check_launches(counts, L: int, decoded: int, long_prefills: int = 0,
                   n8: int = None):
    """The one-row loop's launch counts (K1, K2, K3, K4, K5, K6) and K8's
    (`n8`, by default read now) after `decoded` decode steps and prefills
    of which `long_prefills` had 256 or more tokens: L K8 and 3*L K1 a
    token (`LOOP_ROW`), L K6 a long prefill (none for a short one), no
    other kernel."""
    n8 = k8_launches() if n8 is None else n8
    want = tuple(n * L * decoded for n in LOOP_ROW[:5]) + (
        L * long_prefills,)
    check(tuple(counts) == want and n8 == L * decoded,
          f"launches (K1, K2, K3, K4, K5, K6) {tuple(counts)} and {n8} K8, "
          f"expected {want} and {L * decoded} for {decoded} decoded tokens "
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
    sparse = Generator(cfg, params, sp=SparsityConfig(**LOOP_SP),
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
    sparse.generate(prompts[0], 4, thresholds=th,
                    on_device_loop=False)                   # warm-up
    dense.generate(prompts[0], 4, on_device_loop=False)
    reset_launches()
    outs = [sparse.generate(p, NEW_TOKENS, thresholds=th,
                            on_device_loop=False) for p in prompts]
    k1, k2, *_ = counts = read_launches()
    k8 = k8_launches()
    decoded = len(prompts) * (NEW_TOKENS - 1)
    check_launches(counts, L, decoded, n8=k8)  # short prompts: no K6
    log(f"[e2e] main path: {len(prompts)} requests, {decoded} decoded "
        f"tokens, K8 launches {k8} ({k8 // max(decoded, 1)}/token), "
        f"K1 launches {k1} ({k1 // max(decoded, 1)}/token), "
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
                          pos, th, cfg=cfg, sp=SparsityConfig(**LOOP_SP),
                          rope=sparse.rope)
    check(tuple(lg.shape) == (1, 1, cfg.vocab_size)
          and bool(torch.isfinite(lg).all()), "sparse logits not finite")

    # decode speed, in turns: dense, sparse, sparse, dense
    speeds = {"dense": [], "sparse": []}
    for kind in ("dense", "sparse", "sparse", "dense"):
        g = dense if kind == "dense" else sparse
        _, st = g.generate(prompts[2], 32,
                           thresholds=None if kind == "dense" else th,
                           on_device_loop=False)
        speeds[kind].append(st.tokens_per_s)
    return (k1, k2, k8, decoded), speeds, th


PROFILE_TRIES = 3                # torch.profiler sessions a reading


def profile_device(fn, iters: int):
    """Device time of fn() per call from torch.profiler: (the sum of the
    kernel times in ms, [(kernel, ms)] largest first). Kernel events only:
    an operator's event, and the span the profiler draws on the device
    for an annotated operator (e.g. "aten::mm"), repeat the device time
    of the kernels inside them. On this card the profiler now and then
    records no kernel at all in a session: the reading is then taken
    again, up to `PROFILE_TRIES` sessions; after that the device time
    comes from CUDA events around the `iters` calls (a span that includes
    any host gaps between launches: an upper bound), as one row named so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = sorted(((e.key, e.self_device_time_total / 1e3 / iters)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)
                       and e.self_device_time_total > 0),
                      key=lambda r: -r[1])
        if rows:
            return sum(t for _, t in rows), rows
        log("[time] torch.profiler recorded no kernel of the call; "
            "profiling it again")
    dev, _ = cuda_ms(lambda i: fn(), iters, warmup=0, queued=False)
    log(f"[time] no kernel recorded in {PROFILE_TRIES} profiler sessions: "
        f"device {dev:.3f} ms a call from CUDA events around the calls "
        "(host gaps included)")
    return dev, [("cuda events around the calls (no profiler record)", dev)]


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
        k7 = sum(t for k, t in rows if "token_kernel" in k
                 or "token_rows_kernel" in k)
        out[kind] = dict(device_ms=dev, wall_ms=wall,
                         idle_share=max(0.0, 1.0 - dev / wall), k2_ms=k2,
                         k1_ms=k1, k3_ms=k3, k4_ms=k4, k5_ms=k5, k7_ms=k7)
        log(f"[time] one {kind} decode step (batch {b}): device "
            f"{dev:.3f} ms (sum of kernel times), wall {wall:.3f} ms, "
            f"device idle {out[kind]['idle_share']:.1%}; K1 {k1:.3f} ms, "
            f"K2 {k2:.3f} ms ({k2 / dev:.1%} of device), K3 {k3:.3f} ms, "
            f"K4 {k4:.3f} ms, K5 {k5:.3f} ms, K7 {k7:.3f} ms; top: "
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
    kernel of the port. K8's is `attn_block_plain`, whose q|k|v call is
    `k1` too."""
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
             (attn_block, "attn_block", attn_block.attn_block_plain),
             (attn_block, "select_gather_gemv_plain", k1),
             (token_block, "select_gather_gemv", k1),
             (bg, "block_gather_gemv_multi",
              bg.block_gather_gemv_multi_plain),
             (gg, "row_gather_gemv", gg.row_gather_gemv_plain),
             (llama, "decode_attention", da.decode_attention_plain),
             (attn_block, "decode_attention", da.decode_attention_plain),
             (tp_kernel, "decode_attention", da.decode_attention_plain),
             (token_block, "moe_route", token_block.moe_route_plain),
             (token_block, "token_kernel", token_block.token_kernel_plain),
             (llama, "flash_prefill_attention",
              fp.flash_prefill_attention_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    before = read_launches(), k7_launches(), k8_launches()
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    check((read_launches(), k7_launches(), k8_launches()) == before,
          "the plain path launched a kernel")


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


def loop_thresholds(caps, rule: str, th_row, stage: int,
                    block_size: int = 32):
    """Set the threshold columns of stage `stage` (q|k|v, o, gate|up, down)
    from its captured input: "group" picks a group threshold at the
    stage's group size (the effective one of `block_size`) and capacity
    (`pick_threshold`), "elem" the median |x|."""
    from teal_tpu_torch.ops.block_gemv import (block_capacity,
                                               effective_block_size,
                                               group_scores)

    grp, name, cols = (("self_attn", "h1", (0, 1, 2)),
                       ("self_attn", "h2", (3,)), ("mlp", "h1", (4, 5)),
                       ("mlp", "h2", (6,)))[stage]
    x = caps[grp][name].float().reshape(-1)
    if rule == "group":
        G = effective_block_size(block_size, x.numel())
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

    rule = {"B": "group", "C": "elem", "Q8-main": "group"}.get(name)
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
                loop_thresholds(caps, rule, th[i], stage, sp.block_size)
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


def loop_paths(params, cfg, device, seed, rope, paths=None, launches=None,
               k7=None, k8=None):
    """Phase 6 for every path of `paths` (name: (SparsityConfig kwargs,
    batch); `LOOP_PATHS` by default), each held layer by layer on the
    token path or the layer loop, as `forward` routes it, with the launch
    counts per layer and step of `launches`, the K7 launches per step of
    `k7` and the K8 launches per layer and step of `k8` (`LOOP_K8` by
    default; none where a path is absent). Returns {path: results}."""
    import numpy as np

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine import Generator
    from teal_tpu_torch.models import llama

    paths = paths or LOOP_PATHS
    launches = launches or LOOP_LAUNCHES
    k7 = k7 or {}
    k8 = LOOP_K8 if k8 is None else k8
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
        gen.generate(prompts[0], 3, thresholds=th,
                     on_device_loop=False)                  # warm-up
        reset_launches()
        outs = [gen.generate(p, LOOP_NEW_TOKENS, thresholds=th,
                             on_device_loop=False) for p in prompts]
        counts, n7, n8 = read_launches(), k7_launches(), k8_launches()
        steps = len(prompts) * (LOOP_NEW_TOKENS - 1)
        want = tuple(n * L * steps for n in launches[name])
        want8 = k8.get(name, 0) * L * steps
        check(counts == want and n7 == k7.get(name, 0) * steps
              and n8 == want8,
              f"path {name}: launches (K1, K2, K3, K4, K5, K6) {counts}, "
              f"{n7} K7 and {n8} K8, expected {want}, "
              f"{k7.get(name, 0) * steps} and {want8} for {steps} decode "
              "steps")
        for p, (toks, st) in zip(prompts, outs):
            check(toks.shape == (b, p.shape[1] + LOOP_NEW_TOKENS)
                  and bool((toks >= 0).all() and (toks < cfg.vocab_size)
                           .all()), f"path {name}: bad tokens {toks.shape}")
        log(f"[loop] path {name}: {len(prompts)} requests, {steps} decode "
            f"steps, launches per step (K1, K2, K3, K4, K5, K6) "
            f"{tuple(c // steps for c in counts)}, K7 {n7 // steps} and K8 "
            f"{n8 // steps}; tok/s "
            + ", ".join(f"{st.tokens_per_s * b:.2f}" for _, st in outs)
            + f"; first request's new tokens "
            f"{outs[0][0][0, prompts[0].shape[1]:].tolist()}")
        del gen
        graph = graph_route(f"path {name}", cfg, params, sp_kw, b, th, device,
                            prompts, launches[name], seed,
                            n_new=LOOP_NEW_TOKENS,
                            k7_per_step=k7.get(name, 0),
                            k8_per_step=k8.get(name, 0) * L)
        out[name] = dict(th=th, worst=worst, launches=counts, steps=steps,
                         k7_launches=n7, k8_launches=n8,
                         tok_s=[st.tokens_per_s * b for _, st in outs],
                         graph=graph)
    return out


# --- phase 7: kernel times ------------------------------------------------

def time_kernels(params, cfg, caps, device, gen, rope, launches, errs):
    L = cfg.n_layers
    stages = time_k1_plan(params, params, cfg, caps, device, gen, "bf16")

    (k1n, k2n, _, decoded) = launches
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


def off_path(e, still):
    """Mark a `kernels` entry whose kernel the main path's runs no longer
    launch (its `launches`, read from those runs, are 0): it is still held
    to its plain version and timed; `still` says which option runs it."""
    e.update(on_main_path=False, still_run_by=still)
    log(f"[kernels] {e['name']}: off the main path ({e['launches']} "
        f"launches in its runs); still run by {still}")
    return e


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
    kernels and the quantized logits head; for int8 and int4 at group
    128, K7's batch-1 checks (`k7_quant`) and its rows form: the B = 16
    server step one K7 launch (`QUANT_K7`), every layer held at B = 2, 8
    and 16 (`k7_rows_holds`), the step in turns with the K1/K2 loop
    (`k7_loop_turns`), its time and bound (`k7_rows_times`), and
    `block_verify` at S = 5 and 12 through K7's seq_block form
    (`k7_quant_verify`); then free the copy. Returns (kernels entries,
    {path: results}, extra results)."""
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
                          launches=QUANT_LAUNCHES, k7=QUANT_K7,
                          k8=QUANT_K8)
        results.update(runs)
        extra.update({f"decode_step_ms {k}": v for k, v in time_decode_step(
            qp, cfg, [(n, *QUANT_PATHS[n][1:], runs[n]["th"])
                      for n in names], device, rope).items()})
        for n in names:
            r = runs[n]
            if n.endswith("-b16"):
                rows = extra.setdefault("k7_rows", {})[plan] = {}
                holds = k7_rows_holds(qp, cfg, device, gen, r["th"],
                                      fp32_cut=False, tag=f"k7 rows {plan}")
                rows["holds"] = {str(k): dict(worst=v[0], max_abs_err=v[1],
                                              flips=v[2])
                                 for k, v in holds.items()}
                rows["turns"] = k7_loop_turns(qp, cfg, device, gen, r["th"])
                e7 = k7_rows_times(qp, cfg, device, gen, r["th"])
                e7.update(launches=r["k7_launches"], steps=r["steps"],
                          max_abs_err=max(v[1] for v in holds.values()),
                          turns=rows["turns"]["turns"])
                entries.append(e7)
                rows["verify"] = k7_quant_verify(qp, cfg, device, seed, rope,
                                                 plan)
                # K1's rows form: its launches in the main path's run
                entries.append(off_path(time_rows_kernels(
                    qp, params, cfg, caps, device, gen, rope, plan,
                    r["launches"][0], r["steps"], errs["rows"]),
                    "token_fused=False: a B = 16 step's 4 L launches"))
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
            main = next(n for n in names if n.endswith("-main"))
            e7, extra.setdefault("k7", {})[plan] = k7_quant(
                qp, cfg, device, gen, seed, runs[main]["th"], plan)
            entries.append(e7)
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
    positions): at B = 1 with `LOOP_SP` exactly L K8 and 3*L K1 launches,
    at B > 1 with `MAIN_SP` one K7 launch (its rows form), no other port
    kernel; finite logits of the expected shape. Then B = 16 with
    token_fused=False (the model's layer loop): its launch counts, read.
    Returns them."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama

    L = cfg.n_layers

    def step(b, sp):
        cache = llama.KVCache.init(cfg, b, MAX_SEQ, torch.bfloat16, device)
        reset_launches()
        lg, _ = llama.forward(params, torch.full((b, 1), 7, device=device),
                              cache, row_positions(b), th, cfg=cfg,
                              sp=SparsityConfig(**sp), rope=rope)
        check(tuple(lg.shape) == (b, 1, cfg.vocab_size)
              and bool(torch.isfinite(lg).all()), f"batch {b}: bad logits")
        return read_launches(), k7_launches(), k8_launches()

    row = tuple(n * L for n in LOOP_ROW)
    for b in STEP_BATCHES:
        got = step(b, LOOP_SP if b == 1 else MAIN_SP)
        want = (row, 0, L) if b == 1 else ((0,) * 6, 1, 0)
        check(got == want, f"batch {b}: launches ((K1, K2, K3, K4, K5, K6), "
              f"K7, K8) {got} in one decode step, expected {want}")
    loop = step(16, LOOP_SP)
    log(f"[serve] one decode step at batch {STEP_BATCHES}: launches (K1, "
        f"K2, K3, K4, K5, K6) = {row} and {L} K8 at batch 1 "
        f"(token_fused=False), one K7 and nothing else at batch > 1; batch "
        f"16 with token_fused=False (the layer loop): {loop}")
    return loop[0]


def server_phase(params, cfg, device, seed, rope):
    """The continuous-batching server at 7B: `SERVER_SLOTS` slots,
    `SERVER_REQUESTS` greedy requests (prompts of 5-120 tokens, 8-16 new
    tokens), so that requests join as slots free up. Thresholds are picked
    on the plain path over the first 16 admitted requests' first decode
    step, every layer of which is held to the plain path at B = 16. Then
    the workload runs with one-shot admission and with
    `prefill_chunk=SERVER_CHUNK`, launch counts reset just before and read
    just after: one K7 launch (its rows form) per decode step, nothing
    else. Returns (thresholds, results)."""
    import numpy as np
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine import ContinuousBatchingEngine

    rng = np.random.default_rng(seed + 4)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(SERVER_PROMPT[0], SERVER_PROMPT[1] + 1,
                                     SERVER_REQUESTS)]
    new = [int(n) for n in rng.integers(8, 17, SERVER_REQUESTS)]

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
    loop_step = check_step_launches(params, cfg, th, device, rope)

    out = {"worst": worst, "admitted_step": admitted,
           "loop_step_launches": loop_step}
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
        got, n7 = read_launches(), k7_launches()
        steps = len(decode)
        # prompts of at most 120 tokens: no K6 in one-shot admission
        check(got == (0,) * 6 and n7 == steps, f"server (chunk {chunk}): "
              f"launches (K1, K2, K3, K4, K5, K6) {got} and {n7} K7, "
              f"expected none and {steps} for {steps} decode steps")
        check(len(done) == SERVER_REQUESTS and all(
            len(r.out) == n and all(0 <= t < cfg.vocab_size for t in r.out)
            for r, n in zip(sorted(done, key=lambda r: r.id), new)),
            f"server (chunk {chunk}): requests unfinished or bad tokens")
        toks = sum(n for n, _ in decode)
        dec_s = sum(t for _, t in decode)
        key = "oneshot" if chunk is None else f"chunk{chunk}"
        out[key] = dict(
            steps=steps, launches=got, k7_launches=n7, wall_s=wall,
            decode_tokens=toks,
            decode_s=dec_s, decode_tok_s=toks / dec_s,
            step_ms_full=1e3 * float(np.mean([t for n, t in decode
                                               if n == SERVER_SLOTS] or [0])),
            steps_full=sum(n == SERVER_SLOTS for n, _ in decode),
            outs=[r.out for r in sorted(done, key=lambda r: r.id)])
        log(f"[serve] {key}: {SERVER_REQUESTS} requests in {wall:.2f} s, "
            f"{steps} decode steps ({n7} K7 launches: one a step, no K1-K6),"
            f" {toks} decoded "
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
    scale) on the K1/K2 loop (`hold_token_layers(verify=True)`) and
    through K7's seq_block form (`k7_verify_holds`), ceil(S/8) K7
    launches and none of K1-K6, finite logits. The
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
        sizes = chunk_sizes(S)
        n_chunks = len(sizes)
        kv, off, worst = cache, 0, 0.0
        for ss in sizes:                 # each chunk on the plain cache
            _, w, kv = hold_token_layers(
                params, cfg, llama.KVCache(*kv), toks[0, off:off + ss],
                list(range(pos + off, pos + off + ss)), rope, device,
                verify=True)
            worst, off = max(worst, w), off + ss
        k7_worst, k7_err = k7_verify_holds(params, cfg, cache, toks[0], pos,
                                           rope, device,
                                           tag=f"[k7 verify bf16 S={S}]")
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
            runs[kind] = (lg, time.perf_counter() - t0, read_launches(),
                          k7_launches())
        lg, wall, got, n7 = runs["kernel"]
        check(got == (0,) * 6 and n7 == n_chunks, f"block_verify S={S}: "
              f"launches (K1, K2, K3, K4, K5, K6) {got} and {n7} K7, "
              f"expected none and {n_chunks}")
        check(tuple(lg.shape) == (1, S, cfg.vocab_size)
              and bool(torch.isfinite(lg).all()), f"S={S}: bad logits")
        rel = {k: float((lg - runs[k][0]).abs().max()
                        / runs[k][0].abs().max()) for k in ("plain", "dense")}
        out[S] = dict(launches=got, k7_launches=n7, worst=worst,
                      k7_worst=k7_worst, k7_max_abs_err=k7_err,
                      wall_ms=wall * 1e3,
                      dense_wall_ms=runs["dense"][1] * 1e3,
                      bf16_err_dense=rel["dense"],
                      bf16_err_plain=rel["plain"])
        log(f"[verify] S={S} ({n_chunks} chunk(s) {sizes}): every layer held "
            f"to the plain version on the K1/K2 loop (worst {worst:.2e} of "
            f"scale) and through K7 (worst {k7_worst:.2e}); launches (K1, K2, "
            f"K3, K4, K5, K6) {got} and {n7} K7; bf16 logits after {L} layers "
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
    """The kept count of every stage in one server decode step at batch b
    (the step `time_decode_step` times: token 7 at positions 40, 44, ...
    on an empty cache, the server's thresholds), read from K7's `sel`.
    Returns [L, 4] counts (qkv, o, gate|up, down)."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import token_block

    caps = llama.token_path_caps(cfg, SparsityConfig(**MAIN_SP))
    sel = torch.zeros((cfg.n_layers, 4, 1 + max(caps)), dtype=torch.int32,
                      device=device)
    real = token_block.token_kernel

    def recording(*args, **kw):
        return real(*args, sel=sel, **kw)
    recording.launches = 0       # the wrapper counts into the module's name

    cache = llama.KVCache.init(cfg, b, MAX_SEQ, torch.bfloat16, device)
    try:
        token_block.token_kernel = recording
        llama.forward(params, torch.full((b, 1), 7, device=device), cache,
                      row_positions(b), th, cfg=cfg,
                      sp=SparsityConfig(**MAIN_SP), rope=rope)
    finally:
        token_block.token_kernel = real
    kept = sel[:, :, 0].cpu()
    for j, name in enumerate(STAGES):
        c = kept[:, j].float()
        log(f"[serve] kept groups in one batch-{b} decode step, {name}: "
            f"mean {float(c.mean()):.2f} (min {int(c.min())}, max "
            f"{int(c.max())}) of cap {caps[j]}, {float(c.mean()) / caps[j]:.1%}")
    return kept


def in_turns(routes, turns: int, reading):
    """`turns` readings of each route, taken in turns (the order reversed
    every other turn, so that neither route always runs first): {route:
    [reading(route), ...]}."""
    out = {r: [] for r in routes}
    for i in range(turns):
        for r in (routes if i % 2 == 0 else routes[::-1]):
            out[r].append(reading(r))
    return out


def server_turns(params, cfg, th, device, rope, b: int = 16):
    """The server's B-row decode step (token 7 at `row_positions` on an
    empty cache) through K7's rows form (`MAIN_SP`) and with
    token_fused=False (`LOOP_SP`: the model's layer loop) in turns,
    `K7_ROWS_TURNS` times each: device ms, wall ms, idle share and tok/s
    from the wall time. Returns {route: [readings]}."""
    sps = {"k7": MAIN_SP, "token_fused=False": LOOP_SP}

    def reading(name):
        kind = f"server batch {b}, {name}"
        r = time_decode_step(params, cfg, [(kind, sps[name], b, th,
                                            row_positions(b))],
                             device, rope)[kind]
        r["tok_s"] = b / r["wall_ms"] * 1e3
        return r
    out = in_turns(tuple(sps), K7_ROWS_TURNS, reading)
    for name, rs in out.items():
        log(f"[serve] batch-{b} step, {name}, in turns: device "
            f"{[round(r['device_ms'], 3) for r in rs]} ms, wall "
            f"{[round(r['wall_ms'], 3) for r in rs]} ms, idle "
            f"{[round(r['idle_share'], 4) for r in rs]}, tok/s "
            f"{[round(r['tok_s'], 1) for r in rs]}")
    return out


def batched_phase(params, cfg, caps, device, gen, seed, rope):
    """Phase 9 on the bf16 params, with phase 19 (K7's rows form: its
    plan, every 7B layer held at B = 2, 8 and 16 and an fp32 cut, its
    times) after the server picked its thresholds. Returns (kernels
    entries, results, thresholds)."""
    t0 = time.perf_counter()
    e_k1 = check_k1_rows(params, cfg, caps, device, gen)
    e_k2 = check_k2_rows(cfg, device, gen, rope)
    th, serve = server_phase(params, cfg, device, seed, rope)
    rows_plans = check_k7_rows_plan()
    holds = k7_rows_holds(params, cfg, device, gen, th)
    e_k7 = k7_rows_times(params, cfg, device, gen, th)
    one = serve["oneshot"]
    e_k7.update(launches=one["k7_launches"], steps=one["steps"],
                max_abs_err=max(v[1] for v in holds.values()))
    verify = verify_phase(params, cfg, device, seed, rope)
    steps = time_decode_step(
        params, cfg, [(f"server batch {b}",
                       LOOP_SP if b == 1 else MAIN_SP, b, th,
                       row_positions(b)) for b in STEP_BATCHES],
        device, rope)
    for b in STEP_BATCHES:
        r = steps[f"server batch {b}"]
        log(f"[serve] decode step at batch {b}: {b / r['wall_ms'] * 1e3:.1f} "
            f"tok/s from its wall time ({r['wall_ms']:.3f} ms wall, "
            f"{r['device_ms']:.3f} ms device, idle {r['idle_share']:.1%})")
    turns = server_turns(params, cfg, th, device, rope)
    kept = step_kept_counts(params, cfg, th, device, rope)
    v_steps = sum(-(-S // 8) for S in VERIFY_S)
    v_k7 = sum(r["k7_launches"] for r in verify.values())
    # the verify chunk (S = 8) through K7 and through the K1/K2 loop, in
    # turns
    v_turns = k7_loop_turns(params, cfg, device, gen, th, B=K7_VERIFY_S,
                            seq=True)
    loop_step = serve["loop_step_launches"]
    # K1's rows form and K2's seq_block form: their launches in the main
    # path's runs (the server's steps and the verify chunks, which take K7)
    main_k1 = one["launches"][0] + sum(r["launches"][0]
                                       for r in verify.values())
    main_seq = sum(r["launches"][1] for r in verify.values())
    entries = [
        off_path(time_rows_kernels(params, params, cfg, caps, device, gen,
                                   rope, "bf16", main_k1,
                                   one["steps"] + v_steps, e_k1),
                 "token_fused=False: a verify chunk's 4 L launches"),
        time_k2_rows(cfg, device, gen, rope, loop_step[1], 1, e_k2, "B=16"),
        off_path(time_k2_rows(cfg, device, gen, rope, main_seq, v_steps,
                              e_k2, "seq_block"),
                 "token_fused=False: a verify chunk's L launches"),
        e_k7,
        k7_seq_times(params, cfg, device, gen, v_k7, v_steps,
                     max(r["k7_max_abs_err"] for r in verify.values())),
    ]
    entries[-1]["turns"] = v_turns["turns"]
    results = dict(
        server={k: ({kk: vv for kk, vv in v.items() if kk != "outs"}
                    if isinstance(v, dict) else v) for k, v in serve.items()},
        verify=verify, verify_turns=v_turns, decode_step_ms=steps,
        server_turns=turns,
        step_kept_b16={name: kept[:, j].tolist()
                       for j, name in enumerate(STAGES)},
        k7_rows=dict(plans=rows_plans,
                     holds={str(k): dict(worst=v[0], max_abs_err=v[1],
                                         flips=v[2])
                            for k, v in holds.items()}),
        phase_s=time.perf_counter() - t0)
    log(f"[serve] phases 9 and 19 in {results['phase_s']:.1f} s")
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
    gen = Generator(cfg, params, sp=SparsityConfig(**LOOP_SP), max_seq=T,
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

    gen.generate(prompt[:300], 2, thresholds=th,
                 on_device_loop=False)                      # warm-up
    reset_launches()
    toks, st = gen.generate(prompt, LONG_NEW_TOKENS, thresholds=th,
                            on_device_loop=False)
    counts = read_launches()
    decoded = LONG_NEW_TOKENS - 1
    check_launches(counts, L, decoded, long_prefills=1)
    check(toks.shape == (1, LONG_PROMPT + LONG_NEW_TOKENS)
          and bool((toks >= 0).all() and (toks < cfg.vocab_size).all()),
          f"bad tokens {toks.shape}")
    log(f"[long] {LONG_PROMPT}-token prompt (padded to {T}), "
        f"{LONG_NEW_TOKENS} greedy tokens: launches (K1, K2, K3, K4, K5, K6) "
        f"{counts} and K8 {k8_launches()}; prefill {st.prefill_s:.4f} s (time to first token), "
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
    step = time_decode_step(params, cfg, [(f"pos {LONG_PROMPT}", LOOP_SP, 1,
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


def calib_decode(params, cfg, th, device, seed, what, shares=None,
                 k7: bool = False):
    """Hold every layer of one main-path decode step (the first prompt's
    next token after a dense prefill) at thresholds `th` [L, 7] to the
    plain path (`hold_token_layers`), then decode phase 4's three prompts
    on the one-row loop (`LOOP_SP`) with them, counts set to 0 just
    before: L K8 and 3*L K1 a decoded token. With `k7`, the user's route instead
    (`MAIN_SP`: K7): every layer of K7 alone held to the plain layer
    (`hold_k7_layers`), one K7 and no K1-K6 launch a decoded token.
    Returns (worst hold error, tok/s per prompt)."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine import Generator
    from teal_tpu_torch.models import llama

    dt = llama.compute_dtype(params)
    gen = Generator(cfg, params, sp=SparsityConfig(**(MAIN_SP if k7
                                                       else LOOP_SP)),
                    max_seq=MAX_SEQ, cache_dtype=dt, temperature=0.0,
                    device=device)
    prompts = main_prompts(cfg, seed)
    cache, tok, pos = calibration_token(params, cfg, prompts[0],
                                        gen.new_cache(), gen.rope, device)
    if k7:
        worst, _, _ = hold_k7_layers(params, cfg, cache, tok, pos, gen.rope,
                                     th, device, tag=f"[calib] {what}:")
    else:
        _, worst, _ = hold_token_layers(params, cfg, cache, tok, pos,
                                        gen.rope, device, th=th,
                                        shares=shares)
    gen.generate(prompts[0], 4, thresholds=th,
                 on_device_loop=False)                      # warm-up
    reset_launches()
    outs = [gen.generate(p, NEW_TOKENS, thresholds=th, on_device_loop=False)
            for p in prompts]
    decoded = len(prompts) * (NEW_TOKENS - 1)
    if k7:
        got, n7 = read_launches(), k7_launches()
        check(got == (0,) * 6 and n7 == decoded, f"{what}: launches (K1-K6) "
              f"{got} and {n7} K7 for {decoded} decoded tokens, expected "
              f"none and {decoded}")
    else:
        check_launches(read_launches(), cfg.n_layers, decoded)
    for p, (toks, _) in zip(prompts, outs):
        check(toks.shape == (1, len(p) + NEW_TOKENS)
              and bool((toks >= 0).all() and (toks < cfg.vocab_size).all()),
              f"{what}: bad tokens {toks.shape}")
    tok_s = [st.tokens_per_s for _, st in outs]
    log(f"[calib] {what}: every layer of a decode step held to the plain "
        f"path (worst error {worst:.2e} of scale, tolerance 2e-2); "
        f"{len(prompts)} requests, {decoded} decoded tokens, "
        + ("one K7 launch a token; " if k7 else
           f"{cfg.n_layers} K8 + {3 * cfg.n_layers} K1 launches a token; ")
        + f"tok/s {', '.join(f'{t:.2f}' for t in tok_s)}")
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
                                "GPTQ Q4-main decode (cut)", k7=True)
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
    """L K8 and 3*L K1 a live draft step (the one-row loop), one K7 a
    verify chunk (k + 1 <= 8 positions: one chunk a round, K7's seq_block
    form), no other kernel."""
    want = tuple(n * L * live for n in LOOP_ROW)
    n7, n8 = k7_launches(), k8_launches()
    check(tuple(got) == want and n7 == rounds and n8 == L * live,
          f"{what}: launches (K1, K2, K3, K4, K5, K6) {tuple(got)}, {n7} K7 "
          f"and {n8} K8, expected {want}, {rounds} and {L * live} for "
          f"{live} draft steps and {rounds} verifies")


def spec_run(params, cfg, prompt, n, device, th, seed, draft=LOOP_SP,
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


def spec_round_kernels(L: int, k_eff) -> tuple:
    """K1-K6 launches of one self-speculative round of the 7B's main-path
    draft at depth k_eff (None: `SPEC_K`): k_eff draft steps, L K8 + 3L K1
    each (`LOOP_ROW`; the verify chunk is one K7 launch)."""
    d = SPEC_K if k_eff is None else k_eff
    return tuple(d * n * L for n in LOOP_ROW)


@contextlib.contextmanager
def timed_rounds(rec, count=None):
    """Time each speculative round on the host clock; each ends in the
    round's one read of its tokens and n_valid, which waits for the card.
    rec["host"]: the host loop's rounds (the round called from Python,
    `speculative._Rounds.round(replay=False)`); rec["replay"]: the device
    loop's replayed rounds; rec["capture"]: (k_eff, seconds) of the rounds
    that captured their depth's graph first. With count = (what, L), each
    captured graph's K1-K6 kernel nodes, read after its round, must equal
    `spec_round_kernels(L, k_eff)` (`graph_counts`; rec["counts"][k_eff]),
    its K7 nodes 1 (the verify chunk, `k7_nodes`) and its K8 nodes k_eff x
    L (`k8_nodes`)."""
    from teal_tpu_torch.engine import speculative as spec

    orig_round = spec._Rounds.round
    for key in ("host", "replay", "capture"):
        rec.setdefault(key, [])

    def round_(self, k_eff, replay=True):
        graphed = replay and self.token.device.type == "cuda"
        new = graphed and k_eff not in self.graphs
        t0 = time.perf_counter()
        out = orig_round(self, k_eff, replay)
        dt = time.perf_counter() - t0
        if not graphed:
            rec["host"].append(dt)
        elif new:
            rec["capture"].append((k_eff, dt))
            if count is not None:
                rec.setdefault("counts", {})[k_eff] = graph_counts(
                    self.graphs[k_eff], f"{count[0]} depth {k_eff}",
                    spec_round_kernels(count[1], k_eff))[0]
                n7 = k7_nodes(self.graphs[k_eff])
                check(n7 == 1, f"graph {count[0]} depth {k_eff}: {n7} K7 "
                      "kernel nodes, expected 1 (the verify chunk)")
                n8 = k8_nodes(self.graphs[k_eff])
                d = SPEC_K if k_eff is None else k_eff
                check(n8 == d * count[1], f"graph {count[0]} depth "
                      f"{k_eff}: {n8} K8 kernel nodes, expected "
                      f"{d * count[1]} (the draft steps)")
        else:
            rec["replay"].append(dt)
        return out

    spec._Rounds.round = round_
    try:
        yield rec
    finally:
        spec._Rounds.round = orig_round


def spec_graph_runs(params, cfg, device, seed, th, prompt):
    """Phase 13's round graphs (`device_loop=True`) against the host round
    loop on `prompt` at temperature 0, at temperature 1 from one seed and
    at forced_alpha 0.9, in turns (host, graph, graph, host): the same
    tokens, new_tokens, mean_accepted and rounds in every run; the
    wrappers' launches of a graph run are its warm-up round and its
    capture, 2 x (k x (L K8 + 3L K1) + one K7); the round's graph holds k x
    (L K8 + 3L K1) kernel nodes and one K7 node, what one replay launches
    (`timed_rounds`' count). t_round of both loops (the graph's replayed
    rounds only; its capture apart). Returns the results."""
    import numpy as np

    L = cfg.n_layers
    per_round = spec_round_kernels(L, None)
    out = {}
    for what, kw in (("temperature 0", {}),
                     ("temperature 1", dict(temperature=1.0)),
                     ("forced_alpha 0.9", dict(forced_alpha=0.9))):
        runs, rec = [], {}
        for dl in (False, True, True, False):
            reset_launches()
            with timed_rounds(rec, (f"spec {what}", L)):
                toks, st, wall = spec_run(params, cfg, prompt,
                                          SPEC_NEW_TOKENS, device, th, seed,
                                          device_loop=dl, **kw)
            got, n7, n8 = read_launches(), k7_launches(), k8_launches()
            rounds = st["rounds"] if dl else len(st["accepted_per_step"])
            if dl:
                check(got == tuple(2 * n for n in per_round) and n7 == 2
                      and n8 == 2 * SPEC_K * L,
                      f"spec graph {what}: launches {got}, {n7} K7 and {n8} "
                      f"K8 at the capture, expected "
                      f"{tuple(2 * n for n in per_round)}, 2 and "
                      f"{2 * SPEC_K * L}")
            runs.append((toks, st["new_tokens"], st["mean_accepted"],
                         rounds))
        for r in runs[1:]:
            check(np.array_equal(r[0], runs[0][0]) and r[1:] == runs[0][1:],
                  f"spec graph {what}: the graph loop's tokens or stats "
                  f"{r[1:]} differ from the host loop's {runs[0][1:]}")
        host_ms = 1e3 * float(np.mean(rec["host"]))
        graph_ms = 1e3 * float(np.mean(rec["replay"]))
        cap_ms = 1e3 * float(np.mean([t for _, t in rec["capture"]]))
        res = dict(rounds=runs[0][3], mean_accepted=runs[0][2],
                   t_round_host_ms=host_ms, t_round_graph_ms=graph_ms,
                   first_round_capture_ms=cap_ms,
                   graph_kernel_nodes=rec["counts"][None])
        out[what] = res
        log(f"[spec] device_loop=True, {what} (prompt {len(prompt)}): the "
            f"host loop's tokens and stats ({runs[0][3]} rounds, mean "
            f"accepted {runs[0][2]:.3f}); t_round host {host_ms:.2f} ms, "
            f"graph {graph_ms:.2f} ms (replays; a capture round "
            f"{cap_ms:.1f} ms); the graph's (K1, K2, K3, K4, K5, K6) "
            f"kernel nodes {res['graph_kernel_nodes']}")
    return out


def speculative_phase(params, cfg, device, seed, th, speeds):
    """Phase 13 on the resident bf16 7B at phase 4's thresholds `th`:
    self-speculation with a shared cache (k = `SPEC_K`; the draft the
    main-path config, the dense verify through `block_verify`):
      1. phase 4's three prompts, `SPEC_NEW_TOKENS` new tokens each, and
         the third again with the draft at keep 1.0 and zero thresholds
         (whose proposals the verify accepts; at least one must be), at
         temperature 0 with every verify recorded (`recording_verify`):
         per round L K8 + 3*L K1 a draft step and one K7 a verify chunk
         (`spec_launches`); every emitted token the argmax of its verify
         row and the cache rows of the emitted tokens the verify's
         (`check_spec_rounds`); then the same generation unrecorded and
         timed (the same tokens): t_round, tok/s, mean accepted;
      2. the first round's verify rerun on the final cache (the rows
         before it are the prefill's): the logits equal to the recorded
         ones, every layer of the chunk held to the plain path on the
         K1/K2 loop (`hold_token_layers(verify=True)`, 2e-2 of scale) and
         through K7's seq_block form (`k7_verify_holds`); the bf16
         logits beside the plain path's reported; the same verify on an
         fp32 copy of the weights and cache through the kernels held to
         the plain path within 2e-2 of scale (in bf16 the 32 random
         layers drift the logits several 1e-2 apart, phase 9);
      3. dense decode (`Generator`) and speculation on the 40-token prompt
         in turns; `forced_alpha` at `SPEC_ALPHAS` (`SPEC_ALPHA_NEW_TOKENS`
         tokens): tok/s and the realized acceptance (accepted over
         attempted draws), within 4 binomial standard deviations of alpha;
      4. `device_loop=True, adaptive_k=True`: the host loop's tokens,
         k_eff_final and alpha_hat_final; the wrappers launch each
         captured depth's round twice (warm-up and capture);
      5. the round graphs against the host round loop
         (`spec_graph_runs`).
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
    cases = [(f"prompt {len(p)}", p, LOOP_SP, th) for p in prompts]
    cases.append((f"prompt {len(prompts[2])} keep 1.0", prompts[2],
                  dict(LOOP_SP, block_keep_frac=1.0), zero))
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
            f"(K1, K2, K3, K4, K5, K6) {got} = {SPEC_K} x 3L K1 beside "
            f"{SPEC_K} x L K8 and "
            f"one K7 a round; {n_tok} emitted tokens each the argmax of its "
            "verify "
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
    k7_worst, _ = k7_verify_holds(params, cfg, base, stoks[0], pos, rope,
                                  device, tag=f"[k7 spec verify S={S}]")
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
    res.update(verify_worst=worst, verify_k7_worst=k7_worst,
               verify_bf16_rel_plain=bf16_rel,
               verify_fp32_rel_plain=fp32_rel)
    log(f"[spec] first round's verify (S = {S} at pos {pos}) rerun on the "
        f"final cache: logits equal to the recorded ones; every layer held "
        f"to the plain path on the K1/K2 loop (worst {worst:.2e} of scale, "
        f"tolerance 2e-2) and through K7 (worst {k7_worst:.2e}); "
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
                prompts[2], SPEC_NEW_TOKENS,
                on_device_loop=False)[1].tokens_per_s)
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

    # 4. the device loop with adaptive depth: each depth's round graph is
    # captured on its first round, the wrappers run each captured round
    # twice (warm-up and capture)
    reset_launches()
    with timed_rounds({}, ("spec adaptive", L)) as rec:
        toks, st, wall = spec_run(params, cfg, prompts[0], SPEC_NEW_TOKENS,
                                  device, th, seed, device_loop=True,
                                  adaptive_k=True)
    k1, k2, *rest = got = read_launches()
    n7, n8 = k7_launches(), k8_launches()
    check(np.array_equal(toks, host_toks[0]), "spec: the adaptive device "
          "loop's tokens differ from the host loop's")
    r = st["rounds"]
    depths = sorted(k for k, _ in rec["capture"])
    check(k1 == 3 * n8 and k2 == 0 and n8 == 2 * L * sum(depths)
          and not any(rest) and n7 == 2 * len(depths),
          f"spec adaptive: launches {got}, {n7} K7 and {n8} K8 for the "
          f"captures of depths {depths}")
    res["adaptive"] = dict(rounds=r, k_eff_final=st["k_eff_final"],
                           alpha_hat_final=st["alpha_hat_final"],
                           mean_accepted=st["mean_accepted"],
                           depths_captured=depths, wall_s=wall,
                           graph_kernel_nodes={str(d): c for d, c in
                                               rec["counts"].items()},
                           tok_s=st["new_tokens"] / wall, launches=got)
    log(f"[spec] device_loop + adaptive_k (prompt 5): the host loop's "
        f"tokens; {r} rounds, depths captured {depths}, k_eff_final "
        f"{st['k_eff_final']}, alpha_hat_final {st['alpha_hat_final']:.4f}, "
        f"mean accepted {st['mean_accepted']:.3f}, "
        f"{st['new_tokens'] / wall:.2f} tok/s")
    res["graph"] = spec_graph_runs(params, cfg, device, seed, th, prompts[2])
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
    (stdout, stderr, seconds, launches (K1-K6), peak GiB, K7 launches)."""
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
    got, k7 = read_launches(), k7_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[cli] {what}: {secs:.2f} s, peak {peak:.2f} GiB, launches (K1, K2, "
        f"K3, K4, K5, K6) {got}, K7 {k7}; stderr tail "
        f"{err.getvalue().strip().splitlines()[-1:]}")
    return out.getvalue(), err.getvalue(), secs, got, peak, k7


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
    --block-size 128`: the main path, one K7 launch a step, captured in
    the step's graph, with --metrics); self-speculation (`--speculate-k 4
    --self-speculate`, with --metrics and --profile: a non-empty trace
    directory; k K7 draft steps and one K7 verify chunk a round); ppl at `CLI_PPL` (K6 L a window); eval of a task file whose
    contexts pass 128 tokens (K6 L a scored sequence and L for the
    generated one's prefill); quantize --mode int4, then generate from
    its store (K1's int4 plan after the repack: the K1/K2 loop, 4*L K1 +
    L K2 a step);
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

    def run(name, argv, want=None, want_k7=0):
        out, err, secs, got, peak, k7 = cli_run(argv, name)
        if want is not None:
            check(got == want, f"cli {name}: launches {got}, expected {want}")
        if want_k7 is not None:
            check(k7 == want_k7, f"cli {name}: {k7} K7 launches, expected "
                  f"{want_k7}")
        res[name] = dict(s=secs, peak_gib=peak, launches=got, k7_launches=k7)
        return out, err, got, k7

    _, err, _, _ = run("generate dense", ["generate"] + init + gen,
                       (0, 0, 0, 0, 0, 0))
    check(gen_count(err) == CLI_NEW_TOKENS, f"cli generate dense: {err}")
    out, _, _, _ = run("calibrate", ["calibrate"] + init + [
        "--output-path", str(CLI_DIR / "calib"), "--batch",
        str(CLI_CALIB[0]), "--seq-len", str(CLI_CALIB[1]),
        "--no-layer-inputs", "--group-sizes", "128"], (0, 0, 0, 0, 0, L))
    check(all(os.path.isdir(os.path.join(hist, f"layer-{l}"))
              for l in range(L)), f"cli calibrate: no histograms in {hist}")
    # generate decodes through the step's CUDA graph: the wrappers launch
    # at the capture only (2 warm-up steps and the captured one), whatever
    # the tokens decoded; a host loop would launch a step's worth a token.
    # The bf16 model's main path is K7 (one launch a step), and so is the
    # int4 model's (packed at group 128: K7's int4 plan)
    _, err, _, _ = run("generate sparse", ["generate"] + init + gen + sparse
                       + ["--metrics", str(metrics)], (0,) * 6, 3)
    check(gen_count(err) == CLI_NEW_TOKENS, f"cli generate sparse: {err}")
    _, err, got, k7 = run("generate speculative", ["generate"] + init + gen
                          + ["--speculate-k", "4", "--self-speculate",
                             "--block-size", "128", "--metrics",
                             str(metrics), "--profile", str(prof)],
                          want_k7=None)
    # a round: 4 draft steps and one verify chunk (K7's seq_block form),
    # one K7 launch each, no K1-K6
    per_round = 4 + 1
    check(not any(got) and k7 > 0 and k7 % per_round == 0,
          f"cli speculative: launches {got}, K7 {k7}")
    check(f"{CLI_NEW_TOKENS} tokens" in err and "mean accepted" in err,
          f"cli speculative: {err}")
    check(prof.is_dir() and any(prof.iterdir()), "cli speculative: empty "
          "trace directory")
    lines = [json.loads(l) for l in metrics.read_text().splitlines()]
    check(len(lines) == 2 and lines[1]["speculate_k"] == 4,
          f"cli metrics: {lines}")
    res["generate speculative"].update(
        rounds=k7 // per_round,
        mean_accepted=lines[1]["mean_accepted"],
        trace_files=sorted(p.name for p in prof.iterdir()))
    n_tok, ctx, win = CLI_PPL
    n_win = len(list(windows(n_tok, ctx, win)))
    out, _, _, _ = run("ppl", ["ppl"] + init + [
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
    out, _, _, _ = run("eval", ["eval"] + init + ["--task-file", str(task)],
                       (0, 0, 0, 0, 0, 5 * L))
    ev = json.loads(out)
    check(sorted(ev) == ["gen", "mc"] and 0 <= ev["mc"]["acc"] <= 1,
          f"cli eval: {ev}")
    res["eval"]["results"] = ev
    q4 = str(CLI_DIR / "q4")
    run("quantize int4", ["quantize"] + init + ["--mode", "int4",
                                                "--output-path", q4],
        (0, 0, 0, 0, 0, 0))
    _, err, _, _ = run("generate int4", ["generate"] + base + [
        "--checkpoint", q4] + gen + sparse, (0,) * 6, 3)
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


K7_MOE_REPEATS = 30              # K7 MoE launches held bit-identical


def check_k7_moe_plan(cfg, wplan: int):
    """K7's MoE plan in the wrapper (`_token_plan(..., E=, k_exp=)` on the
    card's resident clusters) equal to the kernel's (`teal_token_plan` /
    `teal_token_plan_q` with E and k) at cfg's shapes, T `MAX_SEQ` and
    its max_seq_len, within shared memory. Returns the plan at
    `MAX_SEQ`."""
    import ctypes

    import torch

    from teal_tpu_torch import _build
    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import token_block as tb

    caps = llama.token_path_caps(cfg, SparsityConfig(**MAIN_SP))
    sms = _build.sm_count(0)
    GH = cfg.n_heads // cfg.n_kv_heads
    E, kx = cfg.n_experts, cfg.n_experts_per_tok
    plans = {}
    for T in (cfg.max_seq_len, MAX_SEQ):
        out = (ctypes.c_int * 11)()
        args = (cfg.dim, cfg.intermediate_size, cfg.n_heads, cfg.n_kv_heads,
                T, 0, max(caps), sms, cfg.n_layers, E, kx, out)
        rc = (_build.load()["token_decode"].teal_token_plan(1, *args)
              if wplan == 0 else
              _build.load()["token_decode_quant"].teal_token_plan_q(wplan,
                                                                    *args))
        want = tb._token_plan(2, *args[:6], max(caps), cfg.n_layers, sms,
                              tb.k7_clusters(torch.device("cuda", 0),
                                             torch.bfloat16, GH, wplan),
                              wplan, E=E, k_exp=kx)
        check(rc == 0 and want is not None and tuple(out) == tuple(want)
              and want.smem <= tb._SMEM_BYTES, f"K7 MoE plan T {T}: kernel "
              f"{rc} {list(out)}, wrapper {want}")
        plans[T] = want
    log(f"[k7 moe] plan (weight plan {wplan}) equal in the wrapper and the "
        f"kernel at T {cfg.max_seq_len} and {MAX_SEQ}: {plans[MAX_SEQ]}")
    return plans[MAX_SEQ]


def k7_moe_turns(cfg, args, kw):
    """K7's MoE form and the K1/K8/K5 loop (`token_decode(...,
    token_fused=False)`) on the same call (`args`, `kw`; the caches
    copied) in `K7_ROWS_TURNS` turns (`route_turns`: one K7 and nothing
    else; arrays: L K8, (1 + 2k) L K1, L K5; int8: (2 + 2k) L K1, L K2, L
    K5). Returns the results."""
    from teal_tpu_torch.ops import token_block as tb

    L, kx = cfg.n_layers, cfg.n_experts_per_tok
    routes = {"k7": None, "loop": False}
    cache = (args[6].clone(), args[7].clone())
    int8 = tb.k7_weight_plan(args[2]) == 1

    def call(route):
        return tb.token_decode(*args[:6], *cache, *args[8:],
                               token_fused=routes[route], **kw)
    loop = ((((2 + 2 * kx) * L, L, 0, 0, L, 0), 0, 0) if int8 else
            (((1 + 2 * kx) * L, 0, 0, 0, L, 0), 0, L))
    out, counts = route_turns(
        call, {"k7": ((0,) * 6, 1, 0), "loop": loop},
        K7_ROWS_TURNS, f"{MOE_MODEL} MoE")
    loop_name = "the K1/K2/K5 loop" if int8 else "the K1/K8/K5 loop"
    for route, rs in out.items():
        log(f"[k7 moe turns] {MOE_MODEL} {L} layers, {route} "
            f"({'one K7 launch' if route == 'k7' else loop_name})"
            f", in turns: device {[round(r['device_ms'], 4) for r in rs]} "
            f"ms, wall {[round(r['wall_ms'], 3) for r in rs]} ms, idle "
            f"{[round(r['idle_share'], 4) for r in rs]}")
    return dict(turns=out, loop_launches=counts["loop"][0])


def k7_moe(params, cfg, plan, device, gen, seed, th, prompts, rope, cache,
           tok, pos):
    """Phase 10's K7 checks on one Mixtral copy (int8 or bf16) at the
    thresholds its token path was held at (`th`): the plan
    (`check_k7_moe_plan`); every layer through K7's MoE form on a one-layer
    slice held to the plain layer, the same routed experts and kept groups
    (`hold_k7_layers`, on the step after prompt 0's prefill: `cache`, `tok`,
    `pos`); `K7_MOE_REPEATS` launches of the whole stack on the same inputs
    bit-identical (stream and caches: every cluster routed alike); K7's
    ms (queued), its plain version's, the barrier floor (the empty launch)
    and the bound of this token's kept groups; K7 against the K1/K2/K5
    loop on one call in turns (`k7_moe_turns`); the two decode graphs in
    turns (`k7_graphs`). Returns (the `kernels` entry, results)."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine import Generator
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import token_block as tb

    wplan = 1 if plan == "int8" else 0
    L, kx = cfg.n_layers, cfg.n_experts_per_tok
    tag = f"[k7 moe {plan}]"
    kplan = check_k7_moe_plan(cfg, wplan)
    t0 = time.perf_counter()
    worst, err, flips = hold_k7_layers(params, cfg, cache, tok, pos, rope,
                                       th, device, tag=tag)
    hold_s = time.perf_counter() - t0
    caps = llama.token_path_caps(cfg, SparsityConfig(**MAIN_SP))
    lay = params["layers"]
    pos_t = torch.tensor([pos], dtype=torch.int32, device=device)
    args = (params["embed"][tok].to(torch.bfloat16), th,
            tuple(lay[n] for n in PROJ_NAMES), lay["attn_norm"],
            lay["mlp_norm"], llama._rope_rows(rope[0], rope[1], pos_t),
            cache.k, cache.v, pos_t)
    kw = dict(caps=caps, n_heads=cfg.n_heads, norm_eps=cfg.norm_eps,
              window=cfg.sliding_window, router=lay["router"],
              n_experts_per_tok=kx)
    check(tb.k7_route(args[0], args[2], cache.k, cfg.n_heads, caps,
                      cfg.sliding_window, lay["router"],
                      n_experts_per_tok=kx), f"{tag} the route refuses K7")
    first = None
    sel = torch.zeros((L, 2 + 2 * kx, 1 + max(caps)), dtype=torch.int32,
                      device=device)
    routes = torch.zeros((L, kx), dtype=torch.int32, device=device)
    for i in range(K7_MOE_REPEATS):
        kc, vc = cache.k.clone(), cache.v.clone()
        out = tb.token_kernel(*args[:6], kc, vc, pos_t, sel=sel,
                              routes=routes, **kw)
        if first is None:
            first = (out, kc, vc, sel.clone(), routes.clone())
            continue
        same = (torch.equal(out, first[0]) and torch.equal(kc, first[1])
                and torch.equal(vc, first[2]) and torch.equal(sel, first[3])
                and torch.equal(routes, first[4]))
        check(same, f"{tag} launch {i} of {K7_MOE_REPEATS} differs from the "
              "first on the same inputs")
    del kc, vc
    check(bool(torch.isfinite(first[0].float()).all()),
          f"{tag} a non-finite stream")
    log(f"{tag} {K7_MOE_REPEATS} launches of the {L}-layer stack on the "
        f"same inputs: stream, caches, kept groups and routes bit-identical")
    scratch = (cache.k.clone(), cache.v.clone())
    targs = (*args[:6], *scratch, pos_t)
    ms, _ = cuda_ms(lambda i: tb.token_kernel(*targs, **kw), K7_TIME_ITERS)
    floor, _ = cuda_ms(lambda i: tb.token_kernel(*targs, empty=True, **kw),
                       K7_TIME_ITERS)
    plain, _ = cuda_ms(lambda i: tb.token_kernel_plain(*targs, **kw), 2,
                       warmup=1, queued=False)
    del scratch, targs
    nbytes, flops = k7_bound(first[3], cfg, pos, 2, wplan)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")
    kept = first[3][:, :, 0].float().mean(0).tolist()
    log(f"{tag} K7 at {MOE_MODEL}'s step (pos {pos}, {L} layers, {plan}): "
        f"{ms:.4f} ms a token (bound {bound:.4f} ms by {by}: "
        f"{nbytes / 1e6:.1f} MB, {bound / ms:.1%} of it), plain "
        f"{plain:.3f} ms, barrier floor {floor:.4f} ms "
        f"({kplan.grid_barriers} grid barriers a token; {kplan.clusters} "
        f"clusters of {kplan.C}, head-owned {kplan.head_owned}); mean kept "
        f"(qkv, o, then gate|up and down a routed expert) "
        f"{[round(k, 2) for k in kept]} of caps {list(caps)}")
    turns = k7_moe_turns(cfg, args, kw)
    gens = [Generator(cfg, params, sp=SparsityConfig(**MAIN_SP),
                      max_seq=MAX_SEQ, cache_dtype=torch.bfloat16,
                      temperature=0.0, device=device) for _ in range(2)]
    graphs = k7_graphs(gens, cfg, th, prompts, tag=tag)
    del gens
    torch.cuda.empty_cache()
    res = dict(plan=kplan._asdict(), hold_worst=worst, hold_abs=err,
               flips=flips, hold_s=hold_s, repeats=K7_MOE_REPEATS, ms=ms,
               plain_ms=plain, barrier_floor_ms=floor, bound_ms=bound,
               bound_by=by, kept_mean=kept, pos=pos, turns=turns,
               graphs=graphs)
    entry = dict(name=f"token_kernel[moe {plan}]", route="cuda",
                 source="teal_tpu_torch/csrc/token_decode"
                 + ("_quant.cu" if wplan else ".cu"),
                 replaces="teal_tpu/ops/token_block.py:274",
                 launches=None, max_abs_err=err, ms=ms, kernel_ms=ms,
                 plain_ms=plain, bound_ms=bound, bound_by=by,
                 library_ms=None, barrier_floor_ms=floor, kept_mean=kept,
                 pos=pos, plan=kplan._asdict(),
                 timed=f"one {MOE_MODEL} token ({L} layers, {plan} experts, "
                       f"bf16 stream) at pos {pos} at the thresholds of "
                       "phase 10's token-path hold; launches: this copy's "
                       "main-path host-loop run of three requests")
    return entry, res


def moe_run(cfg, plan, device, gen, seed, rope):
    """Phase 10 for one Mixtral copy: build it on the card, hold K1's MoE
    forms to the plain version, pick the thresholds (columns 0, 3 and 4;
    6 stays 0) on the plain token path and hold every layer of the K1/K5
    loop's decode step to it (2e-2 of scale, the same routed experts),
    K7's MoE form (`k7_moe`: every layer held, repeated launches
    bit-identical, times, K7 against the loop in turns, both graphs), run
    three greedy requests (dense prefill on the layer loop, decode on the
    main path: one K7 launch a token, no K1-K6), and time the decode step
    (keep 0.5 and 1.0), tok/s in turns and the kernels. Returns (K5 row,
    K1 rows, K7's entry, results)."""
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
        f"on the plain token path and every layer of the K1/K5 loop held "
        f"to it with the same routed experts (worst error {worst:.2e} of "
        f"scale, tolerance 2e-2) in {time.perf_counter() - t0:.2f} s")
    k7_entry, k7_res = k7_moe(params, cfg, plan, device, gen, seed, th,
                              prompts, rope, cache, int(tok.reshape(-1)[0]),
                              pos)

    gens = {keep: Generator(cfg, params, sp=SparsityConfig(
        **dict(MAIN_SP, block_keep_frac=keep)), max_seq=MAX_SEQ,
        cache_dtype=torch.bfloat16, temperature=0.0, device=device)
        for keep in (0.5, 1.0)}
    zero = llama.zero_thresholds(cfg, device)
    gens[0.5].generate(prompts[0], 3, thresholds=th,
                       on_device_loop=False)                # warm-up
    reset_launches()
    outs = [gens[0.5].generate(p, NEW_TOKENS, thresholds=th,
                               on_device_loop=False) for p in prompts]
    got, n7 = read_launches(), k7_launches()
    decoded = len(prompts) * (NEW_TOKENS - 1)
    check(got == (0,) * 6 and n7 == decoded, f"moe {plan}: launches (K1, "
          f"K2, K3, K4, K5, K6) {got} and {n7} K7, expected none and "
          f"{decoded} (one K7 a decoded token)")
    k7_entry["launches"] = n7
    for p, (toks, st) in zip(prompts, outs):
        check(toks.shape == (1, len(p) + NEW_TOKENS)
              and bool((toks >= 0).all() and (toks < cfg.vocab_size).all()),
              f"moe {plan}: bad tokens {toks.shape}")
    log(f"[moe {plan}] {len(prompts)} requests, {decoded} decoded tokens, "
        f"{n7} K7 launches and none of K1-K6; first request's new tokens "
        f"{outs[0][0][0, len(prompts[0]):].tolist()}")
    lg, _ = llama.forward(params, tok, llama.KVCache(cache.k.clone(),
                                                     cache.v.clone()),
                          pos, th, cfg=cfg, sp=sp, rope=rope)
    check(tuple(lg.shape) == (1, 1, cfg.vocab_size)
          and bool(torch.isfinite(lg).all()), f"moe {plan}: bad logits")

    speeds = {0.5: [], 1.0: []}
    for keep in (1.0, 0.5, 0.5, 1.0):
        _, st = gens[keep].generate(prompts[2], 32, thresholds=(
            th if keep == 0.5 else zero), on_device_loop=False)
        speeds[keep].append(st.tokens_per_s)
    log(f"[moe {plan}] decode tok/s (prompt 40, 32 new tokens, in turns): "
        f"keep 0.5 {speeds[0.5]}, keep 1.0 {speeds[1.0]}")
    step = time_decode_step(params, cfg, [
        (f"moe {plan} keep 0.5", MAIN_SP, 1, th),
        (f"moe {plan} keep 1.0", dict(MAIN_SP, block_keep_frac=1.0), 1,
         zero)], device, rope)
    k5, k1_rows = time_moe_kernels(params, cfg, caps, device, gen, plan)
    graph = graph_route(f"moe {plan}", cfg, params, MAIN_SP, 1, th, device,
                        prompts, (0,) * 6, seed, k7_per_step=1)
    results = dict(layers=L, build_s=build_s, worst=worst, launches=got,
                   k7_launches=n7, k7=k7_res, graph=graph,
                   decoded=decoded, err_k1=err_k1,
                   tok_s={str(k): v for k, v in speeds.items()},
                   decode_step_ms=step,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   new_tokens=[o[0][0, len(p):].tolist()
                               for p, o in zip(prompts, outs)])
    del params, gens, cache
    torch.cuda.empty_cache()
    return k5, k1_rows, k7_entry, results


def moe_phase(device, gen, seed):
    """Phase 10: K5 against its plain version, then `moe_run` on the int8
    and bf16 copies of `MOE_RUNS` (the main path: K7's MoE form), then K2
    at Mixtral's heads. K1's MoE forms, K5 and K2 there run only on the
    `token_fused=False` loop now: their entries take their launches from
    the main path's runs (0) and are marked off the path. Returns (kernels
    entries, results)."""
    import dataclasses

    from teal_tpu_torch.config import get_model_config
    from teal_tpu_torch.models import llama

    full = get_model_config(MOE_MODEL)
    rope = llama.precompute_rope(full, MAX_SEQ, device)
    err_k5, k5_differ = check_k5(device, gen)
    entries, results, k5_rows = [], {}, {}
    src = "teal_tpu_torch/csrc/"
    still = ("token_decode(token_fused=False): the K1/K2/K5 loop, and a "
             "Mixtral shape K7 cannot plan")
    for plan, layers in MOE_RUNS:
        cfg = dataclasses.replace(full, n_layers=layers or full.n_layers)
        k5_rows[plan], k1_rows, k7_entry, results[plan] = moe_run(
            cfg, plan, device, gen, seed, rope)
        r = results[plan]
        entries.append(k7_entry)
        entries.append(off_path(plan_entry(
            k1_rows, f"select_gather_gemv[moe {plan}]",
            src + "select_gather_gemv.cu", "teal_tpu/ops/token_block.py:274",
            r["launches"][0], r["decoded"], r["err_k1"],
            f"{MOE_MODEL} {plan} at {cfg.n_layers} layers: one routed "
            "expert's two calls (gate|up, down with the weighted residual; "
            "device pseudo-layer) at count == cap, summed; launches: all of "
            "K1's in the main path's run (K7's MoE form there)"), still))
    r8 = results["int8"]
    entries.append(off_path(dict(
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
            "floor_one_block_ms", "floor_cluster_ms")}), still))
    # K2 at Mixtral's heads (GQA 32/8), launched on the int8 main path
    # before K7 took it (K7 attends inside)
    rope = llama.precompute_rope(full, 2048, device)
    for T in (MAX_SEQ, 2048):
        entries.append(off_path(time_k2(
            full, device, gen, rope, r8["launches"][1], r8["decoded"], 0.0,
            f"decode_attention[GQA 32/8 pos {T - 1}]", T=T), still))
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
        sp = SparsityConfig(**LOOP_SP)
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
    around it (L K8 and 3*L K1 a step)."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.utils.bench_utils import bench_chained

    sp = SparsityConfig(**LOOP_SP)
    cache = llama.KVCache.init(cfg, 1, MAX_SEQ, llama.compute_dtype(params),
                               device)

    def one(c):
        logits, _ = llama.forward(params, c["tok"], cache, 40, c["th"],
                                  cfg=cfg, sp=sp, rope=rope)
        return {"tok": torch.argmax(logits[:, -1:], dim=-1), "th": c["th"]}

    reset_launches()
    s = bench_chained(one, {"tok": torch.full((1, 1), 7, device=device),
                            "th": th}, **P16_BENCH)
    counts, n8 = read_launches(), k8_launches()
    n = (P16_BENCH["n_short"] + P16_BENCH["n_long"]) * (P16_BENCH["reps"]
                                                         + 1)
    L = cfg.n_layers
    cuda = device.type == "cuda"
    want = (tuple(c * L * n for c in LOOP_ROW) if cuda else (0,) * 6,
            L * n if cuda else 0)
    check((counts, n8) == want, f"bench_chained's steps launched "
          f"{counts} and {n8} K8, expected {want}")
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


# --- phase 17: the on-device decode loops (CUDA graphs) ---------------------

# substrings of K1-K6's kernel names, in the profiler's (demangled) and
# the CUDA driver's (mangled) form
KERNEL_NAMES = ("sgg_", "attn_kernel", "bgg_", "rgg_kernel", "route_kernel",
                "flash_prefill_")
GRAPH_TEMPS = (0.0, 0.8)          # the token checks: greedy, and seeded
GRAPH_TURNS = 3                   # host / graph tok/s turns a route
GRAPH_REPLAYS = 10                # replays a profile, and a wall timing
GRAPH_POS = 40                    # the position of the timed replays


def graph_counts(graph, what: str, per_replay):
    """K1-K6 kernel nodes of a captured graph, read from the CUDA driver
    (`profiling.graph_kernels`): exactly what each replay launches. They
    must equal `per_replay`. Returns (counts, all kernel nodes)."""
    from teal_tpu_torch.utils.profiling import graph_kernels

    nodes = graph_kernels(graph)
    counts = tuple(sum(c for k, c in nodes.items() if name in k)
                   for name in KERNEL_NAMES)
    check(counts == tuple(per_replay),
          f"graph {what}: the graph holds (K1, K2, K3, K4, K5, K6) "
          f"{counts} kernel nodes, expected {tuple(per_replay)}")
    return counts, sum(nodes.values())


def k7_nodes(graph) -> int:
    """K7's kernel nodes (one row's `token_kernel`, the rows form's
    `token_rows_kernel`) of a captured graph (`profiling.graph_kernels`)."""
    from teal_tpu_torch.utils.profiling import graph_kernels

    return sum(c for k, c in graph_kernels(graph).items()
               if "token_kernel" in k or "token_rows_kernel" in k)


def k8_nodes(graph) -> int:
    """K8's kernel nodes (`attn_block_kernel`) of a captured graph
    (`profiling.graph_kernels`)."""
    from teal_tpu_torch.utils.profiling import graph_kernels

    return sum(c for k, c in graph_kernels(graph).items()
               if "attn_block_kernel" in k)


def profile_replays(loop, iters: int):
    """`iters` replays of a `Generator`'s decode graph (`loop`, its
    `_DecodeLoop`) from position `GRAPH_POS`: (device ms a replay, the sum
    of its kernel times from the profiler; wall ms a replay, host clock,
    synchronised, without the profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    loop.pos.fill_(GRAPH_POS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            loop.graph.replay()
        torch.cuda.synchronize()
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)) / 1e3
    loop.pos.fill_(GRAPH_POS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        loop.graph.replay()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    loop.pos.fill_(GRAPH_POS)
    return dev / iters, wall


def graph_route(what, cfg, params, sp_kw, b, th, device, prompts, per_step,
                seed, n_new: int = NEW_TOKENS, k7_per_step: int = 0,
                k8_per_step: int = 0):
    """Phase 17 on one route the script's `Generator` drives (sparsity
    kwargs `sp_kw`, batch b, thresholds th, `per_step` K1-K6 launches a
    layer and step): the decode step's capture, counts set to 0 just
    before and read just after (two warm-up steps and the captured one go
    through the wrappers: 3 x per_step x L); every prompt decoded
    `n_new` tokens by the host loop and by the graph at each
    temperature of `GRAPH_TEMPS` from one generator seed, the tokens
    equal; the graph's K1-K6 kernel nodes, what one replay launches,
    equal to per_step x L (`graph_counts`), and its K7 nodes to
    `k7_per_step` (`k7_nodes`; K7's wrapper counts 3 x k7_per_step at the
    capture), and its K8 nodes to `k8_per_step` (`k8_nodes`, likewise);
    the replayed step's device and
    wall time and idle share (1 - device / wall, unclamped: device time
    above wall time is reported as it is, with a note); tok/s of both
    loops in `GRAPH_TURNS` turns of 2 x n_new tokens. Returns the
    results."""
    import numpy as np
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine import Generator
    from teal_tpu_torch.models import llama

    L = cfg.n_layers
    gens = {temp: Generator(cfg, params, sp=SparsityConfig(**sp_kw),
                            max_seq=MAX_SEQ, batch=b,
                            cache_dtype=llama.compute_dtype(params),
                            temperature=temp, device=device)
            for temp in GRAPH_TEMPS}
    g0 = gens[GRAPH_TEMPS[0]]
    reset_launches()
    t0 = time.perf_counter()
    g0.warmup()
    capture_s = time.perf_counter() - t0
    got, n7, n8 = read_launches(), k7_launches(), k8_launches()
    want = tuple(3 * n * L for n in per_step)
    check(got == want and n7 == 3 * k7_per_step and n8 == 3 * k8_per_step,
          f"graph {what}: launches (K1, K2, K3, K4, K5, K6) at the capture "
          f"{got}, {n7} K7 and {n8} K8, expected {want}, {3 * k7_per_step} "
          f"and {3 * k8_per_step} (2 warm-up steps and the captured one)")
    for temp, g in gens.items():
        for i, p in enumerate(prompts):
            outs = [g.generate(p, n_new, thresholds=th, generator=(
                torch.Generator(device=device).manual_seed(seed + i)),
                on_device_loop=dl)[0] for dl in (False, True)]
            check(np.array_equal(outs[0], outs[1]), f"graph {what}: "
                  f"temperature {temp}, prompt {i}: the graph's tokens "
                  f"{outs[1][..., -n_new:].tolist()} differ from the "
                  f"host loop's {outs[0][..., -n_new:].tolist()}")
    dev, wall = profile_replays(g0._loop, GRAPH_REPLAYS)
    counts, total = graph_counts(g0._loop.graph, what,
                                 [n * L for n in per_step])
    nodes7 = k7_nodes(g0._loop.graph)
    check(nodes7 == k7_per_step, f"graph {what}: {nodes7} K7 kernel nodes, "
          f"expected {k7_per_step}")
    nodes8 = k8_nodes(g0._loop.graph)
    check(nodes8 == k8_per_step, f"graph {what}: {nodes8} K8 kernel nodes, "
          f"expected {k8_per_step}")
    tok_s = {"host": [], "graph": []}
    for i in range(GRAPH_TURNS):
        for kind in (("host", "graph") if i % 2 == 0 else ("graph", "host")):
            _, st = g0.generate(prompts[-1], 2 * n_new, thresholds=th,
                                on_device_loop=kind == "graph")
            tok_s[kind].append(st.tokens_per_s * b)
    res = dict(batch=b, capture_launches=got, replay_launches=counts,
               replay_k7_nodes=nodes7, replay_k8_nodes=nodes8,
               replay_kernels=total, replay_device_ms=dev,
               replay_wall_ms=wall, replay_idle_share=1 - dev / wall,
               first_generate_s=capture_s, tok_s=tok_s)
    log(f"[graph] {what} (batch {b}): the graph's tokens equal the host "
        f"loop's for {len(prompts)} prompts x {n_new} tokens at "
        f"temperatures {GRAPH_TEMPS}; capture launches {got}, K7 {n7}, K8 "
        f"{n8}; one replay: (K1, K2, K3, K4, K5, K6) {counts}, K7 {nodes7} "
        f"and K8 {nodes8} of "
        f"{total} kernel nodes, device "
        f"{dev:.3f} ms, wall {wall:.3f} ms, idle "
        f"{res['replay_idle_share']:.1%}"
        + (" (device time above wall time: the profiled and the unprofiled "
           "replays' clocks disagree)" if dev > wall else "")
        + "; tok/s in turns host "
        f"{[round(t, 2) for t in tok_s['host']]} graph "
        f"{[round(t, 2) for t in tok_s['graph']]}")
    del gens, g0
    torch.cuda.empty_cache()
    return res


def device_loop_phase(params, cfg, device, seed, th):
    """Phase 17 on the resident bf16 7B after phase 4, at its thresholds:
    `graph_route` on the main path (L K8 + 3*L K1 a replay) and on dense
    decode (none of the port's kernels), phase 4's three prompts. Returns
    {route: results}."""
    t0 = time.perf_counter()
    prompts = main_prompts(cfg, seed)
    res = {"main": graph_route("main", cfg, params, LOOP_SP, 1, th, device,
                               prompts, LOOP_ROW, seed,
                               k8_per_step=cfg.n_layers),
           "dense": graph_route("dense", cfg, params, {}, 1, th, device,
                                prompts, (0, 0, 0, 0, 0, 0), seed)}
    log(f"[graph] phase 17 (main and dense) in "
        f"{time.perf_counter() - t0:.1f} s")
    return res


# --- phase 18: K7, the whole token in one launch ----------------------------

K7_TOKEN_TOL = 2e-2              # a layer's output and cache rows, of scale
K7_LONG = (2047, 2048)           # (pos, T) of the long-context 2-layer run
K7_CUT = 2                       # layers of the fp32 cut at 7B widths
K7_TIME_ITERS = 20
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores


def check_k7_plan(wplan: int = 0):
    """K7's plan in the wrapper (`token_block._token_plan` on the card's
    resident clusters, `token_block.k7_clusters`) equal to the kernel's
    (`teal_token_plan`) on this card, fp32 and bf16 arrays (wplan 0), or
    int8 (1) or packed int4 (2) with a bf16 stream (`teal_token_plan_q`):
    Llama-2-7B at T 512 / 2048 / 4096, Mistral-7B (GQA 32/8, window 4096)
    at T 8192, and the tests' head-128 tiny configs; each within shared
    memory; the 7B's plan head-owned with 4 grid barriers and no kv-head
    barrier a layer."""
    import ctypes

    import torch

    from teal_tpu_torch import _build
    from teal_tpu_torch.ops import token_block as tb

    lib = _build.load()["token_decode" if wplan == 0
                        else "token_decode_quant"]
    sms = _build.sm_count(0)
    dev = torch.device("cuda", 0)
    shapes = [(4096, 11008, 32, 32, T, None, 43, 32) for T in
              (512, 2048, 4096)] + [(4096, 14336, 32, 8, 8192, 4096, 56, 32),
                                    (256, 384, 2, 1, 16, None, 3, 3),
                                    (256, 384, 2, 2, 64, 8, 3, 3)]
    plans = {}
    forms = (((0, 4, torch.float32), (1, 2, torch.bfloat16)) if wplan == 0
             else ((1, 2, torch.bfloat16),))
    for D, I, Hq, Hkv, T, win, cm, L in shapes:
        for code, esz, dt in forms:
            out = (ctypes.c_int * 11)()
            if wplan == 0:
                rc = lib.teal_token_plan(code, D, I, Hq, Hkv, T, win or 0, cm,
                                         sms, L, 0, 0, out)
            else:
                rc = lib.teal_token_plan_q(wplan, D, I, Hq, Hkv, T, win or 0,
                                           cm, sms, L, 0, 0, out)
            want = tb._token_plan(esz, D, I, Hq, Hkv, T, win, cm, L, sms,
                                  tb.k7_clusters(dev, dt, Hq // Hkv, wplan),
                                  wplan)
            check(rc == 0 and want is not None and tuple(out) == tuple(want)
                  and want.smem <= tb._SMEM_BYTES,
                  f"K7 plan {(D, I, Hq, Hkv, T, win, cm, L, esz)}: kernel "
                  f"{rc} {list(out)}, wrapper {want}")
            plans[f"{D}/{I}/{Hq}/{Hkv}/T{T}/w{win}/{esz}B"] = list(out)
    p7 = plans["4096/11008/32/32/T512/wNone/2B"]
    check(p7[8] == 1 and p7[4] == 4 * 32 and p7[5] == 0,
          f"the 7B's K7 plan {p7}: expected head-owned, 4 grid barriers and "
          "no kv-head barrier a layer")
    log(f"[k7] plan (weight plan {wplan}) equal in the wrapper and the "
        f"kernel for {len(plans)} shapes on {sms} SMs, resident clusters of "
        f"C = 2..8: "
        f"{list(tb.k7_clusters(dev, torch.bfloat16, 1, wplan).values())}; "
        f"7B bf16 T 512: {p7} (grid, threads, shared bytes, workspace "
        "bytes, grid barriers, kv-head barriers, C, clusters, head-owned, "
        "ring slots, score rows)")
    return plans


def k7_recorder(rec, idx_rec, override=None):
    """`recording_k1` that also appends each call's kept groups (in order)
    to `idx_rec`."""
    base = recording_k1(rec, override)

    def k1(*args, **kw):
        out = base(*args, **kw)
        idx_rec.append(out[1][:int(out[2])])
        return out
    return k1


def hold_k7_layers(params, cfg, cache, tok, pos, rope, th, device,
                   tag="[k7]", seq_block: bool = False, keep=None):
    """Every layer of K7 run alone on a one-layer slice of the stack
    (weights, gains, thresholds and cache layer `i:i+1`), on the plain
    path's input to that layer and the pre-step cache: its output and
    written K/V rows within `K7_TOKEN_TOL` of their largest magnitude of
    the plain layer's (`layer_decode` under `plain_path`, the same
    thresholds), its kept counts and groups (K7's `sel`) equal to the
    plain path's. Where one stage kept one group more or fewer and a plain
    score lies within FLIP_ULPS of the threshold (`explain_count_flip`, as
    phase 4), the plain layer runs again past that score and K7 is held to
    that. `tok` and `pos` as lists of B > 1 (the cache of B rows): K7's
    rows form, one row a sequence at its own position, the written K/V
    rows held at each; with `seq_block` the rows are the consecutive
    positions of one sequence in cache row 0 (`block_verify`'s chunk: the
    fixed selection at full caps, K7's seq_block form). With `keep` (a
    dict), keep["cache"] receives the plain path's cache after the step
    as (k, v). Mixtral (`cfg.n_experts`, one row): a one-layer slice of
    the expert stacks and of the router too (K7's MoE form, whose routes
    are read at pseudo-layer e of the slice), its routed experts equal to
    the plain path's (K5's plain version) and its kept counts and groups
    at every stage (qkv, o, then gate|up and down of each routed expert).
    Returns (worst relative error, worst absolute error of the output,
    flips explained)."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import token_block as tb

    lay = params["layers"]
    ws = tuple(lay[n] for n in PROJ_NAMES)
    caps = ((cfg.dim // 128,) * 3 + (cfg.intermediate_size // 128,)
            if seq_block else
            llama.token_path_caps(cfg, SparsityConfig(**MAIN_SP)))
    kw = dict(caps=caps, n_heads=cfg.n_heads, norm_eps=cfg.norm_eps,
              window=cfg.sliding_window, fixed_sel=seq_block,
              seq_block=seq_block)
    E, kx = cfg.n_experts, cfg.n_experts_per_tok
    stages = list(STAGES)
    plain_ws, moe_kw, k7_kw = ws, {}, {}
    if E:
        plain_ws = (*ws[:4], *(tb.expert_stacks(w) for w in ws[4:]))
        moe_kw = dict(router=lay["router"], k_exp=kx)
        stages = ["qkv", "o"] + [f"{n} (expert {t})" for t in range(kx)
                                 for n in ("gate|up", "down")]
    k, v = cache.k.clone(), cache.v.clone()            # plain path
    poss = [pos] if isinstance(pos, int) else list(pos)
    B = len(poss)
    pos_t = torch.tensor(poss, dtype=torch.int32, device=device)
    rows = llama._rope_rows(rope[0], rope[1], pos_t)
    h = params["embed"][torch.as_tensor(
        [tok] if B == 1 else list(tok), device=device)].to(
        llama.compute_dtype(params)).reshape(
        (cfg.dim,) if B == 1 else (B, cfg.dim))
    worst = worst_abs = 0.0
    flips, kept = 0, []
    for i in range(cfg.n_layers):
        rec, idx_rec, counts, routes = [], [], [], []
        with plain_path(k1=k7_recorder(rec, idx_rec)):
            want = tb.layer_decode(h, i, th, plain_ws, lay["attn_norm"],
                                   lay["mlp_norm"], rows, k, v, pos_t,
                                   counts=counts, routes=routes, **kw,
                                   **moe_kw)
        sl = slice(i, i + 1)
        kk, vk = cache.k[sl].clone(), cache.v[sl].clone()
        sel = torch.zeros((1, len(stages), 1 + max(caps)), dtype=torch.int32,
                          device=device)
        if E:
            k7_kw = dict(router=lay["router"][sl].contiguous(),
                         n_experts_per_tok=kx,
                         routes=torch.zeros((1, kx), dtype=torch.int32,
                                            device=device))
        got = tb.token_kernel(h, th[sl].contiguous(),
                              tuple(llama._leaf(w, lambda a: a[sl])
                                    for w in ws), lay["attn_norm"][sl],
                              lay["mlp_norm"][sl], rows, kk, vk, pos_t,
                              sel=sel, **kw, **k7_kw)
        if E:
            g_e = k7_kw["routes"][0].tolist()
            w_e = [e - i * E for e in routes[0].tolist()]
            check(g_e == w_e, f"{tag} layer {i}: K7 routed experts {g_e}, "
                  f"the plain path {w_e}")
            if i in (0, cfg.n_layers - 1):
                log(f"{tag} layer {i}: routed experts {g_e} on both paths")
        g_cnt = [int(c) for c in sel[0, :, 0].tolist()]
        w_cnt = [int(c) for c in counts[-1].tolist()]
        held = want
        if g_cnt != w_cnt:
            ok, what, override = explain_count_flip(rec, g_cnt, w_cnt)
            log(f"{tag} layer {i}: {what}; {'a flip' if ok else 'not a flip'}"
                f" within {FLIP_ULPS} ulps")
            check(ok, f"{tag} layer {i}: K7 kept {g_cnt}, the plain path "
                  f"{w_cnt}: {what}")
            rec, idx_rec, again = [], [], []
            with plain_path(k1=k7_recorder(rec, idx_rec, override)):
                held = tb.layer_decode(h, i, th, plain_ws, lay["attn_norm"],
                                       lay["mlp_norm"], rows, k, v, pos_t,
                                       counts=again, **kw, **moe_kw)
            check([int(c) for c in again[0].tolist()] == g_cnt,
                  f"{tag} layer {i}: the plain layer run again keeps "
                  f"{again[0].tolist()}, K7 {g_cnt}")
            flips += 1
        for st, c in enumerate(g_cnt):
            check(torch.equal(sel[0, st, 1:1 + c], idx_rec[st].int()),
                  f"{tag} layer {i} stage {stages[st]}: K7 kept "
                  f"{sel[0, st, 1:1 + c].tolist()}, the plain path "
                  f"{idx_rec[st].tolist()}")
        kept.append(g_cnt)
        rows_of = [(0 if seq_block else b, p) for b, p in enumerate(poss)]
        for what, g, w in (("hidden", got, held),
                           *((f"k row {b}", kk[0, b, :, p], k[i, b, :, p])
                             for b, p in rows_of),
                           *((f"v row {b}", vk[0, b, :, p], v[i, b, :, p])
                             for b, p in rows_of)):
            err = rel_check(f"{tag} layer {i} {what}: K7 vs plain", g, w,
                            K7_TOKEN_TOL)
            scale = float(w.float().abs().max())
            worst = max(worst, err / scale if scale else 0.0)
            if what == "hidden":
                worst_abs = max(worst_abs, err)
        h = want
    mean = [round(sum(c[j] for c in kept) / len(kept), 2)
            for j in range(len(stages))]
    if keep is not None:
        keep["cache"] = (k, v)
    log(f"{tag} {cfg.n_layers} layers at pos {poss if B > 1 else pos}: "
        f"each K7 layer held to "
        f"the plain layer (worst {worst:.2e} of scale, tolerance "
        f"{K7_TOKEN_TOL}); kept groups identical ({flips} one-group flips "
        f"explained)" + (", routed experts identical" if E else "")
        + f"; mean kept ({', '.join(stages)}) {mean} of caps {list(caps)}")
    return worst, worst_abs, flips


def k7_long_run(params, cfg, device, gen, th, tag="[k7 long]"):
    """K7 on the first two layers at pos 2047 of a 2048-row cache of random
    rows (`K7_LONG`): each layer held alone (`hold_k7_layers`), then one
    2-layer launch against `token_kernel_plain` on the same input, output
    and cache within `K7_TOKEN_TOL` of scale where both keep the same
    groups. Returns the results."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import token_block as tb

    pos, T = K7_LONG
    ccfg = dataclasses.replace(cfg, n_layers=2)
    cut = dict(params, layers={k: llama._leaf(v, lambda a: a[:2])
                               for k, v in params["layers"].items()})
    dt = llama.compute_dtype(params)
    shape = (2, 1, cfg.n_kv_heads, T, 128)
    cache = llama.KVCache(
        torch.randn(shape, generator=gen, device=device).to(dt),
        torch.randn(shape, generator=gen, device=device).to(dt))
    rope = llama.precompute_rope(cfg, T, device)
    worst, _, flips = hold_k7_layers(cut, ccfg, cache, 7, pos, rope,
                                     th[:2].contiguous(), device, tag=tag)
    caps = llama.token_path_caps(cfg, SparsityConfig(**MAIN_SP))
    pos_t = torch.tensor([pos], dtype=torch.int32, device=device)
    rows = llama._rope_rows(rope[0], rope[1], pos_t)
    h = cut["embed"][7].to(dt)
    lay = cut["layers"]
    args = (h, th[:2].contiguous(), tuple(lay[n] for n in PROJ_NAMES),
            lay["attn_norm"], lay["mlp_norm"], rows)
    kw = dict(caps=caps, n_heads=cfg.n_heads, norm_eps=cfg.norm_eps,
              window=cfg.sliding_window)
    sels = [torch.zeros((2, 4, 1 + max(caps)), dtype=torch.int32,
                        device=device) for _ in range(2)]
    caches = [(cache.k.clone(), cache.v.clone()) for _ in range(2)]
    got = tb.token_kernel(*args, *caches[0], pos_t, sel=sels[0], **kw)
    want = tb.token_kernel_plain(*args, *caches[1], pos_t, sel=sels[1], **kw)
    res = dict(pos=pos, T=T, layer_worst=worst, flips=flips,
               same_kept=bool(torch.equal(*sels)))
    if res["same_kept"]:
        res["err"] = rel_check(f"{tag} 2 layers in one launch: K7 vs "
                               "plain", got, want, K7_TOKEN_TOL)
        for i, name in enumerate(("k", "v")):
            rel_check(f"{tag} {name} cache after the launch",
                      caches[0][i], caches[1][i], K7_TOKEN_TOL)
    log(f"{tag} pos {pos} of a {T}-row cache, 2 layers: "
        + (f"one launch within {res['err']:.3e} of the plain version, the "
           "same kept groups" if res["same_kept"] else
           "the 2-layer launch kept other groups than the plain version "
           "(a flip the layer holds explained); held layer by layer"))
    return res


def k7_gqa_hold(cfg, device, gen, th):
    """K7 at GQA 32/8 at the 7B's width (the plan Mistral-7B's heads take
    on this card): a 2-layer model of random bf16 weights (`cfg` with 8
    kv heads), each layer held alone to the plain path (`hold_k7_layers`)
    at pos 2047 of a 2048-row cache of random rows, at phase 4's first two
    layers' thresholds. Returns the results."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import token_block as tb

    ccfg = dataclasses.replace(cfg, n_layers=2, n_kv_heads=8)
    params = llama.init_params(ccfg, gen, torch.bfloat16, device)
    pos, T = K7_LONG
    shape = (2, 1, ccfg.n_kv_heads, T, 128)
    cache = llama.KVCache(
        torch.randn(shape, generator=gen, device=device).to(torch.bfloat16),
        torch.randn(shape, generator=gen, device=device).to(torch.bfloat16))
    lay = params["layers"]
    plan = tb.token_plan(params["embed"][0], cache.k,
                         tuple(lay[n] for n in PROJ_NAMES), ccfg.n_heads,
                         llama.token_path_caps(ccfg,
                                               SparsityConfig(**MAIN_SP)))
    worst, err, flips = hold_k7_layers(
        params, ccfg, cache, 7, pos, llama.precompute_rope(ccfg, T, device),
        th[:2].contiguous(), device, tag="[k7 gqa 32/8]")
    log(f"[k7 gqa 32/8] D {ccfg.dim}, Hq {ccfg.n_heads} / Hkv "
        f"{ccfg.n_kv_heads}: plan {plan}")
    del params, cache
    torch.cuda.empty_cache()
    return dict(worst=worst, max_abs_err=err, flips=flips, pos=pos,
                plan=plan._asdict())


def k7_tokens(params, cfg, device, seed, th, fp32_cut: bool = True,
              tag: str = "[k7]"):
    """Phase 4's three prompts, `NEW_TOKENS` greedy tokens each, through the
    main path as a user calls it (`Generator` with `MAIN_SP`: K7) and through
    the loop (`LOOP_SP`): on the resident 7B (bf16, or a quantized copy
    with a bf16 stream) the agreement is reported; with `fp32_cut`, on a
    `K7_CUT`-layer fp32 cut at the 7B widths the tokens must be equal. The
    K7 run decodes on the host loop with the launch counts set to 0 just
    before and read just after: one K7 and no K1-K6 launch a decoded
    token. Returns (results, K7 launches, the two bf16 Generators)."""
    import numpy as np
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine import Generator
    from teal_tpu_torch.models import llama

    prompts = main_prompts(cfg, seed)
    res = {}

    def gens(p, c, dt):
        return [Generator(c, p, sp=SparsityConfig(**sp), max_seq=MAX_SEQ,
                          cache_dtype=dt, temperature=0.0, device=device)
                for sp in (MAIN_SP, LOOP_SP)]

    k7, loop = gens(params, cfg, torch.bfloat16)
    k7.generate(prompts[0], 4, thresholds=th, on_device_loop=False)
    reset_launches()
    outs = [k7.generate(p, NEW_TOKENS, thresholds=th,
                        on_device_loop=False)[0] for p in prompts]
    got, n7 = read_launches(), k7_launches()
    decoded = len(prompts) * (NEW_TOKENS - 1)
    check(got == (0,) * 6 and n7 == decoded, f"{tag} main path: launches "
          f"(K1-K6) {got} and {n7} K7 for {decoded} decoded tokens, "
          f"expected none and {decoded}")
    refs = [loop.generate(p, NEW_TOKENS, thresholds=th)[0] for p in prompts]
    agree = [int((a[0, len(p):] == b[0, len(p):]).sum())
             for a, b, p in zip(outs, refs, prompts)]
    res["bf16"] = dict(agree=agree, of=NEW_TOKENS,
                       k7=[o[0, len(p):].tolist()
                           for o, p in zip(outs, prompts)],
                       loop=[o[0, len(p):].tolist()
                             for o, p in zip(refs, prompts)])
    log(f"{tag} main path (K7, host loop): {decoded} decoded tokens, "
        f"{n7} K7 launches, no K1-K6; bf16 greedy tokens equal to the "
        f"loop's: {agree} of {NEW_TOKENS} a prompt")
    if not fp32_cut:
        return res, n7, (k7, loop)
    ccfg = dataclasses.replace(cfg, n_layers=K7_CUT)
    cut = to_fp32(dict(params, layers={k: v[:K7_CUT] for k, v in
                                       params["layers"].items()}))
    ck7, cloop = gens(cut, ccfg, torch.float32)
    cth = th[:K7_CUT].contiguous()
    for p in prompts:
        a = ck7.generate(p, NEW_TOKENS, thresholds=cth,
                         on_device_loop=False)[0]
        b = cloop.generate(p, NEW_TOKENS, thresholds=cth,
                           on_device_loop=False)[0]
        check(np.array_equal(a, b), f"[k7] fp32 {K7_CUT}-layer cut, prompt "
              f"{len(p)}: K7's tokens {a[0, len(p):].tolist()} differ from "
              f"the K1/K2 loop's {b[0, len(p):].tolist()}")
    res["fp32_cut_equal"] = True
    log(f"[k7] fp32 {K7_CUT}-layer cut at the 7B widths: K7's greedy tokens "
        f"equal the K1/K2 loop's for {len(prompts)} prompts x {NEW_TOKENS}")
    del cut, ck7, cloop
    torch.cuda.empty_cache()
    return res, n7, (k7, loop)


@contextlib.contextmanager
def k7_off():
    """Inside the block `token_decode` takes the K1/K2 loop (Mixtral's: K1,
    K2 and K5) wherever it would take K7: the loop's decode graph of a
    `Generator` is captured under it where `token_fused=False` would leave
    the token path (Mixtral: the model's layer loop, as in the
    reference). A replay does not call Python: the graph keeps the loop."""
    from teal_tpu_torch.ops import token_block as tb

    route = tb.k7_route
    tb.k7_route = lambda *a, **kw: False
    try:
        yield
    finally:
        tb.k7_route = route


def k7_graphs(gens, cfg, th, prompts, tag="[k7]"):
    """The decode graphs of K7 and of the K1/K2 loop (the two `Generator`s
    of `k7_tokens`; Mixtral: the loop's `Generator` is captured under
    `k7_off`): their kernel nodes (`graph_kernels`; one K7 and no
    K1/K2/K5/K8 node; the loop with arrays or int4 L K8 + 3 L K1, Mixtral
    L K8 + (1 + 2k) L K1 + L K5; with int8 4 L K1 + L K2, Mixtral (2 + 2k)
    L K1 + L K2 + L K5), then in turns a replay's device ms (profiler),
    wall ms, idle share and tok/s (`GRAPH_TURNS` turns of 2 x
    `NEW_TOKENS` tokens)."""
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.utils.profiling import graph_kernels

    L, kx = cfg.n_layers, cfg.n_experts_per_tok
    int8 = llama._is_int8(gens[1].params["layers"]["wq"])
    mlp = 2 * kx if cfg.n_experts else 2         # K1 launches of the MLP
    loop_want = (((2 + mlp) * L, L, L if cfg.n_experts else 0, 0, 0)
                 if int8 else
                 (mlp * L + L, 0, L if cfg.n_experts else 0, 0, L))
    res = {}
    for name, g, want in (("k7", gens[0], (0, 0, 0, 1, 0)),
                          ("loop", gens[1], loop_want)):
        with (k7_off() if cfg.n_experts and name == "loop"
              else contextlib.nullcontext()):
            g.generate(prompts[0], 4, thresholds=th)      # the capture
        nodes = graph_kernels(g._loop.graph)
        counts = tuple(sum(c for k, c in nodes.items() if n in k)
                       for n in ("sgg_", "attn_kernel", "route_kernel",
                                 "token_kernel", "attn_block_kernel"))
        check(counts == want, f"{tag} {name} graph: (K1, K2, K5, K7, K8) "
              f"nodes {counts}, expected {want}")
        res[name] = dict(nodes=counts, kernel_nodes=sum(nodes.values()),
                         device_ms=[], wall_ms=[], idle=[], tok_s=[])
    for i in range(GRAPH_TURNS):
        for name in (("k7", "loop") if i % 2 == 0 else ("loop", "k7")):
            g = gens[0] if name == "k7" else gens[1]
            dev, wall = profile_replays(g._loop, GRAPH_REPLAYS)
            _, st = g.generate(prompts[-1], 2 * NEW_TOKENS, thresholds=th)
            r = res[name]
            r["device_ms"].append(dev)
            r["wall_ms"].append(wall)
            r["idle"].append(1 - dev / wall)
            r["tok_s"].append(st.tokens_per_s)
    for name, r in res.items():
        log(f"{tag} {name} decode graph: (K1, K2, K5, K7, K8) nodes "
            f"{r['nodes']} of {r['kernel_nodes']} kernel nodes; in turns "
            f"device "
            f"{[round(x, 3) for x in r['device_ms']]} ms, wall "
            f"{[round(x, 3) for x in r['wall_ms']]} ms, idle "
            f"{[round(x, 4) for x in r['idle']]}, tok/s "
            f"{[round(x, 2) for x in r['tok_s']]}")
    return res


def k7_weight_bytes(kept, cfg, esz: int, wplan: int):
    """(bytes, elements) of the weights K7 reads at the kept group counts
    `kept` [L, 4] (q|k|v, o, gate|up, down; MoE [L, 2 + 2k]: gate|up and
    down of each routed expert): each kept group's slab rows of the
    stage's weights once (arrays: esz bytes a weight; int8: 1, and each
    stage's per-channel scales once where it kept a group; packed int4:
    half a byte, and each kept group's [scale, zero] rows, 8 bytes a
    column)."""
    D, I, kvw = cfg.dim, cfg.intermediate_size, cfg.n_kv_heads * 128
    widths = (D + 2 * kvw, D) + (2 * I, D) * ((kept.shape[1] - 2) // 2)
    kept = kept.double().cpu()
    n = len(widths)
    elems = float(sum((kept[:, j] * 128 * widths[j]).sum() for j in range(n)))
    if wplan == 0:
        return elems * esz, elems
    if wplan == 1:
        return elems + float(sum(((kept[:, j] > 0).double() * 4
                                  * widths[j]).sum() for j in range(n))), elems
    return elems / 2 + float(sum((kept[:, j] * 8 * widths[j]).sum()
                                 for j in range(n))), elems


def k7_bound(sel, cfg, pos: int, esz: int, wplan: int = 0):
    """(bytes, flops) one K7 token must move and do at the kept counts of
    `sel` [L, 4, ...] (MoE: [L, 2 + 2k, ...]): the kept weights once
    (`k7_weight_bytes`), the live K/V rows read and the token's rows
    written, the gains, thresholds and the stream in and out, and (MoE)
    each layer's router [D, E] fp32 once; 2 flops a weight element read,
    4 a head and live row, 2 a router element."""
    D, kvw = cfg.dim, cfg.n_kv_heads * 128
    wbytes, elems = k7_weight_bytes(sel[:, :, 0], cfg, esz, wplan)
    live = min(pos, cfg.sliding_window - 1) if cfg.sliding_window else pos
    kv = cfg.n_layers * (2 * kvw * live + 2 * kvw) * esz
    router = cfg.n_layers * D * cfg.n_experts
    nbytes = (wbytes + kv + cfg.n_layers * (2 * D * esz + 28) + 2 * D * esz
              + 4 * router)
    flops = (2 * elems + 4 * cfg.n_layers * cfg.n_heads * 128 * (live + 1)
             + 2 * router)
    return nbytes, flops


def k7_times(params, cfg, device, seed, th, launches, err, wplan: int = 0):
    """K7 at the 7B's main step (pos 40 after a prefill of phase 4's first
    prompt, phase 4's thresholds, or a quantized copy's at the thresholds
    of its phase 8 hold; `wplan` 0 arrays, 1 int8, 2 packed int4): kernel
    ms (`cuda_ms`), its plain version's, the bound of this token's kept
    groups, the barrier floor (the empty K7: the same barriers, no work)
    and block 0's trace of the layer phases. Returns the `kernels`
    entry."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import token_block as tb

    dt = llama.compute_dtype(params)
    prompts = main_prompts(cfg, seed)
    rope = llama.precompute_rope(cfg, MAX_SEQ, device)
    cache, tok, pos = calibration_token(
        params, cfg, prompts[2], llama.KVCache.init(cfg, 1, MAX_SEQ, dt,
                                                    device), rope, device)
    caps = llama.token_path_caps(cfg, SparsityConfig(**MAIN_SP))
    lay = params["layers"]
    pos_t = torch.tensor([pos], dtype=torch.int32, device=device)
    args = (params["embed"][tok].to(dt), th, tuple(lay[n] for n in PROJ_NAMES),
            lay["attn_norm"], lay["mlp_norm"],
            llama._rope_rows(rope[0], rope[1], pos_t), cache.k, cache.v, pos_t)
    kw = dict(caps=caps, n_heads=cfg.n_heads, norm_eps=cfg.norm_eps,
              window=cfg.sliding_window)
    L = cfg.n_layers
    sel = torch.zeros((L, 4, 1 + max(caps)), dtype=torch.int32, device=device)
    stamps = tb.token_trace(args[0], cache.k, args[2], cfg.n_heads, caps,
                            cfg.sliding_window)
    plan = tb.token_plan(args[0], cache.k, args[2], cfg.n_heads, caps,
                         cfg.sliding_window)
    tb.token_kernel(*args, sel=sel, stamps=stamps, **kw)
    torch.cuda.synchronize()
    phases = tb.k7_phases(stamps)
    ms, _ = cuda_ms(lambda i: tb.token_kernel(*args, **kw), K7_TIME_ITERS)
    floor, _ = cuda_ms(lambda i: tb.token_kernel(*args, empty=True, **kw),
                       K7_TIME_ITERS)
    plain, _ = cuda_ms(lambda i: tb.token_kernel_plain(*args, **kw), 2,
                       warmup=1, queued=False)
    long = None
    if wplan == 0:
        # the same token at pos 2047 of a 2048-row cache of random rows:
        # attention walks 2047 rows a layer in chunks
        lp, lt = K7_LONG
        lc = rows_cache(cfg, 1, dt, device, torch.Generator(
            device=device).manual_seed(seed), T=lt)
        lrope = llama.precompute_rope(cfg, lt, device)
        lpos = torch.tensor([lp], dtype=torch.int32, device=device)
        largs = (*args[:5], llama._rope_rows(lrope[0], lrope[1], lpos),
                 lc.k, lc.v, lpos)
        long, _ = cuda_ms(lambda i: tb.token_kernel(*largs, **kw),
                          K7_TIME_ITERS)
        del lc, largs
        torch.cuda.empty_cache()
    nbytes, flops = k7_bound(sel, cfg, pos, llama.compute_dtype(
        params).itemsize, wplan)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")
    kept = sel[:, :, 0].float().mean(0).tolist()
    plan_name = ("bf16", "int8", "int4")[wplan] if dt == torch.bfloat16 \
        else "fp32"
    tag = "[k7]" if wplan == 0 else f"[k7 {plan_name}]"
    log(f"{tag} K7 at the 7B main step (pos {pos}, {plan_name}, 32 layers): "
        f"{ms:.4f} ms a token"
        + (f" ({long:.4f} ms at pos {K7_LONG[0]} of a {K7_LONG[1]}-row "
           "cache)" if long is not None else "")
        + f" (bound {bound:.4f} ms by {by}: "
        f"{nbytes / 1e6:.1f} MB, {ms and bound / ms:.1%} of it), plain {plain:.3f} ms, barrier "
        f"floor {floor:.4f} ms ({plan.grid_barriers} grid barriers, "
        f"{plan.head_barriers} kv-head; {plan.clusters} clusters of "
        f"{plan.C}, head-owned {plan.head_owned}); mean kept "
        f"{[round(k, 2) for k in kept]}; the trace, us summed over the "
        f"layers (block 0's phases: work/whole; spans; every block's "
        f"barrier arrivals): "
        + ", ".join(f"{k} {v[0]:.1f}/{v[1]:.1f}" if isinstance(v, tuple)
                    else f"{k} {v:.1f}" for k, v in phases.items()))
    return dict(name="token_kernel" if wplan == 0
                else f"token_kernel[{plan_name}]", route="cuda",
                source="teal_tpu_torch/csrc/token_decode"
                + (".cu" if wplan == 0 else "_quant.cu"),
                replaces="teal_tpu/ops/token_block.py:518",
                launches=launches, max_abs_err=err, ms=ms, kernel_ms=ms,
                plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=None, barrier_floor_ms=floor,
                ms_pos2047=long,
                phases_us=phases, kept_mean=kept, pos=pos,
                plan=plan._asdict(),
                timed=f"one 7B token (32 layers, {plan_name}) at pos "
                      f"{pos} at phase 4's thresholds; launches: the main "
                      "path's host-loop run of phase 18" if wplan == 0
                else f"one 7B token (32 layers, {plan_name} weights, bf16 "
                     f"stream) at pos {pos} at the thresholds of phase 8's "
                     f"hold; launches: phase 8's {plan_name} main-path "
                     "host-loop run")


def k7_quant(qp, cfg, device, gen, seed, th, plan_name: str):
    """Phase 8's K7 checks on one quantized copy of the 7B (Q8-main: int8,
    Q4-main: packed int4 at group 128; a bf16 stream), at the thresholds
    its loop path was held at (`th`): K7's plan in the wrapper equal to
    the kernel's (`check_k7_plan`); every one of the L layers through K7
    alone, on a one-layer slice, held to the plain layer on the same input
    (`hold_k7_layers`); each of 2 layers at pos 2047 of a 2048-row cache,
    and one 2-layer launch against `token_kernel_plain` (`k7_long_run`);
    phase 4's three prompts through K7 (one K7 and no K1-K6 launch a
    decoded token) and through the loop (`LOOP_SP`), agreement reported
    (`k7_tokens`); both decode graphs' nodes (one K7 node; 4 L K1 + L K2)
    and, in turns, a replay's device and wall ms, idle share and tok/s
    (`k7_graphs`); K7's kernel, plain, floor and bound times (`k7_times`).
    Returns (kernels entry, results)."""
    import torch

    from teal_tpu_torch.models import llama

    t0 = time.perf_counter()
    wplan = {"int8": 1, "int4": 2}[plan_name]
    tag = f"[k7 {plan_name}]"
    res = {"plans": check_k7_plan(wplan)}
    prompts = main_prompts(cfg, seed)
    rope = llama.precompute_rope(cfg, MAX_SEQ, device)
    cache, tok, pos = calibration_token(
        qp, cfg, prompts[0], llama.KVCache.init(cfg, 1, MAX_SEQ,
                                                torch.bfloat16, device),
        rope, device)
    worst, err, flips = hold_k7_layers(qp, cfg, cache, tok, pos, rope, th,
                                       device, tag=tag)
    res["layers"] = dict(worst=worst, max_abs_err=err, flips=flips, pos=pos)
    del cache
    res["long"] = k7_long_run(qp, cfg, device, gen, th,
                              tag=f"[k7 {plan_name} long]")
    res["tokens"], n7, gens = k7_tokens(qp, cfg, device, seed, th,
                                        fp32_cut=False, tag=tag)
    res["graphs"] = k7_graphs(gens, cfg, th, prompts, tag=tag)
    del gens
    torch.cuda.empty_cache()
    entry = k7_times(qp, cfg, device, seed, th, n7, err, wplan)
    res["phase_s"] = time.perf_counter() - t0
    log(f"{tag} K7's {plan_name} checks in {res['phase_s']:.1f} s")
    return entry, res


def k7_speculative(params, cfg, device, seed, th):
    """Self-speculation with the main path as its draft (`MAIN_SP`): a draft
    step is one K7 launch, a verify chunk one K7 launch too (its seq_block
    form, `block_verify`) and no K1-K6, the counts set to 0 just before
    and read just after."""
    import numpy as np

    prompt = main_prompts(cfg, seed)[1]
    reset_launches()
    _, st, wall = spec_run(params, cfg, prompt, 2 * SPEC_K, device, th, seed,
                           draft=MAIN_SP)
    got, n7 = read_launches(), k7_launches()
    rounds = len(np.asarray(st["accepted_per_step"]))
    want = (0,) * 6
    check(got == want and n7 == (SPEC_K + 1) * rounds, f"[k7] speculative, "
          f"K7 draft: launches (K1-K6) {got}, K7 {n7}; expected {want} and "
          f"{(SPEC_K + 1) * rounds} for {rounds} rounds of {SPEC_K} draft "
          "steps and a verify chunk")
    log(f"[k7] self-speculation with the K7 draft: {rounds} rounds, {n7} K7 "
        f"launches ({SPEC_K} draft steps and one verify chunk a round), no "
        f"K1-K6, {wall:.2f} s")
    return dict(rounds=rounds, k7_launches=n7, launches=got, wall_s=wall)


def k7_phase(params, cfg, device, gen, seed, th):
    """Phase 18 on the resident bf16 7B after phase 4, at its thresholds:
    K7's plan; every layer of K7 alone held to the plain path on phase 4's
    calibration token; a 2-layer run at pos 2047 of a 2048-row cache; the
    same holds on a 2-layer GQA 32/8 model at the 7B's width; a 2-layer
    int4 cut of llama-3-70b's widths at T 8192 (`k7_fault31`); the
    main path's tokens against the K1/K2 loop's (bf16 reported, an fp32
    cut gated) and its launches; both decode graphs' nodes and times in
    turns; K7's kernel, plain, bound and barrier-floor times; the K7 draft
    of self-speculation. Returns (kernels entry, results)."""
    import torch

    from teal_tpu_torch.models import llama

    t0 = time.perf_counter()
    res = {"plans": check_k7_plan()}
    dt = llama.compute_dtype(params)
    prompts = main_prompts(cfg, seed)
    rope = llama.precompute_rope(cfg, MAX_SEQ, device)
    cache, tok, pos = calibration_token(
        params, cfg, prompts[0], llama.KVCache.init(cfg, 1, MAX_SEQ, dt,
                                                    device), rope, device)
    worst, err, flips = hold_k7_layers(params, cfg, cache, tok, pos, rope,
                                       th, device)
    res["layers"] = dict(worst=worst, max_abs_err=err, flips=flips, pos=pos)
    del cache
    res["long"] = k7_long_run(params, cfg, device, gen, th)
    res["gqa"] = k7_gqa_hold(cfg, device, gen, th)
    res["fault31"] = k7_fault31(device, gen)
    res["tokens"], n7, gens = k7_tokens(params, cfg, device, seed, th)
    res["graphs"] = k7_graphs(gens, cfg, th, prompts)
    del gens
    torch.cuda.empty_cache()
    entry = k7_times(params, cfg, device, seed, th, n7, err)
    res["speculative"] = k7_speculative(params, cfg, device, seed, th)
    res["phase_s"] = time.perf_counter() - t0
    log(f"[k7] phase 18 in {res['phase_s']:.1f} s")
    return entry, res


# --- phase 19: K7's rows form; fault 3.1 (a plan that no longer grows
# with T) ------------------------------------------------------------------

K7_ROWS = (2, 8, 16)             # rows held at the 7B's width (bf16)
K7_ROWS_FP32 = 16                # rows of the fp32 hold on a 2-layer cut
K7_70B = ("llama-3-70b", 2, 8192)    # (config, layers of the cut, T)
K7_ROWS_TURNS = 3                # K7 / token_fused=False server steps


def row_positions(B: int):
    """The positions of a B-row step: row i at 40 + 4 i (as
    `STEP_BATCHES` steps and the server's first steps)."""
    return [40 + 4 * i for i in range(B)]


def check_k7_rows_plan():
    """K7's rows form's plan in the wrapper (`token_block._token_plan(...,
    rows=B)` on the card's resident clusters of the rows kernel) equal to
    the kernel's (`teal_token_plan_rows`) on this card, fp32 and bf16, at
    B = 2, 8 and 16: Llama-2-7B at T 512 and 4096, Mistral-7B (GQA 32/8,
    window 4096) at T 8192, llama-3-70b's widths at T 8192; each within
    shared memory."""
    import ctypes

    import torch

    from teal_tpu_torch import _build
    from teal_tpu_torch.ops import token_block as tb

    lib = _build.load()["token_decode_rows"]
    sms = _build.sm_count(0)
    dev = torch.device("cuda", 0)
    shapes = [(4096, 11008, 32, 32, 512, None, 43, 32),
              (4096, 11008, 32, 32, 4096, None, 43, 32),
              (4096, 14336, 32, 8, 8192, 4096, 56, 32),
              (8192, 28672, 64, 8, 8192, None, 112, 80)]
    plans = {}
    for D, I, Hq, Hkv, T, win, cm, L in shapes:
        for code, esz, dt in ((0, 4, torch.float32), (1, 2, torch.bfloat16)):
            for B in K7_ROWS:
                out = (ctypes.c_int * 11)()
                rc = lib.teal_token_plan_rows(code, B, D, I, Hq, Hkv, T,
                                              win or 0, cm, sms, L, out)
                want = tb._token_plan(
                    esz, D, I, Hq, Hkv, T, win, cm, L, sms,
                    tb.k7_clusters(dev, dt, Hq // Hkv, rows=True), rows=B)
                check(rc == 0 and want is not None
                      and tuple(out) == tuple(want)
                      and want.smem <= tb._SMEM_BYTES,
                      f"K7 rows plan {(B, D, I, Hq, Hkv, T, win, cm, L, esz)}"
                      f": kernel {rc} {list(out)}, wrapper {want}")
                plans[f"B{B}/{D}/{I}/{Hq}/{Hkv}/T{T}/{esz}B"] = list(out)
    log(f"[k7 rows] plan equal in the wrapper and the kernel for "
        f"{len(plans)} shapes on {sms} SMs; 7B bf16 B 16: "
        f"{plans['B16/4096/11008/32/32/T512/2B']}")
    return plans


def rows_cache(cfg, B, dt, device, gen, T=MAX_SEQ):
    """A [L, B, Hkv, T, 128] cache of random rows (a decode step's context
    at every position)."""
    import torch

    from teal_tpu_torch.models import llama

    shape = (cfg.n_layers, B, cfg.n_kv_heads, T, 128)
    return llama.KVCache(
        torch.randn(shape, generator=gen, device=device).to(dt),
        torch.randn(shape, generator=gen, device=device).to(dt))


def k7_rows_bound(sel, cfg, poss, esz: int, wplan: int = 0):
    """(bytes, flops) one step of K7's rows form must move and do at the
    kept counts of `sel` [L, 4, ...]: each kept slab read once for all
    rows (`k7_weight_bytes`), each row's live K/V rows read and its
    token's rows written, the gains and thresholds, the B rows of the
    stream in and out; 2 flops a weight element a row, 4 a head and live
    row."""
    D, kvw = cfg.dim, cfg.n_kv_heads * 128
    wbytes, elems = k7_weight_bytes(sel[:, :, 0], cfg, esz, wplan)
    lives = [min(p, cfg.sliding_window - 1) if cfg.sliding_window else p
             for p in poss]
    kv = cfg.n_layers * sum(2 * kvw * (lv + 1) for lv in lives) * esz
    B = len(poss)
    nbytes = (wbytes + kv + cfg.n_layers * (2 * D * esz + 28)
              + 2 * B * D * esz)
    flops = (2 * B * elems
             + 4 * cfg.n_layers * cfg.n_heads * 128 * sum(lv + 1
                                                          for lv in lives))
    return nbytes, flops


def k7_rows_times(params, cfg, device, gen, th, B=16):
    """K7's rows form on the resident 7B (bf16 arrays, or its int8 or
    packed-int4 copy) at B rows at `row_positions` on a cache of random
    rows, the server's (or the quantized path's) thresholds: kernel ms
    (`cuda_ms`), its plain version's, the bound of this step's kept groups
    (bytes at the HBM rate, the bf16 MMA's operations at the tensor cores'
    peak). Returns the `kernels` entry (launches filled in by the caller
    from the server's or the quantized path's run)."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import token_block as tb

    dt = llama.compute_dtype(params)
    poss = row_positions(B)
    cache = rows_cache(cfg, B, dt, device, gen)
    rope = llama.precompute_rope(cfg, MAX_SEQ, device)
    pos_t = torch.tensor(poss, dtype=torch.int32, device=device)
    caps = llama.token_path_caps(cfg, SparsityConfig(**MAIN_SP))
    lay = params["layers"]
    toks = torch.arange(7, 7 + B, device=device)
    args = (params["embed"][toks].to(dt), th,
            tuple(lay[n] for n in PROJ_NAMES), lay["attn_norm"],
            lay["mlp_norm"], llama._rope_rows(rope[0], rope[1], pos_t),
            cache.k, cache.v, pos_t)
    kw = dict(caps=caps, n_heads=cfg.n_heads, norm_eps=cfg.norm_eps,
              window=cfg.sliding_window)
    sel = torch.zeros((cfg.n_layers, 4, 1 + max(caps)), dtype=torch.int32,
                      device=device)
    tb.token_kernel(*args, sel=sel, **kw)
    plan = tb.token_plan(args[0], cache.k, args[2], cfg.n_heads, caps,
                         cfg.sliding_window)
    ms, _ = cuda_ms(lambda i: tb.token_kernel(*args, **kw), K7_TIME_ITERS)
    plain, _ = cuda_ms(lambda i: tb.token_kernel_plain(*args, **kw), 2,
                       warmup=1, queued=False)
    wplan = tb.k7_weight_plan(args[2])
    pname = ("bf16", "int8", "int4")[wplan]
    nbytes, flops = k7_rows_bound(sel, cfg, poss, dt.itemsize, wplan)
    bound, by = bound_ms(nbytes, flops)
    kept = sel[:, :, 0].float().mean(0).tolist()
    log(f"[k7 rows] K7's rows form, 7B {pname}, B = {B} at "
        f"{poss[0]}..{poss[-1]}, 32 "
        f"layers: {ms:.4f} ms a step (bound {bound:.4f} ms by {by}: "
        f"{nbytes / 1e6:.1f} MB, {bound / ms:.1%} of it), plain {plain:.3f} "
        f"ms; {plan.clusters} clusters of {plan.C}, head-owned "
        f"{plan.head_owned}, {plan.slots} ring slots; mean kept "
        f"{[round(k, 2) for k in kept]} of caps {list(caps)}")
    del cache
    torch.cuda.empty_cache()
    return dict(name="token_kernel[rows]" if wplan == 0
                else f"token_kernel[rows {pname}]", route="cuda",
                source="teal_tpu_torch/csrc/token_decode_rows"
                + (".cu" if wplan == 0 else "_quant.cu"),
                replaces="teal_tpu/ops/token_block.py:518", launches=0,
                max_abs_err=0.0, ms=ms, kernel_ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None, rows=B,
                positions=poss, kept_mean=kept, plan=plan._asdict(),
                timed=f"one 7B step (32 layers, {pname}) of {B} rows at "
                      f"positions {poss[0]}..{poss[-1]} on a cache of random "
                      + ("rows at the server's thresholds; launches: phase "
                         "9's one-shot server run" if wplan == 0 else
                         f"rows at the Q{8 if wplan == 1 else 4}-main-b16 "
                         "hold's thresholds; launches: its host-loop run"))


def k7_rows_holds(params, cfg, device, gen, th, fp32_cut: bool = True,
                  tag: str = "k7 rows"):
    """Every 7B layer of K7's rows form held to the plain path
    (`hold_k7_layers` with B rows, `explain_flip`'s rule for one-group
    flips) at B = 2, 8 and 16, row i at 40 + 4 i on a cache of random
    rows, at the thresholds `th`; then (`fp32_cut`) an fp32 copy of the
    first two layers at B = `K7_ROWS_FP32`. Returns {B: (worst, max abs
    err, flips)}."""
    import torch

    from teal_tpu_torch.models import llama

    rope = llama.precompute_rope(cfg, MAX_SEQ, device)
    dt = llama.compute_dtype(params)
    res = {}
    for B in K7_ROWS:
        cache = rows_cache(cfg, B, dt, device, gen)
        res[B] = hold_k7_layers(params, cfg, cache, list(range(7, 7 + B)),
                                row_positions(B), rope, th, device,
                                tag=f"[{tag} B {B}]")
        del cache
        torch.cuda.empty_cache()
    if not fp32_cut:
        return res
    ccfg = dataclasses.replace(cfg, n_layers=2)
    cut = to_fp32(dict(params, layers={k: v[:2] for k, v in
                                       params["layers"].items()}))
    B = K7_ROWS_FP32
    cache = rows_cache(ccfg, B, torch.float32, device, gen)
    res[f"fp32 B {B}"] = hold_k7_layers(
        cut, ccfg, cache, list(range(7, 7 + B)), row_positions(B), rope,
        th[:2].contiguous(), device, tag=f"[k7 rows fp32 B {B}]")
    del cut, cache
    torch.cuda.empty_cache()
    return res


# --- phases 8, 9 and 13: K7's quantized rows and its seq_block form --------

K7_VERIFY_QS = (5, 12)           # block_verify S held on the Q8 / Q4 copies
K7_VERIFY_S = 8                  # the verify chunk timed (one chunk)


def chunk_sizes(S: int):
    """`block_verify`'s chunks of S positions: ceil(S / 8) of balanced
    sizes (12 -> 6 + 6)."""
    n = -(-S // 8)
    return [S // n + (1 if j < S % n else 0) for j in range(n)]


def k7_verify_holds(params, cfg, cache, toks, pos: int, rope, device,
                    tag: str):
    """Every layer of each `block_verify` chunk of `toks` (S positions
    from `pos` of one sequence) through K7's seq_block form (fixed
    selection at full caps) held to the plain path (`hold_k7_layers(...,
    seq_block=True)`), each chunk on the plain path's cache after the
    chunks before it. Returns (worst relative error, worst absolute
    error)."""
    from teal_tpu_torch.models import llama

    zero = llama.zero_thresholds(cfg, device)
    kv, off, worst, err = (cache.k, cache.v), 0, 0.0, 0.0
    for ss in chunk_sizes(len(toks)):
        keep = {}
        w, e, _ = hold_k7_layers(
            params, cfg, llama.KVCache(*kv), toks[off:off + ss].tolist(),
            list(range(pos + off, pos + off + ss)), rope, zero, device,
            tag=f"{tag} chunk {pos + off}..{pos + off + ss - 1}",
            seq_block=True, keep=keep)
        kv, off = keep["cache"], off + ss
        worst, err = max(worst, w), max(err, e)
    return worst, err


def k7_quant_verify(qp, cfg, device, seed, rope, plan: str):
    """Phase 8's `block_verify` on a quantized copy (int8, or packed int4
    at group 128) after a prefill of 40 tokens, at S in `K7_VERIFY_QS`:
    every layer of each chunk held to the plain path through K7's
    seq_block form (`k7_verify_holds`), then one `block_verify` call with
    the counts set to 0 just before and read just after: ceil(S / 8) K7
    launches and no K1-K6, finite logits of the expected shape. Returns
    {S: results}."""
    import numpy as np
    import torch

    from teal_tpu_torch.models import llama

    rng = np.random.default_rng(seed + 9)
    cache, _, pos = prefill(qp, cfg, rng.integers(1, cfg.vocab_size,
                                                  (1, 40)), device, rope)
    zero = llama.zero_thresholds(cfg, device)
    out = {}
    for S in K7_VERIFY_QS:
        check(llama.can_block_verify(qp, cfg, S), f"{plan} S={S}: gate "
              "refused")
        toks = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                             (1, S))).to(device)
        worst, err = k7_verify_holds(qp, cfg, cache, toks[0], pos, rope,
                                     device, tag=f"[k7 verify {plan} S={S}]")
        c = llama.KVCache(cache.k.clone(), cache.v.clone())
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        lg, _ = llama.block_verify(qp, toks, c, pos, zero, cfg=cfg, rope=rope)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, n7 = read_launches(), k7_launches()
        n_chunks = len(chunk_sizes(S))
        check(got == (0,) * 6 and n7 == n_chunks, f"{plan} block_verify "
              f"S={S}: launches (K1, K2, K3, K4, K5, K6) {got} and {n7} K7, "
              f"expected none and {n_chunks}")
        check(tuple(lg.shape) == (1, S, cfg.vocab_size)
              and bool(torch.isfinite(lg).all()), f"{plan} S={S}: bad "
              "logits")
        out[S] = dict(worst=worst, max_abs_err=err, k7_launches=n7,
                      wall_ms=wall * 1e3)
        log(f"[k7 verify] {plan} S={S} at pos {pos} ({n_chunks} chunk(s) "
            f"{chunk_sizes(S)}): every layer of each chunk through K7's "
            f"seq_block form held to the plain path (worst {worst:.2e} of "
            f"scale, tolerance {K7_TOKEN_TOL}); {n7} K7 launches and none of "
            f"K1-K6; wall {wall * 1e3:.1f} ms")
        del c
    del cache
    torch.cuda.empty_cache()
    return out


def route_turns(call, want, turns: int, what: str):
    """K7 and the loop on one call in turns: `call(route)` runs the call
    through route "k7" or "loop"; the launch counts of one call of each
    (set to 0 just before, read just after) must be `want` {route:
    ((K1, K2, K3, K4, K5, K6), K7, K8)}; then `turns` turns of each: device ms
    (CUDA events around one call queued behind a sleep, `cuda_ms`), wall
    ms (host clock, synchronised) and idle share (1 - device / wall).
    Returns ({route: [reading, ...]}, the counts)."""
    import torch

    counts = {}
    for route in want:
        call(route)
        torch.cuda.synchronize()
        reset_launches()
        call(route)
        torch.cuda.synchronize()
        counts[route] = (read_launches(), k7_launches(), k8_launches())
    check(counts == want, f"K7 / loop turns ({what}): launches ((K1, K2, "
          f"K3, K4, K5, K6), K7, K8) {counts}, expected {want}")

    def reading(route):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            call(route)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 3
        dev, _ = cuda_ms(lambda i: call(route), 1, warmup=0)
        return dict(device_ms=dev, wall_ms=wall, idle_share=1 - dev / wall)
    return in_turns(tuple(want), turns, reading), counts


def k7_loop_turns(params, cfg, device, gen, th, B: int = 16,
                  seq: bool = False, turns: int = K7_ROWS_TURNS):
    """K7 and the K1/K2 loop on the same inputs, in turns: `token_decode`
    of B rows (token_fused unset: one K7 launch; token_fused=False: the
    host loop of 4 L K1 and L K2 launches, at one row of arrays or int4 L
    K8 and 3 L K1) at `row_positions` on a cache
    of random rows at thresholds `th`, or with `seq` a verify chunk (B
    consecutive positions from 40 of one sequence, fixed selection at full
    caps, seq_block). The launch counts of one call of each (set to 0 just
    before, read just after) are checked; then `turns` turns of each:
    device ms, wall ms (host clock, synchronised) and idle share (1 -
    device / wall) a call. Both routes' device ms come from the same
    tool: CUDA events around one call queued behind a sleep (`cuda_ms`),
    so the device runs the call's launches back to back (K7: its launch
    and the workspace's memset; the loop: its 5 L launches and the gaps
    between them on the device, not the host's). Returns the results (the
    loop's launches of one call under "loop_launches")."""
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import token_block as tb

    L, dt = cfg.n_layers, llama.compute_dtype(params)
    poss = list(range(40, 40 + B)) if seq else row_positions(B)
    cache = rows_cache(cfg, 1 if seq else B, dt, device, gen)
    rope = llama.precompute_rope(cfg, MAX_SEQ, device)
    pos_t = torch.tensor(poss, dtype=torch.int32, device=device)
    caps = ((cfg.dim // 128,) * 3 + (cfg.intermediate_size // 128,) if seq
            else llama.token_path_caps(cfg, SparsityConfig(**MAIN_SP)))
    if seq:
        th = llama.zero_thresholds(cfg, device)
    lay = params["layers"]
    h = params["embed"][torch.arange(7, 7 + B, device=device)].to(dt)
    args = (h, th, tuple(lay[n] for n in PROJ_NAMES), lay["attn_norm"],
            lay["mlp_norm"], llama._rope_rows(rope[0], rope[1], pos_t),
            cache.k, cache.v, pos_t)
    kw = dict(caps=caps, n_heads=cfg.n_heads, norm_eps=cfg.norm_eps,
              window=cfg.sliding_window, fixed_sel=seq, seq_block=seq)
    routes = {"k7": None, "loop": False}

    def call(route):
        return tb.token_decode(*args, token_fused=routes[route], **kw)
    one_row = B == 1 and not seq and tb.k7_weight_plan(args[2]) != 1
    loop = ((tuple(n * L for n in LOOP_ROW), 0, L) if one_row
            else ((4 * L, L, 0, 0, 0, 0), 0, 0))
    out, counts = route_turns(
        call, {"k7": ((0,) * 6, 1, 0), "loop": loop},
        turns, f"B={B}, seq {seq}")
    loop_name = "L K8 + 3L K1" if one_row else "4L K1 + L K2"
    what = (f"verify chunk S={B} at {poss[0]}.." if seq else
            f"B={B} step at {poss[0]}..{poss[-1]}")
    pname = ("bf16", "int8", "int4")[tb.k7_weight_plan(args[2])]
    for route, rs in out.items():
        log(f"[k7 turns] 7B {pname} {what}, {route} "
            f"({'one K7 launch' if route == 'k7' else loop_name}), in "
            f"turns: device {[round(r['device_ms'], 4) for r in rs]} ms, "
            f"wall {[round(r['wall_ms'], 3) for r in rs]} ms, idle "
            f"{[round(r['idle_share'], 4) for r in rs]}")
    del cache, args
    torch.cuda.empty_cache()
    return dict(rows=B, seq_block=seq, positions=poss, turns=out,
                loop_launches=counts["loop"][0])


def k7_seq_bound(cfg, pos0: int, S: int, esz: int, wplan: int = 0):
    """(bytes, flops) one verify chunk of S positions from pos0 through
    K7's seq_block form must move and do at full caps: every weight read
    once (`k7_weight_bytes` at every group), the sequence's cache rows
    [lo, pos0 + S - 1) read once and its S new rows written, the gains and
    thresholds, S rows of the stream in and out; 2 flops a weight element
    a row, 4 a head and live row of each row."""
    import torch

    D, I, kvw = cfg.dim, cfg.intermediate_size, cfg.n_kv_heads * 128
    full = torch.tensor([[D // 128] * 3 + [I // 128]] * cfg.n_layers)
    wbytes, elems = k7_weight_bytes(full, cfg, esz, wplan)
    last = pos0 + S - 1
    lo = max(pos0 - cfg.sliding_window + 1, 0) if cfg.sliding_window else 0
    kv = 2 * kvw * ((last - lo) + S) * esz
    nbytes = (wbytes + cfg.n_layers * (kv + 2 * D * esz + 28)
              + 2 * S * D * esz)
    lives = [min(p, cfg.sliding_window - 1) if cfg.sliding_window else p
             for p in range(pos0, pos0 + S)]
    flops = (2 * S * elems
             + cfg.n_layers * 4 * cfg.n_heads * 128 * sum(lv + 1
                                                        for lv in lives))
    return nbytes, flops


def k7_seq_times(params, cfg, device, gen, launches: int, steps: int,
                 err: float, S: int = K7_VERIFY_S):
    """K7's seq_block form on the resident 7B (bf16): one verify chunk of
    S positions from 40 of one sequence on a cache of random rows (fixed
    selection at full caps): kernel ms (`cuda_ms`), its plain version's,
    the bound (`k7_seq_bound`). Returns the `kernels` entry (launches:
    phase 9's `block_verify` runs)."""
    import torch

    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import token_block as tb

    dt = llama.compute_dtype(params)
    poss = list(range(40, 40 + S))
    cache = rows_cache(cfg, 1, dt, device, gen)
    rope = llama.precompute_rope(cfg, MAX_SEQ, device)
    pos_t = torch.tensor(poss, dtype=torch.int32, device=device)
    caps = (cfg.dim // 128,) * 3 + (cfg.intermediate_size // 128,)
    lay = params["layers"]
    args = (params["embed"][torch.arange(7, 7 + S, device=device)].to(dt),
            llama.zero_thresholds(cfg, device),
            tuple(lay[n] for n in PROJ_NAMES), lay["attn_norm"],
            lay["mlp_norm"], llama._rope_rows(rope[0], rope[1], pos_t),
            cache.k, cache.v, pos_t)
    kw = dict(caps=caps, n_heads=cfg.n_heads, norm_eps=cfg.norm_eps,
              window=cfg.sliding_window, fixed_sel=True, seq_block=True)
    plan = tb.token_plan(args[0], cache.k, args[2], cfg.n_heads, caps,
                         cfg.sliding_window)
    ms, _ = cuda_ms(lambda i: tb.token_kernel(*args, **kw), K7_TIME_ITERS)
    plain, _ = cuda_ms(lambda i: tb.token_kernel_plain(*args, **kw), 2,
                       warmup=1, queued=False)
    nbytes, flops = k7_seq_bound(cfg, poss[0], S, dt.itemsize)
    bound, by = bound_ms(nbytes, flops)
    log(f"[k7 seq] K7's seq_block form, 7B bf16, a verify chunk of S = {S} "
        f"at {poss[0]}..{poss[-1]} (full caps, 32 layers): {ms:.4f} ms "
        f"(bound {bound:.4f} ms by {by}: {nbytes / 1e6:.1f} MB, "
        f"{bound / ms:.1%} of it), plain {plain:.3f} ms; {plan.clusters} "
        f"clusters of {plan.C}, head-owned {plan.head_owned}, {plan.slots} "
        "ring slots")
    del cache, args
    torch.cuda.empty_cache()
    return dict(name="token_kernel[seq_block]", route="cuda",
                source="teal_tpu_torch/csrc/token_decode_rows.cu",
                replaces="teal_tpu/ops/token_block.py:518",
                launches=launches, launches_per_chunk=launches / steps,
                max_abs_err=err, ms=ms, kernel_ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None, rows=S,
                positions=poss, plan=plan._asdict(),
                timed=f"one 7B verify chunk (32 layers, bf16) of S = {S} "
                      f"positions {poss[0]}..{poss[-1]} of one sequence, "
                      "full caps, on a cache of random rows; launches: "
                      "phase 9's block_verify runs")


def k7_fault31(device, gen):
    """Fault 3.1 on the card: a 2-layer cut of llama-3-70b's widths (64/8
    heads, D 8192, I 28672; random bf16 weights quantized to packed int4
    at group 128) decodes at pos T - 1 of a T = 8192-row cache of random
    rows through K7 (which had no plan at T 8192 before its attention
    walked the cache in chunks): its plan in the wrapper equal to the
    kernel's, each layer held to the plain path (`hold_k7_layers`), the
    route (`k7_route`) K7, and one 2-layer launch against the K1/K8 loop
    (`token_decode(token_fused=False)`: L K8 + 3 L K1) on the same input,
    output and
    cache within `K7_TOKEN_TOL` of scale where both keep the same groups.
    Thresholds 0 keep each stage's first `cap` groups. Returns the
    results."""
    import ctypes

    import torch

    from teal_tpu_torch import _build
    from teal_tpu_torch.config import SparsityConfig, get_model_config
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import quant
    from teal_tpu_torch.ops import token_block as tb

    t0 = time.perf_counter()
    name, L, T = K7_70B
    cfg = dataclasses.replace(get_model_config(name), n_layers=L)
    params = llama.init_params(cfg, gen, torch.bfloat16, device)
    qp = quant.pack_int4_params(quant.quantize_params_int4(params, 128), 128)
    del params
    torch.cuda.empty_cache()
    cache = rows_cache(cfg, 1, torch.bfloat16, device, gen, T=T)
    th = torch.zeros((L, 7), device=device)
    pos = T - 1
    lay = qp["layers"]
    ws = tuple(lay[n] for n in PROJ_NAMES)
    caps = llama.token_path_caps(cfg, SparsityConfig(**MAIN_SP))
    h = qp["embed"][7].to(torch.bfloat16)
    want = tb.token_plan(h, cache.k, ws, cfg.n_heads, caps)
    out = (ctypes.c_int * 11)()
    rc = _build.load()["token_decode_quant"].teal_token_plan_q(
        2, cfg.dim, cfg.intermediate_size, cfg.n_heads, cfg.n_kv_heads, T, 0,
        max(caps), _build.sm_count(0), L, 0, 0, out)
    check(rc == 0 and want is not None and tuple(out) == tuple(want),
          f"[k7 70b] plan: kernel {rc} {list(out)}, wrapper {want}")
    check(tb.k7_route(h, ws, cache.k, cfg.n_heads, caps),
          "[k7 70b] the route does not take K7")
    rope = llama.precompute_rope(cfg, T, device)
    worst, err, flips = hold_k7_layers(qp, cfg, cache, 7, pos, rope, th,
                                       device, tag="[k7 70b int4]")
    pos_t = torch.tensor([pos], dtype=torch.int32, device=device)
    rows = llama._rope_rows(rope[0], rope[1], pos_t)
    kw = dict(caps=caps, n_heads=cfg.n_heads, norm_eps=cfg.norm_eps)
    sel = torch.zeros((L, 4, 1 + max(caps)), dtype=torch.int32,
                      device=device)
    caches = [(cache.k.clone(), cache.v.clone()) for _ in range(2)]
    reset_launches()
    got = tb.token_kernel(h, th, ws, lay["attn_norm"], lay["mlp_norm"], rows,
                          *caches[0], pos_t, sel=sel, **kw)
    loop = tb.token_decode(h, th, ws, lay["attn_norm"], lay["mlp_norm"],
                           rows, *caches[1], pos_t, token_fused=False, **kw)
    torch.cuda.synchronize()
    n7, n12, n8 = k7_launches(), read_launches()[:2], k8_launches()
    check(n7 == 1 and n12 == (3 * L, 0) and n8 == L, f"[k7 70b] launches: "
          f"K7 {n7}, (K1, K2) {n12}, K8 {n8}; expected 1, {(3 * L, 0)} and "
          f"{L}")
    e = rel_check("[k7 70b int4] 2 layers: K7 vs the K1/K8 loop", got, loop,
                  K7_TOKEN_TOL)
    for i, what in enumerate(("k", "v")):
        rel_check(f"[k7 70b int4] {what} cache: K7 vs the loop",
                  caches[0][i], caches[1][i], K7_TOKEN_TOL)
    ms, _ = cuda_ms(lambda i: tb.token_kernel(
        h, th, ws, lay["attn_norm"], lay["mlp_norm"], rows, *caches[0],
        pos_t, **kw), K7_TIME_ITERS)
    res = dict(config=name, layers=L, T=T, pos=pos, plan=want._asdict(),
               layer_worst=worst, max_abs_err=err, flips=flips,
               loop_err=e, ms=ms, kept=sel[:, :, 0].tolist(),
               phase_s=time.perf_counter() - t0)
    log(f"[k7 70b int4] {name}'s widths, {L} layers, pos {pos} of T {T}: "
        f"plan {tuple(want)}; each layer held to the plain path (worst "
        f"{worst:.2e} of scale), one launch within {e:.3e} of the K1/K8 loop;"
        f" {ms:.4f} ms a token ({res['phase_s']:.1f} s)")
    del qp, cache, caches
    torch.cuda.empty_cache()
    return res


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

    def mark(what: str) -> None:
        log(f"[phase] {what} done at {time.perf_counter() - t_start:.1f} s")
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
    e8 = check_k8(cfg, device, gen)
    mark("2, 3 and 21")
    e_loop = (check_k1_groups(params, cfg, device, gen),
              check_k3(params, cfg, device, gen),
              check_k4(params, cfg, device, gen))
    launches, speeds, th = end_to_end(params, cfg, caps, device, seed)
    log(f"[e2e] decode tok/s (prompt 40, 32 new tokens, Python loop, no "
        f"CUDA graph): dense {speeds['dense']} sparse {speeds['sparse']} "
        f"on {card}")
    graphs = device_loop_phase(params, cfg, device, seed, th)
    mark("4 and 17")
    k7_entry, k7_res = k7_phase(params, cfg, device, gen, seed, th)
    mark("18")
    loop = loop_paths(params, cfg, device, seed, rope)
    mark("6")
    step = time_decode_step(
        params, cfg, [("sparse", LOOP_SP, 1, th), ("dense", {}, 1, th)]
        + [(f"path {n}", sp_kw, b, loop[n]["th"])
           for n, (sp_kw, b) in LOOP_PATHS.items()], device, rope)
    with plain_path():          # row 2's plain version: one plain step
        step.update(time_decode_step(
            params, cfg, [("sparse, plain kernels", LOOP_SP, 1, th)],
            device, rope))
    bench = p16_bench_step(params, cfg, th, device, rope, step)
    line = time_kernels(params, cfg, caps, device, gen, rope, launches,
                        (e1, e2))
    line["kernels"] += time_loop_kernels(params, cfg, device, gen, loop,
                                         e_loop)
    line["kernels"].append(time_k8(
        params, cfg, device, gen,
        {"loop": launches[2:], "B": (loop["B"]["k8_launches"],
                                     loop["B"]["steps"])}, e8))
    line["kernels"].append(k7_entry)
    line["k7"] = k7_res
    line["lm_head_ms"] = time_lm_head(params, cfg, device, gen)
    line["decode_tok_s"] = speeds
    line["decode_tok_s_loop_paths"] = {n: r["tok_s"] for n, r in loop.items()}
    line["device_loop"] = graphs
    line["device_loop"].update({f"path {n}": r.pop("graph")
                                for n, r in loop.items()})
    line["decode_step_ms"] = step
    mark("7")
    b_entries, line["batched"], _ = batched_phase(params, cfg, caps, device,
                                                  gen, seed, rope)
    line["kernels"] += b_entries
    mark("9, 19 and 20")
    q_entries, q_runs, q_extra = quant_paths(params, cfg, caps, device, gen,
                                             seed, rope)
    line["kernels"] += q_entries
    line["decode_tok_s_quant_paths"] = {n: r["tok_s"]
                                        for n, r in q_runs.items()}
    line["device_loop"].update({n: r.pop("graph") for n, r in q_runs.items()})
    line["k7"].update(q_extra.pop("k7"))
    line["quant"] = q_extra
    mark("8 and 20")
    l_entries, line["long_prompts"] = long_prompt_phase(params, cfg, device,
                                                        gen, seed, th)
    line["kernels"] += l_entries
    mark("11")
    line["calibration"] = calibration_phase(params, cfg, device, seed)
    mark("12")
    line["speculative"] = speculative_phase(params, cfg, device, seed, th,
                                            speeds)
    mark("13")
    line["cli"] = cli_phase(device)
    mark("14")
    # phase 10 needs the card's memory for int8 Mixtral-8x7B (46 GB)
    del params
    torch.cuda.empty_cache()
    m_entries, line["moe"] = moe_phase(device, gen, seed)
    line["device_loop"].update({f"moe {p}": r.pop("graph")
                                for p, r in line["moe"].items()
                                if isinstance(r, dict) and "graph" in r})
    line["kernels"] += m_entries
    mark("10")
    p_entries, line["parallel"] = parallel_phase(device, gen, seed, card)
    line["kernels"] += p_entries
    mark("15")
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
