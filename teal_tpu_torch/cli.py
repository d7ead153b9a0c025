"""Unified CLI of the port: `python -m teal_tpu_torch.cli <command>`.

Port of `teal_tpu/cli.py`, with its subcommands, flags and defaults:
  generate   text generation (dense, sparse, speculative)
  calibrate  activation capture -> histograms (+ layer inputs)
  greedyopt  block-wise greedy per-layer sparsity allocation
  ppl        sliding-window perplexity, dense vs sparse
  eval       lm-eval tasks (the real `lm_eval`, or `--task-file` JSON
             through the shim)
  quantize   int8 / int4 / int4-gptq native checkpoint
  convert    HF safetensors -> native parameter store
(`accuracy-map`, which renders the TPU bench's files, is not ported.)

Model weights come from --checkpoint (an HF safetensors dir or a native
store, written by either package); without one, --random-init draws a
random model of the named architecture on the device from a
`torch.Generator` seeded with --seed. One flag is the port's own:
--device {cuda,cpu} (default cuda) says where the model runs. There is
no fallback: without a card, `cuda` fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _load_model(args, dtype=None):
    import torch

    from teal_tpu_torch.config import get_model_config
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.utils import checkpoint

    overrides = {}
    if getattr(args, "n_layers", None):
        overrides["n_layers"] = args.n_layers
    cfg = get_model_config(args.model, **overrides)
    dtype = dtype or (torch.float32 if args.fp32 else torch.bfloat16)
    device = llama._device(args.device)
    if args.checkpoint:
        if os.path.exists(os.path.join(args.checkpoint, "meta.json")):
            params = checkpoint.load_params(args.checkpoint, device)
            # int4 checkpoints ({"q","scale","zero"} leaves) repack to the
            # kernel layout when the block decode kernel will run, so the
            # gather reads packed nibbles
            layers = params.get("layers", {})
            has_int4 = any(isinstance(v, dict) and "zero" in v
                           for v in layers.values())
            if has_int4 and getattr(args, "kernel", None) == "block":
                from teal_tpu_torch.ops.quant import pack_int4_params

                params = pack_int4_params(
                    params, getattr(args, "block_size", 32) or 32)
        else:
            params = checkpoint.load_hf_checkpoint(args.checkpoint, cfg,
                                                   dtype, device)
    elif args.random_init:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = llama.init_params(cfg, gen, dtype, device)
    else:
        raise SystemExit("need --checkpoint or --random-init")
    return cfg, params


def _thresholds(args, cfg):
    """[n_layers, 7] thresholds (numpy fp32) from the flag combination:
    elementwise vs --group-thresholds (group-score scale), uniform vs
    --greedy (per-layer schedule from lookup CSVs)."""
    import numpy as np

    from teal_tpu_torch.calibration import thresholds_for_uniform
    from teal_tpu_torch.calibration.thresholds import (
        group_thresholds_for_greedy,
        group_thresholds_for_uniform,
        thresholds_for_greedy,
    )

    if not args.hist_path or args.sparsity == 0:
        return np.zeros((cfg.n_layers, 7), np.float32)
    group = getattr(args, "group_thresholds", False)
    if (group and getattr(args, "mode", None) != "group"
            and getattr(args, "kernel", None) != "block"):
        # group-score thresholds are on a different scale than the
        # elementwise |x| > t rule: applying them through mode="teal"
        # would silently over-sparsify (group max-|x| >> elementwise t)
        sys.exit(
            "error: --group-thresholds produces GROUP-SCORE thresholds; "
            "combine it with --mode group (accuracy path) or "
            "--kernel block (fast path), not the elementwise rule."
        )
    greedy = getattr(args, "greedy", False)
    bs = getattr(args, "block_size", 32)
    teal_root = os.path.dirname(args.hist_path.rstrip("/"))
    if group and greedy:
        return group_thresholds_for_greedy(teal_root, cfg, args.sparsity, bs)
    if group:
        return group_thresholds_for_uniform(
            args.hist_path, cfg, args.sparsity, group_size=bs
        )
    if greedy:
        return thresholds_for_greedy(teal_root, cfg, args.sparsity)
    return thresholds_for_uniform(args.hist_path, cfg, args.sparsity)


def _keep_fracs(args, cfg):
    """Static gather capacities for the block kernel. Threshold mode gets
    a margin over the target keep fraction (survivor counts vary per
    token); greedy threshold mode bounds the per-layer schedule."""
    from teal_tpu_torch.calibration.thresholds import (
        capacity_fracs_for_greedy)

    if not getattr(args, "group_thresholds", False):
        return None, 1.0 - args.sparsity
    if getattr(args, "greedy", False) and args.hist_path:
        lookup = os.path.join(
            os.path.dirname(args.hist_path.rstrip("/")), "lookup"
        )
        return capacity_fracs_for_greedy(lookup, cfg, args.sparsity), None
    return None, min(1.0, (1.0 - args.sparsity) * 1.25)


def _warn_dropped_thresholds(args):
    """A user who supplies --hist-path with the block kernel but not
    --group-thresholds gets pure top-k selection: elementwise thresholds
    are on a different scale than group scores and are intentionally not
    applied (warn instead of silently dropping)."""
    if (args.hist_path and getattr(args, "kernel", None) == "block"
            and not getattr(args, "group_thresholds", False)
            and not getattr(args, "greedy", False)):
        print(
            "warning: block kernel without --group-thresholds runs pure "
            "top-k selection at the requested sparsity; the calibrated "
            "elementwise thresholds from --hist-path are NOT applied. "
            "Pass --group-thresholds (with group-score histograms) to use "
            "calibrated thresholds.",
            file=sys.stderr,
        )


def _device_thresholds(args, cfg):
    """`_thresholds` as an fp32 tensor on the model's device."""
    import torch

    return torch.from_numpy(_thresholds(args, cfg)).to(args.device)


def cmd_generate(args):
    import numpy as np
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine import Generator
    from teal_tpu_torch.utils import profiling
    from teal_tpu_torch.utils.tokenizer import get_tokenizer

    cfg, params = _load_model(args)
    tok = get_tokenizer(args.tokenizer or args.checkpoint)

    _warn_dropped_thresholds(args)
    keep_fracs, keep_frac = _keep_fracs(args, cfg)
    sp = SparsityConfig(enabled=args.sparsity > 0, kernel=args.kernel,
                        block_size=args.block_size,
                        block_keep_frac=(0.625 if keep_frac is None
                                         else keep_frac),
                        block_keep_fracs=keep_fracs,
                        block_thresholding=args.group_thresholds)
    thresholds = _device_thresholds(args, cfg)

    if args.speculate_k > 0:
        return _generate_speculative(args, cfg, params, tok, sp, thresholds)

    gen = Generator(cfg, params, sp=sp, max_seq=args.max_seq,
                    temperature=args.temperature, top_k=args.top_k,
                    device=args.device)

    def run_samples(prompt: str):
        ids = tok.encode(prompt, bos=True)
        if args.num_samples > 1 or args.profile:
            gen.warmup(prompt_len=len(ids))
        for i in range(args.num_samples):
            # profile only the last sample (reference generate.py:460-485)
            profiling_last = args.profile and i == args.num_samples - 1
            with profiling.trace(args.profile if profiling_last else None):
                out, stats = gen.generate(
                    np.asarray(ids), args.max_new_tokens,
                    thresholds=thresholds,
                    generator=torch.Generator(device=args.device)
                    .manual_seed(args.seed + i),
                )
            text = tok.decode(out[0][len(ids):])
            print(text)
            print(
                f"[{stats.new_tokens} tokens, {stats.tokens_per_s:.2f} tok/s, "
                f"{stats.bandwidth_gb_s:.1f} GB/s, "
                f"prefill {stats.prefill_s * 1e3:.0f} ms]",
                file=sys.stderr,
            )
            if args.metrics:
                profiling.write_metrics(args.metrics, {
                    "model": args.model,
                    "sparsity": args.sparsity,
                    "kernel": args.kernel,
                    "sample": i,
                    "new_tokens": stats.new_tokens,
                    "tokens_per_s": stats.tokens_per_s,
                    "bandwidth_gb_s": stats.bandwidth_gb_s,
                    "prefill_s": stats.prefill_s,
                    **profiling.device_memory_stats(args.device),
                })

    if args.interactive:
        # reference --interactive chat loop (generate.py:168-169,381-383)
        while True:
            try:
                prompt = input("prompt> ")
            except EOFError:
                break
            if prompt.strip() in ("quit", "exit"):
                break
            run_samples(prompt)
    else:
        run_samples(args.prompt)


def _generate_speculative(args, cfg, params, tok, sp, thresholds):
    """--speculate-k path: the draft proposes, the target verifies
    (reference generate.py:98-146,528-558 CLI surface). --profile traces
    the last sample (the reference's speculative path ignores it)."""
    import numpy as np
    import torch

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.engine.speculative import speculative_generate
    from teal_tpu_torch.utils import profiling

    if args.self_speculate:
        # self-speculation: the draft IS the target's weights decoded
        # through the block-sparse kernel; the dense verify makes the
        # output distribution exactly the dense model's
        if args.draft_sparsity <= 0:
            args.draft_sparsity = 0.5
        draft_cfg, draft_params = cfg, params
    else:
        if not (args.draft_checkpoint or args.draft_model):
            raise SystemExit("--speculate-k needs --draft-checkpoint, "
                             "--draft-model (with --random-init), or "
                             "--self-speculate")

        class _DraftArgs:
            model = args.draft_model or args.model
            checkpoint = args.draft_checkpoint
            random_init = args.random_init and not args.draft_checkpoint
            seed = args.seed + 99
            fp32 = args.fp32
            n_layers = None
            kernel = args.kernel
            block_size = args.block_size
            device = args.device

        draft_cfg, draft_params = _load_model(_DraftArgs)
    draft_sp = SparsityConfig(
        enabled=args.draft_sparsity > 0,
        kernel=args.kernel if not args.self_speculate else "block",
        block_size=args.block_size,
        block_keep_frac=1.0 - args.draft_sparsity,
        # threshold selection (zero thresholds + capacity) keeps the
        # draft on the token path
        block_thresholding=args.self_speculate,
    )
    ids = tok.encode(args.prompt, bos=True)
    for i in range(args.num_samples):
        profiling_last = args.profile and i == args.num_samples - 1
        t0 = time.time()
        with profiling.trace(args.profile if profiling_last else None):
            out, stats = speculative_generate(
                params, draft_params, cfg, draft_cfg, np.asarray(ids),
                args.max_new_tokens, speculate_k=args.speculate_k,
                temperature=args.temperature, top_k=args.top_k,
                max_seq=args.max_seq, target_sp=sp, draft_sp=draft_sp,
                target_thresholds=thresholds,
                draft_thresholds=thresholds if args.self_speculate else None,
                generator=torch.Generator(device=args.device)
                .manual_seed(args.seed + i),
                device_loop=args.device_loop, device=args.device,
            )
        dt = time.time() - t0
        print(tok.decode(out[len(ids):]))
        tps = stats["new_tokens"] / dt if dt > 0 else 0.0
        print(
            f"[speculative k={args.speculate_k}: {stats['new_tokens']} "
            f"tokens, {tps:.2f} tok/s (incl. kernel load on sample 0), "
            f"mean accepted {stats['mean_accepted']:.2f}]",
            file=sys.stderr,
        )
        if args.metrics:
            profiling.write_metrics(args.metrics, {
                "model": args.model, "speculate_k": args.speculate_k,
                "sample": i, "new_tokens": stats["new_tokens"],
                "tokens_per_s": tps,
                "mean_accepted": stats["mean_accepted"],
            })


def cmd_calibrate(args):
    import numpy as np

    from teal_tpu_torch.calibration import calibrate
    from teal_tpu_torch.calibration.thresholds import model_group_sizes
    from teal_tpu_torch.utils.data import get_token_stream
    from teal_tpu_torch.utils.tokenizer import get_tokenizer

    cfg, params = _load_model(args)
    tok = get_tokenizer(args.tokenizer or args.checkpoint)
    n = args.batch * args.seq_len
    ids = get_token_stream(
        tok, text_file=args.text_file, dataset=args.dataset,
        vocab_size=cfg.vocab_size, n_tokens=n, seed=args.seed,
    )
    ids = np.mod(ids, cfg.vocab_size)
    ids = (list(ids) * (n // max(len(ids), 1) + 1))[:n]
    tokens = np.asarray(ids).reshape(args.batch, args.seq_len)
    if args.group_sizes:
        group_sizes = tuple(int(x) for x in args.group_sizes.split(","))
    else:
        # default: every group size the block kernel will actually use at
        # runtime for this model (deep input dims double the group size)
        group_sizes = tuple(sorted(set(model_group_sizes(cfg)) | {32}))
    calibrate(params, cfg, tokens, args.output_path,
              save_layer_inputs=not args.no_layer_inputs,
              group_sizes=group_sizes, progress=True)
    print(f"calibration artifacts written to {args.output_path}")


def cmd_greedyopt(args):
    from teal_tpu_torch.calibration.greedyopt import run_greedy

    cfg, params = _load_model(args)
    layers = None
    if args.layers:
        layers = [int(x) for x in args.layers.split(",")]
    run_greedy(params, cfg, args.teal_path,
               target_sparsity=args.target_sparsity,
               base_step_size=args.base_step_size,
               last_fraction=args.last_fraction,
               layers=layers, progress=True)


def cmd_ppl(args):
    import numpy as np

    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.eval.ppl import eval_ppl
    from teal_tpu_torch.utils.data import get_token_stream
    from teal_tpu_torch.utils.tokenizer import get_tokenizer

    cfg, params = _load_model(args)
    tok = get_tokenizer(args.tokenizer or args.checkpoint)
    ids = get_token_stream(
        tok, text_file=args.text_file, dataset=args.dataset,
        vocab_size=cfg.vocab_size, n_tokens=args.num_tokens, seed=args.seed,
    )
    ids = np.mod(ids, cfg.vocab_size)

    if args.permute:
        from teal_tpu_torch.calibration.permute import (
            apply_permutations, compute_permutations,
        )

        n_cal = min(len(ids), 2048)
        cal_tokens = np.asarray(ids[:n_cal]).reshape(1, n_cal)
        params = apply_permutations(
            params,
            compute_permutations(
                params, cfg, cal_tokens, method=args.permute_method,
                block_size=args.block_size, sparsity=args.sparsity or 0.5,
            ),
            cfg,
        )

    dense = eval_ppl(params, cfg, ids, context_size=args.context_size,
                     window_size=args.window_size, device=args.device)
    print(f"dense ppl: {dense:.4f}")
    if args.sparsity > 0:
        _warn_dropped_thresholds(args)
        keep_fracs, keep_frac = _keep_fracs(args, cfg)
        sp = SparsityConfig(
            enabled=True, apply_prefill=True, mode=args.mode,
            kernel=args.kernel, block_size=args.block_size,
            block_keep_frac=(0.625 if keep_frac is None else keep_frac),
            block_keep_fracs=keep_fracs,
            block_thresholding=args.group_thresholds,
        )
        th = _device_thresholds(args, cfg)
        sparse = eval_ppl(params, cfg, ids, sp=sp, thresholds=th,
                          context_size=args.context_size,
                          window_size=args.window_size, device=args.device)
        print(f"sparse ppl @ {args.sparsity} (mode={args.mode}): "
              f"{sparse:.4f} (delta {sparse - dense:+.4f})")


def cmd_eval(args):
    """Run lm-eval tasks against a dense or sparse model configuration
    (reference `gpt-fast/eval.py:154-254`). With the real `lm_eval`
    installed, `--tasks` are harness task names; otherwise tasks come
    from `--task-file` JSON ({"name", "type": "multiple_choice"|
    "generate", "docs": [...]}) run through the shim's evaluator."""
    from teal_tpu_torch.config import SparsityConfig
    from teal_tpu_torch.eval.harness import ScoreModel, make_lm_eval_model
    from teal_tpu_torch.utils.tokenizer import get_tokenizer

    cfg, params = _load_model(args)
    tok = get_tokenizer(args.tokenizer or args.checkpoint)
    sp = SparsityConfig()
    th = None
    if args.sparsity > 0:
        _warn_dropped_thresholds(args)
        keep_fracs, keep_frac = _keep_fracs(args, cfg)
        sp = SparsityConfig(
            enabled=True, apply_prefill=True, mode=args.mode,
            block_size=args.block_size,
            block_keep_frac=(0.625 if keep_frac is None else keep_frac),
            block_keep_fracs=keep_fracs,
            block_thresholding=args.group_thresholds,
        )
        th = _device_thresholds(args, cfg)
    model = ScoreModel(params, cfg, sp=sp, thresholds=th,
                       max_seq=args.max_seq, device=args.device)
    lm = make_lm_eval_model(model, tok)

    try:
        import lm_eval  # type: ignore

        results = lm_eval.simple_evaluate(
            model=lm, tasks=args.tasks.split(",") if args.tasks else [],
            limit=args.limit,
        )["results"]
    except ImportError:
        if not args.task_file:
            raise SystemExit(
                "lm_eval is not installed; pass --task-file with shim-"
                "format task JSON"
            )
        from teal_tpu_torch.eval.lm_eval_shim import (
            GenerateTask, MultipleChoiceTask, simple_evaluate,
        )

        with open(args.task_file) as f:
            specs = json.load(f)
        if isinstance(specs, dict):
            specs = [specs]
        tasks = []
        for s in specs:
            docs = s["docs"][: args.limit] if args.limit else s["docs"]
            if s.get("type", "multiple_choice") == "generate":
                tasks.append(GenerateTask(
                    name=s["name"], docs=docs,
                    until=tuple(s.get("until", ["\n"])),
                    max_gen_toks=int(s.get("max_gen_toks", 32)),
                ))
            else:
                tasks.append(MultipleChoiceTask(name=s["name"], docs=docs))
        results = simple_evaluate(lm, tasks)
    print(json.dumps(results, indent=2))


def cmd_quantize(args):
    """Write a quantized native checkpoint (the analog of the reference's
    `quantize.py:528-605` writing model_int8.pth / model_int4.g{G}.pth);
    `generate` / `ppl` load it transparently: the native store records
    every leaf's dtype in meta.json."""
    from teal_tpu_torch.utils import checkpoint

    cfg, params = _load_model(args)
    if args.mode == "int8":
        from teal_tpu_torch.ops.quant import quantize_params_int8

        qparams = quantize_params_int8(params)
    elif args.mode == "int4":
        from teal_tpu_torch.ops.quant import quantize_params_int4

        qparams = quantize_params_int4(params, group=args.group_size)
    elif args.mode == "int4-gptq":
        import numpy as np

        from teal_tpu_torch.calibration.gptq_runner import gptq_quantize_model
        from teal_tpu_torch.utils.data import get_token_stream
        from teal_tpu_torch.utils.tokenizer import get_tokenizer

        tok = get_tokenizer(args.tokenizer or args.checkpoint)
        n = args.calib_tokens
        ids = get_token_stream(
            tok, text_file=args.text_file, dataset=args.dataset,
            vocab_size=cfg.vocab_size, n_tokens=n, seed=args.seed,
        )
        ids = np.mod(np.asarray(ids), cfg.vocab_size)
        ids = (list(ids) * (n // max(len(ids), 1) + 1))[:n]
        seq = min(n, 2048)
        tokens = np.asarray(ids)[: (n // seq) * seq].reshape(-1, seq)
        qparams = gptq_quantize_model(
            params, cfg, tokens, group=args.group_size,
            sequential=not args.one_shot, intra_block=args.intra_block,
            progress=True,
        )
    else:
        raise SystemExit(f"unknown quantize mode {args.mode!r}")
    checkpoint.save_params(qparams, args.output_path)
    print(f"{args.mode} checkpoint written to {args.output_path}")


def cmd_convert(args):
    import torch

    from teal_tpu_torch.config import get_model_config
    from teal_tpu_torch.utils import checkpoint

    cfg = get_model_config(args.model)
    params = checkpoint.load_hf_checkpoint(
        args.checkpoint, cfg, torch.float32 if args.fp32 else torch.bfloat16,
        args.device)
    checkpoint.save_params(params, args.output_path)
    print(f"native checkpoint written to {args.output_path}")


def _common(p, ckpt=True):
    p.add_argument("--model", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-layers", type=int, default=None,
                   help="override layer count (testing)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (no fallback: cuda needs a "
                        "card)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="teal_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate")
    _common(g)
    g.add_argument("--prompt", default="Hello, my name is")
    g.add_argument("--max-new-tokens", type=int, default=200)
    g.add_argument("--num-samples", type=int, default=1)
    g.add_argument("--max-seq", type=int, default=2048)
    g.add_argument("--temperature", type=float, default=0.8)
    g.add_argument("--top-k", type=int, default=200)
    g.add_argument("--sparsity", type=float, default=0.0)
    g.add_argument("--kernel", default="block",
                   choices=["masked_dense", "block", "gather"])
    g.add_argument("--block-size", type=int, default=32)
    g.add_argument("--hist-path", default=None)
    g.add_argument("--greedy", action="store_true")
    g.add_argument("--group-thresholds", action="store_true",
                   help="use calibrated group-score thresholds (block "
                        "kernel threshold mode; needs group histograms)")
    g.add_argument("--speculate-k", type=int, default=0,
                   help="speculative decoding: draft tokens per step")
    g.add_argument("--draft-checkpoint", default=None)
    g.add_argument("--draft-model", default=None,
                   help="draft architecture name (default: --model)")
    g.add_argument("--draft-sparsity", type=float, default=0.0)
    g.add_argument("--self-speculate", action="store_true",
                   help="draft = the target's own weights decoded "
                        "block-sparse at --draft-sparsity (default 0.5); "
                        "dense verify makes the output distribution "
                        "exactly the dense model's (lossless sparsity)")
    g.add_argument("--device-loop", action="store_true",
                   help="run the speculative generation as the "
                        "reference's whole-generation loop (its bound and "
                        "stats; a host round loop here)")
    g.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the last sample")
    g.add_argument("--metrics", default=None, metavar="FILE",
                   help="append JSONL run metrics")
    g.add_argument("--interactive", action="store_true")
    g.set_defaults(fn=cmd_generate)

    c = sub.add_parser("calibrate")
    _common(c)
    c.add_argument("--output-path", required=True)
    c.add_argument("--text-file", default=None)
    c.add_argument("--dataset", default=None,
                   help="HF dataset name (e.g. tatsu-lab/alpaca)")
    c.add_argument("--batch", type=int, default=10)
    c.add_argument("--seq-len", type=int, default=2048)
    c.add_argument("--no-layer-inputs", action="store_true")
    c.add_argument("--group-sizes", default=None,
                   help="comma-separated group sizes for group-score "
                        "histograms (default: the model's runtime-"
                        "effective block-kernel group sizes)")
    c.set_defaults(fn=cmd_calibrate)

    o = sub.add_parser("greedyopt")
    _common(o)
    o.add_argument("--teal-path", required=True,
                   help="dir containing histograms/ and activations/")
    o.add_argument("--target-sparsity", type=float, default=0.9)
    o.add_argument("--base-step-size", type=float, default=0.05)
    o.add_argument("--last-fraction", type=float, default=0.25)
    o.add_argument("--layers", default=None, help="comma-separated subset")
    o.set_defaults(fn=cmd_greedyopt)

    p = sub.add_parser("ppl")
    _common(p)
    p.add_argument("--text-file", default=None)
    p.add_argument("--dataset", default=None,
                   help="HF dataset name (e.g. tatsu-lab/alpaca)")
    p.add_argument("--num-tokens", type=int, default=8192)
    p.add_argument("--context-size", type=int, default=2048)
    p.add_argument("--window-size", type=int, default=512)
    p.add_argument("--sparsity", type=float, default=0.0)
    p.add_argument("--hist-path", default=None)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--mode", default="teal", choices=["teal", "group"],
                   help="sparsity rule: 'teal' = reference elementwise "
                        "|x|>t; 'group' = the block kernel's group "
                        "selection (measures the fast path's ppl cost)")
    p.add_argument("--kernel", default="masked_dense",
                   choices=["masked_dense", "block", "gather"])
    p.add_argument("--block-size", type=int, default=32)
    p.add_argument("--group-thresholds", action="store_true",
                   help="thresholds are calibrated group-score thresholds "
                        "(needs group histograms at the model's effective "
                        "group sizes)")
    p.add_argument("--permute", action="store_true",
                   help="fold calibrated channel permutations into the "
                        "weights before evaluating (improves group-mode "
                        "accuracy; exact re-parameterization)")
    p.add_argument("--permute-method", default="magnitude",
                   choices=["magnitude", "coactivation"],
                   help="magnitude: sort by calibrated mean |x|; "
                        "coactivation: cluster channels whose per-token "
                        "keep decisions correlate")
    p.set_defaults(fn=cmd_ppl)

    e = sub.add_parser("eval")
    _common(e)
    e.add_argument("--tasks", default=None,
                   help="comma-separated lm_eval task names (needs the "
                        "real lm_eval installed)")
    e.add_argument("--task-file", default=None,
                   help="JSON task file for the shim's evaluator")
    e.add_argument("--limit", type=int, default=None)
    e.add_argument("--max-seq", type=int, default=2048)
    e.add_argument("--sparsity", type=float, default=0.0)
    e.add_argument("--hist-path", default=None)
    e.add_argument("--greedy", action="store_true")
    e.add_argument("--mode", default="teal", choices=["teal", "group"])
    e.add_argument("--block-size", type=int, default=32)
    e.add_argument("--group-thresholds", action="store_true")
    e.set_defaults(fn=cmd_eval)

    q = sub.add_parser("quantize")
    _common(q)
    q.add_argument("--mode", default="int8",
                   choices=["int8", "int4", "int4-gptq"])
    q.add_argument("--output-path", required=True)
    q.add_argument("--group-size", type=int, default=128,
                   help="int4 quantization group size along the input dim")
    q.add_argument("--calib-tokens", type=int, default=4096,
                   help="GPTQ calibration token count")
    q.add_argument("--one-shot", action="store_true",
                   help="GPTQ: calibrate every layer on the full-"
                        "precision activations instead of the default "
                        "sequential propagation through the quantized "
                        "prefix (faster, slightly less accurate)")
    q.add_argument("--intra-block", action="store_true",
                   help="GPTQ: also sub-sequence within each block "
                        "(qkv -> o -> gate/up -> down calibrate on "
                        "intermediates from the already-quantized "
                        "earlier projections; 5 forwards/layer)")
    q.add_argument("--text-file", default=None)
    q.add_argument("--dataset", default=None)
    q.set_defaults(fn=cmd_quantize)

    v = sub.add_parser("convert")
    _common(v)
    v.add_argument("--output-path", required=True)
    v.set_defaults(fn=cmd_convert)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
