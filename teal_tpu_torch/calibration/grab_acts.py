"""Activation capture → histogram calibration.

Port of `teal_tpu/calibration/grab_acts.py`. Streaming layer-by-layer
capture of the four TEAL hidden-state groups and construction of
per-(layer, module, hidden-type) histograms, as the TEAL reference does
(`teal/grab_acts.py:63-97`): embed once, then for each layer save the
layer-input tensor (for the greedy optimizer), run the layer in capture
mode, build histograms, and move on, so memory stays one layer's
activations whatever the depth. The model runs on the device its params
live on; the histograms are built on the host (`ops/distribution`'s
native library).

A calibration batch is a pos-0 sequence on an empty cache, so each
layer's capture passes `causal_prefill=True`: at S >= 256 (S % 128 == 0,
head_dim 128, no window) its attention runs through kernel K6 instead of
the masked attention over an [S, S] score tensor (the reference's
`_layer_capture` takes its einsum `_attention`; the two agree within the
tests' tolerance).

Artifact layout matches the reference scheme
(`<out>/histograms/layer-<i>/{self_attn,mlp}/...` with keys h1/h2 and
h1_g<G>/h2_g<G>, and `<out>/activations/act_<i>.npz`), so either
package's calibration data loads in the other.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from teal_tpu_torch.config import ModelConfig, SparsityConfig
from teal_tpu_torch.models import llama
from teal_tpu_torch.ops.distribution import (Histogram, build_histogram,
                                             save_histograms)


def _layer_params(params, layer: int) -> Dict:
    """Layer `layer`'s parameters from the stacked tree."""
    return {k: llama._leaf(v, lambda a: a[layer])
            for k, v in params["layers"].items()}


def _pos0_layer(lp, hidden: torch.Tensor, cfg: ModelConfig,
                sp: SparsityConfig, thresholds: torch.Tensor,
                capture: bool):
    """`llama.layer_forward` of one layer over full pos-0 sequences
    (hidden [B, S, D]) on a fresh cache, with `causal_prefill` (K6 where
    the shapes allow). Returns (output, captures or None)."""
    b, s, _ = hidden.shape
    dev = hidden.device
    cos, sin = llama.precompute_rope(cfg, s, dev)
    kc = torch.zeros((b, cfg.n_kv_heads, s, cfg.head_dim),
                     dtype=hidden.dtype, device=dev)
    vc = torch.zeros_like(kc)
    pos = torch.zeros((b,), dtype=torch.int64, device=dev)
    h_out, _, _, caps = llama.layer_forward(
        hidden, lp, kc, vc, pos, cos.expand(b, s, -1), sin.expand(b, s, -1),
        cfg, sp, thresholds, capture=capture, causal_prefill=True)
    return h_out, caps


def _layer_capture(lp, hidden: torch.Tensor, cfg: ModelConfig):
    """Run one layer over a full pos-0 sequence (hidden [B, S, D]),
    returning (output, captures): the four TEAL hidden-state groups
    {"self_attn": {"h1", "h2"}, "mlp": {"h1", "h2"}} (no mlp h2 for MoE),
    each [B, S, width] in hidden's type on its device."""
    zero = torch.zeros((7,), dtype=torch.float32, device=hidden.device)
    return _pos0_layer(lp, hidden, cfg, SparsityConfig(enabled=False), zero,
                       capture=True)


def _embed(params, tokens) -> torch.Tensor:
    """Token ids [B, S] (any integer array) embedded on the params'
    device in the activation type."""
    emb = params["embed"]
    ids = torch.as_tensor(np.asarray(tokens), dtype=torch.int64)
    return emb[ids.to(emb.device)].to(llama.compute_dtype(params))


def calibrate(
    params,
    cfg: ModelConfig,
    tokens,
    out_dir: str,
    *,
    num_bins: int = 10000,
    outlier_threshold: float = 0.01,
    save_layer_inputs: bool = True,
    group_sizes=(32,),
    progress: bool = False,
) -> str:
    """Build histograms (and layer-input snapshots) from a token batch.

    tokens: [B, S] integer array — the calibration corpus (reference uses
    10 sequences of 2048 alpaca tokens, `teal/grab_acts.py:56`).

    Besides the reference's elementwise h1/h2 histograms, also builds
    GROUP-SCORE histograms (keys `h1_g<G>`/`h2_g<G>`: per-position max-|x|
    over G-channel groups, taken on the device before the host copy: a
    max is exact) for each size in `group_sizes` — the calibration data
    the block decode kernels' threshold mode needs."""
    hidden = _embed(params, tokens)

    act_dir = os.path.join(out_dir, "activations")
    if save_layer_inputs:
        os.makedirs(act_dir, exist_ok=True)

    for l in range(cfg.n_layers):
        if save_layer_inputs:
            np.savez_compressed(
                os.path.join(act_dir, f"act_{l}.npz"),
                hidden=hidden.float().cpu().numpy(),
            )
        hidden, caps = _layer_capture(_layer_params(params, l), hidden, cfg)
        for module in ("self_attn", "mlp"):
            hists: Dict[str, Histogram] = {}
            for htype in ("h1", "h2"):
                if htype not in caps[module]:
                    continue  # MoE layers have no shared mlp h2
                vals = caps[module][htype]
                hists[htype] = build_histogram(
                    vals, num_bins=num_bins, outlier_threshold=outlier_threshold
                )
                d = vals.shape[-1]
                for g in group_sizes:
                    if d % g:
                        continue
                    scores = vals.abs().reshape(-1, d // g, g).amax(-1)
                    hists[f"{htype}_g{g}"] = build_histogram(
                        scores, num_bins=num_bins,
                        outlier_threshold=outlier_threshold,
                    )
            save_histograms(
                os.path.join(out_dir, "histograms", f"layer-{l}", module),
                hists,
            )
        if progress:
            print(f"calibrated layer {l}/{cfg.n_layers}", flush=True)
    return out_dir


def load_layer_input(out_dir: str, layer: int) -> np.ndarray:
    path = os.path.join(out_dir, "activations", f"act_{layer}.npz")
    with np.load(path) as z:
        return z["hidden"]
