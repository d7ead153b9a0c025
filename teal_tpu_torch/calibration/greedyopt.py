"""Block-wise greedy per-layer sparsity allocation.

Port of `teal_tpu/calibration/greedyopt.py`. Coordinate-ascent over the
seven projections of one layer: starting from all-zero sparsities,
repeatedly bump the projection whose bump least increases layer-output
error, until a target *effective* (parameter-weighted) sparsity is
reached. Behavioral parity with the reference (`teal/greedyopt.py:99-159`):

  - projection weights ∝ parameter count relative to q
    (`weight_dict`, greedyopt.py:26-52) — here derived from the
    ModelConfig's projection shapes instead of a hand-maintained table;
  - step size per projection = base_step / weight[proj] (:116);
  - error = mean over (batch, channel) of the L2 norm along the *sequence*
    axis of the output delta, restricted to the last `last_fraction` of
    positions (`calculate_activation_error`, :88-92);
  - every step logs `Effective Sparsity, Activation Error, Baseline Error,
    q,k,v,o,gate,up,down` to `lookup/layer-<i>/results.csv`, where baseline
    is the uniform allocation at the same effective sparsity (:148-154);
  - forwards use prefill-mode sparsification (last half of positions),
    like the reference's monkeypatched layer under apply_prefill.

The layer forwards run on the device the layer's params live on, with
`causal_prefill=True` (a pos-0 sequence on an empty cache): at S >= 256
their attention runs through kernel K6, eight times a greedy step.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional

import numpy as np
import torch

from teal_tpu_torch.config import ModelConfig, PROJS, SparsityConfig
from teal_tpu_torch.ops.distribution import Distribution, threshold_for_sparsity
from teal_tpu_torch.calibration.grab_acts import (_layer_params,
                                                  _pos0_layer,
                                                  load_layer_input)
from teal_tpu_torch.calibration.thresholds import (
    load_layer_distributions,
    proj_distribution,
    read_greedy_csv,
)


def proj_weights(cfg: ModelConfig, *,
                 reference_compat: bool = False) -> Dict[str, float]:
    """Parameter-count weights relative to q (generalizes the reference's
    per-model `weight_dict` to any config).

    DELIBERATE DEVIATION from the reference for MHA Llama-2 models: true
    param counts give k = v = 1.0 there, while the reference hardcodes
    1/8 for every model incl. MHA (`teal/greedyopt.py:26-52`). Pass
    `reference_compat=True` to reproduce the reference's scale when
    comparing 'Effective Sparsity' against its SHIPPED lookup CSVs for
    Llama-2-7B/13B.
    """
    q = cfg.proj_params("q")
    w = {p: cfg.proj_params(p) / q for p in PROJS}
    if reference_compat and cfg.n_kv_heads == cfg.n_heads:
        w["k"] = w["v"] = 1.0 / 8.0
    return w


def effective_sparsity(sparsities: Dict[str, float], weights: Dict[str, float]) -> float:
    total = sum(weights.values())
    return sum(sparsities[p] * weights[p] for p in sparsities if p in weights) / total


def _layer_fwd(lp, hidden: torch.Tensor, thresholds: torch.Tensor,
               cfg: ModelConfig, sp: SparsityConfig) -> torch.Tensor:
    """One layer over a pos-0 sequence (hidden [B, S, D]) at `thresholds`
    [7]: its output."""
    return _pos0_layer(lp, hidden, cfg, sp, thresholds, capture=False)[0]


def activation_error(target: torch.Tensor, new: torch.Tensor,
                     last_fraction: float = 0.25) -> float:
    """Mean over (batch, channel) of L2 norms along the sequence axis,
    over the trailing `last_fraction` of positions."""
    start = int(new.shape[1] * (1 - last_fraction))
    d = (target[:, start:] - new[:, start:]).float()
    return float(torch.linalg.vector_norm(d, dim=1).mean())


def _thresholds_of(sparsities: Dict[str, float], distrs,
                   device) -> torch.Tensor:
    # sparsity may exceed 1.0 transiently (step overshoot); icdf clamps to
    # the last bin center, same as the reference's searchsorted behavior.
    return torch.tensor(
        [threshold_for_sparsity(proj_distribution(distrs, p), sparsities[p])
         for p in PROJS],
        dtype=torch.float32, device=device,
    )


def process_layer(
    layer_params,
    cfg: ModelConfig,
    input_acts,
    distrs: Dict[str, Distribution],
    *,
    target_sparsity: float = 0.9,
    base_step_size: float = 0.05,
    last_fraction: float = 0.25,
    output_csv: Optional[str] = None,
    progress: bool = False,
) -> Dict[str, float]:
    """Greedy-allocate one layer (input_acts: the layer input [B, S, D],
    an array or tensor, run on the layer params' device in their type).
    Returns the final per-projection sparsities."""
    weights = proj_weights(cfg)
    step_sizes = {p: base_step_size / weights[p] for p in PROJS}
    sp = SparsityConfig(enabled=True, apply_prefill=True, prefill_fraction=0.5)

    ref = layer_params["attn_norm"]
    if not isinstance(input_acts, torch.Tensor):
        input_acts = torch.from_numpy(np.asarray(input_acts))
    hidden = input_acts.to(ref.device, ref.dtype)
    sparsities = {p: 0.0 for p in PROJS}

    def fwd(s):
        return _layer_fwd(layer_params, hidden,
                          _thresholds_of(s, distrs, ref.device), cfg, sp)

    target_acts = fwd(sparsities)

    writer = None
    csvfile = None
    if output_csv:
        os.makedirs(os.path.dirname(output_csv), exist_ok=True)
        csvfile = open(output_csv, "w", newline="")
        writer = csv.writer(csvfile)
        writer.writerow(
            ["Effective Sparsity", "Activation Error", "Baseline Error"]
            + list(PROJS)
        )

    try:
        while effective_sparsity(sparsities, weights) < target_sparsity:
            best_error, best_proj = float("inf"), None
            for p in PROJS:
                if sparsities[p] >= 1:
                    continue
                trial = dict(sparsities)
                trial[p] += step_sizes[p]
                err = activation_error(target_acts, fwd(trial), last_fraction)
                if err < best_error:
                    best_error, best_proj = err, p
            if best_proj is None:
                break
            sparsities[best_proj] += step_sizes[best_proj]

            eff = effective_sparsity(sparsities, weights)
            baseline = {p: eff for p in PROJS}
            baseline_error = activation_error(target_acts, fwd(baseline),
                                              last_fraction)

            if writer:
                writer.writerow(
                    [eff, best_error, baseline_error]
                    + [sparsities[p] for p in PROJS]
                )
                csvfile.flush()
            if progress:
                print(
                    f"eff={eff:.4f} err={best_error:.4f} "
                    f"baseline={baseline_error:.4f} bumped={best_proj}",
                    flush=True,
                )
    finally:
        if csvfile:
            csvfile.close()
    return sparsities


def run_greedy(
    params,
    cfg: ModelConfig,
    teal_root: str,
    *,
    target_sparsity: float = 0.9,
    base_step_size: float = 0.05,
    last_fraction: float = 0.25,
    layers=None,
    resume: bool = True,
    progress: bool = False,
):
    """Greedy-allocate every layer from a calibration dir (histograms/ +
    activations/), writing lookup/layer-<i>/results.csv (the reference
    CLI's whole-model loop, `teal/greedyopt.py:163-198`). With `resume`,
    layers whose results.csv already reached the target are skipped."""
    hist_root = os.path.join(teal_root, "histograms")
    for l in layers if layers is not None else range(cfg.n_layers):
        out_csv = os.path.join(teal_root, "lookup", f"layer-{l}",
                               "results.csv")
        if resume and os.path.exists(out_csv):
            try:
                rows = read_greedy_csv(out_csv)
            except (TypeError, ValueError):     # a row cut off mid-write
                rows = []
            if rows and rows[-1]["Effective Sparsity"] >= target_sparsity:
                if progress:
                    print(f"layer {l}: already complete, skipping",
                          flush=True)
                continue
        process_layer(
            _layer_params(params, l), cfg, load_layer_input(teal_root, l),
            load_layer_distributions(hist_root, l),
            target_sparsity=target_sparsity,
            base_step_size=base_step_size,
            last_fraction=last_fraction,
            output_csv=out_csv,
            progress=progress,
        )
