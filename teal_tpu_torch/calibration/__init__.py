"""Calibration: activation histograms, TEAL thresholds, the greedy
allocation, channel permutations and GPTQ (port of `teal_tpu/calibration`).
The captures run on the params' device; the histograms, thresholds and
permutation search are host code."""

from teal_tpu_torch.calibration.grab_acts import calibrate
from teal_tpu_torch.calibration.thresholds import (
    thresholds_for_uniform,
    thresholds_from_sparsities,
    get_layer_greedy_sparsities,
)
from teal_tpu_torch.calibration.greedyopt import process_layer, proj_weights

__all__ = [
    "calibrate",
    "thresholds_for_uniform",
    "thresholds_from_sparsities",
    "get_layer_greedy_sparsities",
    "process_layer",
    "proj_weights",
]
