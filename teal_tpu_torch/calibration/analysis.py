"""Distribution analysis (parity with `notebooks/distributions.ipynb`).

Port of `teal_tpu/calibration/analysis.py` (host numpy). The reference's
notebook visualizes per-layer activation histograms and
fits Gaussian/Laplace densities — the zero-mean unimodal observation that
justifies the icdf threshold rule (paper §4). This module provides the
same analysis programmatically: moment-based fits, fit quality, and an
optional matplotlib plot.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from teal_tpu_torch.ops.distribution import Distribution


@dataclass
class FitReport:
    mean: float
    std: float
    laplace_b: float
    gaussian_l1: float      # mean |empirical - fit| over the grid
    laplace_l1: float
    better: str             # "gaussian" | "laplace"


def fit_distribution(d: Distribution, n_grid: int = 512) -> FitReport:
    """Moment-fit Gaussian and Laplace densities to a histogram and score
    both against the empirical pdf (midpoint-mass estimate)."""
    centers = d.centers
    probs = d.counts / d.total
    mean = float((centers * probs).sum())
    var = float(((centers - mean) ** 2 * probs).sum())
    std = math.sqrt(max(var, 1e-30))
    b = float((np.abs(centers - mean) * probs).sum())  # Laplace MLE scale

    lo, hi = np.quantile(centers, [0.001, 0.999])
    grid = np.linspace(lo, hi, n_grid)
    widths = np.diff(
        np.concatenate([[centers[0]], (centers[:-1] + centers[1:]) / 2,
                        [centers[-1]]])
    )
    emp_pdf = np.interp(grid, centers, probs / np.maximum(widths, 1e-30))
    gauss = np.exp(-0.5 * ((grid - mean) / std) ** 2) / (std * math.sqrt(2 * math.pi))
    lap = np.exp(-np.abs(grid - mean) / b) / (2 * b)
    g_l1 = float(np.mean(np.abs(emp_pdf - gauss)))
    l_l1 = float(np.mean(np.abs(emp_pdf - lap)))
    return FitReport(
        mean=mean, std=std, laplace_b=b,
        gaussian_l1=g_l1, laplace_l1=l_l1,
        better="gaussian" if g_l1 <= l_l1 else "laplace",
    )


def analyze_layer(hist_root: str, layer: int) -> Dict[str, FitReport]:
    """Fit reports for one layer's four hidden-type distributions."""
    from teal_tpu_torch.calibration.thresholds import load_layer_distributions

    distrs = load_layer_distributions(hist_root, layer)
    return {k: fit_distribution(d) for k, d in distrs.items()}


def plot_layer(hist_root: str, layer: int, out_png: Optional[str] = None):
    """Histogram + fitted densities (matplotlib, imported here: an
    optional dependency, absent where the kernels run)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from teal_tpu_torch.calibration.thresholds import load_layer_distributions

    distrs = load_layer_distributions(hist_root, layer)
    fig, axes = plt.subplots(2, 2, figsize=(10, 6))
    for ax, (name, d) in zip(axes.ravel(), sorted(distrs.items())):
        r = fit_distribution(d)
        lo, hi = np.quantile(d.centers, [0.005, 0.995])
        grid = np.linspace(lo, hi, 400)
        ax.plot(grid, d.pdf(grid), label="empirical (KDE)")
        ax.plot(grid, np.exp(-0.5 * ((grid - r.mean) / r.std) ** 2)
                / (r.std * np.sqrt(2 * np.pi)), "--", label="gaussian")
        ax.plot(grid, np.exp(-np.abs(grid - r.mean) / r.laplace_b)
                / (2 * r.laplace_b), ":", label="laplace")
        ax.set_title(f"{name} (better: {r.better})")
        ax.legend(fontsize=7)
    fig.tight_layout()
    if out_png:
        fig.savefig(out_png, dpi=120)
    return fig
