"""Empirical activation distributions: histogram build, cdf/icdf, thresholds.

Port of `teal_tpu/ops/distribution.py`. The calibration-to-threshold
mapping at the heart of TEAL: activations of each (layer, projection
group) are summarized as a 10,000-bin histogram with 1% outlier clamping,
and the sparsity-to-threshold map is the inverse empirical CDF at
`0.5 + s/2` (zero-mean unimodal assumption, so zeroing `|x| <= t` removes
the central `s` probability mass).

The histogram queries (`Distribution`) and the artifact IO are host numpy,
as in the reference. `build_histogram` runs the native C++ library
(`teal_tpu_torch/native`), which raises where it cannot be built; its numpy
twin `build_histogram_plain` gives the same counts, centers and edges bit
for bit. `accumulate_counts` is torch, on the values' device, for
streaming capture. The `.npz` + `meta.json` layout is the reference's, so
files written by either package load in the other, and TEAL's shipped
`histograms.pt` files read too.
"""

from __future__ import annotations

import ctypes
import json
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

DEFAULT_NUM_BINS = 10000
DEFAULT_OUTLIER_THRESHOLD = 0.01


@dataclass
class Histogram:
    """counts[i] covers [edges[i], edges[i+1]); centers are bin midpoints."""

    counts: np.ndarray   # [num_bins] float64
    centers: np.ndarray  # [num_bins] float32/float64
    edges: Optional[np.ndarray] = None  # [num_bins + 1], kept when known

    @property
    def num_bins(self) -> int:
        return int(self.counts.shape[0])


def make_edges(
    sorted_values: np.ndarray,
    num_bins: int = DEFAULT_NUM_BINS,
    outlier_threshold: float = DEFAULT_OUTLIER_THRESHOLD,
) -> np.ndarray:
    """Bin edges from sorted data: uniform between the outlier-clamped
    bounds, plus catch-all outer bins reaching the true min/max."""
    n = len(sorted_values)
    k = int(outlier_threshold * n)
    lower = sorted_values[k]
    upper = sorted_values[-k] if k > 0 else sorted_values[-1]
    main = np.linspace(lower, upper, num_bins - 1)
    return np.concatenate(
        [[sorted_values[0]], main, [sorted_values[-1]]]
    ).astype(np.float64)


def _edges_from_stats(vmin, vmax, lower, upper, num_bins) -> np.ndarray:
    # float32 endpoints so linspace computes in float32, bit-identical to
    # make_edges on the float32 sorted array
    main = np.linspace(np.float32(lower), np.float32(upper), num_bins - 1)
    return np.concatenate(
        [[np.float32(vmin)], main, [np.float32(vmax)]]
    ).astype(np.float64)


def _host_values(values) -> np.ndarray:
    """values (a tensor on any device, or an array) as a flat C-contiguous
    float32 host array."""
    if isinstance(values, torch.Tensor):
        values = values.detach().float().cpu().numpy()
    return np.ascontiguousarray(np.asarray(values, dtype=np.float32).ravel())


def _histogram(edges: np.ndarray, counts: np.ndarray) -> Histogram:
    centers = (edges[:-1] + edges[1:]) / 2
    return Histogram(counts=counts, centers=centers.astype(np.float32),
                     edges=edges)


def build_histogram(
    values,
    num_bins: int = DEFAULT_NUM_BINS,
    outlier_threshold: float = DEFAULT_OUTLIER_THRESHOLD,
) -> Histogram:
    """10k-bin outlier-clamped histogram (the TEAL reference's
    `find_histogram` semantics) through the native library: O(n) order
    statistics and an OpenMP counting pass over the hundreds of millions
    of values a 7B histogram holds. values: a tensor (copied to the host)
    or an array, at least two values."""
    from teal_tpu_torch.native import get_lib

    values = _host_values(values)
    n = len(values)
    if n < 2:
        raise ValueError(f"a histogram needs at least 2 values; got {n}")
    k = int(outlier_threshold * n)
    lib = get_lib()
    f32p = ctypes.POINTER(ctypes.c_float)
    out4 = np.zeros(4, np.float32)
    k_hi = (n - k) if k > 0 else (n - 1)
    lib.teal_order_stats(values.ctypes.data_as(f32p), n, k, k_hi,
                         out4.ctypes.data_as(f32p))
    vmin, vmax, lower, upper = (float(v) for v in out4)
    edges = _edges_from_stats(vmin, vmax, lower, upper, num_bins)
    counts = np.zeros(num_bins, np.float64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.teal_histogram_count(values.ctypes.data_as(f32p), n,
                             edges.ctypes.data_as(f64p), num_bins,
                             counts.ctypes.data_as(f64p))
    return _histogram(edges, counts)


def build_histogram_plain(
    values,
    num_bins: int = DEFAULT_NUM_BINS,
    outlier_threshold: float = DEFAULT_OUTLIER_THRESHOLD,
) -> Histogram:
    """`build_histogram` in numpy (a full sort and `np.histogram`): the
    same counts, centers and edges, bit for bit. Only the tests call it."""
    values = _host_values(values)
    sv = np.sort(values)
    edges = make_edges(sv, num_bins, outlier_threshold)
    counts = np.histogram(values, bins=edges)[0].astype(np.float64)
    return _histogram(edges, counts)


def accumulate_counts(edges: torch.Tensor, values: torch.Tensor,
                      counts: torch.Tensor) -> torch.Tensor:
    """Streaming accumulation of histogram counts, on the values' device.

    `edges` are fixed ([B+1]); values outside [edges[0], edges[-1]] are
    clipped into the outer catch-all bins (the outer bins already extend to
    the min/max of the first calibration batch; clipping keeps later
    batches' rare extremes counted rather than dropped). Returns
    counts + this batch's counts (counts' type)."""
    values = values.reshape(-1).to(edges.dtype)
    idx = torch.searchsorted(edges, values, right=True) - 1
    idx = idx.clamp(0, edges.shape[0] - 2)
    return counts + torch.bincount(idx, minlength=counts.shape[0]).to(
        counts.dtype)


class Distribution:
    """Histogram-backed empirical distribution with pdf/cdf/icdf."""

    def __init__(self, histogram: Histogram):
        self.histogram = histogram
        self.centers = np.asarray(histogram.centers, dtype=np.float64)
        self.counts = np.asarray(histogram.counts, dtype=np.float64)
        self.total = float(self.counts.sum())
        self.cum = np.cumsum(self.counts)

    # -- construction helpers -------------------------------------------------

    @classmethod
    def from_values(cls, values, **kw) -> "Distribution":
        return cls(build_histogram(values, **kw))

    @classmethod
    def from_counts(cls, counts, centers) -> "Distribution":
        return cls(Histogram(np.asarray(counts, np.float64),
                             np.asarray(centers)))

    # -- queries --------------------------------------------------------------

    def pdf(self, x, bandwidth: Optional[float] = None):
        """Gaussian kernel-density estimate over bin centers (Silverman-style
        bandwidth as in the reference, computed over interior centers)."""
        if bandwidth is None:
            bandwidth = float(
                1.06 * np.std(self.centers[1:-1]) * (self.total - 2) ** (-1 / 5)
            )
        x = np.atleast_1d(np.asarray(x, dtype=np.float64))
        z = (x[None, :] - self.centers[:, None]) / bandwidth
        kernel = np.exp(-0.5 * z**2) / (bandwidth * np.sqrt(2 * np.pi))
        return (kernel * self.counts[:, None]).sum(0) / self.total

    def cdf(self, x):
        x = np.asarray(x, dtype=np.float64)
        return np.interp(x, self.centers, self.cum / self.total)

    def icdf(self, q: float) -> float:
        """Inverse empirical CDF with linear interpolation between centers."""
        target = q * self.total
        idx = int(np.searchsorted(self.cum, target, side="left"))
        if idx == 0:
            return float(self.centers[0])
        if idx >= len(self.centers):
            return float(self.centers[-1])
        lo_c, hi_c = self.cum[idx - 1], self.cum[idx]
        lo_v, hi_v = self.centers[idx - 1], self.centers[idx]
        frac = (target - lo_c) / (hi_c - lo_c)
        return float(lo_v + frac * (hi_v - lo_v))

    def abs_icdf(self, q: float) -> float:
        """Inverse CDF of |X|: magnitude t with P(|X| <= t) = q, by folding
        the signed histogram about zero."""
        abs_centers = np.abs(self.centers)
        order = np.argsort(abs_centers, kind="stable")
        folded_centers = abs_centers[order]
        folded_cum = np.cumsum(self.counts[order])
        target = q * self.total
        idx = int(np.searchsorted(folded_cum, target, side="left"))
        if idx == 0:
            return float(folded_centers[0])
        if idx >= len(folded_centers):
            return float(folded_centers[-1])
        lo_c, hi_c = folded_cum[idx - 1], folded_cum[idx]
        frac = 0.0 if hi_c == lo_c else (target - lo_c) / (hi_c - lo_c)
        return float(
            folded_centers[idx - 1]
            + frac * (folded_centers[idx] - folded_centers[idx - 1])
        )


def threshold_for_sparsity(distr: Distribution, sparsity: float) -> float:
    """Magnitude threshold zeroing the central `sparsity` mass:
    `t = icdf(0.5 + s/2)`; 0 when s == 0."""
    if sparsity == 0.0:
        return 0.0
    return distr.icdf(0.5 + sparsity / 2)


# -- artifact IO --------------------------------------------------------------

def save_histograms(path: str, hists: Dict[str, Histogram]) -> None:
    """Save histograms for one (layer, module) as an .npz plus a JSON index
    (keys `{h1, h1_centers, h2, h2_centers, ...}`, the reference's
    `histograms.pt` scheme)."""
    os.makedirs(path, exist_ok=True)
    arrays = {}
    for key, h in hists.items():
        arrays[key] = h.counts.astype(np.float32)
        arrays[f"{key}_centers"] = h.centers.astype(np.float32)
    np.savez(os.path.join(path, "histograms.npz"), **arrays)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"keys": sorted(hists)}, f)


def load_histograms(path: str) -> Dict[str, Histogram]:
    """Load histograms saved by `save_histograms` (either package) or a
    reference-format `histograms.pt` (TEAL's shipped calibration data
    under `models/<M>/histograms/`)."""
    npz = os.path.join(path, "histograms.npz")
    if os.path.exists(npz):
        with np.load(npz) as data:
            keys = [k for k in data.files if not k.endswith("_centers")]
            return {
                k: Histogram(
                    counts=np.asarray(data[k], np.float64),
                    centers=np.asarray(data[f"{k}_centers"], np.float32),
                )
                for k in keys
            }
    pt = os.path.join(path, "histograms.pt")
    if os.path.exists(pt):
        data = torch.load(pt, map_location="cpu", weights_only=True)
        keys = [k for k in data if not k.endswith("_centers")]
        return {
            k: Histogram(
                counts=np.asarray(data[k].float().numpy(), np.float64),
                centers=np.asarray(data[f"{k}_centers"].float().numpy(),
                                   np.float32),
            )
            for k in keys
        }
    raise FileNotFoundError(f"no histograms.npz or histograms.pt under {path}")


def load_distribution(path: str, hidden_type: str) -> Distribution:
    """Distribution for one hidden type ('h1'/'h2') from a histogram dir."""
    hists = load_histograms(path)
    if hidden_type not in hists:
        raise KeyError(f"{hidden_type!r} not in {sorted(hists)} at {path}")
    return Distribution(hists[hidden_type])
