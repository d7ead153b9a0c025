"""The port's activation distributions (`teal_tpu_torch/ops/distribution.py`
and its native histogram library) against the JAX package's on the CPU:
histograms bit for bit (counts, centers, edges) beside the port's numpy
twin, the distribution queries and thresholds equal, streaming counts
equal, and histogram files written by either package read by the other."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from teal_tpu.ops import distribution as jd
from teal_tpu_torch.native import loader
from teal_tpu_torch.ops import distribution as td


def _values(kind: str, n: int) -> np.ndarray:
    """n seeded float32 values of `kind`, with duplicates and extremes."""
    rng = np.random.default_rng(n + len(kind))
    v = {"normal": lambda: rng.normal(0.0, 1.0, n),
         "laplace": lambda: rng.laplace(0.0, 0.3, n),
         "lognormal": lambda: rng.lognormal(0.0, 1.5, n)}[kind]()
    v = v.astype(np.float32)
    v[: n // 10] = v[n // 10: 2 * (n // 10)]          # duplicates
    v[rng.integers(0, n, 3)] = [1e6, -1e6, 0.0]       # extremes
    return v


def _same(a, b) -> None:
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.centers, b.centers)
    np.testing.assert_array_equal(a.edges, b.edges)
    assert a.counts.dtype == b.counts.dtype == np.float64
    assert a.centers.dtype == b.centers.dtype == np.float32


@pytest.mark.parametrize("kind", ["normal", "laplace", "lognormal"])
@pytest.mark.parametrize("n", [1000, 123457])
def test_build_histogram_matches_jax_bit_for_bit(kind, n):
    """The native build equals JAX's build_histogram and the port's numpy
    twin bit for bit, from an array and from a tensor."""
    v = _values(kind, n)
    got = td.build_histogram(v)
    _same(got, jd.build_histogram(v))
    _same(got, td.build_histogram_plain(v))
    _same(got, td.build_histogram(torch.from_numpy(v)))
    assert got.counts.sum() == n
    small = td.build_histogram(v, num_bins=512, outlier_threshold=0.02)
    _same(small, jd.build_histogram(v, num_bins=512, outlier_threshold=0.02))


def test_native_library_lands_in_build_dir():
    """The library is built under the repository's git-ignored build/
    directory (keyed by a source hash), nowhere else."""
    td.build_histogram(_values("normal", 1000))
    path = loader._target()
    assert path.exists()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert str(path).startswith(os.path.join(root, "build", "teal_tpu_torch"))


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A source that does not compile raises with the compiler's output;
    nothing falls back to numpy."""
    bad = tmp_path / "histogram.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(loader, "SRC", bad)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(loader, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ exit"):
        loader.get_lib()
    with pytest.raises(RuntimeError):
        td.build_histogram(_values("normal", 1000))


@pytest.mark.parametrize("kind", ["normal", "laplace", "lognormal"])
def test_distribution_queries_match_jax(kind):
    """pdf, cdf, icdf, abs_icdf and threshold_for_sparsity equal JAX's on
    the same histogram."""
    v = _values(kind, 123457)
    h = td.build_histogram(v, num_bins=2000)
    got, want = td.Distribution(h), jd.Distribution(jd.build_histogram(
        v, num_bins=2000))
    xs = np.linspace(-4, 4, 97)
    np.testing.assert_array_equal(got.cdf(xs), want.cdf(xs))
    np.testing.assert_array_equal(got.pdf(xs[::8]), want.pdf(xs[::8]))
    for q in (0.0, 1e-6, 0.1, 0.5, 0.75, 0.99, 0.9999, 1.0, 1.2):
        assert got.icdf(q) == want.icdf(q), q
        assert got.abs_icdf(q) == want.abs_icdf(q), q
    for s in (0.0, 0.25, 0.5, 0.9, 1.0):
        assert (td.threshold_for_sparsity(got, s)
                == jd.threshold_for_sparsity(want, s)), s


def test_accumulate_counts_matches_jax():
    """Streaming counts (values past either outer edge clipped into the
    catch-all bins) equal JAX's, batch after batch."""
    rng = np.random.default_rng(5)
    edges = td.build_histogram(rng.normal(size=5000).astype(np.float32),
                               num_bins=300).edges.astype(np.float32)
    counts = torch.zeros(300, dtype=torch.float32)
    jcounts = jnp.zeros(300, jnp.float32)
    for i in range(3):
        v = (rng.normal(size=(7, 311)) * (1 + i)).astype(np.float32)
        counts = td.accumulate_counts(torch.from_numpy(edges),
                                      torch.from_numpy(v), counts)
        jcounts = jd.accumulate_counts(jnp.asarray(edges), jnp.asarray(v),
                                       jcounts)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert float(counts.sum()) == 3 * 7 * 311


def test_histogram_files_cross_load(tmp_path):
    """.npz files written by either package load in the other, equal; the
    reference's histograms.pt format reads too."""
    v = _values("laplace", 4321)
    hists = {"h1": td.build_histogram(v, num_bins=100),
             "h2_g32": td.build_histogram(np.abs(v[:1000]), num_bins=50)}
    jhists = {k: jd.Histogram(h.counts, h.centers) for k, h in hists.items()}
    td.save_histograms(str(tmp_path / "port"), hists)
    jd.save_histograms(str(tmp_path / "jax"), jhists)
    for src in ("port", "jax"):
        for load in (td.load_histograms, jd.load_histograms):
            got = load(str(tmp_path / src))
            assert sorted(got) == sorted(hists)
            for k, h in hists.items():
                np.testing.assert_array_equal(got[k].counts, h.counts)
                np.testing.assert_array_equal(got[k].centers, h.centers)
    pt = tmp_path / "pt"
    pt.mkdir()
    torch.save({"h1": torch.from_numpy(hists["h1"].counts).float(),
                "h1_centers": torch.from_numpy(hists["h1"].centers)},
               pt / "histograms.pt")
    d = td.load_distribution(str(pt), "h1")
    np.testing.assert_array_equal(d.counts, hists["h1"].counts)
    assert d.icdf(0.5) == jd.load_distribution(str(pt), "h1").icdf(0.5)
    with pytest.raises(KeyError):
        td.load_distribution(str(pt), "h2")
