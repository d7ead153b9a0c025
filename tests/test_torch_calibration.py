"""The port's calibration (`teal_tpu_torch/calibration`: capture,
histograms, TEAL thresholds, the greedy allocation) against the JAX
package's on the CPU, on `tiny` in fp32 (2 x 64 tokens, 512 bins) and on a
head_dim-128 config at S = 256, where the port's capture takes kernel K6
(its plain version here) and JAX's the masked `_attention`: captures and
layer inputs within 2e-5 of scale; every threshold function equal bit for
bit from the same histogram files; the greedy allocation's sparsities
equal and its first step's trial errors within 2e-5."""

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from teal_tpu.calibration import grab_acts as jgrab
from teal_tpu.calibration import greedyopt as jgreedy
from teal_tpu.calibration import thresholds as jth
from teal_tpu.config import get_model_config as jget_model_config
from teal_tpu.models import llama as jllama
from teal_tpu_torch.calibration import analysis, grab_acts, greedyopt
from teal_tpu_torch.calibration import thresholds as tth
from teal_tpu_torch.config import PROJS, get_model_config
from teal_tpu_torch.models import llama
from teal_tpu_torch.ops import flash_prefill as fp

TOL = 2e-5
HEAD128 = dict(n_layers=2, n_heads=2, n_kv_heads=1, dim=256,
               intermediate_size=384, vocab_size=128)
MOE = dict(n_layers=2, n_heads=2, n_kv_heads=2, dim=256,
           intermediate_size=384, vocab_size=64, n_experts=2,
           n_experts_per_tok=1)
GREEDY = dict(target_sparsity=0.3, base_step_size=0.1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its many small ops run tens of
    times slower on the default thread pool when the test workers share
    the cores (measured: 90 s against 2 s for the greedy loop)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _model(name: str, **kw):
    """(cfg, JAX cfg, port params, JAX params), fp32, the same weights."""
    cfg, jcfg = get_model_config(name, **kw), jget_model_config(name, **kw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = llama.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return cfg, jcfg, params, jparams


def _close(got, want, tol=TOL) -> None:
    """max |got - want| within tol of want's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


@pytest.fixture(scope="module")
def calib(tmp_path_factory):
    """Both packages' calibrations of tiny from the same tokens, and the
    port's greedy lookup on its own (dirs: port, jax)."""
    cfg, jcfg, params, jparams = _model("tiny")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64))
    root = tmp_path_factory.mktemp("calib")
    out, jout = str(root / "port"), str(root / "jax")
    grab_acts.calibrate(params, cfg, tokens, out, num_bins=512,
                        group_sizes=(16, 32))
    jgrab.calibrate(jparams, jcfg, tokens, jout, num_bins=512,
                    group_sizes=(16, 32))
    greedyopt.run_greedy(params, cfg, out, **GREEDY)
    return cfg, jcfg, params, jparams, out, jout


def test_layer_inputs_and_captures_match_jax(calib):
    """act_<i>.npz of both packages within 2e-5; each layer's four
    captures and its output within 2e-5 on the same layer input."""
    cfg, jcfg, params, jparams, out, jout = calib
    for l in range(cfg.n_layers):
        a = grab_acts.load_layer_input(out, l)
        ja = jgrab.load_layer_input(jout, l)
        assert a.shape == (2, 64, cfg.dim)
        _close(a, ja)
        h, caps = grab_acts._layer_capture(
            grab_acts._layer_params(params, l), torch.from_numpy(ja), cfg)
        jh, jcaps = jgrab._layer_capture(
            jax.tree.map(lambda x: x[l], jparams["layers"]),
            jnp.asarray(ja), jcfg)
        _close(h, jh)
        for module in ("self_attn", "mlp"):
            assert sorted(caps[module]) == sorted(jcaps[module])
            for htype in caps[module]:
                _close(caps[module][htype], jcaps[module][htype])


def test_capture_at_s256_takes_k6(monkeypatch, tmp_path):
    """On the head_dim-128 config a [1, 256] calibration batch runs each
    layer's attention through K6 (its plain version on the CPU: one call a
    layer); the captures stay within 2e-5 of JAX's `_attention` ones."""
    cfg, jcfg, params, jparams = _model("tiny", **HEAD128)
    calls = [0]
    plain = fp.flash_prefill_attention_plain

    def counting(*args):
        calls[0] += 1
        return plain(*args)

    monkeypatch.setattr(fp, "flash_prefill_attention_plain", counting)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 256))
    grab_acts.calibrate(params, cfg, tokens, str(tmp_path), num_bins=256,
                        group_sizes=(128,))
    assert calls[0] == cfg.n_layers
    x = grab_acts.load_layer_input(str(tmp_path), 1)
    _, caps = grab_acts._layer_capture(grab_acts._layer_params(params, 1),
                                       torch.from_numpy(x), cfg)
    assert calls[0] == cfg.n_layers + 1
    _, jcaps = jgrab._layer_capture(
        jax.tree.map(lambda a: a[1], jparams["layers"]), jnp.asarray(x),
        jcfg)
    for module in ("self_attn", "mlp"):
        for htype in ("h1", "h2"):
            _close(caps[module][htype], jcaps[module][htype])


@pytest.fixture
def round_trip_pandas(monkeypatch):
    """pandas' read_csv with its correctly rounded float parser, for the
    JAX package's greedy CSV readers (its default parser can land some
    units in the last place off; the port's `csv` reader parses exactly)."""
    read = pd.read_csv
    monkeypatch.setattr(pd, "read_csv", lambda *a, **k: read(
        *a, float_precision="round_trip", **k))


def _sparsities(cfg):
    rng = np.random.default_rng(11)
    s = rng.uniform(0.05, 0.95, (cfg.n_layers, len(PROJS)))
    s[0, 2] = 0.0
    return s


# (port, JAX) calls of each threshold function on (cfg, jcfg, out)
THRESHOLD_CASES = {
    "uniform": lambda m, c, h: m.thresholds_for_uniform(h, c, 0.5),
    "uniform_per_module": lambda m, c, h: m.thresholds_for_uniform(
        h, c, 0.4, mlp_sparsity=0.7, self_attn_sparsity=0.2),
    "uniform_zero": lambda m, c, h: m.thresholds_for_uniform(h, c, 0.0),
    "from_sparsities": lambda m, c, h: m.thresholds_from_sparsities(
        h, c, _sparsities(c)),
    "group": lambda m, c, h: m.group_thresholds_from_sparsities(
        h, c, _sparsities(c), 32),
    "group_tail": lambda m, c, h: m.group_thresholds_from_sparsities(
        h, c, np.full((c.n_layers, 7), 0.9), 64),
    "group_uniform": lambda m, c, h: m.group_thresholds_for_uniform(
        h, c, 0.5, group_size=16),
    "model_group_sizes": lambda m, c, h: np.asarray(
        m.model_group_sizes(c, 32) + m.model_group_sizes(c, 16)),
}
GREEDY_CASES = {
    "lookup": lambda m, c, r: m.get_layer_greedy_sparsities(
        os.path.join(r, "lookup"), c, 0.2),
    "greedy": lambda m, c, r: m.thresholds_for_greedy(r, c, 0.25),
    "group_greedy": lambda m, c, r: m.group_thresholds_for_greedy(
        r, c, 0.2, block_size=32),
    "keep_fracs": lambda m, c, r: np.asarray(m.keep_fracs_from_greedy(
        os.path.join(r, "lookup"), c, 0.3)),
    "capacity_fracs": lambda m, c, r: np.asarray(
        m.capacity_fracs_for_greedy(os.path.join(r, "lookup"), c, 0.1)),
}


@pytest.mark.parametrize("case", sorted(THRESHOLD_CASES))
def test_thresholds_match_jax_bit_for_bit(calib, case):
    """From the port's histogram files, each threshold function equals
    JAX's bit for bit (the tail extrapolation too: block 64 on dim 64 has
    no g64 histogram, so s = 0.9 takes abs_icdf at 0.9^(1/64) > 0.98)."""
    cfg, jcfg, _, _, out, _ = calib
    hist = os.path.join(out, "histograms")
    got = THRESHOLD_CASES[case](tth, cfg, hist)
    want = THRESHOLD_CASES[case](jth, jcfg, hist)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if case in ("group_tail", "group_uniform"):
        assert np.all(got > 0)


def test_group_thresholds_need_the_histogram(calib):
    """Without the iid fallback a missing group histogram raises in both."""
    cfg, jcfg, _, _, out, _ = calib
    hist = os.path.join(out, "histograms")
    s = np.full((cfg.n_layers, 7), 0.5)
    for m, c in ((tth, cfg), (jth, jcfg)):
        with pytest.raises(KeyError, match="g64"):
            m.group_thresholds_from_sparsities(hist, c, s, 64,
                                               iid_fallback=False)


@pytest.mark.parametrize("case", sorted(GREEDY_CASES))
def test_greedy_thresholds_match_jax_bit_for_bit(calib, round_trip_pandas,
                                                 case):
    """From the port's greedy lookup and histograms, each greedy reader
    equals JAX's bit for bit (JAX's pandas reading the CSV correctly
    rounded, as the port's csv reader does)."""
    cfg, jcfg, _, _, out, _ = calib
    got = GREEDY_CASES[case](tth, cfg, out)
    want = GREEDY_CASES[case](jth, jcfg, out)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("level", [0.0, 0.1, 0.2, 0.25, 0.5])
def test_greedy_csv_lookup_beside_pandas(calib, level):
    """The csv reader picks the row pandas' argmin picks (the first of the
    nearest), with the values pandas reads at round-trip precision, bit
    for bit. The JAX package's reader (pandas' default parser, some units
    in the last place off) gives the same row within 1e-12, except where
    two rows lie equally far from the level up to parsing precision (0.2
    here: every greedy step on tiny adds 0.1 / 11.25 of effective
    sparsity), where it may pick the other of the two."""
    cfg, jcfg, _, _, out, _ = calib
    lookup = os.path.join(out, "lookup")
    got = tth.get_layer_greedy_sparsities(lookup, cfg, level)
    want = jth.get_layer_greedy_sparsities(lookup, jcfg, level)
    for l in range(cfg.n_layers):
        df = pd.read_csv(os.path.join(lookup, f"layer-{l}", "results.csv"),
                         float_precision="round_trip")
        dist = (df["Effective Sparsity"] - level).abs()
        row = df.iloc[dist.argmin()]
        np.testing.assert_array_equal(got[l], row[list(PROJS)].to_numpy(
            np.float64))
        near = df[dist <= dist.min() + 1e-9][list(PROJS)].to_numpy(np.float64)
        assert len(near) in (1, 2)
        assert any(np.allclose(want[l], r, rtol=1e-12, atol=0) for r in near)
        if len(near) == 1:
            np.testing.assert_allclose(got[l], want[l], rtol=1e-12, atol=0)


def _recording(module, monkeypatch):
    """Record every activation_error the module's process_layer computes."""
    seen = []
    f = module.activation_error

    def rec(*a, **k):
        seen.append(float(f(*a, **k)))
        return seen[-1]

    monkeypatch.setattr(module, "activation_error", rec)
    return seen


@pytest.mark.parametrize("layer", [0, 1])
def test_process_layer_matches_jax(calib, monkeypatch, tmp_path, layer):
    """From the same layer input and the same distributions (the port's
    histogram files), the greedy allocation reaches the same sparsities,
    its first step's seven trial errors within 2e-5 of JAX's, and both
    write the same CSV rows (errors within 2e-5)."""
    cfg, jcfg, params, jparams, out, _ = calib
    hist = os.path.join(out, "histograms")
    acts = grab_acts.load_layer_input(out, layer)
    errs, jerrs = (_recording(greedyopt, monkeypatch),
                   _recording(jgreedy, monkeypatch))
    got = greedyopt.process_layer(
        grab_acts._layer_params(params, layer), cfg, acts,
        tth.load_layer_distributions(hist, layer), **GREEDY,
        output_csv=str(tmp_path / "port" / "results.csv"))
    want = jgreedy.process_layer(
        jax.tree.map(lambda a: a[layer], jparams["layers"]), jcfg, acts,
        jth.load_layer_distributions(hist, layer), **GREEDY,
        output_csv=str(tmp_path / "jax" / "results.csv"))
    assert got == want
    assert len(errs) == len(jerrs) and len(errs) >= 8
    _close(errs[:7], jerrs[:7])
    rows = pd.read_csv(tmp_path / "port" / "results.csv")
    jrows = pd.read_csv(tmp_path / "jax" / "results.csv")
    assert list(rows.columns) == list(jrows.columns) == tth.CSV_HEADER
    np.testing.assert_array_equal(rows[list(PROJS)].to_numpy(),
                                  jrows[list(PROJS)].to_numpy())
    _close(rows["Activation Error"], jrows["Activation Error"])


def test_run_greedy_resumes(calib, tmp_path, monkeypatch):
    """resume skips a layer whose CSV reached the target, redoes one that
    did not (or whose last row was cut off), and resume=False redoes
    all."""
    cfg, _, params, _, out, _ = calib
    root = str(tmp_path / "teal")
    shutil.copytree(out, root)
    done = []
    real = greedyopt.process_layer

    def counting(lp, c, acts, distrs, **kw):
        done.append(kw["output_csv"])
        return real(lp, c, acts, distrs, **kw)

    monkeypatch.setattr(greedyopt, "process_layer", counting)
    greedyopt.run_greedy(params, cfg, root, **GREEDY)
    assert done == []                         # both layers reached 0.3
    greedyopt.run_greedy(params, cfg, root, target_sparsity=0.35,
                         base_step_size=0.1, layers=[1])
    assert len(done) == 1 and "layer-1" in done[0]
    csv0 = os.path.join(root, "lookup", "layer-0", "results.csv")
    with open(csv0) as f:
        text = f.read()
    with open(csv0, "w") as f:                 # a row cut off mid-write
        f.write(text + "0.5,0.1")
    greedyopt.run_greedy(params, cfg, root, **GREEDY)
    assert len(done) == 2 and "layer-0" in done[1]
    greedyopt.run_greedy(params, cfg, root, **GREEDY, resume=False)
    assert len(done) == 4


def test_moe_leaves_down_threshold_at_zero(tmp_path):
    """A Mixtral calibration records no shared mlp h2: the elementwise and
    group thresholds leave column 6 at 0 and calibrate the rest, equal to
    JAX's from the same files."""
    cfg, jcfg, params, _ = _model("tiny", **MOE)
    tokens = np.arange(32).reshape(1, 32) % cfg.vocab_size
    grab_acts.calibrate(params, cfg, tokens, str(tmp_path),
                        save_layer_inputs=False, group_sizes=(128,))
    hist = os.path.join(str(tmp_path), "histograms")
    assert "h2" not in tth.load_histograms(os.path.join(hist, "layer-0",
                                                        "mlp"))
    s = np.full((cfg.n_layers, 7), 0.5)
    for fn in ("thresholds_from_sparsities",
               "group_thresholds_from_sparsities"):
        args = (s, 128) if fn.startswith("group") else (s,)
        got = getattr(tth, fn)(hist, cfg, *args)
        np.testing.assert_array_equal(got, getattr(jth, fn)(hist, jcfg,
                                                            *args))
        assert np.all(got[:, 6] == 0.0) and np.all(got[:, :6] > 0.0)


def test_analysis_fits_match_jax(calib):
    """The distribution fits of a captured layer equal JAX's."""
    from teal_tpu.calibration import analysis as janalysis

    cfg, _, _, _, out, _ = calib
    hist = os.path.join(out, "histograms")
    got = analysis.analyze_layer(hist, 0)
    want = janalysis.analyze_layer(hist, 0)
    assert sorted(got) == sorted(want) == ["mlp/h1", "mlp/h2",
                                           "self_attn/h1", "self_attn/h2"]
    for k in got:
        assert got[k].__dict__ == want[k].__dict__
