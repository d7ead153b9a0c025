"""The port's channel permutations (`teal_tpu_torch/calibration/permute.py`)
against the JAX package's on the CPU: the numpy search helpers equal on
the same arrays, `compute_permutations` equal on tiny (fp32), the folded
params equal to JAX's for the same permutations, the permuted model equal
to the unpermuted one within 1e-5 of scale (fp32), and the permuted
model's block decode (top-k at block 32) within 1e-4 of JAX's, whose
Pallas kernels run in interpret mode in a subprocess
(`jax_subprocess.jax_results`, `jax_reference` below)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_subprocess import jax_results

from teal_tpu.calibration import permute as jperm
from teal_tpu.config import SparsityConfig as JSparsityConfig
from teal_tpu.config import get_model_config as jget_model_config
from teal_tpu.models import llama as jllama
from teal_tpu_torch.calibration import permute as tperm
from teal_tpu_torch.config import SparsityConfig, get_model_config
from teal_tpu_torch.models import llama

BLOCK_KW = dict(dim=256, intermediate_size=512, n_heads=4, n_kv_heads=2,
                vocab_size=128)
BLOCK_SP = dict(enabled=True, kernel="block", block_size=32,
                block_keep_frac=0.5)
METHODS = ("magnitude", "coactivation")


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
def _model(seed: int, **kw):
    """(cfg, JAX cfg, port params, JAX params) of tiny, fp32."""
    cfg, jcfg = get_model_config("tiny", **kw), jget_model_config("tiny", **kw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    params = llama.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return cfg, jcfg, params, jparams


def _acts(seed: int = 0, P: int = 512, D: int = 256) -> np.ndarray:
    """Activations with heterogeneous channel scales and co-firing
    channels (latent gates)."""
    rng = np.random.default_rng(seed)
    z = rng.integers(0, 16, D)
    gates = np.exp(rng.normal(0, 1.2, (P, 16)))
    sigma = np.exp(rng.normal(0, 0.8, D))
    return (gates[:, z] * sigma * rng.normal(size=(P, D))).astype(np.float32)


HELPERS = {
    "channel_stats": lambda m, x: m.channel_stats(x),
    "sort_perm": lambda m, x: m.sort_perm(m.channel_stats(x)),
    "coactivation_perm": lambda m, x: m.coactivation_perm(x, 16, 0.5),
    "coactivation_perm_sub": lambda m, x: m.coactivation_perm(
        x, 32, 0.6, max_positions=100),
    "group_dropped_energy": lambda m, x: np.asarray(m.group_dropped_energy(
        x, m.sort_perm(m.channel_stats(x)), 16, 0.5)),
    "calibrated_magnitude": lambda m, x: m._calibrated_perm(
        x, 16, 0.5, "magnitude"),
    "calibrated_coactivation": lambda m, x: m._calibrated_perm(
        x, 16, 0.5, "coactivation"),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_search_helpers_match_jax(name):
    x = _acts()
    got, want = HELPERS[name](tperm, x), HELPERS[name](jperm, x)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _perms_equal(got, want) -> None:
    np.testing.assert_array_equal(got["residual"], want["residual"])
    for key in ("inter", "kv"):
        assert len(got[key]) == len(want[key])
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", METHODS)
def test_compute_permutations_match_jax(method):
    """The same permutations as JAX's from the same tokens (the captures
    agree within 2e-5; no two channel statistics are that close here)."""
    cfg, jcfg, params, jparams = _model(0)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 32))
    got = tperm.compute_permutations(params, cfg, tokens, method=method,
                                     block_size=32)
    want = jperm.compute_permutations(jparams, jcfg, tokens, method=method,
                                      block_size=32)
    _perms_equal(got, want)
    assert sorted(got["residual"].tolist()) == list(range(cfg.dim))
    with pytest.raises(ValueError):
        tperm.compute_permutations(params, cfg, tokens, method="random")


def test_apply_permutations_matches_jax():
    """The same permutations fold into the same parameters, leaf for leaf,
    bit for bit."""
    cfg, jcfg, params, jparams = _model(0)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 16))
    perms = tperm.compute_permutations(params, cfg, tokens)
    got = tperm.apply_permutations(params, perms, cfg)
    want = jperm.apply_permutations(jparams, perms, jcfg)
    for key in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert sorted(got["layers"]) == sorted(want["layers"])
    for key, leaf in got["layers"].items():
        np.testing.assert_array_equal(leaf.numpy(),
                                      np.asarray(want["layers"][key]))


def _logits(params, cfg, ids, sp=None):
    cache = llama.KVCache.init(cfg, 1, ids.shape[1], torch.float32, "cpu")
    out, _ = llama.forward(params, ids, cache, 0,
                           llama.zero_thresholds(cfg, "cpu"), cfg=cfg,
                           sp=sp or SparsityConfig())
    return out


@pytest.mark.parametrize("method", METHODS)
def test_permuted_model_is_exact(method):
    """Folded permutations are a re-parameterization: the port's permuted
    model's dense logits equal the unpermuted ones within 1e-5 of scale
    (fp32)."""
    cfg, _, params, _ = _model(0)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 32))
    perms = tperm.compute_permutations(params, cfg, tokens, method=method,
                                       block_size=32)
    pparams = tperm.apply_permutations(params, perms, cfg)
    ids = torch.from_numpy(tokens[:, :8])
    want = _logits(params, cfg, ids)
    got = _logits(pparams, cfg, ids)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


def _block_perms():
    """The port's permutations of the block-decode config (JSON lists)."""
    cfg, _, params, _ = _model(1, **BLOCK_KW)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 16))
    perms = tperm.compute_permutations(params, cfg, tokens)
    return {"residual": perms["residual"].tolist(),
            "inter": [p.tolist() for p in perms["inter"]],
            "kv": [p.tolist() for p in perms["kv"]]}


def jax_reference(perms):
    """JAX's permuted tiny model (the block config, the given
    permutations): logits of one block-sparse decode step at pos 0 with
    the Pallas kernels in interpret mode (run by `jax_results` in the
    subprocess)."""
    from jax.experimental.pallas import tpu as pltpu

    _, jcfg, _, jparams = _model(1, **BLOCK_KW)
    pp = jperm.apply_permutations(
        jparams, {"residual": np.asarray(perms["residual"], np.int32),
                  "inter": [np.asarray(p, np.int32) for p in perms["inter"]],
                  "kv": [np.asarray(p, np.int32) for p in perms["kv"]]},
        jcfg)
    cache = jllama.KVCache.init(jcfg, 1, 8, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        lg, _ = jllama.forward(pp, jnp.array([[3]], jnp.int32), cache, 0,
                               jllama.zero_thresholds(jcfg), cfg=jcfg,
                               sp=JSparsityConfig(**BLOCK_SP))
    return {"logits": np.asarray(lg)}


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    return jax_results(__file__, "jax_reference",
                       {"block": dict(perms=_block_perms())},
                       tmp_path_factory.mktemp("jax_permute"))


def test_permuted_block_decode_matches_jax(jax_refs):
    """The permuted model drives the port's block decode path (K3 in top-k
    mode, its plain version here) to JAX's logits within 1e-4 of scale."""
    cfg, _, params, _ = _model(1, **BLOCK_KW)
    perms = {k: (np.asarray(v, np.int32) if k == "residual"
                 else [np.asarray(p, np.int32) for p in v])
             for k, v in _block_perms().items()}
    pparams = tperm.apply_permutations(params, perms, cfg)
    cache = llama.KVCache.init(cfg, 1, 8, torch.float32, "cpu")
    got, _ = llama.forward(pparams, torch.tensor([[3]]), cache, 0,
                           llama.zero_thresholds(cfg, "cpu"), cfg=cfg,
                           sp=SparsityConfig(**BLOCK_SP))
    want = jax_refs["block"]["logits"]
    assert np.isfinite(got.numpy()).all()
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()), err
