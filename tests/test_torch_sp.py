"""The port's sequence-parallel prefill (`teal_tpu_torch/parallel/sp.py`)
against the JAX package's `teal_tpu/parallel/sp.py` at the same degree,
on the same numpy weights and caches, with real gloo ranks: sp 2 and 4,
a nonzero base, the ("sp", "tp") composition and the prefill-to-decode
hand-off on one mesh (tests/test_sp.py, tests/test_composed.py).

The port's cases run once for the module in a group of four rank
processes (`torch_parallel_cases.Ranks`) while the JAX references run
here on the 8-device CPU mesh of conftest.py (no Pallas kernel on this
path); the sp x tp cases run at sp 2 x tp 2 (the reference's
tests/test_composed.py takes sp 4 x tp 2 over 8 devices). Tolerances
are the reference tests': logits 1e-4, caches 1e-5, and a relative
error of 1e-5 for the compositions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from teal_tpu.config import SparsityConfig as JSparsityConfig
from teal_tpu.config import get_model_config as jget_model_config
from teal_tpu.models import llama as jllama
from teal_tpu.parallel import shard_params as jshard_params
from teal_tpu.parallel.sp import make_sp_mesh as jmake_sp_mesh
from teal_tpu.parallel.sp import sp_prefill as jsp_prefill
from torch_parallel_cases import Ranks, error_of, np_cache, np_params

WORLD = 4
TINY = {}
COMPOSED = dict(n_layers=2, n_heads=8, n_kv_heads=4, dim=256,
                intermediate_size=512, vocab_size=512)
TOKS = (np.arange(16) * 3 % 512).reshape(2, 8).tolist()
TILED = np.tile(np.arange(8), (2, 1)).tolist()

CASES = {
    "sp2": dict(cfg=TINY, seed=0, n_sp=2, tokens=TOKS),
    "sp4": dict(cfg=TINY, seed=0, n_sp=4, tokens=TOKS),
    "sp2-base6": dict(cfg=TINY, seed=1, n_sp=2, tokens=[[5, 9, 2, 6]],
                      base=6, cache_seed=2),
    "sp2-tp2": dict(cfg=COMPOSED, seed=3, n_sp=2, tp=2, tokens=TILED),
    "sp2-tp2-handoff": dict(cfg=COMPOSED, seed=4, n_sp=2, tp=2,
                            tokens=TILED, next_tokens=[[9], [3]]),
    "indivisible": dict(cfg=TINY, seed=0, n_sp=4, tokens=[[1] * 6]),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)


def _jax_sp(cfg, seed, n_sp, tokens, tp=1, base=0, max_seq=16,
            cache_seed=None, next_tokens=None):
    c = jget_model_config("tiny", **cfg)
    params = jax.tree.map(jnp.asarray, np_params(cfg, seed))
    toks = jnp.asarray(tokens, jnp.int32)
    k, v = np_cache(cfg, toks.shape[0], max_seq, cache_seed)
    cache = jllama.KVCache(k=jnp.asarray(k), v=jnp.asarray(v))
    th, spc = jllama.zero_thresholds(c), JSparsityConfig()
    mesh = jmake_sp_mesh(n_sp, devices=jax.devices()[:n_sp * tp], tp=tp)
    out = {}
    if tp > 1:
        params = jshard_params(params, mesh, c)
    with jax.set_mesh(mesh):
        logits, cache = jax.jit(lambda p, cc, t: jsp_prefill(
            p, toks, cc, base, t, cfg=c, sp=spc, mesh=mesh))(params, cache,
                                                            th)
        out["logits"] = np.asarray(logits)
        if next_tokens is not None:
            nt = jnp.asarray(next_tokens, jnp.int32)
            logits, cache = jax.jit(lambda p, cc, t: jllama.forward(
                p, nt, cc, base + toks.shape[1], t, cfg=c, sp=spc))(
                    params, cache, th)
            out["logits2"] = np.asarray(logits)
    out["k"], out["v"] = np.asarray(cache.k), np.asarray(cache.v)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ranks = Ranks(WORLD, {n: ("sp_run", kw) for n, kw in CASES.items()},
                  tmp_path_factory.mktemp("sp_ranks"))
    try:
        jax_out = {n: _jax_sp(**kw) for n, kw in CASES.items()
                   if n != "indivisible"}
    finally:
        port = ranks.join()
    return jax_out, port


@pytest.mark.parametrize("case", ["sp2", "sp4", "sp2-base6"])
def test_sp_prefill_matches_jax(case, results):
    """Logits (1e-4) and the replicated cache (1e-5) equal the JAX
    package's `sp_prefill` at the same degree, on every rank bit for
    bit."""
    jax_out, port = results
    n = CASES[case]["n_sp"]
    for r in range(n):
        got = port[case][r]
        assert not error_of(got), error_of(got)
        np.testing.assert_allclose(got["logits"], jax_out[case]["logits"],
                                   rtol=1e-4, atol=1e-4)
        for name in ("k", "v"):
            np.testing.assert_allclose(got[name], jax_out[case][name],
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        np.testing.assert_array_equal(got["logits"], port[case][0]["logits"])


@pytest.mark.parametrize("case", ["sp2-tp2", "sp2-tp2-handoff"])
def test_sp_tp_composed_matches_jax(case, results):
    """On an ("sp", "tp") mesh the prefill's logits and head-sharded cache,
    and the decode step that follows on the same mesh and cache through
    the sharded forward, are within 1e-5 (relative) of the JAX package's
    composition."""
    jax_out, port = results
    for r in range(4):
        got = port[case][r]
        assert not error_of(got), error_of(got)
        for name in ("logits", "logits2", "k", "v"):
            if name in jax_out[case]:
                assert _rel(got[name], jax_out[case][name]) < 1e-5, (r, name)


def test_sp_rejects_indivisible_seq(results):
    """A prompt of 6 tokens over sp 4: ValueError "not divisible", as the
    reference raises."""
    _, port = results
    c = jget_model_config("tiny")
    params = jax.tree.map(jnp.asarray, np_params(TINY, 0))
    with pytest.raises(ValueError, match="not divisible"):
        jsp_prefill(params, jnp.ones((1, 6), jnp.int32),
                    jllama.KVCache.init(c, 1, 16, jnp.float32), 0,
                    jllama.zero_thresholds(c), cfg=c, sp=JSparsityConfig(),
                    mesh=jmake_sp_mesh(4))
    for r in range(WORLD):
        err = error_of(port["indivisible"][r])
        assert err.startswith("ValueError") and "not divisible" in err, err
