"""The port's pipeline parallelism (`teal_tpu_torch/parallel/pp.py`)
against the JAX package's `teal_tpu/parallel/pp.py` at the same degree,
on the same numpy weights and caches, with real gloo ranks: (stages,
microbatches) = (2, 2), (4, 1), (4, 4), a decode step at per-row
positions with sparsity, a quantized head, and the dp x pp x tp
composition (tests/test_pp.py, tests/test_composed.py).

The port's cases run once for the module in a group of eight rank
processes (`torch_parallel_cases.Ranks`; dp 2 x pp 2 x tp 2 takes all
eight) while the JAX references run here on the 8-device CPU mesh of
conftest.py (no Pallas kernel on this path). Tolerances are the
reference tests': logits 1e-4 (2e-4 for the int8 head), caches 1e-5, a
relative error of 1e-5 for the compositions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from teal_tpu.config import SparsityConfig as JSparsityConfig
from teal_tpu.config import get_model_config as jget_model_config
from teal_tpu.models import llama as jllama
from teal_tpu.ops.quant import quantize_int8 as jquantize_int8
from teal_tpu.parallel import pp as jpp
from teal_tpu_torch.parallel import pp as ppm
from torch_parallel_cases import (Ranks, error_of, model_config, np_cache,
                                  np_params, port_params)

WORLD = 8
L4 = dict(n_layers=4)
COMPOSED = dict(n_layers=4, n_heads=8, n_kv_heads=4, dim=256,
                intermediate_size=512, vocab_size=512)
TEAL = dict(enabled=True, apply_prefill=True)


def _toks(b, s):
    return (np.arange(b * s) % 512).reshape(b, s).tolist()


TILED = np.tile(np.arange(8), (4, 1)).tolist()
# case: (pp_run kwargs, logits tol, cache tol); rel: the compositions
CASES = {
    "pp2-m2": (dict(cfg=L4, seed=0, pp=2, n_micro=2, tokens=_toks(4, 4)),
               1e-4, 1e-5),
    "pp4-m1": (dict(cfg=L4, seed=0, pp=4, n_micro=1, tokens=_toks(4, 4)),
               1e-4, 1e-5),
    "pp4-m4": (dict(cfg=L4, seed=0, pp=4, n_micro=4, tokens=_toks(4, 4)),
               1e-4, 1e-5),
    "pp2-decode-teal": (dict(cfg=L4, seed=1, pp=2, n_micro=2,
                             tokens=[[3], [7], [1], [9]], pos=[2, 5, 0, 3],
                             sp=dict(enabled=True), th=0.05, cache_seed=2),
                        1e-4, 1e-5),
    "pp2-int8-head": (dict(cfg=L4, seed=3, pp=2, n_micro=2,
                           tokens=[[1, 2, 3, 4], [5, 6, 7, 8]], max_seq=16,
                           quant="int8-head"), 2e-4, 1e-5),
    "dp2-pp2-tp2": (dict(cfg=COMPOSED, seed=4, pp=2, dp=2, tp=2, n_micro=2,
                         tokens=TILED, max_seq=16), "rel", "rel"),
    "dp2-pp2-tp2-teal": (dict(cfg=COMPOSED, seed=5, pp=2, dp=2, tp=2,
                              n_micro=2, tokens=TILED, max_seq=16, sp=TEAL,
                              th=0.02), "rel", "rel"),
}
ERRORS = {
    "layers-pp3": dict(cfg=L4, seed=0, pp=3, n_micro=1, tokens=_toks(2, 4)),
    "batch-3-m2": dict(cfg=L4, seed=0, pp=2, n_micro=2, tokens=_toks(3, 4)),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)


def _jparams(cfg, seed, quant=None):
    params = jax.tree.map(jnp.asarray, np_params(cfg, seed))
    if quant == "int8-head":
        q = jquantize_int8(params["lm_head"])
        params = dict(params, lm_head={"q": q.q, "scale": q.scale})
    return params


def _jax_pp(cfg, seed, pp, n_micro, tokens, dp=1, tp=1, pos=0, max_seq=8,
            sp=None, th=None, quant=None, cache_seed=None):
    c = jget_model_config("tiny", **cfg)
    params = _jparams(cfg, seed, quant)
    toks = jnp.asarray(tokens, jnp.int32)
    k, v = np_cache(cfg, toks.shape[0], max_seq, cache_seed)
    mesh = jpp.make_pp_mesh(pp, devices=jax.devices()[:dp * pp * tp], dp=dp,
                            tp=tp)
    sharded = jpp.pp_shard_params(params, mesh, c)
    cache = jpp.pp_shard_cache(jllama.KVCache(k=jnp.asarray(k),
                                              v=jnp.asarray(v)), mesh)
    thr = (jllama.zero_thresholds(c) if th is None
           else jnp.full((c.n_layers, 7), th, jnp.float32))
    spc = JSparsityConfig(**(sp or {}))
    pos = jnp.asarray(pos, jnp.int32)
    with jax.set_mesh(mesh):
        logits, cache = jax.jit(lambda p, cc, t: jpp.pp_forward(
            p, toks, cc, pos, t, cfg=c, sp=spc, mesh=mesh,
            n_micro=n_micro))(sharded, cache, thr)
    return {"logits": np.asarray(logits), "k": np.asarray(cache.k),
            "v": np.asarray(cache.v)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cases = {n: ("pp_run", kw) for n, (kw, _, _) in CASES.items()}
    cases.update({n: ("pp_run", kw) for n, kw in ERRORS.items()})
    ranks = Ranks(WORLD, cases, tmp_path_factory.mktemp("pp_ranks"))
    try:
        jax_out = {n: _jax_pp(**kw) for n, (kw, _, _) in CASES.items()}
    finally:
        port = ranks.join()
    return jax_out, port


@pytest.mark.parametrize("case", list(CASES))
def test_pp_forward_matches_jax(case, results):
    """Logits and the full cache (every stage's layer slab, gathered)
    equal the JAX package's `pp_forward` at the same degree; the logits
    reach every rank bit for bit."""
    jax_out, port = results
    kw, tol, ctol = CASES[case]
    n = kw["pp"] * kw.get("dp", 1) * kw.get("tp", 1)
    want = jax_out[case]
    for r in range(n):
        got = port[case][r]
        assert not error_of(got), error_of(got)
        np.testing.assert_array_equal(got["logits"], port[case][0]["logits"])
    got = port[case][0]
    for name in ("logits", "k", "v"):
        if tol == "rel":
            assert _rel(got[name], want[name]) < 1e-5, name
        else:
            t = tol if name == "logits" else ctol
            np.testing.assert_allclose(got[name], want[name], rtol=t, atol=t,
                                       err_msg=name)


def test_pp_raises_like_jax(results):
    """4 layers over 3 stages, and a batch of 3 in 2 microbatches: both
    packages raise ValueError "not divisible"."""
    _, port = results
    c = jget_model_config("tiny", **L4)
    params = _jparams(L4, 0)
    with pytest.raises(ValueError, match="not divisible"):
        jpp.pp_shard_params(params, jpp.make_pp_mesh(
            3, devices=jax.devices()[:3]), c)
    mesh = jpp.make_pp_mesh(2, devices=jax.devices()[:2])
    with pytest.raises(ValueError, match="not divisible"):
        jpp.pp_forward(jpp.pp_shard_params(params, mesh, c),
                       jnp.ones((3, 4), jnp.int32),
                       jpp.pp_shard_cache(jllama.KVCache.init(
                           c, 3, 8, jnp.float32), mesh), 0,
                       jllama.zero_thresholds(c), cfg=c,
                       sp=JSparsityConfig(), mesh=mesh, n_micro=2)
    for case, n in (("layers-pp3", WORLD), ("batch-3-m2", 2)):
        for r in range(n):
            err = error_of(port[case][r])
            assert err.startswith("ValueError") and "not divisible" in err, \
                (case, r, err)


def _specs_tuples(tree):
    if isinstance(tree, dict):
        return {k: _specs_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("tp", [False, True])
def test_pp_param_specs_match_jax(tp):
    """`pp_param_specs` (layer slabs over "pp"; with tp=True the Megatron
    splits too) names the reference's split dims, with an int8 head."""
    cfg = COMPOSED
    params = port_params(cfg, 0, "int8-head")
    jparams = _jparams(cfg, 0, "int8-head")
    c, jc = model_config(cfg), jget_model_config("tiny", **cfg)
    got = ppm.pp_param_specs(params, c, tp=tp)
    want = _specs_tuples(jpp.pp_param_specs(jparams, jc, tp=tp))
    assert got == want
