"""The port's continuous-batching server on a tensor-parallel group
(`engine/serving.py` with `mesh=`) against the JAX package's engine on
tp-sharded params and a head-sharded cache (`tests/test_serving.py`'s
`test_serving_on_tp_mesh_matches_unsharded`: its config, submissions and
greedy fp32 decode) and against the port's own single-process server.

The port's server runs on four gloo ranks (`torch_parallel_cases.Ranks`,
tp 4, one group for the module); the JAX engines run meanwhile in one
child process (`jax_subprocess.jax_results`) on a 4-device tp mesh of
its 8 CPU devices. Greedy tokens must be equal, token for token; at
temperature > 0 every rank must draw the same tokens. A head-128 config
admits a 200-token prompt (padded to 256) through K6 on each rank's
heads (its plain version on the CPU).
"""

import numpy as np
import pytest
import torch
from jax_subprocess import jax_results

from teal_tpu_torch.config import SparsityConfig
from teal_tpu_torch.models import llama
from teal_tpu_torch.parallel import make_mesh, tp as tpm
from torch_parallel_cases import (Ranks, error_of, model_config, np_params,
                                  port_params)

WORLD = 4
TP = 4
# tests/test_serving.py:121-136
CFG = dict(dim=256, intermediate_size=384, n_heads=4, n_kv_heads=4,
           vocab_size=128)
SUBMIT = [[[1, 2, 3], 5], [[7, 5], 5]]
SEED = 6
LONG_CFG = dict(n_layers=2, n_heads=4, n_kv_heads=4, dim=512,
                intermediate_size=768, vocab_size=128)      # head_dim 128
LONG_PROMPT = np.random.default_rng(3).integers(1, 128, 200).tolist()
BLOCK_SP = dict(enabled=True, kernel="block", block_size=32,
                block_thresholding=True)

# case: serve_tp kwargs (the JAX engine takes the same, less `single`)
SERVED = {
    "oneshot": dict(cfg=CFG, seed=SEED, tp=TP, submissions=SUBMIT,
                    single=True),
    "chunked": dict(cfg=CFG, seed=SEED, tp=TP, submissions=SUBMIT,
                    prefill_chunk=2, single=True),
    "long": dict(cfg=LONG_CFG, seed=8, tp=TP, max_seq=272, single=True,
                 submissions=[[LONG_PROMPT, 4], [[3, 1, 4], 4]]),
}
OTHER = {
    "sampled": dict(cfg=CFG, seed=SEED, tp=TP, submissions=SUBMIT,
                    temperature=0.8),
    "refused": dict(cfg=CFG, seed=SEED, tp=TP, submissions=SUBMIT,
                    sp=BLOCK_SP, th=0.0),
}


def jax_engine(cfg, seed, tp, submissions, slots=2, max_seq=32,
               prefill_chunk=None, single=False):
    """The JAX engine on tp-sharded params and a head-sharded cache over
    `tp` CPU devices, greedy in fp32 (run by `jax_results` in the
    subprocess): {out<id>: tokens}."""
    import jax
    import jax.numpy as jnp

    from teal_tpu.config import get_model_config
    from teal_tpu.engine.serving import ContinuousBatchingEngine
    from teal_tpu.parallel import make_mesh as jmake_mesh
    from teal_tpu.parallel import tp as jtp

    c = get_model_config("tiny", **cfg)
    params = jax.tree.map(jnp.asarray, np_params(cfg, seed))
    mesh = jmake_mesh(tp=tp, dp=1, devices=jax.devices()[:tp])
    eng = ContinuousBatchingEngine(
        c, jtp.shard_params(params, mesh, c), slots=slots, max_seq=max_seq,
        temperature=0.0, cache_dtype=jnp.float32, prefill_chunk=prefill_chunk)
    eng.cache = jtp.shard_cache(eng.cache, mesh)
    for prompt, n in submissions:
        eng.submit(prompt, n)
    return {f"out{r.id}": np.array(r.out) for r in eng.run()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving_tp")
    cases = {n: ("serve_tp", kw) for n, kw in {**SERVED, **OTHER}.items()}
    ranks = Ranks(WORLD, cases, d / "ranks")
    try:
        jax_out = jax_results(__file__, "jax_engine", SERVED, d)
    finally:
        port = ranks.join()
    for case, per in port.items():
        for r in range(WORLD):
            assert not error_of(per[r]), (case, r, error_of(per[r]))
    return jax_out, port


def _outs(res, prefix=""):
    return {k[len(prefix):]: v.tolist() for k, v in res.items()
            if k.startswith(prefix + "out")}


@pytest.mark.parametrize("case", list(SERVED))
def test_server_on_tp_group_matches_jax_and_single_process(case, results):
    """Every request's greedy tokens on every rank equal the JAX engine's
    on a 4-device tp mesh and the port's single-process server's, token
    for token."""
    jax_out, port = results
    want = _outs(jax_out[case])
    assert len(want) == len(SERVED[case]["submissions"])
    assert [len(want[f"out{i}"]) for i in range(len(want))] == \
        [n for _, n in SERVED[case]["submissions"]]
    assert _outs(port[case][0], "single_") == want
    for r in range(WORLD):
        assert _outs(port[case][r]) == want, r


def test_chunked_admission_matches_oneshot_on_tp_group(results):
    """Chunked admission (2 positions a step) on the tp group gives the
    one-shot admission's tokens."""
    _, port = results
    assert port["chunked"][0]["sub_shapes"][:, 3].tolist() == [4, 2]
    for r in range(WORLD):
        assert _outs(port["chunked"][r]) == _outs(port["oneshot"][r])


@pytest.mark.parametrize("case", list(SERVED))
def test_rank_cache_holds_its_heads(case, results):
    """The rank's cache and every admission sub-cache are allocated with
    n_kv_heads / tp heads (the single-process server's with all)."""
    _, port = results
    c = model_config(SERVED[case]["cfg"])
    kw = SERVED[case]
    want = [c.n_layers, kw.get("slots", 2), c.n_kv_heads // TP,
            kw.get("max_seq", 32), c.head_dim]
    for r in range(WORLD):
        res = port[case][r]
        assert res["cache_shape"].tolist() == want
        subs = res["sub_shapes"]
        assert len(subs) == len(kw["submissions"])
        assert (subs[:, 2] == c.n_kv_heads // TP).all()
        assert (subs[:, 1] == 1).all()
    single = port[case][0]
    assert single["single_cache_shape"][2] == c.n_kv_heads
    assert (single["single_sub_shapes"][:, 2] == c.n_kv_heads).all()


def test_long_prompt_admitted_through_k6_on_rank_heads(results):
    """One-shot admission of a 200-token prompt (padded to 256) calls K6
    once a layer on the rank's n_heads / tp heads; the 3-token prompt
    does not (the single-process server's calls take every head)."""
    _, port = results
    c = model_config(LONG_CFG)
    for r in range(WORLD):
        q = port["long"][r]["k6_q"]
        assert q.tolist() == [[1, c.n_heads // TP, 256, c.head_dim]] * \
            c.n_layers
    assert port["long"][0]["single_k6_q"].tolist() == \
        [[1, c.n_heads, 256, c.head_dim]] * c.n_layers


def test_sampled_tokens_agree_across_ranks(results):
    """At temperature 0.8 every rank's generator, seeded alike, draws the
    same tokens in the same order."""
    _, port = results
    outs = [_outs(port["sampled"][r]) for r in range(WORLD)]
    assert [len(outs[0][f"out{i}"]) for i in range(2)] == [5, 5]
    for r in range(1, WORLD):
        assert outs[r] == outs[0]


def test_block_kernel_decode_refused_at_first_step(results):
    """A server whose config decodes through the block kernel at one token
    raises `check_sharded`'s ValueError at its first decode step, before
    any token is out."""
    _, port = results
    c = model_config(CFG)
    mesh = make_mesh(tp=1)
    local = tpm.shard_params(port_params(CFG, SEED), mesh, c)
    with pytest.raises(ValueError) as e:
        llama.check_sharded(local, c, SparsityConfig(**BLOCK_SP), 1)
    for r in range(WORLD):
        res = port["refused"][r]
        assert str(res["raised"]) == f"ValueError: {e.value}"
        assert int(res["steps"]) == 0 and int(res["tokens_out"]) == 0


def test_server_refuses_a_mesh_split_beyond_tp():
    """The server shards over tp only: a rank outside the mesh, or a mesh
    that splits another axis, raises."""
    from teal_tpu_torch.engine import ContinuousBatchingEngine
    from teal_tpu_torch.parallel.mesh import Mesh

    c = model_config(CFG)
    params = port_params(CFG, SEED)
    mesh = make_mesh(tp=1)
    mesh.shape = {"dp": 2, "tp": 1}
    with pytest.raises(ValueError, match="tp only"):
        ContinuousBatchingEngine(c, params, mesh=mesh, device="cpu")
    outside = Mesh(np.array([[0]]), ("dp", "tp"))
    outside.coords = None
    with pytest.raises(ValueError, match="not in the server's mesh"):
        ContinuousBatchingEngine(c, params, mesh=outside, device="cpu")
    eng = ContinuousBatchingEngine(c, params, mesh=make_mesh(tp=1),
                                   device="cpu", cache_dtype=torch.float32)
    assert eng.tp == 1 and eng.cache.k.shape[2] == c.n_kv_heads
