"""`llama.forward(..., return_hidden=True)`: the final-normed hidden state
[B, S, dim] in place of the logits, against the JAX package's
`forward(return_hidden=True)` on the same numpy weights, within 2e-5 in
fp32, on each route:

  - the token path (batch 1 and the batched rows; K1 / K2's plain
    versions on the CPU) against JAX's whole-token kernel in interpret
    mode, run in one child process (`jax_subprocess.jax_results`);
  - the layer loop (a dense prefill, a TEAL decode step) against JAX's
    XLA forward here;
  - the sharded forward at tp 2 on two gloo ranks
    (`torch_parallel_cases.hidden_tp`) against JAX's GSPMD forward on a
    2-device tp mesh, and against the port's single-process forward.

The logits of the same calls stay as they were: the head of the hidden
state is the logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_subprocess import jax_results

from teal_tpu.config import SparsityConfig as JSparsityConfig
from teal_tpu.config import get_model_config as jget_model_config
from teal_tpu.models import llama as jllama
from teal_tpu.parallel import make_mesh as jmake_mesh
from teal_tpu.parallel import tp as jtp
from teal_tpu_torch.config import SparsityConfig
from teal_tpu_torch.models import llama
from torch_parallel_cases import (Ranks, error_of, model_config, np_cache,
                                  np_params, port_params)

CFG = dict(n_layers=2, n_heads=2, n_kv_heads=1, dim=256,
           intermediate_size=384, vocab_size=128)             # head_dim 128
TP_CFG = dict(n_heads=4, n_kv_heads=4)                        # tiny, dim 64
MAIN = dict(enabled=True, kernel="block", block_size=128,
            block_keep_frac=0.5, block_thresholding=True)
TH = np.array([2.6, 2.6, 2.6, 0.12, 2.65, 2.65, 0.12], np.float32)
TOL = dict(rtol=2e-5, atol=2e-5)
T = 16
TOKEN_CASES = {"b1": dict(tokens=[[9]], pos=[5]),
               "b2": dict(tokens=[[9], [4]], pos=[5, 11])}
TP_CASE = dict(cfg=TP_CFG, seed=2, tp=2, tokens=[[5, 3, 8, 1]],
               next_tokens=[[7]])


def _thresholds():
    return np.tile(TH, (CFG["n_layers"], 1))


def _cache(b):
    k, v = np_cache(CFG, 1, T, seed=4)
    return np.repeat(k, b, axis=1), np.repeat(v, b, axis=1)


def jax_token_hidden(tokens, pos):
    """JAX's token path with `return_hidden` in interpret mode (run by
    `jax_results` in the subprocess)."""
    from jax.experimental.pallas import tpu as pltpu

    jcfg = jget_model_config("tiny", **CFG)
    params = jax.tree.map(jnp.asarray, np_params(CFG, 1))
    k, v = _cache(len(tokens))
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for hidden in (True, False):
            got, _ = jllama.forward(
                params, jnp.asarray(tokens, jnp.int32),
                jllama.KVCache(jnp.asarray(k), jnp.asarray(v)),
                jnp.asarray(pos, jnp.int32), jnp.asarray(_thresholds()),
                cfg=jcfg, sp=JSparsityConfig(**MAIN,
                                             fused_decode_attention=True),
                return_hidden=hidden)
            out["hidden" if hidden else "logits"] = np.asarray(got)
    return out


def _jax_tp_hidden(cfg, seed, tp, tokens, next_tokens, max_seq=16):
    jcfg = jget_model_config("tiny", **cfg)
    params = jax.tree.map(jnp.asarray, np_params(cfg, seed))
    mesh = jmake_mesh(tp=tp, dp=1, devices=jax.devices()[:tp])
    sharded = jtp.shard_params(params, mesh, jcfg)
    toks = jnp.asarray(tokens, jnp.int32)
    nt = jnp.asarray(next_tokens, jnp.int32)
    cache = jtp.shard_cache(jllama.KVCache.init(jcfg, toks.shape[0], max_seq,
                                                jnp.float32), mesh)
    th, sp = jllama.zero_thresholds(jcfg), JSparsityConfig()
    with jax.set_mesh(mesh):
        h, cache = jax.jit(lambda p, c: jllama.forward(
            p, toks, c, 0, th, cfg=jcfg, sp=sp, return_hidden=True))(
                sharded, cache)
        h2, _ = jax.jit(lambda p, c: jllama.forward(
            p, nt, c, toks.shape[1], th, cfg=jcfg, sp=sp,
            return_hidden=True))(sharded, cache)
    return np.asarray(h), np.asarray(h2)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    d = tmp_path_factory.mktemp("hidden")
    ranks = Ranks(2, {"tp": ("hidden_tp", TP_CASE)}, d / "ranks")
    try:
        jax_out = jax_results(__file__, "jax_token_hidden", TOKEN_CASES, d)
        jax_tp = _jax_tp_hidden(**TP_CASE)
    finally:
        port = ranks.join()
    for r in range(2):
        assert not error_of(port["tp"][r]), error_of(port["tp"][r])
    return jax_out, jax_tp, port["tp"]


@pytest.mark.parametrize("case", list(TOKEN_CASES))
def test_hidden_on_token_path_matches_jax(case, refs):
    """The token path (batch 1, and two rows at their own positions)
    returns JAX's token-kernel hidden state [B, 1, dim]; the logits of
    the same step are unchanged."""
    jax_out, _, _ = refs
    cfg = model_config(CFG)
    params = port_params(CFG, 1)
    kw = TOKEN_CASES[case]
    sp = SparsityConfig(**MAIN)
    b = len(kw["tokens"])
    assert llama.can_token_decode(params, cfg, sp, 1, b, torch.float32)
    for hidden in (True, False):
        k, v = _cache(b)
        got, _ = llama.forward(
            params, torch.tensor(kw["tokens"]),
            llama.KVCache.from_numpy(k, v, device="cpu"), kw["pos"],
            torch.from_numpy(_thresholds()), cfg=cfg, sp=sp,
            return_hidden=hidden)
        want = jax_out[case]["hidden" if hidden else "logits"]
        assert got.shape == ((b, 1, cfg.dim) if hidden
                             else (b, 1, cfg.vocab_size))
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("sp_kw", [dict(), dict(enabled=True, mode="teal")],
                         ids=["dense", "teal"])
def test_hidden_on_layer_loop_matches_jax(sp_kw):
    """The layer loop: a 6-token prefill and a decode step after it return
    JAX's hidden states; `_lm_head` of the hidden state is the logits."""
    cfg = model_config(CFG)
    jcfg = jget_model_config("tiny", **CFG)
    params = port_params(CFG, 1)
    jparams = jax.tree.map(jnp.asarray, np_params(CFG, 1))
    th = np.full((CFG["n_layers"], 7), 0.02, np.float32)
    cache = llama.KVCache.init(cfg, 1, T, torch.float32, "cpu")
    jcache = jllama.KVCache.init(jcfg, 1, T, jnp.float32)
    sp, jsp = SparsityConfig(**sp_kw), JSparsityConfig(**sp_kw)
    for toks, pos in (([[3, 1, 4, 1, 5, 9]], 0), ([[2]], 6)):
        logits, _ = llama.forward(
            params, torch.tensor(toks),
            llama.KVCache(cache.k.clone(), cache.v.clone()), pos,
            torch.from_numpy(th), cfg=cfg, sp=sp)
        got, cache = llama.forward(params, torch.tensor(toks), cache, pos,
                                   torch.from_numpy(th), cfg=cfg, sp=sp,
                                   return_hidden=True)
        want, jcache = jllama.forward(jparams, jnp.asarray(toks, jnp.int32),
                                      jcache, pos, jnp.asarray(th), cfg=jcfg,
                                      sp=jsp, return_hidden=True)
        assert got.shape == (1, len(toks[0]), cfg.dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        torch.testing.assert_close(llama._lm_head(params, got), logits,
                                   rtol=0, atol=0)


def test_hidden_on_sharded_forward_matches_jax(refs):
    """At tp 2 the hidden state of a prefill and a decode step (before the
    logits' gather) equals JAX's GSPMD forward and the port's
    single-process forward, and is the same on both ranks."""
    _, (want, want2), port = refs
    for r in range(2):
        res = port[r]
        assert res["hidden"].shape == (1, 4, model_config(TP_CFG).dim)
        np.testing.assert_allclose(res["hidden"], want, **TOL)
        np.testing.assert_allclose(res["hidden2"], want2, **TOL)
        np.testing.assert_allclose(res["hidden"], res["single_hidden"], **TOL)
        np.testing.assert_allclose(res["hidden2"], res["single_hidden2"],
                                   **TOL)
        np.testing.assert_array_equal(res["hidden"], port[0]["hidden"])
