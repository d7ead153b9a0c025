"""The port's verify path against the JAX package on the CPU (fp32):
`llama.block_verify` (S consecutive positions of one sequence as the
token path's rows, fixed full selection, K2's `seq_block` form) against
JAX's `block_verify` through its whole-token kernel in interpret mode,
logits and caches within 2e-5; and K2's `seq_block` form in its plain
version against one single-slot call per position in order.

The JAX interpret-mode references run in one subprocess for the module
(`jax_subprocess.jax_results`), so a hang of the interpreter fails these
cases instead of stalling the run."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax_subprocess import jax_results

from teal_tpu.config import get_model_config as jget_model_config
from teal_tpu.models import llama as jllama
from teal_tpu_torch.config import SparsityConfig, get_model_config
from teal_tpu_torch.models import llama
from teal_tpu_torch.ops.decode_attention import decode_attention

TOL = dict(rtol=2e-5, atol=2e-5)
MAX_SEQ = 48
HEADS = {"mha": (2, 2), "gqa": (4, 2)}


VERIFY_CASES = [(0, 5), (7, 5), (0, 9), (5, 12)]


@functools.lru_cache(maxsize=None)
def _model(heads):
    nh, nkv = HEADS[heads]
    kw = dict(n_layers=2, n_heads=nh, n_kv_heads=nkv, dim=128 * nh,
              intermediate_size=384, vocab_size=128)
    cfg, jcfg = get_model_config("tiny", **kw), jget_model_config("tiny", **kw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(1), jnp.float32)
    params = llama.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return cfg, jcfg, params, jparams


def _cache(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, MAX_SEQ, 128)
    return (rng.standard_normal(shape).astype(np.float32) * 0.1,
            rng.standard_normal(shape).astype(np.float32) * 0.1)


def _tokens(s):
    return np.array([[(3 * i + 1) % 127 for i in range(s)]])


def jax_block_verify(heads, pos, s):
    """JAX's block_verify through its whole-token kernel in interpret
    mode (run by `jax_results` in the subprocess)."""
    cfg, jcfg, _, jparams = _model(heads)
    assert jllama.can_block_verify(jparams, jcfg, s)
    k, v = _cache(cfg, 10 * pos + s)
    with pltpu.force_tpu_interpret_mode():
        want, wc = jllama.block_verify(
            jparams, jnp.asarray(_tokens(s), jnp.int32),
            jllama.KVCache(jnp.asarray(k), jnp.asarray(v)), pos,
            jnp.zeros((cfg.n_layers, 7), jnp.float32), cfg=jcfg)
    return dict(logits=want, k=wc.k, v=wc.v)


@pytest.fixture(scope="module")
def jax_verify(tmp_path_factory):
    cases = {f"{h}-{p}-{s}": dict(heads=h, pos=p, s=s)
             for h in HEADS for p, s in VERIFY_CASES}
    return jax_results(__file__, "jax_block_verify", cases,
                       tmp_path_factory.mktemp("jax_verify"))


@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("pos,s", VERIFY_CASES)
def test_block_verify_matches_jax(heads, pos, s, jax_verify):
    """One chunk (S <= 8) and two balanced chunks (9 -> 5 + 4, 12 -> 6 +
    6; the later chunk reads the earlier one through the cache), at pos 0
    and mid-cache."""
    cfg, _, params, _ = _model(heads)
    assert llama.can_block_verify(params, cfg, s)
    k, v = _cache(cfg, 10 * pos + s)
    th = np.zeros((cfg.n_layers, 7), np.float32)
    cache = llama.KVCache.from_numpy(k, v, device="cpu")
    got, cache = llama.block_verify(params, torch.from_numpy(_tokens(s)),
                                    cache, pos, torch.from_numpy(th), cfg=cfg)
    want = jax_verify[f"{heads}-{pos}-{s}"]
    np.testing.assert_allclose(got.numpy(), want["logits"], **TOL)
    np.testing.assert_allclose(cache.k.numpy(), want["k"], **TOL)
    np.testing.assert_allclose(cache.v.numpy(), want["v"], **TOL)


def test_block_verify_matches_dense_forward():
    """block_verify == the dense forward over the same positions (the JAX
    suite's own check, `tests/test_speculative.py:145`), in logits and in
    the cache rows written."""
    cfg, _, params, _ = _model("gqa")
    k, v = _cache(cfg, 3)
    toks = torch.arange(20, 31)[None]
    th = llama.zero_thresholds(cfg, "cpu")
    c1 = llama.KVCache.from_numpy(k, v, device="cpu")
    c2 = llama.KVCache.from_numpy(k, v, device="cpu")
    got, c1 = llama.block_verify(params, toks, c1, 9, th, cfg=cfg)
    want, c2 = llama.forward(params, toks, c2, 9, th, cfg=cfg,
                             sp=SparsityConfig())
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(c1.k.numpy(), c2.k.numpy(), **TOL)
    np.testing.assert_allclose(c1.v.numpy(), c2.v.numpy(), **TOL)


def test_can_block_verify_follows_jax():
    """The gate agrees with the reference's on S and on MoE."""
    cfg, jcfg, params, jparams = _model("mha")
    for s in (1, 2, 8, 32, 33):
        assert llama.can_block_verify(params, cfg, s) == \
            jllama.can_block_verify(jparams, jcfg, s)
    moe = get_model_config("tiny", n_layers=1, n_heads=2, n_kv_heads=2,
                           dim=256, intermediate_size=384, n_experts=4,
                           n_experts_per_tok=2)
    assert not llama.can_block_verify(params, moe, 4)
    with pytest.raises(ValueError):
        llama.block_verify(params, torch.ones(1, 1, dtype=torch.long),
                           llama.KVCache.from_numpy(*_cache(cfg, 0),
                                                    device="cpu"),
                           0, torch.zeros(2, 7), cfg=cfg)


@pytest.mark.parametrize("Hq,Hkv,window", [(4, 4, None), (8, 2, 6)])
def test_k2_seq_block_matches_slot_by_slot(Hq, Hkv, window):
    """K2's seq_block form over S = 7 consecutive positions == seven
    single-slot calls in order, each reading the rows the earlier ones
    wrote: outputs and the whole cache after the call."""
    rng = np.random.default_rng(Hq + Hkv)
    L, T, S, p0, layer = 2, 32, 7, 5, 1

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    kc, vc = rand(L, 1, Hkv, T, 128), rand(L, 1, Hkv, T, 128)
    q, kn, vn = rand(S, Hq, 128), rand(S, Hkv, 128), rand(S, Hkv, 128)
    rope = torch.rand(S, 2, 128, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(p0, p0 + S, dtype=torch.int32)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got = decode_attention(q, kn, vn, k1, v1, layer, pos, window=window,
                           rope=rope, seq_block=True)
    for i in range(S):
        want = decode_attention(q[i:i + 1], kn[i:i + 1], vn[i:i + 1], k2, v2,
                                layer, pos[i:i + 1], window=window,
                                rope=rope[i:i + 1])
        np.testing.assert_allclose(got[i:i + 1].numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-6)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    with pytest.raises(ValueError):
        decode_attention(q, kn, vn, k1.expand(L, 2, Hkv, T, 128).clone(),
                         v1.expand(L, 2, Hkv, T, 128).clone(), layer, pos,
                         seq_block=True)
