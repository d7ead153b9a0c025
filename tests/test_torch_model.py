"""The port's model and engine against the JAX package on the CPU (fp32):
the main decode path (token path, K1/K2 plain versions) against the JAX
masked-dense group twin and against the JAX whole-token Pallas kernel in
interpret mode; dense prefill and decode; greedy generation;
`debug_fixed_selection` on the token path (against the JAX token kernel
in interpret mode) and on the layer loop, where it changes nothing. The
interpret-mode references run once per module, in one subprocess
(`jax_subprocess.jax_results`, `jax_reference` below), so a hang of the
interpreter fails these cases instead of stalling the run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax_subprocess import jax_results

from teal_tpu.config import SparsityConfig as JSparsityConfig
from teal_tpu.config import get_model_config as jget_model_config
from teal_tpu.engine import Generator as JGenerator
from teal_tpu.models import llama as jllama
from teal_tpu_torch.config import SparsityConfig, get_model_config
from teal_tpu_torch.engine import Generator
from teal_tpu_torch.models import llama
from teal_tpu_torch.ops import block_gemv

CFG_KW = dict(n_layers=3, n_heads=2, n_kv_heads=1, dim=256,
              intermediate_size=384, vocab_size=128)
MAIN = dict(enabled=True, kernel="block", block_size=128,
            block_keep_frac=0.5, block_thresholding=True)
TWIN = dict(MAIN, kernel="masked_dense", mode="group")
TOL = dict(rtol=2e-5, atol=2e-5)
T = 16


@pytest.fixture(scope="module")
def model():
    cfg = get_model_config("tiny", **CFG_KW)
    jcfg = jget_model_config("tiny", **CFG_KW)
    assert cfg.head_dim == 128
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(7), jnp.float32)
    params = llama.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return cfg, jcfg, params, jparams, _thresholds(cfg)


def _thresholds(cfg):
    """Per-layer group thresholds, equal within each fused stage (q=k=v,
    gate=up), near the median group score of each stage's input so that
    stages keep some groups and drop others."""
    base = np.array([2.6, 2.6, 2.6, 0.12, 2.65, 2.65, 0.12], np.float32)
    th = base[None] * (1 + 0.03 * np.arange(cfg.n_layers)[:, None])
    return th.astype(np.float32)


def _cache(seed):
    rng = np.random.default_rng(seed)
    shape = (CFG_KW["n_layers"], 1, CFG_KW["n_kv_heads"], T, 128)
    return (rng.standard_normal(shape).astype(np.float32) * 0.1,
            rng.standard_normal(shape).astype(np.float32) * 0.1)


def _port_decode(cfg, params, th, k, v, tok, p):
    cache = llama.KVCache.from_numpy(k, v, device="cpu")
    sp = SparsityConfig(**MAIN)
    assert llama.can_token_decode(params, cfg, sp, 1, 1, cache.k.dtype)
    logits, cache = llama.forward(
        params, torch.tensor([[tok]]), cache, p, torch.from_numpy(th),
        cfg=cfg, sp=sp)
    return logits.numpy(), cache.k.numpy(), cache.v.numpy()


@pytest.mark.parametrize("p", [0, 5, 15])
def test_token_path_matches_jax_group_twin(model, p):
    """Port main path (token_decode: K1/K2 plain versions) == JAX forward
    on the XLA masked-dense group twin, in logits and caches."""
    cfg, jcfg, params, jparams, th = model
    k, v = _cache(p)
    got, gk, gv = _port_decode(cfg, params, th, k, v, 3 + p, p)
    want, wc = jllama.forward(
        jparams, jnp.asarray([[3 + p]], jnp.int32),
        jllama.KVCache(jnp.asarray(k), jnp.asarray(v)), p, jnp.asarray(th),
        cfg=jcfg, sp=JSparsityConfig(**TWIN))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(gk, np.asarray(wc.k), **TOL)
    np.testing.assert_allclose(gv, np.asarray(wc.v), **TOL)


TOKEN_POS = [0, 5, 15]


def _jax_model():
    jcfg = jget_model_config("tiny", **CFG_KW)
    return jcfg, jllama.init_params(jcfg, jax.random.PRNGKey(7), jnp.float32)


def jax_token_kernel(p):
    """JAX's whole-token kernel in interpret mode at a TOKEN_POS entry
    (run by `jax_results` in the subprocess)."""
    jcfg, jparams = _jax_model()
    k, v = _cache(100 + p)
    with pltpu.force_tpu_interpret_mode():
        want, wc = jllama.forward(
            jparams, jnp.asarray([[9 + p]], jnp.int32),
            jllama.KVCache(jnp.asarray(k), jnp.asarray(v)), p,
            jnp.asarray(_thresholds(jcfg)), cfg=jcfg,
            sp=JSparsityConfig(**MAIN, fused_decode_attention=True))
    return dict(logits=want, k=wc.k, v=wc.v)


@pytest.mark.parametrize("p", TOKEN_POS)
def test_token_path_matches_jax_token_kernel(model, jax_refs, p):
    """Port main path == the JAX whole-token Pallas kernel
    (token_block.token_decode), run in interpret mode on the CPU."""
    cfg, jcfg, params, jparams, th = model
    k, v = _cache(100 + p)
    got, gk, gv = _port_decode(cfg, params, th, k, v, 9 + p, p)
    want = jax_refs[f"token-{p}"]
    np.testing.assert_allclose(got, want["logits"], **TOL)
    np.testing.assert_allclose(gk, want["k"], **TOL)
    np.testing.assert_allclose(gv, want["v"], **TOL)


@pytest.mark.parametrize("sp_kw", [dict(), dict(enabled=True, mode="teal"),
                                   TWIN], ids=["dense", "teal", "group"])
def test_plain_path_matches_jax(model, sp_kw):
    """Prefill (S=6 at pos 0) then one decode step on the plain layer loop:
    dense, and the masked-dense accuracy path in teal and group modes."""
    cfg, jcfg, params, jparams, th = model
    th = th * 0.3 if sp_kw.get("mode") == "teal" else th
    toks = np.array([[5, 1, 7, 2, 9, 4]], np.int32)
    cache = llama.KVCache.init(cfg, 1, T, torch.float32, "cpu")
    jcache = jllama.KVCache.init(jcfg, 1, T, jnp.float32)
    sp, jsp = SparsityConfig(**sp_kw), JSparsityConfig(**sp_kw)
    for tk, p in ((toks, 0), (np.array([[11]], np.int32), 6)):
        got, cache = llama.forward(params, torch.from_numpy(tk).long(), cache,
                                   p, torch.from_numpy(th), cfg=cfg, sp=sp)
        want, jcache = jllama.forward(jparams, jnp.asarray(tk), jcache, p,
                                      jnp.asarray(th), cfg=jcfg, sp=jsp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k),
                                   **TOL)


def test_generator_greedy_matches_jax(model):
    """Dense prefill + 4 greedy tokens: the port's Generator (main path) ==
    the JAX Generator (group twin), token for token."""
    cfg, jcfg, params, jparams, th = model
    prompt = np.array([3, 17, 42, 8, 99], np.int64)
    gen = Generator(cfg, params, sp=SparsityConfig(**MAIN), max_seq=T,
                    cache_dtype=torch.float32, temperature=0.0,
                    device="cpu")
    got, stats = gen.generate(prompt, 5, thresholds=torch.from_numpy(th))
    jgen = JGenerator(jcfg, jparams, sp=JSparsityConfig(**TWIN), max_seq=T,
                      cache_dtype=jnp.float32, temperature=0.0)
    want, _ = jgen.generate(prompt, 5, thresholds=jnp.asarray(th))
    np.testing.assert_array_equal(got, want)
    assert stats.new_tokens == 5


def test_params_from_numpy_bf16():
    """A bf16 JAX pytree carries across bit for bit, int leaves as ints."""
    jcfg = jget_model_config("tiny", **CFG_KW)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(3), jnp.bfloat16)
    tree = jax.tree.map(np.asarray, jparams)
    tree["ids"] = np.arange(4, dtype=np.int32)
    params = llama.params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert params["layers"]["wq"].dtype == torch.bfloat16
    for name in ("wq", "wdown", "attn_norm"):
        np.testing.assert_array_equal(
            params["layers"][name].float().numpy(),
            tree["layers"][name].astype(np.float32))
    assert params["ids"].dtype == torch.int32
    k = np.asarray(jnp.ones((1, 1, 1, T, 128), jnp.bfloat16))
    cache = llama.KVCache.from_numpy(k, k, device="cpu", dtype=torch.bfloat16)
    assert cache.k.dtype == torch.bfloat16 and cache.max_seq == T


def test_entry_points_default_to_cuda(model):
    cfg, _, params, _, _ = model
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Generator(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.KVCache.init(cfg, 1, T)


def test_moe_token_path_gate(model):
    """The MoE FFN takes the token path at batch 1 only, as in the
    reference (batch 2 runs the layer loop; both are held to the JAX
    package in tests/test_torch_moe.py)."""
    moe = get_model_config("tiny", **CFG_KW, n_experts=4, n_experts_per_tok=2)
    mp = llama.init_params(moe, torch.Generator().manual_seed(0),
                           torch.float32, "cpu")
    sp = SparsityConfig(**MAIN)
    assert llama.can_token_decode(mp, moe, sp, 1, 1, torch.float32)
    assert not llama.can_token_decode(mp, moe, sp, 1, 2, torch.float32)


FIXED_POS = [3, 9]           # positions of the batch rows (batch 1: the first)


def _fixed_inputs(b):
    k, v = _cache(40 + b)
    k, v = np.repeat(k, b, axis=1), np.repeat(v, b, axis=1)
    toks = np.array([[5 + 2 * i] for i in range(b)])
    return k, v, toks, FIXED_POS[:b]


def jax_fixed_selection(b):
    """JAX's token path with `debug_fixed_selection` (the whole-token
    kernel's fixed_sel) in interpret mode, run by `jax_results` in the
    subprocess."""
    jcfg, jparams = _jax_model()
    k, v, toks, pos = _fixed_inputs(b)
    with pltpu.force_tpu_interpret_mode():
        want, wc = jllama.forward(
            jparams, jnp.asarray(toks, jnp.int32),
            jllama.KVCache(jnp.asarray(k), jnp.asarray(v)),
            jnp.asarray(pos, jnp.int32), jnp.asarray(_thresholds(jcfg)),
            cfg=jcfg, sp=JSparsityConfig(**MAIN, fused_decode_attention=True,
                                         debug_fixed_selection=True))
    return dict(logits=want, k=wc.k, v=wc.v)


def jax_reference(kind, **kw):
    """Every interpret-mode reference of this module, by kind: "token"
    (`jax_token_kernel`), "fixed" (`jax_fixed_selection`) (run by
    `jax_results` in the subprocess)."""
    if kind == "token":
        return jax_token_kernel(**kw)
    return jax_fixed_selection(**kw)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    cases = {f"token-{p}": dict(kind="token", p=p) for p in TOKEN_POS}
    cases.update({f"fixed-{b}": dict(kind="fixed", b=b) for b in (1, 2)})
    return jax_results(__file__, "jax_reference", cases,
                       tmp_path_factory.mktemp("jax_model"))


@pytest.mark.parametrize("b", [1, 2])
def test_debug_fixed_selection_matches_jax(model, jax_refs, b):
    """`debug_fixed_selection` on the token path (batch 1, and the
    batched rows at two positions): every stage keeps groups 0..cap-1,
    as the reference's token kernel does with fixed_sel; logits and
    caches within 2e-5 of JAX's, and unlike the threshold selection."""
    cfg, _, params, _, th = model
    k, v, toks, pos = _fixed_inputs(b)
    sp = SparsityConfig(**MAIN, debug_fixed_selection=True)
    assert llama.can_token_decode(params, cfg, sp, 1, b, torch.float32)
    out = {}
    for fixed in (True, False):
        cache = llama.KVCache.from_numpy(k, v, device="cpu")
        lg, cache = llama.forward(
            params, torch.from_numpy(toks), cache, pos, torch.from_numpy(th),
            cfg=cfg, sp=sp.replace(debug_fixed_selection=fixed))
        out[fixed] = (lg.numpy(), cache.k.numpy(), cache.v.numpy())
    want = jax_refs[f"fixed-{b}"]
    for got, name in zip(out[True], ("logits", "k", "v")):
        np.testing.assert_allclose(got, want[name], **TOL)
    assert np.abs(out[True][0] - out[False][0]).max() > 1e-3
    # K1's fixed selection keeps groups 0..cap-1 even when no group
    # clears the threshold
    x = torch.from_numpy(np.random.default_rng(b).standard_normal(
        (b, cfg.dim)).astype(np.float32))
    _, idx, count = block_gemv.select_gather_gemv_plain(
        x, torch.tensor(1e9), (params["layers"]["wo"],), 0, 1, fixed=True)
    assert idx.tolist() == [0] and int(count[0]) == 1


def test_debug_fixed_selection_ignored_on_layer_loop(model):
    """On the layer loop (the masked-dense group twin: prefill, then one
    decode step) the flag changes nothing, in the port as in the JAX
    package."""
    cfg, jcfg, params, jparams, th = model
    toks = np.array([[5, 1, 7, 2, 9, 4]], np.int32)
    runs = {}
    for fixed in (True, False):
        cache = llama.KVCache.init(cfg, 1, T, torch.float32, "cpu")
        sp = SparsityConfig(**TWIN, debug_fixed_selection=fixed)
        assert not llama.can_token_decode(params, cfg, sp, 1, 1,
                                          torch.float32)
        for tk, p in ((toks, 0), (np.array([[11]], np.int32), 6)):
            lg, cache = llama.forward(params, torch.from_numpy(tk).long(),
                                      cache, p, torch.from_numpy(th),
                                      cfg=cfg, sp=sp)
        runs[fixed] = (lg.numpy(), cache.k.numpy())
    jcache = jllama.KVCache.init(jcfg, 1, T, jnp.float32)
    jsp = JSparsityConfig(**TWIN, debug_fixed_selection=True)
    for tk, p in ((toks, 0), (np.array([[11]], np.int32), 6)):
        want, jcache = jllama.forward(jparams, jnp.asarray(tk), jcache, p,
                                      jnp.asarray(th), cfg=jcfg, sp=jsp)
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    np.testing.assert_array_equal(runs[True][1], runs[False][1])
    np.testing.assert_allclose(runs[True][0], np.asarray(want), **TOL)
    np.testing.assert_allclose(runs[True][1], np.asarray(jcache.k), **TOL)
