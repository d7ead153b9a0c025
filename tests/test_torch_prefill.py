"""The port's long-prompt prefill against the JAX package on the CPU
(fp32): kernel K6's plain version (`ops/flash_prefill.py`) against JAX's
`_flash_prefill_attention` (the Pallas flash kernel in interpret mode,
run in a subprocess by `jax_subprocess.jax_results`) and against JAX's
`_attention`, within 2e-5; the `_can_flash_prefill` gate; and
`forward(causal_prefill=True)`, `Generator` and the server's one-shot
admission at prompts of 256 tokens or more, where the port takes K6 (its
plain version here) and JAX on the CPU takes `_attention`."""

import functools

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
from teal_tpu.engine.serving import ContinuousBatchingEngine as JEngine
from teal_tpu.models import llama as jllama
from teal_tpu_torch.config import SparsityConfig, get_model_config
from teal_tpu_torch.engine import ContinuousBatchingEngine, Generator
from teal_tpu_torch.models import llama
from teal_tpu_torch.ops import flash_prefill as fp

TOL = dict(rtol=2e-5, atol=2e-5)
CFG_KW = dict(n_layers=3, n_heads=2, n_kv_heads=1, dim=256,
              intermediate_size=384, vocab_size=128)
MAIN = dict(enabled=True, kernel="block", block_size=128,
            block_keep_frac=0.5, block_thresholding=True)
TWIN = dict(MAIN, kernel="masked_dense", mode="group")
# group thresholds equal within each fused stage (the token path's rule),
# near the median group score of each stage's input
TH = np.array([2.6, 2.6, 2.6, 0.12, 2.65, 2.65, 0.12], np.float32)
K6_S = (256, 384)
K6_HEADS = [(2, 2), (4, 2)]


def _qkv(S, hq, hkv):
    rng = np.random.default_rng(S + 10 * hq + hkv)
    return tuple(rng.standard_normal((1, h, S, 128)).astype(np.float32)
                 for h in (hq, hkv, hkv))


def jax_flash(S, hq, hkv):
    """JAX's `_flash_prefill_attention` (Pallas flash attention in
    interpret mode), run by `jax_results` in the subprocess."""
    q, k, v = (jnp.asarray(a) for a in _qkv(S, hq, hkv))
    with pltpu.force_tpu_interpret_mode():
        return dict(out=jllama._flash_prefill_attention(q, k, v))


@pytest.fixture(scope="module")
def jax_flash_ref(tmp_path_factory):
    cases = {f"{S}-{hq}-{hkv}": dict(S=S, hq=hq, hkv=hkv)
             for S in K6_S for hq, hkv in K6_HEADS}
    return jax_results(__file__, "jax_flash", cases,
                       tmp_path_factory.mktemp("jax_flash"))


@functools.lru_cache(maxsize=None)
def _model():
    cfg, jcfg = get_model_config("tiny", **CFG_KW), \
        jget_model_config("tiny", **CFG_KW)
    assert cfg.head_dim == 128
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(11), jnp.float32)
    params = llama.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return cfg, jcfg, params, jparams


@pytest.fixture
def k6_calls(monkeypatch):
    """Counts the calls of K6's plain version (what the wrapper runs on
    CPU tensors)."""
    calls = [0]
    plain = fp.flash_prefill_attention_plain

    def counting(*args):
        calls[0] += 1
        return plain(*args)

    monkeypatch.setattr(fp, "flash_prefill_attention_plain", counting)
    return calls


@pytest.mark.parametrize("S", K6_S)
@pytest.mark.parametrize("hq,hkv", K6_HEADS)
def test_k6_plain_matches_jax_flash(S, hq, hkv, jax_flash_ref):
    """K6's plain version == the reference's flash kernel (interpret
    mode), MHA and GQA."""
    got = fp.flash_prefill_attention(*(torch.from_numpy(a)
                                       for a in _qkv(S, hq, hkv)))
    np.testing.assert_allclose(got.numpy(),
                               jax_flash_ref[f"{S}-{hq}-{hkv}"]["out"], **TOL)


@pytest.mark.parametrize("S", K6_S)
@pytest.mark.parametrize("hq,hkv", K6_HEADS)
def test_k6_plain_matches_jax_attention(S, hq, hkv):
    """K6's plain version == JAX's masked `_attention` over a cache that
    holds just the prompt (pos 0), with no interpreter."""
    q, k, v = _qkv(S, hq, hkv)
    got = fp.flash_prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v))
    want = jllama._attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.zeros((1,), jnp.int32), S, S, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_k6_wrapper_checks():
    """The wrapper runs the plain version on CPU tensors (no launch
    counted) and raises on what the kernel does not take."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(256, 4, 2))
    before = fp.flash_prefill_attention.launches
    fp.flash_prefill_attention(q, k, v)
    assert fp.flash_prefill_attention.launches == before
    bad = [(q[..., :64].contiguous(), k[..., :64].contiguous(),
            v[..., :64].contiguous()),                       # head_dim 64
           (q[:, :, :100].contiguous(), k[:, :, :100].contiguous(),
            v[:, :, :100].contiguous()),                     # S % 64
           (q[:, :3].contiguous(), k, v),                    # Hq % Hkv
           (q.bfloat16(), k, v),                             # mixed types
           (q.transpose(2, 3), k, v),                        # strided
           (q, k, v[:, :, :128].contiguous())]               # k/v shapes
    for args in bad:
        with pytest.raises(ValueError):
            fp.flash_prefill_attention(*args)


def test_can_flash_prefill_follows_jax(monkeypatch):
    """The port's gate is the reference's on shapes (the reference also
    refuses the CPU backend; the port decides from shapes alone)."""
    monkeypatch.setattr(jllama.jax, "default_backend", lambda: "tpu")
    cases = [(255, 128, None), (256, 128, None), (320, 128, None),
             (384, 128, None), (2048, 128, None), (256, 128, 64),
             (256, 64, None), (512, 256, None)]
    for s, hd, window in cases:
        assert llama._can_flash_prefill(s, hd, window) == \
            jllama._can_flash_prefill(s, hd, window), (s, hd, window)
    assert [llama._can_flash_prefill(*c) for c in cases] == \
        [False, True, False, True, True, False, False, True]


@pytest.mark.parametrize("S", K6_S)
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_causal_prefill_matches_jax(S, sparse, k6_calls):
    """`forward(causal_prefill=True)` at pos 0, dense and with the group
    thresholds applied to the prefill: logits and caches within 2e-5 of
    JAX's `forward(causal_prefill=True)`, and K6 taken once a layer."""
    cfg, jcfg, params, jparams = _model()
    sp_kw = dict(TWIN, apply_prefill=True) if sparse else {}
    th = np.tile(TH, (cfg.n_layers, 1))
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (1, S))
    cache = llama.KVCache.init(cfg, 1, S + 16, torch.float32, "cpu")
    got, cache = llama.forward(params, torch.from_numpy(toks), cache, 0,
                               torch.from_numpy(th), cfg=cfg,
                               sp=SparsityConfig(**sp_kw),
                               causal_prefill=True)
    assert k6_calls[0] == cfg.n_layers
    jcache = jllama.KVCache.init(jcfg, 1, S + 16, jnp.float32)
    want, jcache = jllama.forward(jparams, jnp.asarray(toks, jnp.int32),
                                  jcache, 0, jnp.asarray(th), cfg=jcfg,
                                  sp=JSparsityConfig(**sp_kw),
                                  causal_prefill=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), **TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), **TOL)


def test_causal_prefill_gate_routes(k6_calls):
    """Short prompts, a sliding window and `causal_prefill=False` keep the
    masked `_attention`; the result equals K6's at S = 256."""
    cfg, _, params, _ = _model()
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256)))
    th = llama.zero_thresholds(cfg, "cpu")
    outs = []
    for s, causal in ((255, True), (256, False), (256, True)):
        cache = llama.KVCache.init(cfg, 1, 256, torch.float32, "cpu")
        lg, _ = llama.forward(params, toks[:, :s], cache, 0, th, cfg=cfg,
                              sp=SparsityConfig(), causal_prefill=causal)
        outs.append(lg)
    assert k6_calls[0] == cfg.n_layers            # only the last run
    np.testing.assert_allclose(outs[1].numpy(), outs[2].numpy(), **TOL)
    mistral = get_model_config("tiny", **CFG_KW, sliding_window=64)
    cache = llama.KVCache.init(mistral, 1, 256, torch.float32, "cpu")
    llama.forward(params, toks, cache, 0, th, cfg=mistral,
                  sp=SparsityConfig(), causal_prefill=True)
    assert k6_calls[0] == cfg.n_layers


def test_generator_long_prompt_matches_jax(k6_calls):
    """A 200-token prompt (padded to 256: K6's prefill) then 4 greedy
    tokens on the main path: the port's Generator == the JAX Generator
    (the group twin), token for token."""
    cfg, jcfg, params, jparams = _model()
    th = np.tile(TH, (cfg.n_layers, 1))
    prompt = np.random.default_rng(3).integers(1, cfg.vocab_size, 200)
    gen = Generator(cfg, params, sp=SparsityConfig(**MAIN), max_seq=272,
                    cache_dtype=torch.float32, temperature=0.0,
                    device="cpu")
    got, _ = gen.generate(prompt, 5, thresholds=torch.from_numpy(th))
    assert k6_calls[0] == cfg.n_layers
    jgen = JGenerator(jcfg, jparams, sp=JSparsityConfig(**TWIN), max_seq=272,
                      cache_dtype=jnp.float32, temperature=0.0)
    want, _ = jgen.generate(prompt, 5, thresholds=jnp.asarray(th))
    np.testing.assert_array_equal(got, want)


def test_server_long_prompt_matches_jax(k6_calls):
    """One-shot admission of a 256-token prompt (K6) and then a short one
    (`_attention`) into one slot: the port's server (main path) == the
    JAX server (group twin), token for token."""
    cfg, jcfg, params, jparams = _model()
    th = np.tile(TH, (cfg.n_layers, 1))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (256, 9)]
    eng = ContinuousBatchingEngine(
        cfg, params, slots=1, max_seq=272, temperature=0.0,
        cache_dtype=torch.float32, sp=SparsityConfig(**MAIN),
        thresholds=torch.from_numpy(th), device="cpu")
    jeng = JEngine(jcfg, jparams, slots=1, max_seq=272, temperature=0.0,
                   cache_dtype=jnp.float32, sp=JSparsityConfig(**TWIN),
                   thresholds=jnp.asarray(th))
    for p in prompts:
        eng.submit(p, 4)
        jeng.submit(p, 4)
    got = [r.out for r in sorted(eng.run(), key=lambda r: r.id)]
    assert k6_calls[0] == cfg.n_layers
    want = [r.out for r in sorted(jeng.run(), key=lambda r: r.id)]
    assert got == want
