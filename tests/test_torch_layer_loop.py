"""The port's layer-loop sparse decode against the JAX package on the CPU
(fp32, the head-dim-128 tiny config): block mode in top-k (path A, batch
1 and 3, G 32 and 64) and threshold mode at G = 32 (path B, and batched),
gather mode (path C), the main-path config with the route flags that send
it to the layer loop; greedy generation; the logits head; and the
variants the port refuses. The JAX projections run their Pallas kernels
in interpret mode; attention runs on the JAX package's XLA route and, in
one case per path, through its fused decode-attention kernels
(`fused_decode_attention=True`, interpret mode). Tolerance 2e-5: fp32
sums of the same products in another order. The JAX interpret-mode
references run once per module, in one subprocess
(`jax_subprocess.jax_results`, `jax_reference` below), so a hang of the
interpreter fails these cases instead of stalling the run."""

import dataclasses
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
from teal_tpu.models import llama as jllama
from teal_tpu_torch.config import PROJS, SparsityConfig, get_model_config
from teal_tpu_torch.engine import Generator
from teal_tpu_torch.models import llama

CFG_KW = dict(n_layers=3, n_heads=2, n_kv_heads=1, dim=256,
              intermediate_size=384, vocab_size=128)
PATH_A = dict(enabled=True, kernel="block")
PATH_B = dict(enabled=True, kernel="block", block_size=32,
              block_keep_frac=0.5, block_thresholding=True)
PATH_C = dict(enabled=True, kernel="gather")
MAIN = dict(enabled=True, kernel="block", block_size=128,
            block_keep_frac=0.5, block_thresholding=True)
TOL = dict(rtol=2e-5, atol=2e-5)
T = 16
POS = 9


@functools.lru_cache(maxsize=None)
def _jax_model(n_layers):
    jcfg = jget_model_config("tiny", **dict(CFG_KW, n_layers=n_layers))
    return jcfg, jllama.init_params(jcfg, jax.random.PRNGKey(11),
                                    jnp.float32)


def _model(n_layers):
    cfg = get_model_config("tiny", **dict(CFG_KW, n_layers=n_layers))
    jcfg, jparams = _jax_model(n_layers)
    params = llama.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return cfg, jcfg, params, jparams


@pytest.fixture(scope="module")
def model():
    return _model(CFG_KW["n_layers"])


def _cache(cfg, b, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, b, cfg.n_kv_heads, T, 128)
    return (rng.standard_normal(shape).astype(np.float32) * 0.1,
            rng.standard_normal(shape).astype(np.float32) * 0.1)


def _thresholds(cfg, params, k, v, toks, rule):
    """Per-layer thresholds near the median of each projection input's
    score (`rule`: "group32" group scores at the stage's group size,
    "elem" |x|), from the dense layer loop on this decode input."""
    from teal_tpu_torch.ops.block_gemv import effective_block_size

    b = toks.shape[0]
    h = params["embed"][torch.from_numpy(toks)]
    cos, sin = llama.precompute_rope(cfg, T, "cpu")
    pos = torch.full((b,), POS, dtype=torch.int64)
    cos, sin = cos[pos][:, None], sin[pos][:, None]
    kc, vc = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    th = np.zeros((cfg.n_layers, 7), np.float32)
    dense = SparsityConfig()
    for i in range(cfg.n_layers):
        lp = {n: w[i] for n, w in params["layers"].items()}
        h, _, _, caps = llama.layer_forward(
            h, lp, kc[i], vc[i], pos, cos, sin, cfg, dense,
            torch.zeros(7), capture=True)
        for grp, name, cols in (("self_attn", "h1", (0, 1, 2)),
                                ("self_attn", "h2", (3,)),
                                ("mlp", "h1", (4, 5)), ("mlp", "h2", (6,))):
            xs = caps[grp][name].reshape(b, -1).abs()
            if rule == "group32":
                G = effective_block_size(32, xs.shape[-1])
                xs = xs.reshape(b, -1, G).amax(-1)
            th[i, list(cols)] = float(xs.median())
    return th


def _decode_inputs(cfg, b, seed):
    """One decode step's caches and tokens (b rows) from `seed`."""
    k, v = _cache(cfg, b, seed)
    toks = (np.arange(b)[:, None] * 5 + 3 + seed) % cfg.vocab_size
    return k, v, toks


def _case_th(model, b, th, seed):
    """A case's [L, 7] thresholds: `th` itself, or computed by it from
    the port's dense layer loop on the case's inputs."""
    cfg, _, params, _ = model
    k, v, toks = _decode_inputs(cfg, b, seed)
    return th(cfg, params, k, v, toks) if callable(th) else th


def _jax_decode(n_layers, sp_kw, b, th, seed, jax_fused):
    """JAX's forward on a decode case, its Pallas kernels in interpret
    mode (run by `jax_results` in the subprocess)."""
    jcfg, jparams = _jax_model(n_layers)
    k, v, toks = _decode_inputs(jcfg, b, seed)
    kw = dict(sp_kw, fused_decode_attention=True) if jax_fused else sp_kw
    with pltpu.force_tpu_interpret_mode():
        want, wc = jllama.forward(
            jparams, jnp.asarray(toks, jnp.int32),
            jllama.KVCache(jnp.asarray(k), jnp.asarray(v)), POS,
            jnp.asarray(np.asarray(th, np.float32)), cfg=jcfg,
            sp=JSparsityConfig(**kw))
    return {"logits": np.asarray(want), "k": np.asarray(wc.k),
            "v": np.asarray(wc.v)}


def _run_both(model, sp_kw, b, th, seed, want, jax_fused=False):
    """The port's forward on a decode case against JAX's results `want`
    (`_jax_decode` on the same case)."""
    cfg, _, params, _ = model
    k, v, toks = _decode_inputs(cfg, b, seed)
    th = _case_th(model, b, th, seed)
    kw = dict(sp_kw, fused_decode_attention=True) if jax_fused else sp_kw
    cache = llama.KVCache.from_numpy(k, v, device="cpu")
    got, cache = llama.forward(params, torch.from_numpy(toks), cache, POS,
                               torch.from_numpy(th), cfg=cfg,
                               sp=SparsityConfig(**kw))
    np.testing.assert_allclose(got.numpy(), want["logits"], **TOL)
    np.testing.assert_allclose(cache.k.numpy(), want["k"], **TOL)
    np.testing.assert_allclose(cache.v.numpy(), want["v"], **TOL)


def _group_th(cfg, params, k, v, toks):
    return _thresholds(cfg, params, k, v, toks, "group32")


ZERO_TH = np.zeros((CFG_KW["n_layers"], 7), np.float32)
MAIN_TH = np.array([[2.6, 2.6, 2.6, 0.12, 2.65, 2.65, 0.12]] * 3,
                   np.float32)
CASES = {
    # path A: top-k at G=32 (K1 is not used: K3 + K2 without RoPE)
    "A": (PATH_A, 1, ZERO_TH),
    "A-b3": (PATH_A, 3, ZERO_TH),
    "A-G64": (dict(PATH_A, block_size=64), 1, ZERO_TH),
    # unequal keep fractions: one K3 call per projection
    "A-keep_fracs": (dict(PATH_A, block_keep_fracs=(0.5, 0.25, 0.75, 0.5,
                                                    0.5, 0.625, 0.375)),
                     1, ZERO_TH),
    # path B: threshold at G=32 (K1 with the folded norm, mega K1 + K2)
    "B": (PATH_B, 1, _group_th),
    # batched threshold mode: pooled selection, K3 with 3 rows
    "B-b3": (PATH_B, 3, _group_th),
    # the main-path config sent to the layer loop by its route flags
    "MAIN-packed_pipeline-off": (dict(MAIN, packed_pipeline=False), 1,
                                 MAIN_TH),
    "MAIN-b3-token_fused-off": (dict(MAIN, token_fused=False), 3, MAIN_TH),
}


FUSED_CASES = ["A", "B", "MAIN-packed_pipeline-off"]


def _elem_th(cfg, params, k, v, toks):
    return _thresholds(cfg, params, k, v, toks, rule="elem")


@pytest.mark.parametrize("case", list(CASES))
def test_layer_loop_matches_jax(model, case, jax_refs):
    """Logits and both caches after one decode step at pos 9 == the JAX
    forward (Pallas projections in interpret mode, XLA attention)."""
    sp_kw, b, th = CASES[case]
    _run_both(model, sp_kw, b, th, len(case), jax_refs[f"loop-{case}"])


@pytest.mark.parametrize("case", FUSED_CASES)
def test_layer_loop_matches_jax_fused_attention(model, case, jax_refs):
    """The same with `fused_decode_attention=True`: the JAX package runs
    its decode-attention / attention-block Pallas kernels (interpret
    mode), the port K2 (and the attention stage)."""
    sp_kw, b, th = CASES[case]
    _run_both(model, sp_kw, b, th, 40 + len(case),
              jax_refs[f"fused-{case}"], jax_fused=True)


@pytest.fixture(scope="module")
def shallow():
    # the JAX row-gather kernel steps one row per grid step, so gather
    # mode in interpret mode is costly: one layer
    return _model(1)


@pytest.mark.parametrize("jax_fused", [False, True], ids=["xla", "fused"])
def test_gather_path_matches_jax(shallow, jax_fused, jax_refs):
    """Path C (unstructured gather: K4 for the seven projections),
    elementwise thresholds at the median |x|; with jax_fused the
    attention of both runs through the fused decode-attention kernels."""
    _run_both(shallow, PATH_C, 1, _elem_th, 5,
              jax_refs[f"gather-{int(jax_fused)}"], jax_fused=jax_fused)


def test_route_gates_follow_reference_flags(model):
    """can_fused_decode and can_token_decode send each config where the
    JAX package's gates send it."""
    cfg, jcfg, params, _ = model
    for flag in (True, False):
        for s, b, T_ in ((1, 1, 16), (1, 3, 16), (2, 1, 16), (1, 17, 16),
                         (1, 1, 12)):
            sp = SparsityConfig(**PATH_A, fused_decode_attention=flag)
            jsp = JSparsityConfig(**PATH_A, fused_decode_attention=flag)
            assert llama.can_fused_decode(s, b, cfg, T_, sp, True) == \
                jllama._can_fused_decode(s, b, jcfg, T_, jsp, True)
    for kw, b, want in ((MAIN, 1, True), (MAIN, 3, True),
                        (dict(MAIN, token_fused=False), 1, True),
                        (dict(MAIN, token_fused=False), 3, False),
                        (dict(MAIN, packed_pipeline=False), 1, False),
                        (dict(MAIN, fused_attn_block=False), 1, True),
                        (PATH_B, 1, False), (PATH_A, 1, False)):
        assert llama.can_token_decode(params, cfg, SparsityConfig(**kw), 1,
                                      b, torch.float32) == want, (kw, b)
    assert not llama.can_token_decode(
        params, cfg, SparsityConfig(**MAIN), 1, 1, torch.float32,
        fused_attn=False)


GREEDY_PROMPT = [3, 17, 42, 8, 99]


def _jax_greedy():
    """JAX's Generator on path A (interpret mode): the greedy tokens (run
    by `jax_results` in the subprocess)."""
    jcfg, jparams = _jax_model(CFG_KW["n_layers"])
    with pltpu.force_tpu_interpret_mode():
        jgen = JGenerator(jcfg, jparams, sp=JSparsityConfig(**PATH_A),
                          max_seq=T, cache_dtype=jnp.float32,
                          temperature=0.0)
        want, _ = jgen.generate(np.array(GREEDY_PROMPT, np.int64), 5)
    return {"tokens": np.asarray(want)}


def test_generator_greedy_path_a_matches_jax(model, jax_refs):
    """Dense prefill + 5 greedy tokens on path A: the port's Generator ==
    the JAX Generator (interpret mode), token for token."""
    cfg, jcfg, params, jparams = model
    prompt = np.array(GREEDY_PROMPT, np.int64)
    gen = Generator(cfg, params, sp=SparsityConfig(**PATH_A), max_seq=T,
                    cache_dtype=torch.float32, temperature=0.0,
                    device="cpu")
    got, stats = gen.generate(prompt, 5)
    np.testing.assert_array_equal(got, jax_refs["greedy"]["tokens"])
    assert stats.new_tokens == 5


def test_lm_head_keeps_fp32_sums():
    """A bf16 head's logits are the fp32 sums of the bf16 products, as the
    JAX package's `_lm_head` computes them (not rounded to bf16)."""
    rng = np.random.default_rng(3)
    h = jnp.asarray(rng.standard_normal((1, 2, 256)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((256, 128)) * 0.05, jnp.bfloat16)
    want = np.asarray(jllama._lm_head({"lm_head": w}, h))
    got = llama._lm_head(
        {"lm_head": torch.from_numpy(np.asarray(w, np.float32)).bfloat16()},
        torch.from_numpy(np.asarray(h, np.float32)).bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_unported_variants_raise(model):
    """Batched gather mode raises NotImplementedError. The MoE FFN is
    ported: on the layer loop's configs (the top-k block config at batch
    1, the main-path config at batch 2) it decodes to finite logits (held
    to the JAX package in tests/test_torch_moe.py; int8 and int4 weights
    in tests/test_torch_quant.py, batched decode on the token path in
    tests/test_torch_batched.py)."""
    cfg, _, params, _ = model
    th = torch.zeros(cfg.n_layers, len(PROJS))

    def fwd(p, c, sp, b):
        cache = llama.KVCache.init(c, b, T, torch.float32, "cpu")
        return llama.forward(p, torch.ones((b, 1), dtype=torch.int64),
                             cache, 3, th, cfg=c, sp=SparsityConfig(**sp))[0]

    with pytest.raises(NotImplementedError):
        fwd(params, cfg, PATH_C, 2)
    moe = dataclasses.replace(cfg, n_experts=2, n_experts_per_tok=1)
    mp = llama.init_params(moe, torch.Generator().manual_seed(1),
                           torch.float32, "cpu")
    for sp, b in ((PATH_A, 1), (MAIN, 2)):
        lg = fwd(mp, moe, sp, b)
        assert lg.shape == (b, 1, cfg.vocab_size)
        assert bool(torch.isfinite(lg).all())


# --- the JAX references, in one subprocess for the module -------------------

def jax_reference(kind, **kw):
    """Every interpret-mode reference of this module, by kind: "loop" (a
    `CASES` entry with its seed and thresholds), "gather" (path C on one
    layer), "greedy" (run by `jax_results` in the subprocess)."""
    if kind == "loop":
        sp_kw, b, _ = CASES[kw["case"]]
        return _jax_decode(CFG_KW["n_layers"], sp_kw, b, kw["th"],
                           kw["seed"], kw["fused"])
    if kind == "gather":
        return _jax_decode(1, PATH_C, 1, kw["th"], 5, kw["fused"])
    return _jax_greedy()


@pytest.fixture(scope="module")
def jax_refs(model, shallow, tmp_path_factory):
    """The module's JAX references, each case's thresholds computed here
    (from the port's dense layer loop where a case computes them) and
    passed to the subprocess."""
    cases = {}
    for tag, names, off, fused in (("loop", CASES, 0, False),
                                   ("fused", FUSED_CASES, 40, True)):
        for case in names:
            sp_kw, b, th = CASES[case]
            seed = off + len(case)
            cases[f"{tag}-{case}"] = dict(
                kind="loop", case=case, seed=seed, fused=fused,
                th=_case_th(model, b, th, seed).tolist())
    for fused in (False, True):
        cases[f"gather-{int(fused)}"] = dict(
            kind="gather", fused=fused,
            th=_case_th(shallow, 1, _elem_th, 5).tolist())
    cases["greedy"] = dict(kind="greedy")
    return jax_results(__file__, "jax_reference", cases,
                       tmp_path_factory.mktemp("jax_loop"))
