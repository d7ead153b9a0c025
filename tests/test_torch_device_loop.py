"""The port's on-device decode loops on the CPU: `Generator.generate(
on_device_loop=True)` (the decode step over static buffers, a CUDA graph
on the card, run eagerly here) and speculative `device_loop=True` (the
round over static buffers, `speculative._Rounds`).

Held here: the graph-safe draw (`sampling.draw`) equals
`torch.multinomial` bit for bit; `forward` with the position as a device
tensor equals an int position bit for bit on every single-device route a
`Generator` takes (the token path at batch 1 and its rows form at batch
4 with unequal positions, the layer loop's paths A, B and C, dense, int8,
packed int4, the MoE token path), and so does `block_verify`; a host
position out of range is refused; both decode loops give the tokens of a
plain loop of `forward` at host positions, greedy and seeded; the device
loop
equals the JAX `Generator`'s `on_device_loop=True` (its XLA group twin,
fp32, greedy); the speculative round loop equals the round loop the
port ran before it kept its buffers on the device.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from teal_tpu.config import SparsityConfig as JSparsityConfig
from teal_tpu.config import get_model_config as jget_model_config
from teal_tpu.engine import Generator as JGenerator
from teal_tpu.models import llama as jllama
from teal_tpu_torch.config import SparsityConfig, get_model_config
from teal_tpu_torch.engine import Generator, sampling
from teal_tpu_torch.engine.generate import _pad_len
from teal_tpu_torch.engine import speculative as spec
from teal_tpu_torch.models import llama
from teal_tpu_torch.ops import quant

HEAD128 = dict(n_layers=3, n_heads=2, n_kv_heads=1, dim=256,
               intermediate_size=384, vocab_size=128)
MOE = dict(n_layers=2, n_heads=2, n_kv_heads=2, dim=256,
           intermediate_size=384, vocab_size=128, n_experts=4,
           n_experts_per_tok=2)
MAIN = dict(enabled=True, kernel="block", block_size=128,
            block_keep_frac=0.5, block_thresholding=True)
TWIN = dict(MAIN, kernel="masked_dense", mode="group")
T = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the many small ops of a decode step run far
    slower on the default thread pool when the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(kw, dtype=torch.float32, seed=0):
    cfg = get_model_config("tiny", **kw)
    return cfg, llama.init_params(cfg, torch.Generator().manual_seed(seed),
                                  dtype, "cpu")


def _thresholds(cfg, scale=1.0):
    """Per-layer thresholds near the middle of each stage's group scores
    (equal within the fused stages), so that stages keep some groups and
    drop others."""
    base = np.array([2.6, 2.6, 2.6, 0.12, 2.65, 2.65, 0.12], np.float32)
    th = base[None] * (1 + 0.03 * np.arange(cfg.n_layers)[:, None]) * scale
    return torch.from_numpy(th.astype(np.float32))


# --- the draw ---------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("v", [128, 1000])
@pytest.mark.parametrize("temperature,top_k", [(0.8, 200), (1.0, None),
                                               (0.5, 5)])
def test_draw_equals_multinomial(b, v, temperature, top_k):
    """`sampling.draw` gives `torch.multinomial`'s one-sample tokens from
    the same generator state, over 50 seeds."""
    for seed in range(50):
        logits = torch.randn((b, v), generator=torch.Generator().manual_seed(
            1000 + seed)) * 3
        probs = sampling.logits_to_probs(logits, temperature, top_k)
        want = torch.multinomial(probs, 1,
                                 generator=torch.Generator().manual_seed(seed))
        got = sampling.draw(probs, torch.Generator().manual_seed(seed))
        assert torch.equal(got, want), seed


@pytest.mark.parametrize("v", [128, 1000])
def test_sample_probs_equals_multinomial(v):
    """Speculation's draw from one probs row, an all-zero row included
    (uniform through the 1e-30 floor), equals `torch.multinomial`'s."""
    for seed in range(20):
        rows = [torch.zeros(v), torch.softmax(torch.randn(
            v, generator=torch.Generator().manual_seed(seed)), -1)]
        for probs in rows:
            want = torch.multinomial(
                probs + 1e-30, 1,
                generator=torch.Generator().manual_seed(seed))
            got = spec._sample_probs(probs,
                                     torch.Generator().manual_seed(seed))
            assert got.shape == (1,) and torch.equal(got, want), seed


# --- forward with a device position -----------------------------------------

def _quantized(params, kind):
    if kind == "int8":
        return quant.quantize_params_int8(params)
    return quant.pack_int4_params(quant.quantize_params_int4(params, 128),
                                  128)


# route: (config kwargs, sparsity kwargs, batch, weights, threshold scale)
ROUTES = {
    "token-b1": (HEAD128, MAIN, 1, "fp32", 1.0),
    "rows-b4": (HEAD128, MAIN, 4, "fp32", 1.0),
    "A": (HEAD128, dict(enabled=True, kernel="block"), 1, "fp32", 1.0),
    "A-b4": (HEAD128, dict(enabled=True, kernel="block"), 4, "fp32", 1.0),
    "B": (HEAD128, dict(MAIN, block_size=32), 1, "fp32", 1.0),
    "C": (HEAD128, dict(enabled=True, kernel="gather"), 1, "fp32", 0.1),
    "dense": ({}, {}, 2, "fp32", 1.0),
    "int8": (HEAD128, MAIN, 1, "int8", 1.0),
    "int4": (HEAD128, MAIN, 1, "int4", 1.0),
    "moe": (MOE, MAIN, 1, "fp32", 1.0),
}
POSITIONS = [3, 9, 5, 12]


def _route(name):
    cfg_kw, sp_kw, b, weights, scale = ROUTES[name]
    cfg, params = _params(cfg_kw, torch.float32 if weights == "fp32"
                          else torch.bfloat16)
    if weights != "fp32":
        params = _quantized(params, weights)
    return cfg, params, SparsityConfig(**sp_kw), b, _thresholds(cfg, scale)


@pytest.mark.parametrize("name", list(ROUTES))
def test_forward_device_pos_equals_int_pos(name):
    """One decode step at host positions and at the same positions as an
    int32 device tensor ([1] shared by the batch, or [B]): the logits and
    the whole cache bit for bit, on the route `forward` takes."""
    cfg, params, sp, b, th = _route(name)
    dt = llama.compute_dtype(params)
    fused = llama.can_fused_decode(
        1, b, cfg, T, sp, (sp.enabled and sp.kernel == "block")
        or llama._is_int4_packed(params["layers"]["wq"]))
    token_path = llama.can_token_decode(params, cfg, sp, 1, b, dt,
                                        fused_attn=fused)
    assert token_path == (name in ("token-b1", "rows-b4", "int8", "int4",
                                   "moe")), name
    rng = np.random.default_rng(len(name))
    shape = (cfg.n_layers, b, cfg.n_kv_heads, T, cfg.head_dim)
    k0, v0 = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                               * 0.1).to(dt) for _ in range(2))
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (b, 1)))
    shared = b == 1 or name == "dense"
    host = POSITIONS[0] if shared else POSITIONS[:b]
    dev = torch.tensor([host] if shared else host, dtype=torch.int32)
    outs = []
    for pos in (host, dev):
        cache = llama.KVCache(k0.clone(), v0.clone())
        logits, cache = llama.forward(params, toks, cache, pos, th, cfg=cfg,
                                      sp=sp)
        outs.append((logits, cache.k, cache.v))
    for got, want in zip(outs[1], outs[0]):
        assert torch.equal(got, want), name


@pytest.mark.parametrize("name", ["token-b1", "rows-b4", "A"])
@pytest.mark.parametrize("bad", ["max_seq", "negative"])
def test_forward_host_pos_out_of_range_raises(name, bad):
    """A host position outside [0, max_seq) is refused with a ValueError
    before anything launches (a device position is read on the device
    only), on the token path, its rows form and the layer loop."""
    cfg, params, sp, b, th = _route(name)
    cache = llama.KVCache.init(cfg, b, T, llama.compute_dtype(params), "cpu")
    p = T if bad == "max_seq" else -1
    pos = p if b == 1 else [0] * (b - 1) + [p]
    toks = torch.ones((b, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match=f"pos {p} out of range"):
        llama.forward(params, toks, cache, pos, th, cfg=cfg, sp=sp)


def test_block_verify_device_pos_equals_int_pos():
    """`block_verify` over S = 11 positions (two chunks) at pos 6 given as
    an int and as an int32 device tensor: logits and cache bit for bit."""
    cfg, params = _params(HEAD128)
    assert llama.can_block_verify(params, cfg, 11)
    rng = np.random.default_rng(1)
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, T, cfg.head_dim)
    k0, v0 = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                               * 0.1) for _ in range(2))
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, 11)))
    outs = []
    for pos in (6, torch.tensor([6], dtype=torch.int32)):
        cache = llama.KVCache(k0.clone(), v0.clone())
        logits, cache = llama.block_verify(params, toks, cache, pos,
                                           _thresholds(cfg), cfg=cfg)
        outs.append((logits, cache.k, cache.v))
    for got, want in zip(outs[1], outs[0]):
        assert torch.equal(got, want)


# --- the decode loops -------------------------------------------------------

def _plain_decode(gen, prompt, n, th, generator):
    """`gen.generate`'s tokens as a plain Python loop: the same prefill,
    then `forward` at host int positions on a fresh cache and
    `sampling.sample` from the caller's generator, the tokens stacked at
    the end."""
    b, t = prompt.shape
    padded = torch.zeros((b, _pad_len(t)), dtype=torch.int64)
    padded[:, :t] = torch.from_numpy(prompt)
    prefill_sp = (gen.sp if gen.sp.apply_prefill
                  else gen.sp.replace(enabled=False))
    logits, cache = llama.forward(gen.params, padded, gen.new_cache(), 0, th,
                                  cfg=gen.cfg, sp=prefill_sp, rope=gen.rope,
                                  causal_prefill=True)
    toks = [sampling.sample(logits[:, t - 1], gen.temperature, gen.top_k,
                            generator)]
    for pos in range(t, t + n - 1):
        logits, cache = llama.forward(gen.params, toks[-1][:, None], cache,
                                      pos, th, cfg=gen.cfg, sp=gen.sp,
                                      rope=gen.rope)
        toks.append(sampling.sample(logits[:, 0], gen.temperature,
                                    gen.top_k, generator))
    return np.concatenate([prompt, torch.stack(toks, 1).numpy()], axis=1)


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("route", ["token", "A"])
def test_device_loop_equals_host_loop(b, temperature, route):
    """Both decode loops (the step over static buffers, called eagerly on
    the CPU) give the tokens of a plain Python loop of `forward` at host
    int positions from one generator seed (`_plain_decode`), three times
    in a row on one `Generator` (the buffers and the cache reused), and
    leave the generator in the plain loop's state."""
    cfg, params = _params(HEAD128)
    sp = SparsityConfig(**(MAIN if route == "token"
                           else dict(enabled=True, kernel="block")))
    gen = Generator(cfg, params, sp=sp, max_seq=T, batch=b,
                    cache_dtype=torch.float32, temperature=temperature,
                    device="cpu")
    prompt = np.random.default_rng(b).integers(1, cfg.vocab_size, (b, 5))
    g = torch.Generator().manual_seed(3)
    want = _plain_decode(gen, prompt, 12, _thresholds(cfg), g)
    for dl in (False, True, True):
        gi = torch.Generator().manual_seed(3)
        toks, st = gen.generate(prompt, 12, thresholds=_thresholds(cfg),
                                generator=gi, on_device_loop=dl)
        np.testing.assert_array_equal(toks, want)
        assert st.new_tokens == 12
        assert torch.equal(gi.get_state(), g.get_state())
    assert gen._loop is not None and gen._loop.graph is None


def test_device_loop_fills_max_seq():
    """A generation that fills max_seq (its last step decodes at position
    max_seq - 1, its last token's column is max_seq): both loops give the
    plain loop's tokens, and one more token is refused."""
    cfg, params = _params({})
    gen = Generator(cfg, params, max_seq=16, cache_dtype=torch.float32,
                    temperature=0.8, device="cpu")
    prompt = np.arange(1, 9)
    want = _plain_decode(gen, prompt[None], 9, llama.zero_thresholds(
        cfg, "cpu"), torch.Generator().manual_seed(1))
    for dl in (False, True):
        np.testing.assert_array_equal(gen.generate(
            prompt, 9, generator=torch.Generator().manual_seed(1),
            on_device_loop=dl)[0], want)
    with pytest.raises(ValueError, match="do not fit"):
        gen.generate(prompt, 10)


def test_dropped_generator_frees_its_loop():
    """The device loop's buffers (a cache, and on the card the graph and
    its memory pool) go with the last reference to their `Generator`,
    without waiting for the cyclic collector."""
    cfg, params = _params({})
    gen = Generator(cfg, params, max_seq=16, cache_dtype=torch.float32,
                    device="cpu")
    gen.generate(np.arange(1, 5), 4)
    cache = weakref.ref(gen._loop.cache.k)
    gc.disable()
    try:
        del gen
        assert cache() is None
    finally:
        gc.enable()


def test_device_loop_matches_jax_on_device_loop():
    """Greedy fp32 main path: the port's device loop == the JAX
    `Generator`'s `on_device_loop=True` (`lax.scan` over its XLA group
    twin), token for token."""
    jcfg = jget_model_config("tiny", **HEAD128)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(7), jnp.float32)
    cfg = get_model_config("tiny", **HEAD128)
    params = llama.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    th = _thresholds(cfg)
    prompt = np.array([3, 17, 42, 8, 99], np.int64)
    gen = Generator(cfg, params, sp=SparsityConfig(**MAIN), max_seq=T,
                    cache_dtype=torch.float32, temperature=0.0, device="cpu")
    got, _ = gen.generate(prompt, 10, thresholds=th, on_device_loop=True)
    jgen = JGenerator(jcfg, jparams, sp=JSparsityConfig(**TWIN), max_seq=T,
                      cache_dtype=jnp.float32, temperature=0.0)
    want, _ = jgen.generate(prompt, 10, thresholds=jnp.asarray(th.numpy()),
                            on_device_loop=True)
    np.testing.assert_array_equal(got, want)


# --- the speculative round loop ---------------------------------------------

def _host_round_loop(cfg, params, cur, t, th_d, generator, *, k, n,
                     max_seq, draft_sp, adaptive_k, forced_alpha=None,
                     probe_every=8):
    """The port's round loop as it ran with its token and position on the
    host: `build_speculative_step`'s round each round (at the
    controller's depth under adaptive_k), the token and position moved on
    from the round's host ints, the position made afresh each round.
    Returns (tokens, n_out, rounds[, k_eff, alpha])."""
    step = spec.build_speculative_step(
        cfg, cfg, speculate_k=k, temperature=1.0, draft_sp=draft_sp,
        shared_params=True, shared_cache=True, forced_alpha=forced_alpha,
        max_seq=max_seq, device="cpu")
    cache = llama.KVCache.init(cfg, 1, max_seq, torch.float32, "cpu")
    zero = llama.zero_thresholds(cfg, "cpu")
    llama.forward(params, torch.tensor([t]), cache, 0, zero, cfg=cfg,
                  sp=SparsityConfig(), causal_prefill=True)
    acc_w, att_w = spec._PRIOR
    pos, n_out, rounds, out, token = len(t), 0, 0, [], cur
    while n_out < n - 1 and pos + k + 1 < max_seq:
        k_eff = None
        if adaptive_k:
            k_eff, _ = spec._controller(acc_w, att_w, k=k)
            if rounds % probe_every == 0:
                k_eff = max(k_eff, 1)
        toks, n_valid = step(params, params, cache, None, token,
                             torch.tensor([pos], dtype=torch.int32), zero,
                             th_d, generator, k_eff=k_eff)
        n_valid = int(n_valid)
        if adaptive_k:
            acc = np.float32(n_valid - 1)
            att = acc + np.float32((n_valid - 1) < k_eff)
            acc_w = spec._DISCOUNT * acc_w + acc
            att_w = spec._DISCOUNT * att_w + att
        out.extend(toks[:n_valid].tolist())
        token = toks[n_valid - 1:n_valid]
        n_out, pos, rounds = n_out + n_valid, pos + n_valid, rounds + 1
    res = (out, n_out, rounds)
    if adaptive_k:
        res += spec._controller(acc_w, att_w, k=k)
    return res


@pytest.mark.parametrize("kw", [dict(adaptive_k=True),
                                dict(adaptive_k=False, forced_alpha=0.7)],
                         ids=["adaptive", "forced"])
def test_round_loop_equals_host_round_loop(kw):
    """`speculative_generate(device_loop=True)` at temperature 1 from one
    seed (the round over static buffers, `_Rounds`) gives the tokens and
    stats (rounds, mean accepted, k_eff_final, alpha_hat_final) of the
    round loop with its token and position on the host, draw for draw."""
    cfg, params = _params({})
    draft_sp = SparsityConfig(enabled=True)
    th_d = torch.full((cfg.n_layers, 7), 0.08)
    prompt, n, k, max_seq = [3, 1, 4], 20, 4, 64
    toks, st = spec.speculative_generate(
        params, params, cfg, cfg, prompt, n, speculate_k=k, temperature=1.0,
        max_seq=max_seq, draft_sp=draft_sp, draft_thresholds=th_d,
        generator=torch.Generator().manual_seed(5),
        cache_dtype=torch.float32, device_loop=True, device="cpu", **kw)
    g = torch.Generator().manual_seed(5)
    cache = llama.KVCache.init(cfg, 1, max_seq, torch.float32, "cpu")
    logits, _ = llama.forward(params, torch.tensor([prompt]), cache, 0,
                              llama.zero_thresholds(cfg, "cpu"), cfg=cfg,
                              sp=SparsityConfig(), causal_prefill=True)
    cur = spec._sample_probs(spec.logits_to_probs(logits[0, -1], 1.0, None),
                             g)
    want = _host_round_loop(cfg, params, cur, prompt, th_d, g, k=k, n=n,
                            max_seq=max_seq, draft_sp=draft_sp, **kw)
    out, n_out, rounds = want[:3]
    new = ([int(cur)] + out[:n_out])[:n]
    np.testing.assert_array_equal(toks, np.asarray(prompt + new))
    assert st["rounds"] == rounds and st["new_tokens"] == len(new)
    assert st["mean_accepted"] == (n_out - rounds) / rounds
    if kw["adaptive_k"]:
        assert st["k_eff_final"] == want[3]
        assert st["alpha_hat_final"] == want[4]
