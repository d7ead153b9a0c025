"""The port's continuous-batching server (`engine/serving.py`) against the
JAX package's on the CPU, greedy in fp32: identical tokens for every
request. With the main-path config each decode step is one pass of the
batched token path over all slots (the JAX side through its batched
whole-token kernel in interpret mode), inactive slots included.

The JAX interpret-mode servers run in one subprocess for the module
(`jax_subprocess.jax_results`, `jax_reference` below), so a hang of the
interpreter fails these cases instead of stalling the run."""

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
from teal_tpu.engine.serving import ContinuousBatchingEngine as JEngine
from teal_tpu.models import llama as jllama
from teal_tpu_torch.config import SparsityConfig, get_model_config
from teal_tpu_torch.engine import ContinuousBatchingEngine, Generator
from teal_tpu_torch.models import llama

MAIN = dict(enabled=True, kernel="block", block_size=128,
            block_keep_frac=0.5, block_thresholding=True)
TH = np.array([2.6, 2.6, 2.6, 0.12, 2.65, 2.65, 0.12], np.float32)
MAX_SEQ = 48


@functools.lru_cache(maxsize=None)
def _model():
    kw = dict(n_layers=2, n_heads=2, n_kv_heads=1, dim=256,
              intermediate_size=384, vocab_size=128)
    cfg, jcfg = get_model_config("tiny", **kw), jget_model_config("tiny", **kw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(5), jnp.float32)
    params = llama.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return cfg, jcfg, params, jparams


def _prompts(n, seed):
    """n prompts of three lengths (each length compiles the JAX server's
    prefill once)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, int(rng.choice((3, 8, 13)))).tolist()
            for _ in range(n)]


def _port(prompts, new, slots, sp=MAIN, **kw):
    cfg, _, params, _ = _model()
    eng = ContinuousBatchingEngine(
        cfg, params, slots=slots, max_seq=MAX_SEQ, temperature=0.0,
        cache_dtype=torch.float32, sp=SparsityConfig(**sp),
        thresholds=torch.from_numpy(np.tile(TH, (cfg.n_layers, 1))),
        device="cpu", **kw)
    for p in prompts:
        eng.submit(p, new)
    return [r.out for r in sorted(eng.run(), key=lambda r: r.id)]


def _jax(prompts, new, slots, **kw):
    _, jcfg, _, jparams = _model()
    eng = JEngine(jcfg, jparams, slots=slots, max_seq=MAX_SEQ,
                  temperature=0.0, cache_dtype=jnp.float32,
                  sp=JSparsityConfig(**MAIN, fused_decode_attention=True),
                  thresholds=jnp.asarray(np.tile(TH, (jcfg.n_layers, 1))),
                  **kw)
    for p in prompts:
        eng.submit(p, new)
    with pltpu.force_tpu_interpret_mode():
        return [r.out for r in sorted(eng.run(), key=lambda r: r.id)]


SERVER_CASES = {"2-slots": (2, 2), "10-slots": (10, 10),
                "more-requests": (3, 7)}
CHUNKED_PROMPTS = [[1, 2, 3], list(range(1, 20)), [4, 5, 6, 9]]


def jax_reference(case):
    """The JAX server's tokens for a case of this module, every request's
    concatenated with their lengths (run by `jax_results` in the
    subprocess): a `SERVER_CASES` entry, or "chunked" (prefill_chunk=8)."""
    if case == "chunked":
        outs = _jax(CHUNKED_PROMPTS, 5, 2, prefill_chunk=8)
    else:
        slots, n_req = SERVER_CASES[case]
        outs = _jax(_prompts(n_req, slots), 5, slots)
    return {"tokens": np.array([t for o in outs for t in o], np.int64),
            "lens": np.array([len(o) for o in outs], np.int64)}


@pytest.fixture(scope="module")
def jax_servers(tmp_path_factory):
    """{case: the JAX server's tokens a request}."""
    cases = {c: dict(case=c) for c in (*SERVER_CASES, "chunked")}
    got = jax_results(__file__, "jax_reference", cases,
                      tmp_path_factory.mktemp("jax_serving"))
    out = {}
    for c, r in got.items():
        ends = np.cumsum(r["lens"]).tolist()
        out[c] = [r["tokens"][e - n:e].tolist()
                  for e, n in zip(ends, r["lens"].tolist())]
    return out


@pytest.mark.parametrize("slots,n_req", list(SERVER_CASES.values()),
                         ids=list(SERVER_CASES))
def test_server_matches_jax(slots, n_req, jax_servers):
    """2 slots (one row tile), 10 slots (two row tiles), and 7 requests
    on 3 slots: requests join as slots free up, and inactive slots ride
    in the pooled selection at token 0, position 0, as in the
    reference."""
    prompts = _prompts(n_req, slots)
    got = _port(prompts, 5, slots)
    case = next(c for c, v in SERVER_CASES.items() if v == (slots, n_req))
    assert got == jax_servers[case]
    assert all(len(o) == 5 for o in got)


def test_chunked_admission_matches_oneshot_and_jax(jax_servers):
    """prefill_chunk=8 admission (one chunk per engine step, interleaved
    with decode) gives one-shot admission's tokens, and the JAX chunked
    server's."""
    got = _port(CHUNKED_PROMPTS, 5, 2, prefill_chunk=8)
    assert got == _port(CHUNKED_PROMPTS, 5, 2)
    assert got == jax_servers["chunked"]


def test_chunked_admission_interleaves_decode():
    """While a 4-chunk prompt is admitted, an active request decodes one
    token per engine step."""
    cfg, _, params, _ = _model()
    C = 8
    eng = ContinuousBatchingEngine(cfg, params, slots=2, max_seq=MAX_SEQ,
                                   temperature=0.0, cache_dtype=torch.float32,
                                   prefill_chunk=C, device="cpu")
    eng.submit([1, 2, 3], 40)
    eng.step()
    eng.step()
    before = len(eng.active[0].out)
    eng.submit(list(range(1, 4 * C + 1)), 2)
    steps = 0
    while (eng._pending is not None or eng.active[1] is None) and steps < 10:
        eng.step()
        steps += 1
    assert steps == 4
    assert len(eng.active[0].out) - before == steps


def test_server_matches_single_request_generation():
    """Each request's tokens are what the batch-1 Generator gives it alone
    (dense decode, where the batch cannot change the arithmetic), with a
    reused slot and an eos stop."""
    cfg, _, params, _ = _model()
    prompts = [[9, 8, 7], [2, 4], [5, 6, 7, 8]]
    gen = Generator(cfg, params, max_seq=MAX_SEQ, cache_dtype=torch.float32,
                    temperature=0.0, device="cpu")
    want = [gen.generate(np.array(p), 6)[0][0, len(p):].tolist()
            for p in prompts]
    assert _port(prompts, 6, 2, sp={}) == want
    eos = want[0][1]
    got = _port(prompts[:1], 50, 1, sp={}, eos_id=eos)
    assert got == [want[0][:want[0].index(eos) + 1]]


def test_server_samples_from_its_generator():
    """temperature > 0 draws from the engine's torch.Generator: the same
    seed gives the same tokens."""
    cfg, _, params, _ = _model()

    def run(seed):
        eng = ContinuousBatchingEngine(
            cfg, params, slots=2, max_seq=MAX_SEQ, temperature=1.0,
            cache_dtype=torch.float32, device="cpu",
            generator=torch.Generator().manual_seed(seed))
        for p in ([1, 2, 3], [4, 5]):
            eng.submit(p, 6)
        return [r.out for r in sorted(eng.run(), key=lambda r: r.id)]

    assert run(3) == run(3)
    assert all(0 <= t < cfg.vocab_size for o in run(4) for t in o)
