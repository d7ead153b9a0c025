"""The port's eval harness (`teal_tpu_torch.eval.harness`) and its
lm-eval shim against the JAX package's on the CPU, fp32: token
log-probabilities, `loglikelihood` (with context truncation) and
`score_choices` within 2e-5, the greedy flags and choices equal; on the
head-128 config a context padded to 256 tokens runs the port's attention
through K6 (its plain version here; the JAX package on the CPU takes its
masked attention). The shim's multiple-choice and `generate_until`
results equal JAX's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from teal_tpu.config import get_model_config as jget_model_config
from teal_tpu.eval import harness as jharness
from teal_tpu.eval import lm_eval_shim as jshim
from teal_tpu.models import llama as jllama
from teal_tpu.utils.tokenizer import ByteTokenizer as JByteTokenizer
from teal_tpu_torch.config import SparsityConfig, get_model_config
from teal_tpu_torch.eval import harness, lm_eval_shim
from teal_tpu_torch.models import llama
from teal_tpu_torch.ops import flash_prefill
from teal_tpu_torch.utils.tokenizer import ByteTokenizer

TOL = dict(rtol=2e-5, atol=2e-5)
HEAD128 = dict(n_layers=2, n_heads=2, n_kv_heads=2, dim=256,
               intermediate_size=384, vocab_size=512)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its many small ops run far
    slower on the default thread pool when the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(name, max_seq):
    """(port ScoreModel, JAX ScoreModel) on the same fp32 weights."""
    kw = HEAD128 if name == "head128" else {}
    cfg, jcfg = get_model_config("tiny", **kw), jget_model_config("tiny", **kw)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    p = llama.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return (harness.ScoreModel(p, cfg, max_seq=max_seq, device="cpu"),
            jharness.ScoreModel(jp, jcfg, max_seq=max_seq))


def _ids(n, seed, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, n)


@pytest.mark.parametrize("name,n,max_seq", [("tiny", 5, 64),
                                            ("tiny", 33, 64),
                                            ("tiny", 64, 64),
                                            ("head128", 200, 512)])
def test_token_logprobs_match_jax(name, n, max_seq, monkeypatch):
    """Padded to a power of two (8 at least, max_seq at most); the
    head-128 sequence of 200 pads to 256 and runs K6 (plain version) once
    a layer in the port."""
    model, jmodel = _models(name, max_seq)
    calls = []
    orig = flash_prefill.flash_prefill_attention_plain
    monkeypatch.setattr(flash_prefill, "flash_prefill_attention_plain",
                        lambda *a: calls.append(1) or orig(*a))
    ids = _ids(n, n)
    lp, greedy = model._token_logprobs(ids)
    jlp, jgreedy = jmodel._token_logprobs(ids)
    np.testing.assert_allclose(lp, np.asarray(jlp), **TOL)
    np.testing.assert_array_equal(greedy, np.asarray(jgreedy))
    assert lp.shape == (n - 1,)
    assert len(calls) == (model.cfg.n_layers if name == "head128" else 0)


@pytest.mark.parametrize("name,max_seq", [("tiny", 64), ("head128", 512)])
def test_loglikelihood_and_choices_match_jax(name, max_seq):
    """Continuations scored against contexts (the head-128 ones over 128
    tokens, so padded to 256), the greedy flag from the model's own
    argmax, the context truncated from the left past max_seq, and the
    multiple-choice pick."""
    model, jmodel = _models(name, max_seq)
    n_ctx = 150 if name == "head128" else 20
    ctx = _ids(n_ctx, 1).tolist()
    _, greedy = model._token_logprobs(np.asarray(ctx + [0]))
    conts = [[int(greedy[-1])], _ids(3, 2).tolist(), _ids(6, 3).tolist()]
    for cont in conts:
        got = model.loglikelihood(ctx, cont)
        want = jmodel.loglikelihood(ctx, cont)
        np.testing.assert_allclose(got[0], want[0], **TOL)
        assert got[1] == want[1]
    assert model.loglikelihood(ctx, conts[0])[1]
    assert model.score_choices(ctx, conts) == jmodel.score_choices(ctx, conts)
    long_ctx = _ids(max_seq + 9, 4).tolist()
    np.testing.assert_allclose(model.loglikelihood(long_ctx, conts[2])[0],
                               jmodel.loglikelihood(long_ctx, conts[2])[0],
                               **TOL)
    with pytest.raises(ValueError):
        model.loglikelihood(ctx[:2], _ids(max_seq + 1, 5).tolist())


def test_sparse_score_model_matches_jax():
    """A masked-dense sparse config with thresholds scores as JAX's."""
    cfg, jcfg = get_model_config("tiny"), jget_model_config("tiny")
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    p = llama.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    th = np.full((cfg.n_layers, 7), 0.05, np.float32)
    from teal_tpu.config import SparsityConfig as JSparsityConfig

    sp = dict(enabled=True, apply_prefill=True)
    model = harness.ScoreModel(p, cfg, sp=SparsityConfig(**sp),
                               thresholds=th, max_seq=64, device="cpu")
    jmodel = jharness.ScoreModel(jp, jcfg, sp=JSparsityConfig(**sp),
                                 thresholds=jnp.asarray(th), max_seq=64)
    ids = _ids(30, 7)
    np.testing.assert_allclose(model._token_logprobs(ids)[0],
                               np.asarray(jmodel._token_logprobs(ids)[0]),
                               **TOL)


MC_DOCS = [{"query": "ab", "choices": ["cd", "ef", "gh"], "gold": 1},
           {"query": "xy", "choices": ["z", "w"], "gold": 0},
           {"query": "the cat sat on", "choices": [" the mat", " a hat"],
            "gold": 0}]
GEN_DOCS = [{"query": "hello", "target": "x"},
            {"query": "one two", "target": "three"}]


def _lms():
    model, jmodel = _models("tiny", 64)
    return (harness.make_lm_eval_model(model, ByteTokenizer(),
                                       max_gen_toks=8),
            jharness.make_lm_eval_model(jmodel, JByteTokenizer(),
                                        max_gen_toks=8))


def test_shim_multiple_choice_matches_jax():
    lm, jlm = _lms()
    reqs = [lm_eval_shim.Instance("loglikelihood", (d["query"], c))
            for d in MC_DOCS for c in d["choices"]]
    got = lm.loglikelihood(reqs)
    want = jlm.loglikelihood(reqs)
    for (a, ga), (b, gb) in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
        assert ga == gb
    res = lm_eval_shim.simple_evaluate(
        lm, [lm_eval_shim.MultipleChoiceTask("mc", MC_DOCS)])
    jres = jshim.simple_evaluate(jlm, [jshim.MultipleChoiceTask("mc",
                                                                MC_DOCS)])
    assert res == jres
    rolled = lm.loglikelihood_rolling(
        [lm_eval_shim.Instance("loglikelihood_rolling", ("abcdef",))])
    np.testing.assert_allclose(rolled, jlm.loglikelihood_rolling(
        [jshim.Instance("loglikelihood_rolling", ("abcdef",))]), **TOL)


def test_shim_generate_until_matches_jax():
    """Greedy generation through each package's Generator (built at first
    use): the same texts, cut at the same stop strings."""
    lm, jlm = _lms()
    for until in ([], ["\x00"]):
        reqs = [lm_eval_shim.Instance(
            "generate_until", (d["query"], {"until": until,
                                            "max_gen_toks": 8}))
            for d in GEN_DOCS]
        assert lm.generate_until(reqs) == jlm.generate_until(reqs)
    task = lm_eval_shim.GenerateTask("gen", GEN_DOCS, until=(),
                                     max_gen_toks=8)
    jtask = jshim.GenerateTask("gen", GEN_DOCS, until=(), max_gen_toks=8)
    assert lm_eval_shim.simple_evaluate(lm, [task]) == \
        jshim.simple_evaluate(jlm, [jtask])


def test_score_model_defaults_to_cuda(monkeypatch):
    """The entry point runs on the card unless asked for the CPU: without
    one it fails loudly."""
    model, _ = _models("tiny", 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        harness.ScoreModel(model.params, model.cfg)
