"""The port's perplexity harness (`teal_tpu_torch/eval/ppl.py`) against the
JAX package's on the CPU (fp32): the window geometry, and `eval_ppl` at
context 256 + window 128 over seeded token streams, dense and with group
thresholds on the prefill, each window's forward taking K6 (its plain
version here) where JAX on the CPU takes `_attention`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from teal_tpu.config import SparsityConfig as JSparsityConfig
from teal_tpu.config import get_model_config as jget_model_config
from teal_tpu.eval import ppl as jppl
from teal_tpu.models import llama as jllama
from teal_tpu_torch.config import SparsityConfig, get_model_config
from teal_tpu_torch.eval import ppl
from teal_tpu_torch.models import llama
from teal_tpu_torch.ops import flash_prefill as fp

CFG_KW = dict(n_layers=3, n_heads=2, n_kv_heads=1, dim=256,
              intermediate_size=384, vocab_size=128)
TWIN = dict(enabled=True, kernel="masked_dense", mode="group",
            block_size=128, block_keep_frac=0.5, block_thresholding=True,
            apply_prefill=True)
TH = np.array([2.6, 2.6, 2.6, 0.12, 2.65, 2.65, 0.12], np.float32)
CONTEXT, WINDOW = 256, 128


@functools.lru_cache(maxsize=None)
def _model():
    cfg, jcfg = get_model_config("tiny", **CFG_KW), \
        jget_model_config("tiny", **CFG_KW)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(13), jnp.float32)
    params = llama.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return cfg, jcfg, params, jparams


def _jax_geometry(monkeypatch, n, context, window):
    """(begin, n_valid, n_score) of every window of the reference's
    `eval_ppl` over a stream of n tokens, recorded from the arguments its
    loop hands `_window_nll` (the stream is 1..n, so a window's first
    token names its begin)."""
    seen = []

    def record(params, tokens, n_valid, n_score, *rest):
        seen.append((int(tokens[0, 0]) - 1, int(n_valid), int(n_score)))
        return 0.0

    monkeypatch.setattr(jppl, "_window_nll", record)
    jcfg = _model()[1]
    jppl.eval_ppl(None, jcfg, np.arange(1, n + 1),
                  thresholds=jnp.zeros((jcfg.n_layers, 7)),
                  context_size=context, window_size=window)
    return seen


def _both(fn):
    """fn()'s result, or "ValueError" where it raises one."""
    try:
        return fn()
    except ValueError:
        return "ValueError"


@pytest.mark.parametrize("context,window", [(256, 128), (200, 128),
                                            (2048, 512), (100, 64)])
def test_window_geometry_matches_jax(monkeypatch, context, window):
    """Streams too short for one stride (both raise), of exactly one
    stride and one past it, one short of a window, exactly one window and
    one past it, a remainder past the loop bound, and a last window that
    runs past the stream's end (context not a stride multiple): the same
    windows as the reference, in order."""
    L = context + window
    for n in (0, 2, window - 1, window, window + 1, L - 1, L, L + 1,
              2 * L + 7, 3 * window, 4 * window - 1, 5 * L + 3):
        got = _both(lambda: list(ppl.windows(n, context, window)))
        want = _both(lambda: _jax_geometry(monkeypatch, n, context, window))
        assert got == want, n
    assert got != "ValueError"          # the longest stream has windows


@pytest.mark.parametrize("n_tokens", [300, 1000, 1200])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_eval_ppl_matches_jax(monkeypatch, n_tokens, sparse):
    """ppl over a seeded stream (one short window; several windows with a
    remainder past the loop bound) within 1e-5 relative of JAX's, dense
    and with group thresholds on every window's prefill; K6 runs once a
    layer and window."""
    cfg, jcfg, params, jparams = _model()
    ids = np.random.default_rng(n_tokens).integers(0, cfg.vocab_size,
                                                   n_tokens)
    th = np.tile(TH, (cfg.n_layers, 1)) if sparse else \
        np.zeros((cfg.n_layers, 7), np.float32)
    sp_kw = TWIN if sparse else {}
    calls = [0]
    plain = fp.flash_prefill_attention_plain

    def counting(*args):
        calls[0] += 1
        return plain(*args)

    monkeypatch.setattr(fp, "flash_prefill_attention_plain", counting)
    got = ppl.eval_ppl(params, cfg, ids, sp=SparsityConfig(**sp_kw),
                       thresholds=torch.from_numpy(th), context_size=CONTEXT,
                       window_size=WINDOW, device="cpu")
    n_windows = len(list(ppl.windows(n_tokens, CONTEXT, WINDOW)))
    assert calls[0] == n_windows * cfg.n_layers
    want = jppl.eval_ppl(jparams, jcfg, ids, sp=JSparsityConfig(**sp_kw),
                         thresholds=jnp.asarray(th), context_size=CONTEXT,
                         window_size=WINDOW)
    assert np.isfinite(got) and got > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_eval_ppl_defaults_to_cuda():
    cfg, _, params, _ = _model()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ppl.eval_ppl(params, cfg, np.arange(400), context_size=CONTEXT,
                     window_size=WINDOW)
