"""The port's tokenizers, text sources and profiling
(`teal_tpu_torch.utils`) against the JAX package's on the CPU."""

import base64
import json
import os
import warnings

import numpy as np
import pytest
import torch

from teal_tpu.utils import data as jdata
from teal_tpu.utils import tokenizer as jtok
from teal_tpu_torch.utils import data, profiling, tokenizer

TEXTS = ["", "Hello, my name is", "héllo wörld ✓ 日本語", "a\nb\tc  d"]


@pytest.mark.parametrize("text", TEXTS)
def test_byte_tokenizer_matches_jax(text):
    got, want = tokenizer.ByteTokenizer(), jtok.ByteTokenizer()
    for bos in (False, True):
        assert got.encode(text, bos=bos) == want.encode(text, bos=bos)
    ids = got.encode(text, bos=True) + [257, 300]
    assert got.decode(ids) == want.decode(ids) == text
    assert (got.bos_id(), got.eos_id(), got.vocab_size()) == \
        (want.bos_id(), want.eos_id(), want.vocab_size())


def test_fallback_warns_loudly(tmp_path):
    """A path with no tokenizer files falls back to bytes with the
    reference's warning; no path at all falls back silently."""
    with pytest.warns(UserWarning, match="byte-level tokenizer"):
        tok = tokenizer.get_tokenizer(str(tmp_path))
    assert isinstance(tok, tokenizer.ByteTokenizer)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert isinstance(tokenizer.get_tokenizer(None),
                          tokenizer.ByteTokenizer)


def test_tiktoken_resolution_matches_jax(tmp_path):
    """A Llama-3-named dir with a BPE ranks file resolves to the tiktoken
    tokenizer in both packages, with the same ids."""
    pytest.importorskip("tiktoken")
    d = tmp_path / "llama3-test"
    d.mkdir()
    (d / "tokenizer.model").write_text("".join(
        base64.b64encode(bytes([i])).decode() + f" {i}\n"
        for i in range(256)))
    got, want = (m.get_tokenizer(str(d)) for m in (tokenizer, jtok))
    assert type(got).__name__ == type(want).__name__ == "TiktokenLlama3"
    for text in TEXTS:
        ids = got.encode(text, bos=True)
        assert ids == want.encode(text, bos=True)
        assert got.decode(ids[1:]) == text
    assert got.bos_id() == want.bos_id() and got.eos_id() == want.eos_id()


@pytest.mark.parametrize("vocab,n,seed", [(512, 100, 0), (32000, 4096, 1),
                                          (128, 7, 3), (258, 10000, 5)])
def test_synthetic_tokens_match_jax(vocab, n, seed):
    got = data.synthetic_tokens(vocab, n, seed)
    np.testing.assert_array_equal(got, jdata.synthetic_tokens(vocab, n, seed))
    assert got.dtype == np.int64 and len(got) == n


def test_token_stream_matches_jax(tmp_path):
    f = tmp_path / "text.txt"
    f.write_text("The quick brown fox.\nJumps over — the lazy dog.\n" * 20)
    tok = tokenizer.ByteTokenizer()
    got = data.get_token_stream(tok, text_file=str(f))
    want = jdata.get_token_stream(jtok.ByteTokenizer(), text_file=str(f))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        data.get_token_stream(tok, vocab_size=300, n_tokens=64, seed=2),
        jdata.get_token_stream(jtok.ByteTokenizer(), vocab_size=300,
                               n_tokens=64, seed=2))


def test_write_metrics_lines(tmp_path):
    path = tmp_path / "sub" / "m.jsonl"
    profiling.write_metrics(str(path), {"a": 1, "tokens_per_s": 2.5})
    profiling.write_metrics(str(path), {"a": 2})
    lines = [json.loads(l) for l in path.read_text().splitlines()]
    assert [l["a"] for l in lines] == [1, 2]
    assert lines[0]["tokens_per_s"] == 2.5 and "ts" in lines[0]


def test_trace_writes_a_chrome_trace(tmp_path):
    """A CPU trace: one non-empty Chrome trace file in the directory; no
    directory, no trace."""
    d = tmp_path / "trace"
    with profiling.trace(str(d)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    trace = json.loads((d / files[0]).read_text())
    assert trace["traceEvents"]
    with profiling.trace(None):
        pass


def test_device_memory_stats_empty_on_cpu():
    assert profiling.device_memory_stats("cpu") == {}
