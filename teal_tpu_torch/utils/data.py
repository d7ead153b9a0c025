"""Calibration/eval text sources (parity with `utils/data.py:12-19`).

Port of `teal_tpu/utils/data.py`, unchanged: the synthetic stream comes
from the same numpy generator, so it is the same token for token;
`datasets` is imported only for a named dataset.

Resolution order mirrors practical deployments: a local text file, an HF
dataset (requires network/cache — the reference's
`get_dataset("tatsu-lab/alpaca", size=300)` path), or a deterministic
synthetic stream so every flow runs in hermetic environments.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np


def get_dataset_text(name: str, *, split: str = "train",
                     size: Optional[int] = None,
                     text_field: str = "text") -> str:
    """Concatenate `size` samples of an HF dataset into one blob with the
    reference's '\\n\\n' joiner (`utils/eval_ppl.py:15-17`)."""
    from datasets import load_dataset

    ds = load_dataset(name, split=split, streaming=True)
    if size:
        ds = ds.take(size)
    return "".join(sample[text_field] + "\n\n" for sample in ds)


def synthetic_tokens(vocab_size: int, n: int, seed: int = 0) -> np.ndarray:
    """Markov-ish synthetic token stream (more structure than uniform so
    ppl comparisons are not degenerate)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab_size, size=max(16, n // 8))
    out = []
    i = 0
    while len(out) < n:
        j = int(rng.integers(0, len(base)))
        run = int(rng.integers(2, 9))
        out.extend(int(base[(j + k) % len(base)]) for k in range(run))
        i += 1
    return np.asarray(out[:n], np.int64)


def get_token_stream(tokenizer, *, text_file: Optional[str] = None,
                     dataset: Optional[str] = None,
                     dataset_size: Optional[int] = 300,
                     vocab_size: int = 32000,
                     n_tokens: int = 8192, seed: int = 0) -> np.ndarray:
    """Token stream for calibration/ppl from the first available source."""
    if text_file:
        return np.asarray(tokenizer.encode(open(text_file).read()), np.int64)
    if dataset:
        text = get_dataset_text(dataset, size=dataset_size)
        return np.asarray(tokenizer.encode(text), np.int64)
    return synthetic_tokens(vocab_size, n_tokens, seed)
