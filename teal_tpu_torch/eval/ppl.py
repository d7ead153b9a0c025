"""Sliding-window perplexity (the accuracy regression harness).

Port of `teal_tpu/eval/ppl.py`, with its window geometry (the TEAL
reference's `utils/eval_ppl.py:13-72`):
  - windows of `context_size + window_size` tokens start every stride
    (= window_size) and are sliced from the UNTRUNCATED stream; only the
    loop bound `seq_len` is truncated to a stride multiple, and the loop
    breaks once a window's unclamped end reaches it;
  - each window scores its last `min(stride, n_valid - 1)` labels, so
    every scored token sees at least `context_size` of context (a final
    window shorter than the stride scores all its labels);
  - ppl = exp(mean over windows of each window's mean NLL): windows
    weigh equally, the short last one too.

Every window is padded to `context_size + window_size` tokens and
masked, and runs one `forward` at pos 0 with `causal_prefill`, so a
window the gate takes runs its attention through kernel K6. Log-softmax
is fp32. The model runs on `device` ("cuda" unless the caller asks for
the CPU).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from teal_tpu_torch.config import ModelConfig, SparsityConfig
from teal_tpu_torch.models import llama
from teal_tpu_torch.models.llama import KVCache


def windows(n_tokens: int, context_size: int, window_size: int
            ) -> Iterator[Tuple[int, int, int]]:
    """(begin, n_valid, n_score) of each window over a stream of
    `n_tokens`: the window is ids[begin:begin + context_size +
    window_size], n_valid its real tokens, n_score the labels scored."""
    stride = window_size
    max_length = context_size + window_size
    seq_len = n_tokens - (n_tokens % stride)      # loop bound only
    if seq_len < 2:
        raise ValueError(f"token stream too short: {n_tokens}")
    for begin in range(0, seq_len, stride):
        end = begin + max_length                  # unclamped, as reference
        n_valid = min(end, n_tokens) - begin
        yield begin, n_valid, min(stride, n_valid - 1)
        if end >= seq_len:
            break


def _window_nll(params, tokens: torch.Tensor, n_valid: int, n_score: int,
                thresholds, cfg: ModelConfig, sp: SparsityConfig,
                rope=None) -> torch.Tensor:
    """Mean NLL of the last `n_score` valid labels of tokens [1, T] (a
    0-d fp32 tensor on the tokens' device)."""
    t = tokens.shape[1]
    cache = KVCache.init(cfg, 1, t, llama.compute_dtype(params),
                         tokens.device)
    logits, _ = llama.forward(params, tokens, cache, 0, thresholds, cfg=cfg,
                              sp=sp, rope=rope, causal_prefill=True)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    token_logp = logp.gather(-1, tokens[:, 1:, None])[..., 0]
    label_pos = torch.arange(1, t, device=tokens.device)[None, :]
    mask = (label_pos < n_valid) & (label_pos >= n_valid - n_score)
    return -(token_logp * mask).sum() / mask.sum().clamp(min=1)


def window_nlls(params, cfg: ModelConfig, token_ids, *,
                sp: SparsityConfig = SparsityConfig(),
                thresholds: Optional[torch.Tensor] = None,
                context_size: int = 2048, window_size: int = 512,
                progress: bool = False, device="cuda") -> List[float]:
    """Each window's mean NLL over a flat token stream, in window order."""
    device = llama._device(device)
    if thresholds is None:
        thresholds = llama.zero_thresholds(cfg, device)
    ids = np.asarray(token_ids).reshape(-1)
    max_length = context_size + window_size
    rope = llama.precompute_rope(cfg, max_length, device)
    nlls = []
    for begin, n_valid, n_score in windows(len(ids), context_size,
                                           window_size):
        padded = np.zeros((1, max_length), dtype=np.int64)
        padded[0, :n_valid] = ids[begin:begin + n_valid]
        nll = _window_nll(params, torch.from_numpy(padded).to(device),
                          n_valid, n_score, thresholds, cfg, sp, rope)
        nlls.append(float(nll))
        if progress:
            print(f"window {begin}: nll={nlls[-1]:.4f}", flush=True)
    return nlls


def eval_ppl(params, cfg: ModelConfig, token_ids, *,
             sp: SparsityConfig = SparsityConfig(),
             thresholds: Optional[torch.Tensor] = None,
             context_size: int = 2048, window_size: int = 512,
             progress: bool = False, device="cuda") -> float:
    """Perplexity of a flat token stream under the given sparsity config
    (thresholds [L, 7] on `device`; zeros when absent)."""
    return float(np.exp(np.mean(window_nlls(
        params, cfg, token_ids, sp=sp, thresholds=thresholds,
        context_size=context_size, window_size=window_size,
        progress=progress, device=device))))
