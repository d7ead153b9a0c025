"""lm-evaluation-harness adapter (capability parity with
`gpt-fast/eval.py:85-151`).

Port of `teal_tpu/eval/harness.py`: wraps the model as an `lm_eval`
model so that downstream tasks run against dense or sparse
configurations. The real `lm_eval` is taken when installed, the port's
copy of the shim (`eval/lm_eval_shim.py`) otherwise.

`ScoreModel` scores a sequence with one `forward(causal_prefill=True)`
at pos 0 over the ids padded to a power of two (at most `max_seq`), so a
context padded to 256 tokens or more runs its attention through kernel
K6; log-softmax is fp32. The model runs on `device` ("cuda" unless the
caller asks for the CPU).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from teal_tpu_torch.config import ModelConfig, SparsityConfig
from teal_tpu_torch.models import llama
from teal_tpu_torch.models.llama import KVCache


class ScoreModel:
    """Minimal scoring interface: total log-likelihood of a continuation
    given a context (the primitive lm-eval tasks are built on).
    thresholds: [L, 7] (a tensor or array; zeros when absent), moved to
    `device`."""

    def __init__(self, params, cfg: ModelConfig, *,
                 sp: SparsityConfig = SparsityConfig(), thresholds=None,
                 max_seq: int = 2048, device="cuda"):
        self.device = llama._device(device)
        self.params = params
        self.cfg = cfg
        self.sp = sp
        if thresholds is None:
            thresholds = llama.zero_thresholds(cfg, self.device)
        self.thresholds = torch.as_tensor(thresholds, dtype=torch.float32,
                                          device=self.device)
        self.max_seq = max_seq

    def _token_logprobs(self, ids: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """(log P(ids[i] | ids[:i]), the argmax token at each position)
        for i >= 1. ids: [T]. The argmax ids feed the `is_greedy` flag
        (continuation == greedy decode), computed from the same logits
        rather than by re-running generation."""
        t = len(ids)
        pad = 1 << max(3, (t - 1).bit_length())   # pad to a power of two
        pad = min(pad, self.max_seq)
        if t > pad:
            ids = ids[-pad:]
            t = pad
        padded = torch.zeros((1, pad), dtype=torch.int64)
        padded[0, :t] = torch.as_tensor(np.asarray(ids), dtype=torch.int64)
        tokens = padded.to(self.device)
        cache = KVCache.init(self.cfg, 1, pad,
                             llama.compute_dtype(self.params), self.device)
        logits, _ = llama.forward(self.params, tokens, cache, 0,
                                  self.thresholds, cfg=self.cfg, sp=self.sp,
                                  causal_prefill=True)
        logits = logits[:, :-1].float()
        logp = torch.log_softmax(logits, dim=-1)
        lp = logp.gather(-1, tokens[:, 1:, None])[0, :, 0]
        greedy = logits.argmax(-1)[0]
        pos = torch.arange(1, pad, device=self.device)
        lp = torch.where(pos < t, lp, 0.0)
        return (lp.cpu().numpy()[: t - 1], greedy.cpu().numpy()[: t - 1])

    def loglikelihood(self, context_ids: Sequence[int],
                      continuation_ids: Sequence[int]) -> Tuple[float, bool]:
        """(sum logprob of continuation, is_greedy). is_greedy is true iff
        every continuation token is the argmax prediction at its position
        (exact greedy-match, per lm_eval semantics)."""
        ids = np.asarray(list(context_ids) + list(continuation_ids))
        n_ctx = len(context_ids)
        if len(ids) > self.max_seq:
            # lm_eval convention: truncate the CONTEXT from the left, keep
            # the whole continuation (plus >= 1 conditioning token)
            drop = len(ids) - self.max_seq
            if drop >= n_ctx:
                raise ValueError(
                    f"continuation ({len(continuation_ids)} tokens) "
                    f"does not fit max_seq={self.max_seq} with at least "
                    "one context token")
            ids = ids[drop:]
            n_ctx -= drop
        lp, greedy = self._token_logprobs(ids)
        cont_lp = lp[n_ctx - 1:]
        cont_pred = greedy[n_ctx - 1:]
        cont_true = ids[n_ctx:]
        is_greedy = bool(np.all(cont_pred == cont_true))
        return float(cont_lp.sum()), is_greedy

    def score_choices(self, context_ids: Sequence[int],
                      choices: Sequence[Sequence[int]]) -> int:
        """Index of the highest-likelihood continuation (multiple choice)."""
        scores = [self.loglikelihood(context_ids, c)[0] for c in choices]
        return int(np.argmax(scores))


def _lm_base():
    """The LM base class: the real lm_eval when installed, the shim
    otherwise (the same calling convention)."""
    try:
        from lm_eval.api.model import LM  # type: ignore
        return LM, True
    except ImportError:
        from teal_tpu_torch.eval.lm_eval_shim import LM
        return LM, False


def make_lm_eval_model(score_model: ScoreModel, tokenizer, *,
                       generator=None, max_gen_toks: int = 64):
    """An lm_eval-compatible LM over a ScoreModel (+ an optional
    `teal_tpu_torch.engine.Generator` for generate_until; one with greedy
    sampling on the score model's device is built at first use when
    omitted)."""
    LM, _is_real = _lm_base()

    def get_generator():
        nonlocal generator
        if generator is None:
            from teal_tpu_torch.engine import Generator

            generator = Generator(
                score_model.cfg, score_model.params, sp=score_model.sp,
                max_seq=score_model.max_seq, temperature=0.0, top_k=None,
                device=score_model.device)
        return generator

    class TealTorchLM(LM):
        def loglikelihood(self, requests):
            out = []
            for req in requests:
                ctx, cont = req.args
                ctx_ids = tokenizer.encode(ctx, bos=True)
                cont_ids = tokenizer.encode(cont)
                out.append(score_model.loglikelihood(ctx_ids, cont_ids))
            return out

        def loglikelihood_rolling(self, requests):
            out = []
            for req in requests:
                (text,) = req.args
                ids = tokenizer.encode(text, bos=True)
                lp, _ = score_model._token_logprobs(np.asarray(ids))
                out.append(float(lp.sum()))
            return out

        def generate_until(self, requests):
            gen = get_generator()
            out = []
            for req in requests:
                ctx, kwargs = req.args
                until = kwargs.get("until", [])
                max_toks = int(kwargs.get("max_gen_toks", max_gen_toks))
                ids = tokenizer.encode(ctx, bos=True)
                tokens, _ = gen.generate(
                    np.asarray(ids), max_toks,
                    thresholds=score_model.thresholds)
                text = tokenizer.decode(tokens[0][len(ids):])
                for stop in until:
                    pos = text.find(stop)
                    if pos >= 0:
                        text = text[:pos]
                out.append(text)
            return out

    return TealTorchLM()
