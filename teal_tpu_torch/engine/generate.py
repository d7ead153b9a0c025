"""Prefill + decode generation engine.

Port of `teal_tpu/engine/generate.py`: a dense prefill over the prompt
padded to `_pad_len` (the padded rows' cache entries lie past the prompt
and are masked out until decode overwrites them, as in the reference;
the prefill starts at pos 0, so it runs with `causal_prefill` and a
prompt padded to 256 or more takes kernel K6),
then one `forward` per new token in a Python loop. Tokens stay on the
device until the end, so the loop never waits for the card. `warmup`
runs one short generation first, as the reference's does. The
reference's on-device token loop (`generate(on_device_loop=)`) has its
Hopper form in a CUDA graph of the decode step, which is later work.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from teal_tpu_torch.config import ModelConfig, SparsityConfig
from teal_tpu_torch.engine import sampling
from teal_tpu_torch.models import llama
from teal_tpu_torch.models.llama import KVCache


def _pad_len(n: int) -> int:
    """Next power of two (min 8): the reference's prompt padding."""
    p = 8
    while p < n:
        p *= 2
    return p


@dataclass
class GenerateStats:
    prefill_s: float
    decode_s: float
    new_tokens: int
    tokens_per_s: float
    bandwidth_gb_s: float


class Generator:
    """Generation for one (model config, sparsity config) on one device.
    The default cache type, bf16, is the compute type of quantized
    params (`llama.compute_dtype`), which the token path needs."""

    def __init__(self, cfg: ModelConfig, params, *,
                 sp: SparsityConfig = SparsityConfig(),
                 max_seq: Optional[int] = None, batch: int = 1,
                 cache_dtype=torch.bfloat16, temperature: float = 0.8,
                 top_k: Optional[int] = 200, device="cuda"):
        self.device = llama._device(device)
        self.cfg = cfg
        self.params = params
        self.sp = sp
        self.max_seq = max_seq or cfg.max_seq_len
        self.batch = batch
        self.cache_dtype = cache_dtype
        self.temperature = temperature
        self.top_k = top_k
        self.rope = llama.precompute_rope(cfg, self.max_seq, self.device)

        def leaf_bytes(w):
            ts = w.values() if isinstance(w, dict) else (w,)
            return sum(t.numel() * t.element_size() for t in ts)

        # projection bytes (bf16/fp32, int8 and int4 leaves with their
        # scales) and Mixtral's router; the reference protocol excludes
        # embeddings
        self.model_bytes = sum(
            leaf_bytes(params["layers"][n])
            for n in ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown",
                      "router")
            if n in params["layers"])

    def new_cache(self) -> KVCache:
        return KVCache.init(self.cfg, self.batch, self.max_seq,
                            self.cache_dtype, self.device)

    def warmup(self, prompt_len: int = 4, new_tokens: int = 2) -> None:
        """Run one short generation so that later `generate` timings are
        warm: the kernels built and loaded, the allocator's blocks in
        place (the reference times 5 samples after a warm-up sample,
        gpt-fast/generate.py:431-497)."""
        prompt = np.ones((self.batch, prompt_len), np.int64)
        self.generate(prompt, new_tokens)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, prompt_tokens, max_new_tokens: int, *,
                 thresholds: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[np.ndarray, GenerateStats]:
        """prompt_tokens: [B, T] or [T] ints. Returns (all tokens, stats)."""
        if thresholds is None:
            thresholds = llama.zero_thresholds(self.cfg, self.device)
        prompt = torch.as_tensor(np.asarray(prompt_tokens), dtype=torch.int64)
        if prompt.dim() == 1:
            prompt = prompt[None]
        b, t = prompt.shape
        if b != self.batch:
            raise ValueError(f"prompt batch {b} != generator batch "
                             f"{self.batch}")
        if max(_pad_len(t), t + max_new_tokens - 1) > self.max_seq:
            raise ValueError(f"prompt {t} + {max_new_tokens} new tokens do "
                             f"not fit max_seq {self.max_seq}")
        padded = torch.zeros((b, _pad_len(t)), dtype=torch.int64)
        padded[:, :t] = prompt
        padded = padded.to(self.device)
        cache = self.new_cache()
        prefill_sp = self.sp if self.sp.apply_prefill \
            else self.sp.replace(enabled=False)

        self._sync()
        t0 = time.perf_counter()
        logits, cache = llama.forward(self.params, padded, cache, 0,
                                      thresholds, cfg=self.cfg,
                                      sp=prefill_sp, rope=self.rope,
                                      causal_prefill=True)
        tok = sampling.sample(logits[:, t - 1], self.temperature, self.top_k,
                              generator)
        self._sync()
        t1 = time.perf_counter()

        toks = [tok]
        for pos in range(t, t + max_new_tokens - 1):
            logits, cache = llama.forward(self.params, tok[:, None], cache,
                                          pos, thresholds, cfg=self.cfg,
                                          sp=self.sp, rope=self.rope)
            tok = sampling.sample(logits[:, 0], self.temperature,
                                  self.top_k, generator)
            toks.append(tok)
        out = torch.stack(toks, dim=1).cpu().numpy()   # waits for the card
        t2 = time.perf_counter()

        decode_s = t2 - t1
        n_new = out.shape[1]
        tps = (n_new - 1) / decode_s if decode_s > 0 else float("inf")
        stats = GenerateStats(
            prefill_s=t1 - t0, decode_s=decode_s, new_tokens=n_new,
            tokens_per_s=tps,
            bandwidth_gb_s=self.model_bytes * tps / 1e9)
        return np.concatenate([prompt.numpy(), out], axis=1), stats
