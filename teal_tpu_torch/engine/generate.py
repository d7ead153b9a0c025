"""Prefill + decode generation engine.

Port of `teal_tpu/engine/generate.py`: a dense prefill over the prompt
padded to `_pad_len` (the padded rows' cache entries lie past the prompt
and are masked out until decode overwrites them, as in the reference;
the prefill starts at pos 0, so it runs with `causal_prefill` and a
prompt padded to 256 or more takes kernel K6), then the decode steps.
Tokens stay on the device until the end. `warmup` runs one short
generation first, as the reference's does.

The decode is one step function over static buffers (`_DecodeLoop`:
the token, the position as an int32 device tensor, the thresholds, a
cache the `Generator` allocates once, an output row indexed by the
device position), which runs the embedding, `forward`, the draw, the
token's write and `pos += 1`. It draws from a private generator, into
which the caller's generator state is copied before the decode and back
after it. Two loops run it, as in the reference (`generate(
on_device_loop=)`):
  - the on-device loop (the default; the reference's `lax.scan`,
    `decode_scan_fn`): on a CUDA device the step is captured once per
    `Generator` as a CUDA graph (after a warm-up on a side stream that
    builds and loads every kernel; the private generator registered with
    it) and replayed once a token: the CUDA driver issues the step's
    launches, with no Python, ctypes or allocator work a token. A
    capture that fails raises; nothing carries on in the host loop.
  - the host loop (`on_device_loop=False`, and either loop on the CPU):
    the step called from Python once a token.
Kernel launch counters (`select_gather_gemv.launches`, ...) count where
a wrapper launches, which in the graph is the warm-up and the capture,
not the replays: count a replay's kernels from the profiler's records.
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
        self._loop = None    # the on-device loop, made on its first use

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
        place and, on a CUDA device, the decode step's graph captured
        (the reference times 5 samples after a warm-up sample,
        gpt-fast/generate.py:431-497)."""
        prompt = np.ones((self.batch, prompt_len), np.int64)
        self.generate(prompt, new_tokens)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, prompt_tokens, max_new_tokens: int, *,
                 thresholds: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 on_device_loop: bool = True
                 ) -> Tuple[np.ndarray, GenerateStats]:
        """prompt_tokens: [B, T] or [T] ints. Returns (all tokens, stats).
        on_device_loop: decode by replays of the step's CUDA graph on a
        CUDA device, else by calling the step from Python once a token
        (module docstring); both give the same tokens from the same
        generator state, and on the CPU both run the step eagerly."""
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
        if self._loop is None:
            self._loop = _DecodeLoop(self)
        cache = self._loop.begin(thresholds)
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

        out = self._loop.run(tok, t, max_new_tokens, generator,
                             replay=on_device_loop)
        t2 = time.perf_counter()

        decode_s = t2 - t1
        n_new = out.shape[1]
        tps = (n_new - 1) / decode_s if decode_s > 0 else float("inf")
        stats = GenerateStats(
            prefill_s=t1 - t0, decode_s=decode_s, new_tokens=n_new,
            tokens_per_s=tps,
            bandwidth_gb_s=self.model_bytes * tps / 1e9)
        return np.concatenate([prompt.numpy(), out], axis=1), stats


def capture_graph(fn, rng: torch.Generator, warmups: int,
                  pool=None) -> "torch.cuda.CUDAGraph":
    """Capture fn() (launches on the current stream of a CUDA device) as
    a CUDA graph that draws from `rng`: fn runs `warmups` times first on
    a side stream, which builds and loads every kernel and makes the
    libraries' handles, as capture requires; the warm-up's writes are
    the caller's to undo. pool: a memory pool shared with other graphs
    (`torch.cuda.graph_pool_handle`). The graph keeps its captured
    `cudaGraph_t` (`raw_cuda_graph()`), whose kernel nodes say what a
    replay launches. A failed capture raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmups):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.register_generator_state(rng)
    with torch.cuda.graph(graph, pool=pool):
        fn()
    graph.instantiate()
    return graph


def _default_generator(device: torch.device) -> torch.Generator:
    """The generator a draw with `generator=None` takes on `device`."""
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        return torch.cuda.default_generators[index]
    return torch.default_generator


class _DecodeLoop:
    """The on-device decode loop of one `Generator` (module docstring):
    its static buffers, its step, and on a CUDA device the step's graph,
    captured on the first `run` that replays."""

    def __init__(self, gen: Generator):
        dev = self.device = gen.device
        # what the step reads of the Generator, not the Generator itself:
        # no reference cycle keeps a dropped Generator's graph and cache
        # on the card until the cyclic collector runs
        self.params, self.cfg, self.sp, self.rope = (gen.params, gen.cfg,
                                                     gen.sp, gen.rope)
        self.temperature, self.top_k = gen.temperature, gen.top_k
        self.cache = gen.new_cache()
        self.tok = torch.zeros(gen.batch, dtype=torch.int64, device=dev)
        self.pos = torch.zeros(1, dtype=torch.int32, device=dev)
        self.th = llama.zero_thresholds(gen.cfg, dev)
        # a token's column is its position: up to max_seq for the last
        self.out = torch.zeros((gen.batch, gen.max_seq + 1),
                               dtype=torch.int64, device=dev)
        self.rng = torch.Generator(device=dev)
        self.graph = None

    def begin(self, thresholds: torch.Tensor) -> KVCache:
        """Reset the cache and take this generation's thresholds; returns
        the cache for the prefill."""
        self.cache.k.zero_()
        self.cache.v.zero_()
        self.th.copy_(thresholds)
        return self.cache

    def step(self) -> None:
        """One decode step on the static buffers: the token at `pos` in,
        the next token written at `pos + 1` of `out`, `pos` advanced."""
        logits, _ = llama.forward(self.params, self.tok[:, None],
                                  self.cache, self.pos, self.th,
                                  cfg=self.cfg, sp=self.sp, rope=self.rope)
        tok = sampling.sample(logits[:, 0], self.temperature, self.top_k,
                              self.rng)
        self.tok.copy_(tok)
        self.pos += 1
        self.out.index_copy_(1, self.pos.long(), tok[:, None])

    def run(self, tok: torch.Tensor, t: int, n: int,
            generator: Optional[torch.Generator],
            replay: bool = True) -> np.ndarray:
        """Decode n - 1 tokens after the prefill's `tok` at position t, by
        replays of the step's graph (`replay` on a CUDA device) or by
        calling the step; returns the n new tokens [B, n] (one read at
        the end)."""
        dev = self.device
        replay = replay and dev.type == "cuda"
        if replay and self.graph is None and n > 1:
            # the warm-up writes the cache and the buffers, set afresh
            # below; the private generator takes the caller's state
            self.pos.fill_(t)
            self.graph = capture_graph(self.step, self.rng, warmups=2)
        src = generator if generator is not None else _default_generator(dev)
        self.rng.set_state(src.get_state())
        self.tok.copy_(tok)
        self.pos.fill_(t)
        self.out[:, t] = tok
        for _ in range(n - 1):
            if replay:
                self.graph.replay()
            else:
                self.step()
        src.set_state(self.rng.get_state())
        return self.out[:, t:t + n].cpu().numpy()       # waits for the card
