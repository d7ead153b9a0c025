"""Continuous batching: a slot-based serving engine.

Port of `teal_tpu/engine/serving.py`. A fixed pool of KV-cache slots
(the cache's batch rows), each at its own sequence position; one decode
step runs `forward` for ALL slots at once (`pos [slots]`), so with the
main-path config it is one pass of the batched token path: per layer one
K1 launch per stage and one K2 launch for every slot together. Inactive
slots ride along with token 0 at position 0, as in the reference: they
take part in the pooled group selection and write row 0 of their own
cache row, which admission overwrites.

Admission is FIFO. One-shot admission (`prefill_slot`) runs a batch-1
dense prefill of the prompt, padded to `_pad_len`, into a `pad`-long
sub-cache (pos 0, so with `causal_prefill`: a prompt padded to 256 or
more takes kernel K6), copies it into the slot's cache row and samples
the first token. Chunked admission (`prefill_chunk=C`) prefills one
pending prompt C positions per engine step (`forward` at S = C, pos > 0
on the sub-cache), interleaved with the decode step, and copies the
sub-cache into the slot after the last chunk; at temperature 0 it gives
the same tokens as one-shot admission.

Sampling draws from an explicit `torch.Generator` (temperature > 0);
temperature 0 is greedy argmax. The cache is updated in place.

On a tensor-parallel group (`mesh=`, the counterpart of the reference
engine run on `tp.shard_params` trees and a `tp.shard_cache` cache) the
params are this rank's shards, every `forward` runs the sharded layer
loop on the group, and the cache and every admission sub-cache hold only
the rank's n_kv_heads / tp heads. Every rank runs this same host loop on
the same submissions, as the reference's SPMD host code does; the logits
reach every rank by the rank-ordered gather, so greedy tokens agree, and
at temperature > 0 each rank's generator, seeded alike (the default
seeds 0), draws the same tokens in the same order. The sharded forward
refuses what `llama.check_sharded` refuses (a decode step through the
sparse single-token kernels raises at the first step).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from teal_tpu_torch.config import ModelConfig, SparsityConfig
from teal_tpu_torch.engine import sampling
from teal_tpu_torch.engine.generate import _pad_len
from teal_tpu_torch.models import llama
from teal_tpu_torch.models.llama import KVCache


@dataclass
class Request:
    id: int
    prompt: List[int]
    max_new_tokens: int
    out: List[int] = field(default_factory=list)
    done: bool = False
    submitted_at: float = field(default_factory=time.time)


class ContinuousBatchingEngine:
    """The server. mesh: a `parallel.mesh.Mesh` whose one split axis is
    "tp" (`make_mesh(tp=n)`, `make_tp_mesh(n)`); `params` are then this
    rank's shards (`parallel.tp.shard_params`)."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_seq: int = 2048, sp: SparsityConfig = SparsityConfig(),
                 thresholds: Optional[torch.Tensor] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 eos_id: Optional[int] = None, cache_dtype=torch.bfloat16,
                 prefill_chunk: Optional[int] = None, device="cuda",
                 generator: Optional[torch.Generator] = None, mesh=None):
        self.device = llama._device(device)
        self.tp_group = None
        if mesh is not None:
            if not mesh.member:
                raise ValueError("this rank is not in the server's mesh")
            wide = {a: n for a, n in mesh.shape.items()
                    if a != "tp" and n > 1}
            if wide:
                raise ValueError(f"the server shards over tp only; the mesh "
                                 f"also splits {wide}")
            self.tp_group = mesh.group("tp")
        self.tp = 1 if self.tp_group is None else self.tp_group.size
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.sp = sp
        self.thresholds = (thresholds if thresholds is not None
                           else llama.zero_thresholds(cfg, self.device))
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id
        self.prefill_chunk = prefill_chunk
        self.generator = (generator if generator is not None else
                          torch.Generator(self.device).manual_seed(0))
        self.cache = KVCache.init(cfg, slots, max_seq, cache_dtype,
                                  self.device, tp=self.tp)
        self.rope = llama.precompute_rope(cfg, max_seq, self.device)
        self.prefill_sp = sp if sp.apply_prefill else sp.replace(enabled=False)

        self.pos = np.zeros(slots, np.int64)          # next write position
        self.cur = np.zeros(slots, np.int64)          # next input token
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self._pending: Optional[dict] = None   # in-flight chunked admission
        self._next_id = 0

    # -- public API -----------------------------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int) -> int:
        req = Request(self._next_id, list(prompt), max_new_tokens)
        self._next_id += 1
        self.queue.append(req)
        return req.id

    def has_work(self) -> bool:
        return (bool(self.queue) or self._pending is not None
                or any(r is not None for r in self.active))

    def step(self) -> List[Request]:
        """Admit queued requests into free slots, run one decode step for
        all slots, collect tokens. Returns requests finished this step."""
        self._admit()
        if not any(r is not None for r in self.active):
            return []
        toks = self._decode_step()

        done_now: List[Request] = []
        for b, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(self.cur[b])
            req.out.append(tok)
            self.pos[b] += 1
            self.cur[b] = toks[b]
            hit_eos = self.eos_id is not None and tok == self.eos_id
            if (len(req.out) >= req.max_new_tokens or hit_eos
                    or self.pos[b] + 1 >= self.max_seq):
                req.done = True
                self.finished.append(req)
                done_now.append(req)
                self.active[b] = None
                self.pos[b] = 0
                self.cur[b] = 0
        return done_now

    def run(self, max_steps: int = 100000) -> List[Request]:
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    # -- internals ------------------------------------------------------------

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sampling.sample(logits, self.temperature, self.top_k,
                               self.generator)

    def _decode_step(self) -> np.ndarray:
        """One forward of every slot at its own position; the sampled next
        tokens [slots] on the host."""
        tokens = torch.from_numpy(self.cur[:, None]).to(self.device)
        logits, _ = llama.forward(self.params, tokens, self.cache, self.pos,
                                  self.thresholds, cfg=self.cfg, sp=self.sp,
                                  rope=self.rope, tp_group=self.tp_group)
        return self._sample(logits[:, 0]).cpu().numpy()

    def _sub_cache(self, length: int) -> KVCache:
        """A batch-1 cache of `length` positions (the rank's heads) for one
        admission."""
        return KVCache.init(self.cfg, 1, length, self.cache.k.dtype,
                            self.device, tp=self.tp)

    def _scatter_slot(self, sub: KVCache, slot: int) -> None:
        """Copy a sub-cache into positions [0, its length) of `slot`."""
        n = sub.max_seq
        self.cache.k[:, slot, :, :n] = sub.k[:, 0]
        self.cache.v[:, slot, :, :n] = sub.v[:, 0]

    def _padded(self, prompt: List[int], length: int) -> torch.Tensor:
        padded = np.zeros((1, length), np.int64)
        padded[0, :len(prompt)] = prompt
        return torch.from_numpy(padded).to(self.device)

    def _activate(self, slot: int, req: Request, first_token: int) -> None:
        self.active[slot] = req
        self.pos[slot] = len(req.prompt)
        self.cur[slot] = first_token

    def _admit(self):
        if self.prefill_chunk:
            self._admit_chunked()
            return
        for b in range(self.slots):
            if self.active[b] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            t = len(req.prompt)
            pad = _pad_len(t)
            sub = self._sub_cache(pad)
            logits, sub = llama.forward(self.params, self._padded(req.prompt,
                                                                  pad),
                                        sub, 0, self.thresholds,
                                        cfg=self.cfg, sp=self.prefill_sp,
                                        causal_prefill=True,
                                        tp_group=self.tp_group)
            self._scatter_slot(sub, b)
            self._activate(b, req, int(self._sample(logits[:, t - 1])[0]))

    def _admit_chunked(self):
        """Advance chunked admission by AT MOST one chunk per engine
        step: one pending prompt prefills `prefill_chunk` positions into
        a slot-local sub-cache, then the decode step for active slots
        runs, so a long prompt never stalls concurrent decodes for more
        than one chunk at a time."""
        C = self.prefill_chunk
        if self._pending is None and self.queue:
            free = [b for b in range(self.slots) if self.active[b] is None]
            if free:
                req = self.queue.pop(0)
                t = len(req.prompt)
                n_chunks = max(1, -(-t // C))
                pad = n_chunks * C
                self._pending = dict(req=req, slot=free[0],
                                     tokens=self._padded(req.prompt, pad),
                                     sub=self._sub_cache(pad), chunk=0,
                                     n_chunks=n_chunks, true_len=t)
        p = self._pending
        if p is None:
            return
        i = p["chunk"]
        logits, p["sub"] = llama.forward(
            self.params, p["tokens"][:, i * C:(i + 1) * C], p["sub"], i * C,
            self.thresholds, cfg=self.cfg, sp=self.prefill_sp,
            tp_group=self.tp_group)
        p["chunk"] = i + 1
        if p["chunk"] < p["n_chunks"]:
            return
        # final chunk: copy the sub-cache into the slot, sample the first
        # token from the last real position's logits (in this chunk:
        # n_chunks == ceil(t/C))
        b, req, t = p["slot"], p["req"], p["true_len"]
        self._scatter_slot(p["sub"], b)
        self._activate(b, req, int(self._sample(logits[:, (t - 1) % C])[0]))
        self._pending = None
