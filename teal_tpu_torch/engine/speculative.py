"""Speculative decoding: a draft proposes k tokens, the target verifies
them in one forward.

Port of `teal_tpu/engine/speculative.py`, with the reference's algorithm
(`gpt-fast/generate.py:98-146`):
  - the draft decodes k tokens one at a time, recording its probs;
  - one target forward over [current, draft_0..k-1] gives k+1 prob rows;
  - draft token i is accepted with probability min(1, q_i / p_i) (q the
    target's, p the draft's); at the first rejection the next token is
    drawn from the residual max(q - p, 0) / sum; if all k are accepted a
    k+1-th token is drawn from the target's last row (the residual
    against a zero row);
  - with a separate draft cache, the draft is topped up with its last
    token so that both caches stay aligned; rejected positions' rows are
    overwritten by later rounds (attention masks them meanwhile).

Self-speculation (`draft_params is target_params` with a sparse
`draft_sp`): the draft is the same weights decoded through the sparse
token path (K1's single row, K2) and the target verifies densely through
`llama.block_verify` (K1's `fixed` rows form, K2's `seq_block`) where
`can_block_verify` holds. Speculative sampling makes the output
distribution the dense model's exactly, at any sparsity; its speed is
bounded by the acceptance rate.

Shared-cache self-speculation (`shared_cache=True`, the default when the
params are shared): draft and target use ONE KV cache. The draft writes
its rows at pos..pos+k-1, the dense verify then overwrites pos..pos+k,
so no top-up forward is needed, the cache memory halves and the draft
conditions on exact history.

Form. A round (`build_speculative_step`: the draft steps, the verify,
the acceptance and the residual's draw) reads nothing back to the host.
Both loops run it over static buffers (`_Rounds`: the last token, the
position, the round's tokens and n_valid, all on the device; the round
itself moves the token and the position on) and read the round's k + 2
ints once a round, for the next round's bound (the reference's host loop
waits there too). The host loop (`device_loop=False`) calls the round
from Python. `device_loop=True` (`build_speculative_loop`) keeps the
reference's on-device loop's semantics and stats (its `while` bound,
`n_target`, the adaptive depth) and, on a CUDA device, replays a CUDA
graph of the round, captured once for each depth k_eff it runs, into
one memory pool. Its one read a round drives the controller and the
bound, where the reference's `while_loop` reads once a generation: a
graph cannot branch on the device without conditional nodes. On the CPU
it calls the round as the host loop does. Draws come from an explicit
`torch.Generator` in a fixed order: the prefill's token, then per round
one draw per live draft step, k uniforms, and the residual's draw; the
rounds draw from a private generator (registered with the graphs), which
takes the caller's state before the first round and hands it back after
the last.

`forced_alpha` is a measurement harness only: each in-depth draft is
accepted with that probability instead of the q/p rule, so that
throughput can be measured at a chosen acceptance rate on random weights,
whose own acceptance is an artifact. It is not distribution-exact.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from teal_tpu_torch.config import ModelConfig, SparsityConfig
from teal_tpu_torch.engine.generate import (_default_generator,
                                            capture_graph)
from teal_tpu_torch.engine.sampling import draw, logits_to_probs
from teal_tpu_torch.models import llama
from teal_tpu_torch.models.llama import KVCache

# the adaptive controller's discount and optimistic prior (alpha ~ 0.8)
_DISCOUNT = np.float32(0.9)
_PRIOR = (np.float32(4.0), np.float32(5.0))


def _sample_probs(probs: torch.Tensor, generator) -> torch.Tensor:
    """One draw from probs [V] as a [1] int64 tensor: the reference's
    categorical over log(probs + 1e-30), so an all-zero row draws
    uniformly (`sampling.draw`: no host read, so a graph captures it)."""
    return draw(probs + 1e-30, generator)


def _verify_round(dtoks: torch.Tensor, dprobs: torch.Tensor,
                  tprobs: torch.Tensor, u: torch.Tensor, *, k_eff=None,
                  forced_alpha: Optional[float] = None):
    """The acceptance arithmetic of one round, on the device: draft tokens
    dtoks [k], the draft's probs dprobs [k, V], the target's tprobs
    [k+1, V] and uniforms u [k]. Draft i is accepted where u_i < min(1,
    q_i / p_i) (or u_i < forced_alpha), and i < k_eff where given; the
    accepted length is the first rejection's index (k if none); the
    residual is max(tprobs - dprobs, 0) at that row, normalised, with a
    zero row below dprobs so that acc_len == k draws from tprobs[k].
    Returns (accept [k] bool, acc_len 0-d int64, residual [V])."""
    k = dtoks.shape[0]
    ar = torch.arange(k, device=dtoks.device)
    if forced_alpha is None:
        p = dprobs[ar, dtoks]
        q = tprobs[ar, dtoks]
        accept = u < torch.clamp(q / p, max=1.0)
    else:
        accept = u < forced_alpha
    if k_eff is not None:
        accept = accept & (ar < k_eff)
    rej = (~accept).to(torch.int32)
    acc_len = torch.where(rej.any(), rej.argmax(), k)
    rows = torch.cat([tprobs.index_select(0, acc_len.reshape(1)),
                      torch.cat([dprobs, torch.zeros_like(tprobs[:1])])
                      .index_select(0, acc_len.reshape(1))])
    residual = torch.clamp(rows[0] - rows[1], min=0.0)
    residual = residual / torch.clamp(residual.sum(), min=1e-30)
    return accept, acc_len, residual


def _round_tokens(dtoks: torch.Tensor, acc_len: torch.Tensor,
                  next_token: torch.Tensor) -> torch.Tensor:
    """The round's [k+1] output: the accepted draft tokens, the residual's
    token at acc_len, zeros after it."""
    k = dtoks.shape[0]
    idx = torch.arange(k + 1, device=dtoks.device)
    return torch.where(idx < acc_len, torch.cat([dtoks, dtoks[-1:]]),
                       torch.where(idx == acc_len, next_token,
                                   torch.zeros_like(next_token)))


def _spec_step(pt, pd, cache_t, cache_d, token, pos: torch.Tensor, th_t,
               th_d, generator, *, k: int, temperature: float, top_k,
               target_cfg: ModelConfig, draft_cfg: ModelConfig,
               target_sp: SparsityConfig, draft_sp: SparsityConfig,
               rope_t, rope_d, shared_cache: bool = False,
               k_eff: Optional[int] = None,
               forced_alpha: Optional[float] = None):
    """One draft-propose / target-verify round.

    token: [1] int64 on the device (the last emitted token, at pos);
    pos: int32 [1] on the device, read there only;
    shared_cache: one cache for both roles (`cache_d` must be None): the
    draft writes its rows into `cache_t` and the dense verify overwrites
    them. k_eff (adaptive depth, shared cache only): draft steps
    i >= k_eff run no forward and give a zero probs row, and their
    proposals are rejected, so the round proposes k_eff tokens (k_eff 0
    is a plain target step through the zero-padded residual).

    Returns (tokens [k+1] int64 on the device, n_valid as a 0-d tensor);
    the caches are updated in place."""
    if shared_cache:
        assert cache_d is None, "shared_cache: pass cache_d=None"
        cache_d = cache_t
    zero = None
    tok, dtoks, dprobs = token, [], []
    for i in range(k):
        if k_eff is not None and i >= k_eff:
            if zero is None:
                zero = torch.zeros(draft_cfg.vocab_size, dtype=torch.float32,
                                   device=token.device)
            probs = zero
        else:
            logits, _ = llama.forward(pd, tok[:, None], cache_d, pos + i,
                                      th_d, cfg=draft_cfg, sp=draft_sp,
                                      rope=rope_d)
            probs = logits_to_probs(logits[0, 0], temperature, top_k)
            tok = _sample_probs(probs, generator)
        dtoks.append(tok)
        dprobs.append(probs)
    dtoks = torch.cat(dtoks)
    dprobs = torch.stack(dprobs)

    seq = torch.cat([token, dtoks])[None]                     # [1, k+1]
    # the token path also needs the cache in the stream type (the
    # reference's kernel casts; a mismatch takes the forward here)
    if (not target_sp.enabled
            and llama.can_block_verify(pt, target_cfg, k + 1)
            and llama.compute_dtype(pt) == cache_t.k.dtype):
        tlogits, _ = llama.block_verify(pt, seq, cache_t, pos, th_t,
                                        cfg=target_cfg, rope=rope_t)
    else:
        tlogits, _ = llama.forward(pt, seq, cache_t, pos, th_t,
                                   cfg=target_cfg, sp=target_sp,
                                   rope=rope_t)
    tprobs = logits_to_probs(tlogits[0], temperature, top_k)  # [k+1, V]

    u = torch.rand(k, generator=generator, device=token.device)
    _, acc_len, residual = _verify_round(dtoks, dprobs, tprobs, u,
                                         k_eff=k_eff,
                                         forced_alpha=forced_alpha)
    next_token = _sample_probs(residual, generator)

    if not shared_cache:
        # top up the draft cache with its own last token (the reference's
        # `generate.py:133-137`); a separate cache would go stale on
        # skipped steps, hence adaptive depth is shared-cache only
        assert k_eff is None, "adaptive k requires shared_cache"
        llama.forward(pd, dtoks[-1:][None], cache_d, pos + k, th_d,
                      cfg=draft_cfg, sp=draft_sp, rope=rope_d)
    return _round_tokens(dtoks, acc_len, next_token), acc_len + 1


def build_speculative_step(
    target_cfg: ModelConfig,
    draft_cfg: ModelConfig,
    *,
    speculate_k: int,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    target_sp: SparsityConfig = SparsityConfig(),
    draft_sp: SparsityConfig = SparsityConfig(),
    shared_params: bool = False,
    shared_cache: bool = False,
    forced_alpha: Optional[float] = None,
    max_seq: int = 2048,
    device="cuda",
):
    """Returns a round
    step(pt, pd, cache_t, cache_d, token [1], pos [1], th_t, th_d,
         generator, k_eff=None) -> (tokens [k+1] int64, n_valid int64 [])
    with the RoPE tables for `max_seq` positions built once. token and
    pos (int32) are device tensors, and so are the results: the round
    reads nothing back to the host, so a CUDA graph captures it
    (`_Rounds`). The caches are updated in place.

    shared_cache (requires shared_params): one cache for draft and
    target; the caller's cache_d is ignored. forced_alpha: the
    measurement harness (module docstring)."""
    if shared_cache:
        assert shared_params, "shared_cache requires shared params"
    device = llama._device(device)
    rope_t = llama.precompute_rope(target_cfg, max_seq, device)
    rope_d = (rope_t if draft_cfg == target_cfg
              else llama.precompute_rope(draft_cfg, max_seq, device))

    def step(pt, pd, cache_t, cache_d, token, pos, th_t, th_d, generator,
             k_eff=None):
        return _spec_step(
            pt, pt if shared_params else pd, cache_t,
            None if shared_cache else cache_d, token, pos, th_t, th_d,
            generator, k=speculate_k, temperature=temperature, top_k=top_k,
            target_cfg=target_cfg, draft_cfg=draft_cfg,
            target_sp=target_sp, draft_sp=draft_sp, rope_t=rope_t,
            rope_d=rope_d, shared_cache=shared_cache, k_eff=k_eff,
            forced_alpha=forced_alpha)

    return step


def _controller(acc_w, att_w, *, k: int, k_min: int = 0,
                draft_cost_ratio: float = 0.5,
                overhead_ratio: float = 0.15) -> Tuple[int, float]:
    """(k_eff, alpha_hat) from the discounted acceptance counters, in fp32
    as the reference computes them (`speculative.py:333-340`): alpha_hat =
    acc_w / max(att_w, 0.5) clipped to [0.02, 0.98] (the truncated-
    geometric MLE), and k_eff the depth j in [k_min, k] that maximises
    E[tokens | alpha_hat, j] / (j * draft_cost_ratio + 1 +
    overhead_ratio), the round's cost in verify units."""
    f32 = np.float32
    alpha = np.clip(f32(acc_w) / np.maximum(f32(att_w), f32(0.5)),
                    f32(0.02), f32(0.98))
    ks = np.arange(k + 1, dtype=f32)
    gain = (f32(1.0) - alpha ** (ks + f32(1.0))) / (f32(1.0) - alpha)
    cost = ks * f32(draft_cost_ratio) + f32(1.0) + f32(overhead_ratio)
    k_best = int(np.argmax(gain / cost))
    return int(np.clip(k_best, k_min, k)), float(alpha)


def build_speculative_loop(
    target_cfg: ModelConfig,
    draft_cfg: ModelConfig,
    *,
    speculate_k: int,
    max_new_tokens: int,
    max_seq: int,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    target_sp: SparsityConfig = SparsityConfig(),
    draft_sp: SparsityConfig = SparsityConfig(),
    shared_params: bool = False,
    shared_cache: bool = False,
    forced_alpha: Optional[float] = None,
    adaptive_k: bool = False,
    k_min: int = 0,
    draft_cost_ratio: float = 0.5,
    overhead_ratio: float = 0.15,
    probe_every: int = 8,
    device="cuda",
):
    """The whole generation loop (the reference's on-device `while_loop`
    program, here a round loop with the same semantics whose rounds are
    CUDA graph replays on a CUDA device, `_Rounds`). Returns
    run(pt, pd, cache_t, cache_d, token [1], pos, th_t, th_d, generator,
    n_target=max_new_tokens) -> (out_buf, n_out, n_rounds, pos_final[,
    k_eff_final, alpha_hat_final with adaptive_k]): out_buf holds n_out
    tokens (n_out may pass the bound by up to k); the loop runs while
    n_out < min(n_target, max_new_tokens) and pos + k + 1 < max_seq.

    adaptive_k (shared_cache only): each round's depth k_eff in [k_min,
    k] from `_controller` on counters discounted by 0.9 a round (prior
    4.0 / 5.0), floored at 1 every `probe_every` rounds so that the
    estimator keeps seeing evidence. The output distribution is unchanged
    at any depth."""
    k = speculate_k
    if shared_cache:
        assert shared_params, "shared_cache requires shared params"
    if adaptive_k:
        assert shared_cache, "adaptive_k requires shared_cache " \
            "(a separate draft cache would go stale on skipped steps)"
    device = llama._device(device)
    step = build_speculative_step(
        target_cfg, draft_cfg, speculate_k=k, temperature=temperature,
        top_k=top_k, target_sp=target_sp, draft_sp=draft_sp,
        shared_params=shared_params, shared_cache=shared_cache,
        forced_alpha=forced_alpha, max_seq=max_seq, device=device)
    ctl = dict(k=k, k_min=k_min, draft_cost_ratio=draft_cost_ratio,
               overhead_ratio=overhead_ratio)

    def run(pt, pd, cache_t, cache_d, token, pos, th_t, th_d, generator,
            n_target=max_new_tokens):
        bound = min(int(n_target), max_new_tokens)
        pos, n_out, rounds = int(pos), 0, 0
        acc_w, att_w = _PRIOR
        out = []

        src = (generator if generator is not None
               else _default_generator(device))
        rs = _Rounds(lambda tok, p, rng, k_eff: step(
            pt, pd, cache_t, cache_d, tok, p, th_t, th_d, rng, k_eff),
            k, token, pos, src)
        while n_out < bound and pos + k + 1 < max_seq:
            k_eff = None
            if adaptive_k:
                k_eff, _ = _controller(acc_w, att_w, **ctl)
                if rounds % probe_every == 0:
                    k_eff = max(k_eff, 1)
            host = rs.round(k_eff)
            n_valid = host[-1]
            if adaptive_k:
                # truncated-geometric counters, discounted: n_valid - 1
                # accepted out of that (+1 where a rejection was seen)
                acc = np.float32(n_valid - 1)
                att = acc + np.float32((n_valid - 1) < k_eff)
                acc_w = _DISCOUNT * acc_w + acc
                att_w = _DISCOUNT * att_w + att
            out.extend(host[:n_valid])
            n_out, pos, rounds = n_out + n_valid, pos + n_valid, rounds + 1
        src.set_state(rs.rng.get_state())
        res = (out, n_out, rounds, pos)
        if adaptive_k:
            res += _controller(acc_w, att_w, **ctl)
        return res

    return run


class _Rounds:
    """The rounds of both speculative loops over static buffers: the last
    token [1], the position int32 [1] and the round's result [k + 2] (its
    k + 1 tokens, then n_valid), all on the device. A round runs
    `round_fn(token, pos, rng, k_eff)` (`build_speculative_step`'s
    round), writes its result and moves the token and the position on:
    a call from Python, or on a CUDA device a replay of the graph
    captured for its k_eff (captured on first use, all depths in one
    memory pool). `rng` is a private generator registered with every
    graph; it starts at the state of `src`, and the caller hands its
    final state back."""

    def __init__(self, round_fn, k: int, token: torch.Tensor, pos: int,
                 src: torch.Generator):
        dev = token.device
        self.round_fn = round_fn
        self.token = token.reshape(1).clone()
        self.pos = torch.full((1,), pos, dtype=torch.int32, device=dev)
        self.res = torch.zeros(k + 2, dtype=torch.int64, device=dev)
        self.rng = torch.Generator(device=dev)
        self.rng.set_state(src.get_state())
        self.graphs = {}
        self.pool = None

    def body(self, k_eff) -> None:
        toks, n_valid = self.round_fn(self.token, self.pos, self.rng, k_eff)
        self.res[:-1].copy_(toks)
        self.res[-1:].copy_(n_valid.reshape(1))
        self.token.copy_(toks.index_select(0, (n_valid - 1).reshape(1)))
        self.pos += n_valid.to(torch.int32)

    def _capture(self, k_eff) -> torch.cuda.CUDAGraph:
        """Capture the round at depth k_eff (`capture_graph`, one warm-up
        round). The warm-up writes the cache rows that the round itself
        writes next (they are written again before anything reads
        them); the token, the position and the generator are put
        back."""
        saved = (self.token.clone(), self.pos.clone(), self.rng.get_state())
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = capture_graph(lambda: self.body(k_eff), self.rng, warmups=1,
                              pool=self.pool)
        self.token.copy_(saved[0])
        self.pos.copy_(saved[1])
        self.rng.set_state(saved[2])
        return graph

    def round(self, k_eff, replay: bool = True) -> list:
        """Run one round, by a replay of its depth's graph (`replay` on a
        CUDA device) or by calling the body; returns its k + 1 tokens and
        n_valid as host ints (the one read a round)."""
        if not replay or self.token.device.type != "cuda":
            self.body(k_eff)
        else:
            if k_eff not in self.graphs:
                self.graphs[k_eff] = self._capture(k_eff)
            self.graphs[k_eff].replay()
        return self.res.tolist()


def speculative_generate(
    target_params, draft_params,
    target_cfg: ModelConfig, draft_cfg: ModelConfig,
    prompt_tokens,
    max_new_tokens: int,
    *,
    speculate_k: int = 5,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    max_seq: int = 2048,
    target_sp: SparsityConfig = SparsityConfig(),
    draft_sp: SparsityConfig = SparsityConfig(),
    target_thresholds=None,
    draft_thresholds=None,
    generator: Optional[torch.Generator] = None,
    cache_dtype=torch.bfloat16,
    device_loop: bool = False,
    shared_cache: Optional[bool] = None,
    n_target: Optional[int] = None,
    forced_alpha: Optional[float] = None,
    adaptive_k: bool = False,
    draft_cost_ratio: float = 0.5,
    device="cuda",
) -> Tuple[np.ndarray, dict]:
    """Returns (all tokens [T+new] int64, stats).

    device_loop=False: the host loop of the reference's interactive path
    (stats: accepted_per_step, mean_accepted, new_tokens).
    device_loop=True: the reference's on-device loop's semantics
    (`build_speculative_loop`; stats: mean_accepted = (n - rounds) /
    rounds, new_tokens, rounds, and with adaptive_k k_eff_final and
    alpha_hat_final). shared_cache: one KV cache for draft and target;
    default: on exactly when the params are shared. n_target
    (device_loop): bound the generation below max_new_tokens.
    generator: a `torch.Generator` on `device` (seed 0 when absent).
    Thresholds are [L, 7] fp32 tensors on `device` (zeros when absent)."""
    device = llama._device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    shared_params = target_params is draft_params
    if shared_cache is None:
        shared_cache = shared_params
    if shared_cache and not shared_params:
        raise ValueError("shared_cache requires target_params is "
                         "draft_params (self-speculation)")
    if adaptive_k and not device_loop:
        raise ValueError("adaptive_k requires device_loop=True")
    th_t = (target_thresholds if target_thresholds is not None
            else llama.zero_thresholds(target_cfg, device))
    th_d = (draft_thresholds if draft_thresholds is not None
            else llama.zero_thresholds(draft_cfg, device))

    prompt = torch.as_tensor(np.asarray(prompt_tokens),
                             dtype=torch.int64).reshape(1, -1)
    t = prompt.shape[1]
    prompt_d = prompt.to(device)

    # prefill on the prompt (pos 0, an empty cache; shared cache: one
    # dense prefill serves both roles)
    cache_t = KVCache.init(target_cfg, 1, max_seq, cache_dtype, device)
    logits, _ = llama.forward(target_params, prompt_d, cache_t, 0, th_t,
                              cfg=target_cfg, sp=target_sp,
                              causal_prefill=True)
    probs = logits_to_probs(logits[0, -1], temperature, top_k)
    cur = _sample_probs(probs, generator)
    cache_d = None
    if not shared_cache:
        cache_d = KVCache.init(draft_cfg, 1, max_seq, cache_dtype, device)
        llama.forward(draft_params, prompt_d, cache_d, 0, th_d,
                      cfg=draft_cfg, sp=draft_sp, causal_prefill=True)

    common = dict(speculate_k=speculate_k, temperature=temperature,
                  top_k=top_k, target_sp=target_sp, draft_sp=draft_sp,
                  shared_params=shared_params, shared_cache=shared_cache,
                  forced_alpha=forced_alpha, max_seq=max_seq, device=device)
    if device_loop:
        run = build_speculative_loop(
            target_cfg, draft_cfg, max_new_tokens=max_new_tokens - 1,
            adaptive_k=adaptive_k, draft_cost_ratio=draft_cost_ratio,
            **common)
        res = run(target_params, draft_params, cache_t, cache_d, cur, t,
                  th_t, th_d, generator,
                  *(() if n_target is None else (n_target,)))
        out_buf, n, rounds = res[0], res[1], res[2]
        r = max(rounds, 1)
        new = ([int(cur)] + out_buf[:n])[:max_new_tokens]
        stats = {
            "accepted_per_step": [],
            "mean_accepted": (n - r) / r,
            "new_tokens": len(new),
            "rounds": r,
        }
        if adaptive_k:
            stats["k_eff_final"] = res[4]
            stats["alpha_hat_final"] = res[5]
        return np.concatenate([prompt[0].numpy(),
                               np.asarray(new, np.int64)]), stats

    step = build_speculative_step(target_cfg, draft_cfg, **common)
    rs = _Rounds(lambda tok, p, rng, k_eff: step(
        target_params, draft_params, cache_t, cache_d, tok, p, th_t, th_d,
        rng, k_eff), speculate_k, cur, t, generator)
    out = [int(cur)]
    pos = t
    accept_counts = []
    while len(out) < max_new_tokens:
        host = rs.round(None, replay=False)
        n = host[-1]
        accept_counts.append(n - 1)
        take = min(n, max_new_tokens - len(out))
        out.extend(host[:take])
        pos += n
        if pos + speculate_k + 1 >= max_seq:
            break
    generator.set_state(rs.rng.get_state())
    stats = {
        "accepted_per_step": accept_counts,
        "mean_accepted": (float(np.mean(accept_counts)) if accept_counts
                          else 0.0),
        "new_tokens": len(out),
    }
    return np.concatenate([prompt[0].numpy(),
                           np.asarray(out, np.int64)]), stats
