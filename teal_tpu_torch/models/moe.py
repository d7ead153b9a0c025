"""Mixtral-style mixture-of-experts FFN of the layer loop, in PyTorch.

Port of `teal_tpu/models/moe.py` (plain tensor code there too: XLA, no
Pallas): top-k softmax routing over E experts, SwiGLU experts, outputs
combined by the routing weights.

  - decode (one position, B <= 8) runs only the routed experts of each
    row, with the TEAL rule of the sparsity config on each expert's input
    and on its own intermediate, and combines them in the stream type with
    weights rounded to it (the semantics twin of the token path's MoE
    stages, `ops/token_block.py`, which adds each expert in fp32);
  - prefill runs every expert with `apply_sparsity`'s prefill rule and
    combines in fp32. It loops over the experts instead of materialising
    `[E, ...]` copies: a dequantised int8 Mixtral layer would take 2.8 GB
    of bf16. The sums are those of the reference, expert by expert.

The router picks like `jax.lax.top_k`: the lowest index wins among equal
logits (`torch.topk` promises no order for ties).

A quirk of the reference, kept: calibration leaves the MoE down threshold
(column 6 of the [L, 7] table) at 0, so in threshold mode each expert's
down stage keeps every group with a score above 0 up to `cap`, which is
its first `cap` groups by index rather than its largest.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from teal_tpu_torch.config import ModelConfig, SparsityConfig
from teal_tpu_torch.ops.block_gemv import effective_block_size
from teal_tpu_torch.ops.quant import matmul_f32
from teal_tpu_torch.ops.sparsify import (apply_sparsity, sparsify,
                                         sparsify_groups)


def init_moe_ffn_params(cfg: ModelConfig, generator: torch.Generator,
                        dtype=torch.bfloat16, device="cuda"):
    """Per-layer MoE FFN params: router [L, D, E], wgate / wup
    [L, E, D, I], wdown [L, E, I, D]. N(0, 0.02^2) drawn in fp32 one
    matrix at a time on `device`, then cast to `dtype`; the router keeps
    its `dtype`-rounded values in fp32, the type the token path reads."""
    L, D, I, E = (cfg.n_layers, cfg.dim, cfg.intermediate_size,
                  cfg.n_experts)

    def draw(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device) * 0.02

    def experts(K, N):
        out = torch.empty((L, E, K, N), dtype=dtype, device=device)
        for l in range(L):
            for e in range(E):
                out[l, e] = draw((K, N))
        return out

    router = torch.empty((L, D, E), dtype=torch.float32, device=device)
    for l in range(L):
        router[l] = draw((D, E)).to(dtype)
    return {"router": router, "wgate": experts(D, I), "wup": experts(D, I),
            "wdown": experts(I, D)}


def _mm(y: torch.Tensor, w: torch.Tensor, scale=None) -> torch.Tensor:
    """y @ one expert's weight with fp32 sums of the products in y's type;
    an int8 weight is converted to y's type and its per-channel scale
    goes on the sums (the reference's dequant-in-matmul)."""
    out = matmul_f32(y, w)
    return out if scale is None else out * scale.float()


def _expert_ffn(y, wg, wu, wd, sg=None, su=None, sd=None, inter_rule=None):
    """SwiGLU through one expert: fp32 gate and up, silu(gate) * up cast
    to y's type, `inter_rule` (this expert's own sparsification of its
    intermediate), then the down projection cast to y's type."""
    gate = _mm(y, wg, sg)
    up = _mm(y, wu, su)
    inter = (F.silu(gate) * up).to(y.dtype)
    if inter_rule is not None:
        inter = inter_rule(inter)
    return _mm(inter, wd, sd).to(y.dtype)


def _wq(leaf, e=None):
    """(weights, int8 scale or None) of an expert leaf ([E, K, N] array or
    {"q": [E, K, N], "scale": [E, N]}), at expert e when given (an int or
    a [1] device index: a gather on the device, no host sync)."""
    q, s = (leaf["q"], leaf["scale"]) if isinstance(leaf, dict) \
        else (leaf, None)
    if e is None:
        return q, s
    if isinstance(e, torch.Tensor):
        return q.index_select(0, e)[0], (None if s is None
                                         else s.index_select(0, e)[0])
    return q[e], (None if s is None else s[e])


def route(y: torch.Tensor, router: torch.Tensor, k: int):
    """fp32 router logits of y [..., D] against router [D, E] (fp32 sums
    of the products in y's type), the top k by repeated argmax (the lowest
    index among equal logits, `jax.lax.top_k`'s order) and their softmax.
    Returns (top indices [..., k] int64, weights [..., k] fp32)."""
    logits = torch.matmul(y.float(), router.float())
    E = logits.shape[-1]
    taken = torch.zeros_like(logits, dtype=torch.bool)
    iota = torch.arange(E, device=y.device)
    idx = []
    for _ in range(k):
        i = torch.argmax(logits.masked_fill(taken, float("-inf")), dim=-1)
        taken = taken | (iota == i[..., None])
        idx.append(i)
    idx = torch.stack(idx, dim=-1)
    return idx, torch.softmax(torch.gather(logits, -1, idx), dim=-1)


def moe_ffn(y: torch.Tensor, lp, cfg: ModelConfig,
            sp: Optional[SparsityConfig] = None, th_gu=None, th_down=None):
    """y: [B, S, D] (the normalized mlp input) -> [B, S, D] in y's type.

    lp: one layer's leaves, router [D, E] and the expert stacks wgate /
    wup [E, D, I], wdown [E, I, D] (arrays or int8 {"q", "scale"} dicts).
    sp / th_gu / th_down: the decode rule (block kernel or group mode:
    `sparsify_groups` of the expert input at keep kf[4] and threshold
    th_gu, of each expert's intermediate at kf[6] and th_down; TEAL mode:
    elementwise) or, in prefill, `apply_sparsity`."""
    k = cfg.n_experts_per_tok
    top_idx, weights = route(y, lp["router"], k)          # [B, S, k]
    b, s, d = y.shape

    if s == 1 and b <= 8:
        y_in, inter_rule = y[:, 0], None
        if sp is not None and sp.enabled and (sp.kernel == "block"
                                              or sp.mode == "group"):
            gd = effective_block_size(sp.block_size, d)
            gi = effective_block_size(sp.block_size, cfg.intermediate_size)
            kf = sp.block_keep_fracs or (sp.block_keep_frac,) * 7
            thr = sp.block_thresholding
            y_in = sparsify_groups(y_in, gd, kf[4],
                                   threshold=th_gu if thr else None)

            def inter_rule(inter):
                return sparsify_groups(inter, gi, kf[6],
                                       threshold=th_down if thr else None)
        elif sp is not None and sp.enabled:
            y_in = sparsify(y_in, th_gu)

            def inter_rule(inter):
                return sparsify(inter, th_down)

        w8 = weights[:, 0].to(y.dtype)                      # [B, k]
        rows = []
        for bi in range(b):
            outs = []
            for t in range(k):
                e = top_idx[bi, 0, t:t + 1]
                (wg, sg), (wu, su), (wd, sd) = (
                    _wq(lp[n], e) for n in ("wgate", "wup", "wdown"))
                out = _expert_ffn(y_in[bi:bi + 1], wg, wu, wd, sg, su, sd,
                                  inter_rule=inter_rule)
                outs.append(out * w8[bi, t])
            # the products in y's type, summed in fp32 and rounded once
            rows.append(torch.stack(outs).float().sum(0).to(y.dtype))
        return torch.cat(rows)[:, None, :]

    # prefill: every expert, combined in fp32 by the routing weights; the
    # routing sees the dense y
    y_eff, inter_rule = y, None
    if sp is not None and sp.enabled:
        y_eff = apply_sparsity(y, th_gu, sp)

        def inter_rule(inter):
            return apply_sparsity(inter, th_down, sp)

    # combine[e]: expert e's weight at each position (0 where not routed)
    combine = torch.zeros((*top_idx.shape[:-1], cfg.n_experts),
                          dtype=torch.float32, device=y.device)
    combine.scatter_add_(-1, top_idx, weights)
    acc = torch.zeros((b, s, d), dtype=torch.float32, device=y.device)
    for e in range(cfg.n_experts):
        (wg, sg), (wu, su), (wd, sd) = (
            _wq(lp[n], e) for n in ("wgate", "wup", "wdown"))
        out = _expert_ffn(y_eff, wg, wu, wd, sg, su, sd,
                          inter_rule=inter_rule)
        acc += out.float() * combine[..., e:e + 1]
    return acc.to(y.dtype)
