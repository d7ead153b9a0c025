"""Magnitude thresholding of hidden states ("the" sparsity op).

Port of `teal_tpu/ops/sparsify.py`, same semantics:
  - keep rule: `|x| > t` (strict), output `x * keep`;
  - decode (seq == 1): always sparsified;
  - prefill (seq > 1): with `apply_prefill`, only the trailing
    `int(prefill_fraction * seq)` positions are sparsified; without it,
    prefill stays dense.
"""

from __future__ import annotations

import torch

from teal_tpu_torch.config import SparsityConfig


def sparsify(x: torch.Tensor, threshold) -> torch.Tensor:
    """`x * (|x| > threshold)`. threshold may be scalar or broadcastable."""
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def group_capacity(nb: int, keep_frac: float) -> int:
    """The one capacity formula: `max(1, min(nb, round(nb * keep)))`, with
    Python's round-half-to-even (nb=3 at keep 0.5 gives 2)."""
    return max(1, min(nb, int(round(nb * keep_frac))))


def sparsify_groups(x: torch.Tensor, group_size: int, keep_frac: float,
                    threshold=None) -> torch.Tensor:
    """Group-granular sparsification under THE unified selection rule:

      - threshold mode: keep groups whose max-|x| score is > threshold,
        scanned in ascending group order; the first `cap` survivors win;
      - top-k mode (`threshold=None`): keep every group scoring >= the
        cap-th largest score (so ties can keep more than `cap`, as in the
        reference).
    """
    *lead, d = x.shape
    nb = d // group_size
    if nb * group_size != d:
        raise ValueError(f"dim {d} not divisible by group {group_size}")
    k = group_capacity(nb, keep_frac)
    xg = x.reshape(*lead, nb, group_size)
    scores = xg.abs().amax(dim=-1)                       # [..., nb]
    if threshold is not None:
        surv = scores > threshold
        mask = surv & (torch.cumsum(surv.to(torch.int32), dim=-1) <= k)
    else:
        kth = torch.topk(scores, k, dim=-1).values[..., -1:]
        mask = scores >= kth
    return (xg * mask[..., None].to(x.dtype)).reshape(x.shape)


def apply_sparsity(x: torch.Tensor, threshold,
                   cfg: SparsityConfig) -> torch.Tensor:
    """Apply the sparsity rule with the prefill policy. x: [..., seq, dim].

    cfg.mode "teal" is elementwise |x| > t; "group" is the block kernel's
    group rule at the kernel's effective group size.
    """
    if not cfg.enabled:
        return x

    if cfg.mode == "group":
        from teal_tpu_torch.ops.block_gemv import effective_block_size

        G = effective_block_size(cfg.block_size, x.shape[-1])

        def rule(v):
            return sparsify_groups(
                v, G, cfg.block_keep_frac,
                threshold=threshold if cfg.block_thresholding else None,
            )
    else:
        def rule(v):
            return sparsify(v, threshold)

    seq = x.shape[-2]
    if seq > 1:
        if not cfg.apply_prefill:
            return x
        n_sparse = int(cfg.prefill_fraction * seq)
        if n_sparse == 0:
            return x
        head, tail = x[..., : seq - n_sparse, :], x[..., seq - n_sparse:, :]
        return torch.cat([head, rule(tail)], dim=-2)
    return rule(x)
