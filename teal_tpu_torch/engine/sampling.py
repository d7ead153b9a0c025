"""Token sampling: temperature + top-k.

Port of `teal_tpu/engine/sampling.py`: logits scaled by
`max(temperature, 1e-5)`, optional top-k cutoff, categorical draw from an
explicit `torch.Generator`; temperature 0 is greedy argmax. The draw
(`draw`) reads nothing back to the host, so it runs inside a CUDA graph.
"""

from __future__ import annotations

from typing import Optional

import torch


def logits_to_probs(logits: torch.Tensor, temperature: float = 1.0,
                    top_k: Optional[int] = None) -> torch.Tensor:
    logits = logits / max(temperature, 1e-5)
    if top_k is not None:
        k = min(top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    return torch.softmax(logits, dim=-1)


def draw(probs: torch.Tensor,
         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One draw per row of probs [..., V] -> [..., 1] int64: the one-sample
    fast path of `torch.multinomial` (argmax of probs / q, q ~ Exp(1)
    from `generator`), the same tokens from the same generator state,
    without multinomial's host-side check of its input, which a CUDA
    graph cannot capture."""
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1, keepdim=True)


def sample(logits: torch.Tensor, temperature: float = 1.0,
           top_k: Optional[int] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits: [B, V] fp32 -> token ids [B] (int64, on logits' device)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = logits_to_probs(logits, temperature, top_k)
    return draw(probs, generator).squeeze(-1)
