"""Token sampling: temperature + top-k.

Port of `teal_tpu/engine/sampling.py`: logits scaled by
`max(temperature, 1e-5)`, optional top-k cutoff, categorical draw from an
explicit `torch.Generator`; temperature 0 is greedy argmax.
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


def sample(logits: torch.Tensor, temperature: float = 1.0,
           top_k: Optional[int] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits: [B, V] fp32 -> token ids [B] (int64, on logits' device)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = logits_to_probs(logits, temperature, top_k)
    return torch.multinomial(probs, 1, generator=generator).squeeze(-1)
