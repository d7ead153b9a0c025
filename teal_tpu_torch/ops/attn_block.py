"""The attention stage of single-token decode: K1 then K2.

Port of `teal_tpu/ops/attn_block.py:attn_stage` (batch 1), at group size
128 on the token path and at the layer loop's group size (32 at 7B) on
its fused-attention route. The JAX package runs the stage as one Pallas
launch; here it is two kernels in order:
  1. K1 (`block_gemv.select_gather_gemv`): folded rms_norm, group
     selection, and the q|k|v gather into one fp32 vector (with int8
     weights, the per-channel scales applied to it in K1's epilogue, so
     that RoPE sees scaled values, as in the Pallas kernel);
  2. K2 (`decode_attention.decode_attention`): RoPE on q and the current
     k in fp32, q scaled by 1/sqrt(128), the in-place cache write at
     `pos`, and GQA attention; output in the cache type.
q/k/v stay fp32 between the two, as they do inside the Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from teal_tpu_torch.ops.block_gemv import select_gather_gemv
from teal_tpu_torch.ops.decode_attention import HEAD_DIM, decode_attention


def attn_stage(h: torch.Tensor, thr: torch.Tensor, wq, wk, wv, layer: int,
               cap: int, norm: torch.Tensor, norm_eps: float,
               kc: torch.Tensor, vc: torch.Tensor, pos: torch.Tensor,
               rope: torch.Tensor, *, n_heads: int,
               window: Optional[int] = None, G: int = 128, scales=None):
    """h: [D] raw residual stream; wq/wk/wv: K1 operands of one plan;
    norm: [L, D] attention-norm gains; kc/vc: [L, 1, Hkv, T, 128]
    (updated in place); pos: int32 [1]; rope: [1, 2, 128] (cos, sin)
    rows at pos; G: K1's group size; scales: int8 only, the q/k/v
    per-channel scale stacks [L, N].

    Returns (attn [n_heads * 128] in the cache type, kept-group count).
    """
    qkv, _, count = select_gather_gemv(h, thr, (wq, wk, wv), layer, cap,
                                       G=G, norm=norm, norm_eps=norm_eps,
                                       scales=scales)
    hkv = kc.shape[2]
    nq, nk = n_heads * HEAD_DIM, hkv * HEAD_DIM
    q = qkv[:nq].view(1, n_heads, HEAD_DIM)
    k = qkv[nq:nq + nk].view(1, hkv, HEAD_DIM)
    v = qkv[nq + nk:].view(1, hkv, HEAD_DIM)
    attn = decode_attention(q, k, v, kc, vc, layer, pos, window=window,
                            rope=rope)
    return attn.view(nq), count
