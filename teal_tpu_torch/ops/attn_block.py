"""The attention stage of single-token decode: K1 then K2.

Port of `teal_tpu/ops/attn_block.py:attn_stage`, at group size 128 on the
token path (batch 1, or B <= 16 rows) and at the layer loop's group size
(32 at 7B) on its fused-attention route. The JAX package runs the stage
as one Pallas launch; here it is two kernels in order:
  1. K1 (`block_gemv.select_gather_gemv`): folded rms_norm (per row),
     group selection (one kept set for all rows, pooled scores), and the
     q|k|v gather into one fp32 [B, n_tot] tensor (with int8 weights, the
     per-channel scales applied to it in K1's epilogue, so that RoPE sees
     scaled values, as in the Pallas kernel);
  2. K2 (`decode_attention.decode_attention`): RoPE on q and the current
     k in fp32 at each row's own position, q scaled by 1/sqrt(128), the
     in-place cache write, and GQA attention; output in the cache type.
     K2 reads q, k and v as strided views of K1's output.
q/k/v stay fp32 between the two, as they do inside the Pallas kernel.
With `seq_block` the rows are consecutive positions of one sequence in
cache row 0 (the reference's `cache_rows=(0,)*B`).
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
               window: Optional[int] = None, G: int = 128, scales=None,
               fixed: bool = False, seq_block: bool = False):
    """h: [D] or rows [B, D] raw residual stream; wq/wk/wv: K1 operands
    of one plan; norm: [L, D] attention-norm gains; kc/vc: [L, B, Hkv, T,
    128] ([L, 1, ...] with seq_block; updated in place); pos: int32 [B];
    rope: [B, 2, 128] (cos, sin) rows at pos; G: K1's group size; scales:
    int8 only, the q/k/v per-channel scale stacks [L, N]; fixed: keep
    groups 0..cap-1; seq_block: see the module docstring.

    Returns (attn of h's leading shape + [n_heads * 128] in the cache
    type, kept-group count).
    """
    qkv, _, count = select_gather_gemv(h, thr, (wq, wk, wv), layer, cap,
                                       G=G, norm=norm, norm_eps=norm_eps,
                                       scales=scales, fixed=fixed)
    rows = qkv.view(-1, qkv.shape[-1])
    B, hkv = rows.shape[0], kc.shape[2]
    nq, nk = n_heads * HEAD_DIM, hkv * HEAD_DIM
    q = rows[:, :nq].view(B, n_heads, HEAD_DIM)
    k = rows[:, nq:nq + nk].view(B, hkv, HEAD_DIM)
    v = rows[:, nq + nk:].view(B, hkv, HEAD_DIM)
    attn = decode_attention(q, k, v, kc, vc, layer, pos, window=window,
                            rope=rope, seq_block=seq_block)
    return attn.view(*h.shape[:-1], nq), count
