"""Single-token decode of the whole layer stack (batch 1, G = 128).

Port of `teal_tpu/ops/token_block.py:token_decode`. The JAX package runs
every layer in one Pallas launch; here a host loop runs, per layer, five
kernel launches (160 a token at 7B):
  1. the attention stage (`attn_block.attn_stage`: K1 on q|k|v with the
     folded attention norm, then K2), threshold column 0;
  2. o + residual (K1), column 3;
  3. gate|up with the folded mlp norm and silu * mul (K1), column 4;
  4. down + residual (K1), column 6.
The residual stream stays in the stream type between stages; residual
adds and silu * mul happen on the fp32 sums inside K1, as in the
reference. Thresholds come from the `[L, 7]` table on the device, so the
loop never waits for the card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from teal_tpu_torch.ops.attn_block import attn_stage
from teal_tpu_torch.ops.block_gemv import select_gather_gemv


def layer_decode(h: torch.Tensor, layer: int, thresholds: torch.Tensor,
                 ws: Sequence[torch.Tensor], norm_attn: torch.Tensor,
                 norm_mlp: torch.Tensor, rope: torch.Tensor,
                 kc: torch.Tensor, vc: torch.Tensor, pos: torch.Tensor, *,
                 caps: Tuple[int, int, int, int], n_heads: int,
                 norm_eps: float = 1e-5, window: Optional[int] = None,
                 counts: Optional[List[torch.Tensor]] = None):
    """One transformer layer of `token_decode`. Returns the new stream.
    With `counts`, appends this layer's kept-group counts (qkv, o,
    gate|up, down) as an int32 [4] device tensor."""
    wq, wk, wv, wo, wgate, wup, wdown = ws
    attn, c0 = attn_stage(h, thresholds[layer, 0], wq, wk, wv, layer,
                          caps[0], norm_attn, norm_eps, kc, vc, pos, rope,
                          n_heads=n_heads, window=window)
    h, _, c1 = select_gather_gemv(attn, thresholds[layer, 3], (wo,), layer,
                                  caps[1], res=h)
    inter, _, c2 = select_gather_gemv(h, thresholds[layer, 4], (wgate, wup),
                                      layer, caps[2], norm=norm_mlp,
                                      norm_eps=norm_eps, silu=True)
    h, _, c3 = select_gather_gemv(inter, thresholds[layer, 6], (wdown,),
                                  layer, caps[3], res=h)
    if counts is not None:
        counts.append(torch.cat([c0, c1, c2, c3]))
    return h


def token_decode(h: torch.Tensor, thresholds: torch.Tensor,
                 ws: Sequence[torch.Tensor], norm_attn: torch.Tensor,
                 norm_mlp: torch.Tensor, rope: torch.Tensor,
                 kc: torch.Tensor, vc: torch.Tensor, pos: int, *,
                 caps: Tuple[int, int, int, int], n_heads: int,
                 norm_eps: float = 1e-5, window: Optional[int] = None):
    """Decode one token through every layer.

    h:    [dim] raw residual stream (embedding of the token)
    thresholds: [L, 7] fp32 per-layer group thresholds (config.PROJS order)
    ws:   (wq, wk, wv, wo, wgate, wup, wdown), each [L, K, N]
    norm_attn/norm_mlp: [L, dim] rms_norm gains
    rope: [1, 2, 128] fp32 (cos, sin) rows at `pos`
    kc/vc: [L, 1, Hkv, T, 128] caches of the stream type, updated in place
    pos:  the token's position
    caps: gather capacities (qkv, o, gate|up, down)

    Returns the stream after the last layer, [dim].
    """
    if not 0 <= pos < kc.shape[3]:
        raise ValueError(f"pos {pos} out of range [0, {kc.shape[3]})")
    if kc.dtype != h.dtype:
        raise ValueError(f"the token path needs the cache in the stream "
                         f"type {h.dtype}; got {kc.dtype}")
    pos_t = torch.full((1,), pos, dtype=torch.int32, device=h.device)
    for layer in range(kc.shape[0]):
        h = layer_decode(h, layer, thresholds, ws, norm_attn, norm_mlp, rope,
                         kc, vc, pos_t, caps=caps, n_heads=n_heads,
                         norm_eps=norm_eps, window=window)
    return h
