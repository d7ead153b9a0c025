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

Weights are arrays of the stream type, int8 dicts {"q", "scale"} (all
seven, as the reference's kernel needs: K1 applies each stage's
per-channel scales to its fp32 sums before the epilogue, the reference's
`scale_ref`) or packed int4 dicts {"qp", "sz"} (unpacked in K1).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from teal_tpu_torch.ops.attn_block import attn_stage
from teal_tpu_torch.ops.block_gemv import _weight_kind, select_gather_gemv


def stage_operands(ws):
    """The seven weights as K1 operands: (operands, scales), scales being
    the seven int8 per-channel scale stacks, or None for arrays and
    packed int4. int8 needs all seven int8, as in the reference."""
    kinds = {_weight_kind(w) for w in ws}
    if "int8" in kinds:
        if kinds != {"int8"}:
            raise ValueError("the int8 token path needs all seven "
                             "projections int8")
        return tuple(w["q"] for w in ws), tuple(w["scale"] for w in ws)
    return tuple(ws), None


def layer_decode(h: torch.Tensor, layer: int, thresholds: torch.Tensor,
                 ws: Sequence[torch.Tensor], norm_attn: torch.Tensor,
                 norm_mlp: torch.Tensor, rope: torch.Tensor,
                 kc: torch.Tensor, vc: torch.Tensor, pos: torch.Tensor, *,
                 caps: Tuple[int, int, int, int], n_heads: int,
                 norm_eps: float = 1e-5, window: Optional[int] = None,
                 counts: Optional[List[torch.Tensor]] = None):
    """One transformer layer of `token_decode` (ws: the seven weights,
    see `token_decode`). Returns the new stream. With `counts`, appends
    this layer's kept-group counts (qkv, o, gate|up, down) as an int32
    [4] device tensor."""
    ops, sc = stage_operands(ws)
    wq, wk, wv, wo, wgate, wup, wdown = ops

    def scales(*i):
        return None if sc is None else tuple(sc[j] for j in i)

    attn, c0 = attn_stage(h, thresholds[layer, 0], wq, wk, wv, layer,
                          caps[0], norm_attn, norm_eps, kc, vc, pos, rope,
                          n_heads=n_heads, window=window,
                          scales=scales(0, 1, 2))
    h, _, c1 = select_gather_gemv(attn, thresholds[layer, 3], (wo,), layer,
                                  caps[1], res=h, scales=scales(3))
    inter, _, c2 = select_gather_gemv(h, thresholds[layer, 4], (wgate, wup),
                                      layer, caps[2], norm=norm_mlp,
                                      norm_eps=norm_eps, silu=True,
                                      scales=scales(4, 5))
    h, _, c3 = select_gather_gemv(inter, thresholds[layer, 6], (wdown,),
                                  layer, caps[3], res=h, scales=scales(6))
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
    ws:   (wq, wk, wv, wo, wgate, wup, wdown), each [L, K, N] of the
          stream type, all seven int8 {"q" [L, K, N], "scale" [L, N]}, or
          packed int4 {"qp" [L, K/2, N], "sz" [L, K/128, 2, N]}
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
