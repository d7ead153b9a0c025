"""Single-token decode of the whole layer stack (G = 128), for one row
or a batch of up to 16 rows.

Port of `teal_tpu/ops/token_block.py:token_decode`. The JAX package runs
every layer in one Pallas launch; here a host loop runs, per layer, five
kernel launches whatever the batch (160 a step at 7B):
  1. the attention stage (`attn_block.attn_stage`: K1 on q|k|v with the
     folded attention norm, then K2), threshold column 0;
  2. o + residual (K1), column 3;
  3. gate|up with the folded mlp norm and silu * mul (K1), column 4;
  4. down + residual (K1), column 6.
The residual stream stays in the stream type between stages; residual
adds and silu * mul happen on the fp32 sums inside K1, as in the
reference. Thresholds come from the `[L, 7]` table on the device, so the
loop never waits for the card.

Rows (`batch` > 1 in the reference): each row is a sequence at its own
position, with its own RoPE row and cache row; the rows share one kept
set per stage, picked by the group score pooled over the rows, and one
pass over the kept weights. `seq_block` makes the rows consecutive
positions of ONE sequence (cache row 0; row i attends to rows < i), the
verify path's form, with `fixed_sel` keeping groups 0..cap-1.

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
                 fixed_sel: bool = False, seq_block: bool = False,
                 counts: Optional[List[torch.Tensor]] = None):
    """One transformer layer of `token_decode` (h: [dim] or rows [B, dim];
    pos: int32 [B] on the device; the rest as in `token_decode`). Returns
    the new stream. With `counts`, appends this layer's kept-group counts
    (qkv, o, gate|up, down) as an int32 [4] device tensor."""
    ops, sc = stage_operands(ws)
    wq, wk, wv, wo, wgate, wup, wdown = ops

    def scales(*i):
        return None if sc is None else tuple(sc[j] for j in i)

    attn, c0 = attn_stage(h, thresholds[layer, 0], wq, wk, wv, layer,
                          caps[0], norm_attn, norm_eps, kc, vc, pos, rope,
                          n_heads=n_heads, window=window,
                          scales=scales(0, 1, 2), fixed=fixed_sel,
                          seq_block=seq_block)
    h, _, c1 = select_gather_gemv(attn, thresholds[layer, 3], (wo,), layer,
                                  caps[1], res=h, scales=scales(3),
                                  fixed=fixed_sel)
    inter, _, c2 = select_gather_gemv(h, thresholds[layer, 4], (wgate, wup),
                                      layer, caps[2], norm=norm_mlp,
                                      norm_eps=norm_eps, silu=True,
                                      scales=scales(4, 5), fixed=fixed_sel)
    h, _, c3 = select_gather_gemv(inter, thresholds[layer, 6], (wdown,),
                                  layer, caps[3], res=h, scales=scales(6),
                                  fixed=fixed_sel)
    if counts is not None:
        counts.append(torch.cat([c0, c1, c2, c3]))
    return h


def token_decode(h: torch.Tensor, thresholds: torch.Tensor,
                 ws: Sequence[torch.Tensor], norm_attn: torch.Tensor,
                 norm_mlp: torch.Tensor, rope: torch.Tensor,
                 kc: torch.Tensor, vc: torch.Tensor, pos, *,
                 caps: Tuple[int, int, int, int], n_heads: int,
                 norm_eps: float = 1e-5, window: Optional[int] = None,
                 fixed_sel: bool = False, seq_block: bool = False):
    """Decode one token per row through every layer.

    h:    [dim] raw residual stream (embedding of the token), or rows
          [B, dim] with B <= 16
    thresholds: [L, 7] fp32 per-layer group thresholds (config.PROJS order)
    ws:   (wq, wk, wv, wo, wgate, wup, wdown), each [L, K, N] of the
          stream type, all seven int8 {"q" [L, K, N], "scale" [L, N]}, or
          packed int4 {"qp" [L, K/2, N], "sz" [L, K/128, 2, N]}
    norm_attn/norm_mlp: [L, dim] rms_norm gains
    rope: [B, 2, 128] fp32 (cos, sin) rows at each row's position
    kc/vc: [L, B, Hkv, T, 128] caches of the stream type ([L, 1, ...]
          with seq_block), updated in place
    pos:  the token's position (an int, batch 1), or int32 [B] on the
          device (checked on the card by K2, which traps out of range)
    caps: gather capacities (qkv, o, gate|up, down)
    fixed_sel: keep groups 0..cap-1 at every stage (no scoring)
    seq_block: the rows are consecutive positions pos[0] + i of one
          sequence in cache row 0; row i attends to rows < i

    Returns the stream after the last layer, of h's shape.
    """
    if isinstance(pos, int):
        if not 0 <= pos < kc.shape[3]:
            raise ValueError(f"pos {pos} out of range [0, {kc.shape[3]})")
        pos = torch.full((1,), pos, dtype=torch.int32, device=h.device)
    if kc.dtype != h.dtype:
        raise ValueError(f"the token path needs the cache in the stream "
                         f"type {h.dtype}; got {kc.dtype}")
    for layer in range(kc.shape[0]):
        h = layer_decode(h, layer, thresholds, ws, norm_attn, norm_mlp, rope,
                         kc, vc, pos, caps=caps, n_heads=n_heads,
                         norm_eps=norm_eps, window=window,
                         fixed_sel=fixed_sel, seq_block=seq_block)
    return h
