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

Mixtral (the reference's MoE branch, `token_block.py:274-324`; batch 1,
arrays or int8): stages 3-4 become, per layer,
  3. K5 `moe_route` (`csrc/moe_route.cu`) on the stream: the mlp norm
     (`xn`, stream type), the top K_EXP experts as pseudo-layers l*E + e
     (int32) and their softmax weights (fp32), all left on the device;
  4. for each routed expert t: K1 gate|up on `xn` (no norm, column 4) and
     K1 down (column 6) with the weighted residual h = (w_t * sums + h)
     rounded to the stream type, both reading pseudo-layer t of K5's
     output on the device from the expert stacks read as [L*E, K, N]
     (int8 scales as [L*E, N]): no host sync between K5 and the experts.
Launches a layer: 2 (attention) + 1 (o) + 1 (K5) + 2 * K_EXP; 256 a token
at Mixtral's 32 layers. Two quirks of the reference are kept: thresholds
are read at the real layer (calibration leaves the MoE down column 6 at
0, so the down stage keeps its first `cap` groups by index), and each
expert is added to the stream in fp32 with the fp32 routing weight (the
layer loop's twin, `models/moe.moe_ffn`, combines the experts in the
stream type with weights rounded to it).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from teal_tpu_torch import _build
from teal_tpu_torch.ops.attn_block import attn_stage
from teal_tpu_torch.ops.block_gemv import (_DTYPE_CODE, _check_launch_device,
                                           _weight_kind, select_gather_gemv,
                                           selection_input)

MAX_EXPERTS = 64                 # K5: two experts a lane of one warp
MAX_ROUTED = 8                   # routed experts a token

# K5's launch plan on the card (`csrc/moe_route.cu`, `RouteLayout` and
# `route_plan`, which `_route_smem` and `_route_plan` mirror; the card
# tests hold them together through `teal_moe_route_plan`)
_ROUTE_THREADS = 256
_ROUTE_MAX_CLUSTER = 8           # blocks a cluster (the portable size)
_ROUTE_MIN_ROWS = 64             # rows a block at least, where D allows
_ROUTE_MAX_ROWS = 4 * _ROUTE_THREADS   # rows a block at most (registers)
_SMEM_BYTES = 232448             # a block's shared memory on Hopper


def _route_smem(rows: int, E: int) -> int:
    """K5's shared memory a block in bytes: its router slab (rows * E
    fp32, +3 floats that keep the slab's offset within 16 bytes, padded
    to 4), xn as fp32 [rows], the threads' partial logits [256], the
    peers' partial logits [8][E] and 32 floats of scratch."""
    return 4 * (-(-(rows * E + 3) // 4) * 4 + rows + _ROUTE_THREADS
                + _ROUTE_MAX_CLUSTER * E + 32)


def _route_plan(D: int, E: int) -> Optional[Tuple[int, int, int]]:
    """K5's launch plan from D and E only: (C, rows, shared bytes), or
    None where none fits (more than 1024 rows a block, or a router slab
    past shared memory). One cluster of C blocks (the largest power of
    two <= 8 leaving each block 64 rows, at least 1); block s takes rows
    `gather_gemv.split_range(D, C, s)` of x, the gain and the router, at
    most `rows` = ceil(D / C) of them."""
    if D < 1 or not 1 <= E <= MAX_EXPERTS:
        return None
    C = _ROUTE_MAX_CLUSTER
    while C > 1 and D < C * _ROUTE_MIN_ROWS:
        C //= 2
    rows = -(-D // C)
    smem = _route_smem(rows, E)
    if rows > _ROUTE_MAX_ROWS or smem > _SMEM_BYTES:
        return None
    return C, rows, smem


def moe_route_plain(x: torch.Tensor, norm: torch.Tensor,
                    router: torch.Tensor, layer: int, k_exp: int,
                    norm_eps: float = 1e-5):
    """K5 in plain PyTorch (same arguments and results as `moe_route`):
    the folded norm of `block_gemv.selection_input`, one dot product per
    expert (equal router columns give equal logits), top-k by repeated
    argmax (the first maximum wins: the lowest index among ties, as
    `jax.lax.top_k`), then the softmax anchored at the largest logit and
    summed in t order."""
    xn = selection_input(x, norm, layer, norm_eps)
    xf = xn.float()
    E = router.shape[-1]
    logits = torch.stack([torch.dot(xf, router[layer, :, e])
                          for e in range(E)])
    iota = torch.arange(E, device=x.device)
    taken = torch.zeros(E, dtype=torch.bool, device=x.device)
    idx = []
    for _ in range(k_exp):
        i = torch.argmax(logits.masked_fill(taken, float("-inf")))
        taken = taken | (iota == i)
        idx.append(i)
    idx = torch.stack(idx)
    ex = torch.exp(logits[idx] - logits[idx[0]])
    den = ex[0]
    for t in range(1, k_exp):
        den = den + ex[t]
    return xn, (layer * E + idx).to(torch.int32), ex / den


def _check_route(x, norm, router, layer, k_exp):
    if (x.dtype not in _DTYPE_CODE or x.dim() != 1
            or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous fp32/bf16 vector [D]; got "
                         f"{x.dtype} {tuple(x.shape)}")
    D = x.shape[0]
    if (router.dim() != 3 or router.shape[1] != D
            or router.dtype != torch.float32 or not router.is_contiguous()
            or router.device != x.device):
        raise ValueError(f"router must be a contiguous fp32 [L, {D}, E] "
                         f"stack on x's device; got {router.dtype} "
                         f"{tuple(router.shape)}")
    L, _, E = router.shape
    if (norm.shape != (L, D) or norm.dtype != x.dtype
            or norm.device != x.device or not norm.is_contiguous()):
        raise ValueError(f"norm must be a contiguous [L, D] stack of x's "
                         f"type; got {norm.dtype} {tuple(norm.shape)}")
    if not (1 <= E <= MAX_EXPERTS and 1 <= k_exp <= min(E, MAX_ROUTED)):
        raise ValueError(f"{k_exp} routed of {E} experts: K5 takes at most "
                         f"{MAX_EXPERTS} experts and {MAX_ROUTED} routed")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")


def moe_route(x: torch.Tensor, norm: torch.Tensor, router: torch.Tensor,
              layer: int, k_exp: int, norm_eps: float = 1e-5):
    """K5: Mixtral routing of one decode row at layer `layer`.

    x:      [D] raw residual stream (fp32 or bf16)
    norm:   [L, D] mlp rms_norm gains of x's type
    router: [L, D, E] fp32 router weights
    k_exp:  routed experts (<= 8, <= E)

    Returns (xn [D] the folded norm in x's type, pseudo-layers int32
    [k_exp] layer * E + e_t, routing weights fp32 [k_exp]), all on x's
    device, the experts in descending logit order (the lowest index
    first among equal logits)."""
    _check_route(x, norm, router, layer, k_exp)
    if x.device.type == "cpu":
        return moe_route_plain(x, norm, router, layer, k_exp, norm_eps)
    _check_launch_device(x, "moe_route")
    D, E = x.shape[0], router.shape[2]
    if _route_plan(D, E) is None:
        raise ValueError(f"K5 has no launch plan for D = {D}, E = {E}: "
                         f"more than {_ROUTE_MAX_ROWS} rows a block, or a "
                         f"block's router slab past shared memory")
    lib = _build.load()["moe_route"]
    xn = torch.empty_like(x)
    eidx = torch.empty(k_exp, dtype=torch.int32, device=x.device)
    w = torch.empty(k_exp, dtype=torch.float32, device=x.device)
    err = lib.teal_moe_route(
        _DTYPE_CODE[x.dtype], x.data_ptr(), norm.data_ptr(), norm_eps,
        router.data_ptr(), xn.data_ptr(), eidx.data_ptr(), w.data_ptr(),
        D, E, k_exp, layer, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "moe_route")
    moe_route.launches += 1
    return xn, eidx, w


moe_route.launches = 0


def expert_stacks(w):
    """An expert stack [L, E, K, N] (int8: {"q" [L, E, K, N], "scale"
    [L, E, N]}) as the pseudo-layer stack [L*E, K, N] K1 reads: views, no
    copy."""
    if isinstance(w, dict):
        return {k: v.flatten(0, 1) for k, v in w.items()}
    return w.flatten(0, 1)


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
                 counts: Optional[List[torch.Tensor]] = None,
                 router: Optional[torch.Tensor] = None, k_exp: int = 0,
                 routes: Optional[List[torch.Tensor]] = None):
    """One transformer layer of `token_decode` (h: [dim] or rows [B, dim];
    pos: int32 [B] on the device; with `router`, the MoE layer, ws holding
    the expert stacks as [L*E, K, N] (`expert_stacks`); the rest as in
    `token_decode`). Returns the new stream. With `counts`, appends this
    layer's kept-group counts as an int32 device tensor: (qkv, o, gate|up,
    down), or with `router` (qkv, o, then gate|up and down of each routed
    expert); with `routes`, this layer's routed pseudo-layers (K5's int32
    [k_exp])."""
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
    if router is not None:
        xn, eidx, route_w = moe_route(h, norm_mlp, router, layer, k_exp,
                                      norm_eps)
        if routes is not None:
            routes.append(eidx)
        cs = []
        for t in range(k_exp):
            inter, _, c2 = select_gather_gemv(
                xn, thresholds[layer, 4], (wgate, wup), eidx, caps[2],
                slot=t, silu=True, scales=scales(4, 5), fixed=fixed_sel)
            h, _, c3 = select_gather_gemv(
                inter, thresholds[layer, 6], (wdown,), eidx, caps[3],
                slot=t, res=h, route_w=route_w, scales=scales(6),
                fixed=fixed_sel)
            cs += [c2, c3]
    else:
        inter, _, c2 = select_gather_gemv(h, thresholds[layer, 4],
                                          (wgate, wup), layer, caps[2],
                                          norm=norm_mlp, norm_eps=norm_eps,
                                          silu=True, scales=scales(4, 5),
                                          fixed=fixed_sel)
        h, _, c3 = select_gather_gemv(inter, thresholds[layer, 6], (wdown,),
                                      layer, caps[3], res=h,
                                      scales=scales(6), fixed=fixed_sel)
        cs = [c2, c3]
    if counts is not None:
        counts.append(torch.cat([c0, c1, *cs]))
    return h


def token_decode(h: torch.Tensor, thresholds: torch.Tensor,
                 ws: Sequence[torch.Tensor], norm_attn: torch.Tensor,
                 norm_mlp: torch.Tensor, rope: torch.Tensor,
                 kc: torch.Tensor, vc: torch.Tensor, pos, *,
                 caps: Tuple[int, int, int, int], n_heads: int,
                 norm_eps: float = 1e-5, window: Optional[int] = None,
                 fixed_sel: bool = False, seq_block: bool = False,
                 router: Optional[torch.Tensor] = None,
                 n_experts_per_tok: int = 0):
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
    router: Mixtral, one row: [L, dim, E] fp32 router weights; ws[4:7]
          are then the expert stacks [L, E, K, N] (int8: {"q" [L, E, K,
          N], "scale" [L, E, N]}), `n_experts_per_tok` of which run a
          layer (see the module docstring)

    Returns the stream after the last layer, of h's shape.
    """
    if router is not None:
        if h.dim() != 1 or seq_block:
            raise ValueError("the MoE token path decodes one row")
        ws = (*ws[:4], *(expert_stacks(w) for w in ws[4:]))
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
                         fixed_sel=fixed_sel, seq_block=seq_block,
                         router=router, k_exp=n_experts_per_tok)
    return h
