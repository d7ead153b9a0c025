"""Single-token decode of the whole layer stack (G = 128), for one row
or a batch of up to 16 rows.

Port of `teal_tpu/ops/token_block.py:token_decode`. The JAX package runs
every layer in one Pallas launch (`_token_kernel`), or with `token_fused`
False in the 4-launch packed pipeline (`models/llama.py:_packed_layer`).
Here two routes, decided by the call's form and shapes before any
launch:
  - K7 `token_kernel` (`csrc/token_decode.cuh`, built by `token_decode.cu`
    for the arrays and `token_decode_quant.cu` for int8 and int4; the rows
    form `csrc/token_decode_rows.cuh`, built by `token_decode_rows.cu` and
    `token_decode_rows_quant.cu`): one persistent launch a step through
    every layer, for one row (batch 1) or 2-16 rows (the server's step, or
    with `seq_block` a verify chunk), with weights that are arrays of the
    stream type (the cache of that type), or with a bf16 stream and cache
    all seven int8 dicts or all seven packed int4 dicts at quant group
    128; Mixtral at one row with arrays or int8 experts, its routing
    inside (below); head_dim 128 and Hq / Hkv <= 8, where `token_fused`
    is not False and K7 has a launch plan for the shapes (`k7_plan`). Its
    plain version, `token_kernel_plain`, runs each stage through K1's,
    K2's and K5's plain versions (on CPU tensors the wrapper runs it);
  - the layer loop below, every other form, a shape K7 cannot plan and
    `token_fused=False`: a host loop runs, per layer, four kernel
    launches at one row of arrays or packed int4 (128 a step at 7B, as the
    reference's packed pipeline), five with int8 and for rows (160):
  1. the attention stage (`attn_block.attn_stage`: one K8 launch at one
     row of arrays or int4; else K1 on q|k|v with the folded attention
     norm, then K2), threshold column 0;
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
arrays or int8). K7 takes it in one launch a token: after o, every
cluster folds the mlp norm into xn and routes (each block dots its share
of the router rows, the cluster's partial logits added in rank order, so
that every block of the grid picks the same experts with no barrier of
its own), then runs gate|up and down of each routed expert in order,
each stage followed by a grid barrier: 2 + 2 K_EXP grid barriers a layer
head-owned, 3 + 2 K_EXP in the other plan (Mixtral's: 7). With
`token_fused=False`, or a shape K7 cannot plan, the layer loop runs it
(the form K7's plain version composes), its stages 3-4 becoming, per
layer,
  3. K5 `moe_route` (`csrc/moe_route.cu`) on the stream: the mlp norm
     (`xn`, stream type), the top K_EXP experts as pseudo-layers l*E + e
     (int32) and their softmax weights (fp32), all left on the device;
  4. for each routed expert t: K1 gate|up on `xn` (no norm, column 4) and
     K1 down (column 6) with the weighted residual h = (w_t * sums + h)
     rounded to the stream type, both reading pseudo-layer t of K5's
     output on the device from the expert stacks read as [L*E, K, N]
     (int8 scales as [L*E, N]): no host sync between K5 and the experts.
Launches a layer: the attention stage (K8 with arrays; K1 + K2 with
int8) + 1 (o) + 1 (K5) + 2 * K_EXP: 224 a token at Mixtral's 32 layers
with arrays, 256 with int8. Both routes keep two quirks of the reference:
thresholds are read at the real layer (calibration leaves the MoE down
column 6 at 0, so the down stage keeps its first `cap` groups by index),
and each expert is added to the stream in fp32 with the fp32 routing
weight, the product rounded before the sum (the
layer loop's twin, `models/moe.moe_ffn`, combines the experts in the
stream type with weights rounded to it).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from teal_tpu_torch import _build
from teal_tpu_torch.ops.attn_block import attn_stage
from teal_tpu_torch.ops.block_gemv import (_DTYPE_CODE, _H100_SMS,
                                           PLAN_INT4, PLAN_INT8, PLAN_STREAM,
                                           _check_launch_device,
                                           _weight_kind, select_gather_gemv,
                                           select_gather_gemv_plain,
                                           selection_input)
from teal_tpu_torch.ops.decode_attention import (HEAD_DIM, MAX_GROUP,
                                                 decode_attention_plain)

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
                 n_experts_per_tok: int = 0,
                 token_fused: Optional[bool] = None):
    """Decode one token per row through every layer: K7 (`token_kernel`)
    where `token_fused` is not False and the call is of K7's form
    (`k7_form`), else the layer loop (module docstring).

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
    token_fused: False keeps the layer loop (the reference's packed
          pipeline); otherwise K7 takes the forms it covers where it has a
          launch plan for the shapes

    Returns the stream after the last layer, of h's shape.
    """
    if isinstance(pos, int):
        if not 0 <= pos < kc.shape[3]:
            raise ValueError(f"pos {pos} out of range [0, {kc.shape[3]})")
        pos = torch.full((1,), pos, dtype=torch.int32, device=h.device)
    if k7_route(h, ws, kc, n_heads, caps, window, router, seq_block,
                token_fused, n_experts_per_tok):
        return token_kernel(h, thresholds, ws, norm_attn, norm_mlp, rope,
                            kc, vc, pos, caps=caps, n_heads=n_heads,
                            norm_eps=norm_eps, window=window,
                            fixed_sel=fixed_sel, seq_block=seq_block,
                            router=router,
                            n_experts_per_tok=n_experts_per_tok)
    if router is not None:
        if h.dim() != 1 or seq_block:
            raise ValueError("the MoE token path decodes one row")
        ws = (*ws[:4], *(expert_stacks(w) for w in ws[4:]))
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


# --- K7: the whole token in one launch --------------------------------------

# K7's launch plan on the card (`csrc/token_decode.cu`: `token_plan`,
# `Layout` and `WsLayout`, which `_token_plan`, `_token_smem` and
# `_token_ws` mirror; the card tests hold them together through
# `teal_token_plan`)
_TOK_THREADS = 288               # 8 worker warps + the TMA producer warp
_TOK_WORKERS = 256
_TOK_UB = 256                    # bytes of an array's slab row in a TMA
                                 # box: a unit of a stage's columns
_TOK_QUB = 128                   # the same for int8 and packed int4
_TOK_BOX = 8192                  # bytes of a TMA box (every weight plan)
_TOK_SZB = 2 * HEAD_DIM * 4      # int4: a group's [scale, zero] rows of a
                                 # unit's 128 columns
_TOK_MAX_SLOTS = 8
_TOK_MAXCH = 8                   # 16-byte chunks of h a thread at most
_TOK_MIN_C, _TOK_MAX_C = 2, 8    # blocks a cluster (the portable sizes)
_TOK_BARRIER_SLOTS = 5           # q|k|v (other plan), attention, o,
                                 # gate|up, down
_TOK_TRACE_ROWS = _TOK_BARRIER_SLOTS + 4    # a block's trace: barrier
                                 # arrivals, then its gathers' ends
_TOK_MISC = 128                  # floats of scratch (block reductions)
MAX_ROWS = 16                    # K7's rows form: 2..16 rows (the MMA's M)
_ROWS_UB = 128                   # bytes of a rows-form box row: a unit

# Resident clusters of C blocks of K7 (one block an SM) on an NVIDIA H100
# 80GB HBM3 (132 SMs), from `cudaOccupancyMaxActiveClusters`
# (`tools/k7_cluster_probe.py`): the table the CPU tests plan with. On the
# card the wrapper asks the CUDA runtime (`teal_token_clusters`).
H100_CLUSTERS = {2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


class TokenPlan(NamedTuple):
    grid: int                    # blocks (one an SM): clusters * C
    threads: int
    smem: int                    # shared bytes a block uses
    ws_bytes: int                # workspace bytes
    grid_barriers: int           # a token
    head_barriers: int           # a token, among a kv head's blocks (0)
    C: int                       # blocks a cluster
    clusters: int
    head_owned: bool             # a cluster a kv head: q|k|v + attention
    slots: int                   # ring slots (`_tok_slot` bytes; rows:
                                 # two boxes and their staged input rows)
    NS: int                      # attention: the scores a query row
                                 # keeps (`_tok_scores`); rows: the rows
                                 # of a warp's chunk (`_rows_chunk`)


def _al(n: int, a: int) -> int:
    return -(-n // a) * a


def _tok_unit(esz: int, plan: int = PLAN_STREAM) -> int:
    """Columns of a K7 unit (a TMA box's slab row): 256 bytes of arrays
    (128 bf16 or 64 fp32 columns), 128 bytes (columns) of int8 or packed
    int4."""
    return _TOK_UB // esz if plan == PLAN_STREAM else _TOK_QUB


def _tok_slot(plan: int = PLAN_STREAM) -> int:
    """Bytes of a K7 ring slot: two boxes, and for int4 two groups' scale
    and zero rows."""
    return 2 * _TOK_BOX + (2 * _TOK_SZB if plan == PLAN_INT4 else 0)


_TOK_SCORES = 2048               # attention scores a block keeps


def _tok_scores(GH: int) -> int:
    """Scores a query row of K7's attention keeps in shared memory (a
    block's share of up to 2048 live rows at one query row a kv head, 256
    at eight; a longer share is scored again chunk by chunk), whatever
    T."""
    return _TOK_SCORES // GH


def _rows_chunk(esz: int, GH: int) -> int:
    """Cache rows of a warp's attention chunk in the rows form: 2 bf16 rows
    a pass (1 fp32), 8 passes in flight (fewer for 4 and 8 query heads a
    kv head, whose sums take registers)."""
    return 32 // (HEAD_DIM * esz // 16) * (8 if GH <= 2 else 16 // GH)


def _token_smem(esz: int, D: int, I: int, GH: int, capmax: int, NS: int,
                partf: int, slots: int, plan: int = PLAN_STREAM,
                E: int = 0) -> int:
    """K7's shared memory a block in bytes: the ring (attention's row-lane
    PV sums), its full and empty mbarriers, the block's partial sums
    (`partf` fp32, read by the cluster's peers), the warps' sums of a
    unit, the stream h [D] and a stage's selection input [max(D, I)] of
    the stream type, the group scores, the kept groups and count, (int4)
    each kept group's sum [capmax] fp32, 128 floats of scratch,
    attention's q|k|v sums and RoPE'd q|k (fp32), q rounded, four [8]
    fp32, the block's maxima and partial PV with its denominators (fp32,
    read by the peers) and the kept scores [GH][NS]; with E experts (MoE)
    the folded stream xn [D] of the stream type, the block's partial
    router logits [E] and the routed pseudo-layers and weights
    [MAX_ROUTED] each."""
    n = slots * _tok_slot(plan) + 2 * _TOK_MAX_SLOTS * 8 + partf * 4
    n += 8 * 2 * _tok_unit(esz, plan) * 4
    n += _al(D * esz, 16) + _al(max(D, I) * esz, 16)
    n += (_al(max(D, I) // HEAD_DIM, 4) * 4 + _al(capmax + 1, 4) * 4
          + _TOK_MISC * 4)
    n += _al(capmax, 4) * 4 if plan == PLAN_INT4 else 0
    n += (GH + 2) * HEAD_DIM * 4 + (GH + 1) * HEAD_DIM * 4
    n += _al(GH * HEAD_DIM * esz, 16) + 4 * MAX_GROUP * 4 + MAX_GROUP * 4
    n += (GH * HEAD_DIM + MAX_GROUP) * 4 + GH * NS * 4
    if E:
        n += _al(D * esz, 16) + (_al(E, 4) + 2 * MAX_ROUTED) * 4
    return n


def _rows_unit(esz: int, plan: int = PLAN_STREAM) -> int:
    """Columns of a unit of K7's rows form (a box row of 128 bytes): 64
    bf16 or 32 fp32 columns of arrays, 128 of int8 or packed int4."""
    return _ROWS_UB // esz if plan == PLAN_STREAM else _TOK_QUB


def _rows_slot(esz: int, plan: int = PLAN_STREAM) -> int:
    """Bytes of a rows-form ring slot: two boxes (64 rows x 128 bytes; for
    int4 also two groups' scale and zero rows) and 16 staged input rows of
    a group (128 of the stream type, +16 bytes)."""
    return _tok_slot(plan) + MAX_ROWS * (HEAD_DIM * esz + 16)


def _token_smem_rows(esz: int, D: int, I: int, capmax: int, partf: int,
                     slots: int, plan: int = PLAN_STREAM) -> int:
    """Shared memory a block of K7's rows form in bytes
    (`token_decode_rows.cuh`'s RowsLayout): the ring (`_rows_slot` a
    slot), its full and empty mbarriers, the block's partial sums (`partf`
    fp32: B rows), the warps' sums of a unit [8][16][unit] fp32, the
    peers' sums of squares [8][16] and the row scales [16] fp32, the group
    scores, the kept groups and count, 128 floats of scratch."""
    n = slots * _rows_slot(esz, plan) + 2 * _TOK_MAX_SLOTS * 8 + partf * 4
    n += 8 * MAX_ROWS * _rows_unit(esz, plan) * 4 + 8 * MAX_ROWS * 4
    n += MAX_ROWS * 4 + _al(max(D, I) // HEAD_DIM, 4) * 4
    return n + _al(capmax + 1, 4) * 4 + _TOK_MISC * 4


def _token_ws(esz: int, D: int, I: int, Hq: int, Hkv: int,
              rows: int = 1) -> int:
    """K7's workspace in bytes (256-byte aligned regions): the grid
    barrier's counter (a 128-byte line), the q|k|v sums [rows][(Hq + 2
    Hkv) * 128] fp32 (the other plan's, and every rows plan's), two
    stream buffers [rows][D] (so that a stage that keeps no group can skip
    its barrier), the attention output [rows][Hq * 128] and the
    intermediate [rows][I] of the stream type."""
    n = _al(256 + rows * (Hq + 2 * Hkv) * HEAD_DIM * 4, 256)
    for part in (D * esz, D * esz, Hq * HEAD_DIM * esz):
        n = _al(n + rows * part, 256)
    return _al(n + rows * I * esz, 256)


def _token_structure(Hkv: int, n_sms: int, clusters) -> Optional[Tuple[int,
                                                                      bool]]:
    """(C, head-owned) from the resident clusters of each size C <= 8: the
    head-owned plan (Hkv clusters, one a kv head) with the largest C of
    which Hkv clusters fit, where they hold at least half the SMs; else
    the other plan with the largest C whose grid is within 1/16 of the
    largest grid. None where no cluster fits."""
    nc = {c: clusters.get(c, 0) for c in range(_TOK_MIN_C, _TOK_MAX_C + 1)}
    best = max(c * nc[c] for c in nc)
    ch = max((c for c in nc if nc[c] >= Hkv), default=0)
    if ch and 2 * ch * Hkv >= n_sms:
        return ch, True
    co = next((c for c in range(_TOK_MAX_C, _TOK_MIN_C - 1, -1)
               if best > 0 and 16 * c * nc[c] >= 15 * best), 0)
    return (co, False) if co else None


def _k7_moe_ok(plan: int, rows: int, E: int, k_exp: int) -> bool:
    """Whether K7 takes E experts with k_exp routed a token (E = 0: a
    dense MLP, k_exp 0): one row, arrays or int8 (int4 MoE is not wired,
    as in the reference), E a divisor of the 256 worker threads up to
    MAX_EXPERTS (a worker's router elements fall in one column), 1 <=
    k_exp <= min(E, MAX_ROUTED)."""
    if E == 0:
        return k_exp == 0
    return (rows == 1 and plan != PLAN_INT4 and 1 <= E <= MAX_EXPERTS
            and _TOK_WORKERS % E == 0 and 1 <= k_exp <= min(E, MAX_ROUTED))


def _token_plan(esz: int, D: int, I: int, Hq: int, Hkv: int, T: int,
                window: Optional[int], capmax: int, L: int,
                n_sms: int = _H100_SMS, clusters=None,
                plan: int = PLAN_STREAM, rows: int = 1, E: int = 0,
                k_exp: int = 0) -> Optional[TokenPlan]:
    """K7's launch plan from shapes, the weight plan (`block_gemv`'s
    PLAN_*; int8 and int4 with a bf16 stream, esz 2), the rows (1, or
    2..16 for the rows form, in every weight plan; its seq_block form
    plans as its rows do) and the card's resident
    clusters of each size (`clusters`: {C: clusters}, default
    `H100_CLUSTERS`), or None where they take none (among them, at one
    row, a stream of more than 36 KB: a thread holds at most `_TOK_MAXCH`
    16-byte chunks of it). The grid is clusters * C blocks
    (`_token_structure` picks C and the structure: Hkv clusters
    head-owned, else as many as fit); attention walks the cache in
    chunks and keeps a fixed number of scores (NS a query row,
    `_tok_scores`; rows: a warp's chunk of `_rows_chunk` rows), so no plan
    depends on T or the window; the ring takes what shared memory the
    rest leaves, up to 8 slots, at least 2 (one row: and at least
    attention's PV sums). Grid barriers a layer: 4 head-owned, 5 in the
    other plan; none among a kv head's blocks. MoE (E experts, k_exp
    routed, `_k7_moe_ok`): the same structure and workspace, shared
    memory for xn and the routing, and gate|up and down once for each
    routed expert: 2 + 2 k_exp grid barriers a layer head-owned, 3 + 2
    k_exp in the other plan."""
    if (not _k7_moe_ok(plan, rows, E, k_exp)
            or (plan != PLAN_STREAM and esz != 2)
            or plan not in (PLAN_STREAM, PLAN_INT8, PLAN_INT4)
            or not (rows == 1 or 2 <= rows <= MAX_ROWS)
            or D <= 0 or I <= 0 or D % HEAD_DIM or I % HEAD_DIM or Hkv <= 0
            or Hq != D // HEAD_DIM or Hq % Hkv or MAX_GROUP % (Hq // Hkv)
            or T < 1 or L < 1
            or not 1 <= capmax <= max(D, I) // HEAD_DIM
            or (rows == 1 and D * esz > 16 * _TOK_MAXCH * _TOK_THREADS)):
        return None
    st = _token_structure(Hkv, n_sms, H100_CLUSTERS if clusters is None
                          else clusters)
    if st is None:
        return None
    C, head = st
    NC = Hkv if head else (H100_CLUSTERS if clusters is None
                           else clusters)[C]
    GH = Hq // Hkv
    uw = _rows_unit(esz, plan) if rows > 1 else _tok_unit(esz, plan)

    def most(cols, nw):
        return nw * -(-(cols // uw) // NC) * uw
    partf = rows * max(most(D, 1), most(I, 2),
                       (GH + 2) * HEAD_DIM if head
                       else most((Hq + 2 * Hkv) * HEAD_DIM, 1))
    if rows > 1:
        NS, slot = _rows_chunk(esz, GH), _rows_slot(esz, plan)

        def smem(n):
            return _token_smem_rows(esz, D, I, capmax, partf, n, plan)
    else:
        NS, slot = _tok_scores(GH), _tok_slot(plan)

        def smem(n):
            return _token_smem(esz, D, I, GH, capmax, NS, partf, n, plan, E)
    slots = min(_TOK_MAX_SLOTS, (_SMEM_BYTES - smem(0)) // slot)
    rpi = _TOK_WORKERS // (HEAD_DIM * esz // 16)
    if slots < 2 or (rows == 1 and slots * slot < rpi * GH * HEAD_DIM * 4):
        return None
    return TokenPlan(NC * C, _TOK_THREADS, smem(slots),
                     _token_ws(esz, D, I, Hq, Hkv, rows),
                     ((2 if head else 3) + 2 * max(k_exp, 1)) * L, 0, C, NC,
                     head, slots, NS)


def _split_lo(count: int, S: int, s: int) -> int:
    return count * s // S


def token_columns(plan: TokenPlan, esz: int, D: int, I: int, Hq: int,
                  Hkv: int, wplan: int = PLAN_STREAM, rows: int = 1):
    """Each cluster's output columns of each gather stage under `plan`
    (weight plan `wplan`; `rows` > 1: the rows form), as the kernel cuts
    them: {stage: [[(weight, first, end), ...] a cluster]} over the
    weights wq, wk, wv, wo, wgate, wup, wdown; a cluster owns a contiguous
    range of the stage's units (`_tok_unit` columns; the rows form's:
    `_rows_unit`; as even as they allow); in the head-owned plan
    cluster c < Hkv owns q|k|v of kv head c (its Hq / Hkv query heads' q
    columns, its k and v columns) and the other clusters none. Also
    {"attention": [kv heads a cluster]}."""
    uw = _rows_unit(esz, wplan) if rows > 1 else _tok_unit(esz, wplan)
    GH, kvw = Hq // Hkv, Hkv * HEAD_DIM

    def cut(pieces):
        cols = sum(n for _, _, n in pieces)
        out = []
        for c in range(plan.clusters):
            u0 = _split_lo(cols // uw, plan.clusters, c)
            u1 = _split_lo(cols // uw, plan.clusters, c + 1)
            got, off = [], 0
            for name, c0, n in pieces:
                a, b = max(u0 * uw, off), min(u1 * uw, off + n)
                if a < b:
                    got.append((name, c0 + a - off, c0 + b - off))
                off += n
            out.append(got)
        return out
    if plan.head_owned:
        qkv = [[("wq", c * GH * HEAD_DIM, (c + 1) * GH * HEAD_DIM),
                ("wk", c * HEAD_DIM, (c + 1) * HEAD_DIM),
                ("wv", c * HEAD_DIM, (c + 1) * HEAD_DIM)] if c < Hkv else []
               for c in range(plan.clusters)]
    else:
        qkv = cut([("wq", 0, D), ("wk", 0, kvw), ("wv", 0, kvw)])
    gu = [[(w, a, b) for _, a, b in got for w in ("wgate", "wup")]
          for got in cut([("wgate", 0, I)])]
    return {"qkv": qkv, "o": cut([("wo", 0, D)]), "gate|up": gu,
            "down": cut([("wdown", 0, D)]),
            "attention": [list(range(c, Hkv, plan.clusters))
                          for c in range(plan.clusters)]}


def k7_weight_plan(ws) -> Optional[int]:
    """K7's weight plan of seven projections, from their form alone:
    PLAN_STREAM (seven arrays), PLAN_INT8 (seven {"q", "scale"} dicts) or
    PLAN_INT4 (seven {"qp", "sz"} dicts at quant group 128); None for
    any other set (a mix, unpacked int4, int4 at another group)."""
    if len(ws) != 7:
        return None
    if all(isinstance(w, torch.Tensor) for w in ws):
        return PLAN_STREAM
    if not all(isinstance(w, dict) for w in ws):
        return None
    if all(set(w) == {"q", "scale"} for w in ws):
        return PLAN_INT8
    if all(set(w) == {"qp", "sz"} and w["sz"].dim() == 4
           and w["qp"].dim() == 3
           and w["sz"].shape[1] * HEAD_DIM == 2 * w["qp"].shape[1]
           for w in ws):
        return PLAN_INT4
    return None


def _k7_stacks(ws, plan: int):
    """The tensors K7 reads for each weight: (weights, sz, scales), the
    quantized dicts' q or qp stacks with int4's sz and int8's scale stacks
    (None where the plan has none)."""
    if plan == PLAN_INT8:
        return (tuple(w["q"] for w in ws), None,
                tuple(w["scale"] for w in ws))
    if plan == PLAN_INT4:
        return tuple(w["qp"] for w in ws), tuple(w["sz"] for w in ws), None
    return tuple(ws), None, None


def _experts(router) -> int:
    """The experts of a MoE router [L, D, E] (0 without one)."""
    return 0 if router is None else router.shape[-1]


def k7_form(h: torch.Tensor, ws, kc: torch.Tensor, n_heads: int,
            router=None, seq_block: bool = False) -> bool:
    """Whether a `token_decode` call is of the form K7 covers (decided by
    the form alone): one row h [D], or rows h [B, D] with 2 <= B <= 16
    (the rows form), the cache of the stream type with as many rows (one
    with `seq_block`: the rows are consecutive positions of one sequence)
    and head_dim 128, MHA or GQA with 1, 2, 4 or 8 (a divisor of
    `MAX_GROUP`) query heads a kv head, and the seven weights arrays of
    the stream type (fp32 or bf16), or with a bf16 stream all seven int8
    dicts or all seven packed int4 dicts at quant group 128
    (`k7_weight_plan`). With a MoE `router` (fp32 [L, D, E]): one row, no
    seq_block, arrays or int8 (the expert stacks [L, E, K, N]; int4 MoE is
    not wired, as in the reference). Whether K7 has a launch plan for the
    shapes (among them E and the routed count) is `k7_plan`'s."""
    plan = k7_weight_plan(ws)
    if plan is None:
        return False
    if plan == PLAN_STREAM:
        types = h.dtype in _DTYPE_CODE and all(w.dtype == h.dtype
                                               for w in ws)
    else:
        types = h.dtype == torch.bfloat16
    rows = (1 if h.dim() == 1 else h.shape[0]
            if h.dim() == 2 and 2 <= h.shape[0] <= MAX_ROWS else 0)
    if router is not None:
        w4 = _k7_stacks(ws, plan)[0][4]
        if not (rows == 1 and not seq_block and plan != PLAN_INT4
                and router.dtype == torch.float32 and router.dim() == 3
                and router.shape[1] == h.shape[-1] and w4.dim() == 4
                and w4.shape[:2] == (router.shape[0], router.shape[2])):
            return False
    return (rows > 0 and types
            and kc.dim() == 5 and kc.dtype == h.dtype
            and kc.shape[1] == (1 if seq_block else rows)
            and kc.shape[4] == HEAD_DIM and n_heads % kc.shape[2] == 0
            and MAX_GROUP % (n_heads // kc.shape[2]) == 0)


def k7_route(h: torch.Tensor, ws, kc: torch.Tensor, n_heads: int, caps,
             window: Optional[int] = None, router=None,
             seq_block: bool = False,
             token_fused: Optional[bool] = None,
             n_experts_per_tok: int = 0) -> bool:
    """`token_decode`'s route, from the call's form and shapes alone: K7
    where `token_fused` is not False, the call is of K7's form (`k7_form`)
    and K7 has a launch plan for the shapes (`k7_plan`); else the loop."""
    return (token_fused is not False
            and k7_form(h, ws, kc, n_heads, router, seq_block)
            and k7_plan(h, kc, ws, n_heads, caps, window, router,
                        n_experts_per_tok) is not None)


def k7_plan(h: torch.Tensor, kc: torch.Tensor, ws, n_heads: int, caps,
            window: Optional[int] = None, router=None,
            n_experts_per_tok: int = 0) -> Optional[TokenPlan]:
    """K7's launch plan for a call of K7's form, decided from shapes before
    any launch (the route's static gate, as the reference's
    `_can_packed_pipeline`): on a CUDA tensor the card's (`token_plan`),
    on a CPU tensor the H100's (`_token_plan` on `H100_CLUSTERS` and 132
    SMs). None: the shapes take no plan, and the call takes the loop."""
    if h.device.type == "cuda":
        return token_plan(h, kc, ws, n_heads, caps, window, router,
                          n_experts_per_tok)
    plan = k7_weight_plan(ws)
    if plan is None:
        return None
    return _token_plan(h.element_size(), h.shape[-1],
                       _k7_stacks(ws, plan)[0][4].shape[-1], n_heads,
                       kc.shape[2], kc.shape[3], window, max(caps),
                       kc.shape[0], plan=plan,
                       rows=h.shape[0] if h.dim() == 2 else 1,
                       E=_experts(router), k_exp=n_experts_per_tok)


def _check_k7_moe(h, ws, router, k_exp, routes, L):
    """Raise on a MoE call K7 does not take; returns ws with the expert
    stacks as the pseudo-layer stacks [L*E, K, N] (`expert_stacks`)."""
    plan = k7_weight_plan(ws)
    if (h.dim() != 1 or plan not in (PLAN_STREAM, PLAN_INT8)
            or router.dtype != torch.float32 or router.dim() != 3
            or router.shape[:2] != (L, h.shape[0])
            or router.device != h.device or not router.is_contiguous()):
        raise ValueError(f"K7's MoE form takes one row, arrays or int8 "
                         f"experts and an fp32 router [{L}, {h.shape[-1]}, "
                         f"E] on h's device; got h {tuple(h.shape)}, router "
                         f"{router.dtype} {tuple(router.shape)}")
    E = router.shape[2]
    if not _k7_moe_ok(plan, 1, E, k_exp):
        raise ValueError(f"K7 routes {k_exp} of {E} experts: E must divide "
                         f"{_TOK_WORKERS} and be at most {MAX_EXPERTS}, "
                         f"1 <= routed <= min(E, {MAX_ROUTED})")
    for w in ws[4:]:
        w4 = w["q"] if isinstance(w, dict) else w
        if w4.dim() != 4 or w4.shape[:2] != (L, E):
            raise ValueError(f"expert stacks must be [{L}, {E}, K, N]; got "
                             f"{tuple(w4.shape)}")
    if routes is not None and (routes.shape != (L, k_exp)
                               or routes.dtype != torch.int32
                               or routes.device != h.device
                               or not routes.is_contiguous()):
        raise ValueError(f"routes must be a contiguous int32 [{L}, {k_exp}] "
                         f"tensor on h's device")
    return (*ws[:4], *(expert_stacks(w) for w in ws[4:]))


def _check_k7(h, thresholds, ws, norm_attn, norm_mlp, rope, kc, vc, pos,
              caps, n_heads, sel, seq_block=False, n_exp=0, k_exp=0):
    """Raise on anything K7 (and its plain version) does not take (ws with
    the expert stacks of `n_exp` experts flattened, `_check_k7_moe`).
    Returns (L, D, I, Hkv, T, rows)."""
    B = 1 if h.dim() == 1 else h.shape[0]
    if (not (h.dim() == 1 or (h.dim() == 2 and 2 <= B <= MAX_ROWS))
            or h.dtype not in _DTYPE_CODE or not h.is_contiguous()):
        raise ValueError(f"h must be a contiguous fp32/bf16 vector [D] or "
                         f"rows [B, D] with 2 <= B <= {MAX_ROWS}; got "
                         f"{h.dtype} {tuple(h.shape)}")
    D, dev, dt = h.shape[-1], h.device, h.dtype
    Bc = 1 if seq_block else B            # the cache's rows
    if kc.dim() != 5 or kc.shape[1] != Bc or kc.shape[4] != HEAD_DIM:
        raise ValueError(f"caches must be [L, {Bc}, Hkv, T, {HEAD_DIM}]; got "
                         f"{tuple(kc.shape)}")
    L, _, Hkv, T, _ = kc.shape
    if n_heads * HEAD_DIM != D or n_heads % Hkv or \
            MAX_GROUP % (n_heads // Hkv):
        raise ValueError(f"{n_heads} heads of {HEAD_DIM} must make D = {D} "
                         f"and group the {Hkv} kv heads by 1, 2, 4 or 8")
    for name, t in (("kc", kc), ("vc", vc)):
        if (t.shape != kc.shape or t.dtype != dt or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {list(kc.shape)} "
                             f"cache of h's type on h's device")
    plan = k7_weight_plan(ws)
    if plan is None:
        raise ValueError("K7 takes the seven projections as arrays, as "
                         "seven int8 {'q', 'scale'} dicts or as seven packed "
                         "int4 {'qp', 'sz'} dicts at quant group 128")
    if plan != PLAN_STREAM and dt != torch.bfloat16:
        raise ValueError(f"K7's int8 and int4 weights take a bf16 stream; "
                         f"got {dt}")
    wts, szs, scs = _k7_stacks(ws, plan)
    I = wts[4].shape[-1]
    shapes = ((D, D), (D, Hkv * HEAD_DIM), (D, Hkv * HEAD_DIM), (D, D),
              (D, I), (D, I), (I, D))
    for i, (k, n) in enumerate(shapes):
        Lw = L * n_exp if i >= 4 and n_exp else L     # pseudo-layers
        want = [(wts[i], (Lw, k, n) if plan != PLAN_INT4
                 else (Lw, k // 2, n),
                 dt if plan == PLAN_STREAM else torch.int8)]
        if plan == PLAN_INT4:
            want.append((szs[i], (Lw, k // HEAD_DIM, 2, n), torch.float32))
        if plan == PLAN_INT8:
            want.append((scs[i], (Lw, n), torch.float32))
        for t, shape, tdt in want:
            if (t.shape != shape or t.dtype != tdt or t.device != dev
                    or not t.is_contiguous() or t.data_ptr() % 16):
                raise ValueError(
                    f"weights must be contiguous, 16-byte aligned stacks on "
                    f"h's device: {tdt} {list(shape)}; got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
    if I % HEAD_DIM or D % HEAD_DIM:
        raise ValueError(f"D = {D} and I = {I} must be multiples of "
                         f"{HEAD_DIM}")
    for name, t in (("norm_attn", norm_attn), ("norm_mlp", norm_mlp)):
        if (t.shape != (L, D) or t.dtype != dt or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous [{L}, {D}] stack "
                             f"of h's type")
    if (thresholds.shape != (L, 7) or thresholds.dtype != torch.float32
            or thresholds.device != dev or not thresholds.is_contiguous()):
        raise ValueError(f"thresholds must be a contiguous fp32 [{L}, 7] "
                         f"table on h's device")
    if (rope.shape != (B, 2, HEAD_DIM) or rope.dtype != torch.float32
            or rope.device != dev or not rope.is_contiguous()):
        raise ValueError(f"rope must be contiguous fp32 [{B}, 2, {HEAD_DIM}] "
                         f"(cos, sin) rows on h's device")
    if (not isinstance(pos, torch.Tensor) or pos.shape != (B,)
            or pos.dtype != torch.int32 or pos.device != dev
            or not pos.is_contiguous()):
        raise ValueError(f"pos must be an int32 [{B}] tensor on h's device "
                         f"(read on the device; K7 traps out of range)")
    ks = (D, D, D, I)
    if len(caps) != 4 or not all(1 <= c <= k // HEAD_DIM
                                 for c, k in zip(caps, ks)):
        raise ValueError(f"caps {tuple(caps)} out of range: (qkv, o, "
                         f"gate|up, down) within [1, {D // HEAD_DIM}] x 3 "
                         f"and [1, {I // HEAD_DIM}]")
    nst = 2 + 2 * k_exp if n_exp else 4
    if sel is not None and (sel.shape != (L, nst, 1 + max(caps))
                            or sel.dtype != torch.int32 or sel.device != dev
                            or not sel.is_contiguous()):
        raise ValueError(f"sel must be a contiguous int32 [{L}, {nst}, "
                         f"{1 + max(caps)}] tensor on h's device")
    if h.data_ptr() % 16:
        raise ValueError("K7 reads h in 16-byte chunks: it must be 16-byte "
                         "aligned")
    return L, D, I, Hkv, T, B


def _record(sel, layer: int, stage: int, idx, count) -> None:
    """A stage's kept count and groups into sel [L, stages, 1 + max cap]:
    the count, the groups in order, -1 past the count."""
    row = sel[layer, stage]
    row.fill_(-1)
    row[0] = count.reshape(())
    row[1:1 + idx.numel()] = idx


def token_kernel_plain(h, thresholds, ws, norm_attn, norm_mlp, rope, kc, vc,
                       pos, *, caps, n_heads: int, norm_eps: float = 1e-5,
                       window: Optional[int] = None, fixed_sel: bool = False,
                       seq_block: bool = False,
                       sel: Optional[torch.Tensor] = None,
                       router: Optional[torch.Tensor] = None,
                       n_experts_per_tok: int = 0,
                       routes: Optional[torch.Tensor] = None):
    """K7 in plain PyTorch (same arguments and result as `token_kernel`):
    each layer's four stages through K1's and K2's plain versions, as the
    layer loop runs them (the same cast points; int8's scales on each
    stage's fp32 sums, packed int4 through its factored affine; rows
    [B, D] through the plain twins' rows: one kept set a stage, pooled
    over the rows; `seq_block` through K2's plain seq_block form; MoE:
    K5's plain version on the stream after o, then gate|up and down of
    each routed expert at its pseudo-layer of the stacks `expert_stacks`
    flattens, as `layer_decode(router=...)` runs them). A device position
    is read to the host here (this version is no fast path)."""
    k_exp = n_experts_per_tok if router is not None else 0
    if router is not None:
        ws = _check_k7_moe(h, ws, router, k_exp, routes, kc.shape[0])
    B = _check_k7(h, thresholds, ws, norm_attn, norm_mlp, rope, kc, vc, pos,
                  caps, n_heads, sel, seq_block, _experts(router), k_exp)[5]
    ops, sc = stage_operands(ws)
    wq, wk, wv, wo, wgate, wup, wdown = ops

    def scales(*i):
        return None if sc is None else tuple(sc[j] for j in i)
    nq, nk = n_heads * HEAD_DIM, kc.shape[2] * HEAD_DIM
    for layer in range(kc.shape[0]):
        qkv, i0, c0 = select_gather_gemv_plain(
            h, thresholds[layer, 0], (wq, wk, wv), layer, caps[0],
            norm=norm_attn, norm_eps=norm_eps, scales=scales(0, 1, 2),
            fixed=fixed_sel)
        q2 = qkv.reshape(B, -1)
        attn = decode_attention_plain(
            q2[:, :nq].reshape(B, n_heads, HEAD_DIM),
            q2[:, nq:nq + nk].reshape(B, -1, HEAD_DIM),
            q2[:, nq + nk:].reshape(B, -1, HEAD_DIM), kc, vc, layer, pos,
            window=window, rope=rope,
            seq_block=seq_block).reshape(h.shape[:-1] + (nq,))
        h, i1, c1 = select_gather_gemv_plain(
            attn, thresholds[layer, 3], (wo,), layer, caps[1], res=h,
            scales=scales(3), fixed=fixed_sel)
        kept = [(i0, c0), (i1, c1)]
        if router is None:
            inter, i2, c2 = select_gather_gemv_plain(
                h, thresholds[layer, 4], (wgate, wup), layer, caps[2],
                norm=norm_mlp, norm_eps=norm_eps, silu=True,
                scales=scales(4, 5), fixed=fixed_sel)
            h, i3, c3 = select_gather_gemv_plain(
                inter, thresholds[layer, 6], (wdown,), layer, caps[3],
                res=h, scales=scales(6), fixed=fixed_sel)
            kept += [(i2, c2), (i3, c3)]
        else:
            xn, eidx, route_w = moe_route_plain(h, norm_mlp, router, layer,
                                                k_exp, norm_eps)
            if routes is not None:
                routes[layer] = eidx
            for t in range(k_exp):
                inter, i2, c2 = select_gather_gemv_plain(
                    xn, thresholds[layer, 4], (wgate, wup), eidx, caps[2],
                    slot=t, silu=True, scales=scales(4, 5), fixed=fixed_sel)
                h, i3, c3 = select_gather_gemv_plain(
                    inter, thresholds[layer, 6], (wdown,), eidx, caps[3],
                    slot=t, res=h, route_w=route_w, scales=scales(6),
                    fixed=fixed_sel)
                kept += [(i2, c2), (i3, c3)]
        if sel is not None:
            for st, (i, c) in enumerate(kept):
                _record(sel, layer, st, i, c)
    return h


def k7_clusters(device: torch.device, dtype: torch.dtype, GH: int,
                plan: int = PLAN_STREAM, rows: bool = False) -> dict:
    """The card's resident clusters of C blocks of K7 for (weight plan,
    dtype, GH query heads a kv head; `rows`: the rows form's kernel):
    {C: clusters} for C in [2, 8] from the CUDA runtime
    (`teal_token_clusters`, `teal_token_clusters_q` for int8 and int4,
    `teal_token_clusters_rows` and `teal_token_clusters_rows_q`; asked
    once)."""
    key = (device.index, dtype, GH, plan, rows)
    if key not in _CLUSTERS:
        libs = _build.load()

        def ask(c):
            if rows and plan == PLAN_STREAM:
                return libs["token_decode_rows"].teal_token_clusters_rows(
                    _DTYPE_CODE[dtype], GH, c)
            if rows:
                return libs[
                    "token_decode_rows_quant"].teal_token_clusters_rows_q(
                        plan, GH, c)
            if plan == PLAN_STREAM:
                return libs["token_decode"].teal_token_clusters(
                    _DTYPE_CODE[dtype], GH, c)
            return libs["token_decode_quant"].teal_token_clusters_q(
                plan, GH, c)
        with torch.cuda.device(device):
            _CLUSTERS[key] = {c: ask(c)
                              for c in range(_TOK_MIN_C, _TOK_MAX_C + 1)}
    return _CLUSTERS[key]


_CLUSTERS: dict = {}


def token_plan(h: torch.Tensor, kc: torch.Tensor, ws, n_heads: int, caps,
               window: Optional[int] = None, router=None,
               n_experts_per_tok: int = 0) -> Optional[TokenPlan]:
    """K7's plan for a `token_kernel` call on h's card (None where the
    shapes or the weights take none); h [B, D] asks the rows form's, a
    `router` the MoE form's."""
    L, _, Hkv, T, _ = kc.shape
    plan = k7_weight_plan(ws)
    if plan is None:
        return None
    rows = h.shape[0] if h.dim() == 2 else 1
    if rows > 1 and (not 2 <= rows <= MAX_ROWS
                     or MAX_GROUP % max(1, n_heads // Hkv)):
        return None
    return _token_plan(h.element_size(), h.shape[-1],
                       _k7_stacks(ws, plan)[0][4].shape[-1], n_heads, Hkv,
                       T, window, max(caps), L,
                       _build.sm_count(h.device.index),
                       k7_clusters(h.device, h.dtype, n_heads // Hkv, plan,
                                   rows > 1),
                       plan, rows, _experts(router), n_experts_per_tok)


def token_trace(h: torch.Tensor, kc: torch.Tensor, ws, n_heads: int, caps,
                window: Optional[int] = None) -> torch.Tensor:
    """A zeroed `stamps` tensor for a `token_kernel` call on the card (not
    the MoE form, whose trace K7 does not keep): int64 [L, K7_STAMPS + 9 *
    grid] (block 0's points, then every block's arrival at each of the
    five barrier slots and the end of its share of each of the four
    gather stages)."""
    plan = token_plan(h, kc, ws, n_heads, caps, window)
    if plan is None:
        raise ValueError("K7 has no launch plan for these shapes")
    return torch.zeros((kc.shape[0], K7_STAMPS
                        + _TOK_TRACE_ROWS * plan.grid),
                       dtype=torch.int64, device=h.device)


def token_kernel(h: torch.Tensor, thresholds: torch.Tensor, ws,
                 norm_attn: torch.Tensor, norm_mlp: torch.Tensor,
                 rope: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                 pos: torch.Tensor, *, caps: Tuple[int, int, int, int],
                 n_heads: int, norm_eps: float = 1e-5,
                 window: Optional[int] = None, fixed_sel: bool = False,
                 seq_block: bool = False, sel: Optional[torch.Tensor] = None,
                 empty: bool = False, stamps: Optional[torch.Tensor] = None,
                 router: Optional[torch.Tensor] = None,
                 n_experts_per_tok: int = 0,
                 routes: Optional[torch.Tensor] = None):
    """K7: one token through every layer in one launch, for one row or
    for 2-16 rows (the rows form: each row a sequence at its own position,
    or with `seq_block` a position of one sequence, one kept set a stage
    pooled over the rows), or (MoE) one row of Mixtral with its routing
    inside.

    h:    [D] raw residual stream (the token's embedding), fp32 or bf16;
          or rows [B, D]
    thresholds: [L, 7] fp32 group thresholds, read on the device
    ws:   (wq, wk, wv, wo, wgate, wup, wdown), [L, K, N] arrays of h's
          type, or with bf16 h all seven int8 {"q" [L, K, N], "scale"
          [L, N] fp32} or all seven packed int4 {"qp" [L, K/2, N] int8,
          "sz" [L, K/128, 2, N] fp32} (the layouts `quant` produces, read
          as they are)
    norm_attn/norm_mlp: [L, D] rms_norm gains of h's type
    rope: [B, 2, 128] fp32 (cos, sin) rows at pos (B = 1 for one row)
    kc/vc: [L, B, Hkv, T, 128] caches of h's type ([L, 1, ...] with
          seq_block), updated in place
    pos:  int32 [B] on the device (the kernel traps outside [0, T), and
          with seq_block where pos[i] != pos[0] + i)
    caps: gather capacities (qkv, o, gate|up, down)
    fixed_sel: keep groups 0..cap-1 at every stage
    seq_block: the rows are the consecutive positions pos[0] + i of one
          sequence in cache row 0: every row's K/V is written before any
          row attends, row i to the rows before pos[0] + i (the verify's
          chunk)
    sel:  optional int32 [L, 4, 1 + max(caps)]: each stage's kept count
          and groups (-1 past the count); MoE: [L, 2 + 2 k, 1 + max(caps)],
          qkv, o, then gate|up and down of each routed expert in order
    router: Mixtral, one row: [L, D, E] fp32 router weights; ws[4:7] are
          then the expert stacks [L, E, K, N] (int8: {"q" [L, E, K, N],
          "scale" [L, E, N]}), `n_experts_per_tok` (k) of which run a
          layer: K7 routes in every cluster (the same logits in every
          block), then runs gate|up (column 4 of the real layer, no norm
          fold past the routing's) and down (column 6, the weighted
          residual) of each routed expert at its pseudo-layer l E + e
    routes: optional int32 [L, k] (MoE): each layer's routed
          pseudo-layers
    empty: launch the kernel with its barriers alone (their floor; no
          output is written; one row)
    stamps: optional int64 [L, K7_STAMPS + 9 * grid] on the card (one row;
          not the MoE form)
          (`token_trace` makes one): block 0's %globaltimer (ns) at each
          layer's start, at the arrival at and the exit from each grid
          barrier, at each gather's start and end, at the end of each
          stage's cluster sums and at five points of attention; then
          every block's arrival at each barrier slot and the end of its
          share of each gather stage (`k7_phases` reads it)

    Returns the stream after the last layer, of h's shape. On CPU tensors
    this runs `token_kernel_plain`; on a CUDA tensor it launches K7 or
    raises."""
    k_exp = n_experts_per_tok if router is not None else 0
    E = _experts(router)
    flat = ws if router is None else _check_k7_moe(h, ws, router, k_exp,
                                                   routes, kc.shape[0])
    L, D, I, Hkv, T, B = _check_k7(h, thresholds, flat, norm_attn, norm_mlp,
                                   rope, kc, vc, pos, caps, n_heads, sel,
                                   seq_block, E, k_exp)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive; got {window}")
    if B > 1 and (empty or stamps is not None):
        raise ValueError("the empty launch and the trace are the one-row "
                         "kernel's")
    if router is not None and stamps is not None:
        raise ValueError("K7's MoE form keeps no trace")
    if h.device.type == "cpu":
        if empty or stamps is not None:
            raise ValueError("an empty launch and the trace are card "
                             "measurements")
        return token_kernel_plain(h, thresholds, ws, norm_attn, norm_mlp,
                                  rope, kc, vc, pos, caps=caps,
                                  n_heads=n_heads, norm_eps=norm_eps,
                                  window=window, fixed_sel=fixed_sel,
                                  seq_block=seq_block, sel=sel,
                                  router=router, n_experts_per_tok=k_exp,
                                  routes=routes)
    _check_launch_device(h, "token_kernel")
    sms = _build.sm_count(h.device.index)
    plan = token_plan(h, kc, ws, n_heads, caps, window, router, k_exp)
    if plan is None:
        raise ValueError(f"K7 has no launch plan for D = {D}, I = {I}, "
                         f"{n_heads}/{Hkv} heads, T = {T}, window {window}, "
                         f"caps {tuple(caps)}, {k_exp} of {E} experts on "
                         f"{sms} SMs")
    width = K7_STAMPS + _TOK_TRACE_ROWS * plan.grid
    if stamps is not None and (stamps.shape != (L, width)
                               or stamps.dtype != torch.int64
                               or stamps.device != h.device
                               or not stamps.is_contiguous()):
        raise ValueError(f"stamps must be a contiguous int64 [{L}, {width}] "
                         f"tensor on h's device (`token_trace`)")
    out = torch.empty_like(h)
    work = torch.empty(plan.ws_bytes, dtype=torch.uint8, device=h.device)
    wplan = k7_weight_plan(flat)
    wts, szs, scs = _k7_stacks(flat, wplan)
    none = (None,) * 7
    if B > 1:
        head = (B, h.data_ptr(), thresholds.data_ptr(), pos.data_ptr(),
                rope.data_ptr(), norm_attn.data_ptr(), norm_mlp.data_ptr(),
                *(w.data_ptr() for w in wts))
        tail = (kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
                None if sel is None else sel.data_ptr(), work.data_ptr(), L,
                D, I, n_heads, Hkv, T, window or 0, *caps, int(fixed_sel),
                int(seq_block), norm_eps, sms,
                torch.cuda.current_stream().cuda_stream)
        if wplan == PLAN_STREAM:
            err = _build.load()["token_decode_rows"].teal_token_decode_rows(
                _DTYPE_CODE[h.dtype], *head, *tail)
        else:
            err = _build.load()[
                "token_decode_rows_quant"].teal_token_decode_rows_q(
                    wplan, *head,
                    *(none if szs is None else (t.data_ptr() for t in szs)),
                    *(none if scs is None else (t.data_ptr() for t in scs)),
                    *tail)
        if err == -1:
            raise RuntimeError("token_kernel: no plan or no TMA map for "
                               "these rows on this card")
        _build.check(err, "token_kernel")
        token_kernel.launches += 1
        return out
    head = (h.data_ptr(), thresholds.data_ptr(), pos.data_ptr(),
            rope.data_ptr(), norm_attn.data_ptr(), norm_mlp.data_ptr(),
            *(w.data_ptr() for w in wts))
    tail = (None if router is None else router.data_ptr(), kc.data_ptr(),
            vc.data_ptr(), out.data_ptr(),
            None if sel is None else sel.data_ptr(),
            None if routes is None else routes.data_ptr(),
            None if stamps is None else stamps.data_ptr(), work.data_ptr(), L,
            D, I, n_heads, Hkv, T, window or 0, *caps, int(fixed_sel), E,
            k_exp, norm_eps, sms, int(empty),
            torch.cuda.current_stream().cuda_stream)
    if wplan == PLAN_STREAM:
        err = _build.load()["token_decode"].teal_token_decode(
            _DTYPE_CODE[h.dtype], *head, *tail)
    else:
        err = _build.load()["token_decode_quant"].teal_token_decode_q(
            wplan, *head,
            *(none if szs is None else (t.data_ptr() for t in szs)),
            *(none if scs is None else (t.data_ptr() for t in scs)), *tail)
    if err == -1:
        raise RuntimeError("token_kernel: no plan or no TMA map for these "
                           "weights on this card")
    _build.check(err, "token_kernel")
    if not empty:
        token_kernel.launches += 1
    return out


token_kernel.launches = 0

K7_STAMPS = 1 + 2 * _TOK_BARRIER_SLOTS + 4 + 4 + 4 + 5
K7_BARRIERS = ("qkv", "attention", "o", "gate|up", "down")


def k7_phases(stamps: torch.Tensor):
    """Microseconds summed over the layers from a K7 trace (`token_kernel`'s
    `stamps`): block 0's phases between grid barriers, for each (block 0's
    work, from the previous barrier's exit -- the layer's start for the
    first -- to its arrival at the next; the whole phase, exit to exit):
    "qkv" in the other plan only, "attention" (with q|k|v in the
    head-owned plan), "o", "gate|up", "down"; for each gather stage the
    layers that ran it (kept a group) and, over them, its prologue (phase
    start to gather start), gather (to its last slot used) and cluster
    sums (to the stage's values written); attention's spans (the
    q|k|v sums or loads and RoPE, the scores and local max, the maxima's
    exchange, the weights and PV, the PV's exchange, the combine); for
    each barrier, from every block's arrival (the layers that ran it):
    the spread (last arrival - first, summed), block 0's wait (last
    arrival - block 0's) and the block that arrived last most often; and
    for each gather stage the spread of its blocks' ends."""
    s = stamps.cpu().double() / 1e3
    grid = (s.shape[1] - K7_STAMPS) // _TOK_TRACE_ROWS
    head = bool((stamps[:, 1] == 0).all())
    G, E, Z, A = (1 + 2 * _TOK_BARRIER_SLOTS, 1 + 2 * _TOK_BARRIER_SLOTS + 4,
                  1 + 2 * _TOK_BARRIER_SLOTS + 8,
                  1 + 2 * _TOK_BARRIER_SLOTS + 12)

    def span(a, b, ran=None):
        d = s[:, b] - s[:, a]
        return float((d if ran is None else d[ran]).sum())
    out = {}
    prev = 0
    for b, name in enumerate(K7_BARRIERS):
        if b == 0 and head:
            continue
        out[name] = (span(prev, 1 + 2 * b), span(prev, 2 + 2 * b))
        prev = 2 + 2 * b
    for j, (name, start) in enumerate((("qkv", 0), ("o", 4), ("gate|up", 6),
                                       ("down", 8))):
        ran = (stamps[:, G + j] != 0).cpu()    # the layers that ran it
        out[f"{name} layers"] = int(ran.sum())
        out[f"{name} prologue"] = span(start, G + j, ran)
        out[f"{name} gather"] = span(G + j, E + j, ran)
        out[f"{name} sums"] = span(E + j, Z + j, ran)
    for name, a, b in (("qkv+rope", Z if head else 2, A),
                       ("scores", A, A + 1), ("max exchange", A + 1, A + 2),
                       ("weights+pv", A + 2, A + 3),
                       ("pv exchange", A + 3, A + 4), ("combine", A + 4, 3)):
        out[f"attention {name}"] = span(a, b)
    def rows(r):                 # every block's row r of the trace
        return s[:, K7_STAMPS + r * grid:K7_STAMPS + (r + 1) * grid]
    for b, name in enumerate(K7_BARRIERS):
        arr = rows(b)
        used = (stamps[:, K7_STAMPS + b * grid] != 0).cpu()
        if not bool(used.any()):
            continue
        arr = arr[used]
        last = arr.max(1).values
        out[f"{name} barrier spread"] = float((last - arr.min(1).values).sum())
        out[f"{name} barrier block 0 wait"] = float((last - arr[:, 0]).sum())
        out[f"{name} barrier last block"] = int(
            torch.mode(arr.argmax(1)).values)
    for j, name in enumerate(("qkv", "o", "gate|up", "down")):
        ends = rows(_TOK_BARRIER_SLOTS + j)
        used = (stamps[:, K7_STAMPS + (_TOK_BARRIER_SLOTS + j) * grid]
                != 0).cpu()
        if bool(used.any()):
            e = ends[used]
            e = e[:, (e != 0).all(0)]          # blocks that ran the stage
            out[f"{name} gather end spread"] = float(
                (e.max(1).values - e.min(1).values).sum())
    return out
