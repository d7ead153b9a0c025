"""Single-token decode of the whole layer stack (G = 128), for one row
or a batch of up to 16 rows.

Port of `teal_tpu/ops/token_block.py:token_decode`. The JAX package runs
every layer in one Pallas launch (`_token_kernel`), or with `token_fused`
False in the 4-launch packed pipeline (`models/llama.py:_packed_layer`).
Here two routes, decided by the call's form alone:
  - K7 `token_kernel` (`csrc/token_decode.cu`): one persistent launch a
    token through every layer, for one row (batch 1) with weights that are
    arrays of the stream type, the cache of that type, no MoE, head_dim
    128 and Hq / Hkv <= 8, where `token_fused` is not False. Its plain
    version, `token_kernel_plain`, runs each stage through K1's and K2's
    plain versions (on CPU tensors the wrapper runs it);
  - the layer loop below, every other form and `token_fused=False`: a
    host loop runs, per layer, five kernel launches whatever the batch
    (160 a step at 7B):
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

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from teal_tpu_torch import _build
from teal_tpu_torch.ops.attn_block import attn_stage
from teal_tpu_torch.ops.block_gemv import (_DTYPE_CODE, _H100_SMS,
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
          pipeline); otherwise K7 takes the forms it covers

    Returns the stream after the last layer, of h's shape.
    """
    if token_fused is not False and k7_form(h, ws, kc, n_heads, router,
                                            seq_block):
        if isinstance(pos, int):
            if not 0 <= pos < kc.shape[3]:
                raise ValueError(f"pos {pos} out of range "
                                 f"[0, {kc.shape[3]})")
            pos = torch.full((1,), pos, dtype=torch.int32, device=h.device)
        return token_kernel(h, thresholds, ws, norm_attn, norm_mlp, rope,
                            kc, vc, pos, caps=caps, n_heads=n_heads,
                            norm_eps=norm_eps, window=window,
                            fixed_sel=fixed_sel)
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


# --- K7: the whole token in one launch --------------------------------------

# K7's launch plan on the card (`csrc/token_decode.cu`: `token_plan`,
# `Layout` and `WsLayout`, which `_token_smem`, `_token_ws` and
# `_token_plan` mirror; the card tests hold them together through
# `teal_token_plan`)
_TOK_THREADS = 256
_TOK_PIECE = 256                 # bytes of a slab row a tile reads
_TOK_RING = 64 * 1024            # the cp.async ring: 16 x 16 bytes a thread
_TOK_RLANES = 16                 # slab rows a step
_TOK_MAXCH = 8                   # 16-byte chunks of h a thread at most
_TOK_MAX_SA = 16                 # attention blocks a kv head
_TOK_GRID_BARRIERS = 6           # a layer
_TOK_HEAD_BARRIERS = 2           # a layer, a kv head's blocks


class TokenPlan(NamedTuple):
    grid: int                    # blocks (one an SM)
    threads: int
    smem: int                    # shared bytes a block
    ws_bytes: int                # workspace bytes
    grid_barriers: int           # a token
    head_barriers: int           # a token, among a kv head's SA blocks
    SA: int                      # attention blocks a kv head


def _al(n: int, a: int) -> int:
    return -(-n // a) * a


def _token_smem(esz: int, D: int, I: int, GH: int, capmax: int,
                NS: int) -> int:
    """K7's shared memory a block in bytes: the cp.async ring (attention's
    row-lane PV sums), the row lanes' sums of a tile, the stream h [D] and
    a stage's selection input [max(D, I)] of the stream type, the group
    scores, the kept groups and count, 64 floats of scratch, attention's
    raw q|k|v sums and RoPE'd q|k (fp32), q rounded, four [8] fp32 and
    the score slice [GH][NS]."""
    tw = _TOK_PIECE // esz
    n = _TOK_RING + _TOK_RLANES * 2 * tw * 4
    n += _al(D * esz, 16) + _al(max(D, I) * esz, 16)
    n += _al(max(D, I) // HEAD_DIM, 4) * 4 + _al(capmax + 1, 4) * 4 + 64 * 4
    n += (GH + 2) * HEAD_DIM * 4 + (GH + 1) * HEAD_DIM * 4
    n += _al(GH * HEAD_DIM * esz, 16) + 4 * MAX_GROUP * 4
    return n + GH * NS * 4


def _token_segs(P: int, tiles: int) -> int:
    """Partial slots a tile: at most P / tiles + 2 blocks' ranges meet one
    tile of a stage cut into P equal ranges."""
    return P // tiles + 2


def _token_ws(esz: int, D: int, I: int, Hq: int, Hkv: int, P: int,
              SA: int) -> int:
    """K7's workspace in bytes (256-byte aligned regions): the barrier
    counters (1 + Hkv, a 128-byte line each), the partials [tiles][slots]
    [NW][tile] fp32 of the q|k|v, o, gate|up (NW 2) and down stages,
    attention's maxima, sums and partial PV of the Hkv x SA blocks
    (fp32), the attention output [Hq * 128] and the intermediate [I] of
    the stream type."""
    tw, GH = _TOK_PIECE // esz, Hq // Hkv
    nq, nd, ni = (Hq + 2 * Hkv) * HEAD_DIM // tw, D // tw, I // tw
    parts = (nq * _token_segs(P, nq) * tw, nd * _token_segs(P, nd) * tw,
             ni * _token_segs(P, ni) * 2 * tw, nd * _token_segs(P, nd) * tw,
             Hkv * SA * GH, Hkv * SA * GH, Hkv * SA * GH * HEAD_DIM)
    n = _al((1 + Hkv) * 128, 256)
    for p in parts:
        n = _al(n + p * 4, 256)
    n = _al(n + Hq * HEAD_DIM * esz, 256)
    return _al(n + I * esz, 256)


def _token_plan(esz: int, D: int, I: int, Hq: int, Hkv: int, T: int,
                window: Optional[int], capmax: int, L: int,
                n_sms: int = _H100_SMS) -> Optional[TokenPlan]:
    """K7's launch plan from shapes only, or None where they take none
    (among them a stream of more than 32 KB: a thread holds at most
    `_TOK_MAXCH` 16-byte chunks of it): a grid of one block an SM; SA =
    min(16, SMs / Hkv) blocks a kv head share its live rows, each holding
    the scores of at most ceil((min(T, window) - 1) / SA) rows (padded to
    4); 6 grid barriers a layer and 2 among a kv head's blocks."""
    if (D <= 0 or I <= 0 or D % HEAD_DIM or I % HEAD_DIM or Hkv <= 0
            or Hq != D // HEAD_DIM or Hq % Hkv or MAX_GROUP % (Hq // Hkv)
            or Hkv > n_sms or T < 1 or L < 1
            or not 1 <= capmax <= max(D, I) // HEAD_DIM
            or D * esz > 16 * _TOK_MAXCH * _TOK_THREADS):
        return None
    SA = min(_TOK_MAX_SA, n_sms // Hkv)
    live = window if window and window < T else T
    NS = _al(-(-max(live - 1, 1) // SA), 4)
    smem = _token_smem(esz, D, I, Hq // Hkv, capmax, NS)
    if smem > _SMEM_BYTES:
        return None
    return TokenPlan(n_sms, _TOK_THREADS, smem,
                     _token_ws(esz, D, I, Hq, Hkv, n_sms, SA),
                     _TOK_GRID_BARRIERS * L, _TOK_HEAD_BARRIERS * L, SA)


def k7_form(h: torch.Tensor, ws, kc: torch.Tensor, n_heads: int,
            router=None, seq_block: bool = False) -> bool:
    """Whether a `token_decode` call is of the form K7 covers (decided by
    the form alone): one row of fp32 or bf16, the seven weights arrays of
    that type, the cache of that type with one row and head_dim 128, MHA
    or GQA with 1, 2, 4 or 8 (a divisor of `MAX_GROUP`) query heads a kv
    head, no MoE router, no seq_block."""
    return (router is None and not seq_block and h.dim() == 1
            and h.dtype in _DTYPE_CODE and len(ws) == 7
            and all(isinstance(w, torch.Tensor) and w.dtype == h.dtype
                    for w in ws)
            and kc.dim() == 5 and kc.dtype == h.dtype and kc.shape[1] == 1
            and kc.shape[4] == HEAD_DIM and n_heads % kc.shape[2] == 0
            and MAX_GROUP % (n_heads // kc.shape[2]) == 0)


def _check_k7(h, thresholds, ws, norm_attn, norm_mlp, rope, kc, vc, pos,
              caps, n_heads, sel):
    """Raise on anything K7 (and its plain version) does not take."""
    if h.dim() != 1 or h.dtype not in _DTYPE_CODE or not h.is_contiguous():
        raise ValueError(f"h must be a contiguous fp32/bf16 vector [D]; got "
                         f"{h.dtype} {tuple(h.shape)}")
    D, dev, dt = h.shape[0], h.device, h.dtype
    if kc.dim() != 5 or kc.shape[1] != 1 or kc.shape[4] != HEAD_DIM:
        raise ValueError(f"caches must be [L, 1, Hkv, T, {HEAD_DIM}]; got "
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
    if len(ws) != 7 or not all(isinstance(w, torch.Tensor) for w in ws):
        raise ValueError("K7 takes the seven projections as arrays")
    I = ws[4].shape[-1]
    shapes = ((D, D), (D, Hkv * HEAD_DIM), (D, Hkv * HEAD_DIM), (D, D),
              (D, I), (D, I), (I, D))
    for w, (k, n) in zip(ws, shapes):
        if (w.shape != (L, k, n) or w.dtype != dt or w.device != dev
                or not w.is_contiguous() or w.data_ptr() % 16):
            raise ValueError(f"weights must be contiguous, 16-byte aligned "
                             f"[{L}, {k}, {n}] stacks of h's type; got "
                             f"{w.dtype} {tuple(w.shape)}")
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
    if (rope.shape != (1, 2, HEAD_DIM) or rope.dtype != torch.float32
            or rope.device != dev or not rope.is_contiguous()):
        raise ValueError(f"rope must be a contiguous fp32 [1, 2, {HEAD_DIM}] "
                         f"(cos, sin) row on h's device")
    if (not isinstance(pos, torch.Tensor) or pos.shape != (1,)
            or pos.dtype != torch.int32 or pos.device != dev):
        raise ValueError("pos must be an int32 [1] tensor on h's device "
                         "(read on the device; K7 traps out of range)")
    ks = (D, D, D, I)
    if len(caps) != 4 or not all(1 <= c <= k // HEAD_DIM
                                 for c, k in zip(caps, ks)):
        raise ValueError(f"caps {tuple(caps)} out of range: (qkv, o, "
                         f"gate|up, down) within [1, {D // HEAD_DIM}] x 3 "
                         f"and [1, {I // HEAD_DIM}]")
    if sel is not None and (sel.shape != (L, 4, 1 + max(caps))
                            or sel.dtype != torch.int32 or sel.device != dev
                            or not sel.is_contiguous()):
        raise ValueError(f"sel must be a contiguous int32 [{L}, 4, "
                         f"{1 + max(caps)}] tensor on h's device")
    if h.data_ptr() % 16:
        raise ValueError("K7 reads h in 16-byte chunks: it must be 16-byte "
                         "aligned")
    return L, D, I, Hkv, T


def _record(sel, layer: int, stage: int, idx, count) -> None:
    """A stage's kept count and groups into sel [L, 4, 1 + max cap]: the
    count, the groups in order, -1 past the count."""
    row = sel[layer, stage]
    row.fill_(-1)
    row[0] = count.reshape(())
    row[1:1 + idx.numel()] = idx


def token_kernel_plain(h, thresholds, ws, norm_attn, norm_mlp, rope, kc, vc,
                       pos, *, caps, n_heads: int, norm_eps: float = 1e-5,
                       window: Optional[int] = None, fixed_sel: bool = False,
                       sel: Optional[torch.Tensor] = None):
    """K7 in plain PyTorch (same arguments and result as `token_kernel`):
    each layer's four stages through K1's and K2's plain versions, as the
    layer loop runs them (the same cast points). A device position is
    read to the host here (this version is no fast path)."""
    _check_k7(h, thresholds, ws, norm_attn, norm_mlp, rope, kc, vc, pos,
              caps, n_heads, sel)
    wq, wk, wv, wo, wgate, wup, wdown = ws
    nq, nk = n_heads * HEAD_DIM, kc.shape[2] * HEAD_DIM
    for layer in range(kc.shape[0]):
        qkv, i0, c0 = select_gather_gemv_plain(
            h, thresholds[layer, 0], (wq, wk, wv), layer, caps[0],
            norm=norm_attn, norm_eps=norm_eps, fixed=fixed_sel)
        attn = decode_attention_plain(
            qkv[:nq].view(1, n_heads, HEAD_DIM),
            qkv[nq:nq + nk].view(1, -1, HEAD_DIM),
            qkv[nq + nk:].view(1, -1, HEAD_DIM), kc, vc, layer, pos,
            window=window, rope=rope).reshape(nq)
        h, i1, c1 = select_gather_gemv_plain(
            attn, thresholds[layer, 3], (wo,), layer, caps[1], res=h,
            fixed=fixed_sel)
        inter, i2, c2 = select_gather_gemv_plain(
            h, thresholds[layer, 4], (wgate, wup), layer, caps[2],
            norm=norm_mlp, norm_eps=norm_eps, silu=True, fixed=fixed_sel)
        h, i3, c3 = select_gather_gemv_plain(
            inter, thresholds[layer, 6], (wdown,), layer, caps[3], res=h,
            fixed=fixed_sel)
        if sel is not None:
            for st, (i, c) in enumerate(((i0, c0), (i1, c1), (i2, c2),
                                         (i3, c3))):
                _record(sel, layer, st, i, c)
    return h


def token_kernel(h: torch.Tensor, thresholds: torch.Tensor, ws,
                 norm_attn: torch.Tensor, norm_mlp: torch.Tensor,
                 rope: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                 pos: torch.Tensor, *, caps: Tuple[int, int, int, int],
                 n_heads: int, norm_eps: float = 1e-5,
                 window: Optional[int] = None, fixed_sel: bool = False,
                 sel: Optional[torch.Tensor] = None, empty: bool = False,
                 stamps: Optional[torch.Tensor] = None):
    """K7: one token through every layer in one launch (batch 1).

    h:    [D] raw residual stream (the token's embedding), fp32 or bf16
    thresholds: [L, 7] fp32 group thresholds, read on the device
    ws:   (wq, wk, wv, wo, wgate, wup, wdown), [L, K, N] arrays of h's type
    norm_attn/norm_mlp: [L, D] rms_norm gains of h's type
    rope: [1, 2, 128] fp32 (cos, sin) row at pos
    kc/vc: [L, 1, Hkv, T, 128] caches of h's type, updated in place
    pos:  int32 [1] on the device (the kernel traps outside [0, T))
    caps: gather capacities (qkv, o, gate|up, down)
    fixed_sel: keep groups 0..cap-1 at every stage
    sel:  optional int32 [L, 4, 1 + max(caps)]: each stage's kept count
          and groups (-1 past the count)
    empty: launch the kernel with its barriers alone (their floor; no
          output is written)
    stamps: optional int64 [L, K7_STAMPS] on the card: block 0's
          %globaltimer (ns) at each layer's start, at the arrival at and
          the exit from each of the layer's six grid barriers, at each
          gather's start and at three points of attention (`k7_phases`
          reads it)

    Returns the stream after the last layer [D]. On CPU tensors this runs
    `token_kernel_plain`; on a CUDA tensor it launches K7 or raises."""
    L, D, I, Hkv, T = _check_k7(h, thresholds, ws, norm_attn, norm_mlp,
                                rope, kc, vc, pos, caps, n_heads, sel)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive; got {window}")
    if h.device.type == "cpu":
        if empty or stamps is not None:
            raise ValueError("an empty launch and the trace are card "
                             "measurements")
        return token_kernel_plain(h, thresholds, ws, norm_attn, norm_mlp,
                                  rope, kc, vc, pos, caps=caps,
                                  n_heads=n_heads, norm_eps=norm_eps,
                                  window=window, fixed_sel=fixed_sel,
                                  sel=sel)
    _check_launch_device(h, "token_kernel")
    sms = _build.sm_count(h.device.index)
    plan = _token_plan(h.element_size(), D, I, n_heads, Hkv, T, window,
                       max(caps), L, sms)
    if plan is None:
        raise ValueError(f"K7 has no launch plan for D = {D}, I = {I}, "
                         f"{n_heads}/{Hkv} heads, T = {T}, window {window}, "
                         f"caps {tuple(caps)} on {sms} SMs")
    if stamps is not None and (stamps.shape != (L, K7_STAMPS)
                               or stamps.dtype != torch.int64
                               or stamps.device != h.device
                               or not stamps.is_contiguous()):
        raise ValueError(f"stamps must be a contiguous int64 [{L}, "
                         f"{K7_STAMPS}] tensor on h's device")
    lib = _build.load()["token_decode"]
    out = torch.empty_like(h)
    work = torch.empty(plan.ws_bytes, dtype=torch.uint8, device=h.device)
    err = lib.teal_token_decode(
        _DTYPE_CODE[h.dtype], h.data_ptr(), thresholds.data_ptr(),
        pos.data_ptr(), rope.data_ptr(), norm_attn.data_ptr(),
        norm_mlp.data_ptr(), *(w.data_ptr() for w in ws), kc.data_ptr(),
        vc.data_ptr(), out.data_ptr(),
        None if sel is None else sel.data_ptr(),
        None if stamps is None else stamps.data_ptr(), work.data_ptr(), L, D,
        I,
        n_heads, Hkv, T, window or 0, *caps, int(fixed_sel), norm_eps, sms,
        int(empty), torch.cuda.current_stream().cuda_stream)
    if err == -1:
        raise RuntimeError(f"token_kernel: a block of {plan.smem} shared "
                           f"bytes cannot be resident on this card")
    _build.check(err, "token_kernel")
    if not empty:
        token_kernel.launches += 1
    return out


token_kernel.launches = 0

K7_STAMPS = 1 + 2 * _TOK_GRID_BARRIERS + 4 + 5 + 2
K7_PHASES = ("qkv", "attention", "o", "gate|up", "intermediate", "down")


def k7_phases(stamps: torch.Tensor):
    """Microseconds summed over the layers from a K7 trace (`token_kernel`'s
    `stamps`, block 0's clock): for each phase, (block 0's work, from the
    previous grid barrier's exit -- the layer's start for q|k|v -- to its
    arrival at the next; the whole phase, exit to exit); each gather
    stage's prologue (from the phase's start to the gather's start) and,
    within it, the stream update of o and of down (the latter closes a
    layer); attention's spans: the q|k|v sums and RoPE, the scores, the
    maxima's exchange, the weights and PV, the PV's exchange, the
    combine."""
    s = stamps.cpu().double() / 1e3
    G = 1 + 2 * _TOK_GRID_BARRIERS
    A, U = G + 4, G + 9

    def span(a, b):
        return float((s[:, b] - s[:, a]).sum())
    out = {}
    for i, name in enumerate(K7_PHASES):
        start = 0 if i == 0 else 2 * i
        out[name] = (span(start, 1 + 2 * i), span(start, 2 + 2 * i))
    for j, (name, start) in enumerate((("qkv", 0), ("o", 4),
                                       ("gate|up", 6), ("down", 10))):
        out[f"{name} prologue"] = span(start, G + j)
    out["o stream update"] = span(6, U)
    out["down stream update"] = span(12, U + 1)
    for name, a, b in (("sums+rope", 2, A), ("scores", A, A + 3),
                       ("max exchange", A + 3, A + 1),
                       ("weights+pv", A + 1, A + 4),
                       ("pv exchange", A + 4, A + 2),
                       ("combine", A + 2, 3)):
        out[f"attention {name}"] = span(a, b)
    return out
