"""Group-sparse GEMV: selection helpers and kernels K1 and K3.

Port of `teal_tpu/ops/block_gemv.py`. The input dimension is cut into
groups of G rows; selection follows THE unified rule
(docs/KERNEL_NOTES.md "Selection semantics"): in threshold mode a group
is kept if its score (max |x| within the group) clears a calibrated group
threshold, survivors are taken in ascending group order and the first
`cap` kept; in top-k mode the `cap` best-scoring groups are kept, in
ascending order. Only the kept groups' weight slabs `[G, N]` are read.

Two kernels, each launched on CUDA tensors and run as its plain PyTorch
version (same module) on CPU tensors:
  - K1 `select_gather_gemv` (`csrc/select_gather_gemv.cu`): threshold
    selection inside the kernel at G in {32, 64, 128}, one input row (on
    the card a cluster kernel streaming the kept slab rows, planned by
    `_sgg_plan`) or up to 16 rows at G = 128 (pooled scores, one kept
    set; on the card a cluster kernel on the tensor cores, planned by
    `_rows_plan`),
    optional folded rms_norm, 1-3 layer-stacked weights `[L, K, N]`
    sharing one selection, and one of three epilogues;
  - K3 `block_gather_gemv_multi` (`csrc/block_gather_gemv.cu`): the
    gather over a kept-group list selected outside the kernel (top-k
    mode, and batched decode of up to 8 rows with one pooled selection).
`project_many` / `project_many_batched` pick between them as the
reference does.

Both kernels take the reference's three weight plans (`_WeightPlan`,
`teal_tpu/ops/block_gemv.py:82`), one plan for all weights of a call:
  - weights of the stream type (bf16/fp32);
  - int8 `[L, K, N]`, converted to fp32 in the kernel. The per-output-
    channel scale of an int8 dict {"q","scale"} goes on the fp32 sums:
    after the kernel in `project_many` (as in the reference), or inside
    K1's epilogue with `scales` (the token path, as the whole-token
    kernel's `scale_ref` does), before the residual, silu or RoPE;
  - packed int4 {"qp" int8 [L, K/2, N], "sz" fp32 [L, K/G, 2, N]} at
    G >= 64 (quant group == gather group): a byte holds row l of a group
    in its low nibble and row l + G/2 in its high nibble, and each kept
    group's affine is factored through the sum,
    (x @ nib) * scale_g + sum(x) * zero_g (`quant.pack_int4`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from teal_tpu_torch import _build
from teal_tpu_torch.ops.sparsify import group_capacity

LANES = 128
SUBLANES = 8
MAX_ROWS = 16                    # K1's rows form: batched token decode
GROUP_SIZES = (32, 64, 128)      # the kernels' compiled group sizes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def effective_block_size(G: int, K: int) -> int:
    """The group size the reference's kernels run at for a requested G and
    input dim K: clamped to the largest power-of-two divisor of K that is
    <= G, then doubled (up to 128) while K // G > 256."""
    g = G
    while g > 1 and (g > K or K % g):
        g //= 2
    while K // g > 256 and K % (g * 2) == 0 and g < LANES:
        g *= 2
    return g


def block_capacity(nb: int, keep_frac: Optional[float]) -> int:
    """Static gather capacity of `nb` groups at `keep_frac` (0.625 when
    unset): `max(1, min(nb, round(nb * keep)))`."""
    return group_capacity(nb, keep_frac if keep_frac else 0.625)


def _weight_kind(w) -> str:
    """"int4" (packed {"qp","sz"}), "int8" ({"q","scale"}) or "array"."""
    if isinstance(w, dict) and "qp" in w:
        return "int4"
    if isinstance(w, dict):
        if "zero" in w:
            raise ValueError("unpacked int4 {'q','scale','zero'} weights "
                             "take no gather kernel: pack them with "
                             "quant.pack_int4_params")
        return "int8"
    return "array"


def _shared_group_size(ws, block_size: int, K: int) -> int:
    """Gather group size for a projection set: any packed int4 weight
    raises G to >= 64 (quant group == gather group)."""
    G = effective_block_size(block_size, K)
    if any(_weight_kind(w) == "int4" for w in ws):
        G = max(64, G)
    return G


def _kernel_operands(ws):
    """(kernel operands, int8 scales to apply after the kernel or None)."""
    raw, scales = [], []
    for w in ws:
        int8 = _weight_kind(w) == "int8"
        raw.append(w["q"] if int8 else w)
        scales.append(w["scale"] if int8 else None)
    return raw, scales


def _width(w) -> int:
    """Output width N of a kernel operand."""
    return (w["qp"] if isinstance(w, dict) else w).shape[-1]


def group_scores(x: torch.Tensor, G: int) -> torch.Tensor:
    """Per-group max-|x| score. x: [1, K] -> [K//G]."""
    return x.abs().reshape(-1, G).amax(dim=-1)


def _threshold_mask(scores: torch.Tensor, threshold, k_keep: int):
    surv = scores > threshold
    return surv & (torch.cumsum(surv.to(torch.int32), dim=-1) <= k_keep)


def _kept_in_order(mask: torch.Tensor, k_keep: int):
    """Kept group indices in ascending order, padded to min(k_keep, nb)
    slots with index 0; returns (idx, pad)."""
    nb = mask.shape[-1]
    order = torch.where(mask, torch.arange(nb, device=mask.device), nb)
    idx = torch.sort(order).values[: min(k_keep, nb)]
    pad = idx >= nb
    return torch.where(pad, 0, idx), pad


def select_groups(x: torch.Tensor, G: int, k_keep: int, threshold=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selection as K3 inputs for one row x [1, K]: top-k mode
    (`threshold=None`, every group when k_keep >= nb) or threshold mode.
    Returns (idx [k] int32 ascending, xpack [k, 1, 128]: kept group j's
    values in lanes [:G]); padded slots carry index 0 and zero values,
    as in the reference."""
    nb = x.shape[-1] // G
    if k_keep >= nb and threshold is None:
        idx = torch.arange(nb, device=x.device)
        xg = x.reshape(nb, G)
    elif threshold is not None:
        mask = _threshold_mask(group_scores(x, G), threshold, k_keep)
        idx, pad = _kept_in_order(mask, k_keep)
        xg = x.reshape(nb, G)[idx]
        xg = torch.where(pad[:, None], torch.zeros_like(xg), xg)
    else:
        idx = torch.sort(torch.topk(group_scores(x, G), k_keep).indices).values
        xg = x.reshape(nb, G)[idx]
    xpack = torch.zeros((xg.shape[0], LANES), dtype=x.dtype, device=x.device)
    xpack[:, :G] = xg
    return idx.to(torch.int32), xpack.reshape(-1, 1, LANES)


def _pooled_scores(x: torch.Tensor, G: int) -> torch.Tensor:
    B, K = x.shape
    return x.abs().reshape(B, K // G, G).amax(dim=-1).amax(dim=0)


def select_groups_batched(x: torch.Tensor, G: int, k_keep: int,
                          threshold=None):
    """Batched (B <= 8) selection: one kept set for the batch, picked by
    the max score across the batch (with `threshold`, the unified rule on
    that pooled score). Returns (idx [k] int32, xpack [k, 8, 128]: row b
    carries sequence b's values in lanes [:G], rows >= B zero)."""
    B, K = x.shape
    if B > SUBLANES:
        raise ValueError(f"batched selection takes at most {SUBLANES} rows; "
                         f"got {B}")
    nb = K // G
    pooled = _pooled_scores(x, G)
    if threshold is not None:
        idx, pad = _kept_in_order(_threshold_mask(pooled, threshold, k_keep),
                                  k_keep)
        xg = x.reshape(B, nb, G)[:, idx]
        xg = torch.where(pad[None, :, None], torch.zeros_like(xg), xg)
    else:
        idx = torch.sort(torch.topk(pooled, k_keep).indices).values
        xg = x.reshape(B, nb, G)[:, idx]
    xpack = torch.zeros((idx.shape[0], SUBLANES, LANES), dtype=x.dtype,
                        device=x.device)
    xpack[:, :B, :G] = xg.transpose(0, 1)
    return idx.to(torch.int32), xpack


def batched_group_mask(x: torch.Tensor, G: int, k_keep: int,
                       threshold=None) -> torch.Tensor:
    """Semantics twin of the batched selection: [1, K] keep mask."""
    pooled = _pooled_scores(x, G)
    if threshold is not None:
        mask = _threshold_mask(pooled, threshold, k_keep)
    else:
        mask = torch.zeros_like(pooled, dtype=torch.bool)
        mask[torch.topk(pooled, k_keep).indices] = True
    return mask.repeat_interleave(G)[None, :]


def block_sparse_matmul_reference(x: torch.Tensor, w: torch.Tensor,
                                  threshold, block_size: int = 32,
                                  keep_frac: Optional[float] = None):
    """Semantics twin of the block kernel: the unified selection rule (or
    top-k with `threshold=None`), then a dense matmul with fp32 sums."""
    K, N = w.shape
    G = effective_block_size(block_size, K)
    nb = K // G
    k_keep = block_capacity(nb, keep_frac)
    lead = x.shape[:-1]
    xf = x.reshape(1, K)
    s = group_scores(xf, G)
    if threshold is not None:
        mask = _threshold_mask(s, threshold, k_keep)
    else:
        mask = torch.zeros(nb, dtype=torch.bool, device=x.device)
        mask[torch.topk(s, k_keep).indices] = True
    xm = torch.where(mask.repeat_interleave(G)[None, :], xf,
                     torch.zeros_like(xf))
    y = torch.matmul(xm.float(), w.float()).to(x.dtype)
    return y.reshape(*lead, N)


def _split(y: torch.Tensor, raw, scales, layer: int, dtype,
           lead) -> List[torch.Tensor]:
    """Cut a kernel's fp32 output [..., n_tot] into one tensor per weight,
    each times its int8 scale at `layer` (where it has one), cast to
    `dtype` and shaped lead + [N_i]."""
    outs = torch.split(y, [_width(w) for w in raw], dim=-1)
    return [(o if s is None else o * s[layer]).to(dtype)
            .reshape(*lead, o.shape[-1]) for o, s in zip(outs, scales)]


def block_sparse_matmul(x: torch.Tensor, w: torch.Tensor, threshold,
                        block_size: int = 32,
                        keep_frac: Optional[float] = None):
    """Sparse projection for one decode row. x: [..., 1, K]; w: [K, N].
    Selection in PyTorch (top-k, or threshold with `threshold`), then
    K3 over the kept groups, as the reference does."""
    K, N = w.shape
    G = effective_block_size(block_size, K)
    k_keep = block_capacity(K // G, keep_frac)
    idx, xpack = select_groups(x.reshape(1, K), G, k_keep, threshold)
    y = block_gather_gemv_multi(idx, xpack, [w[None]], 0, G, 1)
    return y.to(x.dtype).reshape(*x.shape[:-1], N)


def project_many(x: torch.Tensor, ws, block_size: int = 32,
                 keep_frac: Optional[float] = None, layer: int = 0,
                 threshold=None, norm: Optional[torch.Tensor] = None,
                 norm_eps: float = 1e-5) -> List[torch.Tensor]:
    """Block-sparse projections of one decode row through weights sharing
    its selection. x: [..., K] with one row; ws: layer-stacked weights
    read at `layer`: [L, K, N_i] arrays, int8 dicts {"q" [L, K, N_i],
    "scale" [L, N_i]} or packed int4 dicts {"qp", "sz"}. Threshold mode
    runs K1 with the selection inside the kernel (and, with `norm`
    [L, K], the folded rms_norm: x is then the raw stream); top-k mode
    selects in PyTorch and runs K3. Returns one [..., N_i] tensor per
    weight: the fp32 sums, times the int8 scale, cast to x's type."""
    K = x.shape[-1]
    G = _shared_group_size(ws, block_size, K)
    k_keep = block_capacity(K // G, keep_frac)
    raw, scales = _kernel_operands(ws)
    if threshold is not None:
        thr = torch.as_tensor(threshold, dtype=torch.float32,
                              device=x.device).reshape(())
        y = fused_select_gather_gemv(x.reshape(K).contiguous(), thr, raw,
                                     layer, G, k_keep, norm=norm,
                                     norm_eps=norm_eps)
    elif norm is not None:
        raise ValueError("the norm fold needs threshold mode")
    else:
        idx, xpack = select_groups(x.reshape(1, K), G, k_keep)
        y = block_gather_gemv_multi(idx, xpack, raw, layer, G, 1)[0]
    return _split(y, raw, scales, layer, x.dtype, x.shape[:-1])


def project_many_batched(x: torch.Tensor, ws, block_size: int = 32,
                         keep_frac: Optional[float] = None, layer: int = 0,
                         threshold=None) -> List[torch.Tensor]:
    """Batched (B <= 8) block-sparse projections: one pooled selection for
    the batch (`select_groups_batched`), then K3 with B rows. x: [B, K];
    ws as in `project_many`; returns one [B, N_i] tensor per weight in
    x's type."""
    B, K = x.shape
    G = _shared_group_size(ws, block_size, K)
    k_keep = block_capacity(K // G, keep_frac)
    raw, scales = _kernel_operands(ws)
    idx, xpack = select_groups_batched(x, G, k_keep, threshold)
    y = block_gather_gemv_multi(idx, xpack, raw, layer, G, B)
    return _split(y, raw, scales, layer, x.dtype, (B,))


# Weight plans of the kernels' operands (one plan for all weights of a
# call): 0 the stream type, 1 int8, 2 packed int4 {"qp", "sz"}
PLAN_STREAM, PLAN_INT8, PLAN_INT4 = 0, 1, 2


def _plan(w) -> int:
    if isinstance(w, dict):
        return PLAN_INT4
    return PLAN_INT8 if w.dtype == torch.int8 else PLAN_STREAM


def _in_dim(w) -> int:
    """Input dim K of a layer-stacked kernel operand."""
    return 2 * w["qp"].shape[1] if isinstance(w, dict) else w.shape[1]


def _check_weights(ws, K: int, dtype, device, G: int) -> Tuple[int, int]:
    """Shared checks of 1-3 layer-stacked kernel operands of one plan at
    group size G; returns (L, plan)."""
    if not 1 <= len(ws) <= 3:
        raise ValueError(f"1-3 weights share one selection; got {len(ws)}")
    if not all(isinstance(w, torch.Tensor) or (isinstance(w, dict)
               and set(w) == {"qp", "sz"}) for w in ws):
        raise ValueError("weights are tensors or packed int4 dicts "
                         "{'qp', 'sz'}")
    plans = {_plan(w) for w in ws}
    if len(plans) != 1:
        raise ValueError("the weights of one call share one weight plan")
    plan = plans.pop()
    if plan == PLAN_INT4 and G < 64:
        raise ValueError(f"packed int4 needs G >= 64; got {G}")
    L = (ws[0]["qp"] if plan == PLAN_INT4 else ws[0]).shape[0]
    for w in ws:
        if plan == PLAN_INT4:
            qp, sz = w["qp"], w["sz"]
            ok = (qp.dim() == 3 and qp.shape[:2] == (L, K // 2)
                  and qp.dtype == torch.int8
                  and sz.shape == (L, K // G, 2, qp.shape[2])
                  and sz.dtype == torch.float32)
            tensors, want = (qp, sz), "int8 qp [L, K/2, N], fp32 sz " \
                                      "[L, K/G, 2, N]"
        else:
            ok = (w.dim() == 3 and w.shape[:2] == (L, K)
                  and w.dtype == (torch.int8 if plan else dtype))
            tensors, want = (w,), f"[L, {K}, N] of type {dtype} or int8"
        ok = ok and _width(w) % 32 == 0 and all(
            t.device == device and t.is_contiguous() and t.data_ptr() % 16
            == 0 for t in tensors)
        if not ok:
            raise ValueError(
                f"weights must be contiguous, 16-byte aligned stacks on "
                f"{device} with N % 32 == 0 ({want}); got "
                + ", ".join(f"{t.dtype} {tuple(t.shape)} on {t.device}"
                            for t in tensors))
    return L, plan


def _slab_sums(xg: torch.Tensor, w, layer: int, gidx: torch.Tensor,
               G: int) -> torch.Tensor:
    """fp32 sums of one weight over kept groups, the reference's
    arithmetic (`_accumulate`): xg [rows, k, G] the kept groups' inputs,
    gidx [k] their indices. Stream-type and int8 slabs are converted
    (exactly) and multiplied; packed int4 factors each group's affine
    through its sum, (x @ nib) * scale + sum(x) * zero. Returns
    [rows, N]."""
    xg = xg.float()
    if isinstance(w, dict):
        qp = w["qp"][layer]
        N = qp.shape[-1]
        pk = qp.reshape(-1, G // 2, N)[gidx].to(torch.int32)
        nib = torch.cat([pk & 15, (pk >> 4) & 15], dim=1).float()
        sz = w["sz"][layer][gidx]                          # [k, 2, N]
        terms = (torch.einsum("rkg,kgn->rkn", xg, nib) * sz[None, :, 0]
                 + xg.sum(-1)[..., None] * sz[None, :, 1])
    else:
        N = w.shape[-1]
        slabs = w[layer].reshape(-1, G, N)[gidx].float()
        terms = torch.einsum("rkg,kgn->rkn", xg, slabs)
    return terms.sum(dim=1)


def _check_launch_device(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda" or t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name} runs on the current CUDA device or the "
                         f"CPU; got {t.device}")


# --- K1 -------------------------------------------------------------------

# K1's rows form on the card (`csrc/select_gather_gemv.cu`, `RowsLayout`
# and `rows_plan`, which `_rows_smem` and `_rows_plan` mirror; the card
# tests hold them together through `teal_sgg_rows_plan`)
ROWS_TILE = 64                   # output columns a block
_ROWS_WARPS = 8
_ROWS_MAX_CLUSTER = 8            # blocks a cluster (the portable size)
_ROWS_MAX_SPLITS = 4             # splits of a tile's kept groups
_ROWS_MAX_STAGES = 8             # ring stages
_SMEM_BYTES = 232448             # a block's shared memory on Hopper
_SM_SMEM_BYTES = 233472          # an SM's; a resident block reserves 1 KB
_H100_SMS = 132


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def _rows_smem(esz: int, plan: int, nw: int, stages: int, S: int, C: int,
               nb: int, cap: int) -> int:
    """One block's shared memory in bytes: a ring of `stages` stages, each
    one kept group's `nw` weight slabs (rows padded by 16 bytes; packed
    int4 64 rows and the group's scale and zero rows), its 16 input rows
    (padded likewise) and its gains, or the per-warp sums if larger; with
    S > 1 the split parts the block combines; the C peers' norm partials,
    the row scales, the nb scores and the cap kept groups and count."""
    wrows = LANES // 2 if plan == PLAN_INT4 else LANES
    wstride = ROWS_TILE * (esz if plan == PLAN_STREAM else 1) + 16
    wslab = wrows * wstride + (2 * ROWS_TILE * 4 if plan == PLAN_INT4 else 0)
    stage = nw * wslab + MAX_ROWS * (LANES * esz + 16) + LANES * esz
    sums = nw * MAX_ROWS * ROWS_TILE * 4
    return (max(stages * stage, _ROWS_WARPS * sums) + (sums if S > 1 else 0)
            + (C + 1) * MAX_ROWS * 4 + _pad4(nb) * 4 + _pad4(cap + 1) * 4)


def _rows_plan(esz: int, plan: int, nw: int, K: int, n_out: int, cap: int,
               n_sms: int = _H100_SMS) -> Optional[Tuple[int, int, int, int]]:
    """The rows kernel's launch plan from shapes only: (S, C, stages,
    shared bytes), or None where the widths are not whole 64-column tiles
    or nothing fits. S (1, 2 or 4) splits each tile's kept groups: the
    largest that keeps the grid within one block an SM. C = S * (tiles a
    cluster) <= 8: the largest power of two whose tiles divide the output.
    The ring is the deepest (<= 8 stages) that leaves room for two blocks
    an SM (clusters of 8 blocks of one an SM do not all fit the H100's
    GPCs at once), else the deepest that fits one block."""
    if n_out <= 0 or n_out % ROWS_TILE or K % LANES:
        return None
    tiles = n_out // ROWS_TILE
    S = 1
    while S < _ROWS_MAX_SPLITS and tiles * 2 * S <= n_sms:
        S *= 2
    tc = 1
    while tc * 2 * S <= _ROWS_MAX_CLUSTER and tiles % (tc * 2) == 0:
        tc *= 2
    for two in (True, False):
        for stages in range(_ROWS_MAX_STAGES, 1, -1):
            smem = _rows_smem(esz, plan, nw, stages, S, tc * S, K // LANES,
                              cap)
            if (2 * (smem + 1024) <= _SM_SMEM_BYTES if two
                    else smem <= _SMEM_BYTES):
                return S, tc * S, stages, smem
    return None


# K1's single row on the card (`csrc/select_gather_gemv.cu`, `StreamLayout`
# and `sgg_plan`, which `_sgg_smem` and `_sgg_plan` mirror; the card tests
# hold them together through `teal_sgg_plan`)
_SGG_PIECE = 256                 # bytes of a slab row a block reads
_SGG_STAGES = 8                  # ring stages
_SGG_MAX_SPLITS = 8              # splits of a tile's kept groups
_SGG_MAX_CLUSTER = 8             # blocks a cluster
_SGG_THREADS = 256


def _sgg_tile(esz: int, plan: int) -> int:
    """The single row's tile: 256 bytes of each slab row, in columns."""
    return _SGG_PIECE // (esz if plan == PLAN_STREAM else 1)


def _sgg_smem(esz: int, plan: int, nw: int, G: int, nb: int,
              cap: int) -> int:
    """The single row's shared memory in bytes: the ring (8 stages of a
    16-byte chunk of each of the `nw` weights a thread), a chunk's
    selection inputs (2048 values, or 8 groups for packed int4) of the
    stream type, (int4) its groups' scale and zero rows of the tile, the
    kept groups and count, the nb scores, 64 floats of scratch (the
    block's sum, the peers' norm partials) and the S splits' fp32 sums of
    the block's tile / S columns."""
    tw = _sgg_tile(esz, plan)
    cg = 8 if plan == PLAN_INT4 else 2048 // G
    return (_SGG_STAGES * nw * _SGG_THREADS * 16 + cg * G * esz
            + (cg * nw * 2 * tw * 4 if plan == PLAN_INT4 else 0)
            + _pad4(cap + 1) * 4 + _pad4(nb) * 4 + 64 * 4 + nw * tw * 4)


def _sgg_plan(esz: int, plan: int, nw: int, G: int, ns, K: int, cap: int,
              n_sms: int = _H100_SMS) -> Optional[Tuple[int, int, int, int]]:
    """K1's single-row launch plan from shapes only: (S, C, ring stages,
    shared bytes), or None where the shapes take none. A block reads a
    256-byte tile of each slab row (`nw` = 2: the same columns of gate
    and up), sum of ceil(N_i / tile) tiles (mode 2: of gate's width); S
    (a power of two <= 8) splits each tile's kept groups, the largest
    keeping the grid within one block an SM; a cluster of C = S * (tiles
    a cluster) <= 8 blocks shares the prologue (the largest power of two
    whose tiles divide the grid's)."""
    if G <= 0 or K <= 0 or K % G or not 1 <= cap <= K // G:
        return None
    tw = _sgg_tile(esz, plan)
    tiles = (-(-ns[0] // tw) if nw == 2
             else sum(-(-n // tw) for n in ns))
    smem = _sgg_smem(esz, plan, nw, G, K // G, cap)
    if tiles <= 0 or smem > _SMEM_BYTES:
        return None
    S = 1
    while S < _SGG_MAX_SPLITS and tiles * 2 * S <= n_sms:
        S *= 2
    tc = 1
    while tc * 2 * S <= _SGG_MAX_CLUSTER and tiles % (tc * 2) == 0:
        tc *= 2
    return S, tc * S, _SGG_STAGES, smem


def selection_input(x, norm, layer: int, norm_eps: float):
    """What K1 scores and gathers with, for x [K] or rows [B, K]: x
    itself, or with `norm` its folded rms_norm (each row by the rsqrt of
    its own mean square, `_norm_fold`), rounded to the stream type before
    and after the gain as `llama.rms_norm` does."""
    if norm is None:
        return x
    xf = x.float()
    scale = torch.rsqrt((xf * xf).sum(-1, keepdim=True) / x.shape[-1]
                        + norm_eps)
    return (xf * scale).to(x.dtype) * norm[layer].to(x.dtype)


def select_gather_gemv_plain(x, thr, ws, layer, cap: int, *,
                             G: int = LANES, norm=None,
                             norm_eps: float = 1e-5, res=None,
                             silu: bool = False, scales=None,
                             fixed: bool = False, slot: int = 0,
                             route_w=None):
    """K1 in plain PyTorch (same arguments and results as
    `select_gather_gemv`). Keeps the reference's cast points: the folded
    norm rounds to the stream type before and after the gain; scores,
    sums, int8 scales and epilogues are fp32, the weighted residual
    rounding the product before the sum. A group's score is its max |x|
    over lanes and rows (`_select_scan`); one kept set serves every row.
    A device layer is read to the host here (this version is no fast
    path)."""
    dt = x.dtype
    if isinstance(layer, torch.Tensor):
        layer = int(layer[slot])
    rows = x.reshape(-1, x.shape[-1])
    nb = rows.shape[1] // G
    xs = selection_input(rows, norm, layer, norm_eps)
    if fixed:
        kept = torch.arange(cap, device=x.device)
    else:
        scores = xs.float().abs().reshape(-1, nb, G).amax(dim=-1).amax(dim=0)
        kept = torch.nonzero(_threshold_mask(scores, thr, cap)).flatten()
    count = kept.numel()
    idx = torch.full((cap,), -1, dtype=torch.int32, device=x.device)
    idx[:count] = kept.to(torch.int32)
    xg = xs.reshape(-1, nb, G)[:, kept]                       # [B, k, G]
    accs = [_slab_sums(xg, w, layer, kept, G) for w in ws]    # [B, N_i]
    if scales is not None:
        accs = [a * s[layer] for a, s in zip(accs, scales)]
    if silu:
        g, u = accs
        out = (g * (1.0 / (1.0 + torch.exp(-g))) * u).to(dt)
    elif route_w is not None:
        out = (accs[0] * route_w[slot]
               + res.reshape(accs[0].shape).float()).to(dt)
    elif res is not None:
        out = (accs[0] + res.reshape(accs[0].shape).float()).to(dt)
    else:
        out = torch.cat(accs, dim=-1)
    return (out.reshape(*x.shape[:-1], out.shape[-1]), idx,
            torch.tensor([count], dtype=torch.int32, device=x.device))


def _check_sgg(x, thr, ws, layer, cap, G, norm, res, silu, scales, slot,
               route_w):
    if (x.dtype not in _DTYPE_CODE or x.dim() not in (1, 2)
            or not x.is_contiguous()
            or (x.dim() == 2 and not 1 <= x.shape[0] <= MAX_ROWS)):
        raise ValueError(f"x must be a contiguous fp32/bf16 vector [K] or "
                         f"rows [B <= {MAX_ROWS}, K]; got {x.dtype} "
                         f"{tuple(x.shape)}")
    K = x.shape[-1]
    if G not in GROUP_SIZES or K % G:
        raise ValueError(f"group size {G} must be one of {GROUP_SIZES} and "
                         f"divide K={K}")
    if x.dim() == 2 and x.shape[0] > 1 and G != LANES:
        raise ValueError(f"the rows form runs at G = {LANES}; got G = {G}")
    L, plan = _check_weights(ws, K, x.dtype, x.device, G)
    if scales is not None and (
            plan != PLAN_INT8 or len(scales) != len(ws)
            or not all(s.shape == (L, _width(w)) and s.dtype == torch.float32
                       and s.device == x.device and s.is_contiguous()
                       for s, w in zip(scales, ws))):
        raise ValueError("scales are one contiguous fp32 [L, N_i] stack per "
                         "int8 weight")
    if isinstance(layer, torch.Tensor):
        # checked on the card by the kernel, which traps outside [0, L)
        if (layer.dtype != torch.int32 or layer.dim() != 1
                or not 0 <= slot < layer.numel() or layer.device != x.device
                or not layer.is_contiguous()):
            raise ValueError(f"a device layer is a contiguous int32 vector "
                             f"on x's device with an entry at slot {slot}")
        if norm is not None or x.dim() != 1:
            raise ValueError("a device layer takes one row and no norm "
                             "(the norm is indexed by the real layer)")
    elif not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    if not 1 <= cap <= K // G:
        raise ValueError(f"cap {cap} out of range [1, {K // G}]")
    if (thr.dtype != torch.float32 or thr.numel() != 1
            or thr.device != x.device):
        raise ValueError("thr must be one fp32 value on x's device")
    if norm is not None and (norm.shape != (L, K) or norm.dtype != x.dtype
                             or norm.device != x.device
                             or not norm.is_contiguous()):
        raise ValueError(f"norm must be a contiguous [L, K] stack of x's "
                         f"type; got {norm.dtype} {tuple(norm.shape)}")
    if silu and (len(ws) != 2 or _width(ws[0]) != _width(ws[1])
                 or res is not None):
        raise ValueError("silu needs exactly (gate, up) of equal width and "
                         "no residual")
    if res is not None:
        shape = (*x.shape[:-1], sum(_width(w) for w in ws))
        if (res.shape != shape or res.dtype != x.dtype
                or res.device != x.device or not res.is_contiguous()):
            raise ValueError(f"res must be a contiguous {list(shape)} tensor "
                             f"of x's type")
    if route_w is not None and (
            res is None or x.dim() != 1 or route_w.dtype != torch.float32
            or route_w.dim() != 1 or not 0 <= slot < route_w.numel()
            or route_w.device != x.device or not route_w.is_contiguous()):
        raise ValueError(f"route_w (the weighted residual) is a contiguous "
                         f"fp32 vector on x's device with an entry at slot "
                         f"{slot}, with res and one row")
    return L, plan


def _ptrs(ws, plan: int, scales):
    """The C interface's weight, sz and scale pointers (3 each, null where
    absent)."""
    pad = [None] * (3 - len(ws))
    w = [(t["qp"] if plan == PLAN_INT4 else t).data_ptr() for t in ws]
    sz = [t["sz"].data_ptr() if plan == PLAN_INT4 else None for t in ws]
    sc = [None] * len(ws) if scales is None else [s.data_ptr() for s in scales]
    return w + pad, sz + pad, sc + pad


def select_gather_gemv(x: torch.Tensor, thr: torch.Tensor, ws, layer,
                       cap: int, *, G: int = LANES,
                       norm: Optional[torch.Tensor] = None,
                       norm_eps: float = 1e-5,
                       res: Optional[torch.Tensor] = None,
                       silu: bool = False, scales=None,
                       fixed: bool = False, slot: int = 0,
                       route_w: Optional[torch.Tensor] = None):
    """K1: select + gather GEMV over layer `layer` of stacked weights.

    x:    [K] stream, or rows [B, K] with B <= 16 at G = 128 (raw when
          `norm` is given, which folds rms_norm in, row by row); rows
          share one kept set, picked by each group's max |x| over the rows
    thr:  one fp32 group-score threshold (a 0-d view into the [L, 7]
          table works: the kernel reads it on the device)
    ws:   1-3 weights sharing one selection and one plan: [L, K, N_i] of
          x's type, int8 [L, K, N_i], or packed int4 {"qp" int8
          [L, K/2, N_i], "sz" fp32 [L, K/G, 2, N_i]} (G >= 64)
    G:    group size, one of `GROUP_SIZES`
    norm: [L, K] rms_norm gains; res: residual of out's shape, added in
          fp32
    silu: ws = (gate, up): out = silu(gate) * up
    scales: int8 only, one fp32 [L, N_i] per-channel scale per weight,
          applied to the fp32 sums before the epilogue
    fixed: keep groups 0..cap-1 without scoring (`_select_scan(fixed)`,
          the verify path's identity selection at full capacity)
    layer: a host int, or (MoE, one row, no norm) an int32 device vector
          whose entry `slot` the kernel reads: the pseudo-layers l*E + e
          of the router (`token_block.moe_route`) into expert stacks read
          as [L*E, K, N], so that the host never waits for the routing
    route_w: with res, the MoE expert's weighted residual (mode 3): out =
          (sums * route_w[slot] + res) in fp32, cast to x's type, the
          reference's `write_down_weighted`

    Returns (out, idx, count): out is fp32 [..., sum N_i] (no epilogue)
    or x's type [..., N] (res / silu), with x's leading shape; idx [cap]
    int32 holds the kept groups in ascending order, -1 past `count` ([1]
    int32).
    """
    L, plan = _check_sgg(x, thr, ws, layer, cap, G, norm, res, silu, scales,
                         slot, route_w)
    if x.device.type == "cpu":
        return select_gather_gemv_plain(x, thr, ws, layer, cap, G=G,
                                        norm=norm, norm_eps=norm_eps,
                                        res=res, silu=silu, scales=scales,
                                        fixed=fixed, slot=slot,
                                        route_w=route_w)
    _check_launch_device(x, "select_gather_gemv")
    mode = (2 if silu else 3 if route_w is not None
            else 1 if res is not None else 0)
    dev_layer = isinstance(layer, torch.Tensor)
    n = [_width(w) for w in ws]
    n_out = n[0] if silu else sum(n)
    rows = x.numel() // x.shape[-1]
    lib = _build.load()["select_gather_gemv"]
    sms = _build.sm_count(x.device.index)
    nw = 2 if silu else 1
    if rows > 1:
        if _rows_plan(x.element_size(), plan, nw, x.shape[-1], n_out, cap,
                      sms) is None or any(n_i % ROWS_TILE for n_i in n):
            raise ValueError(f"the rows kernel takes widths that are "
                             f"multiples of {ROWS_TILE} and a plan that fits "
                             f"shared memory; got widths {n}, K = "
                             f"{x.shape[-1]}, cap {cap}")
    elif _sgg_plan(x.element_size(), plan, nw, G, n, x.shape[-1], cap,
                   sms) is None:
        raise ValueError(f"the single-row kernel has no plan that fits "
                         f"shared memory for widths {n}, K = {x.shape[-1]}, "
                         f"G = {G}, cap {cap}")
    if x.data_ptr() % 16 or (norm is not None and norm.data_ptr() % 16):
        raise ValueError("K1 reads x and norm in 16-byte chunks: both must "
                         "be 16-byte aligned")
    out = torch.empty((*x.shape[:-1], n_out), device=x.device,
                      dtype=torch.float32 if mode == 0 else x.dtype)
    sel = torch.empty(cap + 1, dtype=torch.int32, device=x.device)
    w_p, sz_p, sc_p = _ptrs(ws, plan, scales)
    n += [0] * (3 - len(ws))
    err = lib.teal_select_gather_gemv(
        _DTYPE_CODE[x.dtype], plan, x.data_ptr(), thr.data_ptr(),
        None if norm is None else norm.data_ptr(), norm_eps,
        *w_p, *sz_p, *sc_p, *n, len(ws),
        None if res is None else res.data_ptr(),
        out.data_ptr(), sel.data_ptr(), sel.data_ptr() + 4 * cap,
        x.shape[-1], G, 0 if dev_layer else layer, cap, mode, rows,
        int(fixed),
        layer.data_ptr() if dev_layer else None, slot, L,
        None if route_w is None else route_w.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err == -1:
        raise RuntimeError(f"select_gather_gemv: no cluster of the rows "
                           f"kernel's plan (K = {x.shape[-1]}, {n_out} "
                           f"columns) can be resident on this card")
    _build.check(err, "select_gather_gemv")
    select_gather_gemv.launches += 1
    return out, sel[:cap], sel[cap:]


select_gather_gemv.launches = 0


def fused_select_gather_gemv(x: torch.Tensor, thr: torch.Tensor, ws,
                             layer: int, G: int, cap: int,
                             norm: Optional[torch.Tensor] = None,
                             norm_eps: float = 1e-5) -> torch.Tensor:
    """The reference's `fused_select_gather_gemv`: K1 with no epilogue at
    group size G. Returns the fp32 sums [sum N_i]."""
    return select_gather_gemv(x, thr, ws, layer, cap, G=G, norm=norm,
                              norm_eps=norm_eps)[0]


# --- K3 -------------------------------------------------------------------

# K3's launch plans on the card (`csrc/block_gather_gemv.cu`, `full_plan`,
# `StreamLayout` and `Layout`, which `_bgg_plan`, `_bgg_stream_smem` and
# `_bgg_smem` mirror; the card tests hold them together through
# `teal_block_gather_plan`). Two forms: the one-row stream (R = 1) and the
# rows form on the tensor cores (R = 8).
BGG_TILE = 64                    # the rows form's output columns a block
_BGG_STAGE_ROWS = 128            # the rows form's slab rows a ring stage
_BGG_MAX_SPLITS = 8              # blocks a cluster
_BGG_PIECE = 256                 # the one-row form's bytes of a slab row
_BGG_STREAM_STAGES = 8


def _bgg_smem(esz: int, plan: int, G: int, stages: int, S: int,
              jmax: int) -> int:
    """The rows form's shared memory in bytes: a ring of `stages` stages,
    each 128 slab rows of the tile (rows padded by 16 bytes; packed int4:
    64 rows and each group's scale and zero rows) and 16 input rows
    (padded likewise), or the per-warp sums if larger; with S > 1 the
    split parts the block combines; the block's `jmax` kept groups."""
    wrows = _BGG_STAGE_ROWS // 2 if plan == PLAN_INT4 else _BGG_STAGE_ROWS
    wstride = BGG_TILE * (esz if plan == PLAN_STREAM else 1) + 16
    wslab = wrows * wstride + (_BGG_STAGE_ROWS // G * 2 * BGG_TILE * 4
                               if plan == PLAN_INT4 else 0)
    stage = wslab + MAX_ROWS * (LANES * esz + 16)
    sums = _ROWS_WARPS * MAX_ROWS * BGG_TILE * 4
    return (max(stages * stage, sums)
            + (MAX_ROWS * BGG_TILE * 4 if S > 1 else 0) + _pad4(jmax) * 4)


def _bgg_stream_tile(esz: int, plan: int) -> int:
    """The one-row form's tile: 256 bytes of each slab row, in columns."""
    return _BGG_PIECE // (esz if plan == PLAN_STREAM else 1)


def _bgg_stream_smem(esz: int, plan: int, G: int) -> int:
    """The one-row form's shared memory in bytes: the ring (8 stages of a
    16-byte chunk a thread), a chunk's input values (2048, or 1024 for
    packed int4) of the stream type, (int4) its groups' scale and zero
    rows of the tile, its kept groups and the block's fp32 sums."""
    tw = _bgg_stream_tile(esz, plan)
    xs = 1024 if plan == PLAN_INT4 else 2048
    cg = xs // G
    return (_BGG_STREAM_STAGES * 256 * 16 + xs * esz
            + (cg * 2 * tw * 4 if plan == PLAN_INT4 else 0) + _pad4(cg) * 4
            + tw * 4)


def _bgg_plan(esz: int, plan: int, G: int, ns, k_keep: int, R: int,
              n_sms: int = _H100_SMS) -> Optional[Tuple[int, int, int, int]]:
    """K3's launch plan from shapes only: (form, S, ring stages, shared
    bytes), or None where nothing fits. R (xpack's rows) picks the form:
    0, the one-row stream (R = 1: a block reads 256 bytes of each slab row
    of its tile, sum of ceil(N_i / tile) tiles, 8 stages); 1, the rows
    form on the tensor cores (R = 8: 64-column tiles; the deepest ring,
    <= 8 stages, that leaves room for two blocks an SM, else that fits
    one block). A block takes one of S contiguous shares of the kept list
    (`gather_gemv.split_range`); S (the cluster) is the largest power of
    two <= 8 keeping the grid within one block an SM."""
    tw = _bgg_stream_tile(esz, plan) if R == 1 else BGG_TILE
    tiles = sum(-(-n // tw) for n in ns)
    if tiles <= 0 or k_keep < 1:
        return None
    S = 1
    while S < _BGG_MAX_SPLITS and tiles * 2 * S <= n_sms:
        S *= 2
    if R == 1:
        return 0, S, _BGG_STREAM_STAGES, _bgg_stream_smem(esz, plan, G)
    jmax = -(-k_keep // S)
    for two in (True, False):
        for stages in range(_ROWS_MAX_STAGES, 1, -1):
            smem = _bgg_smem(esz, plan, G, stages, S, jmax)
            if (2 * (smem + 1024) <= _SM_SMEM_BYTES if two
                    else smem <= _SMEM_BYTES):
                return 1, S, stages, smem
    return None


def block_gather_gemv_multi_plain(idx, xpack, ws, layer: int, G: int,
                                  rows: int):
    """K3 in plain PyTorch (same arguments and result as
    `block_gather_gemv_multi`)."""
    xg = xpack[:, :rows, :G].transpose(0, 1)                # [rows, k, G]
    gi = idx.long()
    return torch.cat([_slab_sums(xg, w, layer, gi, G) for w in ws], dim=1)


def _check_bgg(idx, xpack, ws, layer, G, rows):
    if (idx.dim() != 1 or idx.dtype != torch.int32 or idx.numel() < 1
            or not idx.is_contiguous()):
        raise ValueError(f"idx must be a contiguous int32 vector; got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    k = idx.shape[0]
    if (xpack.dim() != 3 or xpack.shape[0] != k
            or xpack.shape[1] not in (1, SUBLANES)
            or xpack.shape[2] != LANES or xpack.dtype not in _DTYPE_CODE
            or not xpack.is_contiguous() or xpack.device != idx.device):
        raise ValueError(f"xpack must be a contiguous [{k}, 1 or "
                         f"{SUBLANES}, {LANES}] fp32/bf16 tensor on idx's "
                         f"device; got {xpack.dtype} {tuple(xpack.shape)}")
    if not 1 <= rows <= xpack.shape[1]:
        raise ValueError(f"rows {rows} out of range [1, {xpack.shape[1]}]")
    K = _in_dim(ws[0]) if ws else 0
    if G not in GROUP_SIZES or K % G or k > K // G:
        raise ValueError(f"group size {G} must be one of {GROUP_SIZES} and "
                         f"divide K={K} into at least {k} groups")
    L, plan = _check_weights(ws, K, xpack.dtype, xpack.device, G)
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    return plan


def block_gather_gemv_multi(idx: torch.Tensor, xpack: torch.Tensor, ws,
                            layer: int, G: int, rows: int) -> torch.Tensor:
    """K3: y[b, :] = sum over slots j of xpack[j, b, :G] @ W[layer,
    idx[j]*G : idx[j]*G + G, :], for each weight, concatenated.

    idx:   [k] int32 kept group indices in [0, K // G) (the kernel clamps
           out-of-range values, so it never reads outside W)
    xpack: [k, 1 or 8, 128] fp32/bf16; row b of slot j holds input row
           b's values of group idx[j] in lanes [:G]
    ws:    1-3 weights sharing the selection and one plan: [L, K, N_i] of
           xpack's type, int8 [L, K, N_i] (the caller applies any scale
           to the result), or packed int4 {"qp", "sz"} (G >= 64)
    rows:  input rows to compute (<= xpack.shape[1])

    Returns fp32 [rows, sum N_i].
    """
    plan = _check_bgg(idx, xpack, ws, layer, G, rows)
    if idx.device.type == "cpu":
        return block_gather_gemv_multi_plain(idx, xpack, ws, layer, G, rows)
    _check_launch_device(idx, "block_gather_gemv_multi")
    lib = _build.load()["block_gather_gemv"]
    n = [_width(w) for w in ws]
    out = torch.empty((rows, sum(n)), dtype=torch.float32, device=idx.device)
    w_p, sz_p, _ = _ptrs(ws, plan, None)
    n += [0] * (3 - len(ws))
    err = lib.teal_block_gather_gemv(
        _DTYPE_CODE[xpack.dtype], plan, idx.data_ptr(), xpack.data_ptr(),
        *w_p, *sz_p, *n, len(ws), out.data_ptr(), _in_dim(ws[0]), G, layer,
        idx.shape[0], xpack.shape[1], rows,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "block_gather_gemv")
    block_gather_gemv_multi.launches += 1
    return out


block_gather_gemv_multi.launches = 0
