"""Group-sparse GEMV: selection helpers and kernels K1 and K3.

Port of the array-weight parts of `teal_tpu/ops/block_gemv.py`. The
input dimension is cut into groups of G rows; selection follows THE
unified rule (docs/KERNEL_NOTES.md "Selection semantics"): in threshold
mode a group is kept if its score (max |x| within the group) clears a
calibrated group threshold, survivors are taken in ascending group order
and the first `cap` kept; in top-k mode the `cap` best-scoring groups are
kept, in ascending order. Only the kept groups' weight slabs `[G, N]` are
read.

Two kernels, each launched on CUDA tensors and run as its plain PyTorch
version (same module) on CPU tensors:
  - K1 `select_gather_gemv` (`csrc/select_gather_gemv.cu`): threshold
    selection inside the kernel at G in {32, 64, 128}, one input row,
    optional folded rms_norm, 1-3 layer-stacked weights `[L, K, N]`
    sharing one selection, and one of three epilogues;
  - K3 `block_gather_gemv_multi` (`csrc/block_gather_gemv.cu`): the
    gather over a kept-group list selected outside the kernel (top-k
    mode, and batched decode of up to 8 rows with one pooled selection).
`project_many` / `project_many_batched` pick between them as the
reference does. Quantized weight plans (int8 `{"q","scale"}`, int4
`{"qp","sz"}`) are not ported and raise.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from teal_tpu_torch import _build
from teal_tpu_torch.ops.sparsify import group_capacity

LANES = 128
SUBLANES = 8
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


def _shared_group_size(ws, block_size: int, K: int) -> int:
    """Gather group size for a projection set of plain weight tensors
    (the int4 plan, which raises G to 64, is not ported)."""
    if not all(isinstance(w, torch.Tensor) for w in ws):
        raise NotImplementedError(
            "quantized weight plans (int8 {'q','scale'}, int4 {'qp','sz'}) "
            "are not ported yet")
    return effective_block_size(block_size, K)


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


def _split(y: torch.Tensor, ws, dtype, lead) -> List[torch.Tensor]:
    """Cut a kernel's fp32 output [..., n_tot] into one tensor per weight,
    each cast to `dtype` and shaped lead + [N_i]."""
    outs = torch.split(y, [w.shape[-1] for w in ws], dim=-1)
    return [o.to(dtype).reshape(*lead, o.shape[-1]) for o in outs]


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


def project_many(x: torch.Tensor, ws: Sequence[torch.Tensor],
                 block_size: int = 32, keep_frac: Optional[float] = None,
                 layer: int = 0, threshold=None,
                 norm: Optional[torch.Tensor] = None,
                 norm_eps: float = 1e-5) -> List[torch.Tensor]:
    """Block-sparse projections of one decode row through weights sharing
    its selection. x: [..., K] with one row; ws: [L, K, N_i] stacks read
    at `layer`. Threshold mode runs K1 with the selection inside the
    kernel (and, with `norm` [L, K], the folded rms_norm: x is then the
    raw stream); top-k mode selects in PyTorch and runs K3. Returns one
    [..., N_i] tensor per weight, the fp32 sums cast to x's type."""
    K = x.shape[-1]
    G = _shared_group_size(ws, block_size, K)
    k_keep = block_capacity(K // G, keep_frac)
    if threshold is not None:
        thr = torch.as_tensor(threshold, dtype=torch.float32,
                              device=x.device).reshape(())
        y = fused_select_gather_gemv(x.reshape(K).contiguous(), thr, ws,
                                     layer, G, k_keep, norm=norm,
                                     norm_eps=norm_eps)
    elif norm is not None:
        raise ValueError("the norm fold needs threshold mode")
    else:
        idx, xpack = select_groups(x.reshape(1, K), G, k_keep)
        y = block_gather_gemv_multi(idx, xpack, ws, layer, G, 1)[0]
    return _split(y, ws, x.dtype, x.shape[:-1])


def project_many_batched(x: torch.Tensor, ws: Sequence[torch.Tensor],
                         block_size: int = 32,
                         keep_frac: Optional[float] = None, layer: int = 0,
                         threshold=None) -> List[torch.Tensor]:
    """Batched (B <= 8) block-sparse projections: one pooled selection for
    the batch (`select_groups_batched`), then K3 with B rows. x: [B, K];
    returns one [B, N_i] tensor per weight in x's type."""
    B, K = x.shape
    G = _shared_group_size(ws, block_size, K)
    k_keep = block_capacity(K // G, keep_frac)
    idx, xpack = select_groups_batched(x, G, k_keep, threshold)
    y = block_gather_gemv_multi(idx, xpack, ws, layer, G, B)
    return _split(y, ws, x.dtype, (B,))


def _check_weights(ws, K: int, dtype, device) -> int:
    """Shared checks of 1-3 layer-stacked weights; returns L."""
    if not 1 <= len(ws) <= 3:
        raise ValueError(f"1-3 weights share one selection; got {len(ws)}")
    L = ws[0].shape[0]
    for w in ws:
        if (w.dim() != 3 or w.shape[0] != L or w.shape[1] != K
                or w.shape[2] % 32 or w.dtype != dtype
                or w.device != device or not w.is_contiguous()
                or w.data_ptr() % 16):
            raise ValueError(
                f"weights must be contiguous, 16-byte aligned [L, {K}, N] "
                f"stacks of type {dtype} on {device} with N % 32 == 0; got "
                f"{w.dtype} {tuple(w.shape)} on {w.device}")
    return L


def _check_launch_device(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda" or t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name} runs on the current CUDA device or the "
                         f"CPU; got {t.device}")


# --- K1 -------------------------------------------------------------------

def selection_input(x, norm, layer: int, norm_eps: float):
    """The vector K1 scores and gathers with: x itself, or with `norm`
    its folded rms_norm, rounded to the stream type before and after the
    gain as `llama.rms_norm` does."""
    if norm is None:
        return x
    xf = x.float()
    scale = torch.rsqrt((xf * xf).sum() / x.shape[0] + norm_eps)
    return (xf * scale).to(x.dtype) * norm[layer].to(x.dtype)


def select_gather_gemv_plain(x, thr, ws, layer: int, cap: int, *,
                             G: int = LANES, norm=None,
                             norm_eps: float = 1e-5, res=None,
                             silu: bool = False):
    """K1 in plain PyTorch (same arguments and results as
    `select_gather_gemv`). Keeps the reference's cast points: the folded
    norm rounds to the stream type before and after the gain; scores,
    sums and epilogues are fp32."""
    dt = x.dtype
    nb = x.shape[0] // G
    x = selection_input(x, norm, layer, norm_eps)
    scores = x.float().abs().reshape(nb, G).amax(dim=-1)
    kept = torch.nonzero(_threshold_mask(scores, thr, cap)).flatten()
    count = kept.numel()
    idx = torch.full((cap,), -1, dtype=torch.int32, device=x.device)
    idx[:count] = kept.to(torch.int32)
    xk = x.reshape(nb, G)[kept].reshape(-1).float()
    accs = [xk @ w[layer].reshape(nb, G, w.shape[2])[kept]
            .reshape(count * G, w.shape[2]).float() for w in ws]
    if silu:
        g, u = accs
        out = (g * (1.0 / (1.0 + torch.exp(-g))) * u).to(dt)
    elif res is not None:
        out = (accs[0] + res.float()).to(dt)
    else:
        out = torch.cat(accs)
    return out, idx, torch.tensor([count], dtype=torch.int32,
                                  device=x.device)


def _check_sgg(x, thr, ws, layer, cap, G, norm, res, silu):
    if x.dtype not in _DTYPE_CODE or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous fp32/bf16 vector; got "
                         f"{x.dtype} {tuple(x.shape)}")
    K = x.shape[0]
    if G not in GROUP_SIZES or K % G:
        raise ValueError(f"group size {G} must be one of {GROUP_SIZES} and "
                         f"divide K={K}")
    L = _check_weights(ws, K, x.dtype, x.device)
    if not 0 <= layer < L:
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
    if silu and (len(ws) != 2 or ws[0].shape[2] != ws[1].shape[2]
                 or res is not None):
        raise ValueError("silu needs exactly (gate, up) of equal width and "
                         "no residual")
    if res is not None:
        n_tot = sum(w.shape[2] for w in ws)
        if (res.shape != (n_tot,) or res.dtype != x.dtype
                or res.device != x.device or not res.is_contiguous()):
            raise ValueError(f"res must be a contiguous [{n_tot}] vector of "
                             f"x's type")


def select_gather_gemv(x: torch.Tensor, thr: torch.Tensor,
                       ws: Sequence[torch.Tensor], layer: int, cap: int, *,
                       G: int = LANES,
                       norm: Optional[torch.Tensor] = None,
                       norm_eps: float = 1e-5,
                       res: Optional[torch.Tensor] = None,
                       silu: bool = False):
    """K1: select + gather GEMV over layer `layer` of stacked weights.

    x:    [K] stream (raw when `norm` is given, which folds rms_norm in)
    thr:  one fp32 group-score threshold (a 0-d view into the [L, 7]
          table works: the kernel reads it on the device)
    ws:   1-3 weights [L, K, N_i] of x's type, sharing one selection
    G:    group size, one of `GROUP_SIZES`
    norm: [L, K] rms_norm gains; res: [N] residual added in fp32
    silu: ws = (gate, up): out = silu(gate) * up

    Returns (out, idx, count): out is fp32 [sum N_i] (no epilogue) or
    x's type [N] (res / silu); idx [cap] int32 holds the kept groups in
    ascending order, -1 past `count` ([1] int32).
    """
    _check_sgg(x, thr, ws, layer, cap, G, norm, res, silu)
    if x.device.type == "cpu":
        return select_gather_gemv_plain(x, thr, ws, layer, cap, G=G,
                                        norm=norm, norm_eps=norm_eps,
                                        res=res, silu=silu)
    _check_launch_device(x, "select_gather_gemv")
    lib = _build.load()["select_gather_gemv"]
    mode = 2 if silu else (1 if res is not None else 0)
    n = [w.shape[2] for w in ws]
    n_out = n[0] if silu else sum(n)
    out = torch.empty(n_out, device=x.device,
                      dtype=torch.float32 if mode == 0 else x.dtype)
    sel = torch.empty(cap + 1, dtype=torch.int32, device=x.device)
    ptrs = [w.data_ptr() for w in ws] + [None] * (3 - len(ws))
    n += [0] * (3 - len(ws))
    err = lib.teal_select_gather_gemv(
        _DTYPE_CODE[x.dtype], x.data_ptr(), thr.data_ptr(),
        None if norm is None else norm.data_ptr(), norm_eps,
        *ptrs, *n, len(ws), None if res is None else res.data_ptr(),
        out.data_ptr(), sel.data_ptr(), sel.data_ptr() + 4 * cap,
        x.shape[0], G, layer, cap, mode,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "select_gather_gemv")
    select_gather_gemv.launches += 1
    return out, sel[:cap], sel[cap:]


select_gather_gemv.launches = 0


def fused_select_gather_gemv(x: torch.Tensor, thr: torch.Tensor,
                             ws: Sequence[torch.Tensor], layer: int, G: int,
                             cap: int, norm: Optional[torch.Tensor] = None,
                             norm_eps: float = 1e-5) -> torch.Tensor:
    """The reference's `fused_select_gather_gemv`: K1 with no epilogue at
    group size G. Returns the fp32 sums [sum N_i]."""
    return select_gather_gemv(x, thr, ws, layer, cap, G=G, norm=norm,
                              norm_eps=norm_eps)[0]


# --- K3 -------------------------------------------------------------------

def block_gather_gemv_multi_plain(idx, xpack, ws, layer: int, G: int,
                                  rows: int):
    """K3 in plain PyTorch (same arguments and result as
    `block_gather_gemv_multi`)."""
    k = idx.shape[0]
    xr = xpack[:, :rows, :G].float().transpose(0, 1).reshape(rows, k * G)
    gi = idx.long()
    return torch.cat([
        xr @ w[layer].reshape(-1, G, w.shape[2])[gi]
        .reshape(k * G, w.shape[2]).float() for w in ws], dim=1)


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
    K = ws[0].shape[1] if ws else 0
    L = _check_weights(ws, K, xpack.dtype, xpack.device)
    if G not in GROUP_SIZES or K % G or k > K // G:
        raise ValueError(f"group size {G} must be one of {GROUP_SIZES} and "
                         f"divide K={K} into at least {k} groups")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")


def block_gather_gemv_multi(idx: torch.Tensor, xpack: torch.Tensor,
                            ws: Sequence[torch.Tensor], layer: int, G: int,
                            rows: int) -> torch.Tensor:
    """K3: y[b, :] = sum over slots j of xpack[j, b, :G] @ W[layer,
    idx[j]*G : idx[j]*G + G, :], for each weight, concatenated.

    idx:   [k] int32 kept group indices in [0, K // G) (the kernel clamps
           out-of-range values, so it never reads outside W)
    xpack: [k, 1 or 8, 128] of the weights' type; row b of slot j holds
           input row b's values of group idx[j] in lanes [:G]
    ws:    1-3 weights [L, K, N_i] sharing the selection
    rows:  input rows to compute (<= xpack.shape[1])

    Returns fp32 [rows, sum N_i].
    """
    _check_bgg(idx, xpack, ws, layer, G, rows)
    if idx.device.type == "cpu":
        return block_gather_gemv_multi_plain(idx, xpack, ws, layer, G, rows)
    _check_launch_device(idx, "block_gather_gemv_multi")
    lib = _build.load()["block_gather_gemv"]
    n = [w.shape[2] for w in ws]
    out = torch.empty((rows, sum(n)), dtype=torch.float32, device=idx.device)
    ptrs = [w.data_ptr() for w in ws] + [None] * (3 - len(ws))
    n += [0] * (3 - len(ws))
    err = lib.teal_block_gather_gemv(
        _DTYPE_CODE[xpack.dtype], idx.data_ptr(), xpack.data_ptr(), *ptrs,
        *n, len(ws), out.data_ptr(), ws[0].shape[1], G, layer,
        idx.shape[0], xpack.shape[1], rows,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "block_gather_gemv")
    block_gather_gemv_multi.launches += 1
    return out


block_gather_gemv_multi.launches = 0
