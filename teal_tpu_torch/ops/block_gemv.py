"""Group-sparse GEMV: selection helpers and kernel K1.

Port of the threshold-mode parts of `teal_tpu/ops/block_gemv.py`. The
input dimension is cut into groups of G rows; a group is kept if its
score (max |x| within the group) clears a calibrated group threshold,
survivors are taken in ascending group order and the first `cap` kept
(THE unified selection rule, docs/KERNEL_NOTES.md "Selection
semantics"). Only the kept groups' weight slabs `[G, N]` are read.

`select_gather_gemv` is kernel K1 (`csrc/select_gather_gemv.cu`): G=128,
one input row, optional folded rms_norm, 1-3 layer-stacked weights
`[L, K, N]` sharing one selection, and one of three epilogues. On a CUDA
tensor it launches the kernel; on a CPU tensor it runs
`select_gather_gemv_plain`, the same function in plain PyTorch.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from teal_tpu_torch import _build
from teal_tpu_torch.ops.sparsify import group_capacity

LANES = 128
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


def group_scores(x: torch.Tensor, G: int) -> torch.Tensor:
    """Per-group max-|x| score. x: [1, K] -> [K//G]."""
    return x.abs().reshape(-1, G).amax(dim=-1)


def _threshold_mask(scores: torch.Tensor, threshold, k_keep: int):
    surv = scores > threshold
    return surv & (torch.cumsum(surv.to(torch.int32), dim=-1) <= k_keep)


def select_groups(x: torch.Tensor, G: int, k_keep: int, threshold
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threshold-mode selection as kernel inputs: survivors (score >
    threshold) in ascending order, first `k_keep` kept. Returns
    (idx [k_keep] int32, xpack [k_keep, 1, 128]); padded slots carry
    index 0 and zero values, as in the reference."""
    nb = x.shape[-1] // G
    mask = _threshold_mask(group_scores(x, G), threshold, k_keep)
    order = torch.where(mask, torch.arange(nb, device=x.device), nb)
    idx = torch.sort(order).values[: min(k_keep, nb)]
    pad = idx >= nb
    idx = torch.where(pad, 0, idx)
    xg = x.reshape(nb, G)[idx]
    xg = torch.where(pad[:, None], torch.zeros_like(xg), xg)
    xpack = torch.zeros((xg.shape[0], LANES), dtype=x.dtype, device=x.device)
    xpack[:, :G] = xg
    return idx.to(torch.int32), xpack.reshape(-1, 1, LANES)


def block_sparse_matmul_reference(x: torch.Tensor, w: torch.Tensor,
                                  threshold, block_size: int = 32,
                                  keep_frac: Optional[float] = None):
    """Semantics twin of the block kernel: the unified selection rule (or
    top-k with `threshold=None`), then a dense matmul with fp32 sums."""
    K, N = w.shape
    G = effective_block_size(block_size, K)
    nb = K // G
    k_keep = group_capacity(nb, keep_frac if keep_frac else 0.625)
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


def block_sparse_matmul(x: torch.Tensor, w: torch.Tensor, threshold,
                        block_size: int = 32,
                        keep_frac: Optional[float] = None):
    """Sparse projection for one decode row. x: [..., 1, K]; w: [K, N].

    Threshold mode at group size 128 runs K1. Top-k mode and smaller
    groups run the reference's `block_gather_gemv_multi`, which the port
    does not have yet, so they raise."""
    K, N = w.shape
    G = effective_block_size(block_size, K)
    if threshold is None or G != LANES:
        raise NotImplementedError(
            "block mode needs threshold selection at group size 128 in "
            "the port; the top-k / small-group gather kernel "
            "(block_gemv.block_gather_gemv_multi) is not ported yet")
    cap = group_capacity(K // G, keep_frac if keep_frac else 0.625)
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=x.device)
    y, _, _ = select_gather_gemv(x.reshape(K).contiguous(), thr.reshape(()),
                                 [w.reshape(1, K, N)], 0, cap)
    return y.to(x.dtype).reshape(*x.shape[:-1], N)


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
                             norm=None, norm_eps: float = 1e-5, res=None,
                             silu: bool = False):
    """K1 in plain PyTorch (same arguments and results as
    `select_gather_gemv`). Keeps the reference's cast points: the folded
    norm rounds to the stream type before and after the gain; scores,
    sums and epilogues are fp32."""
    dt = x.dtype
    nb = x.shape[0] // LANES
    x = selection_input(x, norm, layer, norm_eps)
    scores = x.float().abs().reshape(nb, LANES).amax(dim=-1)
    kept = torch.nonzero(_threshold_mask(scores, thr, cap)).flatten()
    count = kept.numel()
    idx = torch.full((cap,), -1, dtype=torch.int32, device=x.device)
    idx[:count] = kept.to(torch.int32)
    xk = x.reshape(nb, LANES)[kept].reshape(-1).float()
    accs = [xk @ w[layer].reshape(nb, LANES, w.shape[2])[kept]
            .reshape(count * LANES, w.shape[2]).float() for w in ws]
    if silu:
        g, u = accs
        out = (g * (1.0 / (1.0 + torch.exp(-g))) * u).to(dt)
    elif res is not None:
        out = (accs[0] + res.float()).to(dt)
    else:
        out = torch.cat(accs)
    return out, idx, torch.tensor([count], dtype=torch.int32,
                                  device=x.device)


def _check_sgg(x, thr, ws, layer, cap, norm, res, silu):
    if x.dtype not in _DTYPE_CODE or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous fp32/bf16 vector; got "
                         f"{x.dtype} {tuple(x.shape)}")
    K = x.shape[0]
    if K % LANES:
        raise ValueError(f"K={K} must be a multiple of {LANES}")
    if not 1 <= len(ws) <= 3:
        raise ValueError(f"1-3 weights share one selection; got {len(ws)}")
    L = ws[0].shape[0]
    for w in ws:
        if (w.dim() != 3 or w.shape[0] != L or w.shape[1] != K
                or w.shape[2] % 32 or w.dtype != x.dtype
                or w.device != x.device or not w.is_contiguous()
                or w.data_ptr() % 16):
            raise ValueError(
                f"weights must be contiguous, 16-byte aligned [L, K, N] "
                f"stacks of x's type and device with N % 32 == 0; got "
                f"{w.dtype} {tuple(w.shape)} on {w.device}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    if not 1 <= cap <= K // LANES:
        raise ValueError(f"cap {cap} out of range [1, {K // LANES}]")
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
                       norm: Optional[torch.Tensor] = None,
                       norm_eps: float = 1e-5,
                       res: Optional[torch.Tensor] = None,
                       silu: bool = False):
    """K1: select + gather GEMV over layer `layer` of stacked weights.

    x:    [K] stream (raw when `norm` is given, which folds rms_norm in)
    thr:  one fp32 group-score threshold (a 0-d view into the [L, 7]
          table works: the kernel reads it on the device)
    ws:   1-3 weights [L, K, N_i] of x's type, sharing one selection
    norm: [L, K] rms_norm gains; res: [N] residual added in fp32
    silu: ws = (gate, up): out = silu(gate) * up

    Returns (out, idx, count): out is fp32 [sum N_i] (no epilogue) or
    x's type [N] (res / silu); idx [cap] int32 holds the kept groups in
    ascending order, -1 past `count` ([1] int32).
    """
    _check_sgg(x, thr, ws, layer, cap, norm, res, silu)
    if x.device.type == "cpu":
        return select_gather_gemv_plain(x, thr, ws, layer, cap, norm=norm,
                                        norm_eps=norm_eps, res=res,
                                        silu=silu)
    if x.device.type != "cuda" or x.device.index != torch.cuda.current_device():
        raise ValueError(f"select_gather_gemv runs on the current CUDA "
                         f"device or the CPU; got {x.device}")
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
        x.shape[0], layer, cap, mode,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "select_gather_gemv")
    select_gather_gemv.launches += 1
    return out, sel[:cap], sel[cap:]


select_gather_gemv.launches = 0
