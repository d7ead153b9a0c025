"""Unstructured row-gather sparse GEMV (the exact elementwise TEAL rule).

Port of `teal_tpu/ops/gather_gemv.py`: the input channels whose
activations survive `|x| > t` are compacted (a stable partition, then the
first `nnz_cap` sorted) and only their weight rows are read. The JAX
package keeps this mode for validation, because a TPU pays a fixed cost
per gathered row; a GPU has no such cost, so here it is a real decode
route.

`row_gather_gemv` is kernel K4 (`csrc/row_gather_gemv.cu`): launched on
CUDA tensors, run as `row_gather_gemv_plain` on CPU tensors.
"""

from __future__ import annotations

import math

import torch

from teal_tpu_torch import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# K4's launch plan on the card (`csrc/row_gather_gemv.cu`, `plan` and
# `Layout`, which `_plan` mirrors; the card tests hold the two together
# through `teal_row_gather_plan`)
_PIECE = 256                     # bytes of a row a block reads
_THREADS = 256
_STAGES = 8                      # the ring of row pieces
_CHUNK = 2048                    # slots compacted at a time
_MAX_SPLITS = 8                  # blocks a cluster


def _plan(esz: int, N: int, n_sms: int):
    """K4's launch plan from shapes only: (tile columns, S, ring stages,
    compaction chunk, shared bytes). A block reads 256 bytes of each
    survivor row (128 bf16 or 64 fp32 columns; the last tile masks columns
    past N) and one of S contiguous ranges of the slots; S (the cluster)
    is the largest power of two <= 8 keeping the grid within two blocks
    an SM (block s takes the slots `split_range(nnz, S, s)`). Shared
    memory: the ring [stages][threads] x 16 bytes, the
    compacted indices and values, the warps' counts (64 bytes) and the
    block's fp32 sums of its tile."""
    tw = _PIECE // esz
    tiles = -(-N // tw)
    S = 1
    while S < _MAX_SPLITS and tiles * S * 2 <= 2 * n_sms:
        S *= 2
    smem = _STAGES * _THREADS * 16 + 2 * _CHUNK * 4 + 64 + tw * 4
    return tw, S, _STAGES, _CHUNK, smem


def split_range(count: int, S: int, s: int):
    """The items [lo, hi) of `count` that split s of S takes (`split_lo`
    in `csrc/common.cuh`, by which K3 and K4 cut their kept groups and
    slots; the card tests hold the two together through
    `teal_row_gather_split` and `teal_block_gather_split`): S contiguous
    ranges in order, some empty where count < S."""
    return count * s // S, count * (s + 1) // S


def compact_indices(x: torch.Tensor, threshold, nnz_cap: int):
    """Survivor compaction of one row x (K values): the indices of
    |x| > threshold in ascending order, padded to `nnz_cap` slots. Padded
    and overflow slots point at real rows and carry value 0. Returns
    (idx [nnz_cap] int32, vals [nnz_cap] fp32)."""
    K = x.shape[-1]
    xf = x.reshape(K).float()
    keep = xf.abs() > threshold
    order = torch.argsort((~keep).to(torch.uint8), stable=True)
    idx = torch.sort(order[:nnz_cap]).values
    vals = torch.where(keep[idx], xf[idx], torch.zeros_like(xf[idx]))
    return idx.to(torch.int32), vals


def row_gather_gemv_plain(idx, xc, w):
    """K4 in plain PyTorch (same arguments and result as
    `row_gather_gemv`)."""
    return (xc @ w[idx.long()].float()).to(w.dtype)


def _check(idx, xc, w):
    if (idx.dim() != 1 or idx.dtype != torch.int32
            or not idx.is_contiguous() or idx.numel() < 1):
        raise ValueError(f"idx must be a contiguous int32 vector; got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if (xc.shape != idx.shape or xc.dtype != torch.float32
            or not xc.is_contiguous() or xc.device != idx.device):
        raise ValueError(f"xc must be a contiguous fp32 vector like idx; "
                         f"got {xc.dtype} {tuple(xc.shape)}")
    if (w.dim() != 2 or w.dtype not in _DTYPE_CODE or w.shape[1] % 32
            or not w.is_contiguous() or w.data_ptr() % 16
            or w.device != idx.device):
        raise ValueError(f"w must be a contiguous, 16-byte aligned fp32/bf16 "
                         f"[K, N] matrix with N % 32 == 0 on idx's device; "
                         f"got {w.dtype} {tuple(w.shape)} on {w.device}")


def row_gather_gemv(idx: torch.Tensor, xc: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """K4: y[n] = sum_i xc[i] * w[idx[i], n], fp32 sums.

    idx: [nnz] int32 row indices in [0, K) (the kernel clamps others, so
         it never reads outside w)
    xc:  [nnz] fp32 values; slots with 0 contribute nothing
    w:   [K, N] (one layer's view of a [L, K, N] stack)

    Returns [N] in w's type.
    """
    _check(idx, xc, w)
    if idx.device.type == "cpu":
        return row_gather_gemv_plain(idx, xc, w)
    if idx.device.type != "cuda" or \
            idx.device.index != torch.cuda.current_device():
        raise ValueError(f"row_gather_gemv runs on the current CUDA device "
                         f"or the CPU; got {idx.device}")
    lib = _build.load()["row_gather_gemv"]
    K, N = w.shape
    out = torch.empty(N, dtype=w.dtype, device=w.device)
    err = lib.teal_row_gather_gemv(
        _DTYPE_CODE[w.dtype], idx.data_ptr(), xc.data_ptr(), w.data_ptr(),
        out.data_ptr(), K, N, idx.shape[0],
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "row_gather_gemv")
    row_gather_gemv.launches += 1
    return out


row_gather_gemv.launches = 0


def gather_sparse_matmul(x: torch.Tensor, w: torch.Tensor, threshold,
                         nnz_cap_frac: float = 0.625) -> torch.Tensor:
    """Unstructured sparse projection of one decode row. x: [..., K] with
    one row; w: [K, N]. Capacity `max(1, int(K * nnz_cap_frac))` rows (a
    floor, as in the reference)."""
    K, N = w.shape
    if math.prod(x.shape[:-1]) != 1:
        raise NotImplementedError(
            "gather mode with more than one row is not ported (the "
            "reference's row-gather kernel takes one row)")
    nnz_cap = max(1, int(K * nnz_cap_frac))
    idx, vals = compact_indices(x, threshold, nnz_cap)
    return row_gather_gemv(idx, vals, w).to(x.dtype).reshape(*x.shape[:-1], N)
