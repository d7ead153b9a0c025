"""Sparse GEMV dispatch for single-token decode.

Port of the `masked_dense` and `block` branches of
`teal_tpu/ops/sparse_gemv.py`:
  - "masked_dense": zero sub-threshold activations, dense matmul — the
    accuracy path (reference semantics);
  - "block": group-granular selection. One decode row in threshold mode
    at group size 128 runs kernel K1 (`block_gemv.select_gather_gemv`);
    several rows fall back to the group-masked dense twin, as in the
    reference. The "gather" branch (`gather_gemv.row_gather_gemv`) is not
    ported yet.
"""

from __future__ import annotations

import math

import torch

from teal_tpu_torch.config import SparsityConfig
from teal_tpu_torch.ops.sparsify import sparsify, sparsify_groups


def masked_dense_matmul(x, w, threshold):
    """Reference semantics: zero sub-threshold activations, dense matmul."""
    return torch.matmul(sparsify(x, threshold), w).to(x.dtype)


def group_masked_dense_matmul(x, w, threshold, sp: SparsityConfig):
    """Block-kernel semantics on the dense path (any batch shape): the
    unified group rule per position, then a dense matmul."""
    from teal_tpu_torch.ops.block_gemv import effective_block_size

    G = effective_block_size(sp.block_size, x.shape[-1])
    xs = sparsify_groups(
        x, G, sp.block_keep_frac,
        threshold=threshold if sp.block_thresholding else None,
    )
    return torch.matmul(xs, w).to(x.dtype)


def sparse_matmul(x, w, threshold, sp: SparsityConfig):
    """Decode-path sparse projection dispatch. x: [..., 1, K]; w: [K, N]."""
    if sp.kernel == "masked_dense":
        return masked_dense_matmul(x, w, threshold)
    if sp.kernel == "block":
        from teal_tpu_torch.ops import block_gemv

        if math.prod(x.shape[:-1]) > 1:
            return group_masked_dense_matmul(x, w, threshold, sp)
        thr = threshold if sp.block_thresholding else None
        return block_gemv.block_sparse_matmul(
            x, w, thr, sp.block_size, sp.block_keep_frac)
    raise NotImplementedError(
        f"sparse kernel {sp.kernel!r} is not ported (the port has "
        "'masked_dense' and 'block')")
