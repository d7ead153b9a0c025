"""Sparse GEMV dispatch for single-token decode.

Port of the `masked_dense` and `block` branches of
`teal_tpu/ops/sparse_gemv.py`:
  - "masked_dense": zero sub-threshold activations, dense matmul — the
    accuracy path (reference semantics);
  - "gather": unstructured row skipping, the exact elementwise rule
    (`gather_gemv.gather_sparse_matmul`, kernel K4), one row only;
  - "block": group-granular selection. One decode row runs the selection
    and kernel K3 (`block_gemv.block_sparse_matmul`); several rows fall
    back to the group-masked dense twin, as in the reference.
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
    if sp.kernel == "gather":
        from teal_tpu_torch.ops import gather_gemv

        return gather_gemv.gather_sparse_matmul(x, w, threshold,
                                                sp.gather_cap_frac)
    if sp.kernel == "block":
        from teal_tpu_torch.ops import block_gemv

        if math.prod(x.shape[:-1]) > 1:
            return group_masked_dense_matmul(x, w, threshold, sp)
        thr = threshold if sp.block_thresholding else None
        return block_gemv.block_sparse_matmul(
            x, w, thr, sp.block_size, sp.block_keep_frac)
    raise ValueError(f"unknown sparse kernel {sp.kernel!r}")
