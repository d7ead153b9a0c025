"""GPTQ post-training quantization to groupwise int4.

Port of `teal_tpu/ops/gptq.py` (the algorithm of `gpt-fast/GPTQ.py:
132-345`'s Hessian-based runner), in torch in float64 on the weights'
device, so a 7B projection quantizes on the card in seconds where the
reference's host loop over the columns takes minutes.

Quantizes a weight along its input dimension column by column,
compensating each column's rounding error through the later columns with
the upper Cholesky factor T of the inverse Hessian (H = 2 X^T X from
calibration inputs). The steps are the reference's: H, dead inputs (zero
diagonal: kept invertible, their weights zeroed), damping, `inv`, the
factor, then the group loop: each group's affine scale and zero from its
columns as they stand, each column rounded, its error divided by T[i, i]
carried into the later columns. The error of a group reaches the columns
of the group at once, and the columns after it in one product when the
group is done (GPTQ's lazy batch update): the same sums in another order.

Output is the port's `quant.Int4Weight`, so GPTQ weights run through the
int4 paths (`quant.pack_int4` for kernels K1 and K3).
"""

from __future__ import annotations

import torch

from teal_tpu_torch.ops.quant import (Int4Weight, dequantize_int4,
                                      quantize_int4)


def _check_tensor(name: str, a) -> None:
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"{name} must be a torch tensor on the device to "
                        f"run on; got {type(a).__name__}")


def gptq_quantize_int4(
    w: torch.Tensor,
    x: torch.Tensor,
    *,
    group: int = 128,
    percdamp: float = 0.01,
) -> Int4Weight:
    """w: [K, N] (input-major, as the model multiplies); x: [n, K]
    calibration inputs (any float type; moved to w's device). Runs in
    float64 on w's device. Returns an Int4Weight (q int8 in [-8, 7],
    fp32 scale and zero [K // group, N]) with GPTQ-compensated values.
    """
    _check_tensor("w", w)
    _check_tensor("x", x)
    K, N = w.shape
    if K % group:
        raise ValueError(f"group {group} does not divide K={K}")
    dev = w.device
    W = w.to(torch.float64).clone()            # updated in place
    X = x.reshape(-1, K).to(dev, torch.float64)

    H = 2.0 * (X.T @ X)                         # [K, K]
    # dead inputs: keep H invertible, zero their weights (they contribute
    # nothing to the output on the calibration distribution)
    dead = torch.diagonal(H) == 0
    H[dead, dead] = 1.0
    W[dead, :] = 0.0
    damp = percdamp * torch.diagonal(H).mean()
    H.diagonal().add_(damp)

    Hinv = torch.linalg.inv(H)
    # upper Cholesky factor: Hinv = T^T T (drives the error propagation)
    T = torch.linalg.cholesky(Hinv, upper=True)
    del H, Hinv

    q = torch.empty((K, N), dtype=torch.int8, device=dev)
    scales = torch.empty((K // group, N), dtype=torch.float32, device=dev)
    zeros = torch.empty((K // group, N), dtype=torch.float32, device=dev)
    err = torch.empty((group, N), dtype=torch.float64, device=dev)

    for g0 in range(0, K, group):
        g1 = g0 + group
        blk = W[g0:g1]                          # a view: updated in place
        scale = torch.clamp_min((blk.amax(0) - blk.amin(0)) / 15.0, 1e-8)
        zero = blk.amin(0)
        scales[g0 // group] = scale
        zeros[g0 // group] = zero
        for j in range(group):
            i = g0 + j
            col = blk[j]
            qc = torch.clamp(torch.round((col - zero) / scale), 0, 15)
            q[i] = (qc - 8).to(torch.int8)
            err[j] = (col - (qc * scale + zero)) / T[i, i]
            # propagate the rounding error into the group's later columns
            blk[j + 1:] -= torch.outer(T[i, i + 1:g1], err[j])
        # ... and into every column after the group at once
        W[g1:] -= T[g0:g1, g1:].T @ err

    return Int4Weight(q=q, scale=scales, zero=zeros, group=group)


def rtn_quantize_int4(w: torch.Tensor, group: int = 128) -> Int4Weight:
    """Round-to-nearest baseline with identical packing (for comparisons),
    on w's device."""
    _check_tensor("w", w)
    return quantize_int4(w.float(), group=group)


def reconstruction_error(w_ref: torch.Tensor, wq: Int4Weight,
                         x: torch.Tensor) -> float:
    """||x @ (w_ref - dequant(wq))||_F / ||x @ w_ref||_F, in float64 on
    w_ref's device (the dequantized weight is fp32, as in the
    reference)."""
    _check_tensor("w_ref", w_ref)
    _check_tensor("x", x)
    w = w_ref.to(torch.float64)
    xf = x.reshape(-1, w.shape[0]).to(w.device, torch.float64)
    wd = dequantize_int4(wq, torch.float32).to(torch.float64)
    num = torch.linalg.matrix_norm(xf @ (w - wd))
    den = torch.linalg.matrix_norm(xf @ w) + 1e-12
    return float(num / den)
