"""Weight-only quantization: int8 per-channel, int4 groupwise.

Port of `teal_tpu/ops/quant.py` (GPTQ, `teal_tpu/ops/gptq.py`, is not
ported yet). Inputs are torch tensors on any device, so a model can be
quantized on the card:
  - int8: symmetric per-output-channel scales; the dense product is a
    matmul in the compute type with fp32 sums, then the scale;
  - int4: groupwise affine over the input dim (per group and output
    channel a scale and a zero point); the decode layout packs two rows a
    byte (`pack_int4`) with the group's [scale, zero] beside it (`sz`).

The layout is [in, out] (x @ w): per-channel scales live on the output
axis, int4 groups run along the input axis. The block-sparse decode
projections gather int8 slabs or packed int4 slabs through kernel K3
(`block_gemv.block_gather_gemv_multi`), which converts int8 and unpacks
int4 in the kernel, so a kept group costs half (int8) or a quarter plus
its `sz` row (int4) of its bf16 bytes.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from teal_tpu_torch.ops import block_gemv
from teal_tpu_torch.ops.block_gemv import (block_capacity,
                                           effective_block_size,
                                           select_groups)

_QUANT_KEYS = ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown")


class Int8Weight(NamedTuple):
    q: torch.Tensor       # [K, N] int8
    scale: torch.Tensor   # [N] fp32


class Int4Weight(NamedTuple):
    q: torch.Tensor       # [K, N] int8 holding values in [-8, 7]
    scale: torch.Tensor   # [K // group, N] fp32
    zero: torch.Tensor    # [K // group, N] fp32 (affine zero point)
    group: int


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with fp32 sums of the products in x's type: one GEMM with an
    fp32 output on the card, an fp32 product elsewhere (which holds every
    bf16 x bf16 and bf16 x int8 product exactly)."""
    if x.device.type == "cuda" and x.dtype != torch.float32:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.to(x.dtype),
                     out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def quantize_int8(w: torch.Tensor) -> Int8Weight:
    """Symmetric per-output-channel int8."""
    wf = w.float()
    amax = wf.abs().amax(dim=0)                          # [N]
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale[None, :]), -128, 127)
    return Int8Weight(q=q.to(torch.int8), scale=scale)


def dequantize_int8(wq: Int8Weight, dtype=torch.bfloat16) -> torch.Tensor:
    return (wq.q.float() * wq.scale[None, :]).to(dtype)


def int8_matmul(x: torch.Tensor, wq: Int8Weight) -> torch.Tensor:
    """Dense path: matmul in the compute type with fp32 sums, then the
    per-channel scale."""
    return (matmul_f32(x, wq.q) * wq.scale).to(x.dtype)


def quantize_int4(w: torch.Tensor, group: int = 128) -> Int4Weight:
    """Groupwise affine int4 along the input dim: groups of `group`
    input channels share a scale and a zero point."""
    K, N = w.shape
    if K % group:
        raise ValueError(f"group {group} does not divide K={K}")
    wf = w.float().reshape(K // group, group, N)
    wmax = wf.amax(dim=1)                                # [K//g, N]
    wmin = wf.amin(dim=1)
    scale = torch.clamp_min((wmax - wmin) / 15.0, 1e-8)
    zero = wmin
    q = torch.clamp(torch.round((wf - zero[:, None, :]) / scale[:, None, :]),
                    0, 15) - 8
    return Int4Weight(q=q.reshape(K, N).to(torch.int8), scale=scale,
                      zero=zero, group=group)


def dequantize_int4(wq: Int4Weight, dtype=torch.bfloat16) -> torch.Tensor:
    K, N = wq.q.shape
    g = wq.group
    qf = (wq.q.float() + 8.0).reshape(K // g, g, N)
    wf = qf * wq.scale[:, None, :] + wq.zero[:, None, :]
    return wf.reshape(K, N).to(dtype)


def int4_matmul(x: torch.Tensor, wq: Int4Weight) -> torch.Tensor:
    """Dense path: dequantize to x's type, then matmul with fp32 sums."""
    return matmul_f32(x, dequantize_int4(wq, x.dtype)).to(x.dtype)


# -- block-sparse int8 decode through K3 --------------------------------------

def int8_block_gather_gemv(idx, xpack, q, scale, *, G: int, k_keep: int,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """Gather + int8 GEMV: K3 converts the gathered int8 slabs in the
    kernel; the per-channel scale follows on the fp32 sums (it commutes
    with the sum over groups). q: [K, N]; returns [1, N]."""
    if idx.shape[0] != k_keep:
        raise ValueError(f"{idx.shape[0]} kept groups, expected {k_keep}")
    out = block_gemv.block_gather_gemv_multi(idx, xpack, [q[None]], 0, G, 1)
    return (out * scale[None, :]).to(out_dtype)


def int8_block_sparse_matmul(x: torch.Tensor, wq: Int8Weight,
                             block_size: int = 32,
                             keep_frac: Optional[float] = None):
    """Sparse int8 decode projection: top-k group selection, then K3."""
    K, N = wq.q.shape
    G = effective_block_size(block_size, K)
    k_keep = block_capacity(K // G, keep_frac)
    idx, xpack = select_groups(x.reshape(1, K), G, k_keep)
    y = int8_block_gather_gemv(idx, xpack, wq.q, wq.scale, G=G,
                               k_keep=k_keep, out_dtype=x.dtype)
    return y.reshape(*x.shape[:-1], N)


# -- packed int4 for the gather kernel -----------------------------------------

def int4_gather_group(block_size: int, K: int) -> int:
    """Gather group size for int4 weights: G >= 64, as in the reference
    (whose packed slab [G/2, N] must cover whole int8 sublane tiles)."""
    return max(64, effective_block_size(block_size, K))


def pack_int4(wq: Int4Weight) -> Dict[str, torch.Tensor]:
    """Int4Weight (quant group g) -> {"qp", "sz"} kernel layout.

    qp [K/2, N] int8: for group b, rows [b*g, b*g + g/2) of nib = q + 8
    in the low nibbles and rows [b*g + g/2, (b+1)*g) in the high nibbles
    of packed rows [b*g/2, (b+1)*g/2), so pairs stay inside a group.
    sz [K//g, 2, N] fp32: per (group, out-channel) [scale, zero]."""
    K, N = wq.q.shape
    g = wq.group
    if g % 2:
        raise ValueError(f"odd quant group {g}")
    nib = (wq.q.to(torch.int32) + 8).to(torch.uint8)
    r = nib.reshape(K // g, g, N)
    packed = (r[:, : g // 2] | (r[:, g // 2:] << 4)).to(torch.int8)
    sz = torch.stack([wq.scale, wq.zero], dim=1).float()
    return {"qp": packed.reshape(K // 2, N), "sz": sz}


def unpack_int4(qp: torch.Tensor, sz: torch.Tensor,
                dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of `pack_int4` (the dense and prefill path); any leading
    dims."""
    K2, N = qp.shape[-2:]
    lead = qp.shape[:-2]
    nbg = sz.shape[-3]
    g = 2 * K2 // nbg
    pi = qp.to(torch.int32)
    lo = (pi & 15).reshape(*lead, nbg, g // 2, N)
    hi = ((pi >> 4) & 15).reshape(*lead, nbg, g // 2, N)
    nib = torch.cat([lo, hi], dim=-2).float()
    w = nib * sz[..., 0:1, :] + sz[..., 1:2, :]
    return w.reshape(*lead, 2 * K2, N).to(dtype)


def int4_packed_matmul(x: torch.Tensor, w: Dict) -> torch.Tensor:
    """Dense matmul against a packed int4 dict {"qp", "sz"}."""
    return matmul_f32(x, unpack_int4(w["qp"], w["sz"], x.dtype)).to(x.dtype)


def pack_int4_params(params, block_size: int = 32) -> Dict:
    """A whole int4 params tree ({"q","scale","zero"} leaves, any quant
    group) in the packed decode layout ({"qp","sz"} leaves whose quant
    group is the int4 gather group). A leaf stored at another group is
    REQUANTIZED from its dequantized weights at the gather group. The
    head stays unpacked, as in the reference."""
    out = {k: v for k, v in params.items() if k != "layers"}
    layers = {}
    for name, leaf in params["layers"].items():
        if not (isinstance(leaf, dict) and "zero" in leaf):
            layers[name] = leaf
            continue
        L, K, N = leaf["q"].shape
        g_stored = K // leaf["scale"].shape[-2]
        G = int4_gather_group(block_size, K)
        qp = torch.empty((L, K // 2, N), dtype=torch.int8,
                         device=leaf["q"].device)
        sz = torch.empty((L, K // G, 2, N), dtype=torch.float32,
                         device=leaf["q"].device)
        for l in range(L):
            wq = Int4Weight(q=leaf["q"][l], scale=leaf["scale"][l],
                            zero=leaf["zero"][l], group=g_stored)
            if g_stored != G:
                wq = quantize_int4(dequantize_int4(wq, torch.float32),
                                   group=G)
            p = pack_int4(wq)
            qp[l], sz[l] = p["qp"], p["sz"]
        layers[name] = {"qp": qp, "sz": sz}
    out["layers"] = layers
    return out


def int4_block_sparse_matmul(x: torch.Tensor, w: Dict, block_size: int = 32,
                             keep_frac: Optional[float] = None,
                             threshold=None) -> torch.Tensor:
    """Sparse int4 decode projection: group selection (top-k, or threshold
    with `threshold`) at the int4 gather group, then K3, which unpacks the
    kept slabs and applies each group's affine factored through the sum.
    w: {"qp" [K/2, N], "sz" [K/G, 2, N]}."""
    K = 2 * w["qp"].shape[-2]
    N = w["qp"].shape[-1]
    G = int4_gather_group(block_size, K)
    k_keep = block_capacity(K // G, keep_frac)
    idx, xpack = select_groups(x.reshape(1, K), G, k_keep, threshold)
    y = block_gemv.block_gather_gemv_multi(
        idx, xpack, [{"qp": w["qp"][None], "sz": w["sz"][None]}], 0, G, 1)
    return y.to(x.dtype).reshape(*x.shape[:-1], N)


# -- whole-model quantization ------------------------------------------------

def int4_dict_matmul(x: torch.Tensor, w: Dict) -> torch.Tensor:
    """Dense matmul against an int4 dict {"q", "scale", "zero"}; the group
    size is K // n_groups."""
    group = w["q"].shape[-2] // w["scale"].shape[-2]
    return int4_matmul(x, Int4Weight(q=w["q"], scale=w["scale"],
                                     zero=w["zero"], group=group))


def _quant_stack_int8(stack: torch.Tensor):
    """Per-matrix int8 of a [..., K, N] stack (layers, or layers and
    experts), one matrix at a time so that no fp32 copy of the stack is
    made. Returns (q [..., K, N], scale [..., N])."""
    flat = stack.reshape(-1, *stack.shape[-2:])
    q = torch.empty(flat.shape, dtype=torch.int8, device=stack.device)
    s = torch.empty((flat.shape[0], flat.shape[-1]), dtype=torch.float32,
                    device=stack.device)
    for i in range(flat.shape[0]):
        q[i], s[i] = quantize_int8(flat[i])
    return q.reshape(stack.shape), s.reshape(*stack.shape[:-2], -1)


def quantize_params_int8(params) -> Dict:
    """Quantize the seven projection stacks AND lm_head to int8 (per layer,
    per channel): each projection becomes {"q": int8 [L, K, N], "scale":
    fp32 [L, N]} (expert stacks [L, E, K, N] -> scale [L, E, N]), lm_head
    {"q": int8 [D, V], "scale": [V]}. Norms and embeddings stay."""
    out = {k: v for k, v in params.items() if k != "layers"}
    head = quantize_int8(out["lm_head"])
    out["lm_head"] = {"q": head.q, "scale": head.scale}
    layers = {}
    for name, stack in params["layers"].items():
        if name in _QUANT_KEYS:
            q, s = _quant_stack_int8(stack)
            layers[name] = {"q": q, "scale": s}
        else:
            layers[name] = stack
    out["layers"] = layers
    return out


def quantize_params_int4(params, group: int = 128) -> Dict:
    """Quantize the seven projection stacks and lm_head to groupwise
    affine int4 (round to nearest): each projection becomes {"q": int8
    [L, K, N] holding [-8, 7], "scale": [L, K//g, N], "zero": [L, K//g, N]},
    with g halved until it divides the projection's input dim."""
    out = {k: v for k, v in params.items() if k != "layers"}
    gh = group
    while out["lm_head"].shape[0] % gh:
        gh //= 2
    head = quantize_int4(out["lm_head"], group=gh)
    out["lm_head"] = {"q": head.q, "scale": head.scale, "zero": head.zero}
    layers = {}
    for name, stack in params["layers"].items():
        if name not in _QUANT_KEYS:
            layers[name] = stack
            continue
        L, K, N = stack.shape
        g = group
        while K % g:
            g //= 2
        dev = stack.device
        q = torch.empty((L, K, N), dtype=torch.int8, device=dev)
        s = torch.empty((L, K // g, N), dtype=torch.float32, device=dev)
        z = torch.empty((L, K // g, N), dtype=torch.float32, device=dev)
        for l in range(L):
            wq = quantize_int4(stack[l], group=g)
            q[l], s[l], z[l] = wq.q, wq.scale, wq.zero
        layers[name] = {"q": q, "scale": s, "zero": z}
    out["layers"] = layers
    return out


def param_is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and "q" in leaf and "scale" in leaf


def dequantize_int4_dict(w: Dict, dtype=torch.bfloat16) -> torch.Tensor:
    K, N = w["q"].shape[-2:]
    g = K // w["scale"].shape[-2]
    qf = (w["q"].float() + 8.0).reshape(*w["q"].shape[:-2], K // g, g, N)
    wf = qf * w["scale"][..., :, None, :] + w["zero"][..., :, None, :]
    return wf.reshape(w["q"].shape).to(dtype)
