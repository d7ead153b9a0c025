"""Kernel K2: single-token decode attention over the stacked KV cache.

Port of `teal_tpu/ops/decode_attention.py` as it runs inside the
attention block (`teal_tpu/ops/attn_block.py:attn_stage`): RoPE on the
fp32 q / current k, the in-place write of the current token's K/V at
`pos`, and GQA attention over the live rows t < pos (t > pos - window
with a window) plus the current token, fp32 softmax, output in the cache
type. `decode_attention` launches `csrc/decode_attention.cu` on CUDA
tensors and runs `decode_attention_plain` on CPU tensors.

The cache is updated in place (the JAX kernel aliases it input->output).
"""

from __future__ import annotations

from typing import Optional

import torch

from teal_tpu_torch import _build

HEAD_DIM = 128
MAX_GROUP = 8                    # query heads per kv head in the kernel
_SMEM_BYTES = 227 * 1024         # a block's shared memory on Hopper
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rope_rows(x: torch.Tensor, rope: torch.Tensor) -> torch.Tensor:
    """HF rotate-half RoPE in fp32. x: [B, H, D]; rope: [B, 2, D] rows
    (cos, sin) at each sequence's position."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * rope[:, None, 0] + rot * rope[:, None, 1]


def decode_attention_plain(q, k_new, v_new, kc, vc, layer: int, pos, *,
                           window: Optional[int] = None, rope=None):
    """K2 in plain PyTorch (same arguments and result as
    `decode_attention`): one exact softmax pass per kv head."""
    B, Hq, D = q.shape
    Hkv = k_new.shape[1]
    GH = Hq // Hkv
    cdt = kc.dtype
    if rope is not None:
        q, k_new = rope_rows(q, rope), rope_rows(k_new, rope)
    q = q * (1.0 / D ** 0.5)
    out = torch.empty((B, Hq, D), dtype=cdt, device=q.device)
    for b in range(B):
        p = int(pos[b])
        lo = max(p - window + 1, 0) if window else 0
        ks = kc[layer, b, :, lo:p].float()               # [Hkv, n, D]
        vs = vc[layer, b, :, lo:p].float()
        qg = q[b].reshape(Hkv, GH, D)
        s = torch.einsum("hgd,htd->hgt", qg.to(cdt).float(), ks)
        sc = (qg * k_new[b][:, None, :]).sum(-1, keepdim=True)
        m = torch.cat([s, sc], dim=-1).amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        ec = torch.exp(sc - m)
        den = e.sum(dim=-1, keepdim=True) + ec
        pv = torch.einsum("hgt,htd->hgd", e.to(cdt).float(), vs)
        o = (pv + ec * v_new[b][:, None, :]) * (1.0 / den)
        out[b] = o.reshape(Hq, D).to(cdt)
        kc[layer, b, :, p] = k_new[b].to(cdt)
        vc[layer, b, :, p] = v_new[b].to(cdt)
    return out


def _check(q, k_new, v_new, kc, vc, layer, pos, window, rope):
    if q.dim() != 3 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"q must be [B, Hq, {HEAD_DIM}]; got "
                         f"{tuple(q.shape)}")
    B, Hq, D = q.shape
    if kc.dim() != 5 or kc.shape[1] != B or kc.shape[4] != D:
        raise ValueError(f"caches must be [L, {B}, Hkv, T, {D}]; got "
                         f"{tuple(kc.shape)}")
    L, _, Hkv, T, _ = kc.shape
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}, at most "
                         f"{MAX_GROUP}x")
    if vc.shape != kc.shape or vc.dtype != kc.dtype or \
            kc.dtype not in _DTYPE_CODE:
        raise ValueError("k/v caches must share one shape and fp32/bf16 type")
    for name, t, shape in (("q", q, (B, Hq, D)), ("k_new", k_new, (B, Hkv, D)),
                           ("v_new", v_new, (B, Hkv, D)),
                           ("rope", rope, (B, 2, D))):
        if t is not None and (t.shape != shape or t.dtype != torch.float32
                              or not t.is_contiguous()
                              or t.device != kc.device):
            raise ValueError(f"{name} must be contiguous fp32 {shape} on "
                             f"the cache's device")
    for t in (kc, vc):
        if not t.is_contiguous():
            raise ValueError("caches must be contiguous")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    if (pos.shape != (B,) or pos.dtype != torch.int32
            or pos.device != kc.device):
        raise ValueError(f"pos must be int32 [{B}] on the cache's device")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive; got {window}")
    GH = Hq // Hkv
    if 4 * (2 * GH * D + 2 * D + 64 + GH * T) > _SMEM_BYTES:
        raise ValueError(f"score row of {GH} heads x T={T} does not fit "
                         "one block's shared memory")


def decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                     layer: int, pos, *, window: Optional[int] = None,
                     rope: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token attention for layer `layer` of a stacked cache.

    q:     [B, Hq, 128] fp32 projection sums (RoPE and 1/sqrt(128) are
           applied here)
    k_new: [B, Hkv, 128] fp32 current keys (RoPE applied here), v_new
           likewise (no RoPE); both are written, cast to the cache type,
           at row pos[b] of layer `layer`
    kc/vc: [L, B, Hkv, T, 128] caches, updated in place
    pos:   int32 [B] tensor (or an int) of current positions
    rope:  [B, 2, 128] fp32 (cos, sin) rows at pos, or None for no RoPE

    Returns attn [B, Hq, 128] in the cache type.
    """
    if isinstance(pos, int):
        if not 0 <= pos < kc.shape[3]:
            raise ValueError(f"pos {pos} out of range [0, {kc.shape[3]})")
        pos = torch.full((q.shape[0],), pos, dtype=torch.int32,
                         device=kc.device)
    _check(q, k_new, v_new, kc, vc, layer, pos, window, rope)
    if kc.device.type == "cpu":
        return decode_attention_plain(q, k_new, v_new, kc, vc, layer, pos,
                                      window=window, rope=rope)
    if kc.device.type != "cuda" or \
            kc.device.index != torch.cuda.current_device():
        raise ValueError(f"decode_attention runs on the current CUDA device "
                         f"or the CPU; got {kc.device}")
    if rope is None:
        rope = torch.zeros((q.shape[0], 2, HEAD_DIM), dtype=torch.float32,
                           device=kc.device)
        rope[:, 0] = 1.0
    lib = _build.load()["decode_attention"]
    B, Hq, D = q.shape
    out = torch.empty((B, Hq, D), dtype=kc.dtype, device=kc.device)
    err = lib.teal_decode_attention(
        _DTYPE_CODE[kc.dtype], q.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), rope.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        pos.data_ptr(), out.data_ptr(), B, Hq, kc.shape[2], kc.shape[3],
        layer, window or 0, 1.0 / D ** 0.5,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
