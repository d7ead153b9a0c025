"""The attention stage of single-token decode: K8, or K1 then K2.

Port of `teal_tpu/ops/attn_block.py`: the stage `attn_stage` and its
one-launch form `attn_block` (batch 1). The stage computes the folded
rms_norm, the group selection, the q|k|v gather in fp32, RoPE (q then
scaled by 1/sqrt(128)), the in-place write of the current token's K/V and
GQA attention, output in the cache type. `attn_stage` takes one of two
routes, decided from the call's form and shapes before any launch:
  - K8 `attn_block` (`csrc/attn_block.cu`): the whole stage in one launch
    for one row (batch 1) of weights that are arrays of the stream type
    or packed int4 {"qp", "sz"} (G >= 64), the cache of the stream type,
    head_dim 128, 1, 2, 4 or 8 query heads a kv head, threshold or fixed
    selection, with or without a window, where `k8_plan` has a launch
    plan for the shapes (`k8_route`). q|k|v never leave the kernel. On
    CPU tensors the wrapper runs its plain version, `attn_block_plain`;
  - every other form (int8 with its per-channel scales, rows B 2-16,
    `seq_block`, a shape K8 cannot plan), as before K8, two kernels:
    1. K1 (`block_gemv.select_gather_gemv`): folded rms_norm (per row),
       group selection (one kept set for all rows, pooled scores), and the
       q|k|v gather into one fp32 [B, n_tot] tensor (with int8 weights,
       the per-channel scales applied to it in K1's epilogue, so that RoPE
       sees scaled values, as in the Pallas kernel);
    2. K2 (`decode_attention.decode_attention`): RoPE on q and the current
       k in fp32 at each row's own position, q scaled by 1/sqrt(128), the
       in-place cache write, and GQA attention; output in the cache type.
       K2 reads q, k and v as strided views of K1's output.
    q/k/v stay fp32 between the two, as they do inside the Pallas kernel.
    With `seq_block` the rows are consecutive positions of one sequence
    in cache row 0 (the reference's `cache_rows=(0,)*B`).
K8's plain version is that composition of K1's and K2's plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from teal_tpu_torch import _build
from teal_tpu_torch.ops.block_gemv import (_DTYPE_CODE, _H100_SMS,
                                           GROUP_SIZES, PLAN_INT4,
                                           PLAN_STREAM, _check_launch_device,
                                           _check_weights, _weight_kind,
                                           _width, select_gather_gemv,
                                           select_gather_gemv_plain)
from teal_tpu_torch.ops.decode_attention import (HEAD_DIM, decode_attention,
                                                 decode_attention_plain)

# K8's launch plan on the card (`csrc/attn_block.cu`, `Layout` and
# `ab_plan`, which `_k8_smem` and `k8_plan` mirror; chip_smoke.py and the
# card tests hold them together through `teal_attn_block_plan`)
K8_HEAD_GROUPS = (1, 2, 4, 8)    # query heads a kv head
_K8_WARPS = 8
_K8_MAX_CLUSTER = 8              # blocks a cluster (the portable size)
_K8_MAXGH = 8
_K8_MISC = 64                    # floats of scratch
_SMEM_BYTES = 232448             # a block's shared memory on Hopper
_SMEM_SM = 233472                # an SM's
_SMEM_RESERVED = 1024            # the runtime's share of a block


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def _k8_smem(K: int, G: int, cap: int, GH: int) -> int:
    """K8's shared memory a block in bytes (the kernel's `Layout::total`):
    the selection input [K] fp32, the scores [K/G], the kept groups and
    count [cap + 1], 64 floats of scratch, the warps' sums [8][ncol], the
    block's partial sums, the head's sums and the RoPE'd q|k|v [ncol]
    each, the current token's scores [8], and the block's attention state
    (maxima and denominators [16], PV sums [GH][128]); ncol = (GH + 2) *
    128. Every term is fp32 or int32, whatever the stream type, and none
    depends on T."""
    ncol = (GH + 2) * HEAD_DIM
    return 4 * (_pad4(K) + _pad4(K // G) + _pad4(cap + 1) + _K8_MISC
                + _K8_WARPS * ncol + 3 * ncol + _K8_MAXGH
                + 2 * _K8_MAXGH + GH * HEAD_DIM)


def k8_blocks_an_sm(code: int, plan: int, GH: int, smem: int) -> int:
    """The blocks of K8's instance for (stream type code: 0 fp32, 1 bf16;
    weight plan; GH query heads a kv head) that an SM holds at once, at
    `smem` shared bytes a block: two for bf16 arrays at GH <= 4 (103-127
    registers a thread in ptxas' report, two blocks' worth within the
    SM's 65536) where two blocks' shared memory fits, else one (fp32,
    int4 and GH 8 take 146-255). chip_smoke.py's `check_k8_plan` holds it
    to the card's reading (`teal_attn_block_clusters`)."""
    two = code == 1 and plan == PLAN_STREAM and GH <= 4
    return 2 if two and 2 * (smem + _SMEM_RESERVED) <= _SMEM_SM else 1


def k8_plan(code: int, plan: int, G: int, K: int, Hq: int, Hkv: int,
            cap: int, n_sms: int = _H100_SMS
            ) -> Optional[Tuple[int, int, int]]:
    """K8's launch plan from types and shapes only: (C blocks a cluster,
    grid, shared bytes), or None where they take none. `code` the stream
    type's (0 fp32, 1 bf16). One cluster a kv head; GH = Hq / Hkv in
    `K8_HEAD_GROUPS`; G in `GROUP_SIZES` dividing K, packed int4 (`plan`
    PLAN_INT4) at G >= 64; 1 <= cap <= K / G; the layout within a block's
    shared memory; C the largest size <= 8 with 4 * Hkv * C <= 3 * b *
    n_sms, at least 1, b = `k8_blocks_an_sm`. The 7B's 32 kv heads on the
    H100: bf16 arrays C = 6 (192 blocks, two an SM), the fastest of C =
    2-8 in turns (`tools/k8_check.py --clusters`; C = 8 leaves 30
    clusters resident, a second wave); fp32 and int4 C = 3 (one an SM:
    C = 6 ran int4 in two waves, 1.22-1.38x C = 3's time)."""
    if Hkv < 1 or Hq < Hkv or Hq % Hkv or Hq // Hkv not in K8_HEAD_GROUPS:
        return None
    if G not in GROUP_SIZES or plan not in (PLAN_STREAM, PLAN_INT4) or (
            plan == PLAN_INT4 and G < 64):
        return None
    if K <= 0 or K % G or not 1 <= cap <= K // G:
        return None
    smem = _k8_smem(K, G, cap, Hq // Hkv)
    if smem > _SMEM_BYTES:
        return None
    b = k8_blocks_an_sm(code, plan, Hq // Hkv, smem)
    C = 1
    while C < _K8_MAX_CLUSTER and 4 * Hkv * (C + 1) <= 3 * b * n_sms:
        C += 1
    return C, Hkv * C, smem


def _k8_weight_plan(ws, dtype) -> Optional[int]:
    """PLAN_STREAM (three arrays of the stream type), PLAN_INT4 (three
    packed int4 dicts) or None (int8, or a mix)."""
    kinds = {_weight_kind(w) for w in ws}
    if kinds == {"array"} and all(w.dtype == dtype for w in ws):
        return PLAN_STREAM
    if kinds == {"int4"}:
        return PLAN_INT4
    return None


def _k8_form(h: torch.Tensor, ws, kc: torch.Tensor, n_heads: int,
             scales=None, seq_block: bool = False) -> Tuple[Optional[int],
                                                            str]:
    """K8's form, from the call's types and shapes: (weight plan, "") for
    one row (h [D] or [1, D]) of fp32 or bf16, no int8 scales and no
    seq_block, the cache [L, 1, Hkv, T, 128] of h's type and the weights
    three arrays of h's type or three packed int4 dicts of n_heads, Hkv
    and Hkv heads; else (None, the reason). `k8_route` and the wrapper's
    checks both ask it."""
    if scales is not None or seq_block:
        return None, "int8 scales and seq_block take K1 then K2"
    if (h.dtype not in _DTYPE_CODE or h.numel() != h.shape[-1]
            or h.dim() > 2):
        return None, (f"h must be one fp32/bf16 row [K] or [1, K]; got "
                      f"{h.dtype} {tuple(h.shape)}")
    if (kc.dim() != 5 or kc.shape[1] != 1 or kc.shape[4] != HEAD_DIM
            or kc.dtype != h.dtype):
        return None, (f"the cache must be [L, 1, Hkv, T, {HEAD_DIM}] of h's "
                      f"type; got {kc.dtype} {tuple(kc.shape)}")
    plan = _k8_weight_plan(ws, h.dtype)
    if plan is None:
        return None, ("K8 takes wq, wk, wv as arrays of the stream type or "
                      "packed int4 dicts (int8 takes K1 then K2)")
    widths = [_width(w) for w in ws]
    if widths != [n_heads * HEAD_DIM, kc.shape[2] * HEAD_DIM,
                  kc.shape[2] * HEAD_DIM]:
        return None, (f"wq, wk, wv must be {n_heads} and {kc.shape[2]} "
                      f"heads of {HEAD_DIM} columns; got widths {widths}")
    return plan, ""


def k8_route(h: torch.Tensor, wq, wk, wv, kc: torch.Tensor, n_heads: int,
             cap: int, G: int, scales=None, seq_block: bool = False) -> bool:
    """Whether `attn_stage` takes K8, from the call's form and shapes
    alone: K8's form (`_k8_form`) and a launch plan for the shapes
    (`k8_plan` on the card's SM count, the H100's for a CPU tensor)."""
    plan, _ = _k8_form(h, (wq, wk, wv), kc, n_heads, scales, seq_block)
    if plan is None:
        return False
    sms = (_build.sm_count(h.device.index) if h.device.type == "cuda"
           else _H100_SMS)
    return k8_plan(_DTYPE_CODE[h.dtype], plan, G, h.shape[-1], n_heads,
                   kc.shape[2], cap, sms) is not None


def attn_block_plain(h: torch.Tensor, thr: torch.Tensor, wq, wk, wv,
                     layer: int, cap: int, norm: Optional[torch.Tensor],
                     norm_eps: float, kc: torch.Tensor, vc: torch.Tensor,
                     pos: torch.Tensor, rope: torch.Tensor, *, n_heads: int,
                     window: Optional[int] = None, G: int = 128,
                     fixed: bool = False):
    """K8 in plain PyTorch (same arguments and results as `attn_block`):
    K1's plain version on q|k|v, then K2's on its fp32 sums."""
    qkv, idx, count = select_gather_gemv_plain(h, thr, (wq, wk, wv), layer,
                                               cap, G=G, norm=norm,
                                               norm_eps=norm_eps,
                                               fixed=fixed)
    row = qkv.reshape(1, -1)
    hkv = kc.shape[2]
    nq, nk = n_heads * HEAD_DIM, hkv * HEAD_DIM
    attn = decode_attention_plain(
        row[:, :nq].view(1, n_heads, HEAD_DIM),
        row[:, nq:nq + nk].view(1, hkv, HEAD_DIM),
        row[:, nq + nk:].view(1, hkv, HEAD_DIM), kc, vc, layer,
        pos.reshape(1), window=window, rope=rope)
    return attn.view(*h.shape[:-1], nq), idx, count


def _check_k8(h, thr, ws, layer, cap, norm, kc, vc, pos, rope, n_heads,
              window, G):
    """Raise on what K8 does not take; return (L, weight plan). Whether
    K8 has a launch plan for the shapes is the kernel's to say (it returns
    cudaErrorInvalidValue where `k8_plan` has none)."""
    plan, why = _k8_form(h, ws, kc, n_heads)
    if plan is None:
        raise ValueError(why)
    if not h.is_contiguous():
        raise ValueError("h must be contiguous")
    K = h.shape[-1]
    if G not in GROUP_SIZES or K % G:
        raise ValueError(f"group size {G} must be one of {GROUP_SIZES} and "
                         f"divide K={K}")
    L, _ = _check_weights(ws, K, h.dtype, h.device, G)
    if kc.shape[0] != L:
        raise ValueError(f"caches must be [{L}, 1, Hkv, T, {HEAD_DIM}]; "
                         f"got {tuple(kc.shape)}")
    if (vc.shape != kc.shape or vc.dtype != kc.dtype
            or not kc.is_contiguous() or not vc.is_contiguous()
            or kc.device != h.device or vc.device != h.device):
        raise ValueError("k/v caches must be contiguous, of one shape and "
                         "of h's type, on h's device")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    if not 1 <= cap <= K // G:
        raise ValueError(f"cap {cap} out of range [1, {K // G}]")
    if (thr.dtype != torch.float32 or thr.numel() != 1
            or thr.device != h.device):
        raise ValueError("thr must be one fp32 value on h's device")
    if norm is not None and (norm.shape != (L, K) or norm.dtype != h.dtype
                             or norm.device != h.device
                             or not norm.is_contiguous()):
        raise ValueError(f"norm must be a contiguous [L, K] stack of h's "
                         f"type; got {norm.dtype} {tuple(norm.shape)}")
    if (pos.numel() != 1 or pos.dtype != torch.int32
            or pos.device != h.device):
        raise ValueError("pos must be one int32 value on h's device")
    if (rope.shape != (1, 2, HEAD_DIM) or rope.dtype != torch.float32
            or not rope.is_contiguous() or rope.device != h.device):
        raise ValueError(f"rope must be contiguous fp32 (1, 2, {HEAD_DIM}) "
                         f"on h's device")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive; got {window}")
    return L, plan


def attn_block(h: torch.Tensor, thr: torch.Tensor, wq, wk, wv, layer: int,
               cap: int, norm: Optional[torch.Tensor], norm_eps: float,
               kc: torch.Tensor, vc: torch.Tensor, pos: torch.Tensor,
               rope: torch.Tensor, *, n_heads: int,
               window: Optional[int] = None, G: int = 128,
               fixed: bool = False):
    """K8: the attention stage of one row in one launch.

    h:    [K] or [1, K] raw residual stream (fp32 or bf16; rms_norm folded
          in with `norm`, the [L, K] gains, else h is the selection input)
    thr:  one fp32 group-score threshold (a 0-d view into the [L, 7]
          table works: the kernel reads it on the device)
    wq/wk/wv: [L, K, N] of h's type, or packed int4 {"qp" int8 [L, K/2,
          N], "sz" fp32 [L, K/G, 2, N]} (G >= 64); N = n_heads * 128 for
          wq, Hkv * 128 for wk and wv
    kc/vc: [L, 1, Hkv, T, 128] of h's type, row `pos` of layer `layer`
          written in place
    pos:  int32 [1] on the device (the kernel traps outside [0, T));
    rope: [1, 2, 128] fp32 (cos, sin) rows at pos
    fixed: keep groups 0..cap-1 without scoring

    Returns (attn of h's leading shape + [n_heads * 128] in the cache
    type, idx [cap] int32 (the kept groups ascending, -1 past the count),
    count [1] int32).
    """
    L, plan = _check_k8(h, thr, (wq, wk, wv), layer, cap, norm, kc, vc, pos,
                        rope, n_heads, window, G)
    if h.device.type == "cpu":
        return attn_block_plain(h, thr, wq, wk, wv, layer, cap, norm,
                                norm_eps, kc, vc, pos, rope, n_heads=n_heads,
                                window=window, G=G, fixed=fixed)
    _check_launch_device(h, "attn_block")
    K, Hkv, T = h.shape[-1], kc.shape[2], kc.shape[3]
    if h.data_ptr() % 16 or (norm is not None and norm.data_ptr() % 16):
        raise ValueError("K8 reads h and norm in 16-byte chunks: both must "
                         "be 16-byte aligned")
    int4 = plan == PLAN_INT4
    w = [(t["qp"] if int4 else t).data_ptr() for t in (wq, wk, wv)]
    sz = [t["sz"].data_ptr() if int4 else None for t in (wq, wk, wv)]
    out = torch.empty((*h.shape[:-1], n_heads * HEAD_DIM), dtype=h.dtype,
                      device=h.device)
    sel = torch.empty(cap + 1, dtype=torch.int32, device=h.device)
    lib = _build.load()["attn_block"]
    err = lib.teal_attn_block(
        _DTYPE_CODE[h.dtype], plan, h.data_ptr(), thr.data_ptr(),
        None if norm is None else norm.data_ptr(), norm_eps, *w, *sz,
        kc.data_ptr(), vc.data_ptr(), rope.data_ptr(), pos.data_ptr(),
        out.data_ptr(), sel.data_ptr(), sel.data_ptr() + 4 * cap, K, G, cap,
        int(fixed), layer, L, n_heads, Hkv, T, window or 0,
        1.0 / HEAD_DIM ** 0.5, _build.sm_count(h.device.index),
        torch.cuda.current_stream().cuda_stream)
    if err == -1:
        raise RuntimeError(f"attn_block: no cluster of K8's plan ({Hkv} kv "
                           f"heads) can be resident on this card")
    _build.check(err, "attn_block")
    attn_block.launches += 1
    return out, sel[:cap], sel[cap:]


attn_block.launches = 0


def k8_card_plan(code: int, plan: int, G: int, K: int, Hq: int, Hkv: int,
                 cap: int, n_sms: int = 0) -> Optional[Tuple[int, int, int]]:
    """The kernel's own plan (`teal_attn_block_plan`) for these types and
    shapes (`k8_plan`'s arguments), on
    `n_sms` SMs (0: the current card's): (C, grid, shared bytes) or None.
    Builds the library where needed (the card checks hold `k8_plan` to
    it)."""
    import ctypes

    out = (ctypes.c_int * 3)()
    lib = _build.load()["attn_block"]
    rc = lib.teal_attn_block_plan(code, plan, G, K, Hq, Hkv, cap, n_sms,
                                  ctypes.addressof(out))
    return None if rc != 0 else tuple(out)


def attn_stage(h: torch.Tensor, thr: torch.Tensor, wq, wk, wv, layer: int,
               cap: int, norm: torch.Tensor, norm_eps: float,
               kc: torch.Tensor, vc: torch.Tensor, pos: torch.Tensor,
               rope: torch.Tensor, *, n_heads: int,
               window: Optional[int] = None, G: int = 128, scales=None,
               fixed: bool = False, seq_block: bool = False):
    """h: [D] or rows [B, D] raw residual stream; wq/wk/wv: K1 operands
    of one plan; norm: [L, D] attention-norm gains; kc/vc: [L, B, Hkv, T,
    128] ([L, 1, ...] with seq_block; updated in place); pos: int32 [B];
    rope: [B, 2, 128] (cos, sin) rows at pos; G: K1's group size; scales:
    int8 only, the q/k/v per-channel scale stacks [L, N]; fixed: keep
    groups 0..cap-1; seq_block: see the module docstring.

    One launch of K8 where `k8_route` holds, else K1 then K2.

    Returns (attn of h's leading shape + [n_heads * 128] in the cache
    type, kept-group count).
    """
    if k8_route(h, wq, wk, wv, kc, n_heads, cap, G, scales, seq_block):
        attn, _, count = attn_block(h, thr, wq, wk, wv, layer, cap, norm,
                                    norm_eps, kc, vc, pos, rope,
                                    n_heads=n_heads, window=window, G=G,
                                    fixed=fixed)
        return attn, count
    qkv, _, count = select_gather_gemv(h, thr, (wq, wk, wv), layer, cap,
                                       G=G, norm=norm, norm_eps=norm_eps,
                                       scales=scales, fixed=fixed)
    rows = qkv.view(-1, qkv.shape[-1])
    B, hkv = rows.shape[0], kc.shape[2]
    nq, nk = n_heads * HEAD_DIM, hkv * HEAD_DIM
    q = rows[:, :nq].view(B, n_heads, HEAD_DIM)
    k = rows[:, nq:nq + nk].view(B, hkv, HEAD_DIM)
    v = rows[:, nq + nk:].view(B, hkv, HEAD_DIM)
    attn = decode_attention(q, k, v, kc, vc, layer, pos, window=window,
                            rope=rope, seq_block=seq_block)
    return attn.view(*h.shape[:-1], nq), count
