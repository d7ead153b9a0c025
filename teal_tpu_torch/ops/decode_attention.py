"""Kernel K2: single-token decode attention over the stacked KV cache.

Port of `teal_tpu/ops/decode_attention.py` as it runs inside the
attention block (`teal_tpu/ops/attn_block.py:attn_stage`): RoPE on the
fp32 q / current k, the in-place write of the current token's K/V at
`pos`, and GQA attention over the live rows t < pos (t > pos - window
with a window) plus the current token, fp32 softmax, output in the cache
type. `decode_attention` launches `csrc/decode_attention.cu` on CUDA
tensors and runs `decode_attention_plain` on CPU tensors.

The cache is updated in place (the JAX kernel aliases it input->output).

The kernel splits the live rows of each (row, kv head) over a cluster of
S <= 8 blocks; `_splits` picks S from the shapes alone and `_plan` fits
it to shared memory. The split changes no rounding point, so every S
gives the plain version's result within the same tolerance.

`seq_block=True` is the verify path's form (`attn_block.attn_stage` with
`cache_rows=(0,)*B`): the B slots are consecutive positions pos[0] + i of
one sequence in cache row 0, and slot i attends to the slots before it
as if each slot's row were written before the next slot reads.
"""

from __future__ import annotations

from typing import Optional

import torch

from teal_tpu_torch import _build

HEAD_DIM = 128
MAX_GROUP = 8                    # query heads per kv head in the kernel
MAX_SEQ_BLOCK = 16               # slots of a seq_block launch
MAX_SPLITS = 8                   # blocks of a cluster (the portable size)
_SMEM_BYTES = 227 * 1024         # a block's shared memory on Hopper
_TILE_BYTES = 16384              # a stage of the kernel's tile ring
_BLOCKS_PER_SM = 2               # the split rule's aim
_MIN_SPLIT_ROWS = 32             # cache rows a split has at least, at T
_H100_SMS = 132
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rope_rows(x: torch.Tensor, rope: torch.Tensor) -> torch.Tensor:
    """HF rotate-half RoPE in fp32. x: [B, H, D]; rope: [B, 2, D] rows
    (cos, sin) at each sequence's position."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * rope[:, None, 0] + rot * rope[:, None, 1]


def decode_attention_plain(q, k_new, v_new, kc, vc, layer: int, pos, *,
                           window: Optional[int] = None, rope=None,
                           seq_block: bool = False):
    """K2 in plain PyTorch (same arguments and result as
    `decode_attention`): one exact softmax pass per kv head, slot by slot,
    each slot's cache row written before the next slot reads."""
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
        cb = 0 if seq_block else b
        lo = max(p - window + 1, 0) if window else 0
        ks = kc[layer, cb, :, lo:p].float()              # [Hkv, n, D]
        vs = vc[layer, cb, :, lo:p].float()
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
        kc[layer, cb, :, p] = k_new[b].to(cdt)
        vc[layer, cb, :, p] = v_new[b].to(cdt)
    return out


def _splits(B: int, Hkv: int, T: int, seq_block: bool, n_sms: int) -> int:
    """Blocks a cluster, from shapes only (never from pos, which lives on
    the device): the largest power of two S <= 8 that keeps the grid at
    about `_BLOCKS_PER_SM` blocks an SM and gives each split at least
    `_MIN_SPLIT_ROWS` rows of a full cache of T rows. A seq_block launch
    has one cluster per kv head (B = 1 here)."""
    clusters = Hkv * (1 if seq_block else B)
    S = 1
    while (2 * S <= MAX_SPLITS
           and clusters * 2 * S <= _BLOCKS_PER_SM * n_sms
           and T // (2 * S) >= _MIN_SPLIT_ROWS):
        S *= 2
    return S


def _smem_bytes(esz: int, GH: int, slots: int, nreb: int, T: int,
                S: int) -> int:
    """One block's shared memory (the kernel's `Layout::total`, which the
    card tests hold this to through `teal_decode_attention_smem`): the
    tile ring (up to 4 stages, as many as K and V take at T); for
    `slots` * GH query rows q rounded (esz bytes), the fp32 partial PV
    and the peers' parts of it; the `nreb` rebuilt k/v rows of a
    seq_block launch; the current keys and values; three per-query-row
    scalars and the S peers' maxima and sums; the score slice of
    ceil(T / S) rows, padded to a multiple of 4."""
    QR = slots * GH
    rows = -(-T // S)                  # a block's rows, at most
    stages = min(4, 2 * -(-rows // (_TILE_BYTES // (HEAD_DIM * esz))))
    return (stages * _TILE_BYTES + 64 + QR * HEAD_DIM * (esz + 8)
            + 2 * nreb * HEAD_DIM * esz + 2 * slots * HEAD_DIM * 4
            + (3 + 2 * S) * 4 * _pad4(QR) + QR * _pad4(rows) * 4)


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def _plan(B: int, Hq: int, Hkv: int, T: int, seq_block: bool, esz: int,
          n_sms: int = _H100_SMS):
    """(S, slots a cluster) for a launch, or None when no plan fits one
    block's shared memory. S starts at `_splits`; a seq_block launch
    serves all B slots from one cluster per kv head where they fit, else
    the fewest groups of slots that do; S grows only when one slot does
    not fit."""
    GH = Hq // Hkv
    nreb = B - 1 if seq_block else 0
    S = _splits(B, Hkv, T, seq_block, n_sms)
    while S <= MAX_SPLITS:
        for groups in range(1, (B if seq_block else 1) + 1):
            slots = -(-B // groups) if seq_block else 1
            if _smem_bytes(esz, GH, slots, nreb, T, S) <= _SMEM_BYTES:
                return S, slots
        S *= 2
    return None


def _rows_ok(t, shape) -> bool:
    """An fp32 [B, H, 128] tensor whose rows may be strided (a view into
    K1's [B, n_tot] q|k|v output), each row contiguous."""
    return (t.shape == shape and t.dtype == torch.float32
            and t.stride()[1:] == (HEAD_DIM, 1))


def _check(q, k_new, v_new, kc, vc, layer, pos, window, rope, seq_block,
           n_sms=_H100_SMS):
    """Raise on what the kernel does not take; return its `_plan`."""
    if q.dim() != 3 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"q must be [B, Hq, {HEAD_DIM}]; got "
                         f"{tuple(q.shape)}")
    B, Hq, D = q.shape
    bc = 1 if seq_block else B
    if kc.dim() != 5 or kc.shape[1] != bc or kc.shape[4] != D:
        raise ValueError(f"caches must be [L, {bc}, Hkv, T, {D}]; got "
                         f"{tuple(kc.shape)}")
    if seq_block and B > MAX_SEQ_BLOCK:
        raise ValueError(f"a seq_block launch takes at most "
                         f"{MAX_SEQ_BLOCK} slots; got {B}")
    L, _, Hkv, T, _ = kc.shape
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}, at most "
                         f"{MAX_GROUP}x")
    if vc.shape != kc.shape or vc.dtype != kc.dtype or \
            kc.dtype not in _DTYPE_CODE:
        raise ValueError("k/v caches must share one shape and fp32/bf16 type")
    for name, t, shape in (("q", q, (B, Hq, D)), ("k_new", k_new, (B, Hkv, D)),
                           ("v_new", v_new, (B, Hkv, D))):
        if not _rows_ok(t, shape) or t.device != kc.device:
            raise ValueError(f"{name} must be fp32 {shape} rows, each "
                             f"contiguous, on the cache's device")
    if k_new.stride(0) != v_new.stride(0):
        raise ValueError("k_new and v_new must share one row stride")
    if rope is not None and (rope.shape != (B, 2, D)
                             or rope.dtype != torch.float32
                             or not rope.is_contiguous()
                             or rope.device != kc.device):
        raise ValueError(f"rope must be contiguous fp32 {(B, 2, D)} on the "
                         f"cache's device")
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
    plan = _plan(B, Hq, Hkv, T, seq_block, kc.element_size(), n_sms)
    if plan is None:
        raise ValueError(f"the score slices of {Hq // Hkv} heads x T={T} do "
                         f"not fit one block's shared memory at "
                         f"{MAX_SPLITS} splits")
    return plan


def decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                     layer: int, pos, *, window: Optional[int] = None,
                     rope: Optional[torch.Tensor] = None,
                     seq_block: bool = False) -> torch.Tensor:
    """Single-token attention for layer `layer` of a stacked cache.

    q:     [B, Hq, 128] fp32 projection sums (RoPE and 1/sqrt(128) are
           applied here); rows may be strided, each row contiguous
    k_new: [B, Hkv, 128] fp32 current keys (RoPE applied here), v_new
           likewise (no RoPE; same row stride); both are written, cast to
           the cache type, at row pos[b] of layer `layer`
    kc/vc: [L, B, Hkv, T, 128] caches ([L, 1, ...] with seq_block),
           updated in place
    pos:   int32 [B] tensor (or an int) of current positions; with
           seq_block, pos[0] + i for slot i (the kernel traps otherwise)
    rope:  [B, 2, 128] fp32 (cos, sin) rows at pos, or None for no RoPE
    seq_block: the B (<= 16) slots are consecutive positions of cache
           row 0; slot i sees slots < i

    Returns attn [B, Hq, 128] in the cache type.
    """
    if isinstance(pos, int):
        if not 0 <= pos < kc.shape[3]:
            raise ValueError(f"pos {pos} out of range [0, {kc.shape[3]})")
        pos = torch.full((q.shape[0],), pos, dtype=torch.int32,
                         device=kc.device)
    S, slots = _check(q, k_new, v_new, kc, vc, layer, pos, window, rope,
                      seq_block, _build.sm_count(kc.device.index)
                      if kc.device.type == "cuda" else _H100_SMS)
    if kc.device.type == "cpu":
        return decode_attention_plain(q, k_new, v_new, kc, vc, layer, pos,
                                      window=window, rope=rope,
                                      seq_block=seq_block)
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
    Hkv, T = kc.shape[2], kc.shape[3]
    out = torch.empty((B, Hq, D), dtype=kc.dtype, device=kc.device)
    err = lib.teal_decode_attention(
        _DTYPE_CODE[kc.dtype], q.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), rope.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        pos.data_ptr(), out.data_ptr(), B, Hq, Hkv, T, layer, window or 0,
        1.0 / D ** 0.5, q.stride(0), k_new.stride(0), int(seq_block), S,
        slots, torch.cuda.current_stream().cuda_stream)
    if err == -1:
        raise RuntimeError(f"decode_attention: no cluster of {S} blocks "
                           f"(Hq={Hq}, Hkv={Hkv}, T={T}, {slots} slots) can "
                           "be resident on this card")
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
