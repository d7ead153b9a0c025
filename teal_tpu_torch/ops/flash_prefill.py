"""Kernel K6: causal flash attention over a pos-0 prompt (prefill).

Port of `_flash_prefill_attention` (`teal_tpu/models/llama.py:138-149`,
the Pallas TPU library kernel `flash_attention` with causal=True): q
[B, Hq, S, 128] against the prompt's own k / v [B, Hkv, S, 128], query
row i seeing keys 0..i, scale 1/sqrt(128), GQA without repeating KV, an
fp32 softmax, the output in the inputs' type. `flash_prefill_attention`
launches `csrc/flash_prefill.cu` on CUDA tensors and runs
`flash_prefill_attention_plain` on CPU tensors. `_plan` mirrors the
kernel's launch (`teal_flash_prefill_plan`): bf16 runs a persistent grid
of blocks of three warpgroups (two consumers, one TMA producer), each
walking 128-row query tiles in `_schedule`'s order with a ring of
`STAGES` K/V stages; fp32 one block of four warps a 64-row tile.
"""

from __future__ import annotations

from typing import Optional

import torch

from teal_tpu_torch import _build

HEAD_DIM = 128
BLOCK = 64                       # S must be a multiple of this
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# bf16: query rows a tile (== keys a tile), ring stages, threads a block;
# the fp32 kernel's tile and threads
TILE, STAGES, THREADS = 128, 2, 384
FP32_TILE, FP32_THREADS = 64, 128
SMEM_LIMIT = 232448              # shared bytes a block may use (H100)


def _plan(dtype: torch.dtype, b: int, hq: int, s: int, n_sms: int):
    """The kernel's launch (`teal_flash_prefill_plan`) for dtype, B, Hq
    and S on a card of `n_sms` SMs: (query tiles a (head, batch row),
    query rows a tile, blocks, threads a block, dynamic shared bytes).
    fp32: one block a tile. bf16: a persistent grid of min(tiles, SMs)
    blocks walking the tile list in `_schedule`'s order."""
    if dtype == torch.float32:
        tiles = s // FP32_TILE
        # Q, K and V tiles, each row padded by 16 bytes
        return (tiles, FP32_TILE, b * hq * tiles, FP32_THREADS,
                3 * FP32_TILE * (HEAD_DIM + 4) * 4)
    tiles = -(-s // TILE)
    tile_bytes = TILE * HEAD_DIM * 2
    # Q, the K and V stages, the mbarriers (Q full and empty; K and V full
    # and empty a stage), and slack to align the base to 1024 bytes
    smem = tile_bytes * (1 + 2 * STAGES) + 8 * (2 + 4 * STAGES) + 1024
    return tiles, TILE, min(b * hq * tiles, n_sms), THREADS, smem


def _schedule(tiles: int, hb: int, blocks: int):
    """The bf16 kernel's tile order (`tile_at`): for each block, its list
    of tiles (query tile, head-and-batch index). Tile u of the list has
    query tile tiles - 1 - u // hb (the longest rows first) and index
    u % hb; blocks take the list in rounds, every other round in reverse
    (a snake)."""
    out = []
    for g in range(blocks):
        mine, n = [], 0
        while True:
            u = n * blocks + (blocks - 1 - g if n % 2 else g)
            if u >= tiles * hb:
                break
            mine.append((tiles - 1 - u // hb, u % hb))
            n += 1
        out.append(mine)
    return out


def masked_attention(q, k, v, pos: torch.Tensor, q_len: int, max_seq: int,
                     sliding_window: Optional[int]):
    """Grouped-query attention over the full static cache (the model's
    `_attention`, and K6's plain version at pos 0).

    q: [B, Hq, S, D]; k/v: [B, Hkv, T, D]; pos [B] each sequence's first
    query position. Future and out-of-window slots are masked out; the
    scores and softmax in fp32, the probabilities rounded to the value
    type before PV."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    q = q.reshape(b, hkv, hq // hkv, s, d)
    scores = torch.einsum("bkgsd,bktd->bkgst", q.float(), k.float()) \
        * (1.0 / d ** 0.5)
    q_pos = pos[:, None] + torch.arange(s, device=q.device)[None, :]
    t_pos = torch.arange(max_seq, device=q.device)[None, None, :]
    valid = t_pos <= q_pos[:, :, None]                  # [B, S, T]
    if sliding_window is not None:
        valid &= t_pos > (q_pos[:, :, None] - sliding_window)
    scores = scores.masked_fill(~valid[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, hq, s, d).to(v.dtype)


def flash_prefill_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor) -> torch.Tensor:
    """K6 in plain PyTorch (same arguments and result as
    `flash_prefill_attention`): `masked_attention` at pos 0 over a cache
    of exactly the S prompt positions."""
    b, s = q.shape[0], q.shape[2]
    pos = torch.zeros(b, dtype=torch.int64, device=q.device)
    return masked_attention(q, k, v, pos, s, s, None)


def _check(q, k, v):
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"q must be [B, Hq, S, {HEAD_DIM}]; got "
                         f"{tuple(q.shape)}")
    b, hq, s, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[2:] != (s, d) or \
            v.shape != k.shape:
        raise ValueError(f"k and v must be [{b}, Hkv, {s}, {d}]; got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    hkv = k.shape[1]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if s == 0 or s % BLOCK:
        raise ValueError(f"S={s} must be a positive multiple of {BLOCK}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share one type, fp32 or bf16; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")


def flash_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """Causal attention of a prompt that starts at position 0.

    q: [B, Hq, S, 128]; k / v: [B, Hkv, S, 128] (Hq a multiple of Hkv,
    S a multiple of 64), all contiguous, of one type (fp32 or bf16).
    Returns [B, Hq, S, 128] in that type."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_prefill_attention_plain(q, k, v)
    if q.device.type != "cuda" or \
            q.device.index != torch.cuda.current_device():
        raise ValueError(f"flash_prefill_attention runs on the current CUDA "
                         f"device or the CPU; got {q.device}")
    lib = _build.load()["flash_prefill"]
    b, hq, s, d = q.shape
    out = torch.empty_like(q)
    err = lib.teal_flash_prefill(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, hq, k.shape[1], s, 1.0 / d ** 0.5,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_prefill_attention")
    flash_prefill_attention.launches += 1
    return out


flash_prefill_attention.launches = 0
