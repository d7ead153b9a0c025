"""Llama/Mistral transformer for activation-sparse inference, in PyTorch.

Port of `teal_tpu/models/llama.py` with the same parameter layout:
  - parameters are a dict of layer-stacked tensors (`[L, K, N]` per
    projection, key names of `init_params`), so one kept group of a
    projection is one contiguous `[128, N]` slab of layer l;
  - the KV cache is `[L, B, Hkv, T, head_dim]` per k and v. The port
    updates it in place (the JAX package threads it functionally);
  - sparsity enters as a `[L, 7]` threshold table (order
    `config.PROJS`) plus a `SparsityConfig`;
  - norms, RoPE and softmax run in fp32; projections in the parameter
    type with fp32 sums;
  - projections may be int8 {"q", "scale"}, groupwise int4
    {"q", "scale", "zero"} or packed int4 {"qp", "sz"} dicts
    (`ops/quant.py`); activations are then bf16 (`compute_dtype`);
  - Mixtral (`cfg.n_experts > 0`): the FFN leaves are a fp32 router
    [L, D, E] and expert stacks wgate / wup [L, E, D, I], wdown
    [L, E, I, D] (`models/moe.py`).

`forward` routes as the reference does. Single-token threshold-mode
decode at G=128 with the default route flags, batch 1 or up to 16 rows
(the main path and the continuous-batching server's decode step; the
reference's packed pipeline / whole-token kernel) runs
`ops/token_block.token_decode`: one K7 launch a step where `token_fused`
is not False, else the K1/K2 loop; so does `block_verify` (S consecutive
positions of one sequence as rows, fixed full selection, `seq_block`:
one K7 launch a chunk). Mixtral decodes batch 1 on the token path
too: one K7 launch a token with its routing inside (K7's MoE form, arrays
or int8 experts), or with a shape K7 cannot plan the loop, routing in
kernel K5 and gathering the routed experts' kept groups through K1.
Everything else
runs the layer loop (`layer_forward`): dense and masked-dense layers in
plain PyTorch, and single-token sparse decode through the kernels --
block mode on K1 (threshold) or K3 (top-k, and batches of up to 8),
gather mode on K4, attention on K2 where `can_fused_decode` holds,
and with `causal_prefill` a pos-0 prompt's attention on K6 where
`_can_flash_prefill` holds.
Packed int4 weights always decode through the block route (at keep 1.0
when sparsity is off), as in the reference.

`forward` and `layer_forward` also run on a rank's tensor-parallel shard
(`tp_group`: the layer loop on the rank's heads and channels, the rowwise
outputs summed over the group; `parallel/tp.py`) and on a rank's chunk
of a prompt (`seq_group`, the reference's `seq_axis`; `parallel/sp.py`).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from teal_tpu_torch.config import ModelConfig, PROJS, SparsityConfig
from teal_tpu_torch.models import moe
from teal_tpu_torch.ops import block_gemv, quant, sparse_gemv
from teal_tpu_torch.ops.attn_block import attn_stage
from teal_tpu_torch.ops.decode_attention import decode_attention
from teal_tpu_torch.ops.flash_prefill import flash_prefill_attention
from teal_tpu_torch.ops.flash_prefill import masked_attention as _attention
from teal_tpu_torch.ops.sparsify import apply_sparsity, group_capacity

_WEIGHTS = ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown")
# leaves that stay fp32 whatever type the floats are cast to: the
# quantization leaves, and the MoE router, which the token path reads in
# fp32 (the JAX package's int8 quantization leaves it unrounded; a bf16
# router is exact in fp32)
_FP32_LEAVES = ("scale", "sz", "zero", "router")


def _is_int8(w) -> bool:
    """An int8 weight-only dict {"q", "scale"} (not groupwise int4)."""
    return isinstance(w, dict) and "q" in w and "zero" not in w


def _is_int4_packed(w) -> bool:
    return isinstance(w, dict) and "qp" in w


def _leaf(w, fn):
    """fn applied to a weight, or to each array of a quantized dict."""
    return {k: fn(v) for k, v in w.items()} if isinstance(w, dict) else fn(w)


def _device(device) -> torch.device:
    """Resolve an entry point's device; CUDA must exist when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass device='cpu' "
                           "to run the port's plain versions on the CPU")
    return device


def _to_tensor(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    # JAX's bf16 arrays come as ml_dtypes.bfloat16 (kind "V"), which
    # torch.from_numpy refuses; they upcast to fp32 exactly
    is_float = a.dtype.kind == "f" or a.dtype.name == "bfloat16"
    if is_float:
        a = a.astype(np.float32)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype if is_float else None)


class KVCache(NamedTuple):
    """Decode cache. k/v: [L, B, n_kv_heads, max_seq, head_dim]."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def init(cls, cfg: ModelConfig, batch: int, max_seq: int,
             dtype=torch.bfloat16, device="cuda", tp: int = 1):
        """A zero cache; with tp > 1 a tensor-parallel rank's block of it
        (n_kv_heads / tp heads), allocated at that size."""
        device = _device(device)
        if cfg.n_kv_heads % tp:
            raise ValueError(f"n_kv_heads={cfg.n_kv_heads} not divisible by "
                             f"tp={tp}")
        shape = (cfg.n_layers, batch, cfg.n_kv_heads // tp, max_seq,
                 cfg.head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    @classmethod
    def from_numpy(cls, k, v, device="cuda", dtype=torch.float32):
        """A cache from the JAX package's arrays (after `np.asarray`)."""
        device = _device(device)
        return cls(k=_to_tensor(k, device, dtype),
                   v=_to_tensor(v, device, dtype))

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]


def params_from_numpy(tree, device="cuda", dtype=torch.float32):
    """The JAX package's parameter pytree (each leaf through `np.asarray`)
    as the port's tensors: same keys, same layout, floats cast to
    `dtype` except the quantization leaves `scale`, `sz` and `zero`,
    which stay fp32 as the JAX package keeps them, and the MoE `router`,
    carried in fp32 so that routing sees the reference's values; integer
    leaves (int8 `q`, packed `qp`) keep their type."""
    device = _device(device)

    def conv(t, key):
        if isinstance(t, dict):
            return {k: conv(v, k) for k, v in t.items()}
        return _to_tensor(t, device, torch.float32 if key in _FP32_LEAVES
                          else dtype)

    return conv(tree, None)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float):
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * weight.to(x.dtype)


def precompute_rope(cfg: ModelConfig, max_seq: int, device="cuda"):
    """cos/sin tables [max_seq, head_dim] (fp32), HF half-split convention."""
    device = _device(device)
    half = cfg.head_dim // 2
    inv_freq = 1.0 / (cfg.rope_base ** (
        torch.arange(0, half, dtype=torch.float32, device=device) / half))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)                     # [S, half]
    emb = torch.cat([freqs, freqs], dim=-1)              # [S, head_dim]
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: [B, H, S, D]; cos/sin: [B, S, D] at each sequence's positions."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    out = x.float() * cos[:, None] + rotated.float() * sin[:, None]
    return out.to(x.dtype)


def _proj(x, w, thresh, sp: SparsityConfig):
    """One of the seven sparsifiable projections: the sparse decode kernels
    for a single-token input (`sparse_gemv.sparse_matmul`), else sparsify
    then matmul (the quantized products of `ops/quant.py`). A packed int4
    single row always takes the gather kernel (keep 1.0 without block
    sparsity). int8 in block mode takes top-k selection and ignores the
    threshold, as the reference does (`teal_tpu/models/llama.py:115`)."""
    quantized = isinstance(w, dict)
    is_int4 = quantized and "zero" in w
    is_int4_packed = quantized and "qp" in w
    if (is_int4_packed and x.shape[-2] == 1
            and math.prod(x.shape[:-1]) == 1):
        sparse = sp.enabled and sp.kernel == "block"
        return quant.int4_block_sparse_matmul(
            x, w, sp.block_size, sp.block_keep_frac if sparse else 1.0,
            threshold=thresh if (sparse and sp.block_thresholding) else None)
    if sp.enabled and x.shape[-2] == 1 and sp.kernel != "masked_dense":
        if quantized and not is_int4 and not is_int4_packed \
                and sp.kernel == "block":
            return quant.int8_block_sparse_matmul(
                x, quant.Int8Weight(w["q"], w["scale"]), sp.block_size,
                sp.block_keep_frac)
        if not quantized:
            return sparse_gemv.sparse_matmul(x, w, thresh, sp)
    xs = apply_sparsity(x, thresh, sp)
    if is_int4_packed:
        return quant.int4_packed_matmul(xs, w)
    if is_int4:
        return quant.int4_dict_matmul(xs, w)
    if quantized:
        return quant.int8_matmul(xs, quant.Int8Weight(w["q"], w["scale"]))
    return torch.matmul(xs, w).to(x.dtype)


def _flash_prefill_attention(q, k_new, v_new):
    """Causal prefill attention through kernel K6 for the pos-0 prompt
    (the reference's `_flash_prefill_attention`): q/k/v cover positions
    0..S-1, so plain causal masking equals the masked attention over the
    zero-filled cache, and the [S, T] score matrix is never built.
    q: [B, Hq, S, D] (cast to the cache type k_new / v_new carry);
    k_new/v_new: [B, Hkv, S, D]. Returns [B, Hq, S, D] in the cache
    type."""
    return flash_prefill_attention(q.to(k_new.dtype).contiguous(),
                                   k_new.contiguous(), v_new.contiguous())


def _can_flash_prefill(s: int, head_dim: int, sliding_window) -> bool:
    """Gate for K6 (the reference's `_can_flash_prefill`): no sliding
    window (Mistral keeps `_attention`), S >= 256, S % 128 == 0 and
    head_dim % 128 == 0. Decided from shapes alone, never from the
    device (the reference also refuses the CPU backend), so that the CPU
    runs the composition the card runs."""
    return (sliding_window is None and s >= 256 and s % 128 == 0
            and head_dim % 128 == 0)


def can_fused_decode(s: int, b: int, cfg: ModelConfig, max_seq: int,
                     sp: SparsityConfig, block_path: bool,
                     tp_size: int = 1) -> bool:
    """Gate for kernel K2 on the layer loop (the reference's
    `_can_fused_decode`): single-token decode at shapes the kernel takes,
    on a forward that is not sharded (`tp_size` 1: the reference's
    single-device condition; `parallel/tp_kernel.py` runs K2 on a rank's
    heads itself); `sp.fused_decode_attention` True forces it, False
    refuses it, and auto (None) turns it on for the block path. Decided
    from the config and shapes alone, never from the device, so that
    the CPU runs the composition the card runs."""
    if sp.fused_decode_attention is False or tp_size > 1:
        return False
    if not (s == 1 and b <= 16 and cfg.head_dim == 128 and max_seq % 8 == 0
            and cfg.n_heads % cfg.n_kv_heads == 0):
        return False
    return bool(sp.fused_decode_attention) or block_path


def _dense_f32(x, w) -> torch.Tensor:
    """x @ w with fp32 sums, before any cast: an array, an int8 dict (the
    scale on the sums), or int4 weights dequantized to x's type."""
    if _is_int8(w):
        return quant.matmul_f32(x, w["q"]) * w["scale"]
    if _is_int4_packed(w):
        w = quant.unpack_int4(w["qp"], w["sz"], x.dtype)
    elif isinstance(w, dict):
        w = quant.dequantize_int4_dict(w, x.dtype)
    return quant.matmul_f32(x, w)


def _rowwise(x, w, thresh, sp: SparsityConfig, tp_group):
    """A rowwise projection (o, down): `_proj`, and on a tp shard the sum
    of every rank's partial product. x then holds this rank's input
    channels; the group rule ("group" mode: a cap or top-k over the whole
    input) is not shard-local, so it runs on the gathered input and each
    rank keeps its part of the single-device selection. The partials are
    summed in fp32 and rounded once, as XLA's partitioner reduces a
    dot's output before the cast."""
    if tp_group is None or tp_group.size == 1:
        return _proj(x, w, thresh, sp)
    if sp.enabled and sp.mode == "group":
        n = x.shape[-1]
        xs = apply_sparsity(tp_group.all_gather(x, -1), thresh, sp).narrow(
            -1, tp_group.index * n, n)
    else:
        xs = apply_sparsity(x, thresh, sp)
    return tp_group.reduce_sum(_dense_f32(xs, w)).to(x.dtype)


def check_sharded(params, cfg: ModelConfig, sp: SparsityConfig,
                  s: int) -> None:
    """Refuse what the sharded layer loop cannot run with single-device
    semantics: the single-token kernels select over a rank's input
    channels (block or gather mode, packed int4 weights), and a Mixtral
    expert's group rule is not shard-local."""
    lay = params["layers"]
    if s == 1 and ((sp.enabled and sp.kernel != "masked_dense")
                   or _is_int4_packed(lay["wq"])):
        raise ValueError(
            "single-token decode through the sparse kernels on a tp shard "
            "selects over the rank's channels: run it through "
            "parallel.tp_kernel.tp_kernel_decode, or use "
            "kernel='masked_dense'")
    if cfg.n_experts > 0 and sp.enabled and sp.mode == "group":
        raise ValueError("a Mixtral expert's group rule is not shard-local "
                         "on a tp shard: use mode='teal' or "
                         "parallel.tp_kernel.tp_kernel_decode")


def layer_forward(h, lp: Dict[str, torch.Tensor], kc, vc,
                  pos: torch.Tensor, cos, sin, cfg: ModelConfig,
                  sp: SparsityConfig, thresholds, capture: bool = False,
                  fused_attn: bool = False, causal_prefill: bool = False,
                  tp_group=None, seq_group=None):
    """One transformer block of the layer loop. h: [B, S, D]; lp: this
    layer's parameters (a quantized weight is a dict of this layer's
    arrays); kc/vc: this layer's [B, Hkv, T, Dh] cache views,
    written in place at each sequence's positions; pos: int64 [B] first
    position of each sequence, on h's device; cos/sin: [B, S, Dh];
    thresholds: [7]; fused_attn: single-token attention through K2
    (`can_fused_decode`); causal_prefill: the caller guarantees pos 0
    and an empty cache, so a prompt that `_can_flash_prefill` takes runs
    its attention through K6 over the fresh k/v (after the cache write).

    tp_group (`parallel.mesh.AxisGroup`): lp and the caches hold this
    rank's tensor-parallel shard (its heads and intermediate channels;
    `parallel/tp.py`), and the o and down outputs are summed over the
    group (`_rowwise`). seq_group: sequence-parallel prefill (the
    reference's `seq_axis`, `parallel/sp.py`): h holds this rank's chunk
    of the prompt at its global positions pos; the k/v chunks of the
    group are gathered and written at the prompt's base, and the local
    queries attend to the whole cache (never through K6).

    A single-token input with B <= 8 in block mode (or with packed int4
    weights, at keep 1.0 without block sparsity) takes the reference's
    block route (`teal_tpu/models/llama.py:258-466`): q|k|v, o, gate|up
    and down through `block_gemv.project_many` (K1 in threshold mode,
    with the rms_norm folded in at B = 1; K3 in top-k mode) or
    `project_many_batched` (K3), and at B = 1 in threshold mode with K2
    the attention stage (`attn_stage`: K8 in one launch for arrays of the
    cache's type and packed int4, else K1 + K2 with RoPE inside). Outputs
    leave the
    projections in the stream type, the residual adds are in the stream
    type, and silu runs in fp32 before the cast and the product with up:
    the layer loop's cast points, not the token path's.

    Mixtral (`cfg.n_experts > 0`): the FFN is `moe.moe_ffn` on the
    explicit mlp rms_norm, with the gate and down thresholds; captures
    then hold attn h1/h2 and mlp h1 only (each expert's intermediate is
    its own).

    Returns (h_out, kc, vc, captures|None): captures are the four TEAL
    hidden-state groups (attn h1/h2, mlp h1/h2) for calibration."""
    b, s, d = h.shape
    t = {p: thresholds[i] for i, p in enumerate(PROJS)}
    sparse_block = sp.enabled and sp.kernel == "block"
    use_block = (s == 1 and b <= 8
                 and (sparse_block or _is_int4_packed(lp["wq"])))
    fold = (use_block and b == 1 and sparse_block and sp.block_thresholding
            and not capture and d % 128 == 0)
    # packed int4 without block sparsity reads every group
    kf = ((sp.block_keep_fracs or (sp.block_keep_frac,) * 7)
          if sparse_block else (1.0,) * 7)

    def stack1(name):
        """This layer's weight as a one-layer stack for the kernels."""
        return _leaf(lp[name], lambda a: a[None])

    def blockproj(inp, projs, frac, norm=None):
        """Block-sparse projections `projs` (PROJS names) of one input,
        sharing one selection; the first one's threshold in threshold
        mode."""
        ws = [stack1("w" + p) for p in projs]
        thr = t[projs[0]] if sparse_block and sp.block_thresholding else None
        if b == 1:
            return block_gemv.project_many(
                inp, ws, sp.block_size, frac, threshold=thr,
                norm=None if norm is None else norm[None],
                norm_eps=cfg.norm_eps)
        outs = block_gemv.project_many_batched(
            inp.reshape(b, inp.shape[-1]), ws, sp.block_size, frac,
            threshold=thr)
        return [o.reshape(b, 1, -1) for o in outs]

    def blockprojs(inp, projs, norm=None):
        """Projections sharing one input: one call when their keep
        fractions agree, else one each."""
        fr = [kf[PROJS.index(p)] for p in projs]
        if len(set(fr)) == 1:
            return blockproj(inp, projs, fr[0], norm)
        return [blockproj(inp, [p], f, norm)[0] for p, f in zip(projs, fr)]

    x = None if fold else rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    # the attention stage (`attn_stage`: one K8 launch for arrays of the
    # cache's type and packed int4, else K1 + K2); int8 takes K1 then K2 on
    # their own here, with the scale after K1, as the reference's layer
    # loop does
    mega = (fold and fused_attn and kf[0] == kf[1] == kf[2]
            and cfg.head_dim == 128 and not _is_int8(lp["wq"])
            and sp.fused_attn_block is not False)
    if mega:
        wqkv = [stack1(n) for n in ("wq", "wk", "wv")]
        G = block_gemv._shared_group_size(wqkv, sp.block_size, d)
        rope = torch.stack([cos[:, 0], sin[:, 0]], dim=1)
        attn, _ = attn_stage(
            h.reshape(d), t["q"], *wqkv, 0, group_capacity(d // G, kf[0]),
            lp["attn_norm"][None], cfg.norm_eps, kc[None], vc[None],
            pos.to(torch.int32), rope, n_heads=cfg.n_heads,
            window=cfg.sliding_window, G=G)
        attn = attn.reshape(b, s, -1).to(h.dtype)
    else:
        if use_block:
            q, k, v = blockprojs(h if fold else x, ("q", "k", "v"),
                                 lp["attn_norm"] if fold else None)
        else:
            q = _proj(x, lp["wq"], t["q"], sp)
            k = _proj(x, lp["wk"], t["k"], sp)
            v = _proj(x, lp["wv"], t["v"], sp)
        hkv = kc.shape[1]
        q = q.reshape(b, s, -1, cfg.head_dim).transpose(1, 2)
        k = k.reshape(b, s, hkv, cfg.head_dim).transpose(1, 2)
        v = v.reshape(b, s, hkv, cfg.head_dim).transpose(1, 2)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if fused_attn:
            attn = decode_attention(
                q[:, :, 0].float().contiguous(),
                k[:, :, 0].float().contiguous(),
                v[:, :, 0].float().contiguous(), kc[None], vc[None], 0,
                pos.to(torch.int32), window=cfg.sliding_window)[:, :, None]
        else:
            kw, vw, base = k, v, pos
            if seq_group is not None:
                kw, vw = (seq_group.all_gather(t.to(kc.dtype), 2)
                          for t in (k, v))
                base = pos - seq_group.index * s
            rows = base[:, None] + torch.arange(
                kw.shape[2], device=h.device)[None, :]
            for bi in range(b):
                kc[bi].index_copy_(1, rows[bi], kw[bi].to(kc.dtype))
                vc[bi].index_copy_(1, rows[bi], vw[bi].to(vc.dtype))
            if causal_prefill and s > 1 and seq_group is None and \
                    _can_flash_prefill(s, cfg.head_dim, cfg.sliding_window):
                attn = _flash_prefill_attention(q, k.to(kc.dtype),
                                                v.to(vc.dtype))
            else:
                attn = _attention(q, kc, vc, pos, s, kc.shape[2],
                                  cfg.sliding_window)
        attn = attn.transpose(1, 2).reshape(b, s, -1).to(h.dtype)  # attn h2
    if use_block:
        (o_out,) = blockproj(attn, ("o",), kf[3])
        h = h + o_out
    else:
        h = h + _rowwise(attn, lp["wo"], t["o"], sp, tp_group)

    if cfg.n_experts > 0:
        y = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)             # mlp h1
        out = moe.moe_ffn(y, lp, cfg, sp, th_gu=t["gate"], th_down=t["down"])
        h = h + (out if tp_group is None or tp_group.size == 1
                 else tp_group.reduce_sum(out))
        caps = ({"self_attn": {"h1": x, "h2": attn}, "mlp": {"h1": y}}
                if capture else None)
        return h, kc, vc, caps
    y = None if fold else rms_norm(h, lp["mlp_norm"], cfg.norm_eps)  # mlp h1
    if use_block:
        gate, up = blockprojs(h if fold else y, ("gate", "up"),
                              lp["mlp_norm"] if fold else None)
    else:
        gate = _proj(y, lp["wgate"], t["gate"], sp)
        up = _proj(y, lp["wup"], t["up"], sp)
    inter = F.silu(gate.float()).to(gate.dtype) * up         # mlp h2
    if use_block:
        (d_out,) = blockproj(inter, ("down",), kf[6])
        h = h + d_out
    else:
        h = h + _rowwise(inter, lp["wdown"], t["down"], sp, tp_group)
    caps = None
    if capture:
        caps = {"self_attn": {"h1": x, "h2": attn},
                "mlp": {"h1": y, "h2": inter}}
    return h, kc, vc, caps


def token_path_caps(cfg: ModelConfig, sp: SparsityConfig
                    ) -> Tuple[int, int, int, int]:
    """Capacities of the four token-path stages (qkv, o, gate|up, down)."""
    kf = sp.block_keep_fracs or (sp.block_keep_frac,) * 7
    D, I = cfg.dim, cfg.intermediate_size
    return (group_capacity(D // 128, kf[0]), group_capacity(D // 128, kf[3]),
            group_capacity(D // 128, kf[4]), group_capacity(I // 128, kf[6]))


def can_token_decode(params, cfg: ModelConfig, sp: SparsityConfig,
                     s: int, b: int, cache_dtype, *,
                     fused_attn: bool = True) -> bool:
    """Gate for the token path, where the reference takes its packed
    pipeline or whole-token kernel (`_can_packed_pipeline`): single-token
    threshold-mode decode with fused decode attention (`fused_attn`, from
    `can_fused_decode`) and `packed_pipeline` not False; batch 1, or up to
    16 unless `token_fused` is False (the batched token kernel's rows);
    weights that are arrays,
    packed int4, or all seven int8 with `token_fused` not False (only the
    reference's whole-token kernel applies int8 scales), never unpacked
    int4; group size 128 for every stage (int4 at least 64), equal
    capacities within the fused stages, head_dim 128, the cache in the
    stream type. Mixtral only at batch 1 with `token_fused` not False,
    arrays or all seven int8 (no packed int4), and an effective group of
    128 for dim and intermediate_size, as in the reference (then K7's
    MoE form where it has a launch plan); b > 1 takes the layer loop."""
    lay = params["layers"]
    if isinstance(lay["wq"], dict) and "zero" in lay["wq"]:
        return False
    if cfg.n_experts > 0 and not (
            b == 1 and sp.token_fused is not False
            and not _is_int4_packed(lay["wq"])
            and not _is_int4_packed(lay["wgate"])
            and block_gemv.effective_block_size(sp.block_size, cfg.dim) == 128
            and block_gemv.effective_block_size(
                sp.block_size, cfg.intermediate_size) == 128):
        return False
    if _is_int8(lay["wq"]) and (sp.token_fused is False or not all(
            _is_int8(lay[n]) for n in _WEIGHTS)):
        return False
    kf = sp.block_keep_fracs or (sp.block_keep_frac,) * 7
    ok_b = b == 1 or (b <= 16 and sp.token_fused is not False)
    if not (sp.packed_pipeline is not False and fused_attn and s == 1
            and ok_b and sp.enabled and sp.kernel == "block"
            and sp.block_thresholding and cfg.head_dim == 128
            and kf[0] == kf[1] == kf[2]
            and kf[4] == kf[5] and compute_dtype(params) == cache_dtype):
        return False
    D, I = cfg.dim, cfg.intermediate_size
    return all(block_gemv._shared_group_size([lay[n] for n in names],
                                             sp.block_size, K) == 128
               for names, K in ((("wq", "wk", "wv"), D), (("wo",), D),
                                (("wgate", "wup"), D), (("wdown",), I)))


def compute_dtype(params) -> torch.dtype:
    """Activation type: the projections' type, or bf16 when they are
    quantized dicts."""
    w = params["layers"]["wq"]
    return torch.bfloat16 if isinstance(w, dict) else w.dtype


def forward(params, tokens: torch.Tensor, cache: KVCache, pos, thresholds,
            *, cfg: ModelConfig, sp: SparsityConfig,
            rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            causal_prefill: bool = False, tp_group=None, seq_group=None,
            return_hidden: bool = False):
    """Full forward. tokens: [B, S] int; pos: start position shared by the
    batch (int) or one per sequence (continuous batching: each row decodes
    at its own depth), or an int tensor of 1 or B entries, which no
    route reads back to the host (`_positions`: the decode step of a CUDA
    graph keeps its position on the device); thresholds: [L, 7] fp32 on the
    parameters' device; rope: optional (cos, sin) tables from
    `precompute_rope` (computed here when absent). The cache is updated
    in place.

    causal_prefill: the caller guarantees pos == 0 and an empty cache
    (a whole prompt, a perplexity window), which lets the layer loop take
    K6 for prompts `_can_flash_prefill` accepts. `sp.debug_fixed_selection`
    keeps groups 0..cap-1 at every stage of the token path (K1's `fixed`
    selection) and is ignored on every other route, as in the reference.

    tp_group / seq_group (`parallel.mesh.AxisGroup`): the sharded forward
    (`parallel/tp.py`: params and cache are this rank's shards, the
    logits gathered over the group) and sequence-parallel prefill
    (`parallel/sp.py`: tokens are this rank's chunk at pos, the logits
    gathered along S); see `layer_forward`. A sharded forward (a tp group
    of more than one rank) takes neither the token path nor K2
    (`check_sharded` says what it refuses).

    return_hidden: return the final-normed hidden state [B, S, dim] (in
    the activation type, the same on every rank of a tp group) in place
    of the logits, on every route.

    Returns (logits [B, S, V] fp32 or the hidden state, cache)."""
    dev = tokens.device
    h = params["embed"][tokens].to(compute_dtype(params))
    b, s = tokens.shape
    pos_t = _positions(pos, b, dev, cache.max_seq)
    cos_full, sin_full = rope or precompute_rope(cfg, cache.max_seq, dev)
    lay = params["layers"]
    block_path = ((sp.enabled and sp.kernel == "block")
                  or _is_int4_packed(lay["wq"]))
    tp_size = 1 if tp_group is None else tp_group.size
    if tp_size > 1:
        check_sharded(params, cfg, sp, s)
    fused_attn = seq_group is None and can_fused_decode(
        s, b, cfg, cache.max_seq, sp, block_path, tp_size)

    if tp_size == 1 and seq_group is None and can_token_decode(
            params, cfg, sp, s, b, cache.k.dtype, fused_attn=fused_attn):
        from teal_tpu_torch.ops import token_block

        # batch 1 in K7's form with token_fused not False (arrays of the
        # stream type, or with a bf16 stream all seven int8 or packed int4
        # at quant group 128): K7, one launch a token (the reference's
        # `_token_kernel` in its three weight plans); Mixtral (arrays or
        # int8 experts) K7's MoE form, its routing inside the launch (the
        # reference's MoE branch); token_fused False: the K1/K2 loop (its
        # `_packed_layer`; Mixtral never comes here then: `can_token_decode`
        # sends it to the layer loop, as the reference does). rows (batch
        # 2-16): K7's rows form in the same three plans, one launch a
        # step, one pooled selection, the kept weights read once for the
        # batch
        pos_arg = pos_t.to(torch.int32)
        moe_kw = (dict(router=lay["router"],
                       n_experts_per_tok=cfg.n_experts_per_tok)
                  if cfg.n_experts > 0 else {})
        h1 = token_block.token_decode(
            h.reshape(cfg.dim) if b == 1 else h.reshape(b, cfg.dim),
            thresholds, tuple(lay[n] for n in _WEIGHTS),
            lay["attn_norm"], lay["mlp_norm"],
            _rope_rows(cos_full, sin_full, pos_arg), cache.k, cache.v,
            pos_arg, caps=token_path_caps(cfg, sp), n_heads=cfg.n_heads,
            norm_eps=cfg.norm_eps, window=cfg.sliding_window,
            fixed_sel=sp.debug_fixed_selection, token_fused=sp.token_fused,
            **moe_kw)
        h = h1.reshape(b, 1, cfg.dim)
    else:
        positions = pos_t[:, None] + torch.arange(s, device=dev)[None, :]
        cos, sin = cos_full[positions], sin_full[positions]
        for i in range(cfg.n_layers):
            lp = {k: _leaf(v, lambda a: a[i]) for k, v in lay.items()}
            h, _, _, _ = layer_forward(h, lp, cache.k[i], cache.v[i], pos_t,
                                       cos, sin, cfg, sp, thresholds[i],
                                       fused_attn=fused_attn,
                                       causal_prefill=causal_prefill,
                                       tp_group=tp_group,
                                       seq_group=seq_group)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        out = h
    else:
        out = _lm_head(params, h)
        if tp_group is not None:
            out = tp_group.all_gather(out, -1)
    if seq_group is not None:
        out = seq_group.all_gather(out, 1)
    return out, cache


def _positions(pos, b: int, dev, max_seq: int) -> torch.Tensor:
    """`forward`'s start positions as an int64 [B] tensor on `dev`, from a
    host int or list (one fill where the batch shares it; each must lie
    in [0, max_seq), else a ValueError) or from a tensor of one or B
    entries, which is read on the device only: a CUDA graph of the step
    then replays at the positions the tensor holds at each replay, not
    at the ones it held at capture (K2 traps one out of range)."""
    if isinstance(pos, torch.Tensor):
        p = pos.reshape(-1).to(device=dev, dtype=torch.int64)
    else:
        vals = [int(v) for v in np.atleast_1d(pos)]
        for v in vals:
            if not 0 <= v < max_seq:
                raise ValueError(f"pos {v} out of range [0, {max_seq})")
        p = (torch.full((1,), vals[0], dtype=torch.int64, device=dev)
             if len(set(vals)) == 1 else torch.tensor(vals, device=dev))
    if p.numel() not in (1, b):
        raise ValueError(f"{p.numel()} positions for a batch of {b}")
    return p.expand(b).contiguous() if p.numel() < b else p


def _rope_rows(cos_full, sin_full, pos: torch.Tensor) -> torch.Tensor:
    """[B, 2, head_dim] (cos, sin) rows at positions pos [B]."""
    p = pos.long()
    return torch.stack([cos_full[p], sin_full[p]], dim=1)


def can_block_verify(params, cfg: ModelConfig, s: int) -> bool:
    """Gate for `block_verify` (the reference's `can_block_verify`, shapes
    and types only): 1 < s <= 32, no MoE, head_dim 128, dim and
    intermediate_size multiples of 128, weights that are arrays, all seven
    int8, or packed int4, gathered at G = 128 in every stage."""
    lay = params["layers"]
    if not (1 < s <= 32 and cfg.n_experts == 0 and cfg.head_dim == 128
            and cfg.dim % 128 == 0 and cfg.intermediate_size % 128 == 0):
        return False
    if isinstance(lay["wq"], dict) and "zero" in lay["wq"]:
        return False
    if _is_int8(lay["wq"]) and not all(_is_int8(lay[n]) for n in _WEIGHTS):
        return False
    D, I = cfg.dim, cfg.intermediate_size
    return all(block_gemv._shared_group_size([lay[n] for n in names], 128,
                                             K) == 128
               for names, K in ((("wq", "wk", "wv"), D), (("wo",), D),
                                (("wgate", "wup"), D), (("wdown",), I)))


def block_verify(params, tokens: torch.Tensor, cache: KVCache, pos,
                 thresholds, *, cfg: ModelConfig,
                 rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Dense forward over S consecutive positions pos..pos+S-1 of ONE
    sequence through the token path (the reference's `block_verify`,
    `teal_tpu/models/llama.py:811`): the positions ride as K7's rows in
    its seq_block form (one launch a chunk, `token_block.token_kernel`)
    with the identity selection at full capacity (`fixed_sel`), so every
    weight is read once per chunk, and each layer writes every position's
    K/V to cache row 0 before any position attends. S > 8 runs ceil(S/8)
    chunks of balanced sizes (S = 12 -> 6 + 6) in order; a later chunk
    attends to the earlier ones through
    the cache. Gate with `can_block_verify`.

    tokens: [1, S] int; pos: the first position (an int, or an int
    tensor read on the device only, as `forward` reads it); thresholds:
    [L, 7] (unused by the fixed selection, passed through as the
    reference does); the cache (batch 1) is updated in place at pos..pos+S-1.
    Returns (logits [1, S, V] fp32, cache)."""
    from teal_tpu_torch.ops import token_block

    b, s = tokens.shape
    if b != 1 or s < 2:
        raise ValueError(f"block_verify takes one sequence of S >= 2 "
                         f"tokens; got {tuple(tokens.shape)}")
    dev = tokens.device
    if isinstance(pos, torch.Tensor):
        # read on the device only (K2 traps a position out of range)
        start = pos.reshape(-1)[:1].to(device=dev, dtype=torch.int32)
    else:
        pos = int(pos)
        if not (0 <= pos and pos + s <= cache.max_seq):
            raise ValueError(f"positions {pos}..{pos + s - 1} out of range "
                             f"[0, {cache.max_seq})")
        start = torch.full((1,), pos, dtype=torch.int32, device=dev)
    lay = params["layers"]
    cos_full, sin_full = rope or precompute_rope(cfg, cache.max_seq, dev)
    n_chunks = -(-s // 8)
    base, rem = divmod(s, n_chunks)
    sizes = [base + (1 if j < rem else 0) for j in range(n_chunks)]
    D, I = cfg.dim, cfg.intermediate_size
    hs, off = [], 0
    for ss in sizes:
        h = params["embed"][tokens[0, off:off + ss]].to(compute_dtype(params))
        positions = start + torch.arange(off, off + ss, dtype=torch.int32,
                                         device=dev)
        hs.append(token_block.token_decode(
            h, thresholds, tuple(lay[n] for n in _WEIGHTS),
            lay["attn_norm"], lay["mlp_norm"],
            _rope_rows(cos_full, sin_full, positions), cache.k, cache.v,
            positions, caps=(D // 128, D // 128, D // 128, I // 128),
            n_heads=cfg.n_heads, norm_eps=cfg.norm_eps,
            window=cfg.sliding_window, fixed_sel=True, seq_block=True))
        off += ss
    h = rms_norm(torch.cat(hs)[None], params["final_norm"], cfg.norm_eps)
    return _lm_head(params, h), cache


def _lm_head(params, h):
    """Logits: the fp32 sums of the products in h's type, as the reference
    computes them (`quant.matmul_f32`: one GEMM with an fp32 output on
    the card). An int8 head {"q", "scale"} multiplies the int8 values in
    h's type and scales the sums; a groupwise int4 head {"q", "scale",
    "zero"} is dequantized to h's type first."""
    w = params["lm_head"]
    if isinstance(w, dict):
        if "zero" in w:
            return quant.matmul_f32(h, quant.dequantize_int4_dict(w, h.dtype))
        return quant.matmul_f32(h, w["q"]) * w["scale"]
    return quant.matmul_f32(h, w)


def zero_thresholds(cfg: ModelConfig, device="cuda"):
    return torch.zeros((cfg.n_layers, len(PROJS)), dtype=torch.float32,
                       device=_device(device))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda"):
    """Random-init parameters on `device` from a seeded `generator` (on
    the same device): N(0, 0.02^2) weights drawn one layer (one expert) at
    a time in fp32, unit norm gains; Mixtral's FFN leaves from
    `moe.init_moe_ffn_params`."""
    device = _device(device)

    def w(shape, scale=0.02):
        if len(shape) == 2:
            return (torch.randn(shape, generator=generator,
                                dtype=torch.float32, device=device)
                    * scale).to(dtype)
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            out[i] = torch.randn(shape[1:], generator=generator,
                                 dtype=torch.float32, device=device) * scale
        return out

    L, D, I, KV, V = (cfg.n_layers, cfg.dim, cfg.intermediate_size,
                      cfg.kv_dim, cfg.vocab_size)
    layers = {
        "attn_norm": torch.ones((L, D), dtype=dtype, device=device),
        "mlp_norm": torch.ones((L, D), dtype=dtype, device=device),
        "wq": w((L, D, D)),
        "wk": w((L, D, KV)),
        "wv": w((L, D, KV)),
        "wo": w((L, D, D)),
    }
    if cfg.n_experts > 0:
        layers.update(moe.init_moe_ffn_params(cfg, generator, dtype, device))
    else:
        layers.update({"wgate": w((L, D, I)), "wup": w((L, D, I)),
                       "wdown": w((L, I, D))})
    return {
        "embed": w((V, D)),
        "layers": layers,
        "final_norm": torch.ones((D,), dtype=dtype, device=device),
        "lm_head": w((D, V)),
    }
