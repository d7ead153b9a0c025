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
    type with fp32 sums.

`forward` routes as the reference does. Batch-1 single-token
threshold-mode decode at G=128 with the default route flags (the main
path; the reference's packed pipeline / whole-token kernel) runs
`ops/token_block.token_decode` on kernels K1 and K2. Everything else
runs the layer loop (`layer_forward`): dense and masked-dense layers in
plain PyTorch, and single-token sparse decode through the kernels --
block mode on K1 (threshold) or K3 (top-k, and batches of up to 8),
gather mode on K4, attention on K2 where `can_fused_decode` holds.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from teal_tpu_torch.config import ModelConfig, PROJS, SparsityConfig
from teal_tpu_torch.ops import block_gemv, sparse_gemv
from teal_tpu_torch.ops.attn_block import attn_stage
from teal_tpu_torch.ops.block_gemv import effective_block_size
from teal_tpu_torch.ops.decode_attention import decode_attention
from teal_tpu_torch.ops.sparsify import apply_sparsity, group_capacity

_WEIGHTS = ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown")


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
             dtype=torch.bfloat16, device="cuda"):
        device = _device(device)
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
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
    `dtype`."""
    device = _device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    return _to_tensor(tree, device, dtype)


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


def _check_plain_weights(lay) -> None:
    if not all(isinstance(lay[n], torch.Tensor) for n in _WEIGHTS):
        raise NotImplementedError(
            "quantized weights (int8 {'q','scale'}, int4 dicts) are not "
            "ported yet")


def _proj(x, w, thresh, sp: SparsityConfig):
    """One of the seven sparsifiable projections: the sparse decode kernels
    for a single-token input (`sparse_gemv.sparse_matmul`), else sparsify
    then matmul."""
    if sp.enabled and x.shape[-2] == 1 and sp.kernel != "masked_dense":
        return sparse_gemv.sparse_matmul(x, w, thresh, sp)
    return torch.matmul(apply_sparsity(x, thresh, sp), w).to(x.dtype)


def _attention(q, k, v, pos: torch.Tensor, q_len: int, max_seq: int,
               sliding_window: Optional[int]):
    """Grouped-query attention over the full static cache.

    q: [B, Hq, S, D]; k/v: [B, Hkv, T, D]; pos [B] each sequence's first
    query position. Future and out-of-window slots are masked out."""
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


def can_fused_decode(s: int, b: int, cfg: ModelConfig, max_seq: int,
                     sp: SparsityConfig, block_path: bool) -> bool:
    """Gate for kernel K2 on the layer loop (the reference's
    `_can_fused_decode`): single-token decode at shapes the kernel takes;
    `sp.fused_decode_attention` True forces it, False refuses it, and
    auto (None) turns it on for the block path. Decided from the config
    and shapes alone, never from the device, so that the CPU runs the
    composition the card runs."""
    if sp.fused_decode_attention is False:
        return False
    if not (s == 1 and b <= 16 and cfg.head_dim == 128 and max_seq % 8 == 0
            and cfg.n_heads % cfg.n_kv_heads == 0):
        return False
    return bool(sp.fused_decode_attention) or block_path


def layer_forward(h, lp: Dict[str, torch.Tensor], kc, vc,
                  pos: torch.Tensor, cos, sin, cfg: ModelConfig,
                  sp: SparsityConfig, thresholds, capture: bool = False,
                  fused_attn: bool = False):
    """One transformer block of the layer loop. h: [B, S, D]; lp: this
    layer's parameters; kc/vc: this layer's [B, Hkv, T, Dh] cache views,
    written in place at each sequence's positions; pos: int64 [B] first
    position of each sequence, on h's device; cos/sin: [B, S, Dh];
    thresholds: [7]; fused_attn: single-token attention through K2
    (`can_fused_decode`).

    A single-token input with B <= 8 in block mode takes the reference's
    block route (`teal_tpu/models/llama.py:258-466`): q|k|v, o, gate|up
    and down through `block_gemv.project_many` (K1 in threshold mode,
    with the rms_norm folded in at B = 1; K3 in top-k mode) or
    `project_many_batched` (K3), and at B = 1 in threshold mode with K2
    the attention stage (K1 + K2 with RoPE inside). Outputs leave the
    projections in the stream type, the residual adds are in the stream
    type, and silu runs in fp32 before the cast and the product with up:
    the layer loop's cast points, not the token path's.

    Returns (h_out, kc, vc, captures|None): captures are the four TEAL
    hidden-state groups (attn h1/h2, mlp h1/h2) for calibration."""
    if cfg.n_experts > 0:
        raise NotImplementedError("the MoE FFN is not ported yet")
    _check_plain_weights(lp)
    b, s, d = h.shape
    t = {p: thresholds[i] for i, p in enumerate(PROJS)}
    sparse_block = sp.enabled and sp.kernel == "block"
    use_block = s == 1 and b <= 8 and sparse_block
    fold = (use_block and b == 1 and sp.block_thresholding and not capture
            and d % 128 == 0)
    kf = sp.block_keep_fracs or (sp.block_keep_frac,) * 7

    def blockproj(inp, projs, frac, norm=None):
        """Block-sparse projections `projs` (PROJS names) of one input,
        sharing one selection; the first one's threshold in threshold
        mode."""
        ws = [lp["w" + p][None] for p in projs]
        thr = t[projs[0]] if sp.block_thresholding else None
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
    mega = (fold and fused_attn and kf[0] == kf[1] == kf[2]
            and cfg.head_dim == 128 and sp.fused_attn_block is not False)
    if mega:
        G = effective_block_size(sp.block_size, d)
        rope = torch.stack([cos[:, 0], sin[:, 0]], dim=1)
        attn, _ = attn_stage(
            h.reshape(d), t["q"], lp["wq"][None], lp["wk"][None],
            lp["wv"][None], 0, group_capacity(d // G, kf[0]),
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
        q = q.reshape(b, s, cfg.n_heads, cfg.head_dim).transpose(1, 2)
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
            rows = pos[:, None] + torch.arange(s, device=h.device)[None, :]
            for bi in range(b):
                kc[bi].index_copy_(1, rows[bi], k[bi].to(kc.dtype))
                vc[bi].index_copy_(1, rows[bi], v[bi].to(vc.dtype))
            attn = _attention(q, kc, vc, pos, s, kc.shape[2],
                              cfg.sliding_window)
        attn = attn.transpose(1, 2).reshape(b, s, -1).to(h.dtype)  # attn h2
    if use_block:
        (o_out,) = blockproj(attn, ("o",), kf[3])
        h = h + o_out
    else:
        h = h + _proj(attn, lp["wo"], t["o"], sp)

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
        h = h + _proj(inter, lp["wdown"], t["down"], sp)
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
    16 unless `token_fused` is False (the batched token kernel, which the
    port does not have: `forward` raises for it); group size 128 for
    every stage, equal capacities within the fused stages, head_dim 128,
    the cache in the stream type."""
    kf = sp.block_keep_fracs or (sp.block_keep_frac,) * 7
    ok_b = b == 1 or (b <= 16 and sp.token_fused is not False)
    return (sp.packed_pipeline is not False and fused_attn and s == 1
            and ok_b and sp.enabled and sp.kernel == "block"
            and sp.block_thresholding and cfg.n_experts == 0
            and cfg.head_dim == 128
            and effective_block_size(sp.block_size, cfg.dim) == 128
            and effective_block_size(sp.block_size,
                                     cfg.intermediate_size) == 128
            and kf[0] == kf[1] == kf[2] and kf[4] == kf[5]
            and params["layers"]["wq"].dtype == cache_dtype)


def compute_dtype(params) -> torch.dtype:
    return params["layers"]["wq"].dtype


def forward(params, tokens: torch.Tensor, cache: KVCache, pos, thresholds,
            *, cfg: ModelConfig, sp: SparsityConfig,
            rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Full forward. tokens: [B, S] int; pos: start position shared by the
    batch (int) or one per sequence; thresholds: [L, 7] fp32 on the
    parameters' device; rope: optional (cos, sin) tables from
    `precompute_rope` (computed here when absent). The cache is updated
    in place.

    Returns (logits [B, S, V] fp32, cache)."""
    if sp.debug_fixed_selection:
        raise NotImplementedError("debug_fixed_selection is not ported")
    _check_plain_weights(params["layers"])
    dev = tokens.device
    h = params["embed"][tokens].to(compute_dtype(params))
    b, s = tokens.shape
    if isinstance(pos, torch.Tensor):
        pos = pos.reshape(-1).tolist()
    pos = [int(p) for p in np.atleast_1d(pos)]
    pos = pos * b if len(pos) == 1 else pos
    cos_full, sin_full = rope or precompute_rope(cfg, cache.max_seq, dev)
    lay = params["layers"]
    fused_attn = can_fused_decode(s, b, cfg, cache.max_seq, sp,
                                  sp.enabled and sp.kernel == "block")

    if can_token_decode(params, cfg, sp, s, b, cache.k.dtype,
                        fused_attn=fused_attn):
        from teal_tpu_torch.ops import token_block

        if b > 1:
            raise NotImplementedError(
                "batched decode on the token path (the reference's batched "
                "whole-token kernel) is not ported yet; token_fused=False "
                "runs the layer loop")
        p = pos[0]
        rope_row = torch.stack([cos_full[p], sin_full[p]])[None]
        h1 = token_block.token_decode(
            h.reshape(cfg.dim), thresholds,
            tuple(lay[n] for n in _WEIGHTS), lay["attn_norm"],
            lay["mlp_norm"], rope_row, cache.k, cache.v, p,
            caps=token_path_caps(cfg, sp), n_heads=cfg.n_heads,
            norm_eps=cfg.norm_eps, window=cfg.sliding_window)
        h = h1.reshape(1, 1, cfg.dim)
    else:
        # one fill, not a host-to-device copy, when the batch shares pos
        pos_t = (torch.full((b,), pos[0], dtype=torch.int64, device=dev)
                 if len(set(pos)) == 1 else torch.tensor(pos, device=dev))
        positions = pos_t[:, None] + torch.arange(s, device=dev)[None, :]
        cos, sin = cos_full[positions], sin_full[positions]
        for i in range(cfg.n_layers):
            lp = {k: v[i] for k, v in lay.items()}
            h, _, _, _ = layer_forward(h, lp, cache.k[i], cache.v[i], pos_t,
                                       cos, sin, cfg, sp, thresholds[i],
                                       fused_attn=fused_attn)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _lm_head(params, h), cache


def _lm_head(params, h):
    """Logits: the fp32 sums of the products in the parameters' type, as
    the reference computes them. On the card a bf16 head is one GEMM with
    an fp32 output; elsewhere the product runs in fp32, which holds every
    bf16 product exactly."""
    w = params["lm_head"]
    if h.device.type == "cuda" and w.dtype != torch.float32:
        y = torch.mm(h.reshape(-1, h.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*h.shape[:-1], w.shape[1])
    return torch.matmul(h.float(), w.float())


def zero_thresholds(cfg: ModelConfig, device="cuda"):
    return torch.zeros((cfg.n_layers, len(PROJS)), dtype=torch.float32,
                       device=_device(device))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda"):
    """Random-init parameters on `device` from a seeded `generator` (on
    the same device): N(0, 0.02^2) weights drawn one layer at a time in
    fp32, unit norm gains."""
    device = _device(device)
    if cfg.n_experts > 0:
        raise NotImplementedError("MoE parameters are not ported yet")

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
        "wgate": w((L, D, I)),
        "wup": w((L, D, I)),
        "wdown": w((L, I, D)),
    }
    return {
        "embed": w((V, D)),
        "layers": layers,
        "final_norm": torch.ones((D,), dtype=dtype, device=device),
        "lm_head": w((D, V)),
    }
