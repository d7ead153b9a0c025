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

`forward` sends batch-1 single-token threshold-mode decode at G=128 (the
main path) to `ops/token_block.token_decode`, which runs on the port's
CUDA kernels; everything else runs the plain layer loop (dense, and the
masked-dense accuracy path in "teal" or "group" mode).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from teal_tpu_torch.config import ModelConfig, PROJS, SparsityConfig
from teal_tpu_torch.ops import sparse_gemv
from teal_tpu_torch.ops.block_gemv import effective_block_size
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


def _proj(x, w, thresh, sp: SparsityConfig):
    """One of the seven sparsifiable projections: sparsify then matmul."""
    if isinstance(w, dict):
        raise NotImplementedError("quantized weights are not ported yet")
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


def layer_forward(h, lp: Dict[str, torch.Tensor], kc, vc,
                  pos: torch.Tensor, cos, sin, cfg: ModelConfig,
                  sp: SparsityConfig, thresholds, capture: bool = False):
    """One transformer block on the plain path (dense, or masked-dense
    sparse). h: [B, S, D]; kc/vc: this layer's [B, Hkv, T, Dh] cache
    views, written in place at each sequence's positions; pos: int64 [B]
    first position of each sequence, on h's device; cos/sin: [B, S, Dh];
    thresholds: [7].

    Returns (h_out, kc, vc, captures|None): captures are the four TEAL
    hidden-state groups (attn h1/h2, mlp h1/h2) for calibration."""
    if cfg.n_experts > 0:
        raise NotImplementedError("the MoE FFN is not ported yet")
    b, s, d = h.shape
    t = {p: thresholds[i] for i, p in enumerate(PROJS)}

    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)          # attn h1
    q = _proj(x, lp["wq"], t["q"], sp)
    k = _proj(x, lp["wk"], t["k"], sp)
    v = _proj(x, lp["wv"], t["v"], sp)
    hkv = kc.shape[1]
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim).transpose(1, 2)
    k = k.reshape(b, s, hkv, cfg.head_dim).transpose(1, 2)
    v = v.reshape(b, s, hkv, cfg.head_dim).transpose(1, 2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    rows = pos[:, None] + torch.arange(s, device=h.device)[None, :]
    for bi in range(b):
        kc[bi].index_copy_(1, rows[bi], k[bi].to(kc.dtype))
        vc[bi].index_copy_(1, rows[bi], v[bi].to(vc.dtype))
    attn = _attention(q, kc, vc, pos, s, kc.shape[2], cfg.sliding_window)
    attn = attn.transpose(1, 2).reshape(b, s, -1).to(h.dtype)  # attn h2
    h = h + _proj(attn, lp["wo"], t["o"], sp)

    y = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)           # mlp h1
    gate = _proj(y, lp["wgate"], t["gate"], sp)
    up = _proj(y, lp["wup"], t["up"], sp)
    inter = F.silu(gate.float()).to(gate.dtype) * up         # mlp h2
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
                     s: int, b: int, cache_dtype) -> bool:
    """Gate for the main path: batch-1 single-token threshold-mode decode
    at group size 128 for every stage, equal capacities within the fused
    stages, plain weight tensors, head_dim 128, cache in the stream type."""
    kf = sp.block_keep_fracs or (sp.block_keep_frac,) * 7
    lay = params["layers"]
    return (s == 1 and b == 1 and sp.enabled and sp.kernel == "block"
            and sp.block_thresholding and cfg.n_experts == 0
            and cfg.head_dim == 128
            and effective_block_size(sp.block_size, cfg.dim) == 128
            and effective_block_size(sp.block_size,
                                     cfg.intermediate_size) == 128
            and kf[0] == kf[1] == kf[2] and kf[4] == kf[5]
            and all(isinstance(lay[n], torch.Tensor) for n in _WEIGHTS)
            and lay["wq"].dtype == cache_dtype)


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
    dev = tokens.device
    h = params["embed"][tokens].to(compute_dtype(params))
    b, s = tokens.shape
    if isinstance(pos, torch.Tensor):
        pos = pos.reshape(-1).tolist()
    pos = [int(p) for p in np.atleast_1d(pos)]
    pos = pos * b if len(pos) == 1 else pos
    cos_full, sin_full = rope or precompute_rope(cfg, cache.max_seq, dev)
    lay = params["layers"]

    if can_token_decode(params, cfg, sp, s, b, cache.k.dtype):
        from teal_tpu_torch.ops import token_block

        p = pos[0]
        rope_row = torch.stack([cos_full[p], sin_full[p]])[None]
        h1 = token_block.token_decode(
            h.reshape(cfg.dim), thresholds,
            tuple(lay[n] for n in _WEIGHTS), lay["attn_norm"],
            lay["mlp_norm"], rope_row, cache.k, cache.v, p,
            caps=token_path_caps(cfg, sp), n_heads=cfg.n_heads,
            norm_eps=cfg.norm_eps, window=cfg.sliding_window)
        h = h1.reshape(1, 1, cfg.dim)
    elif sp.enabled and sp.kernel != "masked_dense" and s == 1:
        raise NotImplementedError(
            "sparse decode outside the batch-1 threshold-mode G=128 token "
            "path needs kernels the port does not have yet (ROADMAP.md)")
    else:
        # one fill, not a host-to-device copy, when the batch shares pos
        pos_t = (torch.full((b,), pos[0], dtype=torch.int64, device=dev)
                 if len(set(pos)) == 1 else torch.tensor(pos, device=dev))
        positions = pos_t[:, None] + torch.arange(s, device=dev)[None, :]
        cos, sin = cos_full[positions], sin_full[positions]
        for i in range(cfg.n_layers):
            lp = {k: v[i] for k, v in lay.items()}
            h, _, _, _ = layer_forward(h, lp, cache.k[i], cache.v[i], pos_t,
                                       cos, sin, cfg, sp, thresholds[i])
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _lm_head(params, h), cache


def _lm_head(params, h):
    """Logits in fp32. A bf16 model's product comes out of the library
    GEMM rounded to bf16 before the upcast (the JAX package keeps the
    fp32 sums); an fp32 model's is exact fp32."""
    return torch.matmul(h, params["lm_head"]).float()


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
