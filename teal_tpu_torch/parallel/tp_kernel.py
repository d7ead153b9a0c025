"""Tensor-parallel decode through the port's kernels, a shard a rank.

Port of `teal_tpu/parallel/tp_kernel.py`. The reference runs its Pallas
kernels on each device's local weights inside one `shard_map`; the port
runs K1, K2 and K3 on each rank's local weights in one process a rank:

  - colwise stages (q|k|v, gate|up): the residual stream is the same on
    every rank, so one shared group selection over it keeps the same
    groups everywhere with no communication, and each rank gathers its
    local `[G, N/tp]` slabs (K1 in threshold mode at batch 1, one launch
    for q|k|v and one for gate|up; K3 for 2-8 rows);
  - rowwise stages (o, down): each rank selects over its own input
    groups at the layer's threshold, with its own cap
    `max(1, round(nb_local * keep))` and G from
    `effective_block_size(block_size, K_local)`: the reference's
    per-shard rule (exact while the cap does not bind, since a group
    never straddles two shards; where it binds the first groups by index
    are kept a shard at a time). Each rank's partial `[B, D]` is then
    summed over the tp group. Top-k mode is refused: each shard would
    take its own quota, a different rule;
  - attention: K2 on the rank's heads over its head-sharded stacked
    cache, RoPE and the current token's write inside, at each row's pos.

Two reductions a layer (after o and after down) and one gather of the
colwise logits on the vocabulary axis, the reference's NCCL schedule. A
reduction gathers the partials and adds them in rank order in the
compute type, as the reference's `psum` adds them, so every rank holds
the same residual stream bit for bit: each rank runs the next colwise
selection on its own, and a stream that differed in one bit between
ranks could keep different groups on different ranks.

Packed int4 needs each rowwise local dim to be a multiple of its quant
group (quant group == gather group): Llama-2-7B's I = 11008 splits at
tp 2 (5504 = 43 x 128) but not at tp 4. Mixtral decodes batch 1 with
bf16 experts: the router is a plain matmul with top-k and softmax, as
the reference computes it outside any kernel, and each routed expert's
gate|up and down run through K3 at keep 1.0 on the pseudo-layer
l * E + e of the flattened expert stacks, with one reduction of the
weighted expert sum.

Prefill (`tp_prefill`) runs the sharded forward of `parallel/tp.py`
(dense, masked-dense rule), whose attention takes K6 on the rank's heads
for prompts `llama._can_flash_prefill` accepts, and writes the
head-sharded cache that `tp_kernel_decode` continues on.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from teal_tpu_torch.config import ModelConfig, SparsityConfig
from teal_tpu_torch.models import llama, moe
from teal_tpu_torch.models.llama import KVCache
from teal_tpu_torch.ops import block_gemv
from teal_tpu_torch.ops.decode_attention import decode_attention
from teal_tpu_torch.parallel import tp as _tp
from teal_tpu_torch.parallel.mesh import Mesh, mesh_of, world

def make_tp_mesh(tp: Optional[int] = None,
                 ranks: Optional[Sequence[int]] = None,
                 dp: int = 1) -> Mesh:
    """1-D ("tp",) mesh, or ("dp", "tp") when dp > 1 (batch over dp, heads
    over tp: the full decode topology), over the first dp * tp of
    `ranks` (default: the world)."""
    n = world()[1] if ranks is None else len(ranks)
    tp = tp or n // dp
    if dp == 1:
        return mesh_of((tp,), ("tp",), ranks)
    return mesh_of((dp, tp), ("dp", "tp"), ranks)


shard_params = _tp.shard_params
shard_cache = _tp.shard_cache


def tp_prefill(params, tokens: torch.Tensor, cache: KVCache, thresholds, *,
               cfg: ModelConfig, sp: SparsityConfig, mesh: Mesh):
    """Prompt prefill at pos 0 on the tp mesh through the sharded forward
    (dense prefill in the masked-dense rule, `causal_prefill`: K6 on the
    rank's heads where the prompt allows). Writes this rank's
    head-sharded cache. tokens: [B, S]. Returns (logits [B, S, V], the
    cache)."""
    prefill_sp = sp.replace(kernel="masked_dense", token_fused=False,
                            fused_attn_block=False, packed_pipeline=False,
                            fused_decode_attention=False)
    return _tp.sharded_forward(params, tokens, cache, 0, thresholds,
                               cfg=cfg, sp=prefill_sp, mesh=mesh,
                               causal_prefill=True)


def _int4_rowwise_check(w, K: int, block_size: int, what: str) -> None:
    """A packed int4 rowwise shard gathers at its quant group: its local
    input dim must hold whole quant groups, at the gather group size."""
    nb = w["sz"].shape[-3]
    if K % nb or block_gemv._shared_group_size([w], block_size, K) != K // nb:
        raise ValueError(
            f"packed int4 {what}: the local input dim {K} does not split "
            f"into quant groups of {K // max(nb, 1)} at gather group "
            f"{block_gemv._shared_group_size([w], block_size, K)}; use a "
            "tp degree that keeps whole 128-channel groups a shard")


def _step_rule(params, cfg: ModelConfig, sp: SparsityConfig, mesh: Mesh,
               rows: int):
    """Check a decode step as the reference does and return its rule:
    (keep fractions of the seven projections, threshold mode)."""
    lay = params["layers"]
    wq = lay["wq"]
    if cfg.n_experts > 0:
        if rows != 1:
            raise ValueError("MoE TP kernel decode takes batch 1")
        if isinstance(lay["wgate"], dict):
            raise ValueError("quantized MoE experts: use the sharded "
                             "forward of parallel/tp.py")
    int4 = llama._is_int4_packed(wq)
    if isinstance(wq, dict) and "zero" in wq:
        raise NotImplementedError(
            "unpacked int4 decodes through dequantized matmuls: repack with "
            "quant.pack_int4_params for the kernel TP path")
    thresholding = sp.block_thresholding
    if not sp.enabled:
        # packed int4 always decodes through the gather kernel: dense is
        # full capacity, where per-shard selection is trivially exact
        if not int4:
            raise ValueError(
                "tp_kernel_decode with sparsity off: dense TP decode runs "
                "on the sharded forward (parallel/tp.py)")
        kf, thresholding = (1.0,) * 7, False
    else:
        if sp.kernel != "block":
            raise ValueError("tp_kernel_decode runs the block kernels only "
                             f"(kernel='block'); got {sp.kernel!r}")
        kf = sp.block_keep_fracs or (sp.block_keep_frac,) * 7
        if not thresholding and any(f < 1.0 for f in kf):
            raise NotImplementedError(
                "top-k mode under TP: each shard would top-k its LOCAL "
                "groups, diverging from the single-device global top-k; "
                "use threshold mode (block_thresholding=True), whose "
                "group-local rule is exact a shard")
    _, b = _tp.dp_rows(rows, mesh)
    if b > block_gemv.SUBLANES:
        raise ValueError(f"the block kernels take at most "
                         f"{block_gemv.SUBLANES} rows a dp block; got {b}")
    if int4:
        tp = mesh.axis_size("tp")
        _int4_rowwise_check(lay["wo"], cfg.dim // tp, sp.block_size, "wo")
        _int4_rowwise_check(lay["wdown"], cfg.intermediate_size // tp,
                            sp.block_size, "wdown")
    return tuple(kf), thresholding


def tp_decode_layer(params, h: torch.Tensor, cache: KVCache, i: int,
                    pos: torch.Tensor, rope: torch.Tensor, thresholds, *,
                    cfg: ModelConfig, sp: SparsityConfig, mesh: Mesh,
                    rule=None):
    """Layer i of `tp_kernel_decode` on this rank's shards. h: [B, 1, D]
    this dp block's residual stream (the same on every rank of the tp
    group); pos: int32 [B]; rope: [B, 2, Dh] (cos, sin) rows at pos;
    rule: `_step_rule`'s result (checked here when None). Writes this
    rank's cache rows at pos. Returns (the stream after the o reduction,
    the layer's output), each the same on every rank of the group."""
    kf, thresholding = rule or _step_rule(
        params, cfg, sp, mesh, h.shape[0] * mesh.axis_size("dp"))
    lay = params["layers"]
    B = h.shape[0]
    tpg = mesh.group("tp")
    hq, Dh = cfg.n_heads // mesh.axis_size("tp"), cfg.head_dim
    dtype = h.dtype

    def reduce(x):
        return x if tpg is None else tpg.reduce_sum(x)

    def proj(x2d, ws, frac, layer, j):
        """[B, K] -> one [B, N_local] per stacked weight of ws, read at
        layer (or pseudo-layer) `layer`; j: the threshold column, or
        None for no threshold."""
        thr = thresholds[i, j] if thresholding and j is not None else None
        if B == 1:
            return block_gemv.project_many(x2d, ws, sp.block_size, frac,
                                           layer=layer, threshold=thr)
        return block_gemv.project_many_batched(x2d, ws, sp.block_size, frac,
                                               layer=layer, threshold=thr)

    def stage(x2d, names, cols):
        """Projections sharing one input: one call where their keep
        fractions agree, else one call each (a greedy profile)."""
        fr = [kf[c] for c in cols]
        if len(set(fr)) == 1:
            return proj(x2d, [lay[n] for n in names], fr[0], i, cols[0])
        return [proj(x2d, [lay[n]], f, i, c)[0]
                for n, f, c in zip(names, fr, cols)]

    x = llama.rms_norm(h, lay["attn_norm"][i], cfg.norm_eps).reshape(B, -1)
    q, k, v = stage(x, ("wq", "wk", "wv"), (0, 1, 2))
    attn = decode_attention(
        q.float().reshape(B, hq, Dh), k.float().reshape(B, -1, Dh),
        v.float().reshape(B, -1, Dh), cache.k, cache.v, i, pos,
        window=cfg.sliding_window, rope=rope)
    (o,) = proj(attn.reshape(B, hq * Dh).to(dtype), [lay["wo"]], kf[3], i, 3)
    h = h + reduce(o).reshape(h.shape)
    h_mid = h
    x2 = llama.rms_norm(h, lay["mlp_norm"][i], cfg.norm_eps).reshape(B, -1)
    if cfg.n_experts > 0:
        # the router is replicated: every rank routes alike; the local
        # expert stacks [L, E, K, N] are read as pseudo-layers l * E + e
        flat = [lay[n].reshape((-1,) + tuple(lay[n].shape[2:]))
                for n in ("wgate", "wup", "wdown")]
        idx, wts = moe.route(x2, lay["router"][i], cfg.n_experts_per_tok)
        d_sum = torch.zeros((1, cfg.dim), dtype=torch.float32,
                            device=h.device)
        for t, e in enumerate(idx[0].tolist()):
            le = i * cfg.n_experts + e
            g, u = proj(x2, flat[:2], 1.0, le, None)
            inter = (F.silu(g.float()) * u.float()).to(dtype)
            (d_e,) = proj(inter, flat[2:], 1.0, le, None)
            d_sum = d_sum + wts[0, t] * d_e.float()
        return h_mid, h + reduce(d_sum).to(dtype).reshape(h.shape)
    g, u = stage(x2, ("wgate", "wup"), (4, 5))
    inter = (F.silu(g.float()) * u.float()).to(dtype)
    (d,) = proj(inter, [lay["wdown"]], kf[6], i, 6)
    return h_mid, h + reduce(d).reshape(h.shape)


def tp_kernel_decode(params, tokens: torch.Tensor, cache: KVCache, pos,
                     thresholds, *, cfg: ModelConfig, sp: SparsityConfig,
                     mesh: Mesh):
    """One TP decode step (one token a row, at most 8 rows a dp block)
    through the kernels: `tp_decode_layer` over the layers.

    params / cache: this rank's shards (`shard_params`, `shard_cache`;
    cache [L, B/dp, Hkv/tp, T, Dh]); tokens [B, 1] and pos (int or [B]:
    each row at its own depth): the whole batch, the same on every rank;
    thresholds [L, 7] on the params' device. Batch 2-8 takes one
    batch-pooled selection a stage (`project_many_batched`, K3).

    Returns (logits [B, 1, V] fp32, the same on every rank; this rank's
    cache, updated in place)."""
    rule = _step_rule(params, cfg, sp, mesh, tokens.shape[0])
    lo, B = _tp.dp_rows(tokens.shape[0], mesh)
    dev = tokens.device
    pos_b = torch.tensor(_tp.batch_pos(pos, tokens.shape[0])[lo:lo + B],
                         dtype=torch.int32, device=dev)
    cos_full, sin_full = llama.precompute_rope(cfg, cache.max_seq, dev)
    rope = llama._rope_rows(cos_full, sin_full, pos_b)
    h = params["embed"][tokens[lo:lo + B]].to(llama.compute_dtype(params))
    for i in range(cfg.n_layers):
        _, h = tp_decode_layer(params, h, cache, i, pos_b, rope, thresholds,
                               cfg=cfg, sp=sp, mesh=mesh, rule=rule)
    h = llama.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = llama._lm_head(params, h)
    tpg, dpg = mesh.group("tp"), mesh.group("dp")
    if tpg is not None:
        logits = tpg.all_gather(logits, -1)
    if dpg is not None:
        logits = dpg.all_gather(logits, 0)
    return logits, cache
