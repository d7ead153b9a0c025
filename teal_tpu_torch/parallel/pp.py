"""Pipeline parallelism over the layer-stacked parameter tree.

Port of `teal_tpu/parallel/pp.py`. The stacked `[L, ...]` layout makes a
pipeline stage a split of dim 0 over a "pp" mesh axis: stage s owns the
contiguous layers [s*L/S, (s+1)*L/S) with no re-packing, and the KV
cache splits its layer dim the same way. The schedule is GPipe's over
`n_micro` microbatches:

  - stage 0 embeds microbatch m and runs its layers, each later stage
    receives m's hidden state from the stage before (`send` / `recv`,
    the reference's `ppermute`), runs its layers and passes it on;
  - the last stage applies the final norm and the head; its logits reach
    every rank of the pp group by one broadcast (the reference adds the
    stages' buffers with a `psum`, which gives the same tensor).

The reference runs every stage in lock step over n_micro + S - 1 rounds
and masks the cache writes of the fill and drain rounds; here a stage
simply waits for its input, so those rounds compute nothing and write no
cache row.

Composition: on a ("dp", "pp", "tp") mesh (`make_pp_mesh(pp, dp=, tp=)`)
a stage's layers are also tp shards (`pp_param_specs(..., tp=True)`:
the Megatron splits of `tp.param_specs` on the weight dims, "pp" on the
layer dim, the head split colwise) and run the sharded layer loop of
`parallel/tp.py` on the tp group, while each dp block pipelines its own
rows of the batch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from teal_tpu_torch.config import ModelConfig, SparsityConfig
from teal_tpu_torch.models import llama
from teal_tpu_torch.models.llama import KVCache
from teal_tpu_torch.parallel import tp as tp_mod
from teal_tpu_torch.parallel.mesh import Mesh, mesh_of, world


def make_pp_mesh(pp: Optional[int] = None,
                 ranks: Optional[Sequence[int]] = None, dp: int = 1,
                 tp: int = 1) -> Mesh:
    """("pp",) mesh, or ("dp", "pp", "tp") when dp or tp > 1 (composed 3-D
    parallelism; an axis of size 1 is kept so that the specs stay
    uniform), over the first dp * pp * tp of `ranks`."""
    n = world()[1] if ranks is None else len(ranks)
    pp = pp or n // (dp * tp)
    if dp > 1 or tp > 1:
        return mesh_of((dp, pp, tp), ("dp", "pp", "tp"), ranks)
    return mesh_of((pp,), ("pp",), ranks)


def _stage_spec(a: torch.Tensor) -> tuple:
    return ("pp",) + (None,) * (a.dim() - 1)


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def pp_param_specs(params, cfg: Optional[ModelConfig] = None,
                   tp: bool = False):
    """The split dims of every leaf: stacked layer leaves split over "pp"
    on dim 0 (each stage a contiguous slab of layers); the embedding,
    final norm and head replicated. tp=True (needs cfg): the layer leaves
    also carry `tp.param_specs`' Megatron splits on their weight dims,
    and the head splits colwise."""
    if tp:
        specs = tp_mod.param_specs(cfg, params)
        return {
            "embed": (),
            "layers": _map_specs(
                lambda s: ("pp",) + tuple(s)[1:], specs["layers"]),
            "final_norm": (),
            "lm_head": specs["lm_head"],
        }
    return {
        "embed": (),
        "layers": _map_specs(_stage_spec, params["layers"]),
        "final_norm": (),
        "lm_head": _map_specs(lambda a: (), params["lm_head"]),
    }


def pp_shard_params(params, mesh: Mesh, cfg: ModelConfig):
    """This rank's stage (and tp shard) of the full parameter tree."""
    pp = mesh.shape["pp"]
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={pp}")
    tp = mesh.axis_size("tp") > 1
    if tp:
        tp_mod.check_divisible(cfg, mesh.axis_size("tp"))
    return tp_mod.shard_tree(params, pp_param_specs(params, cfg, tp=tp), mesh)


def pp_shard_cache(cache: KVCache, mesh: Mesh) -> KVCache:
    """This rank's block of a full cache: layers over pp (and batch over
    dp, heads over tp on a 3-D mesh)."""
    spec = (("pp", "dp", "tp", None, None) if mesh.axis_names != ("pp",)
            else ("pp",))
    return KVCache(k=tp_mod.shard_tensor(cache.k, spec, mesh),
                   v=tp_mod.shard_tensor(cache.v, spec, mesh))


def pp_forward(params, tokens: torch.Tensor, cache: KVCache, pos,
               thresholds, *, cfg: ModelConfig, sp: SparsityConfig,
               mesh: Mesh, n_micro: int = 2):
    """Pipelined forward. params / cache: this rank's stage
    (`pp_shard_params`, `pp_shard_cache`); tokens [B, S] and pos (int or
    [B]): the whole batch on every rank; thresholds [L, 7] for all
    layers. B must split over dp and then into n_micro microbatches.

    Returns (logits [B, S, V] fp32, the same on every rank; this rank's
    cache, updated in place)."""
    n_stages, stage = mesh.shape["pp"], mesh.coord("pp")
    b, s = tokens.shape
    dp = mesh.axis_size("dp")
    if b % (dp * n_micro):
        raise ValueError(f"batch {b} not divisible by n_micro={n_micro}"
                         + (f" on each of dp={dp} blocks" if dp > 1 else ""))
    lo, b_loc = tp_mod.dp_rows(b, mesh)
    mb = b_loc // n_micro
    pos = tp_mod.batch_pos(pos, b)[lo:lo + b_loc]
    tpg, ppg = mesh.group("tp"), mesh.group("pp")
    lay = params["layers"]
    if tpg is not None and tpg.size > 1:
        llama.check_sharded(params, cfg, sp, s)
    dtype = llama.compute_dtype(params)
    dev = tokens.device
    l_local = cache.k.shape[0]
    cos_full, sin_full = llama.precompute_rope(cfg, cache.max_seq, dev)
    pos_t = torch.tensor(pos, dtype=torch.int64, device=dev)
    positions = pos_t[:, None] + torch.arange(s, device=dev)[None, :]
    cos_all, sin_all = cos_full[positions], sin_full[positions]
    last = n_stages - 1
    logits = None
    for m in range(n_micro):
        off = m * mb
        if stage == 0:
            h = params["embed"][tokens[lo + off:lo + off + mb]].to(dtype)
        else:
            h = ppg.recv(torch.empty((mb, s, cfg.dim), dtype=dtype,
                                     device=dev), stage - 1)
        for li in range(l_local):
            lp = {k: llama._leaf(v, lambda a: a[li]) for k, v in lay.items()}
            h, _, _, _ = llama.layer_forward(
                h, lp, cache.k[li, off:off + mb], cache.v[li, off:off + mb],
                pos_t[off:off + mb], cos_all[off:off + mb],
                sin_all[off:off + mb], cfg, sp,
                thresholds[stage * l_local + li], tp_group=tpg)
        if stage < last:
            ppg.send(h, stage + 1)
            continue
        out = llama._lm_head(params, llama.rms_norm(h, params["final_norm"],
                                                    cfg.norm_eps))
        if tpg is not None:
            out = tpg.all_gather(out, -1)
        if logits is None:
            logits = torch.empty((b_loc, s, out.shape[-1]),
                                 dtype=torch.float32, device=dev)
        logits[off:off + mb] = out
    if stage < last:
        logits = torch.empty((b_loc, s, cfg.vocab_size), dtype=torch.float32,
                             device=dev)
    logits = ppg.broadcast(logits, last)
    dpg = mesh.group("dp")
    return (logits if dpg is None else dpg.all_gather(logits, 0)), cache
