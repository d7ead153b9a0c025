"""Tensor-parallel shardings (Megatron-style 1-D TP) and the sharded forward.

Port of `teal_tpu/parallel/tp.py`. The reference states, for each leaf of
the layer-stacked parameter tree, which dim is split over the "tp" mesh
axis (`param_specs`), places the leaves with those shardings, and lets
GSPMD run `llama.forward` on them: colwise shards (q, k, v, gate, up,
lm_head) split the output dim, rowwise shards (o, down) the input dim,
and XLA adds a `psum` after each rowwise projection. The port keeps the
specs (tuples in the place of `PartitionSpec`s, one axis name or None a
dim), slices each rank's shard out of the full tree (`shard_params`,
`shard_cache`), and runs the sharded forward as one process a rank
(`sharded_forward`): the layer loop on the rank's heads and intermediate
channels, the rowwise outputs summed over the tp group, the colwise
logits gathered on the vocabulary axis.

Sparsity composes with TP as in the reference: the TEAL threshold is
elementwise, so a shard of the sparsified input is the sparsified shard.
A rule that is not shard-local (the group rule's cap or top-k on a
rowwise input) runs on the gathered input, so every rank keeps the
groups a single device keeps; the single-token kernels (block or gather
mode, packed int4) are refused here: `parallel/tp_kernel.tp_kernel_decode`
runs them a shard at a time, as the reference does.
"""

from __future__ import annotations

from typing import Optional

import torch

from teal_tpu_torch.config import ModelConfig, SparsityConfig
from teal_tpu_torch.models import llama
from teal_tpu_torch.models.llama import KVCache
from teal_tpu_torch.parallel.mesh import Mesh

REPLICATED = ()


def _leaf_specs(leaf, wspec: tuple):
    """Specs for one projection entry: arrays take `wspec`; a quantized
    dict gets one spec a field (wspec's last two entries cover (K, N)):
    the int8 scale [..., N] takes the N entry, int4 group parameters
    [..., nb(, 2), N] split their group dim like K."""
    if not isinstance(leaf, dict):
        return wspec
    dims = tuple(wspec)
    if "qp" in leaf:                 # packed int4 {"qp", "sz" [.., nb, 2, N]}
        return {"qp": wspec, "sz": (*dims[:-2], dims[-2], None, dims[-1])}
    if "zero" in leaf:               # unpacked int4 {"q", "scale", "zero"}
        return {"q": wspec, "scale": wspec, "zero": wspec}
    return {"q": wspec, "scale": (*dims[:-2], dims[-1])}         # int8


def param_specs(cfg: ModelConfig, params=None):
    """The split dim of every parameter leaf, as the reference's
    `param_specs` (`teal_tpu/parallel/tp.py:40-110`): a tuple with "tp"
    at the split dim and None elsewhere; () for a replicated leaf.
    colwise: wq wk wv wgate wup lm_head; rowwise: wo wdown. Mixtral's
    expert stacks split on their intermediate dim and the router stays
    replicated. With `params`, quantized dict leaves get a spec a
    field."""
    layers = {
        "attn_norm": REPLICATED,
        "mlp_norm": REPLICATED,
        "wq": (None, None, "tp"),
        "wk": (None, None, "tp"),
        "wv": (None, None, "tp"),
        "wo": (None, "tp", None),
    }
    if cfg.n_experts > 0:
        layers.update({
            "router": REPLICATED,
            "wgate": (None, None, None, "tp"),
            "wup": (None, None, None, "tp"),
            "wdown": (None, None, "tp", None),
        })
    else:
        layers.update({
            "wgate": (None, None, "tp"),
            "wup": (None, None, "tp"),
            "wdown": (None, "tp", None),
        })
    specs = {
        "embed": REPLICATED,
        "layers": layers,
        "final_norm": REPLICATED,
        "lm_head": (None, "tp"),
    }
    if params is not None:
        specs["layers"] = {k: _leaf_specs(params["layers"][k], s)
                           for k, s in layers.items()}
        specs["lm_head"] = _leaf_specs(params["lm_head"], specs["lm_head"])
    return specs


def cache_specs(dp: Optional[str] = "dp") -> KVCache:
    """KV cache [L, B, Hkv, T, Dh]: batch over dp (None for a mesh without
    one), heads over tp."""
    return KVCache(k=(None, dp, "tp", None, None),
                   v=(None, dp, "tp", None, None))


def shard_tensor(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of t under `spec` (an axis name or None a dim; an
    axis the mesh lacks is not split), as a contiguous copy that keeps
    nothing of t alive; t itself where nothing is split."""
    out = t
    for d, axis in enumerate(spec):
        n = mesh.axis_size(axis) if axis is not None else 1
        if n == 1:
            continue
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of a {tuple(t.shape)} leaf is not "
                             f"divisible by {axis}={n}")
        size = t.shape[d] // n
        out = out.narrow(d, mesh.coord(axis) * size, size)
    return out if out is t else out.clone(memory_format=torch.contiguous_format)


def shard_tree(tree, specs, mesh: Mesh):
    """`shard_tensor` over a tree (dicts) of tensors and its spec tree."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return shard_tensor(tree, specs, mesh)


def check_divisible(cfg: ModelConfig, tp: int) -> None:
    """n_heads, n_kv_heads and intermediate_size (and the vocabulary of
    the colwise head) must split evenly over tp (the reference divides
    the head counts the same way)."""
    for field, count in (("n_heads", cfg.n_heads),
                         ("n_kv_heads", cfg.n_kv_heads),
                         ("intermediate_size", cfg.intermediate_size),
                         ("vocab_size", cfg.vocab_size)):
        if count % tp:
            raise ValueError(f"{field}={count} not divisible by tp={tp}")


def shard_params(params, mesh: Mesh, cfg: ModelConfig):
    """This rank's shard of the full parameter tree under `param_specs`
    (the reference places the tree on the mesh; here each rank keeps its
    block, each split leaf a contiguous copy so that the kernels take it
    as it is). Raises ValueError where a count does not divide."""
    check_divisible(cfg, mesh.axis_size("tp"))
    return shard_tree(params, param_specs(cfg, params), mesh)


def shard_cache(cache: KVCache, mesh: Mesh) -> KVCache:
    """This rank's block of a full cache: heads over tp, batch over dp."""
    s = cache_specs("dp" if "dp" in mesh.axis_names else None)
    return KVCache(k=shard_tensor(cache.k, s.k, mesh),
                   v=shard_tensor(cache.v, s.v, mesh))


def dp_rows(n: int, mesh: Mesh):
    """(first row, rows) of this rank's dp block of a batch of n."""
    dp = mesh.axis_size("dp")
    if n % dp:
        raise ValueError(f"batch {n} not divisible by dp={dp}")
    b = n // dp
    return mesh.coord("dp") * b, b


def batch_pos(pos, n: int):
    """pos (an int, a list or a tensor of one or n entries) as n ints."""
    if isinstance(pos, torch.Tensor):
        pos = pos.reshape(-1).tolist()
    pos = [int(p) for p in (pos if isinstance(pos, (list, tuple))
                            else [pos])]
    return pos * n if len(pos) == 1 else pos


def sharded_forward(params, tokens: torch.Tensor, cache: KVCache, pos,
                    thresholds, *, cfg: ModelConfig, sp: SparsityConfig,
                    mesh: Mesh, causal_prefill: bool = False):
    """`llama.forward` on this rank's shards: what GSPMD gives the
    reference under `jax.set_mesh(mesh)` with `shard_params` trees.

    params / cache: this rank's shards (`shard_params`, `shard_cache`);
    tokens [B, S] and pos (int or [B]): the whole batch, the same on
    every rank (each dp block takes its rows); thresholds [L, 7].
    Returns (logits [B, S, V] fp32, the same on every rank; this rank's
    cache, updated in place)."""
    lo, b = dp_rows(tokens.shape[0], mesh)
    pos = batch_pos(pos, tokens.shape[0])[lo:lo + b]
    logits, cache = llama.forward(
        params, tokens[lo:lo + b], cache, pos, thresholds, cfg=cfg, sp=sp,
        causal_prefill=causal_prefill, tp_group=mesh.group("tp"))
    dpg = mesh.group("dp")
    return (logits if dpg is None else dpg.all_gather(logits, 0)), cache
