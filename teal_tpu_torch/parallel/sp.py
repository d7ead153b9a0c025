"""Sequence (context) parallelism for long-prompt prefill.

Port of `teal_tpu/parallel/sp.py`. The prompt's sequence dim is split
over an "sp" mesh axis, so prefill activation memory, O(S * D * L),
shrinks by the axis size while each rank works on its contiguous chunk:

  - each rank ropes and projects its own chunk at its global positions;
  - per layer, the k/v chunks are gathered along S over the sp group and
    the whole block is written into a replicated cache at the prompt's
    base, the cache single-device prefill writes, so decode can go on on
    any rank or mesh after it;
  - local queries attend causally to the whole cache (the gathered-KV
    form of context parallelism; never through K6, as the reference
    skips its flash kernel under `seq_axis`);
  - the S-sharded logits are gathered back along S.

Composition with tensor parallelism: on an ("sp", "tp") mesh the
parameters are `tp.shard_params` shards and each chunk's layer loop runs
the sharded forward of `parallel/tp.py` on the tp group; the cache comes
back replicated over sp and head-sharded over tp, ready for TP decode on
the same mesh (the prefill-to-decode hand-off of tests/test_composed.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from teal_tpu_torch.config import ModelConfig, SparsityConfig
from teal_tpu_torch.models import llama
from teal_tpu_torch.models.llama import KVCache
from teal_tpu_torch.parallel.mesh import Mesh, mesh_of, world


def make_sp_mesh(sp: Optional[int] = None,
                 ranks: Optional[Sequence[int]] = None,
                 tp: int = 1) -> Mesh:
    """("sp",) mesh, or ("sp", "tp") when tp > 1 (composed sequence x
    tensor parallel prefill), over the first sp * tp of `ranks`."""
    n = world()[1] if ranks is None else len(ranks)
    sp = sp or n // tp
    if tp > 1:
        return mesh_of((sp, tp), ("sp", "tp"), ranks)
    return mesh_of((sp,), ("sp",), ranks)


def sp_prefill(params, tokens: torch.Tensor, cache: KVCache, pos,
               thresholds, *, cfg: ModelConfig, sp: SparsityConfig,
               mesh: Mesh):
    """Sequence-parallel prefill. tokens: [B, S], the whole prompt on every
    rank, S divisible by the sp axis size; pos: the prompt's base
    position (an int, normally 0); params and cache: the full tree and a
    full cache, or this rank's tp shards on an ("sp", "tp") mesh.

    Returns (logits [B, S, V] fp32, the cache), both the same on every
    rank of the sp group; the cache, updated in place, equals
    single-device prefill's."""
    n_sp = mesh.shape["sp"]
    b, s = tokens.shape
    if s % n_sp:
        raise ValueError(f"prompt length {s} not divisible by sp={n_sp}")
    s_local = s // n_sp
    chunk = mesh.coord("sp")
    return llama.forward(
        params, tokens[:, chunk * s_local:(chunk + 1) * s_local], cache,
        int(pos) + chunk * s_local, thresholds, cfg=cfg, sp=sp,
        tp_group=mesh.group("tp"), seq_group=mesh.group("sp"))
