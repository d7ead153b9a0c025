"""Rank meshes over `torch.distributed`, and the collectives along an axis.

Port of `teal_tpu/parallel/mesh.py`. The JAX package runs one program
over a `jax.sharding.Mesh` of devices, and XLA (or `shard_map`'s `psum`,
`all_gather`, `ppermute`) moves the data. The port runs one process a
rank: each rank holds its own shard on its own device, and the code
calls collectives on explicit process groups, one group for each line of
ranks along a mesh axis.

Ranks are laid out row-major over the axes, as the reference reshapes its
device list (`np.reshape(devices, (dp, tp))`): on a ("dp", "tp") mesh of
ranks r0..r3, dp line 0 is (r0, r1) and the tp groups are {r0, r1} and
{r2, r3}. The groups come from plain `dist.new_group`, which every rank
of the world calls for every group in one order; `DeviceMesh` is not
used, since it assumes one device a rank, and several ranks may share
one card.

Every collective of `AxisGroup` hands back the same bits on every rank
of the group: a sum is the gathered parts added in axis order in the
parts' type, never the transport's own reduction order. On a gloo group
a CUDA tensor is staged through the host (gloo moves host memory);
on an NCCL group tensors stay on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def world() -> Tuple[int, int]:
    """(this process's rank, the world size); (0, 1) without a process
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class AxisGroup:
    """The ranks along one mesh axis that share this rank's coordinates on
    the other axes, in axis order, and the collectives among them.

    `group` is their process group, or None in a process that runs
    without `torch.distributed` (a mesh of one rank); then every
    collective returns its input."""

    def __init__(self, name: str, ranks: Sequence[int], index: int,
                 group=None):
        self.name = name
        self.ranks = tuple(ranks)
        self.index = index
        self.group = group

    @property
    def size(self) -> int:
        return len(self.ranks)

    def __repr__(self) -> str:
        return (f"AxisGroup({self.name!r}, ranks={self.ranks}, "
                f"index={self.index})")

    def _staged(self, x: torch.Tensor) -> bool:
        """Whether x must pass through the host: a CUDA tensor on gloo."""
        return x.is_cuda and dist.get_backend(self.group) == "gloo"

    def parts(self, x: torch.Tensor):
        """Every rank's x, as a list in axis order."""
        if self.group is None:
            return [x]
        staged = self._staged(x)
        src = (x.cpu() if staged else x).contiguous()
        parts = [torch.empty_like(src) for _ in self.ranks]
        dist.all_gather(parts, src, group=self.group)
        return [p.to(x.device) for p in parts] if staged else parts

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's x, concatenated along `dim` in axis order."""
        return x if self.group is None else torch.cat(self.parts(x), dim=dim)

    def reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's x, added in axis order in x's type (the
        reference's `psum`): the same bits on every rank, whatever order
        the transport would reduce in."""
        ps = self.parts(x)
        out = ps[0]
        for p in ps[1:]:
            out = out + p
        return out

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """The tensor of the rank at axis index `src`, on every rank (x is
        the buffer: its shape and type must match on every rank)."""
        if self.group is None:
            return x
        staged = self._staged(x)
        buf = (x.cpu() if staged else x).contiguous()
        dist.broadcast(buf, src=self.ranks[src], group=self.group)
        return buf.to(x.device) if staged else buf

    def send(self, x: torch.Tensor, dst: int) -> None:
        """Send x to the rank at axis index `dst` (a point-to-point send on
        the world group; the matching `recv` must be posted there)."""
        staged = self._staged(x)
        dist.send((x.cpu() if staged else x).contiguous(),
                  dst=self.ranks[dst])

    def recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        """Receive a tensor of `like`'s shape and type from the rank at axis
        index `src`, on `like`'s device."""
        staged = self._staged(like)
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if staged else like.device)
        dist.recv(buf, src=self.ranks[src])
        return buf.to(like.device) if staged else buf


class Mesh:
    """A row-major grid of ranks with named axes (the port's counterpart of
    `jax.sharding.Mesh`).

    axis_names: the axes, outermost first; shape: {axis: size};
    ranks: the global ranks, an array of that shape; coords: this rank's
    coordinate on each axis, or None where this rank is outside the mesh;
    groups: {axis: AxisGroup} for this rank (empty outside the mesh)."""

    def __init__(self, ranks: np.ndarray, axis_names: Tuple[str, ...]):
        if ranks.ndim != len(axis_names):
            raise ValueError(f"a mesh of shape {ranks.shape} needs "
                             f"{ranks.ndim} axis names; got {axis_names}")
        self.axis_names = tuple(axis_names)
        self.ranks = ranks
        self.shape: Dict[str, int] = dict(zip(axis_names, ranks.shape))
        me, n_world = world()
        if ranks.max() >= n_world or len(np.unique(ranks)) != ranks.size:
            raise ValueError(f"mesh ranks {ranks.ravel().tolist()} are not "
                             f"distinct ranks of a world of {n_world}")
        where = np.argwhere(ranks == me)
        self.coords: Optional[Dict[str, int]] = (
            dict(zip(axis_names, (int(c) for c in where[0])))
            if len(where) else None)
        self.groups: Dict[str, AxisGroup] = {}
        # every rank of the world creates every group, in one order
        for a, name in enumerate(axis_names):
            moved = np.moveaxis(ranks, a, -1)
            for line in moved.reshape(-1, ranks.shape[a]):
                line = [int(r) for r in line]
                group = dist.new_group(line) if dist.is_initialized() \
                    else None
                if me in line:
                    self.groups[name] = AxisGroup(name, line,
                                                  line.index(me), group)

    @property
    def member(self) -> bool:
        return self.coords is not None

    def group(self, axis: str) -> Optional[AxisGroup]:
        """This rank's group along `axis`, or None where the mesh has no
        such axis."""
        return self.groups.get(axis)

    def coord(self, axis: str) -> int:
        """This rank's coordinate on `axis` (0 where the mesh lacks it)."""
        return self.coords.get(axis, 0) if self.coords else 0

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def mesh_of(sizes: Sequence[int], axis_names: Sequence[str],
            ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh of `sizes` over the first prod(sizes) of `ranks` (default:
    every rank of the world), row-major. Raises when there are too few."""
    n = int(np.prod(sizes))
    ranks = list(range(world()[1])) if ranks is None else list(ranks)
    if len(ranks) < n:
        raise ValueError(f"{' * '.join(f'{a}={s}' for a, s in zip(axis_names, sizes))}"
                         f" = {n} > {len(ranks)} ranks")
    return Mesh(np.asarray(ranks[:n]).reshape(tuple(sizes)),
                tuple(axis_names))


def make_mesh(tp: Optional[int] = None, dp: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A ("dp", "tp") mesh over all of `ranks` (default: the world), as
    the reference's `make_mesh(tp, dp, devices)`: tp defaults to the
    ranks over dp, and dp * tp must equal their count."""
    ranks = list(range(world()[1])) if ranks is None else list(ranks)
    n = len(ranks)
    if tp is None:
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} ranks")
    return mesh_of((dp, tp), ("dp", "tp"), ranks)

