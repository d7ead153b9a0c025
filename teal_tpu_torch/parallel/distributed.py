"""Process-group start-up and the world mesh.

Port of `teal_tpu/parallel/distributed.py`. The reference starts one
process a host with `jax.distributed.initialize()` (the JAX_* variables
override the auto-detected values) and builds one mesh over every chip.
The port starts one process a rank, as `torchrun` launches them, and
reads torchrun's variables the same way: RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, and MASTER_ADDR / MASTER_PORT through the `env://`
rendezvous. Two nodes of N cards each, the script calling
`initialize_distributed()` and `global_mesh(tp=N, dp=2)`:

    # on node i (0 or 1); ADDR is node 0's address, reachable from both
    torchrun --nnodes 2 --node-rank i --master-addr ADDR \\
        --master-port 29500 --nproc-per-node N script.py

torchrun numbers the ranks node by node (node i holds ranks i*N ..
i*N + N - 1), so the ("dp", "tp") mesh lays dp over the nodes and tp
over the cards of a node, as the reference's "tp = chips per host, dp =
number of hosts".

Each rank runs on its own card, cuda:LOCAL_RANK (its index on its node;
RANK counts across nodes), set before the process group starts; the
backend is NCCL on a card and gloo on the CPU, or gloo where the caller
names it (several ranks sharing one card, whose NCCL refuses two ranks on
one device). Nothing falls back: a missing variable or a failed start
raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from teal_tpu_torch.parallel.mesh import Mesh, make_mesh, world


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def local_card(device="cuda", world_size: Optional[int] = None
               ) -> torch.device:
    """This rank's card: `device` where it names an index (e.g. "cuda:0"
    for ranks sharing one card), else cuda:LOCAL_RANK, the rank's index
    on its own node (never RANK, which counts across nodes). In a group
    of more than one rank (`world_size`, default WORLD_SIZE) LOCAL_RANK
    must be set; a single process takes cuda:0 without it. Reads the
    environment only: touches no card."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE")
    local = _env_int("LOCAL_RANK")
    if local is None:
        if world_size not in (None, 1):
            raise RuntimeError(
                f"LOCAL_RANK is not set in a group of {world_size} ranks: "
                "launch with torchrun, or name the card (device='cuda:i')")
        local = 0
    n_local = _env_int("LOCAL_WORLD_SIZE")
    if local < 0 or (n_local is not None and local >= n_local):
        raise RuntimeError(f"LOCAL_RANK={local} is outside this node's "
                           f"LOCAL_WORLD_SIZE={n_local}")
    return torch.device("cuda", local)


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None, *,
                           backend: Optional[str] = None,
                           device="cuda",
                           timeout: Optional[float] = None) -> torch.device:
    """Start this rank's process group; a no-op for one process.

    init_method / world_size / rank default to torchrun's `env://`,
    WORLD_SIZE and RANK. With neither an init_method nor a world of more
    than one, nothing starts (a single process). device: "cuda" (the
    rank's card from `local_card`) or "cpu"; backend: "nccl" on a card
    and "gloo" on the CPU unless named; timeout: seconds the rendezvous
    and each collective may wait (the backend's default when None).
    Raises where a variable the start needs is missing or the rendezvous
    fails. Returns the rank's device."""
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    dev = local_card(device, world_size)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is present; pass device='cpu' "
                               "to run the ranks on the CPU")
        torch.cuda.set_device(dev.index)
    if init_method is None:
        if world_size in (None, 1):
            return dev                  # a single process
        init_method = "env://"
    if init_method == "env://" and rank is None:
        # torch names a missing MASTER_ADDR / MASTER_PORT itself
        raise RuntimeError("the env:// rendezvous needs RANK: launch with "
                           "torchrun")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs device='cuda'")
    kw = ({} if timeout is None
          else dict(timeout=datetime.timedelta(seconds=timeout)))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    return dev


def global_mesh(tp: Optional[int] = None, dp: int = 1) -> Mesh:
    """A ("dp", "tp") mesh over every rank of the world, row-major: under
    torchrun's node-by-node numbering, tp = cards a node and dp = nodes
    puts each tp group on one node (the reference's "tp = chips per host,
    dp = number of hosts")."""
    return make_mesh(tp=tp, dp=dp)


def is_primary() -> bool:
    return world()[0] == 0
