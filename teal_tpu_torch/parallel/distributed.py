"""Process-group start-up and the world mesh.

Port of `teal_tpu/parallel/distributed.py`. The reference starts one
process a host with `jax.distributed.initialize()` (the JAX_* variables
override the auto-detected values) and builds one mesh over every chip.
The port starts one process a rank, as `torchrun` launches them, and
reads torchrun's variables the same way: RANK, WORLD_SIZE, LOCAL_RANK,
and MASTER_ADDR / MASTER_PORT through the `env://` rendezvous.

    torchrun --nproc-per-node 2 script.py   # script: initialize_distributed()

Each rank runs on its own card, set from LOCAL_RANK before the process
group starts; the backend is NCCL on a card and gloo on the CPU, or
gloo where the caller names it (several ranks sharing one card, whose
NCCL refuses two ranks on one device). Nothing falls back: a failed
start raises.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from teal_tpu_torch.parallel.mesh import Mesh, make_mesh, world


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None, *,
                           backend: Optional[str] = None,
                           device="cuda") -> torch.device:
    """Start this rank's process group; a no-op for one process.

    init_method / world_size / rank default to torchrun's `env://`,
    WORLD_SIZE and RANK. With neither an init_method nor a world of more
    than one, nothing starts (a single process). device: "cuda" (the
    rank's card is cuda:LOCAL_RANK, or the index given, e.g. "cuda:0"
    for ranks sharing one card) or "cpu"; backend: "nccl" on a card and
    "gloo" on the CPU unless named. Returns the rank's device."""
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is present; pass device='cpu' "
                               "to run the ranks on the CPU")
        local = _env_int("LOCAL_RANK")
        index = dev.index if dev.index is not None else (local or 0)
        torch.cuda.set_device(index)
        dev = torch.device("cuda", index)
    if init_method is None:
        if world_size in (None, 1):
            return dev                  # a single process
        init_method = "env://"
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs device='cuda'")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dev


def global_mesh(tp: Optional[int] = None, dp: int = 1) -> Mesh:
    """A ("dp", "tp") mesh over every rank of the world: for a 70B-class
    deployment tp = cards a host, dp = hosts."""
    return make_mesh(tp=tp, dp=dp)


def is_primary() -> bool:
    return world()[0] == 0
