"""The port's process-group start-up, rank meshes and collectives
(`teal_tpu_torch/parallel/distributed.py`, `mesh.py`), with a group of
four real gloo ranks (`torch_parallel_cases.Ranks`, each started by
`initialize_distributed` from torchrun's RANK / WORLD_SIZE): the meshes
lay ranks out as the JAX package's meshes lay devices out
(`teal_tpu/parallel/mesh.py`, `tp_kernel.make_tp_mesh`,
`sp.make_sp_mesh`, `pp.make_pp_mesh`, on conftest.py's 8 CPU devices),
each axis group holds the ranks that differ only on its axis, and a sum
over a group adds the parts in rank order on every rank."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from teal_tpu.parallel import make_mesh as jmake_mesh
from teal_tpu.parallel.pp import make_pp_mesh as jmake_pp_mesh
from teal_tpu.parallel.sp import make_sp_mesh as jmake_sp_mesh
from teal_tpu.parallel.tp_kernel import make_tp_mesh as jmake_tp_mesh
from teal_tpu_torch.parallel import distributed, make_mesh
from torch_parallel_cases import Ranks, error_of

WORLD = 4


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    ranks = Ranks(WORLD, {"probe": ("dist_probe", {})},
                  tmp_path_factory.mktemp("dist_ranks"))
    out = ranks.join()["probe"]
    for r in range(WORLD):
        assert not error_of(out[r]), error_of(out[r])
    return out


def test_initialize_distributed_reads_torchrun_variables(probe):
    """Each rank's group rank is its RANK, the world WORLD_SIZE, the
    backend gloo on the CPU; rank 0 alone is primary."""
    for r in range(WORLD):
        np.testing.assert_array_equal(probe[r]["rank"], [r, r])
        assert int(probe[r]["world"]) == WORLD
        assert str(probe[r]["backend"]) == "gloo"
        assert bool(probe[r]["primary"]) == (r == 0)


def _ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices)


def _jax_meshes():
    d4 = jax.devices()[:4]
    return {"dp2-tp2": jmake_mesh(tp=2, dp=2, devices=d4),
            "global": jmake_mesh(tp=2, dp=2, devices=d4),
            "tpk-dp2-tp2": jmake_tp_mesh(2, devices=d4, dp=2),
            "sp2-tp2": jmake_sp_mesh(2, devices=d4, tp=2),
            "pp2-dp2": jmake_pp_mesh(2, devices=d4, dp=2),
            "pp4": jmake_pp_mesh(4, devices=d4),
            "tp2-of-4": jmake_tp_mesh(2, devices=d4)}


@pytest.mark.parametrize("name", list(_jax_meshes()))
def test_mesh_layout_matches_jax(name, probe):
    """Axis names and the row-major layout of ranks equal the reference
    mesh's over the same count of devices; each rank's group along an axis
    holds the ranks that share its other coordinates, in axis order, and
    its index there."""
    jm = _jax_meshes()[name]
    want = _ids(jm)
    for r in range(WORLD):
        got = probe[r]
        assert str(got[f"{name}/names"]).split(",") == list(jm.axis_names)
        np.testing.assert_array_equal(got[f"{name}/ranks"], want)
        if r not in want:
            continue
        coord = [int(c) for c in np.argwhere(want == r)[0]]
        for a, axis in enumerate(jm.axis_names):
            idx = list(coord)
            idx[a] = slice(None)
            line = want[tuple(idx)].tolist()
            np.testing.assert_array_equal(got[f"{name}/{axis}"],
                                          line + [coord[a]])


def test_collectives_in_rank_order(probe):
    """On a tp group of four: all_gather concatenates in rank order, a sum
    adds the parts in rank order (fp32 1e8 + 1 - 1e8 + 1 = 1, bf16 256 + 1
    - 256 + 1 = 1; another order gives 0 or 2) on every rank, broadcast
    takes the source's tensor, and point-to-point sends chain 0 -> 3."""
    for r in range(WORLD):
        np.testing.assert_array_equal(probe[r]["gather"], [[0, 1, 2, 3]])
        np.testing.assert_array_equal(probe[r]["sum"], [1.0])
        np.testing.assert_array_equal(probe[r]["sum_bf16"], [1.0])
        np.testing.assert_array_equal(probe[r]["bcast"], [2.0, 2.0])
        np.testing.assert_array_equal(probe[r]["chain"],
                                      [sum(range(r + 1))] * 3)


def test_mesh_errors(probe):
    """dp * tp must equal the ranks (make_mesh), and a mesh larger than the
    world raises, as the reference's meshes raise over devices."""
    with pytest.raises(ValueError):
        jmake_mesh(tp=3, dp=1, devices=jax.devices()[:4])
    with pytest.raises(ValueError):
        jmake_tp_mesh(8, devices=jax.devices()[:4])
    for r in range(WORLD):
        assert str(probe[r]["err/mesh-3x1"]).startswith("ValueError")
        assert str(probe[r]["err/tp8"]).startswith("ValueError")


def test_initialize_distributed_single_process(monkeypatch):
    """Without a world of more than one and without an init_method,
    nothing starts: the rank's device comes back and the mesh is one
    rank with no process group, whose collectives return their input."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_distributed(device="cpu") == \
        torch.device("cpu")
    assert not dist.is_initialized()
    assert distributed.is_primary()
    mesh = make_mesh()
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.coords == {"dp": 0,
                                                                "tp": 0}
    g = mesh.group("tp")
    x = torch.arange(3.0)
    assert g.group is None and g.size == 1
    assert g.reduce_sum(x) is x and g.all_gather(x, 0) is x


def test_initialize_distributed_refuses_what_it_cannot_start(monkeypatch):
    """No fallback: a card asked for where there is none raises, and NCCL
    on the CPU raises before any rendezvous."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize_distributed(device="cuda")
    with pytest.raises(ValueError, match="nccl"):
        distributed.initialize_distributed(init_method="file:///nonexistent",
                                           world_size=2, rank=0,
                                           backend="nccl", device="cpu")
    assert not dist.is_initialized()
