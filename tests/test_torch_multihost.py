"""The reference's multi-host legs (`tests/test_multihost.py`,
`experiments/multihost_dryrun.py`) on the port, over a launch of two
"nodes" of two ranks each started as torchrun starts them: RANK,
WORLD_SIZE = 4, LOCAL_RANK, LOCAL_WORLD_SIZE = 2, GROUP_RANK,
MASTER_ADDR = 127.0.0.1 and a free MASTER_PORT, every rank calling
`initialize_distributed()` with no arguments (`env://`, gloo on the CPU;
`torch_parallel_cases.Ranks(..., nodes=2)`, one group for the module).

Legs, each held to its single-process counterpart computed on the ranks:
  gspmd     -- `tp.sharded_forward` on `global_mesh(tp=2, dp=2)` (dp over
               the nodes), a prefill and a TEAL decode step: 2e-5 (fp32);
  kernel-tp -- `tp_kernel.tp_kernel_decode` at tp 4 across both nodes
               (the kernels' plain versions on the CPU) against the
               single-process token path: 2e-4 in logits, 1e-4 in the
               cache (tests/test_tp_kernel.py's tolerances);
  pp        -- `pp.pp_forward` on `make_pp_mesh(pp=2, tp=2)`, a stage a
               node: 2e-5 (fp32);
  serving   -- the server at tp 4 across both nodes with chunked
               admission (`prefill_chunk=8`), the reference leg's
               submissions: the single-process port server's tokens and
               the JAX engine's (run in a child process), token for token.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from jax_subprocess import jax_results

from teal_tpu_torch.parallel import distributed
from torch_parallel_cases import Ranks, error_of, free_port, np_params

WORLD, NODES = 4, 2
GSPMD = dict(cfg=dict(n_layers=2, n_heads=8, n_kv_heads=8, dim=256,
                      intermediate_size=512, vocab_size=512),
             seed=0, tp=2, dp=2, tokens=[[0, 1, 2, 3]] * 2,
             next_tokens=[[5], [9]], sp=dict(enabled=True), th=0.02)
KERNEL_TP = dict(cfg=dict(n_layers=2, n_heads=4, n_kv_heads=4, dim=512,
                          intermediate_size=1024, vocab_size=128),
                 seed=7, tp=4, th=0.02, prompt=[[3, 17, 42, 9]],
                 steps=[(None, 4), (None, 5)],
                 sp=dict(enabled=True, kernel="block", block_size=128,
                         block_keep_frac=1.0, block_thresholding=True))
PP = dict(cfg=dict(n_layers=2, n_heads=4, n_kv_heads=4, dim=256,
                   intermediate_size=512, vocab_size=128),
          seed=3, pp=2, tp=2, n_micro=2, tokens=[[1, 2, 3, 4]] * 2)
SERVING = dict(cfg=dict(n_layers=2, n_heads=8, n_kv_heads=8, dim=1024,
                        intermediate_size=1024, vocab_size=128),
               seed=6, tp=4, slots=2, max_seq=32, prefill_chunk=8,
               submissions=[[[1, 2, 3], 4], [list(range(1, 13)), 3]])
CASES = {"env": ("mh_env", dict(tp=2, dp=2)), "gspmd": ("mh_gspmd", GSPMD),
         "kernel-tp": ("mh_kernel_tp", KERNEL_TP), "pp": ("mh_pp", PP),
         "serving": ("mh_serving", SERVING)}
FP32 = dict(rtol=2e-5, atol=2e-5)


def jax_serving(cfg, seed, tp, slots, max_seq, prefill_chunk, submissions):
    """The JAX engine on a tp mesh of `tp` CPU devices, chunked admission
    (the reference leg's engine; run by `jax_results` in the
    subprocess): {out<id>: tokens}."""
    import jax
    import jax.numpy as jnp

    from teal_tpu.config import get_model_config
    from teal_tpu.engine.serving import ContinuousBatchingEngine
    from teal_tpu.parallel import make_mesh
    from teal_tpu.parallel import tp as jtp

    c = get_model_config("tiny", **cfg)
    params = jax.tree.map(jnp.asarray, np_params(cfg, seed))
    mesh = make_mesh(tp=tp, dp=1, devices=jax.devices()[:tp])
    eng = ContinuousBatchingEngine(
        c, jtp.shard_params(params, mesh, c), slots=slots, max_seq=max_seq,
        temperature=0.0, cache_dtype=jnp.float32, prefill_chunk=prefill_chunk)
    eng.cache = jtp.shard_cache(eng.cache, mesh)
    for prompt, n in submissions:
        eng.submit(prompt, n)
    return {f"out{r.id}": np.array(r.out) for r in eng.run(max_steps=64)}


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost")
    ranks = Ranks(WORLD, CASES, d / "ranks", nodes=NODES)
    try:
        jax_out = jax_results(__file__, "jax_serving", {"serving": SERVING},
                              d)
    finally:
        port = ranks.join()
    for case, per in port.items():
        for r in range(WORLD):
            assert not error_of(per[r]), (case, r, error_of(per[r]))
    return jax_out, port


def test_ranks_start_through_env_as_torchrun_on_two_nodes(legs):
    """Every rank started through `env://` with torchrun's variables; the
    second node's ranks (RANK 2, 3) take their card from LOCAL_RANK (0,
    1), not from RANK; `global_mesh(tp=2, dp=2)` puts each tp group on
    one node and each dp group across the nodes, and a sum over each
    crosses the right ranks."""
    _, port = legs
    ports = set()
    for r in range(WORLD):
        res = port["env"][r]
        env = {k.split("/", 1)[1]: str(v) for k, v in res.items()
               if k.startswith("env/")}
        assert env["RANK"] == str(r) and env["WORLD_SIZE"] == str(WORLD)
        assert env["LOCAL_RANK"] == str(r % 2)
        assert env["LOCAL_WORLD_SIZE"] == "2"
        assert env["GROUP_RANK"] == str(r // 2)
        assert env["MASTER_ADDR"] == "127.0.0.1"
        ports.add(env["MASTER_PORT"])
        assert str(res["init_method"]) == "env://"
        assert int(res["card"]) == r % 2
        assert res["rank"].tolist() == [r, WORLD]
        assert str(res["backend"]) == "gloo"
        assert res["mesh"].tolist() == [[0, 1], [2, 3]]
        node, local = divmod(r, 2)
        assert res["tp/ranks"].tolist() == [2 * node, 2 * node + 1, local]
        assert res["dp/ranks"].tolist() == [local, local + 2, node]
        assert res["tp/sum"].tolist() == [4 * node + 1]
        assert res["dp/sum"].tolist() == [2 * local + 2]
    assert len(ports) == 1


def test_two_process_decode_step(legs):
    """gspmd: the sharded forward on dp 2 (the nodes) x tp 2, a prompt and
    a TEAL decode step, equals the single-process forward within 2e-5
    (fp32) on every rank, and every rank holds the same logits."""
    _, port = legs
    for r in range(WORLD):
        res = port["gspmd"][r]
        for name in ("logits", "logits2"):
            assert np.isfinite(res[name]).all()
            np.testing.assert_allclose(res[name], res["single_" + name],
                                       **FP32, err_msg=name)
            np.testing.assert_array_equal(res[name],
                                          port["gspmd"][0][name])
    assert port["gspmd"][0]["logits"].shape == (2, 4, 512)


def test_two_process_kernel_tp_decode(legs):
    """kernel-tp: `tp_prefill` then two greedy `tp_kernel_decode` steps at
    tp 4 across both nodes equal the single-process token path run on the
    same tokens (logits within 2e-4, caches within 1e-4), the same bits
    on every rank."""
    _, port = legs
    for r in range(WORLD):
        res = port["kernel-tp"][r]
        assert res["single_token_path"].all()
        np.testing.assert_allclose(res["prefill"], res["single_prefill"],
                                   **FP32)
        for j in range(len(KERNEL_TP["steps"])):
            np.testing.assert_allclose(res[f"logits{j}"],
                                       res[f"single_logits{j}"], rtol=2e-4,
                                       atol=2e-4)
            np.testing.assert_array_equal(res[f"logits{j}"],
                                          port["kernel-tp"][0][f"logits{j}"])
        for name in ("k", "v"):
            np.testing.assert_allclose(res[name], res["single_" + name],
                                       rtol=1e-4, atol=1e-4)


def test_two_process_pipeline_parallel(legs):
    """pp: `pp_forward` with a stage a node (pp 2 x tp 2, two
    microbatches) equals the single-process forward within 2e-5 (fp32) in
    logits and the whole cache, on every rank."""
    _, port = legs
    for r in range(WORLD):
        res = port["pp"][r]
        for name in ("logits", "k", "v"):
            np.testing.assert_allclose(res[name], res["single_" + name],
                                       **FP32, err_msg=name)


def test_two_process_serving_engine(legs):
    """serving: the server at tp 4 across both nodes with chunked
    admission gives the single-process port server's tokens and the JAX
    engine's on a 4-device tp mesh, on every rank."""
    jax_out, port = legs
    want = {k: v.tolist() for k, v in jax_out["serving"].items()}
    assert [len(want[f"out{i}"]) for i in range(2)] == [4, 3]
    single = port["serving"][0]
    assert {k[len("single_"):]: v.tolist() for k, v in single.items()
            if k.startswith("single_out")} == want
    for r in range(WORLD):
        got = {k: v.tolist() for k, v in port["serving"][r].items()
               if k.startswith("out")}
        assert got == want, r
        assert port["serving"][r]["cache_shape"][2] == 8 // 4


@pytest.mark.parametrize("missing", ["RANK", "MASTER_ADDR", "MASTER_PORT"])
def test_env_launch_refuses_a_missing_variable(monkeypatch, missing):
    """In a group of more than one rank, env:// needs RANK, MASTER_ADDR and
    MASTER_PORT: without one, `initialize_distributed()` raises, naming
    it, before any rendezvous (RANK: the port's RuntimeError; the others:
    torch's ValueError)."""
    env = dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1",
               LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT="1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv(missing)
    with pytest.raises((RuntimeError, ValueError), match=missing):
        distributed.initialize_distributed(device="cpu")


def test_local_card_comes_from_local_rank(monkeypatch):
    """The card is cuda:LOCAL_RANK, never cuda:RANK; in a group LOCAL_RANK
    must be set and lie within LOCAL_WORLD_SIZE; a named index wins; a
    single process takes cuda:0."""
    import torch

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.local_card() == torch.device("cuda", 0)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    with pytest.raises(RuntimeError, match="LOCAL_RANK is not set"):
        distributed.local_card()
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert distributed.local_card() == torch.device("cuda", 1)
    assert distributed.local_card("cuda:0") == torch.device("cuda", 0)
    assert distributed.local_card("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="LOCAL_WORLD_SIZE"):
        distributed.local_card()


def test_failed_rendezvous_raises():
    """A rank whose rendezvous host never answers raises after its timeout
    (no fallback to a single process): rank 1 of 2 against a port nothing
    listens on, with a 2 s timeout, in a child process."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, RANK="1", WORLD_SIZE="2", LOCAL_RANK="1",
               LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    code = ("from teal_tpu_torch.parallel import distributed\n"
            "distributed.initialize_distributed(device='cpu', timeout=2)\n"
            "print('STARTED')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "STARTED" not in proc.stdout
    assert "Error" in proc.stderr, proc.stderr[-2000:]
