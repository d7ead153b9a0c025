"""The port's tensor-parallel shardings and sharded forward
(`teal_tpu_torch/parallel/tp.py`) against the JAX package's GSPMD TP
(`teal_tpu/parallel/tp.py`, `llama.forward` under `jax.set_mesh`) at the
same degree, on the same numpy weights, with real gloo ranks.

The port's cases run once for the module in a group of four rank
processes (`torch_parallel_cases.Ranks`) while the JAX references run
here on the 8-device CPU mesh of conftest.py (no Pallas kernel is on this
path). Tolerances are the reference tests' between a sharded and a
single-device forward, held here between the port's sharded forward and
its own single-device forward: 1e-4 fp32 (tests/test_tp.py,
test_moe.py), 2e-3 for int8 weights (test_tp_kernel.py) and 2e-2 for
int8 experts (test_moe_int8.py). Against the JAX package the fp32 cases
hold to 1e-4 too; the int8 ones, whose activations are bf16, to the
reference's int8 TP tolerance, 2e-2 (test_tp_kernel.py): the two
frameworks round bf16 at the same points in other summation orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from teal_tpu.config import SparsityConfig as JSparsityConfig
from teal_tpu.config import get_model_config as jget_model_config
from teal_tpu.models import llama as jllama
from teal_tpu.ops import quant as jquant
from teal_tpu.parallel import make_mesh as jmake_mesh
from teal_tpu.parallel import tp as jtp
from teal_tpu_torch.config import SparsityConfig
from teal_tpu_torch.models import llama
from teal_tpu_torch.parallel import tp as tpm
from torch_parallel_cases import (Ranks, error_of, model_config, np_params,
                                  port_params)

WORLD = 4
TINY = {}                                        # heads 4, kv 2, dim 64
TINY4 = dict(n_kv_heads=4)                       # tp 4 divides the kv heads
HD128 = dict(n_layers=2, n_heads=2, n_kv_heads=2, dim=256,
             intermediate_size=384, vocab_size=128)
MOE = dict(n_experts=4, n_experts_per_tok=2)
MOE128 = dict(HD128, n_experts=4, n_experts_per_tok=2)
TEAL = dict(enabled=True, apply_prefill=True, prefill_fraction=1.0)
GROUP = dict(enabled=True, mode="group", block_size=16, block_keep_frac=0.5,
             apply_prefill=True, prefill_fraction=1.0)
PROMPT = [[5, 3, 8, 1]]

# case: (tp_forward kwargs, tolerance against the JAX package, tolerance
# against the port's single-device forward)
FORWARD = {
    "dense-tp2": (dict(cfg=TINY, seed=0, tp=2, dp=1, tokens=PROMPT,
                       next_tokens=[[7]]), 1e-4, 1e-4),
    "teal-tp2": (dict(cfg=TINY, seed=0, tp=2, dp=1, tokens=PROMPT,
                      next_tokens=[[7]], sp=TEAL, th=0.05), 1e-4, 1e-4),
    "dense-dp2-tp2": (dict(cfg=TINY, seed=0, tp=2, dp=2,
                           tokens=[[5, 3, 8, 1], [2, 9, 4, 7]],
                           next_tokens=[[7], [2]]), 1e-4, 1e-4),
    "dense-tp4": (dict(cfg=TINY4, seed=1, tp=4, dp=1, tokens=PROMPT,
                       next_tokens=[[7]]), 1e-4, 1e-4),
    "group-tp2": (dict(cfg=TINY, seed=2, tp=2, dp=1, tokens=PROMPT,
                       next_tokens=[[7]], sp=GROUP), 1e-4, 1e-4),
    "int8-tp2": (dict(cfg=HD128, seed=3, tp=2, dp=1, tokens=[[3, 9, 27]],
                      max_seq=16, quant="int8"), 2e-2, 2e-3),
    "moe-tp2": (dict(cfg=MOE, seed=4, tp=2, dp=1, tokens=PROMPT,
                     next_tokens=[[7]]), 1e-4, 1e-4),
    "moe-int8-tp2": (dict(cfg=MOE128, seed=5, tp=2, dp=1, tokens=PROMPT,
                          quant="int8"), 2e-2, 2e-2),
}
REFUSED = {
    "indivisible-tp4": dict(cfg=TINY, seed=0, tp=4, what="indivisible"),
    "kernel-tp2": dict(cfg=TINY, seed=0, tp=2, what="kernel"),
    "moe-group-tp2": dict(cfg=MOE, seed=0, tp=2, what="moe-group"),
}


def _jparams(cfg, seed, quant=None):
    params = jax.tree.map(jnp.asarray, np_params(cfg, seed))
    if quant == "int8":
        return jquant.quantize_params_int8(params)
    return params


def _jax_forward(cfg, seed, tp, dp, tokens, max_seq=8, sp=None, th=None,
                 quant=None, next_tokens=None):
    jcfg = jget_model_config("tiny", **cfg)
    params = _jparams(cfg, seed, quant)
    mesh = jmake_mesh(tp=tp, dp=dp, devices=jax.devices()[:tp * dp])
    sharded = jtp.shard_params(params, mesh, jcfg)
    toks = jnp.asarray(tokens, jnp.int32)
    dtype = jnp.bfloat16 if quant else jnp.float32
    cache = jtp.shard_cache(jllama.KVCache.init(jcfg, toks.shape[0], max_seq,
                                                dtype), mesh)
    jsp = JSparsityConfig(**(sp or {}))
    th = (jllama.zero_thresholds(jcfg) if th is None
          else jnp.full((jcfg.n_layers, 7), th, jnp.float32))
    out = {}
    with jax.set_mesh(mesh):
        logits, cache = jax.jit(lambda p, c: jllama.forward(
            p, toks, c, 0, th, cfg=jcfg, sp=jsp))(sharded, cache)
        out["logits"] = np.asarray(logits)
        if next_tokens is not None:
            nt = jnp.asarray(next_tokens, jnp.int32)
            logits, cache = jax.jit(lambda p, c: jllama.forward(
                p, nt, c, toks.shape[1], th, cfg=jcfg, sp=jsp))(sharded,
                                                                 cache)
            out["logits2"] = np.asarray(logits)
    out["k"], out["v"] = (np.asarray(t, np.float32) for t in cache)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cases = {n: ("tp_forward", kw) for n, (kw, _, _) in FORWARD.items()}
    cases.update({n: ("tp_refuses", kw) for n, kw in REFUSED.items()})
    ranks = Ranks(WORLD, cases, tmp_path_factory.mktemp("tp_ranks"))
    try:
        jax_out = {n: _jax_forward(**kw) for n, (kw, _, _) in FORWARD.items()}
    finally:
        port = ranks.join()
    return jax_out, port


@pytest.mark.parametrize("case", list(FORWARD))
def test_sharded_forward_matches_jax(case, results):
    """Logits (prompt, then one decode token where the case has one) and
    the full cache, gathered from the ranks' blocks, equal the JAX
    package's GSPMD forward at the same degree, and the logits the port's
    single-device forward; every rank of the mesh holds the same logits
    bit for bit."""
    jax_out, port = results
    kw, tol, tol_single = FORWARD[case]
    n = kw["tp"] * kw["dp"]
    for r in range(n):
        assert not error_of(port[case][r]), error_of(port[case][r])
    got = port[case][0]
    for name in ("logits", "logits2", "k", "v"):
        if name in jax_out[case]:
            np.testing.assert_allclose(got[name], jax_out[case][name],
                                       rtol=tol, atol=tol, err_msg=name)
    for name in ("logits", "logits2"):
        if name in got:
            np.testing.assert_allclose(got[name], got["single_" + name],
                                       rtol=tol_single, atol=tol_single,
                                       err_msg="single-device " + name)
            for r in range(1, n):
                np.testing.assert_array_equal(port[case][r][name], got[name])


def test_shard_params_raises_like_jax(results):
    """tp 4 on 2 kv heads: both packages raise ValueError "not
    divisible"."""
    _, port = results
    params = _jparams(TINY, 0)
    mesh = jmake_mesh(tp=4, dp=1, devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="not divisible"):
        jtp.shard_params(params, mesh, jget_model_config("tiny"))
    for r in range(WORLD):
        err = error_of(port["indivisible-tp4"][r])
        assert err.startswith("ValueError") and "not divisible" in err, err


def test_sharded_forward_refuses_single_token_kernels(results):
    """A single-token block-kernel step on a tp shard would select over
    the rank's channels: the sharded forward refuses it and names
    tp_kernel_decode (the reference gives it single-device semantics)."""
    _, port = results
    for r in range(2):
        err = error_of(port["kernel-tp2"][r])
        assert err.startswith("ValueError") and "tp_kernel_decode" in err, err


def test_sharded_forward_refuses_moe_group_rule(results):
    """A Mixtral expert's intermediate is split over the ranks, so its
    group rule (a cap over the whole intermediate) is not shard-local:
    the sharded forward refuses it."""
    _, port = results
    for r in range(2):
        err = error_of(port["moe-group-tp2"][r])
        assert err.startswith("ValueError") and "Mixtral" in err, err


def _specs_tuples(tree):
    if isinstance(tree, dict):
        return {k: _specs_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("kind", ["dense", "int8", "int4", "int4-unpacked",
                                  "moe"])
def test_param_specs_match_jax(kind):
    """`param_specs` (with and without params) names the same split dims
    as the reference's PartitionSpecs, leaf for leaf."""
    cfg = dict(HD128, **(MOE if kind == "moe" else {}))
    c, jcfg = model_config(cfg), jget_model_config("tiny", **cfg)
    quant = {"dense": None, "moe": None}.get(kind, kind)
    params = port_params(cfg, 0, quant)
    jparams = jax.tree.map(jnp.asarray, np_params(cfg, 0))
    if kind == "int8":
        jparams = jquant.quantize_params_int8(jparams)
    elif kind == "int4":
        jparams = dict(jparams, layers=jquant.pack_int4_params(
            jquant.quantize_params_int4(dict(jparams), group=128),
            block_size=128)["layers"])
    elif kind == "int4-unpacked":
        jparams = jquant.quantize_params_int4(dict(jparams), group=128)
    assert tpm.param_specs(c) == _specs_tuples(jtp.param_specs(jcfg))
    assert tpm.param_specs(c, params) == _specs_tuples(
        jtp.param_specs(jcfg, jparams))


def test_shard_params_gives_contiguous_blocks():
    """Single-process mesh of one rank: nothing is split, the tree comes
    back as it was; the spec slicing cuts contiguous copies that own
    their storage."""
    from teal_tpu_torch.parallel import make_mesh
    from teal_tpu_torch.parallel.mesh import Mesh

    cfg = HD128
    c = model_config(cfg)
    params = port_params(cfg, 0)
    mesh = make_mesh()
    assert mesh.shape == {"dp": 1, "tp": 1}
    same = tpm.shard_params(params, mesh, c)
    assert same["layers"]["wq"] is params["layers"]["wq"]

    class Two(Mesh):                 # coordinates of rank 1 of tp 2
        def __init__(self):
            self.shape, self.coords = {"tp": 2}, {"tp": 1}
            self.axis_names = ("tp",)
    w = params["layers"]["wo"]
    blk = tpm.shard_tensor(w, (None, "tp", None), Two())
    assert blk.is_contiguous() and blk.untyped_storage().nbytes() == \
        blk.numel() * blk.element_size()
    torch.testing.assert_close(blk, w[:, w.shape[1] // 2:], rtol=0, atol=0)


def test_can_fused_decode_false_when_sharded():
    """The reference's single-device condition: K2 on the layer loop only
    on a forward that is not sharded, even where it is forced."""
    c = model_config(HD128)
    for fused in (None, True):
        sp = SparsityConfig(enabled=True, kernel="block", block_size=128,
                            fused_decode_attention=fused)
        assert llama.can_fused_decode(1, 1, c, 16, sp, True)
        assert not llama.can_fused_decode(1, 1, c, 16, sp, True, tp_size=2)
