"""The port's TP decode through the kernels
(`teal_tpu_torch/parallel/tp_kernel.py`: `tp_prefill`,
`tp_kernel_decode`) against the JAX package's `teal_tpu/parallel/tp_kernel.py`
at the same degree, on the same numpy weights and caches.

The port's cases run once for the module in a group of four gloo rank
processes (`torch_parallel_cases.Ranks`; the kernels' plain versions on
the CPU). The JAX references run meanwhile in one child process
(`jax_subprocess.jax_results`): `tp_kernel_decode` on the 8-device CPU
mesh in interpret mode, with `jax.device_get` between steps (the
caveat of `teal_tpu/parallel/tp_kernel.py`). Tolerances are
tests/test_tp_kernel.py's: 2e-4 logits (3e-4 batched, MoE and greedy
fractions), 2e-2 for int8 and int4 weights (bf16 activations); caches
1e-4 / 1e-5. Every rank of a mesh holds the same logits bit for bit, and
the same residual stream after every reduction.

The config has head_dim 128 (K2) and widths at which the rowwise shards
change their group size as the 7B's do: intermediate 768 is 3 groups of
128 a shard at tp 2 and 3 groups of 64 at tp 4 (7B: 5504 at G 128,
2752 at G 64).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax_subprocess import jax_results

from torch_parallel_cases import Ranks, error_of, np_cache, np_params

WORLD = 4
KCFG = dict(n_layers=2, n_heads=4, n_kv_heads=2, dim=512,
            intermediate_size=768, vocab_size=128)
KCFG4 = dict(KCFG, n_kv_heads=4)
SCFG = dict(KCFG, n_heads=2, n_kv_heads=2, dim=256)
MOE = dict(n_layers=2, n_heads=4, n_kv_heads=2, dim=512,
           intermediate_size=512, vocab_size=128, n_experts=4,
           n_experts_per_tok=2)
SP = dict(enabled=True, kernel="block", block_size=128, block_keep_frac=1.0,
          block_thresholding=True, token_fused=False, fused_attn_block=False,
          packed_pipeline=False)
FRACS = dict(SP, block_keep_fracs=(1.0, 0.9, 0.9, 1.0, 1.0, 0.9, 1.0))

# case: (kwargs of tpk_run and of the JAX twin, logits tol, cache tol)
DECODE = {
    "tp2": (dict(cfg=KCFG, seed=7, tp=2, sp=SP, cache_seed=1,
                 steps=[([[8]], 5)]), 2e-4, 1e-4),
    "tp4": (dict(cfg=KCFG4, seed=8, tp=4, sp=SP, cache_seed=2,
                 steps=[([[8]], 5)]), 2e-4, 1e-4),
    "prefill-decode-tp2": (dict(cfg=KCFG, seed=9, tp=2, sp=SP,
                                prompt=[[3, 17, 42, 9]],
                                steps=[(None, 4), (None, 5)]), 2e-4, 1e-4),
    "cap-tp2": (dict(cfg=KCFG, seed=10, tp=2, sp=dict(SP, block_keep_frac=0.5),
                     cache_seed=3, steps=[([[7]], 3)]), 2e-4, 1e-4),
    "int8-tp2": (dict(cfg=SCFG, seed=11, tp=2, sp=SP, quant="int8",
                      steps=[([[7]], 3)]), 2e-2, 2e-2),
    "int4-tp2": (dict(cfg=SCFG, seed=12, tp=2, sp=SP, quant="int4",
                      steps=[([[7]], 3)]), 2e-2, 2e-2),
    "batched-tp2": (dict(cfg=SCFG, seed=13, tp=2, sp=SP, batch=3,
                         cache_seed=4, steps=[([[3], [7], [11]],
                                               [2, 9, 14])]), 3e-4, 1e-5),
    "dp2-tp2": (dict(cfg=SCFG, seed=14, tp=2, dp=2, sp=SP, batch=4,
                     cache_seed=5, steps=[([[3], [7], [11], [2]],
                                           [2, 9, 14, 5])]), 3e-4, 1e-5),
    "fracs-tp2": (dict(cfg=SCFG, seed=15, tp=2, sp=FRACS, cache_seed=6,
                       steps=[([[7]], 3)]), 3e-4, 1e-5),
    "moe-tp2": (dict(cfg=MOE, seed=19, tp=2, sp=SP, cache_seed=7,
                     steps=[([[7]], 3)]), 3e-4, 1e-5),
}
# packed int4 with sparsity off decodes every group through K3 at keep
# 1.0, at the gather group of its block size: at the default 32 that is
# 64 against a quant group of 128, which the port refuses (the
# reference's interpret-mode run reads past the last group there)
DECODE["int4-dense-tp2"] = (dict(DECODE["int4-tp2"][0],
                                 sp=dict(block_size=128)), 2e-2, 2e-2)
INT4_G64 = dict(DECODE["int4-tp2"][0], sp={})
# case: (kwargs, the port's exception, the reference's)
ERRORS = {
    "unpacked-int4": (dict(cfg=SCFG, seed=12, tp=2, sp=SP,
                           quant="int4-unpacked", steps=[([[7]], 3)]),
                      "NotImplementedError", "NotImplementedError"),
    "topk": (dict(cfg=KCFG, seed=7, tp=2,
                  sp=dict(enabled=True, kernel="block", block_size=128,
                          block_keep_frac=0.75), steps=[([[7]], 3)]),
             "NotImplementedError", "NotImplementedError"),
    "dense-bf16": (dict(cfg=KCFG, seed=7, tp=2, sp={}, steps=[([[7]], 3)]),
                   "ValueError", "ValueError"),
    "rows-9": (dict(cfg=KCFG, seed=7, tp=2, sp=SP, batch=9,
                    steps=[([[1]] * 9, 3)]), "ValueError", "AssertionError"),
    "moe-batch-2": (dict(cfg=MOE, seed=7, tp=2, sp=SP, batch=2,
                         steps=[([[1], [2]], 3)]),
                    "ValueError", "AssertionError"),
    "int4-tp4": (dict(cfg=KCFG4, seed=7, tp=4, sp=SP, quant="int4",
                      steps=[([[7]], 3)]), "ValueError", "ValueError"),
}
STREAMS = dict(cfg=KCFG4, seed=16, tp=4, sp=dict(SP, block_keep_frac=0.5),
               th=0.5, pos=3, tok=7)


@functools.lru_cache(maxsize=None)
def _jax_params(cfg_json, seed, quant):
    """The JAX package's params of a case, quantized by it (cases that
    share weights share the quantization, which is slow in the JAX
    package)."""
    from teal_tpu.ops import quant as q

    cfg = json.loads(cfg_json)
    if quant == "int4":
        return dict(_jax_params(cfg_json, seed, None),
                    layers=q.pack_int4_params(
                        _jax_params(cfg_json, seed, "int4-unpacked"),
                        block_size=128)["layers"])
    params = jax.tree.map(jnp.asarray, np_params(cfg, seed))
    if quant == "int8":
        return q.quantize_params_int8(params)
    if quant == "int4-unpacked":
        return q.quantize_params_int4(dict(params), group=128)
    return params


def jax_reference(cfg, seed, tp, dp=1, sp=None, th=0.02, quant=None,
                  batch=1, max_seq=16, cache_seed=None, prompt=None,
                  steps=()):
    """The JAX twin of `torch_parallel_cases.tpk_run` (run by
    `jax_results` in the subprocess): an error is returned as the case's
    result."""
    from jax.experimental.pallas import tpu as pltpu

    from teal_tpu.config import SparsityConfig, get_model_config
    from teal_tpu.models import llama
    from teal_tpu.parallel import tp_kernel

    try:
        c = get_model_config("tiny", **cfg)
        params = _jax_params(json.dumps(cfg, sort_keys=True), seed, quant)
        mesh = tp_kernel.make_tp_mesh(tp, dp=dp)
        sharded = tp_kernel.shard_params(params, mesh, c)
        dtype = jnp.bfloat16 if quant else jnp.float32
        k, v = np_cache(cfg, batch, max_seq, cache_seed)
        cache = tp_kernel.shard_cache(llama.KVCache(
            k=jnp.asarray(k).astype(dtype), v=jnp.asarray(v).astype(dtype)),
            mesh)
        spc = SparsityConfig(**sp)
        thr = jnp.full((c.n_layers, 7), th, jnp.float32)
        out, logits = {}, None
        if prompt is not None:
            logits, cache = tp_kernel.tp_prefill(
                sharded, jnp.asarray(prompt, jnp.int32), cache, thr, cfg=c,
                sp=spc, mesh=mesh)
            out["prefill"] = np.asarray(logits)
        with pltpu.force_tpu_interpret_mode():
            for j, (tok, pos) in enumerate(steps):
                tok = (jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
                       if tok is None else jnp.asarray(tok, jnp.int32))
                logits, cache = tp_kernel.tp_kernel_decode(
                    sharded, tok, cache, jnp.asarray(pos, jnp.int32), thr,
                    cfg=c, sp=spc, mesh=mesh)
                logits = jax.device_get(logits)
                out[f"logits{j}"] = np.asarray(logits)
                out[f"tok{j}"] = np.asarray(tok)
        out["k"], out["v"] = (np.asarray(t, np.float32) for t in cache)
        return out
    except Exception as e:          # the case's result
        return {"error": np.array(f"{type(e).__name__}: {e}")}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_kernel")
    cases = {n: ("tpk_run", kw) for n, (kw, _, _) in DECODE.items()}
    cases.update({n: ("tpk_run", kw) for n, (kw, _, _) in ERRORS.items()})
    cases["streams"] = ("tpk_streams", STREAMS)
    cases["int4-g64"] = ("tpk_run", INT4_G64)
    # the group is joined after the JAX child: the group took up to 213 s
    # in the builder's 6-worker runs; twice that
    ranks = Ranks(WORLD, cases, d / "ranks", timeout=430.0)
    try:
        jcases = {n: kw for n, (kw, _, _) in DECODE.items()}
        jcases.update({n: kw for n, (kw, _, _) in ERRORS.items()})
        jax_out = jax_results(__file__, "jax_reference", jcases, d)
    finally:
        port = ranks.join()
    return jax_out, port


@pytest.mark.parametrize("case", list(DECODE))
def test_tp_kernel_decode_matches_jax(case, results):
    """Every step's logits (after `tp_prefill` where the case has a
    prompt; greedy steps take the same tokens) and the full cache equal
    the JAX package's `tp_kernel_decode` at the same degree; every rank
    holds the same logits bit for bit."""
    jax_out, port = results
    kw, tol, ctol = DECODE[case]
    want = jax_out[case]
    assert not error_of(want), error_of(want)
    n = kw["tp"] * kw.get("dp", 1)
    for r in range(n):
        assert not error_of(port[case][r]), error_of(port[case][r])
    got = port[case][0]
    names = [k for k in want if k.startswith(("logits", "prefill"))]
    assert len(names) == len(kw["steps"]) + ("prompt" in kw)
    for j in range(len(kw["steps"])):
        np.testing.assert_array_equal(got[f"tok{j}"], want[f"tok{j}"])
    for name in names:
        np.testing.assert_allclose(got[name], want[name], rtol=tol, atol=tol,
                                   err_msg=name)
        for r in range(1, n):
            np.testing.assert_array_equal(port[case][r][name], got[name])
    for name in ("k", "v"):
        np.testing.assert_allclose(got[name], want[name], rtol=ctol,
                                   atol=ctol, err_msg=name)


@pytest.mark.parametrize("case", list(ERRORS))
def test_tp_kernel_decode_raises_like_jax(case, results):
    """The calls the reference refuses are refused: unpacked int4 and
    top-k mode (NotImplementedError), sparsity off on bf16 weights, more
    than 8 rows a dp block and MoE at batch 2 (the reference asserts),
    packed int4 at tp 4 where the down shard is not whole 128-channel
    groups."""
    jax_out, port = results
    _, port_type, jax_type = ERRORS[case]
    assert error_of(jax_out[case]).startswith(jax_type), \
        error_of(jax_out[case])
    for r in range(WORLD):
        err = error_of(port[case][r])
        if case != "int4-tp4" and r >= ERRORS[case][0]["tp"]:
            continue                # outside the mesh: nothing to run
        assert err.startswith(port_type), (r, err)


def test_int4_gather_group_must_match_quant_group(results):
    """Packed int4 at sparsity off and block size 32 would gather at G 64
    over quant groups of 128: the port raises ValueError."""
    _, port = results
    for r in range(2):
        err = error_of(port["int4-g64"][r])
        assert err.startswith("ValueError") and "quant groups" in err, err


def test_residual_stream_bit_identical_across_ranks(results):
    """`tp_decode_layer` at tp 4 with binding caps: after every o and down
    reduction all four ranks hold the same stream bit for bit (each runs
    the next colwise selection on its own)."""
    _, port = results
    outs = port["streams"]
    for r in range(WORLD):
        assert not error_of(outs[r]), error_of(outs[r])
    assert len(outs[0]) == 2 * KCFG4["n_layers"]
    for name, a in outs[0].items():
        assert np.isfinite(a).all()
        for r in range(1, WORLD):
            np.testing.assert_array_equal(outs[r][name], a, err_msg=name)
