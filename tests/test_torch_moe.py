"""The port's Mixtral (MoE) path against the JAX package on the CPU, on the
JAX package's own MoE test config (`tests/test_moe.py`, 4 experts, 2
routed, head dim 128):
  - `models/moe.moe_ffn` in prefill and decode (batch 1 and 4; no
    sparsity, the group rule, the elementwise TEAL rule) against JAX's
    `moe_ffn` (fp32, 2e-5);
  - the layer loop's decode (`token_fused=False`, batch 1; the top-k block
    config; batch 2, which the token path refuses) against JAX's layer loop
    with its Pallas kernels in interpret mode (fp32, 2e-5: logits and both
    caches);
  - the token path (plain K1 / K2 / K5) against JAX's whole-token kernel in
    interpret mode, at pos 0 and 5 with a random cache, the down threshold
    (column 6) at 0 as calibration leaves it and picked (fp32, 2e-5:
    logits and both caches);
  - the int8 token path at one layer in bf16 against JAX's int8 token
    kernel (2^-7 of scale, as `tests/test_torch_quant.py` holds one
    quantized layer);
  - K5's plain version (`moe_route_plain`) against `jax.lax.top_k` and a
    softmax, ties included (the lowest index wins);
  - the router carried in fp32 by `params_from_numpy` and counted in
    `Generator.model_bytes`.
The seeds give top-2 router margins far above the two frameworks'
summation-order differences (checked where the test sees the logits).
The JAX interpret-mode references run once per module, in one subprocess
(`jax_subprocess.jax_results`, `jax_reference` below), so a hang of the
interpreter fails these cases instead of stalling the run."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax_subprocess import jax_results

from teal_tpu.config import SparsityConfig as JSparsityConfig
from teal_tpu.config import get_model_config as jget_model_config
from teal_tpu.engine import Generator as JGenerator
from teal_tpu.models import llama as jllama
from teal_tpu.models import moe as jmoe
from teal_tpu.ops import quant as jq
from teal_tpu_torch.config import SparsityConfig, get_model_config
from teal_tpu_torch.engine import Generator
from teal_tpu_torch.models import llama, moe
from teal_tpu_torch.ops import token_block

CFG_KW = dict(n_layers=2, n_heads=2, n_kv_heads=2, dim=256,
              intermediate_size=384, vocab_size=128, n_experts=4,
              n_experts_per_tok=2)
MAIN = dict(enabled=True, kernel="block", block_size=128,
            block_keep_frac=0.5, block_thresholding=True)
TOPK = dict(enabled=True, kernel="block")
TOL = dict(rtol=2e-5, atol=2e-5)
T = 16
# [L, 7] thresholds: q = k = v, gate = up; column 6 (the experts' down
# stage) at 0 as calibration leaves it for MoE, or picked
TH = np.array([[2.6, 2.6, 2.6, 0.12, 2.6, 2.6, 0.0],
               [2.7, 2.7, 2.7, 0.13, 2.7, 2.7, 0.0]], np.float32)
TH_DOWN = 0.2


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _thresholds(col6: bool):
    th = TH.copy()
    if col6:
        th[:, 6] = TH_DOWN
    return th


def _cache(seed, L=CFG_KW["n_layers"], dtype=np.float32):
    rng = np.random.default_rng(seed)
    shape = (L, 1, CFG_KW["n_kv_heads"], T, 128)
    return tuple((rng.standard_normal(shape) * 0.1).astype(dtype)
                 for _ in range(2))


@pytest.fixture(scope="module")
def model():
    return _model()


@functools.lru_cache(maxsize=None)
def _model():
    cfg = get_model_config("tiny", **CFG_KW)
    jcfg = jget_model_config("tiny", **CFG_KW)
    assert cfg.head_dim == 128
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    params = llama.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return cfg, jcfg, params, jparams


def _layer(tree, i):
    return {k: (v[i] if not isinstance(v, dict)
                else {kk: vv[i] for kk, vv in v.items()})
            for k, v in tree["layers"].items()}


def _top2_margin(logits):
    """Smallest gap between the 2nd and 3rd largest logit of any row."""
    s = np.sort(np.asarray(logits, np.float64), axis=-1)
    return float((s[..., -2] - s[..., -3]).min())


# --- models/moe.py ----------------------------------------------------------

RULES = {
    "dense": None,
    "group": dict(MAIN, apply_prefill=True),
    "teal": dict(enabled=True, mode="teal", apply_prefill=True),
}


@pytest.mark.parametrize("b,s", [(1, 6), (1, 1), (4, 1)],
                         ids=["prefill", "decode-b1", "decode-b4"])
@pytest.mark.parametrize("rule", list(RULES))
def test_moe_ffn_matches_jax(model, rule, b, s):
    """`moe_ffn` on one layer, prefill (every expert, fp32 combine) and
    decode (the routed experts, combined in the stream type), under each
    sparsity rule, against JAX's `moe_ffn`; a sparsity rule changes the
    output (it engages)."""
    cfg, jcfg, params, jparams = model
    rng = np.random.default_rng(20 + 3 * b + s)
    y = rng.standard_normal((b, s, cfg.dim)).astype(np.float32)
    lp, jlp = _layer(params, 1), _layer(jparams, 1)
    assert _top2_margin(y @ np.asarray(jlp["router"])) > 1e-3
    th_gu, th_down = (2.5, 0.2) if rule == "group" else (0.7, 0.05)
    kw = {}
    if RULES[rule] is not None:
        kw = dict(th_gu=th_gu, th_down=th_down)
    sp = None if RULES[rule] is None else SparsityConfig(**RULES[rule])
    jsp = None if RULES[rule] is None else JSparsityConfig(**RULES[rule])
    got = moe.moe_ffn(torch.from_numpy(y), lp, cfg, sp, **kw)
    want = jmoe.moe_ffn(jnp.asarray(y), jlp, jcfg, jsp, **kw)
    assert got.shape == (b, s, cfg.dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if sp is not None:
        dense = moe.moe_ffn(torch.from_numpy(y), lp, cfg)
        assert float((got - dense).abs().max()) > 1e-4


def test_init_params_moe_shapes():
    """`init_params` on a Mixtral config draws the reference's MoE leaves
    (router [L, D, E] in fp32, expert stacks [L, E, K, N])."""
    cfg = get_model_config("tiny", **CFG_KW)
    p = llama.init_params(cfg, torch.Generator().manual_seed(0),
                          torch.bfloat16, "cpu")
    L, D, I, E = 2, 256, 384, 4
    lay = p["layers"]
    assert lay["router"].shape == (L, D, E)
    assert lay["router"].dtype == torch.float32
    assert torch.equal(lay["router"], lay["router"].bfloat16().float())
    for n, shape in (("wgate", (L, E, D, I)), ("wup", (L, E, D, I)),
                     ("wdown", (L, E, I, D))):
        assert lay[n].shape == shape and lay[n].dtype == torch.bfloat16
        assert 0.015 < float(lay[n].float().std()) < 0.025


# --- the layer loop ---------------------------------------------------------

LOOP_CASES = {
    "block-threshold-b1": (dict(MAIN, token_fused=False), 1),
    "block-topk-b1": (TOPK, 1),
    "block-threshold-b2": (MAIN, 2),
}


def _loop_inputs(case):
    """A layer-loop case's (sparsity kwargs, batch, toks, k, v, th)."""
    sp_kw, b = LOOP_CASES[case]
    k, v = _cache(7)
    k, v = np.repeat(k, b, axis=1), np.repeat(v, b, axis=1)
    return sp_kw, b, np.arange(3, 3 + b)[:, None], k, v, _thresholds(True)


def _jax_loop(case):
    """JAX's layer loop on a `LOOP_CASES` entry, its Pallas kernels in
    interpret mode (run by `jax_results` in the subprocess)."""
    _, jcfg, _, jparams = _model()
    sp_kw, _, toks, k, v, th = _loop_inputs(case)
    with pltpu.force_tpu_interpret_mode():
        want, wc = jllama.forward(
            jparams, jnp.asarray(toks, jnp.int32),
            jllama.KVCache(jnp.asarray(k), jnp.asarray(v)), 5,
            jnp.asarray(th), cfg=jcfg,
            sp=JSparsityConfig(**sp_kw, fused_decode_attention=True))
    return {"logits": np.asarray(want), "k": np.asarray(wc.k),
            "v": np.asarray(wc.v)}


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_layer_loop_decode_matches_jax(model, case, jax_refs):
    """Single-token decode that the token path does not take (token_fused
    False, the top-k config, batch 2) runs the layer loop: logits and both
    caches as JAX's layer loop (its Pallas kernels in interpret mode)."""
    cfg, jcfg, params, jparams = model
    sp_kw, b, toks, k, v, th = _loop_inputs(case)
    sp = SparsityConfig(**sp_kw)
    assert not llama.can_token_decode(params, cfg, sp, 1, b, torch.float32)
    cache = llama.KVCache.from_numpy(k, v, device="cpu")
    got, gc = llama.forward(params, torch.from_numpy(toks), cache, 5,
                            torch.from_numpy(th), cfg=cfg, sp=sp)
    want = jax_refs[f"loop-{case}"]
    np.testing.assert_allclose(got.numpy(), want["logits"], **TOL)
    np.testing.assert_allclose(gc.k.numpy(), want["k"], **TOL)
    np.testing.assert_allclose(gc.v.numpy(), want["v"], **TOL)


def test_prefill_matches_jax(model):
    """A dense prefill (every expert, the layer loop) as JAX's."""
    cfg, jcfg, params, jparams = model
    toks = np.array([[3, 9, 4, 1, 7, 2, 11]])
    cache = llama.KVCache.init(cfg, 1, T, torch.float32, "cpu")
    got, gc = llama.forward(params, torch.from_numpy(toks), cache, 0,
                            llama.zero_thresholds(cfg, "cpu"), cfg=cfg,
                            sp=SparsityConfig())
    want, wc = jllama.forward(
        jparams, jnp.asarray(toks, jnp.int32),
        jllama.KVCache.init(jcfg, 1, T, jnp.float32), 0,
        jllama.zero_thresholds(jcfg), cfg=jcfg, sp=JSparsityConfig())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gc.k.numpy(), np.asarray(wc.k), **TOL)


# --- the token path ---------------------------------------------------------

TOKEN_CASES = [(0, False), (0, True), (5, False), (5, True)]


def _jax_token(p, col6):
    """JAX's whole-token kernel (interpret mode) at a TOKEN_CASES entry
    (run by `jax_results` in the subprocess)."""
    _, jcfg, _, jparams = _model()
    sp = JSparsityConfig(**MAIN, fused_decode_attention=True)
    k, v = _cache(p)
    with pltpu.force_tpu_interpret_mode():
        lg, c = jllama.forward(
            jparams, jnp.asarray([[3 + p]], jnp.int32),
            jllama.KVCache(jnp.asarray(k), jnp.asarray(v)), p,
            jnp.asarray(_thresholds(col6)), cfg=jcfg, sp=sp)
    return {"logits": np.asarray(lg), "k": np.asarray(c.k),
            "v": np.asarray(c.v)}


@pytest.fixture(scope="module")
def jax_token_runs(jax_refs):
    """JAX's whole-token kernel for every TOKEN_CASES entry, from the
    module's subprocess: {(pos, col6): (logits, k, v)}."""
    return {(p, col6): tuple(jax_refs[f"token-{p}-{int(col6)}"][n]
                             for n in ("logits", "k", "v"))
            for p, col6 in TOKEN_CASES}


@pytest.mark.parametrize("p,col6", TOKEN_CASES,
                         ids=[f"pos{p}-{'col6' if c else 'col6zero'}"
                              for p, c in TOKEN_CASES])
def test_token_path_matches_jax_token_kernel(model, jax_token_runs, p,
                                             col6):
    """The port's MoE token path (K1 / K2 / K5 plain versions: route, then
    each routed expert's gate|up and down through pseudo-layers on the
    device) == JAX's whole-token kernel, logits and both caches."""
    cfg, _, params, _ = model
    sp = SparsityConfig(**MAIN)
    assert llama.can_token_decode(params, cfg, sp, 1, 1, torch.float32)
    k, v = _cache(p)
    cache = llama.KVCache.from_numpy(k, v, device="cpu")
    got, gc = llama.forward(params, torch.tensor([[3 + p]]), cache, p,
                            torch.from_numpy(_thresholds(col6)), cfg=cfg,
                            sp=sp)
    want, wk, wv = jax_token_runs[p, col6]
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(gc.k.numpy(), wk, **TOL)
    np.testing.assert_allclose(gc.v.numpy(), wv, **TOL)


def test_token_path_launch_plan(model):
    """Per layer: K5 once, then gate|up and down of each routed expert at
    pseudo-layers layer * E + e (counts and routes as the path records
    them), and the down stage keeps its first `cap` groups when column 6
    is 0."""
    cfg, _, params, _ = model
    lay = params["layers"]
    ws = tuple(lay[n] for n in llama._WEIGHTS)
    ws = (*ws[:4], *(token_block.expert_stacks(w) for w in ws[4:]))
    assert ws[4].shape == (8, 256, 384) and ws[4].data_ptr() == \
        lay["wgate"].data_ptr()
    caps = llama.token_path_caps(cfg, SparsityConfig(**MAIN))
    k, v = (torch.from_numpy(a) for a in _cache(0))
    rope = llama.precompute_rope(cfg, T, "cpu")
    pos = torch.tensor([0], dtype=torch.int32)
    rows = llama._rope_rows(rope[0], rope[1], pos)
    h = params["embed"][3]
    th = torch.from_numpy(_thresholds(False))
    for i in range(cfg.n_layers):
        counts, routes = [], []
        h = token_block.layer_decode(
            h, i, th, ws, lay["attn_norm"], lay["mlp_norm"], rows, k, v,
            pos, caps=caps, n_heads=cfg.n_heads, norm_eps=cfg.norm_eps,
            counts=counts, routes=routes, router=lay["router"], k_exp=2)
        e = routes[0]
        assert e.dtype == torch.int32 and e.shape == (2,)
        assert bool(((e >= 4 * i) & (e < 4 * i + 4)).all()) and e[0] != e[1]
        c = counts[0]
        assert c.shape == (6,) and int(c[3]) == int(c[5]) == caps[3]


# --- int8 ---------------------------------------------------------------

def _int8_model():
    """int8 Mixtral at one layer (the JAX quantization): (cfg, jcfg,
    params, jparams)."""
    kw = dict(CFG_KW, n_layers=1)
    cfg, jcfg = get_model_config("tiny", **kw), jget_model_config("tiny",
                                                                  **kw)
    jp = jq.quantize_params_int8(
        jllama.init_params(jcfg, jax.random.PRNGKey(17), jnp.bfloat16))
    params = llama.params_from_numpy(jax.tree.map(np.asarray, jp),
                                     device="cpu", dtype=torch.bfloat16)
    return cfg, jcfg, params, jp


def _jax_int8():
    """JAX's int8 whole-token kernel (interpret mode) at one layer (run
    by `jax_results` in the subprocess)."""
    _, jcfg, _, jp = _int8_model()
    k, v = _cache(11, L=1)
    th = _thresholds(True)[:1]
    with pltpu.force_tpu_interpret_mode():
        want, wc = jllama.forward(
            jp, jnp.asarray([[9]], jnp.int32),
            jllama.KVCache(jnp.asarray(k, jnp.bfloat16),
                           jnp.asarray(v, jnp.bfloat16)), 5,
            jnp.asarray(th), cfg=jcfg,
            sp=JSparsityConfig(**MAIN, fused_decode_attention=True))
    return {"logits": np.asarray(want, np.float32),
            "k": np.asarray(wc.k, np.float32),
            "v": np.asarray(wc.v, np.float32)}


def test_int8_token_path_matches_jax_one_layer(jax_refs):
    """int8 Mixtral at one layer in bf16: the port's token path (int8
    scales in K1's epilogue, expert scale stacks as [L*E, N]) against
    JAX's int8 whole-token kernel, within 2^-7 of scale."""
    cfg, _, params, _ = _int8_model()
    assert params["layers"]["wgate"]["q"].dtype == torch.int8
    assert params["layers"]["wgate"]["scale"].shape == (1, 4, 384)
    sp = SparsityConfig(**MAIN)
    assert llama.can_token_decode(params, cfg, sp, 1, 1, torch.bfloat16)
    k, v = _cache(11, L=1)
    th = _thresholds(True)[:1]
    cache = llama.KVCache(torch.from_numpy(k).bfloat16(),
                          torch.from_numpy(v).bfloat16())
    got, gc = llama.forward(params, torch.tensor([[9]]), cache, 5,
                            torch.from_numpy(th), cfg=cfg, sp=sp)
    want = jax_refs["int8"]
    _close(got.float().numpy(), want["logits"], 2 ** -7)
    _close(gc.k.float().numpy(), want["k"], 2 ** -7)
    _close(gc.v.float().numpy(), want["v"], 2 ** -7)


# --- K5's rule --------------------------------------------------------------

@pytest.mark.parametrize("E,k,tie", [(4, 2, None), (8, 2, (3, 6)),
                                     (8, 3, (1, 2)), (8, 2, (5, 0))])
def test_route_rule_matches_jax_top_k(E, k, tie):
    """`moe_route_plain`'s experts and weights == `jax.lax.top_k` and a
    softmax on its own xn; with two equal router columns at the top the
    lower expert comes first (jax.lax.top_k's order), and they weigh the
    same."""
    rng = np.random.default_rng(E + k)
    L, D, layer = 3, 256, 1
    x = rng.standard_normal(D).astype(np.float32)
    norm = (1 + 0.1 * rng.standard_normal((L, D))).astype(np.float32)
    router = (rng.standard_normal((L, D, E)) * 0.05).astype(np.float32)
    if tie is not None:
        router[layer, :, tie[0]] = router[layer, :, tie[1]] = (
            np.sign(x * norm[layer]) * 0.06)
    xn, eidx, w = token_block.moe_route_plain(
        torch.from_numpy(x), torch.from_numpy(norm),
        torch.from_numpy(router), layer, k)
    logits = jnp.asarray(xn.numpy()) @ jnp.asarray(router[layer])
    vals, idx = jax.lax.top_k(logits, k)
    np.testing.assert_array_equal(eidx.numpy(),
                                  layer * E + np.asarray(idx))
    np.testing.assert_allclose(w.numpy(),
                               np.asarray(jax.nn.softmax(vals)), atol=1e-6)
    if tie is not None:
        assert list(np.asarray(idx)[:2]) == sorted(tie)
        assert float(w[0]) == float(w[1])


# --- the repairs -------------------------------------------------------------

def test_params_from_numpy_keeps_router_fp32(model):
    """The router crosses in fp32 whatever type the other floats are cast
    to: the JAX package keeps it unrounded (its int8 quantization leaves
    it fp32, and the token kernel reads it as fp32)."""
    _, jcfg, _, jparams = model
    for tree in (jparams, jq.quantize_params_int8(jparams)):
        p = llama.params_from_numpy(jax.tree.map(np.asarray, tree),
                                    device="cpu", dtype=torch.bfloat16)
        r = p["layers"]["router"]
        assert r.dtype == torch.float32
        np.testing.assert_array_equal(r.numpy(),
                                      np.asarray(tree["layers"]["router"]))
        assert p["layers"]["attn_norm"].dtype == torch.bfloat16


def test_model_bytes_counts_router(model):
    """`Generator.model_bytes` counts the router as JAX's does."""
    cfg, jcfg, params, jparams = model
    got = Generator(cfg, params, max_seq=T, cache_dtype=torch.float32,
                    device="cpu").model_bytes
    want = JGenerator(jcfg, jparams, max_seq=T,
                      cache_dtype=jnp.float32).model_bytes
    assert got == want
    assert got - params["layers"]["router"].numel() * 4 == sum(
        params["layers"][n].numel() * 4 for n in llama._WEIGHTS)


# --- the JAX references, in one subprocess for the module -------------------

def jax_reference(kind, **kw):
    """Every interpret-mode reference of this module, by kind: "loop" (a
    `LOOP_CASES` entry), "token" (a TOKEN_CASES entry), "int8" (run by
    `jax_results` in the subprocess)."""
    if kind == "loop":
        return _jax_loop(**kw)
    if kind == "token":
        return _jax_token(**kw)
    return _jax_int8()


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    cases = {f"loop-{c}": dict(kind="loop", case=c) for c in LOOP_CASES}
    cases.update({f"token-{p}-{int(col6)}": dict(kind="token", p=p,
                                                 col6=col6)
                  for p, col6 in TOKEN_CASES})
    cases["int8"] = dict(kind="int8")
    return jax_results(__file__, "jax_reference", cases,
                       tmp_path_factory.mktemp("jax_moe"))
