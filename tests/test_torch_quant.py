"""The port's weight-only quantization against the JAX package on the CPU:
`ops/quant.py` (integer outputs bit for bit, fp32 leaves within 1e-6
relative), K1 and K3's plain versions with the int8 and packed-int4 weight
plans against the JAX Pallas kernels (interpret mode; same kept sets, fp32
outputs within 1e-5 of scale), and the quantized decode paths of the model
on the head-dim-128 tiny config in bf16:
  - Q8-main / Q4-main: int8 / packed int4 (G = 128) on the main-path
    config, the token path (the JAX whole-token kernel in interpret mode);
  - Q4-loop: packed int4 at G = 64 on the block top-k config, and with
    sparsity off (the gather kernel at keep 1.0), the layer loop;
  - Q8-loop: int8 on the block top-k config, the layer loop with the
    scale after K3.
One layer is held within 2^-7 of scale (bf16 rounds at the same points
in another summation order); two layers within the JAX suite's own
tolerances between its int8/int4 routes (5e-2 logits, 2e-2 caches,
`tests/test_kernels.py`), on inputs whose top-k selections have no near
tie. The JAX interpret-mode references run once per module, in one
subprocess (`jax_subprocess.jax_results`, `jax_reference` below), so a
hang of the interpreter fails these cases instead of stalling the
run."""

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
from teal_tpu.models import llama as jllama
from teal_tpu.ops import block_gemv as jbg
from teal_tpu.ops import quant as jq
from teal_tpu_torch.config import SparsityConfig, get_model_config
from teal_tpu_torch.models import llama
from teal_tpu_torch.ops import block_gemv as tbg
from teal_tpu_torch.ops import quant as tq

CFG_KW = dict(n_heads=2, n_kv_heads=1, dim=256, intermediate_size=384,
              vocab_size=128)
MAIN = dict(enabled=True, kernel="block", block_size=128,
            block_keep_frac=0.5, block_thresholding=True)
TOPK = dict(enabled=True, kernel="block")
T, POS = 16, 9
MAIN_TH = np.array([2.6, 2.6, 2.6, 0.12, 2.65, 2.65, 0.12], np.float32)


def _np(t):
    return t.detach().cpu().float().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(jtree):
    return jax.tree.map(lambda a: _t(np.asarray(a)), jtree)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


# --- ops/quant.py ---------------------------------------------------------

@pytest.mark.parametrize("group", [32, 64, 128])
def test_quant_matches_jax(group):
    """quantize/dequantize int8 and int4, pack/unpack, and the dense
    quantized products against the JAX package."""
    rng = np.random.default_rng(group)
    w = (rng.standard_normal((256, 96)) * 0.05).astype(np.float32)
    w[:, 5] = 0.0                                   # an all-zero channel
    x = rng.standard_normal((2, 256)).astype(np.float32)
    j8, t8 = jq.quantize_int8(jnp.asarray(w)), tq.quantize_int8(_t(w))
    np.testing.assert_array_equal(_np(t8.q), np.asarray(j8.q))
    assert t8.q.dtype == torch.int8
    np.testing.assert_allclose(_np(t8.scale), np.asarray(j8.scale), rtol=1e-6)
    np.testing.assert_allclose(_np(tq.dequantize_int8(t8, torch.float32)),
                               np.asarray(jq.dequantize_int8(j8, jnp.float32)),
                               rtol=1e-6)
    j4 = jq.quantize_int4(jnp.asarray(w), group)
    t4 = tq.quantize_int4(_t(w), group)
    np.testing.assert_array_equal(_np(t4.q), np.asarray(j4.q))
    for a, b in ((t4.scale, j4.scale), (t4.zero, j4.zero)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)
    np.testing.assert_allclose(_np(tq.dequantize_int4(t4, torch.float32)),
                               np.asarray(jq.dequantize_int4(j4, jnp.float32)),
                               rtol=1e-6, atol=1e-7)
    jp, tp = jq.pack_int4(j4), tq.pack_int4(t4)
    np.testing.assert_array_equal(_np(tp["qp"]), np.asarray(jp["qp"]))
    np.testing.assert_allclose(_np(tp["sz"]), np.asarray(jp["sz"]), rtol=1e-6)
    np.testing.assert_allclose(
        _np(tq.unpack_int4(tp["qp"], tp["sz"], torch.float32)),
        np.asarray(jq.unpack_int4(jp["qp"], jp["sz"], jnp.float32)),
        rtol=1e-6, atol=1e-7)
    d = {"q": t4.q, "scale": t4.scale, "zero": t4.zero}
    jd = {"q": j4.q, "scale": j4.scale, "zero": j4.zero}
    np.testing.assert_allclose(
        _np(tq.dequantize_int4_dict(d, torch.float32)),
        np.asarray(jq.dequantize_int4_dict(jd, jnp.float32)), rtol=1e-6,
        atol=1e-7)
    assert tq.param_is_quantized(d) and not tq.param_is_quantized(_t(w))
    xb = jnp.asarray(x, jnp.bfloat16)
    tb = _t(x).bfloat16()
    for got, want in (
            (tq.int8_matmul(tb, t8), jq.int8_matmul(xb, j8)),
            (tq.int4_matmul(tb, t4), jq.int4_matmul(xb, j4)),
            (tq.int4_dict_matmul(tb, d), jq.int4_dict_matmul(xb, jd)),
            (tq.int4_packed_matmul(tb, tp),
             jq.int4_packed_matmul(xb, jp))):
        _close(_np(got), np.asarray(want, np.float32), 2 ** -8)
    assert tq.int4_gather_group(32, 4096) == jq.int4_gather_group(32, 4096)


def _layer_tree(rng, L=2, K=256, ns=(64, 96)):
    return {"embed": rng.standard_normal((8, K)).astype(np.float32),
            "lm_head": (rng.standard_normal((K, 64)) * 0.05)
            .astype(np.float32),
            "layers": {"attn_norm": np.ones((L, K), np.float32),
                       **{n: (rng.standard_normal((L, K, N)) * 0.05)
                          .astype(np.float32)
                          for n, N in zip(("wq", "wdown"), ns)}}}


def _tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _tree_equal(got[k], want[k])
        return
    want = np.asarray(want)
    assert _np(got).shape == want.shape
    if want.dtype == np.int8:
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(_np(got), want)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("group,block_size", [(64, 32), (128, 32)],
                         ids=["packed-as-stored", "requantized"])
def test_whole_model_quantization_matches_jax(group, block_size):
    """quantize_params_int8 / _int4 and pack_int4_params, with the stored
    group equal to the gather group (64 at block size 32) and not (128:
    requantized at 64)."""
    tree = _layer_tree(np.random.default_rng(group))
    jtree, ttree = jax.tree.map(jnp.asarray, tree), _tree(tree)
    _tree_equal(tq.quantize_params_int8(ttree), jq.quantize_params_int8(jtree))
    j4 = jq.quantize_params_int4(jtree, group)
    t4 = tq.quantize_params_int4(ttree, group)
    _tree_equal(t4, j4)
    _tree_equal(tq.pack_int4_params(t4, block_size),
                jq.pack_int4_params(j4, block_size))


# --- K1 and K3 with the weight plans ---------------------------------------

def _spiky(rng, rows, nb, G):
    x = rng.uniform(-0.5, 0.5, (rows, nb, G)).astype(np.float32)
    for r in range(rows):
        levels = 1.0 + 0.1 * rng.permutation(nb) + 0.01 * r
        x[r, np.arange(nb), rng.integers(0, G, nb)] = levels
    return x.reshape(rows, nb * G)


def _plan_weights(rng, plan, L, K, ns, G):
    """Per weight: (port operand, JAX operand) of the plan."""
    out = []
    for n in ns:
        w = (rng.standard_normal((L, K, n)) * 0.1).astype(np.float32)
        if plan == "int8":
            q = np.stack([np.asarray(jq.quantize_int8(jnp.asarray(m)).q)
                          for m in w])
            out.append((_t(q), jnp.asarray(q)))
        else:
            packs = [jq.pack_int4(jq.quantize_int4(jnp.asarray(m), G))
                     for m in w]
            jw = {k: jnp.stack([p[k] for p in packs]) for k in ("qp", "sz")}
            out.append(({k: _t(np.asarray(v)) for k, v in jw.items()}, jw))
    return out


K1_PLAN_CASES = [("int8", 32, True), ("int8", 128, False),
                 ("int4", 64, True), ("int4", 128, False)]
K3_PLAN_CASES = [("int8", 32, 1), ("int8", 64, 8), ("int4", 64, 1),
                 ("int4", 128, 8)]


def _k1_plan_case(plan, G, norm):
    """test_k1_plans_match_jax_kernel's inputs: x, gain, the (port, JAX)
    weights, the selection input xs, layer, cap and a threshold with 5
    survivors (cap 4)."""
    rng = np.random.default_rng(G + len(plan))
    L, nb, layer, cap = 3, 8, 2, 4
    K = nb * G
    x = _spiky(rng, 1, nb, G)[0] * 1.7
    gain = (1 + 0.1 * rng.standard_normal((L, K))).astype(np.float32)
    ws = _plan_weights(rng, plan, L, K, (64, 32, 32), G)
    xs = np.asarray(jllama.rms_norm(jnp.asarray(x[None]),
                                    jnp.asarray(gain[layer]), 1e-5))[0] \
        if norm else x
    scores = np.abs(xs).reshape(-1, G).max(-1)
    thr = np.float32(np.sort(scores)[2] + 1e-3)      # 5 survivors, cap 4
    return x, gain, ws, xs, layer, cap, thr


def _jax_k1_plan(plan, G, norm):
    """The JAX Pallas kernel `fused_select_gather_gemv` (interpret mode)
    on a K1_PLAN_CASES entry (run by `jax_results` in the subprocess)."""
    x, gain, ws, _, layer, cap, thr = _k1_plan_case(plan, G, norm)
    with pltpu.force_tpu_interpret_mode():
        want = jbg.fused_select_gather_gemv(
            jbg.pack_x3(jnp.asarray(x[None]), G), jnp.asarray([thr]),
            [jw for _, jw in ws], G=G, cap=cap, out_dtype=jnp.float32,
            layer=layer,
            norm3=jbg.pack_norm3(jnp.asarray(gain), G) if norm else None)
    return {"out": np.concatenate([np.asarray(o)[0] for o in want])}


@pytest.mark.parametrize("plan,G,norm", K1_PLAN_CASES)
def test_k1_plans_match_jax_kernel(plan, G, norm, jax_refs):
    """K1's plain version with int8 / packed-int4 weights == the JAX
    Pallas kernel `fused_select_gather_gemv` (interpret mode), with and
    without the folded norm; kept set == the JAX selection."""
    x, gain, ws, xs, layer, cap, thr = _k1_plan_case(plan, G, norm)
    got, idx, count = tbg.select_gather_gemv(
        _t(x), torch.tensor(thr), [w for w, _ in ws], layer, cap, G=G,
        norm=_t(gain) if norm else None)
    jidx, _ = jbg.select_groups(jnp.asarray(xs[None]), G, cap,
                                threshold=jnp.float32(thr))
    assert int(count[0]) == cap
    np.testing.assert_array_equal(_np(idx).astype(np.int32), np.asarray(jidx))
    _close(_np(got), jax_refs[f"k1-{plan}-{G}-{int(norm)}"]["out"], 1e-5)


def _k3_plan_case(plan, G, rows):
    """test_k3_plans_match_jax_kernel's inputs: the (port, JAX) weights,
    the JAX selection's idx / xpack, layer and k_keep."""
    rng = np.random.default_rng(G + rows + len(plan))
    L, nb, k_keep, layer = 3, 8, 5, 1
    x = _spiky(rng, rows, nb, G)
    ws = _plan_weights(rng, plan, L, nb * G, (64, 32), G)
    sel = jbg.select_groups if rows == 1 else jbg.select_groups_batched
    jidx, jxp = sel(jnp.asarray(x), G, k_keep)
    return ws, jidx, jxp, layer, k_keep


def _jax_k3_plan(plan, G, rows):
    """The JAX Pallas kernel `block_gather_gemv_multi` (interpret mode) on
    a K3_PLAN_CASES entry (run by `jax_results` in the subprocess)."""
    ws, jidx, jxp, layer, k_keep = _k3_plan_case(plan, G, rows)
    with pltpu.force_tpu_interpret_mode():
        want = jbg.block_gather_gemv_multi(
            jidx, jxp, [jw for _, jw in ws], G=G, k_keep=k_keep,
            out_dtype=jnp.float32, layer=layer, out_rows=rows)
    return {"out": np.concatenate([np.asarray(o) for o in want], axis=1)}


@pytest.mark.parametrize("plan,G,rows", K3_PLAN_CASES)
def test_k3_plans_match_jax_kernel(plan, G, rows, jax_refs):
    """K3's plain version with int8 / packed-int4 weights == the JAX
    Pallas kernel `block_gather_gemv_multi` (interpret mode) on the same
    idx / xpack, 1 or 8 input rows."""
    ws, jidx, jxp, layer, _ = _k3_plan_case(plan, G, rows)
    got = tbg.block_gather_gemv_multi(_t(jidx), _t(jxp), [w for w, _ in ws],
                                      layer, G, rows)
    _close(_np(got), jax_refs[f"k3-{plan}-{G}-{rows}"]["out"], 1e-5)


def test_k1_int8_scale_epilogue():
    """K1's `scales` go on the fp32 sums before the residual and silu
    epilogues (the reference token kernel's stage writers)."""
    rng = np.random.default_rng(5)
    L, K, layer, cap = 2, 512, 1, 3
    x = _t(rng.standard_normal(K).astype(np.float32))
    thr = torch.tensor(0.5)
    q = [_t(rng.integers(-128, 128, (L, K, 64)).astype(np.int8))
         for _ in range(2)]
    s = [_t(rng.uniform(0.001, 0.01, (L, 64)).astype(np.float32))
         for _ in range(2)]
    raw = tbg.select_gather_gemv(x, thr, q, layer, cap)[0]
    g, u = raw[:64] * s[0][layer], raw[64:] * s[1][layer]
    silu = tbg.select_gather_gemv(x, thr, q, layer, cap, silu=True,
                                  scales=s)[0]
    np.testing.assert_allclose(_np(silu), _np(g * torch.sigmoid(g) * u),
                               rtol=1e-5, atol=1e-7)
    res = _t(rng.standard_normal(64).astype(np.float32))
    out = tbg.select_gather_gemv(x, thr, q[:1], layer, cap, res=res,
                                 scales=s[:1])[0]
    np.testing.assert_allclose(_np(out), _np(g + res), rtol=1e-6, atol=1e-6)
    for bad in (dict(scales=s), dict(scales=[s[0].double()])):
        with pytest.raises(ValueError):
            tbg.select_gather_gemv(x, thr, q[:1], layer, cap, **bad)


def test_plan_checks():
    """One plan a call; int4 needs G >= 64 and sz at the call's G; no
    mixed plans; scales only with int8."""
    x = torch.zeros(256)
    thr = torch.tensor(0.0)
    q = torch.zeros(1, 256, 32, dtype=torch.int8)
    i4 = {"qp": torch.zeros(1, 128, 32, dtype=torch.int8),
          "sz": torch.zeros(1, 2, 2, 32)}
    for ws, G in (([q, torch.zeros(1, 256, 32)], 128), ([i4], 32),
                  ([i4], 64), ([{"q": q}], 128)):
        with pytest.raises(ValueError):
            tbg.select_gather_gemv(x, thr, ws, 0, 1, G=G)
    assert tbg.select_gather_gemv(x, thr, [i4], 0, 1, G=128)[0].shape == (32,)
    with pytest.raises(ValueError):
        tbg.select_gather_gemv(x, thr, [i4], 0, 1, G=128,
                               scales=[torch.ones(1, 32)])
    with pytest.raises(ValueError):
        tbg._weight_kind({"q": q, "scale": q, "zero": q})


# --- the model ------------------------------------------------------------

def _q8(p):
    return tq.quantize_params_int8(p)


def _q4_main(p):
    return tq.pack_int4_params(tq.quantize_params_int4(p, 128), 128)


def _q4_loop(p):
    return tq.pack_int4_params(tq.quantize_params_int4(p, 64), 32)


PATHS = {
    "Q8-main": (_q8, MAIN, MAIN_TH, True),
    "Q4-main": (_q4_main, MAIN, MAIN_TH, True),
    "Q4-loop": (_q4_loop, TOPK, None, False),
    "Q4-loop-keep1": (_q4_loop, {}, None, False),
    "Q8-loop": (_q8, TOPK, None, False),
}


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.float().numpy(), jnp.bfloat16)
    return jnp.asarray(tree.numpy())


@functools.lru_cache(maxsize=None)
def _quant_model(n_layers, quantize, seed=7):
    """bf16 random weights quantized by the port (its quantization is held
    to the JAX package's bit for bit above), as the port's tensors and as
    the same values for the JAX package."""
    kw = dict(CFG_KW, n_layers=n_layers)
    cfg, jcfg = get_model_config("tiny", **kw), jget_model_config("tiny", **kw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed), jnp.bfloat16)
    params = quantize(llama.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu",
        dtype=torch.bfloat16))
    return cfg, jcfg, params, _to_jax(params)


def _decode_inputs(n_layers):
    """The decode step's caches: bf16 values, as fp32."""
    rng = np.random.default_rng(7)
    shape = (n_layers, 1, 1, T, 128)
    return tuple(np.asarray(jnp.asarray(rng.standard_normal(shape) * 0.1,
                                        jnp.bfloat16), np.float32)
                 for _ in range(2))


def _path_th(path, n_layers):
    """A PATHS entry's [L, 7] thresholds (its base row, or zeros)."""
    base_th = PATHS[path][2]
    return (np.tile(base_th, (n_layers, 1)) if base_th is not None
            else np.zeros((n_layers, 7), np.float32))


def _jax_decode(path, n_layers, tok=9):
    """JAX's forward (interpret mode) on the quantized model of a PATHS
    entry: logits and both caches as fp32 (run by `jax_results` in the
    subprocess)."""
    quantize, sp_kw, _, _ = PATHS[path]
    _, jcfg, _, jparams = _quant_model(n_layers, quantize)
    k, v = _decode_inputs(n_layers)
    with pltpu.force_tpu_interpret_mode():
        want, wc = jllama.forward(
            jparams, jnp.asarray([[tok]], jnp.int32),
            jllama.KVCache(jnp.asarray(k, jnp.bfloat16),
                           jnp.asarray(v, jnp.bfloat16)), POS,
            jnp.asarray(_path_th(path, n_layers)), cfg=jcfg,
            sp=JSparsityConfig(**sp_kw, fused_decode_attention=True))
    return {"logits": np.asarray(want, np.float32),
            "k": np.asarray(wc.k, np.float32),
            "v": np.asarray(wc.v, np.float32)}


def _decode_both(path, n_layers, refs, tok=9):
    quantize, sp_kw, _, token_path = PATHS[path]
    cfg, _, params, _ = _quant_model(n_layers, quantize)
    k, v = _decode_inputs(n_layers)
    th = _path_th(path, n_layers)
    sp = SparsityConfig(**sp_kw)
    assert llama.can_token_decode(params, cfg, sp, 1, 1,
                                  torch.bfloat16) == token_path
    cache = llama.KVCache.from_numpy(k, v, device="cpu", dtype=torch.bfloat16)
    got, cache = llama.forward(params, torch.tensor([[tok]]), cache, POS,
                               torch.from_numpy(th), cfg=cfg, sp=sp)
    want = refs[f"decode-{path}-{n_layers}"]
    return ((_np(got), want["logits"]), (_np(cache.k), want["k"]),
            (_np(cache.v), want["v"]))


@pytest.mark.parametrize("path", list(PATHS))
def test_quantized_decode_one_layer_matches_jax(path, jax_refs):
    """One decode step at pos 9, one layer: logits and caches within 2^-7
    of scale of the JAX forward."""
    for got, want in _decode_both(path, 1, jax_refs):
        _close(got, want, 2 ** -7)


@pytest.mark.parametrize("path", list(PATHS))
def test_quantized_decode_two_layers_matches_jax(path, jax_refs):
    """Two layers: within the JAX suite's tolerances between its
    quantized routes (5e-2 logits, 2e-2 caches)."""
    (lg, lw), *caches = _decode_both(path, 2, jax_refs)
    np.testing.assert_allclose(lg, lw, rtol=5e-2, atol=5e-2)
    for got, want in caches:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("quantize", [_q8, _q4_loop], ids=["int8", "int4"])
def test_quantized_dense_prefill_matches_jax(quantize):
    """A dense prefill (S = 6 at pos 0) through the quantized products:
    int8 matmul then scale, packed int4 unpacked then matmul."""
    cfg, jcfg, params, jparams = _quant_model(1, quantize)
    toks = np.array([[5, 1, 7, 2, 9, 4]], np.int32)
    cache = llama.KVCache.init(cfg, 1, T, torch.bfloat16, "cpu")
    got, cache = llama.forward(params, torch.from_numpy(toks).long(), cache,
                               0, torch.zeros(1, 7), cfg=cfg,
                               sp=SparsityConfig())
    want, wc = jllama.forward(jparams, jnp.asarray(toks),
                              jllama.KVCache.init(jcfg, 1, T, jnp.bfloat16),
                              0, jnp.zeros((1, 7)), cfg=jcfg,
                              sp=JSparsityConfig())
    _close(_np(got), np.asarray(want), 2 ** -7)
    _close(_np(cache.k), np.asarray(wc.k, np.float32), 2 ** -7)


_PROJ_KW = dict(enabled=True, kernel="block", block_thresholding=True)


def _int8_proj_case():
    """test_int8_block_proj_ignores_threshold_like_jax's input x and int8
    weight (JAX's quantization)."""
    rng = np.random.default_rng(9)
    x = _spiky(rng, 1, 8, 32).reshape(1, 1, 256)
    w8 = jq.quantize_int8(jnp.asarray(rng.standard_normal((256, 64)) * 0.05,
                                      jnp.float32))
    return x, w8


def _jax_int8_proj():
    """JAX's `_proj` of the int8 weight in block mode (interpret mode; run
    by `jax_results` in the subprocess)."""
    x, w8 = _int8_proj_case()
    with pltpu.force_tpu_interpret_mode():
        want = jllama._proj(jnp.asarray(x, jnp.bfloat16),
                            {"q": w8.q, "scale": w8.scale},
                            jnp.float32(1e9), JSparsityConfig(**_PROJ_KW),
                            proj="q")
    return {"out": np.asarray(want, np.float32)}


def test_int8_block_proj_ignores_threshold_like_jax(jax_refs):
    """`_proj` with int8 weights in block mode outside the block route runs
    top-k and ignores the threshold, as the reference does."""
    x, w8 = _int8_proj_case()
    tw = {"q": _t(np.asarray(w8.q)), "scale": _t(np.asarray(w8.scale))}
    want = jax_refs["int8-proj"]["out"]
    got = llama._proj(_t(x).bfloat16(), tw, torch.tensor(1e9),
                      SparsityConfig(**_PROJ_KW))
    _close(_np(got), want, 2 ** -7)
    assert np.abs(want).max() > 0


@pytest.mark.parametrize("quantize", [jq.quantize_params_int8,
                                      jq.quantize_params_int4],
                         ids=["int8", "int4"])
def test_quantized_lm_head_matches_jax(quantize):
    """The int8 head (int8 values in h's type, fp32 sums, then the scale)
    and the groupwise int4 head (dequantized to h's type) == the JAX
    `_lm_head`."""
    rng = np.random.default_rng(4)
    tree = _layer_tree(rng)
    jtree = quantize(jax.tree.map(jnp.asarray, tree))
    h = rng.standard_normal((1, 2, 256)).astype(np.float32)
    want = jllama._lm_head(jtree, jnp.asarray(h, jnp.bfloat16))
    got = llama._lm_head(llama.params_from_numpy(
        jax.tree.map(np.asarray, jtree), device="cpu", dtype=torch.bfloat16),
        _t(h).bfloat16())
    assert got.dtype == torch.float32
    _close(_np(got), np.asarray(want), 1e-5)


def test_params_from_numpy_keeps_quantized_leaves():
    """int8 and packed-int4 trees carried across with dtype=bf16: integer
    leaves keep their type and bits, scale / sz / zero stay fp32."""
    tree = jax.tree.map(jnp.asarray, _layer_tree(np.random.default_rng(6)))
    for jtree in (jq.quantize_params_int8(tree),
                  jq.pack_int4_params(jq.quantize_params_int4(tree, 64), 32)):
        got = llama.params_from_numpy(jax.tree.map(np.asarray, jtree),
                                      device="cpu", dtype=torch.bfloat16)
        for name in ("wq", "wdown"):
            for k, a in jtree["layers"][name].items():
                t = got["layers"][name][k]
                assert t.dtype == (torch.int8 if k in ("q", "qp")
                                   else torch.float32), (name, k, t.dtype)
                np.testing.assert_array_equal(_np(t), np.asarray(a))
        assert got["layers"]["attn_norm"].dtype == torch.bfloat16
        for k, a in jtree["lm_head"].items():
            assert got["lm_head"][k].dtype == (torch.int8 if k == "q"
                                               else torch.float32)
            np.testing.assert_array_equal(_np(got["lm_head"][k]),
                                          np.asarray(a))


def test_token_path_gate_follows_jax_for_quantized_weights():
    """can_token_decode sends quantized params where the JAX package's
    `_can_packed_pipeline` sends them: int8 only with all seven int8 and
    the whole-token kernel allowed, packed int4 when the gather group is
    128, never unpacked int4."""
    cfg, jcfg, q8, jq8 = _quant_model(1, _q8)
    _, _, q4, jq4 = _quant_model(1, _q4_main)
    _, _, q4l, jq4l = _quant_model(1, _q4_loop)
    raw = llama.params_from_numpy(
        jax.tree.map(np.asarray, jllama.init_params(
            jcfg, jax.random.PRNGKey(7), jnp.bfloat16)),
        device="cpu", dtype=torch.bfloat16)
    u4 = tq.quantize_params_int4(raw, 128)
    mixed = dict(q8, layers=dict(q8["layers"], wk=raw["layers"]["wk"]))
    jmixed = dict(jq8, layers=dict(jq8["layers"], wk=_to_jax(raw)["layers"]
                                   ["wk"]))
    for (p, jp), sp_kw in (((q8, jq8), MAIN),
                           ((q8, jq8), dict(MAIN, token_fused=False)),
                           ((mixed, jmixed), MAIN), ((q4, jq4), MAIN),
                           ((q4, jq4), dict(MAIN, block_size=32)),
                           ((q4l, jq4l), dict(MAIN, block_size=32)),
                           ((u4, _to_jax(u4)), MAIN)):
        jnorms = {"attn": None, "mlp": None}
        want = jllama._can_packed_pipeline(jp, jcfg, JSparsityConfig(**sp_kw),
                                           1, 1, True, jnorms)
        got = llama.can_token_decode(p, cfg, SparsityConfig(**sp_kw), 1, 1,
                                     torch.bfloat16)
        assert got == want, sp_kw


# --- the JAX references, in one subprocess for the module -------------------

def jax_reference(kind, **kw):
    """Every interpret-mode reference of this module, by kind: "k1", "k3"
    (an entry of K1_PLAN_CASES / K3_PLAN_CASES), "decode" (a PATHS entry
    at one or two layers), "int8-proj" (run by `jax_results` in the
    subprocess)."""
    return {"k1": _jax_k1_plan, "k3": _jax_k3_plan, "decode": _jax_decode,
            "int8-proj": _jax_int8_proj}[kind](**kw)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    cases = {f"k1-{p}-{G}-{int(n)}": dict(kind="k1", plan=p, G=G, norm=n)
             for p, G, n in K1_PLAN_CASES}
    cases.update({f"k3-{p}-{G}-{r}": dict(kind="k3", plan=p, G=G, rows=r)
                  for p, G, r in K3_PLAN_CASES})
    cases.update({f"decode-{path}-{n}": dict(kind="decode", path=path,
                                             n_layers=n)
                  for path in PATHS for n in (1, 2)})
    cases["int8-proj"] = dict(kind="int8-proj")
    return jax_results(__file__, "jax_reference", cases,
                       tmp_path_factory.mktemp("jax_quant"))
