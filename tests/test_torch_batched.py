"""The port's batched token path against the JAX package on the CPU.

K1's rows form (B <= 16 rows, one kept set from the group score pooled
over the rows, the folded norm per row, `fixed`) in its plain version
against the JAX batched selection (`select_groups_batched`,
`batched_group_mask`) and the JAX gather kernel `block_gather_gemv_multi`
in interpret mode; then `forward` at B > 1 with the main-path config
(the batched token path) against the JAX whole-token kernel in interpret
mode, and `Generator(batch=3)` against the JAX Generator. fp32 logits and
caches within 2e-5, except where a test's docstring says otherwise.

The JAX interpret-mode references run in one subprocess for the module
(`jax_subprocess.jax_results`, `jax_reference` below), so a hang of the
interpreter fails these cases instead of stalling the run.
"""

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
from teal_tpu.ops import block_gemv as jbg
from teal_tpu.ops import quant as jq
from teal_tpu_torch.config import SparsityConfig, get_model_config
from teal_tpu_torch.engine import Generator
from teal_tpu_torch.models import llama
from teal_tpu_torch.ops import block_gemv as tbg
from teal_tpu_torch.ops import quant as tq

G = 128
TOL = dict(rtol=2e-5, atol=2e-5)
MAIN = dict(enabled=True, kernel="block", block_size=128,
            block_keep_frac=0.5, block_thresholding=True)
# the JAX package takes its token kernel on the CPU only when asked
JMAIN = dict(MAIN, fused_decode_attention=True)
# near the median group score of each stage's input (q=k=v, gate=up)
MAIN_TH = np.array([2.6, 2.6, 2.6, 0.12, 2.65, 2.65, 0.12], np.float32)
T = 16


def _np(t):
    return t.detach().cpu().float().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


# --- K1's rows form ----------------------------------------------------------

def _rows(rng, B, nb):
    """B rows whose group scores are distinct levels, so that pooled
    scores have no near tie."""
    x = rng.uniform(-0.5, 0.5, (B, nb, G)).astype(np.float32)
    for b in range(B):
        x[b, np.arange(nb), rng.integers(0, G, nb)] = \
            1.0 + 0.1 * rng.permutation(nb) + 0.013 * b
    return x.reshape(B, nb * G)


def _weights(rng, plan, L, K, ns):
    """Per weight: (port operand, JAX operand, int8 scale or None)."""
    out = []
    for n in ns:
        w = (rng.standard_normal((L, K, n)) * 0.1).astype(np.float32)
        if plan == "fp32":
            out.append((_t(w), jnp.asarray(w), None))
        elif plan == "int8":
            q8 = [jq.quantize_int8(jnp.asarray(m)) for m in w]
            q = np.stack([np.asarray(p.q) for p in q8])
            s = np.stack([np.asarray(p.scale) for p in q8])
            out.append((_t(q), jnp.asarray(q), s))
        else:
            packs = [jq.pack_int4(jq.quantize_int4(jnp.asarray(m), G))
                     for m in w]
            jw = {k: jnp.stack([p[k] for p in packs]) for k in ("qp", "sz")}
            out.append(({k: _t(np.asarray(v)) for k, v in jw.items()}, jw,
                        None))
    return out


def _jax_sums(xs, idx, jws, layer, cap):
    """fp32 sums of the JAX gather kernel (interpret mode) over the kept
    groups idx of every row of xs [B, K], 8 rows a call."""
    B, K = xs.shape
    k = len(idx)
    outs = []
    for r0 in range(0, B, 8):
        rows = xs[r0:r0 + 8]
        xpack = np.zeros((cap, 8, G), np.float32)
        xpack[:k, :len(rows)] = rows.reshape(len(rows), K // G, G)[:, idx] \
            .transpose(1, 0, 2)
        ipad = np.zeros(cap, np.int32)
        ipad[:k] = idx
        with pltpu.force_tpu_interpret_mode():
            ys = jbg.block_gather_gemv_multi(
                jnp.asarray(ipad), jnp.asarray(xpack), jws, G=G, k_keep=cap,
                out_dtype=jnp.float32, layer=layer, out_rows=len(rows))
        outs.append(np.concatenate([np.asarray(y) for y in ys], axis=1))
    return np.concatenate(outs)


ROWS_CASES = [
    (1, "fp32", "qkv", False), (3, "fp32", "qkv", False),
    (8, "fp32", "qkv", False), (12, "fp32", "qkv", False),
    (16, "fp32", "qkv", False), (12, "fp32", "res", False),
    (5, "fp32", "silu", False), (3, "int8", "silu", False),
    (12, "int8", "res", False), (3, "int4", "qkv", False),
    (12, "int4", "silu", False), (16, "fp32", "qkv", True),
    (3, "int8", "res", True)]
ROWS_L, ROWS_NB, ROWS_LAYER, ROWS_CAP = 2, 6, 1, 4


def _rows_inputs(B, plan, epilogue, fixed):
    """One rows case's inputs, from its seed: (x, gain, ws, xs, thr, idx,
    res, ns); idx is the JAX batched selection's kept set (`fixed`:
    groups 0..cap-1)."""
    rng = np.random.default_rng(100 * B + len(plan) + len(epilogue))
    L, nb, layer, cap = ROWS_L, ROWS_NB, ROWS_LAYER, ROWS_CAP
    K = nb * G
    ns = {"qkv": (256, 128, 128), "res": (256,), "silu": (128, 128)}[epilogue]
    norm = epilogue != "res"
    x = _rows(rng, B, nb) * 1.7
    gain = (1 + 0.1 * rng.standard_normal((L, K))).astype(np.float32)
    ws = _weights(rng, plan, L, K, ns)
    xs = (np.asarray(jllama.rms_norm(jnp.asarray(x), jnp.asarray(gain[layer]),
                                     1e-5)) if norm else x)
    pooled = np.abs(xs).reshape(B, nb, G).max(-1).max(0)
    thr = np.float32(np.sort(pooled)[1] + 1e-3)     # 4 survivors at cap 4
    if not fixed:
        mask = np.asarray(jbg.batched_group_mask(
            jnp.asarray(xs), G, cap, threshold=jnp.float32(thr)))[0]
        idx = np.nonzero(mask.reshape(nb, G)[:, 0])[0].astype(np.int32)
    else:
        idx = np.arange(cap, dtype=np.int32)
    res = (rng.standard_normal((B, sum(ns))).astype(np.float32)
           if epilogue == "res" else None)
    return x, gain, ws, xs, thr, idx, res, ns


@pytest.mark.parametrize("B,plan,epilogue,fixed", ROWS_CASES)
def test_k1_rows_match_jax(B, plan, epilogue, fixed, jax_refs):
    """K1's plain version with B rows: the kept set is the JAX batched
    selection's on the per-row folded norm (pooled max over rows, the
    unified threshold + cap rule; `fixed`: groups 0..cap-1), and the
    outputs are the JAX gather kernel's fp32 sums over it with the
    epilogue (int8 scale, residual or silu) applied in fp32, within 1e-5
    of scale (another summation order)."""
    L, nb, layer, cap = ROWS_L, ROWS_NB, ROWS_LAYER, ROWS_CAP
    norm = epilogue != "res"
    x, gain, ws, xs, thr, idx, res, ns = _rows_inputs(B, plan, epilogue,
                                                      fixed)
    if not fixed and B <= 8:
        jidx, _ = jbg.select_groups_batched(jnp.asarray(xs), G, cap,
                                            threshold=jnp.float32(thr))
        np.testing.assert_array_equal(idx, np.asarray(jidx)[:len(idx)])
    scales = ([_t(s) for _, _, s in ws] if plan == "int8" else None)
    xt = _t(x if B > 1 else x[0])
    got, gidx, gcnt = tbg.select_gather_gemv(
        xt, torch.tensor(thr), [w for w, _, _ in ws], layer, cap, G=G,
        norm=_t(gain) if norm else None, silu=epilogue == "silu",
        res=None if res is None else _t(res if B > 1 else res[0]),
        scales=scales, fixed=fixed)
    assert int(gcnt[0]) == len(idx)
    np.testing.assert_array_equal(_np(gidx)[:len(idx)], idx)
    assert (_np(gidx)[len(idx):] == -1).all()
    acc = jax_refs[_rows_key(B, plan, epilogue, fixed)]["acc"]
    accs = np.split(acc, np.cumsum(ns)[:-1], axis=1)
    if plan == "int8":
        accs = [a * s[layer] for a, (_, _, s) in zip(accs, ws)]
    if epilogue == "silu":
        g, u = accs
        want = g * (1.0 / (1.0 + np.exp(-g))) * u
    elif epilogue == "res":
        want = accs[0] + res
    else:
        want = np.concatenate(accs, axis=1)
    assert tuple(got.shape) == ((B,) if B > 1 else ()) + (want.shape[1],)
    _close(_np(got).reshape(want.shape), want, 1e-5)


def test_k1_rows_checks():
    """The rows form takes at most 16 rows, at G = 128 only, and a
    residual of the output's shape."""
    w = torch.zeros(1, 256, 32)
    thr = torch.tensor(0.0)
    for x, kw in ((torch.zeros(17, 256), {}),
                  (torch.zeros(2, 256), dict(G=32)),
                  (torch.zeros(2, 256), dict(res=torch.zeros(32))),
                  (torch.zeros(2, 2, 256), {})):
        with pytest.raises(ValueError):
            tbg.select_gather_gemv(x, thr, [w], 0, 1, **kw)
    out, _, _ = tbg.select_gather_gemv(torch.ones(2, 256), thr, [w], 0, 1,
                                       res=torch.ones(2, 32))
    assert out.shape == (2, 32)


# --- the batched token path ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model(n_layers, n_kv_heads, seed=7):
    kw = dict(n_layers=n_layers, n_heads=2, n_kv_heads=n_kv_heads, dim=256,
              intermediate_size=384, vocab_size=128)
    cfg, jcfg = get_model_config("tiny", **kw), jget_model_config("tiny", **kw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    params = llama.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return cfg, jcfg, params, jparams


def _cache(cfg, B, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, B, cfg.n_kv_heads, T, 128)
    return (rng.standard_normal(shape).astype(np.float32) * 0.1,
            rng.standard_normal(shape).astype(np.float32) * 0.1)


def _decode_inputs(name):
    """A batched decode case's inputs, from its seeds: (cfg, jcfg, params,
    jparams, toks [B, 1], pos [B], th, k, v, dtype); "gqa" / "mha": B = 3
    at [2, 9, 14]; "b12": B = 12 at random positions; "int8" / "int4":
    the quantized copies of a one-layer bf16 model at B = 3."""
    if name in ("int8", "int4"):
        kw = dict(n_layers=1, n_heads=2, n_kv_heads=1, dim=256,
                  intermediate_size=384, vocab_size=128)
        cfg = get_model_config("tiny", **kw)
        jcfg = jget_model_config("tiny", **kw)
        jp = jllama.init_params(jcfg, jax.random.PRNGKey(41), jnp.bfloat16)
        params = {"int8": _q8, "int4": _q4}[name](llama.params_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu",
            dtype=torch.bfloat16))
        rng = np.random.default_rng(9)
        shape = (1, 3, 1, T, 128)
        k, v = (np.asarray(jnp.asarray(rng.standard_normal(shape) * 0.1,
                                       jnp.bfloat16), np.float32)
                for _ in range(2))
        return (cfg, jcfg, params, _to_jax(params), np.array([[3], [7], [11]]),
                [2, 9, 14], np.tile(MAIN_TH, (1, 1)), k, v, "bf16")
    if name == "b12":
        cfg, jcfg, params, jparams = _model(2, 2)
        rng = np.random.default_rng(7)
        pos = rng.integers(1, 15, 12)
        toks = rng.integers(1, 120, (12, 1))
        k, v = _cache(cfg, 12, 43)
    else:
        n_kv_heads = {"gqa": 1, "mha": 2}[name]
        cfg, jcfg, params, jparams = _model(2, n_kv_heads)
        pos, toks = [2, 9, 14], np.array([[3], [7], [11]])
        k, v = _cache(cfg, 3, 11 + n_kv_heads)
    return (cfg, jcfg, params, jparams, toks, pos,
            np.tile(MAIN_TH, (cfg.n_layers, 1)), k, v, None)


def _jax_decode(name):
    """The JAX forward of a decode case through the batched whole-token
    kernel in interpret mode: logits and both caches (run by
    `jax_results` in the subprocess)."""
    _, jcfg, _, jparams, toks, pos, th, k, v, dtype = _decode_inputs(name)
    jdt = jnp.float32 if dtype is None else jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        want, wc = jllama.forward(
            jparams, jnp.asarray(toks, jnp.int32),
            jllama.KVCache(jnp.asarray(k, jdt), jnp.asarray(v, jdt)),
            jnp.asarray(pos, jnp.int32), jnp.asarray(th), cfg=jcfg,
            sp=JSparsityConfig(**JMAIN))
    return {"logits": np.asarray(want, np.float32),
            "k": np.asarray(wc.k, np.float32),
            "v": np.asarray(wc.v, np.float32)}


def _both(name, jax_refs):
    """(port, JAX) decode of a case's toks [B, 1] at positions pos [B]:
    logits and both caches, the JAX token kernel's from `jax_refs`."""
    cfg, _, params, _, toks, pos, th, k, v, dtype = _decode_inputs(name)
    tdt = torch.float32 if dtype is None else torch.bfloat16
    sp = SparsityConfig(**MAIN)
    B = len(pos)
    assert llama.can_token_decode(params, cfg, sp, 1, B, tdt)
    cache = llama.KVCache.from_numpy(k, v, device="cpu", dtype=tdt)
    got, cache = llama.forward(params, torch.from_numpy(toks).long(), cache,
                               list(pos), torch.from_numpy(th), cfg=cfg,
                               sp=sp)
    want = jax_refs[f"decode-{name}"]
    return ((_np(got), want["logits"]), (_np(cache.k), want["k"]),
            (_np(cache.v), want["v"]))


@pytest.mark.parametrize("n_kv_heads", [1, 2], ids=["gqa", "mha"])
def test_batched_token_path_matches_jax_token_kernel(n_kv_heads, jax_refs):
    """B = 3 at positions [2, 9, 14] with nonzero thresholds: `forward`
    (the batched token path, plain K1/K2) == the JAX forward through the
    batched whole-token kernel, in logits and both caches."""
    name = {1: "gqa", 2: "mha"}[n_kv_heads]
    for got, want in _both(name, jax_refs):
        np.testing.assert_allclose(got, want, **TOL)


def test_b12_two_row_tiles_match_jax_token_kernel(jax_refs):
    """B = 12 (the reference's two sublane tiles) at random positions with
    nonzero thresholds == the JAX whole-token kernel."""
    for got, want in _both("b12", jax_refs):
        np.testing.assert_allclose(got, want, **TOL)


def test_b12_zero_thresholds_match_per_sequence_decode():
    """With zero thresholds the capacity rule keeps the first `cap` groups
    for any pooling, so per-sequence batch-1 forwards of the port are an
    exact reference for the 12-row mechanics (`tests/test_kernels.py::
    test_token_kernel_b16_single_launch_equivalence`)."""
    cfg, _, params, _ = _model(2, 2)
    rng = np.random.default_rng(8)
    B = 12
    pos = rng.integers(1, 15, B)
    toks = torch.from_numpy(rng.integers(1, 120, (B, 1)))
    th = torch.zeros(cfg.n_layers, 7)
    sp = SparsityConfig(**MAIN)
    k, v = _cache(cfg, B, 44)
    cache = llama.KVCache.from_numpy(k, v, device="cpu")
    got, cache = llama.forward(params, toks, cache, pos, th, cfg=cfg, sp=sp)
    for b in range(B):
        sub = llama.KVCache.from_numpy(k[:, b:b + 1], v[:, b:b + 1],
                                       device="cpu")
        want, sub = llama.forward(params, toks[b:b + 1], sub, int(pos[b]), th,
                                  cfg=cfg, sp=sp)
        np.testing.assert_allclose(_np(got[b]), _np(want[0]), **TOL)
        np.testing.assert_allclose(_np(cache.k[:, b]), _np(sub.k[:, 0]),
                                   **TOL)
        np.testing.assert_allclose(_np(cache.v[:, b]), _np(sub.v[:, 0]),
                                   **TOL)


def _q8(p):
    return tq.quantize_params_int8(p)


def _q4(p):
    return tq.pack_int4_params(tq.quantize_params_int4(p, 128), 128)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.float().numpy(), jnp.bfloat16)
    return jnp.asarray(tree.numpy())


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_quantized_batched_token_path_matches_jax(quantize, jax_refs):
    """int8 and packed int4 (G = 128) at B = 3, positions [2, 9, 14], one
    layer, bf16 (the quantized paths' compute type): logits and caches
    within 2^-7 of scale of the JAX batched whole-token kernel (bf16
    rounds at the same points in another summation order, as in
    `tests/test_torch_quant.py`; the JAX suite's own int8/int4 batched
    checks, `tests/test_kernels.py:1090` and `:1130`, allow 5e-2)."""
    for got, want in _both(quantize, jax_refs):
        _close(got, want, 2 ** -7)


GEN_PROMPT = np.array([[3, 17, 42, 8, 99], [5, 1, 7, 2, 9],
                       [60, 61, 62, 63, 64]], np.int64)


def _jax_generate():
    """The JAX Generator (batch 3) through its batched whole-token kernel
    in interpret mode (run by `jax_results` in the subprocess)."""
    _, jcfg, _, jparams = _model(2, 1)
    th = np.tile(MAIN_TH, (jcfg.n_layers, 1))
    jgen = JGenerator(jcfg, jparams, sp=JSparsityConfig(**JMAIN), max_seq=T,
                      batch=3, cache_dtype=jnp.float32, temperature=0.0)
    with pltpu.force_tpu_interpret_mode():
        want, _ = jgen.generate(GEN_PROMPT, 5, thresholds=jnp.asarray(th))
    return {"tokens": np.asarray(want)}


def test_batched_generator_matches_jax(jax_refs):
    """`Generator(batch=3)` with the main-path config (dense prefill, then
    the batched token path every step) == the JAX Generator through its
    batched whole-token kernel, token for token (greedy, fp32)."""
    cfg, _, params, _ = _model(2, 1)
    th = np.tile(MAIN_TH, (cfg.n_layers, 1))
    gen = Generator(cfg, params, sp=SparsityConfig(**MAIN), max_seq=T,
                    batch=3, cache_dtype=torch.float32, temperature=0.0,
                    device="cpu")
    got, stats = gen.generate(GEN_PROMPT, 5, thresholds=torch.from_numpy(th))
    np.testing.assert_array_equal(got, jax_refs["generate"]["tokens"])
    assert stats.new_tokens == 5


# --- the JAX references, in one subprocess for the module -------------------

DECODE_NAMES = ("gqa", "mha", "b12", "int8", "int4")


def _rows_key(B, plan, epilogue, fixed):
    return f"rows-{B}-{plan}-{epilogue}-{int(fixed)}"


def jax_reference(kind, **kw):
    """Every interpret-mode reference of this module, by kind: "rows"
    (the JAX gather kernel's sums of a rows case), "decode" (a batched
    decode case), "generate" (run by `jax_results` in the subprocess)."""
    if kind == "rows":
        _, _, ws, xs, _, idx, _, _ = _rows_inputs(**kw)
        return {"acc": _jax_sums(xs, idx, [jw for _, jw, _ in ws],
                                 ROWS_LAYER, ROWS_CAP)}
    if kind == "decode":
        return _jax_decode(**kw)
    return _jax_generate()


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    cases = {_rows_key(*c): dict(kind="rows", B=c[0], plan=c[1],
                                 epilogue=c[2], fixed=c[3])
             for c in ROWS_CASES}
    cases.update({f"decode-{n}": dict(kind="decode", name=n)
                  for n in DECODE_NAMES})
    cases["generate"] = dict(kind="generate")
    return jax_results(__file__, "jax_reference", cases,
                       tmp_path_factory.mktemp("jax_batched"))
