"""K7's route, plan and plain version on the CPU.

K7 (`ops/token_block.token_kernel`, `csrc/token_decode.cu`) decodes one
token through every layer in one launch, the counterpart of the JAX
package's whole-token kernel `_token_kernel`; with `token_fused=False`
the port keeps the K1/K2 loop, the counterpart of `_packed_layer`. Here:
  - the route: K7 exactly for its form (batch 1 or 2-16 rows, arrays of
    the stream type or int8 / int4 at group 128; seq_block rows of one
    sequence; Mixtral at one row with arrays or int8 experts; head_dim
    128, token_fused not False) where it has a launch plan, from the
    shapes alone;
  - `_token_plan` at Llama-2-7B, Mistral-7B (GQA 32/8, window 4096) and
    the tiny configs, for 132 SMs, at one row and in the rows form; no
    plan depends on T, and every head_dim-128 dense config of the
    registry plans at its max_seq_len;
  - the port's forward (K7's plain version on CPU tensors) against the
    JAX `_token_kernel` in interpret mode, and with token_fused=False (the
    loop) against the JAX `_packed_layer`: fp32 within 2e-5 (as
    test_torch_model.py), bf16 within 2e-2 of the logits' largest value
    (the two frameworks round the bf16 stream at the same points but may
    sum in other orders: a bf16 ulp is 2^-8 of a value); GQA, MHA, a
    window with pos past it, `fixed_sel`; and at B = 2, 8 and 16 rows,
    each at its own position, through K7's rows route against the JAX
    `_token_kernel` with `batch` = B, with arrays and with int8 (B = 2,
    16) and packed-int4 (B = 8) weights, these within 2^-7 of scale (the
    bound of a quantized bf16 layer, as test_torch_batched.py). The bf16
    cases select at threshold 0, where every group survives and the first
    `cap` are kept, so that a one-ulp score difference cannot flip a
    group.
All JAX cases run in one child process (`jax_subprocess.jax_results`)."""

import dataclasses

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
from teal_tpu_torch.config import (MODEL_REGISTRY, SparsityConfig,
                                   get_model_config)
from teal_tpu_torch.models import llama
from teal_tpu_torch.ops import quant
from teal_tpu_torch.ops import token_block as tb

GQA = dict(n_layers=3, n_heads=2, n_kv_heads=1, dim=256,
           intermediate_size=384, vocab_size=128)
MHA = dict(GQA, n_kv_heads=2)
WINDOW = dict(GQA, sliding_window=4)
MAIN = dict(enabled=True, kernel="block", block_size=128,
            block_keep_frac=0.5, block_thresholding=True)
TOL = dict(rtol=2e-5, atol=2e-5)
BF16_REL = 2e-2
T = 16

# case: (config overrides, dtype, pos, token_fused, fixed selection)
CASES = {
    "gqa-p0": (GQA, "float32", 0, None, False),
    "gqa-p9": (GQA, "float32", 9, None, False),
    "mha-p5": (MHA, "float32", 5, None, False),
    "window-p14": (WINDOW, "float32", 14, None, False),
    "fixed-p7": (GQA, "float32", 7, None, True),
    "bf16-gqa-p6": (GQA, "bfloat16", 6, None, False),
    "bf16-window-p13": (WINDOW, "bfloat16", 13, None, False),
    "packed-gqa-p9": (GQA, "float32", 9, False, False),
    "packed-mha-p5": (MHA, "float32", 5, False, False),
}

# rows cases, the port through K7's rows route (its plain version):
# (config overrides, dtype, positions of the rows); each row at its own
# position, its own cache row
ROW_CASES = {
    "rows2-gqa": (GQA, "float32", (9, 4)),
    "rows8-mha": (MHA, "float32", (0, 3, 5, 7, 9, 11, 13, 15)),
    "rows16-window": (WINDOW, "float32", tuple((3 * i + 1) % 16
                                               for i in range(16))),
    "bf16-rows16-gqa": (GQA, "bfloat16", tuple((5 * i + 2) % 16
                                               for i in range(16))),
    "bf16-rows8-window": (WINDOW, "bfloat16", (14, 2, 6, 10, 13, 5, 9, 1)),
    "bf16-rows2-mha": (MHA, "bfloat16", (15, 7)),
    # int8 and packed int4 (group 128) copies of the bf16 weights, a bf16
    # stream and cache
    "int8-rows2-gqa": (GQA, "int8", (11, 3)),
    "int8-rows16-window": (WINDOW, "int8", tuple((7 * i + 3) % 16
                                                 for i in range(16))),
    "int4-rows8-window": (WINDOW, "int4", (13, 1, 6, 9, 15, 4, 10, 2)),
}
QUANT_REL = 2 ** -7


def _thresholds(cfg_kw, dtype):
    """Per-layer group thresholds near each stage's median group score
    (fp32), or 0 (bf16, int8, int4: every group survives, the first cap
    kept)."""
    L = cfg_kw["n_layers"]
    if dtype != "float32":
        return np.zeros((L, 7), np.float32)
    base = np.array([2.6, 2.6, 2.6, 0.12, 2.65, 2.65, 0.12], np.float32)
    return (base[None] * (1 + 0.03 * np.arange(L)[:, None])).astype(
        np.float32)


def _inputs(case):
    cfg_kw, dtype, pos, fused, fixed = CASES[case]
    rng = np.random.default_rng(len(case) * 7 + pos)
    shape = (cfg_kw["n_layers"], 1, cfg_kw["n_kv_heads"], T, 128)
    k = rng.standard_normal(shape).astype(np.float32) * 0.1
    v = rng.standard_normal(shape).astype(np.float32) * 0.1
    return cfg_kw, dtype, pos, fused, fixed, k, v, 3 + pos


def _sp(fused, fixed):
    return dict(MAIN, debug_fixed_selection=fixed,
                **({} if fused is None else dict(token_fused=fused)))


def _row_inputs(case):
    cfg_kw, dtype, pos = ROW_CASES[case]
    B = len(pos)
    rng = np.random.default_rng(len(case) * 11 + B)
    shape = (cfg_kw["n_layers"], B, cfg_kw["n_kv_heads"], T, 128)
    k = rng.standard_normal(shape).astype(np.float32) * 0.1
    v = rng.standard_normal(shape).astype(np.float32) * 0.1
    toks = rng.integers(1, 120, (B, 1))
    return cfg_kw, dtype, list(pos), k, v, toks


def _to_jax(tree):
    """A port params tree (CPU tensors) as JAX arrays of the same types."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.float().numpy(), jnp.bfloat16)
    return jnp.asarray(tree.numpy())


def jax_rows_case(case):
    """JAX's forward at a rows case in interpret mode: the whole-token
    kernel with `batch` = B (int8 and int4: the port's quantized copy of
    the bf16 weights, carried across)."""
    cfg_kw, dtype, pos, k, v, toks = _row_inputs(case)
    jcfg = jget_model_config("tiny", **cfg_kw)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    params = jllama.init_params(jcfg, jax.random.PRNGKey(7), jnp.float32)
    params = jax.tree.map(lambda a: a.astype(jdt), params)
    if dtype in ("int8", "int4"):
        params = _to_jax(_port_params(cfg_kw, dtype))
    with pltpu.force_tpu_interpret_mode():
        logits, cache = jllama.forward(
            params, jnp.asarray(toks, jnp.int32),
            jllama.KVCache(jnp.asarray(k, jdt), jnp.asarray(v, jdt)),
            jnp.asarray(pos, jnp.int32),
            jnp.asarray(_thresholds(cfg_kw, dtype)), cfg=jcfg,
            sp=JSparsityConfig(**MAIN, fused_decode_attention=True))
    return dict(logits=np.asarray(logits, np.float32),
                k=np.asarray(cache.k.astype(jnp.float32)),
                v=np.asarray(cache.v.astype(jnp.float32)))


def jax_token_case(case):
    """JAX's forward at one case, in interpret mode: the whole-token kernel
    (token_fused unset) or the packed pipeline (token_fused False); a
    rows case through `jax_rows_case`. Run by `jax_results` in the
    subprocess."""
    if case in ROW_CASES:
        return jax_rows_case(case)
    cfg_kw, dtype, pos, fused, fixed, k, v, tok = _inputs(case)
    jcfg = jget_model_config("tiny", **cfg_kw)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    params = jllama.init_params(jcfg, jax.random.PRNGKey(7), jnp.float32)
    params = jax.tree.map(lambda a: a.astype(jdt), params)
    with pltpu.force_tpu_interpret_mode():
        logits, cache = jllama.forward(
            params, jnp.asarray([[tok]], jnp.int32),
            jllama.KVCache(jnp.asarray(k, jdt), jnp.asarray(v, jdt)), pos,
            jnp.asarray(_thresholds(cfg_kw, dtype)), cfg=jcfg,
            sp=JSparsityConfig(**_sp(fused, fixed),
                               fused_decode_attention=True))
    return dict(logits=np.asarray(logits, np.float32),
                k=np.asarray(cache.k.astype(jnp.float32)),
                v=np.asarray(cache.v.astype(jnp.float32)))


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    return jax_results(__file__, "jax_token_case",
                       {c: dict(case=c) for c in (*CASES, *ROW_CASES)},
                       tmp_path_factory.mktemp("jax_token_kernel"))


def _port_params(cfg_kw, dtype):
    """The port's params of JAX's seed-7 weights in dtype, or (dtype
    "int8" / "int4") their bf16 copy quantized by the port's `quant`."""
    jcfg = jget_model_config("tiny", **cfg_kw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(7), jnp.float32)
    q = dtype if dtype in ("int8", "int4") else None
    params = llama.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu",
                                     dtype=torch.bfloat16 if q else dtype)
    if q == "int8":
        return quant.quantize_params_int8(params)
    if q == "int4":
        return quant.pack_int4_params(quant.quantize_params_int4(params, 128),
                                      128)
    return params


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax(jax_refs, monkeypatch, case):
    """The port's forward at batch 1 on each case against JAX's: through
    K7's plain version (`token_kernel_plain`) where token_fused is unset,
    through the K1/K2 loop where it is False; logits and both caches."""
    cfg_kw, dtype, pos, fused, fixed, k, v, tok = _inputs(case)
    dt = getattr(torch, dtype)
    cfg = get_model_config("tiny", **cfg_kw)
    params = _port_params(cfg_kw, dt)
    cache = llama.KVCache.from_numpy(k, v, device="cpu", dtype=dt)
    calls = []
    plain = tb.token_kernel_plain
    monkeypatch.setattr(tb, "token_kernel_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    sp = SparsityConfig(**_sp(fused, fixed))
    assert llama.can_token_decode(params, cfg, sp, 1, 1, dt)
    logits, cache = llama.forward(
        params, torch.tensor([[tok]]), cache, pos,
        torch.from_numpy(_thresholds(cfg_kw, dtype)), cfg=cfg, sp=sp)
    assert len(calls) == (0 if fused is False else 1)
    want = jax_refs[case]
    got = (logits.float().numpy(), cache.k.float().numpy(),
           cache.v.float().numpy())
    for g, name in zip(got, ("logits", "k", "v")):
        w = want[name]
        if dtype == "float32":
            np.testing.assert_allclose(g, w, **TOL, err_msg=name)
        else:
            err = np.abs(g - w).max()
            assert err <= BF16_REL * np.abs(w).max(), (name, err)
    if fixed:   # the fixed selection is not the threshold selection
        free, _ = llama.forward(
            params, torch.tensor([[tok]]),
            llama.KVCache.from_numpy(k, v, device="cpu", dtype=dt), pos,
            torch.from_numpy(_thresholds(cfg_kw, dtype)), cfg=cfg,
            sp=SparsityConfig(**_sp(fused, False)))
        assert np.abs(free.numpy() - got[0]).max() > 1e-3


@pytest.mark.parametrize("case", list(ROW_CASES))
def test_rows_plain_matches_jax(jax_refs, monkeypatch, case):
    """The port's forward at B = 2, 8 and 16 rows, each at its own
    position: one K7 call (its rows form; on the CPU its plain version
    `token_kernel_plain`) and no K1/K2 loop, against JAX's forward through
    `_token_kernel` with `batch` = B; logits and both caches, fp32 within
    2e-5, bf16 (threshold 0) within 2e-2 of the largest value, int8 and
    packed int4 (threshold 0, a bf16 stream) within 2^-7 of it."""
    cfg_kw, dtype, pos, k, v, toks = _row_inputs(case)
    quantized = dtype in ("int8", "int4")
    dt = torch.bfloat16 if quantized else getattr(torch, dtype)
    cfg = get_model_config("tiny", **cfg_kw)
    params = _port_params(cfg_kw, dtype if quantized else dt)
    cache = llama.KVCache.from_numpy(k, v, device="cpu", dtype=dt)
    calls = {"k7": 0, "plain": 0, "loop": 0}
    kernel, plain, layer = tb.token_kernel, tb.token_kernel_plain, \
        tb.layer_decode

    def spy(name, f):
        def g(*a, **kw):
            calls[name] += 1
            return f(*a, **kw)
        return g
    monkeypatch.setattr(tb, "token_kernel", spy("k7", kernel))
    monkeypatch.setattr(tb, "token_kernel_plain", spy("plain", plain))
    monkeypatch.setattr(tb, "layer_decode", spy("loop", layer))
    sp = SparsityConfig(**MAIN)
    logits, cache = llama.forward(
        params, torch.from_numpy(toks), cache, pos,
        torch.from_numpy(_thresholds(cfg_kw, dtype)), cfg=cfg, sp=sp)
    assert calls == {"k7": 1, "plain": 1, "loop": 0}
    want = jax_refs[case]
    got = (logits.float().numpy(), cache.k.float().numpy(),
           cache.v.float().numpy())
    for g, name in zip(got, ("logits", "k", "v")):
        w = want[name]
        if dtype == "float32":
            np.testing.assert_allclose(g, w, **TOL, err_msg=name)
        else:
            err = np.abs(g - w).max()
            rel = QUANT_REL if quantized else BF16_REL
            assert err <= rel * np.abs(w).max(), (name, err)


# --- the route -----------------------------------------------------------

MOE = dict(n_layers=2, n_heads=2, n_kv_heads=2, dim=256,
           intermediate_size=384, vocab_size=128, n_experts=4,
           n_experts_per_tok=2)
ROUTES = {
    # case: (config overrides, params, batch, SparsityConfig overrides,
    # route): "k7" one K7 launch, "loop" the K1/K2 loop (`layer_decode`),
    # "layers" the model's layer loop (`can_token_decode` refuses), "raises"
    # a ValueError. The cases named loop-int8 and loop-int4 keep their
    # names from before K7 took the quantized plans: all seven int8, or
    # all seven packed int4 at quant group 128, now take K7 like arrays.
    "k7": (GQA, "float32", 1, {}, "k7"),
    "k7-token-fused-true": (GQA, "float32", 1, dict(token_fused=True), "k7"),
    "k7-bf16": (GQA, "bfloat16", 1, {}, "k7"),
    "k7-window": (WINDOW, "float32", 1, {}, "k7"),
    "loop-token-fused-false": (GQA, "float32", 1, dict(token_fused=False),
                               "loop"),
    "loop-int8": (GQA, "int8", 1, {}, "k7"),
    "loop-int4": (GQA, "int4", 1, {}, "k7"),
    "k7-int8-token-fused-true": (GQA, "int8", 1, dict(token_fused=True),
                                 "k7"),
    "k7-int4-window": (WINDOW, "int4", 1, {}, "k7"),
    # int8 with token_fused False: only the whole-token kernel applies
    # int8 scales in the reference, so the model's layer loop runs it
    "layers-int8-token-fused-false": (GQA, "int8", 1,
                                      dict(token_fused=False), "layers"),
    "loop-int4-token-fused-false": (GQA, "int4", 1, dict(token_fused=False),
                                    "loop"),
    # int8 beside one array projection: the token path refuses the mix
    "raises-int8-mixed": (GQA, "int8-mixed", 1, {}, "raises"),
    # int4 at quant group 64 (packed at block size 32): at block size 64
    # the layer loop, at 128 the K1/K2 loop refuses the groups
    "layers-int4-g64": (GQA, "int4-g64", 1, dict(block_size=64), "layers"),
    "raises-int4-g64-main": (GQA, "int4-g64", 1, {}, "raises"),
    # rows: K7's rows form, of arrays, all-int8 and packed int4 (the
    # cases named loop-rows* keep their names from before K7 took them);
    # rows with token_fused False the model's layer loop, as in the
    # reference (its rows are the whole-token kernel's alone)
    "loop-rows": (GQA, "float32", 2, {}, "k7"),
    "k7-rows16-bf16-window": (WINDOW, "bfloat16", 16, {}, "k7"),
    "layers-rows-token-fused-false": (GQA, "float32", 2,
                                      dict(token_fused=False), "layers"),
    "loop-rows-int8": (GQA, "int8", 2, {}, "k7"),
    "loop-rows-int4": (GQA, "int4", 8, {}, "k7"),
    "k7-rows16-int8-window": (WINDOW, "int8", 16, {}, "k7"),
    "layers-rows-int4-token-fused-false": (GQA, "int4", 8,
                                           dict(token_fused=False), "layers"),
    # Mixtral at one row: K7's MoE form for arrays and int8 experts (the
    # case named loop-moe keeps its name from before K7 took it); with
    # token_fused False, or two rows, the model's layer loop, as in the
    # reference (its MoE decode is the whole-token kernel's alone)
    "loop-moe": (MOE, "float32", 1, {}, "k7"),
    "k7-moe-bf16": (MOE, "bfloat16", 1, {}, "k7"),
    "k7-moe-int8": (MOE, "int8", 1, {}, "k7"),
    "layers-moe-token-fused-false": (MOE, "float32", 1,
                                     dict(token_fused=False), "layers"),
    "layers-moe-int8-token-fused-false": (MOE, "int8", 1,
                                          dict(token_fused=False), "layers"),
    "layers-moe-rows": (MOE, "float32", 2, {}, "layers"),
}


def _route_params(cfg, kind):
    """Random params of a ROUTES kind: fp32 or bf16 arrays, int8, packed
    int4 at quant group 128 (packed at block size 128) or 64 (at block
    size 32), or int8 with wq left a bf16 array."""
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.float32 if kind == "float32"
                               else torch.bfloat16, device="cpu")
    if kind.startswith("int8"):
        q = quant.quantize_params_int8(params)
        if kind == "int8-mixed":
            q["layers"]["wq"] = params["layers"]["wq"]
        return q
    if kind == "int4":
        return quant.pack_int4_params(quant.quantize_params_int4(params, 128),
                                      128)
    if kind == "int4-g64":
        return quant.pack_int4_params(quant.quantize_params_int4(params, 64),
                                      32)
    return params


@pytest.mark.parametrize("case", list(ROUTES))
def test_route(monkeypatch, case):
    """`llama.forward` at one decode position takes K7 (its wrapper,
    `token_kernel`) exactly for K7's form with token_fused not False
    (arrays, all seven int8, all seven packed int4 at quant group 128;
    one row or 2-16 rows; Mixtral at one row with arrays or int8
    experts), the K1/K2 loop (`layer_decode`) for token_fused False at one
    row, the model's layer loop where `can_token_decode` refuses, and raises
    where the token path refuses the weights; the route is decided by the
    form alone."""
    cfg_kw, kind, b, sp_kw, route = ROUTES[case]
    cfg = get_model_config("tiny", **cfg_kw)
    dt = torch.float32 if kind == "float32" else torch.bfloat16
    params = _route_params(cfg, kind)
    calls = {"k7": 0, "loop": 0, "layers": 0}
    kernel, layer, block = tb.token_kernel, tb.layer_decode, \
        llama.layer_forward

    def spy(name, f):
        def g(*a, **kw):
            calls[name] += 1
            return f(*a, **kw)
        return g
    monkeypatch.setattr(tb, "token_kernel", spy("k7", kernel))
    monkeypatch.setattr(tb, "layer_decode", spy("loop", layer))
    monkeypatch.setattr(llama, "layer_forward", spy("layers", block))
    sp = SparsityConfig(**dict(MAIN, **sp_kw))
    cache = llama.KVCache.init(cfg, b, T, dt, "cpu")
    assert llama.can_token_decode(params, cfg, sp, 1, b, dt) == (
        route != "layers")
    th = torch.zeros((cfg.n_layers, 7))
    args = (params, torch.full((b, 1), 3), cache,
            [4 + i % 9 for i in range(b)] if b > 1 else 4, th)
    if route == "raises":
        with pytest.raises(ValueError):
            llama.forward(*args, cfg=cfg, sp=sp)
        assert calls["k7"] == 0
        return
    logits, _ = llama.forward(*args, cfg=cfg, sp=sp)
    assert torch.isfinite(logits).all()
    want = {"k7": 0, "loop": 0, "layers": 0}
    want[route] = 1 if route == "k7" else cfg.n_layers
    assert calls == want


def test_route_seq_block_takes_the_loop(monkeypatch):
    """`token_decode` with seq_block (the verify path's rows: consecutive
    positions of one sequence in cache row 0) takes K7's seq_block form
    where token_fused is not False, and the K1/K2 loop with token_fused
    False; both write the same cache and return the same rows. K7's
    seq_block form needs a cache of one row."""
    cfg = get_model_config("tiny", **GQA)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.float32, device="cpu")
    lay = params["layers"]
    calls = {"k7": 0, "loop": 0}
    kernel, layer = tb.token_kernel, tb.layer_decode

    def spy(name, f):
        def g(*a, **kw):
            calls[name] += 1
            return f(*a, **kw)
        return g
    monkeypatch.setattr(tb, "token_kernel", spy("k7", kernel))
    monkeypatch.setattr(tb, "layer_decode", spy("loop", layer))
    ws = tuple(lay[n] for n in ("wq", "wk", "wv", "wo", "wgate", "wup",
                                "wdown"))
    cos, sin = llama.precompute_rope(cfg, T, "cpu")
    pos = torch.tensor([4, 5], dtype=torch.int32)
    h = params["embed"][torch.tensor([3, 4])]
    outs, caches = [], []
    for fused in (None, False):
        cache = llama.KVCache.init(cfg, 1, T, torch.float32, "cpu")
        outs.append(tb.token_decode(
            h, torch.zeros((cfg.n_layers, 7)), ws, lay["attn_norm"],
            lay["mlp_norm"], llama._rope_rows(cos, sin, pos), cache.k,
            cache.v, pos, caps=(2, 2, 2, 3), n_heads=cfg.n_heads,
            fixed_sel=True, seq_block=True, token_fused=fused))
        caches.append(cache)
    assert calls == {"k7": 1, "loop": cfg.n_layers}
    assert outs[0].shape == h.shape
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(caches[0].k, caches[1].k)
    assert torch.equal(caches[0].v, caches[1].v)
    assert tb.k7_form(h, ws, caches[0].k, cfg.n_heads, seq_block=True)
    two = llama.KVCache.init(cfg, 2, T, torch.float32, "cpu")
    assert not tb.k7_form(h, ws, two.k, cfg.n_heads, seq_block=True)


def test_block_verify_takes_the_loop(monkeypatch):
    """`block_verify` (the speculative verify: S consecutive positions of
    one sequence, `seq_block`) takes K7's seq_block form once a chunk (S
    = 4: one chunk, S = 12: two) and never the K1/K2 loop."""
    cfg = get_model_config("tiny", **GQA)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.float32, device="cpu")
    calls = {"k7": 0, "loop": 0}
    kernel, layer = tb.token_kernel, tb.layer_decode

    def spy(name, f):
        def g(*a, **kw):
            calls[name] += 1
            return f(*a, **kw)
        return g
    monkeypatch.setattr(tb, "token_kernel", spy("k7", kernel))
    monkeypatch.setattr(tb, "layer_decode", spy("loop", layer))
    for toks, chunks in (([3, 5, 7, 9], 1), (list(range(3, 15)), 2)):
        calls.update(k7=0, loop=0)
        cache = llama.KVCache.init(cfg, 1, T, torch.float32, "cpu")
        logits, _ = llama.block_verify(
            params, torch.tensor([toks]), cache, 2,
            torch.zeros((cfg.n_layers, 7)), cfg=cfg)
        assert torch.isfinite(logits).all()
        assert calls == {"k7": chunks, "loop": 0}


def test_k7_raises_rather_than_falls_back():
    """K7 refuses what it does not take (a wrong type, a missing pos
    tensor) with a ValueError, on the CPU as on the card: no route gives
    way to the loop on a failure."""
    cfg = get_model_config("tiny", **GQA)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.float32, device="cpu")
    lay = params["layers"]
    ws = tuple(lay[n] for n in ("wq", "wk", "wv", "wo", "wgate", "wup",
                                "wdown"))
    cache = llama.KVCache.init(cfg, 1, T, torch.float32, "cpu")
    rope = torch.zeros((1, 2, 128))
    args = (params["embed"][3], torch.zeros((cfg.n_layers, 7)), ws,
            lay["attn_norm"], lay["mlp_norm"], rope, cache.k, cache.v)
    kw = dict(caps=(1, 1, 1, 2), n_heads=cfg.n_heads)
    with pytest.raises(ValueError, match="pos"):
        tb.token_kernel(*args, 4, **kw)
    with pytest.raises(ValueError, match="weights"):
        tb.token_kernel(*args[:2], ws[:6] + (ws[6].to(torch.bfloat16),),
                        *args[3:], torch.tensor([4], dtype=torch.int32),
                        **kw)
    with pytest.raises(ValueError, match="caps"):
        tb.token_kernel(*args, torch.tensor([4], dtype=torch.int32),
                        caps=(1, 1, 1, 9), n_heads=cfg.n_heads)


def test_k7_quantized_form_and_checks():
    """K7's form from the weights alone: seven int8 dicts or seven packed
    int4 dicts at quant group 128 with a bf16 stream and cache (not at
    group 64, not a mix, not with an fp32 stream); `token_kernel` refuses
    a wrong scale or sz stack with a ValueError rather than falling back,
    and takes the seven dicts as `quant` makes them."""
    cfg = get_model_config("tiny", **GQA)
    params = _route_params(cfg, "bfloat16")
    names = ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown")
    forms = {k: tuple(_route_params(cfg, k)["layers"][n] for n in names)
             for k in ("int8", "int4", "int4-g64", "int8-mixed")}
    h = params["embed"][3]
    cache = llama.KVCache.init(cfg, 1, T, torch.bfloat16, "cpu")
    assert tb.k7_weight_plan(forms["int8"]) == 1
    assert tb.k7_weight_plan(forms["int4"]) == 2
    assert tb.k7_form(h, forms["int8"], cache.k, cfg.n_heads)
    assert tb.k7_form(h, forms["int4"], cache.k, cfg.n_heads)
    for bad in ("int4-g64", "int8-mixed"):
        assert tb.k7_weight_plan(forms[bad]) is None
        assert not tb.k7_form(h, forms[bad], cache.k, cfg.n_heads)
    assert not tb.k7_form(h.float(), forms["int8"],
                          cache.k.float(), cfg.n_heads)
    lay = params["layers"]
    cos, sin = llama.precompute_rope(cfg, T, "cpu")
    pos = torch.tensor([4], dtype=torch.int32)
    args = (h, torch.zeros((cfg.n_layers, 7)))
    rest = (lay["attn_norm"], lay["mlp_norm"], llama._rope_rows(cos, sin, pos),
            cache.k, cache.v, pos)
    kw = dict(caps=(1, 1, 1, 2), n_heads=cfg.n_heads)
    for kind in ("int8", "int4"):
        out = tb.token_kernel(*args, forms[kind], *rest, **kw)
        assert out.shape == h.shape and torch.isfinite(out).all()
    bad8 = tuple(dict(w, scale=w["scale"].double()) if i == 3 else w
                 for i, w in enumerate(forms["int8"]))
    bad4 = tuple(dict(w, sz=w["sz"][:, :, :1].contiguous()) if i == 5 else w
                 for i, w in enumerate(forms["int4"]))
    for ws in (bad8, bad4, forms["int4-g64"]):
        with pytest.raises(ValueError, match="weights|K7 takes"):
            tb.token_kernel(*args, ws, *rest, **kw)
    with pytest.raises(ValueError, match="bf16"):
        tb.token_kernel(h.float(), args[1], forms["int8"],
                        lay["attn_norm"].float(), lay["mlp_norm"].float(),
                        *rest[2:3], cache.k.float(), cache.v.float(), pos,
                        **kw)


def test_plain_records_kept_groups():
    """`token_kernel_plain(sel=)` records each stage's kept count and
    groups, -1 past the count, as K7 does on the card."""
    cfg = get_model_config("tiny", **GQA)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.float32, device="cpu")
    lay = params["layers"]
    ws = tuple(lay[n] for n in ("wq", "wk", "wv", "wo", "wgate", "wup",
                                "wdown"))
    cache = llama.KVCache.init(cfg, 1, T, torch.float32, "cpu")
    cos, sin = llama.precompute_rope(cfg, T, "cpu")
    pos = torch.tensor([4], dtype=torch.int32)
    caps = (1, 2, 2, 2)
    sel = torch.zeros((cfg.n_layers, 4, 3), dtype=torch.int32)
    th = torch.full((cfg.n_layers, 7), 1e9)          # no group survives
    th[:, 4] = 0.0                                   # every group survives
    tb.token_kernel_plain(params["embed"][3], th, ws, lay["attn_norm"],
                          lay["mlp_norm"], llama._rope_rows(cos, sin, pos),
                          cache.k, cache.v, pos, caps=caps,
                          n_heads=cfg.n_heads, sel=sel)
    assert sel[:, 0].tolist() == [[0, -1, -1]] * cfg.n_layers
    assert sel[:, 2].tolist() == [[2, 0, 1]] * cfg.n_layers


# --- the plan --------------------------------------------------------------

PLANS = {
    # name: (esz, D, I, Hq, Hkv, T, window, caps, L)
    "7B-bf16": (2, 4096, 11008, 32, 32, 4096, None, (16, 16, 16, 43), 32),
    "7B-fp32": (4, 4096, 11008, 32, 32, 4096, None, (16, 16, 16, 43), 32),
    "mistral-7B-bf16": (2, 4096, 14336, 32, 8, 32768, 4096,
                        (16, 16, 16, 56), 32),
    "mistral-7B-fp32": (4, 4096, 14336, 32, 8, 32768, 4096,
                        (16, 16, 16, 56), 32),
    "tiny-gqa": (4, 256, 384, 2, 1, 16, None, (1, 1, 1, 2), 3),
    "tiny-mha-window": (2, 256, 384, 2, 2, 16, 4, (1, 1, 1, 2), 3),
}
ONE_CLUSTER = {c: 1 for c in range(2, 9)}
SMEM = 232448


def _rows_partf(p, esz, D, I, Hq, Hkv, B, wplan=0):
    """The rows form's partial sums a block (fp32): B rows of the largest
    NW x (columns of a cluster) of the stages, in 128-byte units (64 bf16
    or 32 fp32 columns, 128 int8 or packed-int4 ones)."""
    uw, GH = (128 // esz if wplan == 0 else 128), Hq // Hkv

    def most(cols, nw):
        return nw * -(-(cols // uw) // p.clusters) * uw
    return B * max(most(D, 1), most(I, 2), (GH + 2) * 128 if p.head_owned
                   else most((Hq + 2 * Hkv) * 128, 1))


def _check_columns(p, esz, D, I, Hq, Hkv, wplan=0, rows=1):
    """Each stage's clusters cover its weights' columns exactly once (in
    units of the weight plan `wplan`, or of the rows form's 128 bytes);
    in the head-owned plan cluster c's q columns are those of kv head c's
    query heads; every kv head's attention runs on one cluster."""
    unit = tb._rows_unit(esz, wplan) if rows > 1 else tb._tok_unit(esz,
                                                                    wplan)
    cols = tb.token_columns(p, esz, D, I, Hq, Hkv, wplan, rows)
    widths = {"wq": D, "wk": Hkv * 128, "wv": Hkv * 128, "wo": D,
              "wgate": I, "wup": I, "wdown": D}
    stages = {"qkv": ("wq", "wk", "wv"), "o": ("wo",),
              "gate|up": ("wgate", "wup"), "down": ("wdown",)}
    for stage, names in stages.items():
        assert len(cols[stage]) == p.clusters
        seen = {n: np.zeros(widths[n], np.int64) for n in names}
        for got in cols[stage]:
            for name, a, b in got:
                assert a < b and a % unit == 0, (stage, name, a, b)
                seen[name][a:b] += 1
        for name in names:
            assert (seen[name] == 1).all(), (stage, name)
    GH = Hq // Hkv
    if p.head_owned:
        for c, got in enumerate(cols["qkv"]):
            heads = {a // (128 * GH) for name, a, _ in got if name == "wq"}
            kv = {a // 128 for name, a, _ in got if name in ("wk", "wv")}
            assert (heads, kv) == (({c}, {c}) if c < Hkv else (set(), set()))
    owners = sorted(h for hs in cols["attention"] for h in hs)
    assert owners == list(range(Hkv))


@pytest.mark.parametrize("name", list(PLANS))
def test_token_plan(name):
    """`_token_plan` for 132 SMs and the H100's resident clusters: the grid
    is clusters * C blocks within the SMs; the 7B takes the head-owned
    plan (a cluster of 3 a kv head: 32 of the 39 clusters of 3 that fit,
    30 of 4 would not) with 4 grid barriers a layer, Mistral-7B's 8 kv
    heads the other plan (2 blocks a cluster, all 66 clusters) with 5; no
    kv-head barrier; shared
    memory within a block's 232448 bytes and equal to its layout's (2048
    attention scores over the query rows of a kv head, whatever T); the
    workspace of its regions (each 256-byte aligned); the columns of every
    stage covered once."""
    esz, D, I, Hq, Hkv, T_, window, caps, L = PLANS[name]
    p = tb._token_plan(esz, D, I, Hq, Hkv, T_, window, max(caps), L, 132)
    assert p is not None
    assert p.threads == 288 and p.grid == p.C * p.clusters <= 132
    head = Hkv == 32
    assert p.clusters == (Hkv if head else tb.H100_CLUSTERS[p.C])
    assert (p.head_owned, p.C) == ((True, 3) if head else (False, 2))
    assert (p.grid_barriers, p.head_barriers) == ((4 if head else 5) * L, 0)
    assert 2 <= p.slots <= 8 and p.smem <= SMEM
    GH = Hq // Hkv
    assert p.NS == tb._tok_scores(GH) == 2048 // GH

    def al(n):
        return -(-n // 256) * 256
    n = al(256 + (Hq + 2 * Hkv) * 128 * 4)
    n = al(al(al(n + D * esz) + D * esz) + Hq * 128 * esz)
    assert p.ws_bytes == al(n + I * esz)
    uw = tb._TOK_UB // esz

    def most(cols, nw):
        return nw * -(-(cols // uw) // p.clusters) * uw
    partf = max(most(D, 1), most(I, 2),
                (GH + 2) * 128 if head else most((Hq + 2 * Hkv) * 128, 1))
    assert p.smem == tb._token_smem(esz, D, I, GH, max(caps), p.NS, partf,
                                    p.slots)
    _check_columns(p, esz, D, I, Hq, Hkv)


@pytest.mark.parametrize("wplan", [1, 2], ids=["int8", "int4"])
@pytest.mark.parametrize("name", ["7B-bf16", "mistral-7B-bf16", "tiny-gqa",
                                  "tiny-mha-window"])
def test_token_plan_quantized(name, wplan):
    """K7's int8 and packed-int4 plans (a bf16 stream) for 132 SMs and the
    H100's resident clusters: the structure of the arrays' plan (the 7B
    head-owned with clusters of 3, Mistral-7B the other plan), units of
    128 columns (128 bytes of a slab row), so that the 7B's o and down
    fall one unit a cluster and gate|up 86 units over 32 clusters; ring
    slots of 16 KB (int4: 18 KB with two groups' scale and zero rows);
    shared memory equal to the layout's and within a block's; every column
    of every stage covered once."""
    _, D, I, Hq, Hkv, T_, window, caps, L = PLANS[name]
    esz = 2
    p = tb._token_plan(esz, D, I, Hq, Hkv, T_, window, max(caps), L, 132,
                       plan=wplan)
    arrays = tb._token_plan(esz, D, I, Hq, Hkv, T_, window, max(caps), L,
                            132)
    assert p is not None and tb._tok_unit(esz, wplan) == 128
    assert (p.grid, p.C, p.clusters, p.head_owned, p.grid_barriers,
            p.NS) == (arrays.grid, arrays.C, arrays.clusters,
                      arrays.head_owned, arrays.grid_barriers, arrays.NS)
    assert tb._tok_slot(wplan) == (16384 if wplan == 1 else 18432)
    assert 2 <= p.slots <= 8 and p.smem <= SMEM
    GH = Hq // Hkv

    def most(cols, nw):
        return nw * -(-(cols // 128) // p.clusters) * 128
    partf = max(most(D, 1), most(I, 2), (GH + 2) * 128 if p.head_owned
                else most((Hq + 2 * Hkv) * 128, 1))
    assert p.smem == tb._token_smem(esz, D, I, GH, max(caps), p.NS, partf,
                                    p.slots, wplan)
    _check_columns(p, esz, D, I, Hq, Hkv, wplan)
    if name == "7B-bf16":
        cols = tb.token_columns(p, esz, D, I, Hq, Hkv, wplan)
        assert [b - a for got in cols["o"] for _, a, b in got] == [128] * 32
        units = sorted({sum(b - a for _, a, b in got) // 256
                        for got in cols["gate|up"]})
        assert units == [2, 3]           # 86 units: 3 or 2 a cluster


@pytest.mark.parametrize("wplan", [0, 1, 2], ids=["arrays", "int8", "int4"])
@pytest.mark.parametrize("B", [2, 8, 16])
@pytest.mark.parametrize("name", list(PLANS))
def test_token_plan_rows(name, B, wplan):
    """K7's rows form's plan (arrays, and int8 and packed int4 with a bf16
    stream; B rows) for 132 SMs and the H100's resident clusters: the
    structure of the one-row plan (the 7B head-owned with clusters of 3,
    Mistral-7B the other plan), a warp's attention chunk of 16 bf16 or 8
    fp32 rows (GQA 32/8: 4 query heads a kv head, 8 and 4), B rows of the
    partial sums in 128-byte units (128 columns for int8 and int4), the
    workspace of B rows of each region, ring slots of two 8 KB boxes (int4:
    and two groups' scale and zero rows) beside 16 staged input rows,
    shared memory equal to its layout's and within a block's, and every
    column covered once; none for 1 or 17 rows, nor for quantized rows
    with an fp32 stream."""
    esz, D, I, Hq, Hkv, T_, window, caps, L = PLANS[name]
    if wplan:
        assert tb._token_plan(4, D, I, Hq, Hkv, T_, window, max(caps), L,
                              132, plan=wplan, rows=B) is None
        esz = 2
    p = tb._token_plan(esz, D, I, Hq, Hkv, T_, window, max(caps), L, 132,
                       plan=wplan, rows=B)
    one = tb._token_plan(esz, D, I, Hq, Hkv, T_, window, max(caps), L, 132)
    assert p is not None
    assert (p.grid, p.C, p.clusters, p.head_owned, p.grid_barriers) == (
        one.grid, one.C, one.clusters, one.head_owned, one.grid_barriers)
    GH = Hq // Hkv
    assert p.NS == tb._rows_chunk(esz, GH) == (16 if esz == 2 else 8) // (
        1 if GH <= 2 else GH // 2)
    assert p.ws_bytes == tb._token_ws(esz, D, I, Hq, Hkv, B)
    assert 2 <= p.slots <= 8 and p.smem <= SMEM
    assert tb._rows_slot(esz, wplan) == 16384 + 2048 * (wplan == 2) + 16 * (
        128 * esz + 16)
    assert p.smem == tb._token_smem_rows(
        esz, D, I, max(caps), _rows_partf(p, esz, D, I, Hq, Hkv, B, wplan),
        p.slots, wplan)
    _check_columns(p, esz, D, I, Hq, Hkv, wplan, rows=B)
    assert tb._token_plan(2, D, I, Hq, Hkv, T_, window, max(caps), L, 132,
                          plan=wplan, rows=1 + 16) is None


@pytest.mark.parametrize("wplan,rows", [(0, 1), (1, 1), (2, 1), (0, 16),
                                       (1, 16), (2, 16)],
                         ids=["arrays", "int8", "int4", "arrays-rows16",
                              "int8-rows16", "int4-rows16"])
def test_token_plan_independent_of_T(wplan, rows):
    """K7's plan is the same at T 2048, 8192 and 32768 (attention walks the
    cache in chunks of a fixed size, so no shared memory grows with T),
    with and without a window, at the 7B's and llama-3-70b's widths (one
    row and 16 rows: bf16, int8, int4, fp32 arrays)."""
    for D, I, Hq, Hkv, L in ((4096, 11008, 32, 32, 32),
                             (8192, 28672, 64, 8, 80)):
        for esz in ((2, 4) if wplan == 0 else (2,)):
            plans = {(T_, w): tb._token_plan(esz, D, I, Hq, Hkv, T_, w,
                                             I // 256, L, 132, plan=wplan,
                                             rows=rows)
                     for T_ in (2048, 8192, 32768) for w in (None, 4096)}
            first = plans[(2048, None)]
            assert first is not None, (D, esz, wplan, rows)
            assert all(p == first for p in plans.values()), (D, esz)


def _dense_128():
    return [n for n, c in ((n, get_model_config(n))
                           for n in MODEL_REGISTRY)
            if c.head_dim == 128 and not c.n_experts]


def _meta_call(cfg, kind, B, dt):
    """(h, ws, kc) of a decode call at cfg's full shapes on the meta device
    (no memory): h [D] or [B, D], the seven weights as `kind` (arrays of
    dt, int8 or packed int4 at group 128 dicts), the cache at max_seq_len."""
    L, D, I, kvw = cfg.n_layers, cfg.dim, cfg.intermediate_size, \
        cfg.n_kv_heads * 128
    shapes = ((D, D), (D, kvw), (D, kvw), (D, D), (D, I), (D, I), (I, D))

    def weight(k, n):
        if kind == "int8":
            return {"q": torch.empty((L, k, n), dtype=torch.int8,
                                     device="meta"),
                    "scale": torch.empty((L, n), device="meta")}
        if kind == "int4":
            return {"qp": torch.empty((L, k // 2, n), dtype=torch.int8,
                                      device="meta"),
                    "sz": torch.empty((L, k // 128, 2, n), device="meta")}
        return torch.empty((L, k, n), dtype=dt, device="meta")
    h = torch.empty((D,) if B == 1 else (B, D), dtype=dt, device="meta")
    kc = torch.empty((L, B, cfg.n_kv_heads, cfg.max_seq_len, 128), dtype=dt,
                     device="meta")
    return h, tuple(weight(k, n) for k, n in shapes), kc


FORMS = {"bf16": ("arrays", torch.bfloat16, 1),
         "fp32": ("arrays", torch.float32, 1),
         "int8": ("int8", torch.bfloat16, 1),
         "int4": ("int4", torch.bfloat16, 1),
         "bf16-rows16": ("arrays", torch.bfloat16, 16),
         "fp32-rows16": ("arrays", torch.float32, 16),
         "int8-rows16": ("int8", torch.bfloat16, 16),
         "int4-rows16": ("int4", torch.bfloat16, 16)}


@pytest.mark.parametrize("name", _dense_128())
def test_registry_plans_at_max_seq_len(name):
    """Every dense head_dim-128 config of the registry has a K7 plan at its
    max_seq_len (llama-3-70b at T 8192 among them) in bf16, int8 and int4
    at one row and at 16 rows, at its main-path caps and at the verify's
    full caps (a chunk of 8 rows)."""
    cfg = get_model_config(name)
    caps = llama.token_path_caps(cfg, SparsityConfig(**MAIN))
    full = (cfg.dim // 128,) * 3 + (cfg.intermediate_size // 128,)
    for form in ("bf16", "int8", "int4"):
        kind, dt, _ = FORMS[form]
        p = tb._token_plan(dt.itemsize, cfg.dim, cfg.intermediate_size,
                           cfg.n_heads, cfg.n_kv_heads, cfg.max_seq_len,
                           cfg.sliding_window, max(full), cfg.n_layers,
                           plan={"arrays": 0, "int8": 1, "int4": 2}[kind],
                           rows=8)
        assert p is not None and p.smem <= SMEM, (name, form, "verify")
    for form in ("bf16", "int8", "int4", "bf16-rows16", "int8-rows16",
                 "int4-rows16"):
        kind, dt, B = FORMS[form]
        plan = {"arrays": 0, "int8": 1, "int4": 2}[kind]
        p = tb._token_plan(dt.itemsize, cfg.dim, cfg.intermediate_size,
                           cfg.n_heads, cfg.n_kv_heads, cfg.max_seq_len,
                           cfg.sliding_window, max(caps), cfg.n_layers,
                           plan=plan, rows=B)
        assert p is not None and p.smem <= SMEM, (name, form)


@pytest.mark.parametrize("name", _dense_128())
def test_route_agrees_with_plan(name):
    """`token_decode`'s route (`k7_route`, from the call's form and shapes
    alone; on a tensor off the card the H100's plan) takes K7 exactly
    where `_token_plan` has a plan, for every dense head_dim-128 config of
    the registry at its full shapes and max_seq_len (tensors on the meta
    device) in bf16, fp32, int8 and int4 at one row and at 16 rows;
    token_fused False keeps the loop."""
    cfg = get_model_config(name)
    caps = llama.token_path_caps(cfg, SparsityConfig(**MAIN))
    for form, (kind, dt, B) in FORMS.items():
        h, ws, kc = _meta_call(cfg, kind, B, dt)
        plan = {"arrays": 0, "int8": 1, "int4": 2}[kind]
        want = tb._token_plan(dt.itemsize, cfg.dim, cfg.intermediate_size,
                              cfg.n_heads, cfg.n_kv_heads, cfg.max_seq_len,
                              cfg.sliding_window, max(caps), cfg.n_layers,
                              plan=plan, rows=B)
        assert tb.k7_form(h, ws, kc, cfg.n_heads), (name, form)
        assert tb.k7_plan(h, kc, ws, cfg.n_heads, caps,
                          cfg.sliding_window) == want, (name, form)
        assert tb.k7_route(h, ws, kc, cfg.n_heads, caps,
                           cfg.sliding_window) == (want is not None)
        assert not tb.k7_route(h, ws, kc, cfg.n_heads, caps,
                               cfg.sliding_window, token_fused=False)


def test_route_takes_the_loop_without_a_plan():
    """A call of K7's form whose shapes K7 cannot plan (no cluster can be
    resident: here 33 query heads a kv head are not a form at all, so the
    shapes are a stream past 36 KB at one row: D 32768) takes the loop:
    the route asks the plan before any launch."""
    cfg = dataclasses.replace(get_model_config("7B"), dim=32768,
                              n_heads=256, n_kv_heads=32, n_layers=2)
    caps = llama.token_path_caps(cfg, SparsityConfig(**MAIN))
    h, ws, kc = _meta_call(cfg, "arrays", 1, torch.bfloat16)
    assert tb.k7_form(h, ws, kc, cfg.n_heads)
    assert tb.k7_plan(h, kc, ws, cfg.n_heads, caps) is None
    assert not tb.k7_route(h, ws, kc, cfg.n_heads, caps)


def test_token_plan_quantized_refuses():
    """No quantized plan for an fp32 stream (the int8 and int4 plans take
    bf16; one row or rows), nor for an unknown weight plan."""
    assert tb._token_plan(4, 4096, 11008, 32, 32, 4096, None, 43, 32, 132,
                          plan=1) is None
    assert tb._token_plan(4, 4096, 11008, 32, 32, 4096, None, 43, 32, 132,
                          plan=2, rows=8) is None
    assert tb._token_plan(2, 4096, 11008, 32, 32, 4096, None, 43, 32, 132,
                          plan=3) is None


def test_token_plan_refuses():
    """No plan where the shapes do not fit: a head_dim other than 128, a
    cap above the groups, 3 query heads a kv head, a stream past 36 KB, no
    cluster that can be resident. A long cache is no longer among them
    (no window, 2^20 rows, 8 query heads a kv head): attention walks it in
    chunks of a fixed size, so it plans as a short one does."""
    long = tb._token_plan(2, 4096, 11008, 32, 4, 1 << 20, None, 16, 32, 132)
    assert long == tb._token_plan(2, 4096, 11008, 32, 4, 512, None, 16, 32,
                                  132)
    assert tb._token_plan(2, 4096, 11008, 64, 8, 4096, None, 16, 32,
                          132) is None
    assert tb._token_plan(2, 4096, 11008, 32, 32, 4096, None, 87, 32,
                          132) is None
    # 3 query heads a kv head: K7 takes 1, 2, 4 or 8 (the loop the rest)
    assert tb._token_plan(2, 3072, 8192, 24, 8, 4096, None, 12, 32,
                          132) is None
    assert tb._token_plan(2, 32768, 11008, 256, 32, 64, None, 16, 2,
                          132) is None
    assert tb._token_plan(2, 4096, 11008, 32, 32, 512, None, 16, 32, 132,
                          {c: 0 for c in range(1, 17)}) is None


def _sweep_shapes(GH):
    """(esz, D, I, Hkv) for Hkv 1-32 at GH query heads a kv head: D = 128
    GH Hkv and I = D * 8 / 3 rounded up to 128, in fp32 and bf16."""
    for Hkv in range(1, 33):
        D = 128 * GH * Hkv
        I = -(-(D * 8 // 3) // 128) * 128
        for esz in (2, 4):
            yield esz, D, I, Hkv


@pytest.mark.parametrize("GH", [1, 2, 4, 8])
@pytest.mark.parametrize("edge", ["h100", "one-cluster", "64-sms"])
def test_token_plan_covers_every_column(GH, edge):
    """Over Hkv 1-32 at 1, 2, 4 and 8 query heads a kv head, fp32 and
    bf16, every D `_token_plan` takes (a stream of at most 36 KB): on the
    H100 (132 SMs and its resident clusters), at the edge of one resident
    cluster of each size, and on half the SMs, the plan either raises
    (None) because two ring slots and the rest (the stream, the selection
    input, the cluster's partial sums) pass a block's shared memory, or
    its clusters cover every q, k, v, o, gate, up and down column exactly
    once, each head-owned cluster's q columns belong to its kv head, and
    its shared bytes stay within 232448. The same for the rows form at B
    = 2, 8 and 16 (arrays, 128-byte units; no stream limit: its rows live
    in the workspace) and at B = 16 with int8 and int4 weights (bf16),
    where None means two slots beside B rows of the cluster's partial
    sums pass shared memory."""
    clusters, sms = {"h100": (tb.H100_CLUSTERS, 132),
                     "one-cluster": (ONE_CLUSTER, 132),
                     "64-sms": ({c: n // 2 for c, n in
                                 tb.H100_CLUSTERS.items()}, 66)}[edge]
    planned = 0
    for esz, D, I, Hkv in _sweep_shapes(GH):
        Hq, cap = GH * Hkv, min(8, D // 128)
        p = tb._token_plan(esz, D, I, Hq, Hkv, 512, None, cap, 2, sms,
                           clusters)
        if D * esz > 16 * 8 * 288:
            assert p is None
            continue
        if p is None:
            C, head = tb._token_structure(Hkv, sms, clusters)
            uw, NC = tb._TOK_UB // esz, Hkv if head else clusters[C]
            partf = max(2 * -(-(I // uw) // NC) * uw,
                        (GH + 2) * 128 if head
                        else -(-((Hq + 2 * Hkv) * 128 // uw) // NC) * uw)
            # at least two slots, and room for attention's PV sums
            least = max(2, -(-(256 // (128 * esz // 16)) * GH * 512 // 16384))
            assert tb._token_smem(esz, D, I, GH, cap, tb._tok_scores(GH),
                                  partf, least) > SMEM, (esz, D, I, Hkv)
            continue
        planned += 1
        assert p.smem <= SMEM and p.grid <= sms
        _check_columns(p, esz, D, I, Hq, Hkv)
    assert planned > 0
    planned = 0
    for esz, D, I, Hkv in _sweep_shapes(GH):
        Hq, cap = GH * Hkv, min(8, D // 128)
        for B, wplan in ((2, 0), (8, 0), (16, 0), (16, 1), (16, 2)):
            if wplan and esz != 2:
                continue
            p = tb._token_plan(esz, D, I, Hq, Hkv, 512, None, cap, 2, sms,
                               clusters, plan=wplan, rows=B)
            if p is None:
                C, head = tb._token_structure(Hkv, sms, clusters)
                uw, NC = tb._rows_unit(esz, wplan), Hkv if head else \
                    clusters[C]
                partf = B * max(2 * -(-(I // uw) // NC) * uw,
                                (GH + 2) * 128 if head
                                else -(-((Hq + 2 * Hkv) * 128 // uw) // NC)
                                * uw)
                assert tb._token_smem_rows(esz, D, I, cap, partf, 2,
                                           wplan) > SMEM, (esz, D, I, Hkv, B)
                continue
            planned += 1
            assert p.smem <= SMEM and p.grid <= sms
            assert p.smem == tb._token_smem_rows(
                esz, D, I, cap, _rows_partf(p, esz, D, I, Hq, Hkv, B, wplan),
                p.slots, wplan)
            _check_columns(p, esz, D, I, Hq, Hkv, wplan, rows=B)
    assert planned > 0


def test_token_plan_one_cluster_raises_past_shared_memory():
    """At the edge of one resident cluster a cluster owns every column:
    the 7B still plans (one cluster of 8; bf16 with five ring slots
    beside the 8 KB of attention scores, fp32 with four), but a 70B-wide
    fp32 layer's gate|up partial sums (2 x
    28672 fp32) beside its stream pass shared memory, so no plan; the tiny
    config plans too."""
    assert tb._token_plan(4, 8192, 28672, 64, 8, 512, None, 43, 32, 132,
                          ONE_CLUSTER) is None
    for esz, slots in ((2, 5), (4, 4)):
        p = tb._token_plan(esz, 4096, 11008, 32, 32, 512, None, 43, 32, 132,
                           ONE_CLUSTER)
        assert (p.C, p.clusters, p.slots) == (8, 1, slots)
        _check_columns(p, esz, 4096, 11008, 32, 32)
    p = tb._token_plan(4, 256, 384, 2, 1, 16, None, 2, 3, 132, ONE_CLUSTER)
    assert (p.C, p.clusters, p.grid, p.head_owned) == (8, 1, 8, False)
    _check_columns(p, 4, 256, 384, 2, 1)
