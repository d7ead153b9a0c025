"""K7's route, plan and plain version on the CPU.

K7 (`ops/token_block.token_kernel`, `csrc/token_decode.cu`) decodes one
token through every layer in one launch, the counterpart of the JAX
package's whole-token kernel `_token_kernel`; with `token_fused=False`
the port keeps the K1/K2 loop, the counterpart of `_packed_layer`. Here:
  - the route: K7 exactly for its form (batch 1, arrays of the stream
    type, head_dim 128, no MoE, no seq_block, token_fused not False);
  - `_token_plan` at Llama-2-7B, Mistral-7B (GQA 32/8, window 4096) and
    the tiny configs, for 132 SMs;
  - the port's forward (K7's plain version on CPU tensors) against the
    JAX `_token_kernel` in interpret mode, and with token_fused=False (the
    loop) against the JAX `_packed_layer`: fp32 within 2e-5 (as
    test_torch_model.py), bf16 within 2e-2 of the logits' largest value
    (the two frameworks round the bf16 stream at the same points but may
    sum in other orders: a bf16 ulp is 2^-8 of a value); GQA, MHA, a
    window with pos past it, `fixed_sel`. The bf16 cases select at
    threshold 0, where every group survives and the first `cap` are
    kept, so that a one-ulp score difference cannot flip a group.
All JAX cases run in one child process (`jax_subprocess.jax_results`)."""

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
from teal_tpu_torch.config import SparsityConfig, get_model_config
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


def _thresholds(cfg_kw, dtype):
    """Per-layer group thresholds near each stage's median group score
    (fp32), or 0 (bf16: every group survives, the first cap kept)."""
    L = cfg_kw["n_layers"]
    if dtype == "bfloat16":
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


def jax_token_case(case):
    """JAX's forward at one case, in interpret mode: the whole-token kernel
    (token_fused unset) or the packed pipeline (token_fused False). Run by
    `jax_results` in the subprocess."""
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
                       {c: dict(case=c) for c in CASES},
                       tmp_path_factory.mktemp("jax_token_kernel"))


def _port_params(cfg_kw, dtype):
    jcfg = jget_model_config("tiny", **cfg_kw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(7), jnp.float32)
    return llama.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   device="cpu", dtype=dtype)


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


# --- the route -----------------------------------------------------------

MOE = dict(n_layers=2, n_heads=2, n_kv_heads=2, dim=256,
           intermediate_size=384, vocab_size=128, n_experts=4,
           n_experts_per_tok=2)
ROUTES = {
    # case: (config overrides, params, batch, token_fused, K7 expected)
    "k7": (GQA, "float32", 1, None, True),
    "k7-token-fused-true": (GQA, "float32", 1, True, True),
    "k7-bf16": (GQA, "bfloat16", 1, None, True),
    "k7-window": (WINDOW, "float32", 1, None, True),
    "loop-token-fused-false": (GQA, "float32", 1, False, False),
    "loop-int8": (GQA, "int8", 1, None, False),
    "loop-int4": (GQA, "int4", 1, None, False),
    "loop-rows": (GQA, "float32", 2, None, False),
    "loop-moe": (MOE, "float32", 1, None, False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_route(monkeypatch, case):
    """`llama.forward` at one decode position takes K7 (its wrapper,
    `token_kernel`) exactly for K7's form with token_fused not False, and
    the K1/K2 loop (`layer_decode`) for token_fused False, int8, int4,
    rows and MoE; the route is decided by the form alone."""
    cfg_kw, kind, b, fused, k7 = ROUTES[case]
    cfg = get_model_config("tiny", **cfg_kw)
    dt = torch.bfloat16 if kind in ("bfloat16", "int8", "int4") \
        else torch.float32
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.float32 if kind == "float32"
                               else torch.bfloat16, device="cpu")
    if kind == "int8":
        params = quant.quantize_params_int8(params)
    elif kind == "int4":
        params = quant.pack_int4_params(quant.quantize_params_int4(params,
                                                                   128), 128)
    calls = {"k7": 0, "loop": 0}
    kernel, layer = tb.token_kernel, tb.layer_decode

    def spy(name, f):
        def g(*a, **kw):
            calls[name] += 1
            return f(*a, **kw)
        return g
    monkeypatch.setattr(tb, "token_kernel", spy("k7", kernel))
    monkeypatch.setattr(tb, "layer_decode", spy("loop", layer))
    sp = SparsityConfig(**dict(MAIN, **({} if fused is None
                                        else dict(token_fused=fused))))
    cache = llama.KVCache.init(cfg, b, T, dt, "cpu")
    assert llama.can_token_decode(params, cfg, sp, 1, b, dt)
    th = torch.zeros((cfg.n_layers, 7))
    logits, _ = llama.forward(params, torch.full((b, 1), 3), cache,
                              [4] * b if b > 1 else 4, th, cfg=cfg, sp=sp)
    assert torch.isfinite(logits).all()
    assert calls == ({"k7": 1, "loop": 0} if k7
                     else {"k7": 0, "loop": cfg.n_layers})


def test_route_seq_block_takes_the_loop(monkeypatch):
    """`token_decode` with seq_block (the verify path's rows) keeps the
    loop whatever token_fused says; K7's form is one row."""
    cfg = get_model_config("tiny", **GQA)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.float32, device="cpu")
    lay = params["layers"]
    calls = []
    kernel = tb.token_kernel
    monkeypatch.setattr(tb, "token_kernel",
                        lambda *a, **kw: calls.append(1) or kernel(*a, **kw))
    cache = llama.KVCache.init(cfg, 1, T, torch.float32, "cpu")
    cos, sin = llama.precompute_rope(cfg, T, "cpu")
    pos = torch.tensor([4, 5], dtype=torch.int32)
    h = params["embed"][torch.tensor([3, 4])]
    out = tb.token_decode(
        h, torch.zeros((cfg.n_layers, 7)),
        tuple(lay[n] for n in ("wq", "wk", "wv", "wo", "wgate", "wup",
                               "wdown")),
        lay["attn_norm"], lay["mlp_norm"], llama._rope_rows(cos, sin, pos),
        cache.k, cache.v, pos, caps=(2, 2, 2, 3), n_heads=cfg.n_heads,
        fixed_sel=True, seq_block=True)
    assert out.shape == h.shape and not calls
    assert not tb.k7_form(h, (lay["wq"],) * 7, cache.k, cfg.n_heads,
                          seq_block=True)


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


@pytest.mark.parametrize("name", list(PLANS))
def test_token_plan(name):
    """`_token_plan` for 132 SMs: a block an SM, SA = min(16, 132 / Hkv),
    shared memory within a block's 232448 bytes, the workspace of its
    regions (each 256-byte aligned; a barrier counter a 128-byte line),
    6 grid and 2 kv-head barriers a layer."""
    esz, D, I, Hq, Hkv, T_, window, caps, L = PLANS[name]
    p = tb._token_plan(esz, D, I, Hq, Hkv, T_, window, max(caps), L, 132)
    assert p is not None
    SA = min(16, 132 // Hkv)
    assert (p.grid, p.threads, p.SA) == (132, 256, SA)
    assert p.smem <= 232448
    assert (p.grid_barriers, p.head_barriers) == (6 * L, 2 * L)

    def al(n):
        return -(-n // 256) * 256
    tw, GH = 256 // esz, Hq // Hkv
    tiles = {"qkv": (Hq + 2 * Hkv) * 128 // tw, "o": D // tw,
             "gu": I // tw, "down": D // tw}
    n = al((1 + Hkv) * 128)
    for stage, nw in (("qkv", 1), ("o", 1), ("gu", 2), ("down", 1)):
        n = al(n + tiles[stage] * (132 // tiles[stage] + 2) * nw * tw * 4)
    for part in (Hkv * SA * GH, Hkv * SA * GH, Hkv * SA * GH * 128):
        n = al(n + 4 * part)
    n = al(n + Hq * 128 * esz)
    assert p.ws_bytes == al(n + I * esz)
    # a window caps the score slice; without one a long cache may not fit
    live = min(T_, window or T_)
    assert -(-(live - 1) // SA) * GH * 4 <= p.smem


def test_token_plan_refuses():
    """No plan where the shapes do not fit: a score slice past shared
    memory (no window, a long cache, 8 query heads a kv head), a head_dim
    other than 128, a cap above the groups, 3 query heads a kv head."""
    assert tb._token_plan(2, 4096, 11008, 32, 4, 1 << 20, None, 16, 32,
                          132) is None
    assert tb._token_plan(2, 4096, 11008, 64, 8, 4096, None, 16, 32,
                          132) is None
    assert tb._token_plan(2, 4096, 11008, 32, 32, 4096, None, 87, 32,
                          132) is None
    # 3 query heads a kv head: K7 takes 1, 2, 4 or 8 (the loop the rest)
    assert tb._token_plan(2, 3072, 8192, 24, 8, 4096, None, 12, 32,
                          132) is None
