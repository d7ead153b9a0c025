"""K7's MoE form (Mixtral: the routing inside the one launch) on the CPU.

`ops/token_block.token_kernel(..., router=, n_experts_per_tok=)` decodes a
Mixtral token in one K7 launch, the counterpart of the MoE branch of the
JAX package's whole-token kernel (`_token_kernel`, its routing in
`_moe_route`); on CPU tensors the wrapper runs its plain version, which
composes K5's and K1's plain versions at the pseudo-layers of the expert
stacks. Here, on the JAX package's MoE test config (`tests/test_moe.py`:
2 layers, 2/2 heads, D 256, I 384, 4 experts, 2 routed) and at 8 experts:
  - the stream and both caches against JAX's `token_decode(router=...)`
    in interpret mode: fp32 within 2e-5 at pos 0 and 5, the down
    threshold (column 6) at 0 as calibration leaves it and picked; int8
    experts at one layer in bf16 within 2^-7 of scale;
  - `sel` and `routes` against the K1/K5 loop's kept counts and routed
    pseudo-layers (`layer_decode`); each case's top-k router margin;
  - the route: K7 for a Mixtral token of arrays or int8 experts where
    token_fused is not False, the loop for token_fused False, int4 MoE
    and shapes K7 cannot plan; the plan of Mixtral-8x7B (bf16 and int8)
    at its max_seq_len within shared memory, and `k7_plan` beside the
    route.
The seeds give top-2 router margins far above the two frameworks'
summation-order differences (checked on the logits). All JAX cases run
in one child process (`jax_subprocess.jax_results`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax_subprocess import jax_results

from teal_tpu.config import get_model_config as jget_model_config
from teal_tpu.models import llama as jllama
from teal_tpu.ops import block_gemv as jbg
from teal_tpu.ops import quant as jq
from teal_tpu.ops import token_block as jtb
from teal_tpu_torch.config import SparsityConfig, get_model_config
from teal_tpu_torch.models import llama
from teal_tpu_torch.ops import block_gemv as bg
from teal_tpu_torch.ops import quant
from teal_tpu_torch.ops import token_block as tb

MOE = dict(n_layers=2, n_heads=2, n_kv_heads=2, dim=256,
           intermediate_size=384, vocab_size=128, n_experts=4,
           n_experts_per_tok=2)
MAIN = dict(enabled=True, kernel="block", block_size=128,
            block_keep_frac=0.5, block_thresholding=True)
CAPS = (1, 1, 1, 2)              # the main config's at D 256, I 384
TOL = dict(rtol=2e-5, atol=2e-5)
QUANT_REL = 2 ** -7
T = 16
# [L, 7] thresholds: column 6 (the experts' down stage) at 0 as
# calibration leaves it for MoE, or picked
TH = np.array([[2.6, 2.6, 2.6, 0.12, 2.6, 2.6, 0.0],
               [2.7, 2.7, 2.7, 0.13, 2.7, 2.7, 0.0]], np.float32)
TH_DOWN = 0.2

# case: (experts, layers, weights, pos, column 6 picked, token, seed)
CASES = {
    "e4-p0": (4, 2, "float32", 0, False, 3, 3),
    "e4-p0-col6": (4, 2, "float32", 0, True, 3, 3),
    "e4-p5": (4, 2, "float32", 5, False, 8, 3),
    "e4-p5-col6": (4, 2, "float32", 5, True, 8, 3),
    "e8-p5-col6": (8, 2, "float32", 5, True, 6, 5),
    "int8-e4-p5": (4, 1, "int8", 5, True, 9, 17),
}


def _cfg_kw(E, L):
    return dict(MOE, n_layers=L, n_experts=E)


def _thresholds(L, col6):
    th = TH[:L].copy()
    if col6:
        th[:, 6] = TH_DOWN
    return th


def _cache(seed, L, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shape = (L, 1, MOE["n_kv_heads"], T, 128)
    return tuple((rng.standard_normal(shape) * 0.1).astype(dtype)
                 for _ in range(2))


def _jax_params(case):
    """JAX's config and weights of a case: fp32, or int8 (its
    quantization of bf16 weights)."""
    E, L, kind, _, _, _, seed = CASES[case]
    jcfg = jget_model_config("tiny", **_cfg_kw(E, L))
    if kind == "int8":
        return jcfg, jq.quantize_params_int8(
            jllama.init_params(jcfg, jax.random.PRNGKey(seed), jnp.bfloat16))
    return jcfg, jllama.init_params(jcfg, jax.random.PRNGKey(seed),
                                    jnp.float32)


def jax_k7_moe(case):
    """JAX's `token_decode` with the router (the whole-token kernel's MoE
    branch) in interpret mode at one case: the stream after the last
    layer, both caches and the RoPE rows it took (run by `jax_results` in
    the subprocess)."""
    E, L, kind, p, col6, tok, _ = CASES[case]
    jcfg, jp = _jax_params(case)
    dt = jnp.bfloat16 if kind == "int8" else jnp.float32
    lay = jp["layers"]
    k, v = _cache(p + 11 * L, L)
    cos, sin = jllama.precompute_rope(jcfg, T)
    h = jp["embed"][tok].astype(dt)
    ws = tuple(lay[n] for n in ("wq", "wk", "wv", "wo", "wgate", "wup",
                                "wdown"))
    with pltpu.force_tpu_interpret_mode():
        h3, kc, vc = jtb.token_decode(
            jbg.pack_x3(h.reshape(1, -1), 128), jnp.asarray(_thresholds(
                L, col6)), ws, jbg.pack_norm3(lay["attn_norm"], 128),
            jbg.pack_norm3(lay["mlp_norm"], 128), cos[p], sin[p],
            jnp.asarray(k, dt), jnp.asarray(v, dt), p, caps=CAPS,
            n_heads=jcfg.n_heads, norm_eps=jcfg.norm_eps,
            router=lay["router"], n_experts_per_tok=jcfg.n_experts_per_tok)
    return {"h": np.asarray(h3.reshape(-1).astype(jnp.float32)),
            "k": np.asarray(kc.astype(jnp.float32)),
            "v": np.asarray(vc.astype(jnp.float32)),
            "cos": np.asarray(cos[p]), "sin": np.asarray(sin[p])}


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    return jax_results(__file__, "jax_k7_moe",
                       {c: dict(case=c) for c in CASES},
                       tmp_path_factory.mktemp("jax_k7_moe"))


def _port(case):
    """The port's inputs of a case: (cfg, params, k and v caches,
    thresholds), JAX's weights carried across (int8: its quantized
    copy)."""
    E, L, kind, p, col6, tok, _ = CASES[case]
    cfg = get_model_config("tiny", **_cfg_kw(E, L))
    jcfg, jp = _jax_params(case)
    dt = torch.bfloat16 if kind == "int8" else torch.float32
    params = llama.params_from_numpy(jax.tree.map(np.asarray, jp),
                                     device="cpu", dtype=dt)
    k, v = (torch.from_numpy(a).to(dt) for a in _cache(p + 11 * L, L))
    return cfg, params, k, v, torch.from_numpy(_thresholds(L, col6))


def _run(case, rope, **kw):
    """token_kernel on a case's CPU tensors: (stream, k, v)."""
    cfg, params, k, v, th = _port(case)
    lay = params["layers"]
    p = CASES[case][3]
    h = params["embed"][CASES[case][5]].to(llama.compute_dtype(params))
    out = tb.token_kernel(
        h, th, tuple(lay[n] for n in llama._WEIGHTS), lay["attn_norm"],
        lay["mlp_norm"], rope, k, v, torch.tensor([p], dtype=torch.int32),
        caps=CAPS, n_heads=cfg.n_heads, norm_eps=cfg.norm_eps,
        router=lay["router"], n_experts_per_tok=cfg.n_experts_per_tok, **kw)
    return out, k, v


def _rope(ref):
    return torch.from_numpy(np.stack([ref["cos"], ref["sin"]])[None])


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_k7_moe_matches_jax(jax_refs, case):
    """K7's MoE form (its plain version on CPU tensors) == JAX's
    `token_decode(router=...)` in interpret mode: the stream after the
    last layer and both caches, fp32 within 2e-5, int8 experts at one
    layer in bf16 within 2^-7 of scale."""
    ref = jax_refs[case]
    got = _run(case, _rope(ref))
    for g, name in zip(got, ("h", "k", "v")):
        if CASES[case][2] == "int8":
            _close(g.float().numpy(), ref[name], QUANT_REL)
        else:
            np.testing.assert_allclose(g.numpy(), ref[name], **TOL,
                                       err_msg=name)


@pytest.mark.parametrize("case", ["e4-p5-col6", "e8-p5-col6", "int8-e4-p5"])
def test_k7_moe_records_match_the_loop(jax_refs, case):
    """`sel` [L, 2 + 2k, 1 + cap] and `routes` [L, k] hold what the K1/K5
    loop (`layer_decode` with the router) keeps and routes, layer by
    layer on the same input: kept counts, routed pseudo-layers l E + e;
    the kept groups lie in range, ascending, -1 past the count."""
    cfg, params, k, v, th = _port(case)
    lay = params["layers"]
    rope = _rope(jax_refs[case])
    E, kx, L = cfg.n_experts, cfg.n_experts_per_tok, cfg.n_layers
    sel = torch.zeros((L, 2 + 2 * kx, 1 + max(CAPS)), dtype=torch.int32)
    routes = torch.zeros((L, kx), dtype=torch.int32)
    _run(case, rope, sel=sel, routes=routes)
    ws = tuple(lay[n] for n in llama._WEIGHTS)
    ws = (*ws[:4], *(tb.expert_stacks(w) for w in ws[4:]))
    h = params["embed"][CASES[case][5]].to(llama.compute_dtype(params))
    pos = torch.tensor([CASES[case][3]], dtype=torch.int32)
    for i in range(L):
        counts, rts = [], []
        h = tb.layer_decode(
            h, i, th, ws, lay["attn_norm"], lay["mlp_norm"], rope, k, v, pos,
            caps=CAPS, n_heads=cfg.n_heads, norm_eps=cfg.norm_eps,
            counts=counts, routes=rts, router=lay["router"], k_exp=kx)
        assert torch.equal(sel[i, :, 0], counts[0]), (i, sel[i], counts)
        assert torch.equal(routes[i], rts[0]), (i, routes[i], rts)
        assert bool(((routes[i] >= i * E) & (routes[i] < (i + 1) * E)).all())
        for st in range(2 + 2 * kx):
            c = int(sel[i, st, 0])
            g = sel[i, st, 1:]
            assert 0 <= c <= CAPS[min(st, 2 + (st - 2) % 2)]
            assert bool((g[c:] == -1).all()) and bool((g[:c] >= 0).all())
            assert c < 2 or bool((g[1:c] > g[:c - 1]).all())


@pytest.mark.parametrize("case", ["e4-p0", "e4-p5", "e8-p5-col6"])
def test_k7_moe_cases_route_with_a_margin(jax_refs, monkeypatch, case):
    """The cases' routed experts stand clear of the next expert: each
    layer's router logits (fp32, of the stream the route folds) keep
    their top k apart from the rest by far more than the two frameworks'
    summation orders move them."""
    cfg, params, k, v, th = _port(case)
    lay = params["layers"]
    ws = tuple(lay[n] for n in llama._WEIGHTS)
    ws = (*ws[:4], *(tb.expert_stacks(w) for w in ws[4:]))
    h = params["embed"][CASES[case][5]]
    pos = torch.tensor([CASES[case][3]], dtype=torch.int32)
    kx, gaps = cfg.n_experts_per_tok, []
    route = tb.moe_route_plain

    def spy(x, norm, router, layer, k_exp, norm_eps=1e-5):
        xn = bg.selection_input(x, norm, layer, norm_eps).float()
        s = np.sort((xn @ router[layer]).numpy())[::-1]
        gaps.append(float(min(s[j] - s[j + 1] for j in range(kx))))
        return route(x, norm, router, layer, k_exp, norm_eps)
    monkeypatch.setattr(tb, "moe_route", spy)
    for i in range(cfg.n_layers):
        h = tb.layer_decode(
            h, i, th, ws, lay["attn_norm"], lay["mlp_norm"],
            _rope(jax_refs[case]), k, v, pos, caps=CAPS, n_heads=cfg.n_heads,
            norm_eps=cfg.norm_eps, router=lay["router"], k_exp=kx)
    assert len(gaps) == cfg.n_layers and min(gaps) > 1e-3, gaps


# --- the route and the plan --------------------------------------------------

def _moe_params(cfg, kind):
    """Random Mixtral params of a kind: fp32 or bf16 arrays, or int8 (all
    seven projections, the expert stacks' scales [L, E, N])."""
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.float32 if kind == "float32"
                               else torch.bfloat16, device="cpu")
    return quant.quantize_params_int8(params) if kind == "int8" else params


def _int4_moe(ws):
    """Packed int4 dicts of the seven projections' shapes at quant group
    128 (zeros: only the form matters): qp [.., K/2, N] int8, sz [.., K/128,
    2, N] fp32, the expert stacks with their [L, E] lead."""
    def pack(w):
        *lead, K, N = w.shape
        return {"qp": torch.zeros((*lead, K // 2, N), dtype=torch.int8),
                "sz": torch.zeros((*lead, K // 128, 2, N))}
    return tuple(pack(w) for w in ws)


@pytest.mark.parametrize("kind,fused", [
    ("float32", None), ("bfloat16", None), ("int8", None),
    ("float32", False), ("int8", False),
])
def test_token_decode_routes_moe(monkeypatch, kind, fused):
    """`token_decode` with a router sends one Mixtral row to K7 (one
    `token_kernel` call, no K1/K5 loop) for arrays and int8 experts where
    token_fused is not False, and the K1/K5 loop (`layer_decode`, a call a
    layer) where it is False; on the CPU both routes give the same stream
    and caches (K7's plain version composes the loop's plain kernels)."""
    cfg = get_model_config("tiny", **MOE)
    params = _moe_params(cfg, kind)
    lay = params["layers"]
    dt = llama.compute_dtype(params)
    calls = {"k7": 0, "loop": 0}
    kernel, layer = tb.token_kernel, tb.layer_decode

    def spy(name, f):
        def g(*a, **kw):
            calls[name] += 1
            return f(*a, **kw)
        return g
    monkeypatch.setattr(tb, "token_kernel", spy("k7", kernel))
    monkeypatch.setattr(tb, "layer_decode", spy("loop", layer))
    ws = tuple(lay[n] for n in llama._WEIGHTS)
    cos, sin = llama.precompute_rope(cfg, T, "cpu")
    pos = torch.tensor([4], dtype=torch.int32)
    h = params["embed"][3].to(dt)
    outs = []
    for f in ((None, False) if fused is None else (False,)):
        cache = llama.KVCache.init(cfg, 1, T, dt, "cpu")
        assert tb.k7_route(h, ws, cache.k, cfg.n_heads, CAPS, None,
                           lay["router"], token_fused=f,
                           n_experts_per_tok=2) == (f is None)
        outs.append((tb.token_decode(
            h, torch.zeros((cfg.n_layers, 7)), ws, lay["attn_norm"],
            lay["mlp_norm"], llama._rope_rows(cos, sin, pos), cache.k,
            cache.v, pos, caps=CAPS, n_heads=cfg.n_heads,
            router=lay["router"], n_experts_per_tok=2, token_fused=f),
            cache.k, cache.v))
    if fused is None:
        assert calls == {"k7": 1, "loop": cfg.n_layers}
        assert all(torch.equal(a, b) for a, b in zip(*outs))
    else:
        assert calls == {"k7": 0, "loop": cfg.n_layers}
    assert torch.isfinite(outs[0][0].float()).all()


def test_k7_moe_form_refuses():
    """K7's form takes a router for one row of arrays or int8 experts
    only: not int4 MoE (not wired, as in the reference), not two rows, not
    seq_block, not a bf16 router or one of another width; the plan refuses
    E that does not divide K7's 256 workers or passes 64, more than 8
    routed or more routed than experts; the wrapper raises on a bad routed
    count, routes, sel or a trace rather than falling back."""
    cfg = get_model_config("tiny", **MOE)
    params = _moe_params(cfg, "bfloat16")
    lay = params["layers"]
    ws = tuple(lay[n] for n in llama._WEIGHTS)
    h = params["embed"][3]
    kc = llama.KVCache.init(cfg, 1, T, torch.bfloat16, "cpu").k
    r = lay["router"]
    assert tb.k7_form(h, ws, kc, cfg.n_heads, r)
    i8 = tuple(_moe_params(cfg, "int8")["layers"][n] for n in llama._WEIGHTS)
    assert tb.k7_form(h, i8, kc, cfg.n_heads, r)
    assert not tb.k7_form(h, _int4_moe(ws), kc, cfg.n_heads, r)
    assert not tb.k7_route(h, _int4_moe(ws), kc, cfg.n_heads, CAPS, None, r,
                           n_experts_per_tok=2)
    two = llama.KVCache.init(cfg, 2, T, torch.bfloat16, "cpu").k
    assert not tb.k7_form(h[None].repeat(2, 1), ws, two, cfg.n_heads, r)
    assert not tb.k7_form(h, ws, kc, cfg.n_heads, r, seq_block=True)
    assert not tb.k7_form(h, ws, kc, cfg.n_heads, r.bfloat16())
    assert not tb.k7_form(h, ws, kc, cfg.n_heads, r[:, :128].contiguous())
    for E, k in ((6, 2), (128, 2), (16, 9), (4, 5), (4, 0)):
        assert tb._token_plan(2, 4096, 14336, 32, 8, 32768, None, 56, 32,
                              E=E, k_exp=k) is None, (E, k)
    assert tb._token_plan(2, 4096, 14336, 32, 8, 32768, None, 56, 32,
                          plan=2, E=8, k_exp=2) is None
    assert tb._token_plan(2, 4096, 14336, 32, 8, 32768, None, 56, 32,
                          rows=2, E=8, k_exp=2) is None
    cos, sin = llama.precompute_rope(cfg, T, "cpu")
    pos = torch.tensor([4], dtype=torch.int32)
    args = (h, torch.zeros((cfg.n_layers, 7)), ws, lay["attn_norm"],
            lay["mlp_norm"], llama._rope_rows(cos, sin, pos), kc,
            llama.KVCache.init(cfg, 1, T, torch.bfloat16, "cpu").v, pos)
    kw = dict(caps=CAPS, n_heads=cfg.n_heads, router=r)
    with pytest.raises(ValueError, match="routes 5 of 4"):
        tb.token_kernel(*args, n_experts_per_tok=5, **kw)
    with pytest.raises(ValueError, match="routes must"):
        tb.token_kernel(*args, n_experts_per_tok=2, **kw,
                        routes=torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="sel must"):
        tb.token_kernel(*args, n_experts_per_tok=2, **kw,
                        sel=torch.zeros((2, 4, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="no trace"):
        tb.token_kernel(*args, n_experts_per_tok=2, **kw,
                        stamps=torch.zeros((2, 8), dtype=torch.int64))
    with pytest.raises(ValueError, match="experts"):
        tb.token_kernel(*args[:2], _int4_moe(ws), *args[3:],
                        n_experts_per_tok=2, **kw)


@pytest.mark.parametrize("wplan", [0, 1], ids=["bf16", "int8"])
def test_mixtral_plans_at_max_seq_len(wplan):
    """Mixtral-8x7B (D 4096, I 14336, 32/8 heads, 8 experts, 2 routed)
    plans on the H100's table at its max_seq_len 32768 in bf16 and int8:
    Mistral-7B's structure (66 clusters of 2, the other plan) with 3 + 2
    x 2 = 7 grid barriers a layer, shared memory within a block's 232448
    bytes and equal to the layout's (the dense layout, xn [D] and the
    routing's floats), the workspace unchanged; `k7_plan` on meta tensors
    agrees with the route."""
    cfg = get_model_config("Mixtral-8x7B")
    caps = llama.token_path_caps(cfg, SparsityConfig(**MAIN))
    assert caps == (16, 16, 16, 56)
    D, I, L = cfg.dim, cfg.intermediate_size, cfg.n_layers
    args = (2, D, I, cfg.n_heads, cfg.n_kv_heads, cfg.max_seq_len, None,
            max(caps), L, 132)
    p = tb._token_plan(*args, plan=wplan, E=8, k_exp=2)
    dense = tb._token_plan(*args, plan=wplan)
    assert p is not None and p.smem <= 232448
    assert (p.grid, p.C, p.clusters, p.head_owned, p.ws_bytes) == (
        dense.grid, dense.C, dense.clusters, dense.head_owned, dense.ws_bytes)
    assert (p.C, p.clusters, p.head_owned) == (2, 66, False)
    assert p.grid_barriers == 7 * L and dense.grid_barriers == 5 * L
    GH = cfg.n_heads // cfg.n_kv_heads

    def most(cols, nw, uw=tb._tok_unit(2, wplan)):
        return nw * -(-(cols // uw) // p.clusters) * uw
    partf = max(most(D, 1), most(I, 2),
                most((cfg.n_heads + 2 * cfg.n_kv_heads) * 128, 1))
    assert p.smem == tb._token_smem(2, D, I, GH, max(caps), p.NS, partf,
                                    p.slots, wplan, 8)
    assert p.smem - tb._token_smem(2, D, I, GH, max(caps), p.NS, partf,
                                   p.slots, wplan) == D * 2 + (8 + 16) * 4
    meta = dict(device="meta")
    h = torch.empty(D, dtype=torch.bfloat16, **meta)
    kc = torch.empty((L, 1, cfg.n_kv_heads, cfg.max_seq_len, 128),
                     dtype=torch.bfloat16, **meta)
    router = torch.empty((L, D, 8), **meta)
    if wplan == 0:
        w = [torch.empty((L, D, n), dtype=torch.bfloat16, **meta)
             for n in (D, 1024, 1024, D)]
        w += [torch.empty((L, 8, D, I), dtype=torch.bfloat16, **meta)] * 2
        w += [torch.empty((L, 8, I, D), dtype=torch.bfloat16, **meta)]
    else:
        def q(lead, k, n):
            return {"q": torch.empty((*lead, k, n), dtype=torch.int8, **meta),
                    "scale": torch.empty((*lead, n), **meta)}
        w = [q((L,), D, n) for n in (D, 1024, 1024, D)]
        w += [q((L, 8), D, I)] * 2 + [q((L, 8), I, D)]
    assert tb.k7_form(h, w, kc, cfg.n_heads, router)
    assert tb.k7_plan(h, kc, w, cfg.n_heads, caps, None, router, 2) == p
    assert tb.k7_route(h, w, kc, cfg.n_heads, caps, None, router,
                       n_experts_per_tok=2)
    assert not tb.k7_route(h, w, kc, cfg.n_heads, caps, None, router,
                           n_experts_per_tok=2, token_fused=False)
