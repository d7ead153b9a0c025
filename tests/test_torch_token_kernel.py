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
ONE_CLUSTER = {c: 1 for c in range(2, 9)}
SMEM = 232448


def _check_columns(p, esz, D, I, Hq, Hkv):
    """Each stage's clusters cover its weights' columns exactly once; in
    the head-owned plan cluster c's q columns are those of kv head c's
    query heads; every kv head's attention runs on one cluster."""
    cols = tb.token_columns(p, esz, D, I, Hq, Hkv)
    widths = {"wq": D, "wk": Hkv * 128, "wv": Hkv * 128, "wo": D,
              "wgate": I, "wup": I, "wdown": D}
    stages = {"qkv": ("wq", "wk", "wv"), "o": ("wo",),
              "gate|up": ("wgate", "wup"), "down": ("wdown",)}
    for stage, names in stages.items():
        assert len(cols[stage]) == p.clusters
        seen = {n: np.zeros(widths[n], np.int64) for n in names}
        for got in cols[stage]:
            for name, a, b in got:
                assert a < b and a % (tb._TOK_UB // esz) == 0, (stage,
                                                                name, a, b)
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
    memory within a block's 232448 bytes and equal to its layout's; the
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
    live = min(T_, window or T_)
    assert p.NS == -(-(-(-(live - 1) // p.C)) // 4) * 4

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


def test_token_plan_refuses():
    """No plan where the shapes do not fit: a score slice past shared
    memory (no window, a long cache, 8 query heads a kv head), a head_dim
    other than 128, a cap above the groups, 3 query heads a kv head, a
    stream past 36 KB, no cluster that can be resident."""
    assert tb._token_plan(2, 4096, 11008, 32, 4, 1 << 20, None, 16, 32,
                          132) is None
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
    its shared bytes stay within 232448."""
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
            NS = -(-(-(-511 // C)) // 4) * 4
            # at least two slots, and room for attention's PV sums
            least = max(2, -(-(256 // (128 * esz // 16)) * GH * 512 // 16384))
            assert tb._token_smem(esz, D, I, GH, cap, NS, partf,
                                  least) > SMEM, (esz, D, I, Hkv)
            continue
        planned += 1
        assert p.smem <= SMEM and p.grid <= sms
        _check_columns(p, esz, D, I, Hq, Hkv)
    assert planned > 0


def test_token_plan_one_cluster_raises_past_shared_memory():
    """At the edge of one resident cluster a cluster owns every column:
    the 7B still plans (one cluster of 8; bf16 with six ring slots, fp32
    with four), but a 70B-wide fp32 layer's gate|up partial sums (2 x
    28672 fp32) beside its stream pass shared memory, so no plan; the tiny
    config plans too."""
    assert tb._token_plan(4, 8192, 28672, 64, 8, 512, None, 43, 32, 132,
                          ONE_CLUSTER) is None
    for esz, slots in ((2, 6), (4, 4)):
        p = tb._token_plan(esz, 4096, 11008, 32, 32, 512, None, 43, 32, 132,
                           ONE_CLUSTER)
        assert (p.C, p.clusters, p.slots) == (8, 1, slots)
        _check_columns(p, esz, 4096, 11008, 32, 32)
    p = tb._token_plan(4, 256, 384, 2, 1, 16, None, 2, 3, 132, ONE_CLUSTER)
    assert (p.C, p.clusters, p.grid, p.head_owned) == (8, 1, 8, False)
    _check_columns(p, 4, 256, 384, 2, 1)
