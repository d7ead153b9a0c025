"""K8, the one-row attention stage (`ops/attn_block.py`), against the JAX
package on the CPU: `attn_block` (on CPU tensors its plain version
`attn_block_plain`, K1's and K2's plain versions composed) against JAX's
one-launch `attn_block.attn_block` in interpret mode, on the cases of
`tests/test_kernels.py::test_fused_attn_block_model_equivalence` (MHA 2/2,
GQA 4/2, a window of 20; `decode_attention.CHUNK` 16 over T 48, so the
reference walks three chunks; pos 0, 15, 16 and 40): fp32 at G 32, 64
and 128, threshold and fixed selection, the output and both caches within
2e-5; packed int4 at G 64 in bf16 within 2^-7 of scale. The references
run in one subprocess for the module (`jax_subprocess.jax_results`,
`jax_reference` below). Then `attn_stage`'s route (`k8_route`: one row of
arrays or packed int4 to K8, every other form to K1 + K2) and K8's launch
plan (`k8_plan`), from shapes alone. Inputs come from seeded numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax_subprocess import jax_results

from teal_tpu.ops import attn_block as jab
from teal_tpu.ops import block_gemv as jbg
from teal_tpu.ops import decode_attention as jda
from teal_tpu.ops import quant as jq
from teal_tpu_torch.ops import attn_block as tab
from teal_tpu_torch.ops import quant as tq

TOL = dict(rtol=2e-5, atol=2e-5)
L, LAYER, T, CHUNK, KEEP = 2, 1, 48, 16, 0.75

# (name): (stream, weights, G, Hq, Hkv, window, pos, survivors, fixed);
# survivors "under": cap - 1 groups over the threshold, "over": every group
CASES = {
    "fp32-g128-mha-p0": ("float32", "array", 128, 2, 2, None, 0, "over",
                         False),
    "fp32-g128-mha-p40": ("float32", "array", 128, 2, 2, None, 40, "under",
                          False),
    "fp32-g32-mha-p15": ("float32", "array", 32, 2, 2, None, 15, "under",
                         False),
    "fp32-g32-gqa-p16": ("float32", "array", 32, 4, 2, None, 16, "over",
                         False),
    "fp32-g128-gqa-p40": ("float32", "array", 128, 4, 2, None, 40, "under",
                          False),
    "fp32-g32-win-p40": ("float32", "array", 32, 2, 2, 20, 40, "under",
                         False),
    "fp32-g128-gqawin-p15": ("float32", "array", 128, 4, 2, 20, 15, "over",
                             False),
    "fp32-g64-win-p0": ("float32", "array", 64, 2, 2, 20, 0, "under", False),
    "fp32-g32-gqa-fixed-p40": ("float32", "array", 32, 4, 2, None, 40,
                               "under", True),
    "int4-g64-mha-p40": ("bfloat16", "int4", 64, 2, 2, None, 40, "under",
                         False),
}


def _np(t):
    return t.detach().cpu().float().numpy()


def _bf16(a):
    """a rounded to bf16, as fp32 numpy."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def _case(name):
    """A CASES entry's inputs as numpy: h [K], gains [L, K], q|k|v fp32
    [L, K, N] each, caches [L, 1, Hkv, T, 128], cos/sin [128] at pos,
    cap, the threshold and the case's constants."""
    dts, kind, G, Hq, Hkv, window, pos, surv, fixed = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 5)
    K = 256 * (Hq // 2)
    nb = K // G
    cap = max(1, min(nb, int(round(nb * KEEP))))
    h = rng.standard_normal(K).astype(np.float32)
    gain = (1 + 0.1 * rng.standard_normal((L, K))).astype(np.float32)
    ws = [(rng.standard_normal((L, K, n)) * 0.05).astype(np.float32)
          for n in (Hq * 128, Hkv * 128, Hkv * 128)]
    kc = (rng.standard_normal((L, 1, Hkv, T, 128)) * 0.1).astype(np.float32)
    vc = (rng.standard_normal((L, 1, Hkv, T, 128)) * 0.1).astype(np.float32)
    if dts == "bfloat16":
        h, gain, kc, vc = (_bf16(a) for a in (h, gain, kc, vc))
    inv = 1.0 / (10000.0 ** (np.arange(0, 64, dtype=np.float32) / 64))
    ang = np.concatenate([pos * inv, pos * inv]).astype(np.float32)
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    xs = h / np.sqrt(np.mean(h * h) + 1e-5) * gain[LAYER]
    s = np.sort(np.abs(xs).reshape(nb, G).max(-1))[::-1]
    if surv == "over":
        thr = np.float32(s[-1] * 0.5)
    else:
        thr = np.float32(0.5 * (s[cap - 2] + s[cap - 1]) if cap > 1
                         else s[0] * 0.5)
    assert np.min(np.abs(s - thr)) > 1e-3 * thr
    return dict(h=h, gain=gain, ws=ws, kc=kc, vc=vc, cos=cos, sin=sin,
                cap=cap, thr=thr, dts=dts, kind=kind, G=G, Hq=Hq, Hkv=Hkv,
                window=window, pos=pos, fixed=fixed)


def _jax_attn_block(name):
    """JAX's `attn_block` (interpret mode, `decode_attention.CHUNK` 16) on a
    CASES entry (run by `jax_results` in the subprocess)."""
    c = _case(name)
    dt = jnp.dtype(c["dts"])
    G = c["G"]
    if c["kind"] == "int4":
        ws = []
        for w in c["ws"]:
            packs = [jq.pack_int4(jq.quantize_int4(jnp.asarray(w[i]), G))
                     for i in range(L)]
            ws.append({k: jnp.stack([p[k] for p in packs])
                       for k in ("qp", "sz")})
    else:
        ws = [jnp.asarray(w) for w in c["ws"]]
    jda.CHUNK = CHUNK
    with pltpu.force_tpu_interpret_mode():
        out, kc, vc = jab.attn_block(
            jbg.pack_x3(jnp.asarray(c["h"], dt)[None], G),
            jnp.asarray([c["thr"]]), ws, jnp.asarray(c["cos"]),
            jnp.asarray(c["sin"]), jnp.asarray(c["kc"], dt),
            jnp.asarray(c["vc"], dt), LAYER, c["pos"], G=G, cap=c["cap"],
            n_heads=c["Hq"], norm3=jbg.pack_norm3(jnp.asarray(c["gain"]), G),
            norm_eps=1e-5, window=c["window"], fixed_sel=c["fixed"])
    return {k: np.asarray(v.astype(jnp.float32))
            for k, v in (("out", out), ("kc", kc), ("vc", vc))}


def _port_inputs(c):
    """The port's tensors for a `_case`: (h, thr, wq, wk, wv, norm, kc, vc,
    pos, rope)."""
    dt = getattr(torch, c["dts"])
    if c["kind"] == "int4":
        ws = [{k: torch.stack([tq.pack_int4(tq.quantize_int4(
            torch.from_numpy(w[i]), c["G"]))[k] for i in range(L)])
            for k in ("qp", "sz")} for w in c["ws"]]
    else:
        ws = [torch.from_numpy(w).to(dt) for w in c["ws"]]
    rope = torch.from_numpy(np.stack([c["cos"], c["sin"]])[None])
    return (torch.from_numpy(c["h"]).to(dt), torch.tensor(c["thr"]), *ws,
            torch.from_numpy(c["gain"]).to(dt),
            torch.from_numpy(c["kc"]).to(dt),
            torch.from_numpy(c["vc"]).to(dt),
            torch.tensor([c["pos"]], dtype=torch.int32), rope)


@pytest.mark.parametrize("name", sorted(CASES))
def test_k8_plain_matches_jax_attn_block(name, jax_refs):
    """K8's wrapper on CPU tensors (`attn_block_plain`) == JAX's one-launch
    `attn_block` (interpret mode): the attention output and both caches
    (the written row and every other), fp32 within 2e-5, packed int4 in
    bf16 within 2^-7 of scale; the kept count is that of the threshold."""
    c = _case(name)
    h, thr, wq, wk, wv, norm, kc, vc, pos, rope = _port_inputs(c)
    out, idx, count = tab.attn_block(
        h, thr, wq, wk, wv, LAYER, c["cap"], norm, 1e-5, kc, vc, pos, rope,
        n_heads=c["Hq"], window=c["window"], G=c["G"], fixed=c["fixed"])
    want = jax_refs[name]
    kept = c["cap"] if c["fixed"] or CASES[name][7] == "over" else \
        c["cap"] - 1 if c["cap"] > 1 else 1
    kept_idx = _np(idx).astype(int).tolist()
    assert int(count[0]) == kept and kept_idx[kept:] == [-1] * (c["cap"]
                                                              - kept)
    assert kept_idx[:kept] == (list(range(kept)) if c["fixed"]
                               else sorted(set(kept_idx[:kept])))
    got = {"out": _np(out).reshape(want["out"].shape), "kc": _np(kc),
           "vc": _np(vc)}
    for k in ("out", "kc", "vc"):
        if c["kind"] == "int4":
            scale = np.abs(want[k]).max()
            assert np.abs(got[k] - want[k]).max() <= 2 ** -7 * scale, k
        else:
            np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


# --- the route and the plan, from shapes -------------------------------

def _route_args(rows=1, dtype=torch.float32, Hq=4, Hkv=2, hd=128, K=512,
                int4=False, cache_dtype=None, device="cpu"):
    """(h, wq, wk, wv, kc) of the given form (no values needed)."""
    def t(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    h = t(K) if rows == 1 else t(rows, K)
    if int4:
        ws = [{"qp": t(L, K // 2, n, dt=torch.int8),
               "sz": t(L, K // 128, 2, n, dt=torch.float32)}
              for n in (Hq * hd, Hkv * hd, Hkv * hd)]
    else:
        ws = [t(L, K, n) for n in (Hq * hd, Hkv * hd, Hkv * hd)]
    kc = t(L, rows, Hkv, 64, hd, dt=cache_dtype or dtype)
    return h, ws, kc


@pytest.mark.parametrize("form,k8", [
    ("one row fp32", True), ("one row bf16", True), ("one row [1, K]", True),
    ("packed int4", True), ("int8 scales", False), ("rows", False),
    ("seq_block", False), ("head_dim 64", False),
    ("3 heads a kv head", False), ("cache of another type", False)])
def test_k8_route(form, k8):
    """`k8_route`: K8 for one row of arrays of the stream type or of packed
    int4 (G >= 64); K1 + K2 for int8 (its scales), rows, seq_block,
    head_dim != 128, a shape `k8_plan` refuses and a cache of another
    type."""
    kw, extra, G = {}, {}, 128
    if form == "one row bf16":
        kw = dict(dtype=torch.bfloat16)
    elif form == "packed int4":
        kw = dict(dtype=torch.bfloat16, int4=True)
    elif form == "rows":
        kw = dict(rows=4)
    elif form == "head_dim 64":
        kw = dict(hd=64)
    elif form == "3 heads a kv head":
        kw = dict(Hq=6, K=768)
    elif form == "cache of another type":
        kw = dict(cache_dtype=torch.bfloat16)
    h, ws, kc = _route_args(**kw)
    if form == "one row [1, K]":
        h = h[None]
    if form == "int8 scales":
        extra = dict(scales=tuple(torch.ones(L, w.shape[-1]) for w in ws))
    if form == "seq_block":
        extra = dict(seq_block=True)
    n_heads = kw.get("Hq", 4)
    assert tab.k8_route(h, *ws, kc, n_heads, 2, G, **extra) is k8


@pytest.mark.parametrize("k8", [True, False])
def test_attn_stage_takes_the_route(k8, monkeypatch):
    """`attn_stage` launches K8 alone where `k8_route` holds (one row of
    arrays) and K1 then K2 where it does not (seq_block), on the same
    values: the same output either way on the CPU."""
    rng = np.random.default_rng(3)
    D, Hq, Hkv = 256, 2, 1
    h = torch.from_numpy(rng.standard_normal(D).astype(np.float32))
    ws = [torch.from_numpy((rng.standard_normal((L, D, n)) * 0.05)
                           .astype(np.float32)) for n in (256, 128, 128)]
    norm = torch.ones(L, D)
    kc = torch.from_numpy(rng.standard_normal((L, 1, Hkv, 16, 128))
                          .astype(np.float32))
    vc = kc * 0.5
    rope = torch.stack([torch.ones(128), torch.zeros(128)])[None]
    pos = torch.tensor([5], dtype=torch.int32)
    calls = []
    for name in ("attn_block", "select_gather_gemv", "decode_attention"):
        fn = getattr(tab, name)
        monkeypatch.setattr(tab, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    out = tab.attn_stage(h, torch.tensor(0.5), *ws, 1, 1, norm, 1e-5,
                         kc.clone(), vc.clone(), pos, rope, n_heads=Hq,
                         seq_block=not k8)[0]
    assert calls == (["attn_block"] if k8 else
                     ["select_gather_gemv", "decode_attention"])
    ref = tab.attn_block_plain(h, torch.tensor(0.5), *ws, 1, 1, norm, 1e-5,
                               kc.clone(), vc.clone(), pos, rope,
                               n_heads=Hq)[0]
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


# the slice's shapes, fp32, and one past two blocks an SM: (what, stream
# type code, weight plan, G, K, Hq, Hkv, cap, C)
PLAN_CASES = [
    ("7B path B", 1, tab.PLAN_STREAM, 32, 4096, 32, 32, 64, 6),
    ("7B loop", 1, tab.PLAN_STREAM, 128, 4096, 32, 32, 16, 6),
    ("7B fp32", 0, tab.PLAN_STREAM, 128, 4096, 32, 32, 16, 3),
    ("7B int4", 1, tab.PLAN_INT4, 128, 4096, 32, 32, 16, 3),
    ("7B int4 G64", 1, tab.PLAN_INT4, 64, 4096, 32, 32, 32, 3),
    ("Mixtral loop", 1, tab.PLAN_STREAM, 128, 4096, 32, 8, 16, 8),
    ("70b cut int4", 1, tab.PLAN_INT4, 128, 8192, 64, 8, 32, 8),
    ("K 32768", 1, tab.PLAN_STREAM, 128, 32768, 32, 32, 16, 3),
]


@pytest.mark.parametrize("what,code,plan,G,K,Hq,Hkv,cap,C", PLAN_CASES)
def test_k8_plan_of_the_slice(what, code, plan, G, K, Hq, Hkv, cap, C):
    """Every shape of the slice has a plan within a block's shared memory
    (232448 bytes) on the H100's 132 SMs: one cluster of C blocks a kv head.
    The 7B's 32 kv heads: bf16 arrays clusters of 6, 192 blocks, two an SM;
    fp32 and int4 (over 128 registers a thread, one block an SM) clusters
    of 3; at K 32768 two blocks' selection inputs of 128 KiB do not fit an
    SM, so one an SM: clusters of 3."""
    got = tab.k8_plan(code, plan, G, K, Hq, Hkv, cap)
    assert got is not None and got[0] == C and got[1] == Hkv * C, got
    assert got[2] <= 232448 and got[2] == tab._k8_smem(K, G, cap, Hq // Hkv)


def test_k8_plan_refuses_what_it_does_not_take():
    """No plan for GH outside 1, 2, 4, 8, packed int4 at G 32, a cap
    outside [1, K / G], a G that does not divide K, or a layout past
    shared memory (a selection input of K 65536 fp32)."""
    assert tab.k8_plan(1, tab.PLAN_STREAM, 128, 768, 6, 2, 3) is None
    assert tab.k8_plan(1, tab.PLAN_INT4, 32, 4096, 32, 32, 64) is None
    assert tab.k8_plan(1, tab.PLAN_STREAM, 128, 4096, 32, 32, 0) is None
    assert tab.k8_plan(1, tab.PLAN_STREAM, 128, 4096, 32, 32, 33) is None
    assert tab.k8_plan(1, tab.PLAN_STREAM, 128, 4000, 32, 32, 16) is None
    assert tab.k8_plan(1, tab.PLAN_STREAM, 128, 65536, 32, 32, 16) is None


@pytest.mark.parametrize("T", [512, 32768])
def test_k8_plan_does_not_grow_with_T(T):
    """The route from shapes on meta tensors at the 70b cut's widths
    (int4, 64/8 heads, K 8192) takes K8 at T 512 and at T 32768 with the
    same shared-memory size: the kernel walks the cache in chunks of a
    fixed number of rows (fault 3.1's lesson)."""
    h, ws, kc = _route_args(dtype=torch.bfloat16, Hq=64, Hkv=8, K=8192,
                            int4=True, device="meta")
    kc = torch.zeros((L, 1, 8, T, 128), dtype=torch.bfloat16, device="meta")
    assert tab.k8_route(h, *ws, kc, 64, 32, 128)
    assert tab.k8_plan(1, tab.PLAN_INT4, 128, 8192, 64, 8, 32)[2] == \
        tab._k8_smem(8192, 128, 32, 8)


def test_k8_wrapper_checks():
    """`attn_block` raises on what K8 does not take: rows, int8 weights,
    a position that is no int32 [1], a cache of another type."""
    h, ws, kc = _route_args()
    thr, norm = torch.tensor(0.1), torch.ones(L, 512)
    rope = torch.zeros(1, 2, 128)
    pos = torch.tensor([3], dtype=torch.int32)
    args = (norm, 1e-5, kc, kc.clone(), pos, rope)
    tab.attn_block(h, thr, *ws, 1, 2, *args, n_heads=4)
    with pytest.raises(ValueError):
        tab.attn_block(h.expand(2, -1).contiguous(), thr, *ws, 1, 2, *args,
                       n_heads=4)
    with pytest.raises(ValueError):
        tab.attn_block(h, thr, *[w.to(torch.int8) for w in ws], 1, 2, *args,
                       n_heads=4)
    with pytest.raises(ValueError):
        tab.attn_block(h, thr, *ws, 1, 2, norm, 1e-5, kc, kc.clone(),
                       pos.long(), rope, n_heads=4)
    with pytest.raises(ValueError):
        tab.attn_block(h, thr, *ws, 1, 2, norm, 1e-5, kc.bfloat16(),
                       kc.bfloat16(), pos, rope, n_heads=4)


# --- the JAX references, in one subprocess for the module -------------------

def jax_reference(kind, **kw):
    """Every interpret-mode reference of this module, by kind: "attn" (a
    CASES entry) (run by `jax_results` in the subprocess)."""
    return {"attn": _jax_attn_block}[kind](**kw)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    cases = {name: dict(kind="attn", name=name) for name in CASES}
    return jax_results(__file__, "jax_reference", cases,
                       tmp_path_factory.mktemp("jax_attn_block"))
