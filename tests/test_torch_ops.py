"""The port's ops and kernels' plain versions against the JAX package, on
the CPU in fp32. Inputs come from seeded numpy and go through both."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from teal_tpu.models import llama as jllama
from teal_tpu.ops import block_gemv as jbg
from teal_tpu_torch.config import SparsityConfig
from teal_tpu_torch.ops import block_gemv as tbg
from teal_tpu_torch.ops import decode_attention as tda
from teal_tpu_torch.ops import sparse_gemv as tsg
from teal_tpu_torch.ops import sparsify as tsp
from teal_tpu_torch.ops.attn_block import attn_stage
from teal_tpu_torch.ops.decode_attention import (decode_attention,
                                                 decode_attention_plain)

TOL = dict(rtol=1e-5, atol=1e-5)
# teal_tpu.ops re-exports the function `sparsify` under the module's name
jsp = importlib.import_module("teal_tpu.ops.sparsify")


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("nb,keep", [(3, 0.5), (5, 0.5), (7, 0.5), (8, 0.3),
                                     (2, 0.1), (4, 2.0)])
def test_capacity_formula(nb, keep):
    assert tsp.group_capacity(nb, keep) == \
        max(1, min(nb, int(round(nb * keep))))
    assert tsp.group_capacity(3, 0.5) == 2       # round half to even


@pytest.mark.parametrize("G,K", [(32, 4096), (32, 11008), (128, 11008),
                                 (128, 256), (128, 96), (16, 24)])
def test_effective_block_size(G, K):
    assert tbg.effective_block_size(G, K) == jbg.effective_block_size(G, K)


def test_sparsify_and_groups_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    np.testing.assert_array_equal(_np(tsp.sparsify(torch.from_numpy(x), 0.7)),
                                  np.asarray(jsp.sparsify(x, 0.7)))
    for thr in (None, 1.5, 2.5):
        for keep in (0.25, 0.5, 1.0):
            got = tsp.sparsify_groups(torch.from_numpy(x), 32, keep,
                                      threshold=thr)
            want = jsp.sparsify_groups(jnp.asarray(x), 32, keep,
                                       threshold=thr)
            np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("mode", ["teal", "group"])
@pytest.mark.parametrize("seq,apply_prefill", [(1, False), (6, False),
                                               (6, True)])
def test_apply_sparsity_matches_jax(mode, seq, apply_prefill):
    from teal_tpu.config import SparsityConfig as JSparsityConfig

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, seq, 256)).astype(np.float32)
    kw = dict(enabled=True, mode=mode, apply_prefill=apply_prefill,
              block_size=64, block_keep_frac=0.5, block_thresholding=True)
    got = tsp.apply_sparsity(torch.from_numpy(x), 2.0, SparsityConfig(**kw))
    want = jsp.apply_sparsity(jnp.asarray(x), 2.0, JSparsityConfig(**kw))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _spiky_x(rng, nb, G=128):
    """x whose group scores are well separated: group g peaks at
    1 + 0.1 * rank[g]."""
    x = rng.uniform(-0.5, 0.5, (nb, G)).astype(np.float32)
    levels = 1.0 + 0.1 * rng.permutation(nb)
    x[np.arange(nb), rng.integers(0, G, nb)] = levels * rng.choice([-1, 1], nb)
    return x.reshape(1, nb * G), np.sort(levels)[::-1]


@pytest.mark.parametrize("n_surv_of_cap", ["under", "equal", "overflow"])
@pytest.mark.parametrize("keep", [0.25, 0.5, 1.0])
def test_k1_plain_matches_jax_selection(n_surv_of_cap, keep):
    """K1's plain version keeps exactly the groups of the JAX selection and
    sums to the JAX semantics twin, for count < cap, count == cap and
    more survivors than cap (the overflow regime)."""
    rng = np.random.default_rng({"under": 3, "equal": 4, "overflow": 5}
                                [n_surv_of_cap] + int(keep * 8))
    nb, N, L, layer = 8, 256, 3, 1
    cap = tsp.group_capacity(nb, keep)
    x, levels = _spiky_x(rng, nb)
    n_surv = {"under": max(1, cap - 2), "equal": cap,
              "overflow": min(nb, cap + 3)}[n_surv_of_cap]
    thr = np.float32(levels[n_surv - 1] - 0.05) if n_surv < nb else \
        np.float32(0.5)
    w = rng.standard_normal((L, nb * 128, N)).astype(np.float32)

    out, idx, count = tbg.select_gather_gemv(
        torch.from_numpy(x[0]), torch.tensor(thr), [torch.from_numpy(w)],
        layer, cap)
    jidx, _ = jbg.select_groups(jnp.asarray(x), 128, cap,
                                threshold=jnp.float32(thr))
    n = int(count[0])
    assert n == min(n_surv, cap)
    np.testing.assert_array_equal(_np(idx[:n]), np.asarray(jidx)[:n])
    assert (_np(idx[n:]) == -1).all()
    want = jbg.block_sparse_matmul_reference(
        jnp.asarray(x), jnp.asarray(w[layer]), jnp.float32(thr),
        block_size=128, keep_frac=keep)
    np.testing.assert_allclose(_np(out), np.asarray(want)[0], **TOL)


def test_k1_plain_epilogues_match_jax():
    """Folded norm + q|k|v, residual, and silu(gate) * up against the JAX
    norm and semantics twin."""
    rng = np.random.default_rng(6)
    L, K, layer, cap, thr = 2, 512, 1, 2, np.float32(2.2)
    x = rng.standard_normal(K).astype(np.float32)
    gain = (1 + 0.1 * rng.standard_normal((L, K))).astype(np.float32)
    ws = [rng.standard_normal((L, K, n)).astype(np.float32) * 0.1
          for n in (256, 128, 128)]
    res = rng.standard_normal(256).astype(np.float32)

    xn = jllama.rms_norm(jnp.asarray(x[None]), jnp.asarray(gain[layer]),
                         1e-5)

    def twin(inp, w):
        return np.asarray(jbg.block_sparse_matmul_reference(
            inp, jnp.asarray(w[layer]), jnp.float32(thr), block_size=128,
            keep_frac=cap / (K // 128)))[0]

    t = {k: torch.from_numpy(v) for k, v in
         dict(x=x, gain=gain, res=res).items()}
    tw = [torch.from_numpy(w) for w in ws]
    thr_t = torch.tensor(thr)
    qkv, _, _ = tbg.select_gather_gemv(t["x"], thr_t, tw, layer, cap,
                                       norm=t["gain"])
    np.testing.assert_allclose(
        _np(qkv), np.concatenate([twin(xn, w) for w in ws]), **TOL)

    o, _, _ = tbg.select_gather_gemv(t["x"], thr_t, tw[:1], layer, cap,
                                     res=t["res"])
    np.testing.assert_allclose(_np(o), twin(jnp.asarray(x[None]), ws[0])
                               + res, **TOL)

    gu, _, _ = tbg.select_gather_gemv(t["x"], thr_t, tw[1:], layer, cap,
                                      norm=t["gain"], silu=True)
    g, u = twin(xn, ws[1]), twin(xn, ws[2])
    np.testing.assert_allclose(_np(gu), g / (1 + np.exp(-g)) * u, **TOL)


def test_k1_wrapper_checks():
    x = torch.zeros(256)
    w = torch.zeros(1, 256, 64)
    thr = torch.tensor(0.0)
    with pytest.raises(ValueError):
        tbg.select_gather_gemv(torch.zeros(200), thr, [w], 0, 1)
    with pytest.raises(ValueError):
        tbg.select_gather_gemv(x, thr, [w.double()], 0, 1)
    with pytest.raises(ValueError):
        tbg.select_gather_gemv(x, thr, [w], 1, 1)
    with pytest.raises(ValueError):
        tbg.select_gather_gemv(x, thr, [w], 0, 3)
    with pytest.raises(ValueError):
        tbg.select_gather_gemv(x, thr, [w], 0, 1, silu=True)
    with pytest.raises(ValueError):
        tbg.select_gather_gemv(x.to("meta"), thr.to("meta"), [w.to("meta")],
                               0, 1)


def test_block_dispatch_matches_jax_twin():
    """sparse_gemv.sparse_matmul: masked-dense and block (threshold and
    top-k) branches against the JAX semantics twins."""
    from teal_tpu.config import SparsityConfig as JSparsityConfig
    from teal_tpu.ops import sparse_gemv as jsg

    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 1, 512)).astype(np.float32)
    w = rng.standard_normal((512, 256)).astype(np.float32)
    kw = dict(enabled=True, block_size=128, block_keep_frac=0.5,
              block_thresholding=True)
    got = tsg.sparse_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            torch.tensor(2.0),
                            SparsityConfig(kernel="block", **kw))
    want = jbg.block_sparse_matmul_reference(
        jnp.asarray(x), jnp.asarray(w), jnp.float32(2.0), 128, 0.5)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    got = tsg.sparse_matmul(torch.from_numpy(x), torch.from_numpy(w), 0.8,
                            SparsityConfig(kernel="masked_dense", **kw))
    want = jsg.masked_dense_matmul(jnp.asarray(x), jnp.asarray(w), 0.8)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    xb = rng.standard_normal((3, 1, 512)).astype(np.float32)
    got = tsg.sparse_matmul(torch.from_numpy(xb), torch.from_numpy(w), 2.0,
                            SparsityConfig(kernel="block", **kw))
    want = jsg.group_masked_dense_matmul(
        jnp.asarray(xb), jnp.asarray(w), 2.0,
        JSparsityConfig(kernel="block", **kw))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    got = tsg.sparse_matmul(torch.from_numpy(x), torch.from_numpy(w), None,
                            SparsityConfig(kernel="block", enabled=True))
    want = jbg.block_sparse_matmul_reference(
        jnp.asarray(x), jnp.asarray(w), None, 32, 0.5)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_block_reference_and_select_groups_match_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 1024)).astype(np.float32)
    w = rng.standard_normal((1024, 128)).astype(np.float32)
    for thr in (1.5, 2.5, 3.5):
        got = tbg.block_sparse_matmul_reference(
            torch.from_numpy(x), torch.from_numpy(w), torch.tensor(thr),
            32, 0.5)
        want = jbg.block_sparse_matmul_reference(
            jnp.asarray(x), jnp.asarray(w), jnp.float32(thr), 32, 0.5)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        idx, xp = tbg.select_groups(torch.from_numpy(x), 32, 16,
                                    torch.tensor(thr))
        jidx, jxp = jbg.select_groups(jnp.asarray(x), 32, 16,
                                      threshold=jnp.float32(thr))
        np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
        np.testing.assert_array_equal(_np(xp), np.asarray(jxp))
    np.testing.assert_array_equal(
        _np(tbg.group_scores(torch.from_numpy(x), 64)),
        np.asarray(jbg.group_scores(jnp.asarray(x), 64)))


def _jax_attention_ref(q, kn, vn, kc, vc, li, pos, window):
    """JAX reference: write the current token, then llama._attention."""
    kc_ref, vc_ref = kc.copy(), vc.copy()
    for b, p in enumerate(pos):
        kc_ref[li, b, :, p] = kn[b]
        vc_ref[li, b, :, p] = vn[b]
    T = kc.shape[3]
    out = jllama._attention(jnp.asarray(q[:, :, None]),
                            jnp.asarray(kc_ref[li]), jnp.asarray(vc_ref[li]),
                            jnp.asarray(pos, jnp.int32), 1, T, window)
    return np.asarray(out)[:, :, 0], kc_ref, vc_ref


@pytest.mark.parametrize("Hq,Hkv,window", [(4, 4, None), (8, 2, None),
                                           (8, 2, 16), (4, 1, 5)])
def test_k2_plain_matches_jax(Hq, Hkv, window):
    """K2's plain version == cache write + llama._attention (fp32), for
    MHA/GQA, a window, and positions 0, mid and T-1."""
    rng = np.random.default_rng(Hq * 10 + Hkv)
    L, B, T, D = 2, 3, 64, 128
    kc = rng.standard_normal((L, B, Hkv, T, D)).astype(np.float32)
    vc = rng.standard_normal((L, B, Hkv, T, D)).astype(np.float32)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    pos = np.array([0, 37, T - 1], np.int32)
    for li in (0, L - 1):
        want, kc_ref, vc_ref = _jax_attention_ref(q, kn, vn, kc, vc, li,
                                                  pos, window)
        tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        got = decode_attention(torch.from_numpy(q), torch.from_numpy(kn),
                               torch.from_numpy(vn), tkc, tvc, li,
                               torch.from_numpy(pos), window=window)
        np.testing.assert_allclose(_np(got), want, **TOL)
        np.testing.assert_array_equal(_np(tkc), kc_ref)
        np.testing.assert_array_equal(_np(tvc), vc_ref)


def test_k2_rope_matches_jax_apply_rope():
    """RoPE in K2's prologue == llama.apply_rope on q and k."""
    from teal_tpu.config import get_model_config

    rng = np.random.default_rng(9)
    cfg = get_model_config("tiny", n_heads=4, n_kv_heads=2, dim=512)
    L, B, T, D = 1, 1, 32, 128
    cos, sin = jllama.precompute_rope(cfg, T)
    p = 21
    kc = rng.standard_normal((L, B, 2, T, D)).astype(np.float32)
    vc = rng.standard_normal((L, B, 2, T, D)).astype(np.float32)
    q = rng.standard_normal((B, 4, D)).astype(np.float32)
    kn = rng.standard_normal((B, 2, D)).astype(np.float32)
    vn = rng.standard_normal((B, 2, D)).astype(np.float32)
    c, s = np.asarray(cos)[p][None, None], np.asarray(sin)[p][None, None]
    qr = np.asarray(jllama.apply_rope(q[:, :, None], c, s))[:, :, 0]
    kr = np.asarray(jllama.apply_rope(kn[:, :, None], c, s))[:, :, 0]
    want, kc_ref, _ = _jax_attention_ref(qr, kr, vn, kc, vc, 0, [p], None)
    rope = torch.from_numpy(np.stack([np.asarray(cos)[p],
                                      np.asarray(sin)[p]])[None])
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(kn),
                                 torch.from_numpy(vn), tkc, tvc, 0,
                                 torch.tensor([p], dtype=torch.int32),
                                 rope=rope)
    np.testing.assert_allclose(_np(got), want, **TOL)
    np.testing.assert_allclose(_np(tkc), kc_ref, **TOL)


def test_k2_wrapper_checks():
    kc = torch.zeros(1, 1, 2, 16, 128)
    q = torch.zeros(1, 4, 128)
    kn = torch.zeros(1, 2, 128)
    with pytest.raises(ValueError):
        decode_attention(q, kn, kn, kc, kc.clone(), 0, 16)
    with pytest.raises(ValueError):
        decode_attention(torch.zeros(1, 3, 128), kn, kn, kc, kc.clone(), 0, 1)
    with pytest.raises(ValueError):
        decode_attention(q, kn, kn, kc, kc.clone(), 1, 1)
    with pytest.raises(ValueError):
        decode_attention(q.double(), kn, kn, kc, kc.clone(), 0, 1)


@pytest.mark.parametrize("seq_block", [False, True])
@pytest.mark.parametrize("sms", [114, 132])
def test_k2_split_rule(seq_block, sms):
    """K2's split rule as a pure function of shapes (no pos argument):
    a power of two in [1, 8], at most `_BLOCKS_PER_SM` blocks an SM where
    it splits at all, each split with rows at T; the plan fitted on it
    keeps S a power of two that divides the head dim, and its slot groups
    cover the B slots exactly once."""
    import inspect

    assert "pos" not in inspect.signature(tda._splits).parameters
    for B in ((1, 2, 8, 16) if seq_block else (1, 2, 3, 4, 8, 16)):
        for Hkv in (1, 2, 8, 32):
            for T in (16, 64, 512, 2048, 8192):
                S = tda._splits(B, Hkv, T, seq_block, sms)
                assert S in (1, 2, 4, 8)
                clusters = Hkv * (1 if seq_block else B)
                assert S == 1 or clusters * S <= tda._BLOCKS_PER_SM * sms
                assert S == 1 or T // S >= tda._MIN_SPLIT_ROWS
                for GH in (1, 4, 8):
                    for esz in (2, 4):
                        S2, slots = tda._plan(B, GH * Hkv, Hkv, T, seq_block,
                                              esz, sms)
                        assert S2 in (1, 2, 4, 8) and S2 >= S
                        assert tda.HEAD_DIM % S2 == 0
                        groups = -(-B // slots)
                        assert (slots == 1 if not seq_block else
                                groups * slots >= B > (groups - 1) * slots)
    assert tda._splits(1, 32, 2048, False, 132) == 8
    assert tda._splits(16, 32, 2048, False, 132) == 1
    assert tda._splits(1, 32, 512, seq_block, 132) == 8


def _old_k2_fits(GH, T, seq_block):
    """The shared-memory check of the kernel before the split (one block
    per row and kv head, the whole score row in shared memory)."""
    prev = 2 * tda.MAX_SEQ_BLOCK * 128 if seq_block else 0
    return 4 * (2 * GH * 128 + 2 * 128 + 64 + prev + GH * T) <= 227 * 1024


@pytest.mark.parametrize("seq_block", [False, True])
def test_k2_check_accepts_every_shape_it_accepted(seq_block):
    """Every (GH, T) the one-block kernel accepted still has a plan, at
    B = 1 and at the largest slot count, fp32 and bf16, up to the largest
    T it accepted; GH = 8 then fits at a T four times larger."""
    B = tda.MAX_SEQ_BLOCK if seq_block else 16
    for GH in (1, 2, 4, 8):
        top = max(T for T in range(1, 80000, 7) if _old_k2_fits(GH, T,
                                                                seq_block))
        for T in (1, 64, 512, top // 2, top - 7, top):
            assert _old_k2_fits(GH, T, seq_block)
            for b in (1, B):
                for esz in (2, 4):
                    assert tda._plan(b, GH, 1, T, seq_block, esz) is not None
    top8 = max(T for T in range(1, 80000, 7) if _old_k2_fits(8, T, seq_block))
    assert not _old_k2_fits(8, 4 * top8, seq_block)
    assert tda._plan(1, 8, 1, 4 * top8, seq_block, 2) is not None


def test_k2_wrapper_checks_shared_memory():
    """`_check` (through the CPU wrapper) takes GH = 8 at the one-block
    kernel's largest T and at 3x it, and raises where no plan fits."""
    for T, ok in ((6968, True), (3 * 6968, True), (60000, False)):
        kc = torch.zeros(1, 1, 1, T, 128)
        q = torch.zeros(1, 8, 128)
        kn = torch.zeros(1, 1, 128)
        if ok:
            out = decode_attention(q, kn, kn, kc, kc.clone(), 0, T - 1)
            assert out.shape == (1, 8, 128)
        else:
            with pytest.raises(ValueError, match="shared memory"):
                decode_attention(q, kn, kn, kc, kc.clone(), 0, T - 1)


# the token path's four K1 stages at Llama-2-7B: (K, output columns,
# weights of one tile: 2 for gate|up), and their caps at keep 0.5
_K1_7B_STAGES = {"qkv": (4096, 12288, 1), "o": (4096, 4096, 1),
                 "gate|up": (4096, 11008, 2), "down": (11008, 4096, 1)}


@pytest.mark.parametrize("stage", list(_K1_7B_STAGES))
@pytest.mark.parametrize("sms", [114, 132])
def test_k1_rows_plan_at_7b(stage, sms):
    """K1's rows-form plan as a pure function of shapes (no B, no count):
    S in {1, 2, 4}, a cluster of C <= 8 blocks that is a multiple of S
    and divides the grid into whole clusters, shared memory within a
    block's 227 KB, at most two blocks an SM at 7B and, for bf16, shared
    memory for all of them at once, at every cap; it takes no B, so one plan serves B = 2..16.
    For every kept count the S shares of a tile's kept list cover it
    once, in order, each non-empty when count >= S (else some are empty,
    which the kernel skips)."""
    import inspect

    params = inspect.signature(tbg._rows_plan).parameters
    assert not {"B", "rows", "count"} & set(params)
    K, n_out, nw = _K1_7B_STAGES[stage]
    nb = K // 128
    for esz in (2, 4):
        for plan in (tbg.PLAN_STREAM, tbg.PLAN_INT8, tbg.PLAN_INT4):
            for cap in (1, tbg.block_capacity(nb, 0.5), nb):
                S, C, stages, smem = tbg._rows_plan(esz, plan, nw, K, n_out,
                                                    cap, sms)
                grid = n_out // tbg.ROWS_TILE * S
                assert S in (1, 2, 4) and C in (1, 2, 4, 8) and C % S == 0
                assert grid % C == 0 and 2 <= stages <= 8
                assert smem == tbg._rows_smem(esz, plan, nw, stages, S, C,
                                              nb, cap) <= 232448
                per_sm = -(-grid // sms)
                assert per_sm <= 2 and (esz == 4 or per_sm * (smem + 1024)
                                        <= 233472)
                for count in range(cap + 1):
                    shares = [(count * s // S, count * (s + 1) // S)
                              for s in range(S)]
                    assert shares[0][0] == 0 and shares[-1][1] == count
                    assert all(a[1] == b[0] for a, b in
                               zip(shares, shares[1:]))
                    if count >= S:
                        assert all(hi > lo for lo, hi in shares)
    # the rule's choice at the 7B shapes on a 132-SM card, bf16
    if sms == 132:
        want = {"qkv": (1, 8), "o": (2, 8), "gate|up": (1, 4),
                "down": (2, 8)}[stage]
        assert tbg._rows_plan(2, 0, nw, K, n_out, 16)[:2] == want


def test_k1_rows_plan_limits():
    """Widths that are not whole 64-column tiles have no plan (the card
    wrapper raises on them; the CPU path takes them); the split rule
    reaches S = 4, 2 and 1 through the widths (up to 33, 66 and beyond
    at 132 SMs), each with a cluster that is a multiple of S and divides
    the grid."""
    assert tbg._rows_plan(2, 0, 1, 256, 96, 1) is None
    assert tbg._rows_plan(2, 0, 1, 200, 64, 1) is None
    for tiles, splits in ((1, 4), (3, 4), (16, 4), (33, 4), (34, 2),
                          (66, 2), (67, 1), (172, 1), (192, 1)):
        S, C, _, smem = tbg._rows_plan(2, 0, 1, 4096, 64 * tiles, 16)
        assert S == splits and C % S == 0 and (tiles * S) % C == 0
        assert smem <= 232448
    out, _, _ = tbg.select_gather_gemv(torch.ones(2, 256), torch.tensor(0.0),
                                       [torch.zeros(1, 256, 96)], 0, 1)
    assert out.shape == (2, 96)


# the same stages as K1's single row reads them: (K, widths, weights of
# one tile), caps at keep 0.5
_K1_7B_ROW = {"qkv": (4096, (4096, 4096, 4096), 1), "o": (4096, (4096,), 1),
              "gate|up": (4096, (11008, 11008), 2),
              "down": (11008, (4096,), 1)}


@pytest.mark.parametrize("stage", list(_K1_7B_ROW))
@pytest.mark.parametrize("sms", [114, 132])
def test_k1_plan_at_7b(stage, sms):
    """K1's single-row plan as a pure function of shapes: at the 7B
    stages, every G, both stream types and every weight plan, S (a power
    of two <= 8) fills the card -- the grid of tiles * S blocks within one
    block an SM, and no doubling of S that would still be -- a cluster of
    C <= 8 blocks that is a multiple of S and divides the grid, and shared
    memory for two blocks an SM (the kernel's launch bounds) within the
    227 KB of one; at 132 SMs bf16 G = 128 takes S = 1 for q|k|v (96
    tiles) and gate|up (86), 4 for o and down (32)."""
    K, ns, nw = _K1_7B_ROW[stage]
    for G in tbg.GROUP_SIZES:
        nb = K // G
        for esz in (2, 4):
            for plan in (tbg.PLAN_STREAM, tbg.PLAN_INT8, tbg.PLAN_INT4):
                if plan == tbg.PLAN_INT4 and G < 64:
                    continue
                for cap in (1, tbg.block_capacity(nb, 0.5), nb):
                    S, C, stages, smem = tbg._sgg_plan(esz, plan, nw, G, ns,
                                                       K, cap, sms)
                    tw = tbg._sgg_tile(esz, plan)
                    tiles = (-(-ns[0] // tw) if nw == 2
                             else sum(-(-n // tw) for n in ns))
                    assert S in (1, 2, 4, 8) and tiles * S <= max(sms, tiles)
                    assert S == 8 or tiles * 2 * S > sms
                    assert C in (1, 2, 4, 8) and C % S == 0
                    assert (tiles * S) % C == 0 and stages == 8
                    assert smem == tbg._sgg_smem(esz, plan, nw, G, nb, cap)
                    assert 2 * (smem + 1024) <= 233472
    if sms == 132:
        want = {"qkv": (1, 8), "o": (4, 8), "gate|up": (1, 2),
                "down": (4, 8)}[stage]
        assert tbg._sgg_plan(2, 0, nw, 128, ns, K, 16)[:2] == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [64, 128, 192, 256, 320, 2048, 2560])
def test_k6_plan_covers_every_query_row_once(dtype, S):
    """K6's launch plan at the 7B (32/32) and GQA (32/8) heads, B = 1 and
    2, on a 132-SM card: the query tiles cover rows 0..S-1 once (a last
    half tile where S % 128 == 64 stores only its rows below S); shared
    memory within a block's 227 KB. bf16: a persistent grid of at most
    one block an SM whose schedule takes every (query tile, head, batch
    row) once, the longest rows first, and evens out the causal work
    (the busiest block within 5% of the mean, or one tile of it)."""
    from teal_tpu_torch.ops import flash_prefill as fp

    for Hq, Hkv in ((32, 32), (32, 8)):
        for B in (1, 2):
            tiles, rows, blocks, threads, smem = fp._plan(dtype, B, Hq, S,
                                                          132)
            assert smem <= fp.SMEM_LIMIT and Hq % Hkv == 0
            seen = [r for t in range(tiles)
                    for r in range(t * rows, min(S, (t + 1) * rows))]
            assert seen == list(range(S))
            if dtype == torch.float32:
                assert (threads, blocks) == (fp.FP32_THREADS,
                                             B * Hq * tiles)
                continue
            assert threads == fp.THREADS
            assert blocks == min(132, B * Hq * tiles)
            sched = fp._schedule(tiles, B * Hq, blocks)
            got = sorted(x for mine in sched for x in mine)
            assert got == sorted((t, hb) for t in range(tiles)
                                 for hb in range(B * Hq))
            assert sched[0][0] == (tiles - 1, 0)
            work = [sum(t + 1 for t, _ in mine) for mine in sched]
            mean = sum(work) / len(work)
            assert max(work) <= max(1.05 * mean, mean + tiles)


def test_attn_stage_composes_k1_and_k2():
    """The attention stage == K1 on q|k|v then K2 (plain versions)."""
    rng = np.random.default_rng(10)
    L, D, T = 2, 256, 16
    h = torch.from_numpy(rng.standard_normal(D).astype(np.float32))
    ws = [torch.from_numpy(rng.standard_normal((L, D, n)).astype(np.float32)
                           * 0.05) for n in (256, 128, 128)]
    norm = torch.ones(L, D)
    kc = torch.from_numpy(rng.standard_normal((L, 1, 1, T, 128))
                          .astype(np.float32))
    vc = kc * 0.5
    rope = torch.stack([torch.ones(128), torch.zeros(128)])[None]
    pos = torch.tensor([7], dtype=torch.int32)
    thr = torch.tensor(1.0)
    kc2, vc2 = kc.clone(), vc.clone()
    attn, count = attn_stage(h, thr, *ws, 1, 1, norm, 1e-5, kc, vc, pos,
                             rope, n_heads=2)
    qkv, _, c2 = tbg.select_gather_gemv(h, thr, ws, 1, 1, norm=norm)
    want = decode_attention_plain(qkv[:256].view(1, 2, 128),
                                  qkv[256:384].view(1, 1, 128),
                                  qkv[384:].view(1, 1, 128), kc2, vc2, 1,
                                  pos, rope=rope)
    np.testing.assert_array_equal(_np(attn), _np(want).reshape(-1))
    np.testing.assert_array_equal(_np(kc), _np(kc2))
    assert int(count[0]) == int(c2[0])
