"""The ops of the port's layer-loop decode against the JAX package, on the
CPU in fp32: the selection twins, K1 at group sizes 32 and 64, K3
(`block_gather_gemv_multi`), K4 (`row_gather_gemv`) with its compaction,
and the projections built on them. The JAX Pallas kernels run in
interpret mode, once per module in one subprocess
(`jax_subprocess.jax_results`, `jax_reference` below), so a hang of the
interpreter fails these cases instead of stalling the run; the port's
wrappers run their plain versions. Inputs come from seeded numpy.
Tolerance 2e-5: fp32 sums of the same products in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax_subprocess import jax_results

from teal_tpu.config import SparsityConfig as JSparsityConfig
from teal_tpu.models import llama as jllama
from teal_tpu.ops import block_gemv as jbg
from teal_tpu.ops import gather_gemv as jgg
from teal_tpu.ops import sparse_gemv as jsg
from teal_tpu_torch.config import SparsityConfig
from teal_tpu_torch.ops import block_gemv as tbg
from teal_tpu_torch.ops import gather_gemv as tgg
from teal_tpu_torch.ops import sparse_gemv as tsg

TOL = dict(rtol=2e-5, atol=2e-5)


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _spiky(rng, rows, nb, G):
    """[rows, nb * G] inputs whose group scores (per row and pooled over
    rows) are distinct: each group peaks at 1 + 0.1 * its rank."""
    x = rng.uniform(-0.5, 0.5, (rows, nb, G)).astype(np.float32)
    for r in range(rows):
        levels = 1.0 + 0.1 * rng.permutation(nb) + 0.01 * r
        x[r, np.arange(nb), rng.integers(0, G, nb)] = levels
    return x.reshape(rows, nb * G)


@pytest.mark.parametrize("G,k_keep", [(32, 4), (64, 3), (32, 8)])
def test_selection_twins_match_jax(G, k_keep):
    """select_groups (top-k, its dense fast path at k_keep >= nb, and
    threshold), select_groups_batched and batched_group_mask (pooled
    top-k and threshold) on tie-free inputs."""
    rng = np.random.default_rng(G + k_keep)
    nb = 8
    x = _spiky(rng, 3, nb, G)
    for thr in (None, 1.35):
        jt = None if thr is None else jnp.float32(thr)
        tt = None if thr is None else torch.tensor(thr)
        idx, xp = tbg.select_groups(_t(x[:1]), G, k_keep, tt)
        jidx, jxp = jbg.select_groups(jnp.asarray(x[:1]), G, k_keep, jt)
        np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
        np.testing.assert_array_equal(_np(xp), np.asarray(jxp))
        idx, xp = tbg.select_groups_batched(_t(x), G, k_keep, tt)
        jidx, jxp = jbg.select_groups_batched(jnp.asarray(x), G, k_keep, jt)
        np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
        np.testing.assert_array_equal(_np(xp), np.asarray(jxp))
        np.testing.assert_array_equal(
            _np(tbg.batched_group_mask(_t(x), G, k_keep, tt)),
            np.asarray(jbg.batched_group_mask(jnp.asarray(x), G, k_keep, jt)))
    w = torch.zeros(1, 8 * G, 32)
    for block_size, K in ((32, 4096), (32, 11008), (16, 24)):
        assert tbg._shared_group_size([w], block_size, K) == \
            jbg._shared_group_size([jnp.zeros((K, 32))], block_size, K)
    for nb_, keep in ((128, 0.5), (172, 0.5), (3, 0.5), (8, None)):
        assert tbg.block_capacity(nb_, keep) == \
            max(1, min(nb_, int(round(nb_ * (keep or 0.625)))))
    # int8 dicts keep the group size, packed int4 raises it to >= 64
    jz = jnp.zeros((8, 32))
    for block_size, K in ((32, 256), (128, 4096), (16, 24)):
        for tw, jw in (({"q": w, "scale": w}, {"q": jz, "scale": jz}),
                       ({"qp": w, "sz": w}, {"qp": jz, "sz": jz})):
            assert tbg._shared_group_size([w, tw], block_size, K) == \
                jbg._shared_group_size([jz, jw], block_size, K)


def _k1_case(seed, G, L=3, nb=8, norm=True, n_ws=(64, 32, 32)):
    rng = np.random.default_rng(seed)
    K = nb * G
    x = _spiky(rng, 1, nb, G)[0] * 1.7
    gain = (1 + 0.1 * rng.standard_normal((L, K))).astype(np.float32)
    ws = [(rng.standard_normal((L, K, n)) * 0.1).astype(np.float32)
          for n in n_ws]
    return x, (gain if norm else None), ws


K1_KERNEL_CASES = [(32, True), (64, False)]


def _k1_kernel_case(G, norm):
    """test_k1_plain_at_group_size_matches_jax_kernel's inputs: x, gain,
    ws, layer, cap and a threshold with 5 survivors (cap 4)."""
    x, gain, ws = _k1_case(11 + G, G, norm=norm)
    layer, cap = 2, 4
    xs = x if gain is None else np.asarray(jllama.rms_norm(
        jnp.asarray(x[None]), jnp.asarray(gain[layer]), 1e-5))[0]
    scores = np.abs(xs).reshape(-1, G).max(-1)
    thr = np.float32(np.sort(scores)[2] + 1e-3)      # 5 survivors, cap 4
    return x, gain, ws, layer, cap, thr


def _jax_k1_kernel(G, norm):
    """The JAX Pallas kernel `fused_select_gather_gemv` (interpret mode)
    on a K1_KERNEL_CASES entry (run by `jax_results` in the
    subprocess)."""
    x, gain, ws, layer, cap, thr = _k1_kernel_case(G, norm)
    with pltpu.force_tpu_interpret_mode():
        want = jbg.fused_select_gather_gemv(
            jbg.pack_x3(jnp.asarray(x[None]), G), jnp.asarray([thr]),
            [jnp.asarray(w) for w in ws], G=G, cap=cap,
            out_dtype=jnp.float32, layer=layer,
            norm3=None if gain is None else jbg.pack_norm3(
                jnp.asarray(gain), G))
    return {"out": np.concatenate([np.asarray(o)[0] for o in want])}


@pytest.mark.parametrize("G,norm", K1_KERNEL_CASES)
def test_k1_plain_at_group_size_matches_jax_kernel(G, norm, jax_refs):
    """K1's plain version at G = 32 / 64 == the JAX Pallas kernel
    `fused_select_gather_gemv` (interpret mode), with and without the
    folded norm."""
    x, gain, ws, layer, cap, thr = _k1_kernel_case(G, norm)
    got = tbg.fused_select_gather_gemv(
        _t(x), torch.tensor(thr), [_t(w) for w in ws], layer, G, cap,
        norm=None if gain is None else _t(gain))
    np.testing.assert_allclose(_np(got), jax_refs[f"k1-{G}-{int(norm)}"]
                               ["out"], **TOL)


@pytest.mark.parametrize("G", [32, 64])
@pytest.mark.parametrize("regime", ["under", "equal", "overflow"])
def test_k1_plain_at_group_size_matches_jax_twin(G, regime):
    """K1's plain version at G = 32 / 64, with the folded norm, keeps the
    groups of the JAX selection and sums to the JAX semantics twin, for
    count < cap, count == cap and more survivors than cap."""
    x, gain, ws = _k1_case(20 + G + len(regime), G, L=2, nb=12)
    layer, cap = 1, 6
    xn = jllama.rms_norm(jnp.asarray(x[None]), jnp.asarray(gain[layer]),
                         1e-5)
    scores = np.sort(np.abs(np.asarray(xn)[0]).reshape(-1, G).max(-1))[::-1]
    n_surv = {"under": 3, "equal": cap, "overflow": 9}[regime]
    thr = np.float32((scores[n_surv - 1] + scores[n_surv]) / 2)
    out, idx, count = tbg.select_gather_gemv(
        _t(x), torch.tensor(thr), [_t(w) for w in ws], layer, cap, G=G,
        norm=_t(gain))
    jidx, _ = jbg.select_groups(xn, G, cap, threshold=jnp.float32(thr))
    n = int(count[0])
    assert n == min(n_surv, cap)
    np.testing.assert_array_equal(_np(idx[:n]), np.asarray(jidx)[:n])
    want = [np.asarray(jbg.block_sparse_matmul_reference(
        xn, jnp.asarray(w[layer]), jnp.float32(thr), block_size=G,
        keep_frac=cap / 12))[0] for w in ws]
    np.testing.assert_allclose(_np(out), np.concatenate(want), **TOL)


K3_KERNEL_CASES = [(32, 1, (64, 32, 32)), (64, 1, (96,)), (32, 8, (64,)),
                   (64, 8, (32, 64))]


def _k3_kernel_case(G, rows, n_ws):
    """test_k3_plain_matches_jax_kernel's inputs: the JAX selection's
    idx / xpack, ws, layer and k_keep."""
    rng = np.random.default_rng(G + rows + len(n_ws))
    L, nb, k_keep, layer = 3, 8, 5, 1
    x = _spiky(rng, max(rows, 1), nb, G)
    ws = [(rng.standard_normal((L, nb * G, n)) * 0.1).astype(np.float32)
          for n in n_ws]
    if rows == 1:
        jidx, jxp = jbg.select_groups(jnp.asarray(x), G, k_keep)
    else:
        jidx, jxp = jbg.select_groups_batched(jnp.asarray(x), G, k_keep)
    return jidx, jxp, ws, layer, k_keep


def _jax_k3_kernel(G, rows, n_ws):
    """The JAX Pallas kernel `block_gather_gemv_multi` (interpret mode) on
    a K3_KERNEL_CASES entry (run by `jax_results` in the subprocess)."""
    jidx, jxp, ws, layer, k_keep = _k3_kernel_case(G, rows, tuple(n_ws))
    with pltpu.force_tpu_interpret_mode():
        want = jbg.block_gather_gemv_multi(
            jidx, jxp, [jnp.asarray(w) for w in ws], G=G, k_keep=k_keep,
            out_dtype=jnp.float32, layer=layer, out_rows=rows)
    return {"out": np.concatenate([np.asarray(o) for o in want], axis=1)}


@pytest.mark.parametrize("G,rows,n_ws", K3_KERNEL_CASES)
def test_k3_plain_matches_jax_kernel(G, rows, n_ws, jax_refs):
    """K3's plain version == the JAX Pallas kernel
    `block_gather_gemv_multi` (interpret mode) on the same idx / xpack:
    1-3 layer-stacked weights at a layer index, 1 or 8 input rows."""
    jidx, jxp, ws, layer, _ = _k3_kernel_case(G, rows, n_ws)
    got = tbg.block_gather_gemv_multi(_t(jidx), _t(jxp),
                                      [_t(w) for w in ws], layer, G, rows)
    np.testing.assert_allclose(
        _np(got), jax_refs[f"k3-{G}-{rows}-{len(n_ws)}"]["out"], **TOL)


def _projection_case():
    """test_projections_match_jax's inputs: x [3, K], gain, two weights,
    layer, threshold."""
    rng = np.random.default_rng(31)
    L, K, layer = 2, 384, 1
    x = _spiky(rng, 3, K // 32, 32) * 1.3
    gain = (1 + 0.1 * rng.standard_normal((L, K))).astype(np.float32)
    ws = [(rng.standard_normal((L, K, n)) * 0.1).astype(np.float32)
          for n in (128, 32)]
    return x, gain, ws, layer, np.float32(1.95)


def _projection_calls(x, gain, ws, layer, thr, jax: bool):
    """project_many (threshold with the folded norm; top-k),
    project_many_batched (pooled top-k and threshold) and
    block_sparse_matmul of one package: a list of their outputs."""
    if jax:
        w, arr, scalar = [jnp.asarray(a) for a in ws], jnp.asarray, \
            jnp.float32
        bg, norm_kw = jbg, dict(norm3=jbg.pack_norm3(jnp.asarray(gain), 32))
    else:
        w, arr, scalar = [_t(a) for a in ws], _t, torch.tensor
        bg, norm_kw = tbg, dict(norm=_t(gain))
    outs = list(bg.project_many(arr(x[:1]), w, 32, 0.5, layer=layer,
                                threshold=scalar(thr), **norm_kw))
    outs += bg.project_many(arr(x[1:2]), w, 64, 0.5, layer=layer)
    for t in (None, thr):
        outs += bg.project_many_batched(
            arr(x), w, 32, 0.5, layer=layer,
            threshold=None if t is None else scalar(t))
    outs.append(bg.block_sparse_matmul(arr(x[:1]), w[0][layer], None, 32,
                                       0.25))
    return outs


def _jax_projections():
    """The JAX package's projections (interpret mode) on
    `_projection_case` (run by `jax_results` in the subprocess)."""
    with pltpu.force_tpu_interpret_mode():
        outs = _projection_calls(*_projection_case(), jax=True)
    return {str(i): np.asarray(o) for i, o in enumerate(outs)}


def test_projections_match_jax(jax_refs):
    """project_many (threshold with the folded norm: K1; top-k: K3),
    project_many_batched (pooled top-k and threshold: K3) and
    block_sparse_matmul against the JAX package's (interpret mode)."""
    got = _projection_calls(*_projection_case(), jax=False)
    want = jax_refs["projections"]
    assert len(got) == len(want)
    for i, g in enumerate(got):
        np.testing.assert_allclose(_np(g), want[str(i)], **TOL)


K4_FRACS = [0.3, 0.7]


def _k4_case(frac):
    """test_k4_plain_and_compaction_match_jax_kernel's inputs: x, w,
    threshold, nnz_cap and the JAX compaction's idx / values."""
    rng = np.random.default_rng(int(frac * 10))
    K, N, thr = 256, 128, np.float32(0.6)
    x = rng.standard_normal((1, 1, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    nnz_cap = max(1, int(K * frac))
    jidx, jvals = jgg.compact_indices(jnp.asarray(x), jnp.float32(thr),
                                      nnz_cap)
    return x, w, thr, nnz_cap, jidx, jvals


def _jax_k4(frac):
    """The JAX Pallas `row_gather_gemv` and the gather dispatch of
    `sparse_matmul` (interpret mode) on a K4_FRACS entry (run by
    `jax_results` in the subprocess)."""
    x, w, thr, nnz_cap, jidx, jvals = _k4_case(frac)
    with pltpu.force_tpu_interpret_mode():
        want = jgg.row_gather_gemv(jidx, jvals, jgg.pack_weight_rows(
            jnp.asarray(w)), nnz_cap=nnz_cap, out_dtype=jnp.float32)
        want_mm = jsg.sparse_matmul(
            jnp.asarray(x), jnp.asarray(w), jnp.float32(thr),
            JSparsityConfig(enabled=True, kernel="gather",
                            gather_cap_frac=frac))
    return {"gemv": np.asarray(want)[0], "mm": np.asarray(want_mm)}


@pytest.mark.parametrize("frac", K4_FRACS)
def test_k4_plain_and_compaction_match_jax_kernel(frac, jax_refs):
    """compact_indices and K4's plain version == the JAX package's
    compaction and Pallas `row_gather_gemv` (interpret mode), with the
    survivor count above (frac 0.3) and below (0.7) nnz_cap; and the
    gather dispatch of `sparse_matmul` == the JAX one."""
    x, w, thr, nnz_cap, jidx, jvals = _k4_case(frac)
    n_surv = int((np.abs(x) > thr).sum())
    assert (n_surv > nnz_cap) == (frac == 0.3)
    idx, vals = tgg.compact_indices(_t(x), torch.tensor(thr), nnz_cap)
    np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
    np.testing.assert_array_equal(_np(vals), np.asarray(jvals))
    got = tgg.row_gather_gemv(idx, vals, _t(w))
    sp = SparsityConfig(enabled=True, kernel="gather", gather_cap_frac=frac)
    got_mm = tsg.sparse_matmul(_t(x), _t(w), torch.tensor(thr), sp)
    want = jax_refs[f"k4-{frac}"]
    np.testing.assert_allclose(_np(got), want["gemv"], **TOL)
    np.testing.assert_allclose(_np(got_mm), want["mm"], **TOL)
    with pytest.raises(NotImplementedError):
        tsg.sparse_matmul(_t(np.repeat(x, 2, axis=0)), _t(w),
                          torch.tensor(thr), sp)


def test_k3_k4_wrapper_checks():
    idx = torch.zeros(2, dtype=torch.int32)
    xp = torch.zeros(2, 1, 128)
    w = torch.zeros(1, 256, 64)
    for bad in (dict(idx=idx.long()), dict(xpack=xp[:, :, :64]),
                dict(xpack=xp.double()), dict(rows=2), dict(G=48),
                dict(G=256), dict(layer=1), dict(ws=[w.double()]),
                dict(ws=[w] * 4)):
        kw = dict(dict(idx=idx, xpack=xp, ws=[w], layer=0, G=32, rows=1),
                  **bad)
        with pytest.raises(ValueError):
            tbg.block_gather_gemv_multi(**kw)
    xc = torch.zeros(2)
    for bad in (dict(idx=idx.long()), dict(xc=xc.double()),
                dict(xc=torch.zeros(3)), dict(w=w[0, :, :40]),
                dict(w=w[0].double())):
        kw = dict(dict(idx=idx, xc=xc, w=w[0]), **bad)
        with pytest.raises(ValueError):
            tgg.row_gather_gemv(**kw)


# --- the JAX references, in one subprocess for the module -------------------

def jax_reference(kind, **kw):
    """Every interpret-mode reference of this module, by kind: "k1", "k3"
    (an entry of K1_KERNEL_CASES / K3_KERNEL_CASES), "projections", "k4"
    (a K4_FRACS entry) (run by `jax_results` in the subprocess)."""
    return {"k1": _jax_k1_kernel, "k3": _jax_k3_kernel,
            "projections": _jax_projections, "k4": _jax_k4}[kind](**kw)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    cases = {f"k1-{G}-{int(norm)}": dict(kind="k1", G=G, norm=norm)
             for G, norm in K1_KERNEL_CASES}
    cases.update({f"k3-{G}-{rows}-{len(n_ws)}": dict(
        kind="k3", G=G, rows=rows, n_ws=list(n_ws))
        for G, rows, n_ws in K3_KERNEL_CASES})
    cases["projections"] = dict(kind="projections")
    cases.update({f"k4-{f}": dict(kind="k4", frac=f) for f in K4_FRACS})
    return jax_results(__file__, "jax_reference", cases,
                       tmp_path_factory.mktemp("jax_layer_ops"))
