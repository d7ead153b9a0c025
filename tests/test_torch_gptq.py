"""The port's GPTQ (`teal_tpu_torch/ops/gptq.py`,
`teal_tpu_torch/calibration/gptq_runner.py`) against the JAX package's on
the CPU: the same int4 codes on the same w and x (float64 both; scale and
zero within 1e-6), GPTQ below round-to-nearest, dead inputs, the GPTQ
weights through the plain versions of kernels K1 and K3 equal to the
dequantized product, and whole-model GPTQ on tiny (block-sequential,
one-shot, intra-block) with JAX's codes."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from teal_tpu.calibration import gptq_runner as jrunner
from teal_tpu.config import get_model_config as jget_model_config
from teal_tpu.models import llama as jllama
from teal_tpu.ops import gptq as jgptq
from teal_tpu_torch.calibration import grab_acts, gptq_runner
from teal_tpu_torch.config import SparsityConfig, get_model_config
from teal_tpu_torch.models import llama
from teal_tpu_torch.ops import block_gemv as bg
from teal_tpu_torch.ops import gptq, quant


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its many small ops run tens of
    times slower on the default thread pool when the test workers share
    the cores (measured: 90 s against 2 s for the greedy loop)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _problem(K: int = 128, N: int = 64, n: int = 512, dead: int = -1):
    """Correlated calibration inputs (low rank plus noise) x [n, K] and a
    weight w [K, N], float64; input channel `dead` all zero."""
    rng = np.random.default_rng(K + N)
    basis = rng.normal(size=(16, K))
    x = rng.normal(size=(n, 16)) @ basis + 0.1 * rng.normal(size=(n, K))
    if dead >= 0:
        x[:, dead] = 0.0
    return rng.normal(size=(K, N)) * 0.1, x


def _same_codes(got, want, tol=1e-6) -> None:
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    for key in ("scale", "zero"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(want, key)),
                                   rtol=0, atol=tol)
    assert got.q.dtype == torch.int8 and got.group == want.group


@pytest.mark.parametrize("K,N,group,dead", [(128, 64, 32, -1),
                                            (128, 64, 128, -1),
                                            (256, 96, 64, -1),
                                            (128, 64, 32, 7)])
def test_gptq_codes_match_jax(K, N, group, dead):
    """The same codes as JAX's gptq_quantize_int4 on the same w and x, and
    the scale and zero within 1e-6, with and without a dead input."""
    w, x = _problem(K, N, dead=dead)
    got = gptq.gptq_quantize_int4(torch.from_numpy(w), torch.from_numpy(x),
                                  group=group)
    _same_codes(got, jgptq.gptq_quantize_int4(w, x, group=group))
    assert int(got.q.min()) >= -8 and int(got.q.max()) <= 7
    assert got.scale.dtype == got.zero.dtype == torch.float32


def test_gptq_beats_rtn():
    """On correlated inputs GPTQ's reconstruction error is below 0.9 of
    round-to-nearest's, as the JAX package's is."""
    w, x = _problem()
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    e_gptq = gptq.reconstruction_error(
        tw, gptq.gptq_quantize_int4(tw, tx, group=32), tx)
    e_rtn = gptq.reconstruction_error(tw, gptq.rtn_quantize_int4(tw, 32), tx)
    assert e_gptq < 0.9 * e_rtn, (e_gptq, e_rtn)
    want = jgptq.reconstruction_error(w, jgptq.gptq_quantize_int4(
        w, x, group=32), x)
    assert e_gptq == pytest.approx(want, rel=1e-6)
    rtn = gptq.rtn_quantize_int4(tw, 32)
    jrtn = jgptq.rtn_quantize_int4(w, 32)
    np.testing.assert_array_equal(rtn.q.numpy(), np.asarray(jrtn.q))


def test_gptq_handles_dead_inputs():
    """A dead input channel keeps H invertible and its weights zeroed: the
    error stays finite and small."""
    w, x = _problem(dead=7)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    wq = gptq.gptq_quantize_int4(tw, tx, group=32)
    e = gptq.reconstruction_error(tw, wq, tx)
    assert np.isfinite(e) and e < 0.5
    with pytest.raises(TypeError):
        gptq.gptq_quantize_int4(w, x, group=32)       # arrays: no device
    with pytest.raises(ValueError):
        gptq.gptq_quantize_int4(tw, tx, group=48)


@pytest.mark.parametrize("G", [64, 128])
def test_gptq_weights_through_int4_k1_and_k3(G):
    """GPTQ int4, packed at its group, through the plain versions of K1
    (single row, every group kept) and K3 (keep 1.0): the fp32 product
    with the dequantized weight, within 1e-5 of scale."""
    w, x = _problem(256, 128)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    wq = gptq.gptq_quantize_int4(tw, tx, group=G)
    packed = quant.pack_int4(wq)
    xv = tx[0].float()
    want = xv.double() @ quant.dequantize_int4(wq, torch.float32).double()
    scale = float(want.abs().max())
    k1, idx, count = bg.select_gather_gemv(
        xv, torch.tensor(0.0), [{k: v[None] for k, v in packed.items()}], 0,
        256 // G, G=G)
    assert int(count) == 256 // G
    assert float((k1.double() - want).abs().max()) <= 1e-5 * scale
    k3 = quant.int4_block_sparse_matmul(xv[None], packed, block_size=G,
                                        keep_frac=1.0)
    assert float((k3.double()[0] - want).abs().max()) <= 1e-5 * scale


@functools.lru_cache(maxsize=None)
def _tiny(seed: int):
    cfg, jcfg = get_model_config("tiny"), jget_model_config("tiny")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    params = llama.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return cfg, jcfg, params, jparams


MODES = {"sequential": dict(sequential=True),
         "one_shot": dict(sequential=False),
         "intra_block": dict(sequential=True, intra_block=True)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_gptq_model_matches_jax(mode):
    """Whole-model GPTQ on tiny (fp32, group 32, 32 tokens): every
    projection's codes equal JAX's, scale and zero within 1e-6; the
    quantized model's dense logits within 0.25 of the fp32 model's
    (relative norm), as the JAX package holds its own."""
    cfg, jcfg, params, jparams = _tiny(0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 32))
    got = gptq_runner.gptq_quantize_model(params, cfg, toks, group=32,
                                          **MODES[mode])
    want = jrunner.gptq_quantize_model(jparams, jcfg, toks, group=32,
                                       **MODES[mode])
    for name in gptq_runner._PROJ_INPUT:
        g, w = got["layers"][name], want["layers"][name]
        assert set(g) == {"q", "scale", "zero"}
        _same_codes(quant.Int4Weight(g["q"], g["scale"], g["zero"], 32),
                    quant.Int4Weight(w["q"], w["scale"], w["zero"], 32))
    ids = torch.from_numpy(toks[:, :8])
    zero = llama.zero_thresholds(cfg, "cpu")
    ref, _ = llama.forward(params, ids, llama.KVCache.init(
        cfg, 1, 8, torch.float32, "cpu"), 0, zero, cfg=cfg,
        sp=SparsityConfig())
    out, _ = llama.forward(got, ids, llama.KVCache.init(
        cfg, 1, 8, torch.bfloat16, "cpu"), 0, zero, cfg=cfg,
        sp=SparsityConfig())
    rel = float((out - ref).norm() / ref.norm())
    assert torch.isfinite(out).all() and rel < 0.25, rel


def test_gptq_model_hook_sees_each_projection_and_its_input():
    """`on_projection` is called once for each (layer, projection), in the
    model's order, with the input that projection was calibrated on (layer
    0's: its capture on the embedded tokens; layer 1's: its capture on
    layer 0's output through the dequantized weights) and the result that
    lands in the returned tree."""
    cfg, _, params, _ = _tiny(0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 32))
    seen = []
    got = gptq_runner.gptq_quantize_model(
        params, cfg, toks, group=32,
        on_projection=lambda *a: seen.append(a))
    names = list(gptq_runner._PROJ_INPUT)
    assert [(l, n) for l, n, *_ in seen] == [
        (l, n) for l in range(cfg.n_layers) for n in names]
    hidden = grab_acts._embed(params, toks)
    for l in range(cfg.n_layers):
        lp = grab_acts._layer_params(params, l)
        _, caps = grab_acts._layer_capture(lp, hidden, cfg)
        lq = dict(lp)
        for j, name in enumerate(names):
            _, _, w, x, wq = seen[l * len(names) + j]
            module, htype = gptq_runner._PROJ_INPUT[name]
            assert torch.equal(w, lp[name])
            assert torch.equal(x, caps[module][htype].reshape(-1, w.shape[0]))
            for key in ("q", "scale", "zero"):
                assert torch.equal(getattr(wq, key),
                                   got["layers"][name][key][l])
            lq[name] = quant.dequantize_int4(wq, w.dtype)
        hidden, _ = grab_acts._layer_capture(lq, hidden, cfg)


def test_gptq_model_rejects_intra_block_one_shot():
    cfg, _, params, _ = _tiny(0)
    with pytest.raises(ValueError):
        gptq_runner.gptq_quantize_model(params, cfg, np.zeros((1, 8), int),
                                        sequential=False, intra_block=True)
