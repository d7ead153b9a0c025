"""The port's speculative decoding (`teal_tpu_torch.engine.speculative`)
against the JAX package on the CPU.

At temperature 0 both packages' tokens, `new_tokens`, `mean_accepted`
and round counts are equal (and `k_eff_final` / `alpha_hat_final` with
adaptive depth, the latter within 1e-6): draws come from each package's
own generator, but at temperature 0 a draw and an acceptance are decided
by the logits. Each case asserts that every logits row the port turns
into probabilities has a top-2 margin above 1e-4, so that no draw rides
on a rounding difference. The acceptance arithmetic is held to JAX's
`_spec_step` on injected probabilities and uniforms; the adaptive
controller to JAX's formula. The head-128 config, whose verify takes
`block_verify` (JAX's whole-token kernel in interpret mode), runs its
JAX side in the module's subprocess (`jax_subprocess.jax_results`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_subprocess import jax_results

from teal_tpu.config import SparsityConfig as JSparsityConfig
from teal_tpu.config import get_model_config as jget_model_config
from teal_tpu.engine import speculative as jspec
from teal_tpu.models import llama as jllama
from teal_tpu_torch.config import SparsityConfig, get_model_config
from teal_tpu_torch.engine import Generator
from teal_tpu_torch.engine import speculative as spec
from teal_tpu_torch.models import llama

MARGIN = 1e-4
HEAD128 = dict(n_layers=2, n_heads=2, n_kv_heads=2, dim=256,
               intermediate_size=384, vocab_size=128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its many small ops run far
    slower on the default thread pool when the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _model(seed, name="tiny"):
    """(port cfg, JAX cfg, port params, JAX params), fp32, the same
    weights: JAX's init carried across."""
    kw = HEAD128 if name == "head128" else {}
    cfg, jcfg = get_model_config("tiny", **kw), jget_model_config("tiny", **kw)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    p = llama.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jcfg, p, jp


@functools.lru_cache(maxsize=None)
def _draft(seed, other, mix):
    """A draft near the target of `seed`: its weights moved a fraction
    `mix` of the way to another init's (port params, JAX params)."""
    jp = jax.tree.map(lambda a, b: (1 - mix) * a + mix * b, _model(seed)[3],
                      _model(other)[3])
    return llama.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu"), jp


class _Margins:
    """Records the smallest top-2 logit margin of every row the port
    turns into probabilities (`logits_to_probs`)."""

    def __init__(self, monkeypatch):
        self.rows = 0
        self.smallest = np.inf
        orig = spec.logits_to_probs

        def rec(logits, *a):
            top = torch.topk(logits.float(), 2, dim=-1).values
            gap = (top[..., 0] - top[..., 1]).min()
            self.smallest = min(self.smallest, float(gap))
            self.rows += logits.reshape(-1, logits.shape[-1]).shape[0]
            return orig(logits, *a)

        monkeypatch.setattr(spec, "logits_to_probs", rec)

    def check(self):
        assert self.rows > 0
        assert self.smallest > MARGIN, (
            f"a logits row with top-2 margin {self.smallest:.2e} <= {MARGIN}:"
            " pick another seed")


def _th(cfg, value):
    return np.full((cfg.n_layers, 7), value, np.float32)


SP = {"dense": (SparsityConfig(), JSparsityConfig()),
      "masked": (SparsityConfig(enabled=True),
                 JSparsityConfig(enabled=True)),
      "masked_prefill": (SparsityConfig(enabled=True, apply_prefill=True),
                         JSparsityConfig(enabled=True, apply_prefill=True))}

# name: (target seed, draft (other seed, mix) or None for self-draft,
# prompt, new tokens, k, target (sp, threshold), draft (sp, threshold),
# extra kwargs)
CASES = {
    "self-draft": (0, None, [1, 2, 3], 12, 4, ("dense", 0), ("dense", 0),
                   {}),
    "other-draft": (0, (42, 0.05), [5, 2, 7], 16, 4, ("dense", 0),
                     ("dense", 0), {}),
    "sparse-target": (0, None, [1, 2, 3], 10, 3, ("masked_prefill", 0.02),
                      ("masked_prefill", 0.02), {}),
    "sparse-draft-shared": (0, None, [2, 9, 4, 1], 12, 4, ("dense", 0),
                            ("masked", 0.06), {"shared_cache": True}),
    "sparse-draft-separate": (0, None, [2, 9, 4, 1], 12, 4, ("dense", 0),
                              ("masked", 0.06), {"shared_cache": False}),
    "device-loop-n-target": (0, (7, 0.05), [4, 8, 2], 16, 3, ("dense", 0),
                             ("dense", 0),
                             {"device_loop": True, "n_target": 6}),
    "adaptive": (0, None, [3, 1, 4], 12, 4, ("dense", 0), ("masked", 0.08),
                 {"device_loop": True, "adaptive_k": True}),
}


def _run_port(case, monkeypatch):
    ts, ds, prompt, n, k, (tsp, tth), (dsp, dth), kw = CASES[case]
    cfg, _, p, _ = _model(ts)
    pd = p if ds is None else _draft(ts, *ds)[0]
    margins = _Margins(monkeypatch)
    toks, st = spec.speculative_generate(
        p, pd, cfg, cfg, prompt, n, speculate_k=k, temperature=0.0,
        max_seq=64, cache_dtype=torch.float32, target_sp=SP[tsp][0],
        draft_sp=SP[dsp][0], target_thresholds=torch.from_numpy(
            _th(cfg, tth)), draft_thresholds=torch.from_numpy(_th(cfg, dth)),
        generator=torch.Generator().manual_seed(1), device="cpu", **kw)
    margins.check()
    return toks, st


def _run_jax(case):
    ts, ds, prompt, n, k, (tsp, tth), (dsp, dth), kw = CASES[case]
    _, jcfg, _, jp = _model(ts)
    jpd = jp if ds is None else _draft(ts, *ds)[1]
    return jspec.speculative_generate(
        jp, jpd, jcfg, jcfg, prompt, n, speculate_k=k, temperature=0.0,
        max_seq=64, cache_dtype=jnp.float32, target_sp=SP[tsp][1],
        draft_sp=SP[dsp][1], target_thresholds=jnp.asarray(_th(jcfg, tth)),
        draft_thresholds=jnp.asarray(_th(jcfg, dth)),
        key=jax.random.PRNGKey(5), **kw)


def _rounds(st):
    return st.get("rounds", len(st["accepted_per_step"]))


@pytest.mark.parametrize("case", list(CASES))
def test_speculative_matches_jax(case, monkeypatch):
    """Tokens and stats equal to JAX's at temperature 0: self-draft (all
    accepted), another draft near the target (partial acceptance, separate
    caches), a sparse target, a sparse self-draft on a shared and on
    separate caches, the device loop bounded by n_target, and adaptive
    depth (k_eff_final, alpha_hat_final)."""
    toks, st = _run_port(case, monkeypatch)
    jtoks, jst = _run_jax(case)
    np.testing.assert_array_equal(toks, np.asarray(jtoks))
    for key in ("new_tokens", "mean_accepted", "accepted_per_step"):
        assert st[key] == jst[key], (key, st[key], jst[key])
    assert _rounds(st) == _rounds(jst)
    if "k_eff_final" in jst:
        assert st["k_eff_final"] == jst["k_eff_final"]
        assert abs(st["alpha_hat_final"] - jst["alpha_hat_final"]) <= 1e-6
    if case == "self-draft":
        assert st["mean_accepted"] == 4.0
    if case == "other-draft":
        assert 0.0 < st["mean_accepted"] < 4.0


@pytest.mark.parametrize("case", ["self-draft", "other-draft",
                                  "sparse-draft-shared",
                                  "sparse-draft-separate", "adaptive"])
def test_speculative_equals_greedy_decode(case, monkeypatch):
    """Lossless: the speculative output at temperature 0 equals the port's
    own dense greedy decode, whatever the draft."""
    toks, _ = _run_port(case, monkeypatch)
    ts, _, prompt, n, *_ = CASES[case]
    cfg, _, p, _ = _model(ts)
    gen = Generator(cfg, p, max_seq=64, temperature=0.0,
                    cache_dtype=torch.float32, device="cpu")
    ref, _ = gen.generate(np.asarray(prompt), n)
    np.testing.assert_array_equal(toks[:len(prompt) + n],
                                  ref[0][:len(prompt) + n])


# --- the head-128 config: the verify through block_verify --------------

H128_CASES = {"shared": dict(draft_seed=None), "separate": dict(draft_seed=9)}
H128_KW = dict(prompt=[5, 2, 7], n=8, k=3)


def jax_head128(draft_seed):
    """JAX's speculative_generate on the head-128 config, its verify
    through `block_verify` in interpret mode (run by `jax_results` in the
    subprocess)."""
    from jax.experimental.pallas import tpu as pltpu

    _, jcfg, _, jp = _model(3, "head128")
    jpd = jp if draft_seed is None else _model(draft_seed, "head128")[3]
    assert jllama.can_block_verify(jp, jcfg, H128_KW["k"] + 1)
    with pltpu.force_tpu_interpret_mode():
        toks, st = jspec.speculative_generate(
            jp, jpd, jcfg, jcfg, H128_KW["prompt"], H128_KW["n"],
            speculate_k=H128_KW["k"], temperature=0.0, max_seq=64,
            cache_dtype=jnp.float32, key=jax.random.PRNGKey(5))
    return dict(toks=toks, new_tokens=st["new_tokens"],
                mean_accepted=st["mean_accepted"],
                accepted=np.asarray(st["accepted_per_step"]))


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    return jax_results(__file__, "jax_head128", H128_CASES,
                       tmp_path_factory.mktemp("jax_spec"))


@pytest.mark.parametrize("case", list(H128_CASES))
def test_block_verify_speculation_matches_jax(case, jax_refs, monkeypatch):
    """The head-128 config: the port's verify takes `block_verify` (K1's
    fixed rows form, K2's seq_block; their plain versions on the CPU),
    JAX's its whole-token kernel; tokens and stats equal."""
    cfg, _, p, _ = _model(3, "head128")
    seed = H128_CASES[case]["draft_seed"]
    pd = p if seed is None else _model(seed, "head128")[2]
    calls = []
    orig = llama.block_verify
    monkeypatch.setattr(llama, "block_verify",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    margins = _Margins(monkeypatch)
    toks, st = spec.speculative_generate(
        p, pd, cfg, cfg, H128_KW["prompt"], H128_KW["n"],
        speculate_k=H128_KW["k"], temperature=0.0, max_seq=64,
        cache_dtype=torch.float32, device="cpu")
    margins.check()
    want = jax_refs[case]
    assert len(calls) == len(st["accepted_per_step"]) > 0
    np.testing.assert_array_equal(toks, want["toks"])
    assert st["new_tokens"] == int(want["new_tokens"])
    assert st["mean_accepted"] == float(want["mean_accepted"])
    assert st["accepted_per_step"] == want["accepted"].tolist()


def test_sparse_token_path_draft_is_lossless():
    """Self-speculation with the main path's draft (the token path at G =
    128, K1's single row and K2; plain versions on the CPU) and the
    block_verify target gives the dense greedy tokens, host loop and
    adaptive device loop alike."""
    cfg, _, p, _ = _model(3, "head128")
    gen = Generator(cfg, p, max_seq=64, temperature=0.0,
                    cache_dtype=torch.float32, device="cpu")
    ref, _ = gen.generate(np.array([5, 2, 7]), 10)
    dsp = SparsityConfig(enabled=True, kernel="block", block_size=128,
                         block_keep_frac=0.5, block_thresholding=True)
    assert llama.can_token_decode(p, cfg, dsp, 1, 1, torch.float32)
    for kw in ({}, {"device_loop": True, "adaptive_k": True}):
        toks, _ = spec.speculative_generate(
            p, p, cfg, cfg, [5, 2, 7], 10, speculate_k=3, temperature=0.0,
            max_seq=64, cache_dtype=torch.float32, draft_sp=dsp,
            device="cpu", **kw)
        np.testing.assert_array_equal(toks[:13], ref[0][:13])


# --- the acceptance arithmetic on injected values ------------------------

V, K, POS0, T0, RES_TOK = 16, 4, 10, 3, 11


def _inject(seed, k_eff=None):
    """Draft tokens, draft probs (zero rows from k_eff on, the token held),
    target probs and uniforms, from a seed."""
    rng = np.random.default_rng(seed)
    dprobs = rng.random((K, V)).astype(np.float32)
    dprobs /= dprobs.sum(-1, keepdims=True)
    tprobs = rng.random((K + 1, V)).astype(np.float32)
    tprobs /= tprobs.sum(-1, keepdims=True)
    dtoks = rng.integers(0, V, K)
    u = rng.random(K).astype(np.float32)
    if k_eff is not None:
        dprobs[k_eff:] = 0
        for i in range(k_eff, K):
            dtoks[i] = dtoks[i - 1] if i else T0
    return dtoks, dprobs, tprobs, u


ARITH_CASES = {
    "qp": dict(seed=13, u_scale=1.0),
    "all-accepted": dict(seed=1, u_scale=0.0),
    "first-rejected": dict(seed=11, u_scale=1.0),
    "k_eff-2": dict(seed=3, u_scale=0.0, k_eff=2),
    "k_eff-0": dict(seed=4, u_scale=1.0, k_eff=0),
    "forced-0.5": dict(seed=5, u_scale=1.0, forced_alpha=0.5),
    "separate-cache": dict(seed=6, u_scale=1.0, shared=False),
}


def _arith_inputs(seed, u_scale, k_eff=None, **_):
    dtoks, dprobs, tprobs, u = _inject(seed, k_eff)
    return dtoks, dprobs, tprobs, u * np.float32(u_scale)


def jax_arith(seed, u_scale, k_eff=None, forced_alpha=None, shared=True):
    """JAX's `_spec_step` on injected values (run in the subprocess): the
    model calls return the injected rows as logits, `logits_to_probs` is
    the identity, each draft draw returns the injected token of the row
    it was given, `jax.random.uniform` the injected uniforms, and the
    residual's draw is recorded and answered with RES_TOK."""
    dtoks, dprobs, tprobs, u = _arith_inputs(seed, u_scale, k_eff)
    D = jnp.asarray(np.concatenate([dprobs, np.zeros((1, V), np.float32)]))
    Dt = jnp.asarray(np.concatenate([dtoks, [0]]), jnp.int32)
    residuals = []

    class FakeLlama:
        @staticmethod
        def forward(params, tokens, cache, pos, th, *, cfg, sp):
            if tokens.shape[1] == 1:
                return D[pos - POS0][None, None], cache
            return jnp.asarray(tprobs)[None], cache

        @staticmethod
        def can_block_verify(*a):
            return False

    def sample(key, probs):
        if isinstance(probs, jax.core.Tracer):
            row = jnp.argmax(jnp.all(probs[None] == D, axis=-1))
            return Dt[row]
        residuals.append(np.asarray(probs))
        return jnp.int32(RES_TOK)

    saved = (jspec.llama, jspec.logits_to_probs, jspec._sample_probs,
             jax.random.uniform)
    jspec.llama = FakeLlama
    jspec.logits_to_probs = lambda logits, t, k: logits
    jspec._sample_probs = sample
    jax.random.uniform = lambda key, shape: jnp.asarray(u)
    try:
        cache = jnp.zeros(1)
        out, n_valid, *_ = jspec._spec_step(
            None, None, cache, None if shared else cache,
            jnp.asarray([T0], jnp.int32), POS0, None, None,
            jax.random.PRNGKey(0), k=K, temperature=1.0, top_k=None,
            target_cfg=None, draft_cfg=jget_model_config("tiny",
                                                         vocab_size=V),
            target_sp=JSparsityConfig(), draft_sp=JSparsityConfig(),
            shared_cache=shared,
            k_eff=None if k_eff is None else jnp.int32(k_eff),
            forced_alpha=forced_alpha)
    finally:
        (jspec.llama, jspec.logits_to_probs, jspec._sample_probs,
         jax.random.uniform) = saved
    q = tprobs[np.arange(K), dtoks]
    p = dprobs[np.arange(K), dtoks]
    accept = (jnp.asarray(u) < (jnp.minimum(1.0, jnp.asarray(q / p))
                                if forced_alpha is None
                                else jnp.float32(forced_alpha)))
    if k_eff is not None:
        accept = accept & (jnp.arange(K) < k_eff)
    return dict(out=out, n_valid=n_valid, residual=residuals[0],
                accept=accept)


@pytest.fixture(scope="module")
def jax_arith_refs(tmp_path_factory):
    return jax_results(__file__, "jax_arith", ARITH_CASES,
                       tmp_path_factory.mktemp("jax_arith"))


@pytest.mark.parametrize("case", list(ARITH_CASES))
def test_acceptance_arithmetic_matches_jax(case, jax_arith_refs):
    """`_verify_round` and `_round_tokens` on the values injected into
    JAX's `_spec_step`: the accepted draft tokens, acc_len, the
    normalised residual and the [k+1] output; k_eff masking (steps from
    k_eff on give zero probs rows and are rejected; k_eff 0 draws from
    the target's row 0); forced_alpha."""
    kw = ARITH_CASES[case]
    dtoks, dprobs, tprobs, u = (torch.from_numpy(np.asarray(a)) for a in
                                _arith_inputs(**kw))
    accept, acc_len, residual = spec._verify_round(
        dtoks, dprobs, tprobs, u, k_eff=kw.get("k_eff"),
        forced_alpha=kw.get("forced_alpha"))
    out = spec._round_tokens(dtoks, acc_len, torch.tensor([RES_TOK]))
    want = jax_arith_refs[case]
    np.testing.assert_array_equal(accept.numpy(), want["accept"])
    assert int(acc_len) + 1 == int(want["n_valid"])
    np.testing.assert_allclose(residual.numpy(), want["residual"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(out.numpy(), want["out"])
    assert int(acc_len) == {"qp": 2, "all-accepted": K, "first-rejected": 0,
                            "k_eff-2": 2, "k_eff-0": 0}.get(case,
                                                             int(acc_len))


def test_controller_matches_jax_formula():
    """`_controller` equals a direct evaluation of the reference's
    formula (`speculative.py:333-340`) over a grid of counters."""
    for k, k_min in ((4, 0), (6, 1)):
        for acc_w in np.linspace(0.0, 12.0, 25, dtype=np.float32):
            for att_w in np.linspace(0.0, 14.0, 29, dtype=np.float32):
                a = jnp.clip(jnp.float32(acc_w) / jnp.maximum(
                    jnp.float32(att_w), 0.5), 0.02, 0.98)
                ks = jnp.arange(k + 1, dtype=jnp.float32)
                gain = (1.0 - a ** (ks + 1.0)) / (1.0 - a)
                cost = ks * 0.5 + 1.0 + 0.15
                kb = int(jnp.clip(jnp.argmax(gain / cost), k_min, k))
                got = spec._controller(acc_w, att_w, k=k, k_min=k_min)
                assert got[0] == kb, (k, acc_w, att_w)
                assert abs(got[1] - float(a)) <= 1e-6


# --- mirrors of tests/test_speculative.py ------------------------------

def test_shared_cache_requires_shared_params():
    cfg, _, p, _ = _model(0)
    pd = _model(1)[2]
    with pytest.raises(ValueError, match="shared_cache"):
        spec.speculative_generate(p, pd, cfg, cfg, [1, 2], 4, speculate_k=2,
                                  max_seq=64, cache_dtype=torch.float32,
                                  shared_cache=True, device="cpu")
    with pytest.raises(ValueError, match="adaptive_k"):
        spec.speculative_generate(p, p, cfg, cfg, [1, 2], 4, speculate_k=2,
                                  max_seq=64, cache_dtype=torch.float32,
                                  adaptive_k=True, device="cpu")


def test_forced_alpha_acceptance_rate():
    """The measurement harness realizes the forced acceptance rate: at
    alpha 0.7 and k = 4 the expected accepted count a round is
    sum_{i=1..4} 0.7^i ~= 1.77 (the reference's band 1.3-2.3), and the
    accepted-over-attempted rate lies within 4 binomial standard
    deviations of alpha."""
    cfg, _, p, _ = _model(0)
    kw = dict(speculate_k=4, temperature=1.0, max_seq=512,
              cache_dtype=torch.float32,
              draft_sp=SparsityConfig(enabled=True),
              draft_thresholds=torch.from_numpy(_th(cfg, 0.08)),
              forced_alpha=0.7, device="cpu")
    _, st = spec.speculative_generate(
        p, p, cfg, cfg, [1, 2, 3], 150, device_loop=True,
        generator=torch.Generator().manual_seed(4), **kw)
    assert 1.3 <= st["mean_accepted"] <= 2.3, st
    _, st = spec.speculative_generate(
        p, p, cfg, cfg, [1, 2, 3], 150,
        generator=torch.Generator().manual_seed(4), **kw)
    acc = np.asarray(st["accepted_per_step"])
    att = acc + (acc < 4)
    rate, n = acc.sum() / att.sum(), att.sum()
    assert abs(rate - 0.7) <= 4 * np.sqrt(0.7 * 0.3 / n), (rate, n)


def test_adaptive_controller_converges():
    """At a high forced acceptance the controller runs deep, near zero it
    collapses to the bare verify (k_eff <= 1), and still makes progress."""
    cfg, _, p, _ = _model(0)
    kw = dict(speculate_k=6, temperature=1.0, max_seq=256,
              cache_dtype=torch.float32,
              draft_sp=SparsityConfig(enabled=True),
              draft_thresholds=torch.from_numpy(_th(cfg, 0.08)),
              device_loop=True, adaptive_k=True, device="cpu")
    _, hi = spec.speculative_generate(
        p, p, cfg, cfg, [1, 2, 3], 120, forced_alpha=0.97,
        generator=torch.Generator().manual_seed(2), **kw)
    _, lo = spec.speculative_generate(
        p, p, cfg, cfg, [1, 2, 3], 60, forced_alpha=0.02,
        generator=torch.Generator().manual_seed(2), **kw)
    assert hi["k_eff_final"] >= 4 and hi["alpha_hat_final"] > 0.8, hi
    assert lo["k_eff_final"] <= 1 and lo["alpha_hat_final"] < 0.2, lo
    assert lo["new_tokens"] >= 60


def test_device_loop_matches_host_loop_sampled():
    """At temperature 1 the device loop and the host loop draw the same
    tokens from the same generator seed (the same draws in the same
    order)."""
    cfg, _, p, _ = _model(0)
    pd = _model(7)[2]
    kw = dict(speculate_k=3, temperature=1.0, top_k=20, max_seq=64,
              cache_dtype=torch.float32, device="cpu")
    host, _ = spec.speculative_generate(
        p, pd, cfg, cfg, [4, 8, 2], 14,
        generator=torch.Generator().manual_seed(11), **kw)
    dev, dst = spec.speculative_generate(
        p, pd, cfg, cfg, [4, 8, 2], 14, device_loop=True,
        generator=torch.Generator().manual_seed(11), **kw)
    np.testing.assert_array_equal(host[:len(dev)], dev)
    assert dst["rounds"] >= 1 and len(dev) == 3 + 14
