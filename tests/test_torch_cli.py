"""The port's CLI (`python -m teal_tpu_torch.cli`) against the JAX
package's (`teal_tpu.cli`) on the CPU, each in-process on the same
native store that the JAX package wrote (`--device cpu` for the port):
generate at temperature 0 (dense, and speculative with a draft store)
prints the same text and acceptance, ppl the same values within 1e-4
relative, eval the same JSON, calibrate the same histograms, quantize the
same codes, convert the same store, and the misuse of
--group-thresholds exits with the same message. Self-speculation, the
device loop, --metrics and --profile, and the run as a module, are the
port's own."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from teal_tpu import cli as jcli
from teal_tpu.config import get_model_config as jget_model_config
from teal_tpu.models import llama as jllama
from teal_tpu.utils import checkpoint as jckpt
from teal_tpu_torch import cli
from teal_tpu_torch import config as tconfig
from teal_tpu_torch.utils import checkpoint as ckpt

ROOT = Path(__file__).resolve().parent.parent
HEAD128 = dict(n_layers=2, n_heads=2, n_kv_heads=2, dim=256,
               intermediate_size=384, vocab_size=512)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its many small ops run far
    slower on the default thread pool when the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """JAX-written native stores (fp32): tiny (seed 0), a draft near it
    (its weights 5% of the way to seed 1's) and the head-128 config."""
    root = tmp_path_factory.mktemp("stores")
    cfg = jget_model_config("tiny")
    p0 = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    p1 = jllama.init_params(cfg, jax.random.PRNGKey(1), jnp.float32)
    h = jllama.init_params(jget_model_config("tiny", **HEAD128),
                           jax.random.PRNGKey(3), jnp.float32)
    out = {}
    for name, tree in (("tiny", p0), ("draft", jax.tree.map(
            lambda a, b: 0.95 * a + 0.05 * b, p0, p1)), ("head128", h)):
        out[name] = str(root / name)
        jckpt.save_params(tree, out[name])
    return out


def _both(args, capsys, port_extra=("--device", "cpu")):
    """(port, JAX) captured (stdout, stderr) of one command."""
    res = []
    for main, extra in ((cli.main, list(port_extra)), (jcli.main, [])):
        main(args + extra)
        o = capsys.readouterr()
        res.append((o.out, o.err))
    return res


def _gen(store, *more):
    return ["generate", "--model", "tiny", "--checkpoint", store,
            "--prompt", "hi there", "--max-new-tokens", "12",
            "--max-seq", "64", "--temperature", "0", *more]


def test_generate_matches_jax(stores, capsys):
    (out, err), (jout, _) = _both(_gen(stores["tiny"]), capsys)
    assert out == jout and out.strip()
    assert "tok/s" in err


def test_generate_speculative_matches_jax(stores, capsys):
    """A draft store near the target: partial acceptance; the same text and
    the same printed mean accepted."""
    (out, err), (jout, jerr) = _both(_gen(
        stores["tiny"], "--draft-checkpoint", stores["draft"],
        "--speculate-k", "3"), capsys)
    assert out == jout

    def accepted(e):
        return e.split("mean accepted ")[1].split("]")[0]

    assert accepted(err) == accepted(jerr)
    assert 0.0 < float(accepted(err)) < 3.0


def test_self_speculate_is_lossless(stores, capsys, tmp_path, monkeypatch):
    """Self-speculation on the head-128 store (registered for the test as
    "tiny128"; the draft on the token path at G = 128, the verify through
    block_verify) prints the dense greedy text, host loop and device loop;
    --metrics appends a line a sample and --profile leaves a non-empty
    trace directory."""
    monkeypatch.setitem(tconfig.MODEL_REGISTRY, "tiny128",
                        dict(tconfig.MODEL_REGISTRY["tiny"], **HEAD128))
    base = ["generate", "--model", "tiny128", "--checkpoint",
            stores["head128"], "--prompt", "ab", "--max-new-tokens", "10",
            "--max-seq", "64", "--temperature", "0", "--device", "cpu"]
    cli.main(base + ["--block-size", "128"])
    dense = capsys.readouterr().out
    metrics, prof = tmp_path / "m.jsonl", tmp_path / "prof"
    for extra in ([], ["--device-loop"]):
        cli.main(base + ["--speculate-k", "3", "--self-speculate",
                         "--block-size", "128", "--metrics", str(metrics),
                         "--profile", str(prof)] + extra)
        o = capsys.readouterr()
        assert o.out == dense
        assert "speculative k=3" in o.err
    lines = [json.loads(l) for l in metrics.read_text().splitlines()]
    assert len(lines) == 2 and lines[0]["speculate_k"] == 3
    assert os.listdir(prof)


def test_ppl_matches_jax(stores, capsys):
    (out, _), (jout, _) = _both(
        ["ppl", "--model", "tiny", "--checkpoint", stores["tiny"],
         "--num-tokens", "512", "--context-size", "64", "--window-size",
         "32"], capsys)
    got = float(out.split("dense ppl: ")[1].split()[0])
    want = float(jout.split("dense ppl: ")[1].split()[0])
    assert abs(got - want) <= 1e-4 * want


def test_calibrate_then_sparse_ppl_match_jax(stores, capsys, tmp_path):
    """calibrate writes the same histograms (the same bins; counts
    within one of JAX's where an activation sits at a bin edge); ppl at
    group thresholds from them prints the same values within 1e-4."""
    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        outs[name] = str(tmp_path / name)
        main(["calibrate", "--model", "tiny", "--checkpoint",
              stores["tiny"], "--output-path", outs[name], "--batch", "1",
              "--seq-len", "64", "--group-sizes", "16,32"] + extra)
    assert "calibration artifacts written" in capsys.readouterr().out
    files = sorted(p.relative_to(outs["jax"]) for p in
                   Path(outs["jax"]).rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(outs["port"]) for p in
                           Path(outs["port"]).rglob("*") if p.is_file())
    n_hist = 0
    for f in files:
        a, b = (Path(outs[k]) / f for k in ("port", "jax"))
        if f.suffix == ".json":
            assert json.loads(a.read_text()) == json.loads(b.read_text())
            continue
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                if k.endswith("_centers") or k == "hidden":
                    np.testing.assert_allclose(za[k], zb[k], rtol=2e-5,
                                               atol=2e-5)
                else:
                    assert za[k].sum() == zb[k].sum()
                    assert np.abs(za[k] - zb[k]).max() <= 1
                    n_hist += 1
    assert n_hist > 0
    ppls = []
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        main(["ppl", "--model", "tiny", "--checkpoint", stores["tiny"],
              "--num-tokens", "512", "--context-size", "64",
              "--window-size", "32", "--sparsity", "0.5", "--hist-path",
              os.path.join(outs["port"], "histograms"), "--mode", "group",
              "--block-size", "16", "--group-thresholds"] + extra)
        out = capsys.readouterr().out
        assert "mode=group" in out
        ppls.append(float(out.split("(mode=group): ")[1].split()[0]))
    assert abs(ppls[0] - ppls[1]) <= 1e-4 * ppls[1]


def test_eval_task_file_matches_jax(stores, capsys, tmp_path):
    task = tmp_path / "task.json"
    task.write_text(json.dumps([
        {"name": "mc", "type": "multiple_choice", "docs": [
            {"query": "ab", "choices": ["cd", "ef"], "gold": 0},
            {"query": "the cat", "choices": [" sat", " ran", " is"],
             "gold": 1}]},
        {"name": "gen", "type": "generate", "until": ["\n"],
         "max_gen_toks": 4, "docs": [{"query": "hi", "target": "x"}]}]))
    (out, _), (jout, _) = _both(
        ["eval", "--model", "tiny", "--checkpoint", stores["tiny"],
         "--task-file", str(task), "--max-seq", "64"], capsys)
    assert json.loads(out) == json.loads(jout)
    assert sorted(json.loads(out)) == ["gen", "mc"]


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_matches_jax(stores, capsys, tmp_path, mode):
    """The same codes; scales and zeros within fp32 rounding."""
    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        outs[name] = str(tmp_path / name)
        main(["quantize", "--model", "tiny", "--checkpoint", stores["tiny"],
              "--mode", mode, "--group-size", "32", "--output-path",
              outs[name]] + extra)
        assert "checkpoint written" in capsys.readouterr().out
    got = ckpt._flatten(ckpt.load_params(outs["port"], device="cpu"))
    want = jckpt._flatten(jckpt.load_params(outs["jax"]))
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        a = np.asarray(want[key])
        if key.endswith(".q"):
            assert t.dtype == torch.int8
            np.testing.assert_array_equal(t.numpy(), a, err_msg=key)
        else:
            np.testing.assert_allclose(t.float().numpy(),
                                       a.astype(np.float32), rtol=1e-6,
                                       atol=0, err_msg=key)


def test_convert_matches_jax(capsys, tmp_path):
    """An HF safetensors dir converts to the same native store."""
    st = pytest.importorskip("safetensors.numpy")
    cfg = jget_model_config("tiny")
    rng = np.random.default_rng(0)
    D, I, KV, V = cfg.dim, cfg.intermediate_size, cfg.kv_dim, cfg.vocab_size
    shapes = {"model.embed_tokens.weight": (V, D), "model.norm.weight": (D,),
              "lm_head.weight": (V, D)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (D,),
            p + "post_attention_layernorm.weight": (D,),
            p + "self_attn.q_proj.weight": (D, D),
            p + "self_attn.k_proj.weight": (KV, D),
            p + "self_attn.v_proj.weight": (KV, D),
            p + "self_attn.o_proj.weight": (D, D),
            p + "mlp.gate_proj.weight": (I, D),
            p + "mlp.up_proj.weight": (I, D),
            p + "mlp.down_proj.weight": (D, I)})
    hf = tmp_path / "hf"
    hf.mkdir()
    st.save_file({k: rng.normal(0, 0.02, s).astype(np.float32)
                  for k, s in shapes.items()}, str(hf / "model.safetensors"))
    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        outs[name] = tmp_path / name
        main(["convert", "--model", "tiny", "--checkpoint", str(hf),
              "--output-path", str(outs[name])] + extra)
        assert "native checkpoint written" in capsys.readouterr().out
    meta = json.loads((outs["port"] / "meta.json").read_text())
    assert meta == json.loads((outs["jax"] / "meta.json").read_text())
    for key in meta:
        a, b = (np.load(outs[k] / (key + ".npy")) for k in ("port", "jax"))
        assert a.dtype == b.dtype and np.array_equal(a, b), key


def test_group_thresholds_misuse_exits_like_jax(stores, capsys, tmp_path):
    hist = tmp_path / "calib"
    jcli.main(["calibrate", "--model", "tiny", "--checkpoint",
               stores["tiny"], "--output-path", str(hist), "--batch", "1",
               "--seq-len", "64", "--no-layer-inputs", "--group-sizes",
               "16,32"])
    args = ["ppl", "--model", "tiny", "--checkpoint", stores["tiny"],
            "--num-tokens", "256", "--context-size", "64", "--window-size",
            "32", "--sparsity", "0.5", "--hist-path",
            str(hist / "histograms"), "--block-size", "16",
            "--group-thresholds"]
    codes = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
        with pytest.raises(SystemExit) as e:
            main(args + extra)
        codes.append(e.value.code)
    assert codes[0] == codes[1] and "GROUP-SCORE" in codes[0]


def test_device_defaults_to_cuda(stores, monkeypatch):
    """--device defaults to cuda, with no fallback: without a card the
    command fails loudly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(_gen(stores["tiny"]))


def test_runs_as_a_module(stores):
    """`python -m teal_tpu_torch.cli generate ...`, as a user runs it:
    exit 0, the text on stdout, the rate on stderr."""
    proc = subprocess.run(
        [sys.executable, "-m", "teal_tpu_torch.cli"]
        + _gen(stores["tiny"], "--device", "cpu"),
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() and "tok/s" in proc.stderr


def test_greedyopt_matches_jax(stores, capsys, tmp_path):
    """greedyopt on the JAX package's calibration (layer inputs and
    histograms) writes the same lookup rows (the same sparsities, errors
    within 2e-5)."""
    import shutil

    root = tmp_path / "jax"
    jcli.main(["calibrate", "--model", "tiny", "--checkpoint",
               stores["tiny"], "--output-path", str(root), "--batch", "1",
               "--seq-len", "64", "--group-sizes", "16,32"])
    shutil.copytree(root, tmp_path / "port")
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        main(["greedyopt", "--model", "tiny", "--checkpoint",
              stores["tiny"], "--teal-path", str(tmp_path / name),
              "--target-sparsity", "0.3", "--base-step-size", "0.1"]
             + extra)
    capsys.readouterr()
    for layer in range(2):
        rows = [np.loadtxt(tmp_path / k / "lookup" / f"layer-{layer}"
                           / "results.csv", delimiter=",", skiprows=1,
                           ndmin=2) for k in ("port", "jax")]
        assert rows[0].shape == rows[1].shape and len(rows[0]) >= 2
        np.testing.assert_allclose(rows[0], rows[1], rtol=2e-5, atol=2e-5)
