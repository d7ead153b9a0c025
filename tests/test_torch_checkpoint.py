"""The port's checkpoints (`teal_tpu_torch.utils.checkpoint`) against the
JAX package's on the CPU: HF safetensors dirs (single, sharded, tied
embeddings, Mixtral's experts and router) read by the port's own
safetensors reader give JAX's arrays exactly, and the native store
carries across both ways bit for bit (bf16, fp32, int8 and int4 leaves).
The test writes the safetensors files with the `safetensors` package."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from teal_tpu.config import get_model_config as jget_model_config
from teal_tpu.models import llama as jllama
from teal_tpu.ops import quant as jquant
from teal_tpu.utils import checkpoint as jckpt
from teal_tpu_torch.config import get_model_config
from teal_tpu_torch.models import llama
from teal_tpu_torch.ops import quant
from teal_tpu_torch.utils import checkpoint as ckpt

MOE = dict(n_layers=2, n_heads=2, n_kv_heads=2, dim=256,
           intermediate_size=384, vocab_size=128, n_experts=4,
           n_experts_per_tok=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its many small ops run far
    slower on the default thread pool when the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_tensors(cfg, seed):
    """A synthetic HF-format Llama / Mixtral checkpoint (fp32 numpy)."""
    rng = np.random.default_rng(seed)
    D, I, KV, V = cfg.dim, cfg.intermediate_size, cfg.kv_dim, cfg.vocab_size

    def w(*shape):
        return rng.normal(0, 0.02, size=shape).astype(np.float32)

    t = {"model.embed_tokens.weight": w(V, D),
         "model.norm.weight": w(D) + 1, "lm_head.weight": w(V, D)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = w(D) + 1
        t[p + "post_attention_layernorm.weight"] = w(D) + 1
        t[p + "self_attn.q_proj.weight"] = w(D, D)
        t[p + "self_attn.k_proj.weight"] = w(KV, D)
        t[p + "self_attn.v_proj.weight"] = w(KV, D)
        t[p + "self_attn.o_proj.weight"] = w(D, D)
        if cfg.n_experts:
            m = p + "block_sparse_moe."
            t[m + "gate.weight"] = w(cfg.n_experts, D)
            for e in range(cfg.n_experts):
                t[m + f"experts.{e}.w1.weight"] = w(I, D)
                t[m + f"experts.{e}.w2.weight"] = w(D, I)
                t[m + f"experts.{e}.w3.weight"] = w(I, D)
        else:
            t[p + "mlp.gate_proj.weight"] = w(I, D)
            t[p + "mlp.up_proj.weight"] = w(I, D)
            t[p + "mlp.down_proj.weight"] = w(D, I)
    return t


def _write(path, t, sharded=False, as_torch=None):
    """Save `t` as one file or two shards with an index; `as_torch`
    (a torch dtype) writes the tensors in that type through
    safetensors.torch."""
    st_np = pytest.importorskip("safetensors.numpy")
    if as_torch is not None:
        from safetensors.torch import save_file

        t = {k: torch.from_numpy(v).to(as_torch) for k, v in t.items()}
    else:
        save_file = st_np.save_file
    if not sharded:
        save_file(t, str(path / "model.safetensors"))
        return
    keys = sorted(t)
    weight_map = {}
    for j, part in enumerate((keys[: len(keys) // 2],
                              keys[len(keys) // 2:])):
        name = f"model-0000{j + 1}-of-00002.safetensors"
        save_file({k: t[k] for k in part}, str(path / name))
        weight_map.update({k: name for k in part})
    (path / "model.safetensors.index.json").write_text(
        json.dumps({"weight_map": weight_map}))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _assert_tree_equal(params, jparams):
    """The port's tensors equal JAX's arrays exactly, leaf for leaf, with
    the same keys (values compared in fp32: both trees' floats are of
    one type, the router fp32 in the port)."""
    flat = ckpt._flatten(params)
    jflat = ckpt._flatten(jparams)
    assert sorted(flat) == sorted(jflat)
    for key, t in flat.items():
        a = np.asarray(jflat[key])
        assert tuple(t.shape) == a.shape, key
        np.testing.assert_array_equal(_np(t), a.astype(np.float32),
                                      err_msg=key)


CASES = {"single": {}, "sharded": dict(sharded=True),
         "tied": dict(tied=True), "sharded-tied": dict(sharded=True,
                                                       tied=True),
         "mixtral": dict(moe=True)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_hf_checkpoint_matches_jax(case, dtype, tmp_path):
    kw = CASES[case]
    mkw = MOE if kw.get("moe") else {}
    cfg, jcfg = get_model_config("tiny", **mkw), jget_model_config("tiny",
                                                                  **mkw)
    t = _hf_tensors(cfg, seed=len(case))
    if kw.get("tied"):
        del t["lm_head.weight"]
    _write(tmp_path, t, sharded=kw.get("sharded", False))
    params = ckpt.load_hf_checkpoint(str(tmp_path), cfg,
                                     getattr(torch, dtype), device="cpu")
    jparams = jckpt.load_hf_checkpoint(str(tmp_path), jcfg,
                                       getattr(jnp, dtype))
    _assert_tree_equal(params, jparams)
    lay = params["layers"]
    assert lay["wq"].dtype == getattr(torch, dtype)
    if kw.get("moe"):
        assert lay["router"].dtype == torch.float32
        assert tuple(lay["wgate"].shape) == (2, 4, 256, 384)
    if kw.get("tied"):
        assert torch.equal(params["lm_head"], params["embed"].T)


@pytest.mark.parametrize("stored", [torch.bfloat16, torch.float16])
def test_reader_takes_bf16_and_f16(stored, tmp_path):
    """BF16 (which the JAX package's numpy reader refuses) and F16 files:
    the reader's values are the stored ones widened exactly (held to
    safetensors.torch's own load); F16 also to JAX's reader."""
    cfg, jcfg = get_model_config("tiny"), jget_model_config("tiny")
    t = _hf_tensors(cfg, seed=3)
    _write(tmp_path, t, as_torch=stored)
    from safetensors.torch import load_file

    ref = load_file(str(tmp_path / "model.safetensors"))
    f = ckpt._SafetensorsFile(str(tmp_path / "model.safetensors"))
    for k, v in ref.items():
        got = f.get(k)
        assert got.dtype == (np.float32 if stored == torch.bfloat16
                             else np.float16)
        np.testing.assert_array_equal(got.astype(np.float32), _np(v))
    params = ckpt.load_hf_checkpoint(str(tmp_path), cfg, torch.float32,
                                     device="cpu")
    np.testing.assert_array_equal(
        _np(params["layers"]["wdown"][1]),
        _np(ref["model.layers.1.mlp.down_proj.weight"]).T)
    if stored == torch.float16:
        _assert_tree_equal(params, jckpt.load_hf_checkpoint(
            str(tmp_path), jcfg, jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_trees():
    """JAX parameter trees of every leaf kind: bf16 and fp32 floats, int8
    {"q", "scale"}, groupwise int4 {"q", "scale", "zero"} and packed int4
    {"qp", "sz"}."""
    jcfg = jget_model_config("tiny", **{k: v for k, v in MOE.items()
                                        if not k.startswith("n_exp")})
    f32 = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return {"bf16": jax.tree.map(lambda a: a.astype(jnp.bfloat16), f32),
            "fp32": f32,
            "int8": jquant.quantize_params_int8(f32),
            "int4": jquant.quantize_params_int4(f32, group=64),
            "int4-packed": jquant.pack_int4_params(
                jquant.quantize_params_int4(f32, group=128), 128)}


def _bits(a) -> np.ndarray:
    """An array's raw bits (bf16 through uint16)."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.bfloat16 else t.numpy())


@pytest.mark.parametrize("kind", ["bf16", "fp32", "int8", "int4",
                                  "int4-packed"])
def test_native_store_jax_to_port(kind, tmp_path):
    """A store the JAX package wrote loads in the port bit for bit, each
    leaf in its stored type, on the requested device."""
    jtree = _jax_trees()[kind]
    jckpt.save_params(jtree, str(tmp_path))
    params = ckpt.load_params(str(tmp_path), device="cpu")
    flat, jflat = ckpt._flatten(params), ckpt._flatten(jtree)
    assert sorted(flat) == sorted(jflat)
    for key, t in flat.items():
        a = np.asarray(jflat[key])
        want = _bits(a)
        assert t.device.type == "cpu"
        assert str(t.dtype).split(".")[1] == a.dtype.name, key
        np.testing.assert_array_equal(_torch_bits(t), want, err_msg=key)


@functools.lru_cache(maxsize=None)
def _port_trees():
    cfg = get_model_config("tiny", **{k: v for k, v in MOE.items()
                                      if not k.startswith("n_exp")})
    f32 = llama.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
    return {"bf16": llama.init_params(cfg, torch.Generator().manual_seed(1),
                                      torch.bfloat16, "cpu"),
            "fp32": f32,
            "int8": quant.quantize_params_int8(f32),
            "int4": quant.quantize_params_int4(f32, group=64),
            "int4-packed": quant.pack_int4_params(
                quant.quantize_params_int4(f32, group=128), 128)}


@pytest.mark.parametrize("kind", ["bf16", "fp32", "int8", "int4",
                                  "int4-packed"])
def test_native_store_port_to_jax(kind, tmp_path):
    """A store the port wrote loads in the JAX package bit for bit, and
    back in the port unchanged."""
    tree = _port_trees()[kind]
    ckpt.save_params(tree, str(tmp_path))
    jtree = jckpt.load_params(str(tmp_path))
    flat, jflat = ckpt._flatten(tree), ckpt._flatten(jtree)
    assert sorted(flat) == sorted(jflat)
    again = ckpt._flatten(ckpt.load_params(str(tmp_path), device="cpu"))
    for key, t in flat.items():
        a = np.asarray(jflat[key])
        assert str(t.dtype).split(".")[1] == a.dtype.name, key
        np.testing.assert_array_equal(_bits(a), _torch_bits(t), err_msg=key)
        assert again[key].dtype == t.dtype and torch.equal(again[key], t)


def test_entry_points_default_to_cuda(tmp_path, monkeypatch):
    """Without a card, the default device fails loudly; nothing falls back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt.save_params({"w": torch.ones(2)}, str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        ckpt.load_params(str(tmp_path))
