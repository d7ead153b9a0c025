"""Checkpoint ingest and the native parameter store.

Port of `teal_tpu/utils/checkpoint.py`. HF to engine conversion (the
analog of `gpt-fast/scripts/convert_hf_checkpoint.py:22-123`, without
its RoPE un-permutation: the model uses the HF rotate-half convention):
reads single or sharded safetensors, remaps the keys, transposes the
[out, in] projections to the [in, out] layout the model multiplies with
and stacks the layers into `[L, ...]` tensors, filled one layer at a time
on the target device. Mixtral's experts stack as [L, E, ...]; its router
is rounded to the requested type, as the reference stores it, and kept
in fp32, the type the port routes in.

The safetensors reader is the port's own (the card's machine has no
`safetensors` package): an 8-byte little-endian header length, a JSON
header of {name: {"dtype", "shape", "data_offsets"}}, then the raw
little-endian data; F32, F16 and BF16 tensors are read (BF16 widened to
fp32 exactly, as the reference's reader does).

The native store is the JAX package's: `meta.json` ({key: {"dtype"}})
plus one `.npy` per leaf, keys joined with "." (`layers.wq.q`), bf16
saved as its uint16 bits. A store written by either package loads in the
other bit for bit.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import numpy as np
import torch

from teal_tpu_torch.config import ModelConfig
from teal_tpu_torch.models.llama import _device

# our stacked-leaf name -> HF per-layer tensor name
_LAYER_KEYMAP = {
    "attn_norm": "model.layers.{i}.input_layernorm.weight",
    "mlp_norm": "model.layers.{i}.post_attention_layernorm.weight",
    "wq": "model.layers.{i}.self_attn.q_proj.weight",
    "wk": "model.layers.{i}.self_attn.k_proj.weight",
    "wv": "model.layers.{i}.self_attn.v_proj.weight",
    "wo": "model.layers.{i}.self_attn.o_proj.weight",
    "wgate": "model.layers.{i}.mlp.gate_proj.weight",
    "wup": "model.layers.{i}.mlp.up_proj.weight",
    "wdown": "model.layers.{i}.mlp.down_proj.weight",
}
_TRANSPOSED = {"wq", "wk", "wv", "wo", "wgate", "wup", "wdown"}
_ST_DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": np.uint16}


class _SafetensorsFile:
    """The header of one safetensors file, and its tensors on request."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self.path, self.header, self.data_start = path, header, 8 + n

    def get(self, key: str) -> np.ndarray:
        """The tensor as a numpy array: F32 and F16 as stored, BF16 as
        fp32."""
        info = self.header[key]
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{self.path}: tensor {key} has dtype "
                             f"{info['dtype']}; the reader takes "
                             f"{sorted(_ST_DTYPES)}")
        dt = np.dtype(_ST_DTYPES[info["dtype"]])
        begin, end = info["data_offsets"]
        a = np.fromfile(self.path, dtype=dt,
                        count=(end - begin) // dt.itemsize,
                        offset=self.data_start + begin).reshape(info["shape"])
        if info["dtype"] == "BF16":
            a = (a.astype(np.uint32) << 16).view(np.float32)
        return a


class _SafetensorsIndex:
    """Uniform reader over a single or sharded safetensors checkpoint dir."""

    def __init__(self, path: str):
        self.path = path
        index_file = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(index_file):
            with open(index_file) as f:
                self.weight_map = json.load(f)["weight_map"]
        else:
            single = os.path.join(path, "model.safetensors")
            if not os.path.exists(single):
                cands = [f for f in os.listdir(path)
                         if f.endswith(".safetensors")]
                if not cands:
                    raise FileNotFoundError(f"no safetensors under {path}")
                single = os.path.join(path, cands[0])
            name = os.path.basename(single)
            self.weight_map = {k: name
                               for k in _SafetensorsFile(single).header}
        self._files: Dict[str, _SafetensorsFile] = {}

    def __contains__(self, key: str) -> bool:
        return key in self.weight_map

    def get(self, key: str) -> np.ndarray:
        fname = self.weight_map[key]
        if fname not in self._files:
            self._files[fname] = _SafetensorsFile(
                os.path.join(self.path, fname))
        return self._files[fname].get(key)


def load_hf_checkpoint(path: str, cfg: ModelConfig, dtype=torch.bfloat16,
                       device="cuda") -> Dict:
    """HF safetensors checkpoint dir -> stacked params on `device` (floats
    rounded to `dtype`; the Mixtral router rounded to `dtype` and held in
    fp32)."""
    device = _device(device)
    idx = _SafetensorsIndex(path)

    def grab(key: str, transpose: bool) -> torch.Tensor:
        t = torch.from_numpy(idx.get(key)).to(device)
        return t.T if transpose else t

    def stacked(keys, transpose: bool, out_dtype=dtype) -> torch.Tensor:
        """keys [L] or [L][E] -> one tensor [L, (E,) ...], filled a
        tensor at a time on the device."""
        lead = (len(keys),) + ((len(keys[0]),)
                               if isinstance(keys[0], list) else ())
        flat = [k for ks in keys for k in (ks if isinstance(ks, list)
                                           else [ks])]
        out = None
        for j, key in enumerate(flat):
            t = grab(key, transpose).to(dtype)
            if out is None:
                out = torch.empty((len(flat), *t.shape), dtype=out_dtype,
                                  device=device)
            out[j] = t
        return out.reshape(*lead, *out.shape[1:])

    L = cfg.n_layers
    layers: Dict[str, torch.Tensor] = {}
    keymap = dict(_LAYER_KEYMAP)
    if cfg.n_experts > 0:
        # Mixtral MoE: per-expert SwiGLU weights + router (HF keys:
        # block_sparse_moe.gate / experts.{e}.w1|w2|w3 where w1 = gate,
        # w2 = down, w3 = up)
        for k in ("wgate", "wup", "wdown"):
            del keymap[k]
        expert_map = {"wgate": "w1", "wdown": "w2", "wup": "w3"}
        for name, hf in expert_map.items():
            layers[name] = stacked(
                [[f"model.layers.{i}.block_sparse_moe.experts.{e}.{hf}.weight"
                  for e in range(cfg.n_experts)] for i in range(L)], True)
        layers["router"] = stacked(
            [f"model.layers.{i}.block_sparse_moe.gate.weight"
             for i in range(L)], True, torch.float32)
    for name, pattern in keymap.items():
        layers[name] = stacked([pattern.format(i=i) for i in range(L)],
                               name in _TRANSPOSED)

    embed = grab("model.embed_tokens.weight", False).to(dtype)
    if "lm_head.weight" in idx:
        lm_head = grab("lm_head.weight", True).to(dtype).contiguous()
    else:  # tied embeddings
        lm_head = embed.T.contiguous()
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": grab("model.norm.weight", False).to(dtype),
        "lm_head": lm_head,
    }


# -- native format ------------------------------------------------------------

def _flatten(params, prefix=""):
    out = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def save_params(params, path: str) -> None:
    """Write a params tree of tensors (any device) as a native store."""
    os.makedirs(path, exist_ok=True)
    meta = {}
    for key, t in _flatten(params).items():
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            a = t.view(torch.int16).numpy().view(np.uint16)
            meta[key] = {"dtype": "bfloat16"}
        else:
            a = t.numpy()
            meta[key] = {"dtype": str(a.dtype)}
        np.save(os.path.join(path, key + ".npy"), a)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_params(path: str, device="cuda"):
    """A native store as a params tree on `device`, every leaf in the
    type it was stored in (bf16, fp32, the int8 / packed int4 codes)."""
    device = _device(device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    params: Dict = {}
    for key, info in meta.items():
        a = np.load(os.path.join(path, key + ".npy"), mmap_mode="r")
        if info["dtype"] == "bfloat16":
            t = torch.from_numpy(np.array(a).view(np.int16)).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        node = params
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.to(device)
    return params
