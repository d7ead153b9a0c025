"""Shared inputs and rank groups for the port's parallelism tests.

`np_params` builds the parameter tree of `init_params`' layout in numpy
from a seed, so that the JAX package and the port get the same weights.
`Ranks` starts a group of real gloo ranks on the CPU (one spawned
process a rank, started by the port's `initialize_distributed` from
torchrun's RANK / WORLD_SIZE and `init_method="file://..."`, so that no
port is taken; one thread a rank) that runs every case of a test module
once. With `nodes=n` it starts them as torchrun does on n nodes instead
(`torchrun_env`: RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
GROUP_RANK, MASTER_ADDR = 127.0.0.1 and a free MASTER_PORT), and each
rank calls `initialize_distributed()` with no arguments, so the group
starts through `env://`. A case is a
function of this module run on every rank, which returns a dict of
numpy arrays (an exception is the case's result: `{"error": "Type:
message"}`). A module starts its group in its fixture, computes its JAX
references meanwhile, and joins the group after.

This module imports torch and the port only: the rank processes never
import JAX.
"""

from __future__ import annotations

import json
import multiprocessing
import socket
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

RANK_TIMEOUT_S = 300.0           # a whole group's run, start-up included


# --- inputs ---------------------------------------------------------------

def model_config(cfg: dict):
    """The port's ModelConfig of a case's config overrides (the JAX
    package's `get_model_config` takes the same)."""
    from teal_tpu_torch.config import get_model_config

    return get_model_config(cfg.get("name", "tiny"),
                            **{k: v for k, v in cfg.items() if k != "name"})


def np_params(cfg: dict, seed: int) -> dict:
    """fp32 parameters of init_params' layout: N(0, 0.02^2) weights,
    norm gains 1 + N(0, 0.1^2), Mixtral's router N(0, 1) (clear top-k
    margins)."""
    c = model_config(cfg)
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.02):
        return (rng.standard_normal(shape, dtype=np.float32) * scale)

    L, D, I, KV, V = (c.n_layers, c.dim, c.intermediate_size, c.kv_dim,
                      c.vocab_size)
    layers = {"attn_norm": 1 + w(L, D, scale=0.1),
              "mlp_norm": 1 + w(L, D, scale=0.1),
              "wq": w(L, D, D), "wk": w(L, D, KV), "wv": w(L, D, KV),
              "wo": w(L, D, D)}
    if c.n_experts > 0:
        E = c.n_experts
        layers.update({"router": w(L, D, E, scale=1.0),
                       "wgate": w(L, E, D, I), "wup": w(L, E, D, I),
                       "wdown": w(L, E, I, D)})
    else:
        layers.update({"wgate": w(L, D, I), "wup": w(L, D, I),
                       "wdown": w(L, I, D)})
    return {"embed": w(V, D), "layers": layers,
            "final_norm": 1 + w(D, scale=0.1), "lm_head": w(D, V)}


def np_cache(cfg: dict, batch: int, max_seq: int, seed=None,
             scale: float = 0.1):
    """(k, v) [L, B, Hkv, T, Dh] fp32: zeros, or N(0, scale^2) from seed."""
    c = model_config(cfg)
    shape = (c.n_layers, batch, c.n_kv_heads, max_seq, c.head_dim)
    if seed is None:
        return np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape, dtype=np.float32) * scale,
            rng.standard_normal(shape, dtype=np.float32) * scale)


def port_params(cfg: dict, seed: int, quant=None):
    """The port's CPU tensors of `np_params`, quantized by the port:
    "int8" (`quantize_params_int8`: the seven stacks and the head),
    "int8-head" (only the head), "int4" (the layers packed at group and
    block 128, the head left fp32, as the reference's TP test builds it)
    or "int4-unpacked" (`quantize_params_int4`, group 128)."""
    import torch

    from teal_tpu_torch.models import llama
    from teal_tpu_torch.ops import quant as q

    params = llama.params_from_numpy(np_params(cfg, seed), device="cpu",
                                     dtype=torch.float32)
    if quant == "int8":
        return q.quantize_params_int8(params)
    if quant == "int8-head":
        head = q.quantize_int8(params["lm_head"])
        return dict(params, lm_head={"q": head.q, "scale": head.scale})
    if quant == "int4":
        packed = q.pack_int4_params(q.quantize_params_int4(params, group=128),
                                    block_size=128)
        return dict(params, layers=packed["layers"])
    if quant == "int4-unpacked":
        return q.quantize_params_int4(params, group=128)
    return params


def port_cache(cfg: dict, batch: int, max_seq: int, seed=None, dtype=None):
    import torch

    from teal_tpu_torch.models.llama import KVCache

    k, v = np_cache(cfg, batch, max_seq, seed)
    return KVCache.from_numpy(k, v, device="cpu",
                              dtype=dtype or torch.float32)


def _np(t) -> np.ndarray:
    return t.detach().cpu().float().numpy()


# --- the rank group ---------------------------------------------------------

def free_port() -> int:
    """A TCP port of 127.0.0.1 that nothing listens on (just now)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun_env(rank: int, world: int, nodes: int, port: int) -> dict:
    """The variables torchrun sets for `rank` of `world` ranks launched
    node by node over `nodes` nodes (`--nnodes nodes --nproc-per-node
    world/nodes`), node 0 the rendezvous host at 127.0.0.1:port."""
    per = world // nodes
    return dict(RANK=str(rank), WORLD_SIZE=str(world),
                LOCAL_RANK=str(rank % per), LOCAL_WORLD_SIZE=str(per),
                GROUP_RANK=str(rank // per), GROUP_WORLD_SIZE=str(nodes),
                ROLE_RANK=str(rank), ROLE_WORLD_SIZE=str(world),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


def _rank_main(rank: int, world: int, init_file: str, spec_path: str,
               out_dir: str, env=None, timeout: float = RANK_TIMEOUT_S
               ) -> None:
    import os

    import torch
    import torch.distributed as dist

    from teal_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    if env is not None:
        # torchrun's variables of a launch over nodes: env://
        os.environ.update(env)
        initialize_distributed(device="cpu", timeout=timeout)
    else:
        # torchrun's variables, read by initialize_distributed
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank))
        initialize_distributed(init_method=f"file://{init_file}",
                               device="cpu")
    spec = json.loads(Path(spec_path).read_text())
    arrays = {}
    for case, (fn, kwargs) in spec.items():
        try:
            out = globals()[fn](**kwargs)
        except Exception as e:   # the case's result; the group goes on
            out = {"error": np.array(f"{type(e).__name__}: {e}")}
        for name, a in out.items():
            arrays[f"{case}::{name}"] = np.asarray(a)
    tmp = Path(out_dir) / f"rank{rank}.tmp.npz"
    np.savez(tmp, **arrays)
    tmp.rename(Path(out_dir) / f"rank{rank}.npz")
    dist.destroy_process_group()


class Ranks:
    """A group of `world` gloo ranks running `cases` ({case: (function
    name in this module, kwargs)}) in order, every case on every rank;
    nodes: start them as torchrun does on that many nodes, through
    `env://` (else through a `file://` rendezvous)."""

    def __init__(self, world: int, cases: Dict[str, tuple], out_dir,
                 timeout: float = RANK_TIMEOUT_S, nodes=None):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.cases = cases
        self.timeout = timeout
        spec = self.out_dir / "cases.json"
        spec.write_text(json.dumps({k: list(v) for k, v in cases.items()}))
        ctx = multiprocessing.get_context("spawn")
        port = free_port() if nodes else None
        self.procs = [ctx.Process(
            target=_rank_main,
            args=(r, world, str(self.out_dir / "init"), str(spec),
                  str(self.out_dir),
                  torchrun_env(r, world, nodes, port) if nodes else None,
                  timeout), daemon=True) for r in range(world)]
        self.t0 = time.monotonic()
        for p in self.procs:
            p.start()

    def join(self) -> Dict[str, List[Dict[str, np.ndarray]]]:
        """{case: [rank 0's results, rank 1's, ...]}; raises when a rank
        failed or the group outlived its timeout (the ranks are killed)."""
        for p in self.procs:
            p.join(max(0.0, self.timeout - (time.monotonic() - self.t0)))
        alive = [p for p in self.procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
        if alive:
            raise RuntimeError(f"{len(alive)} of {len(self.procs)} ranks did "
                               f"not finish in {self.timeout:.0f} s (killed)")
        bad = [p.exitcode for p in self.procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with {bad}")
        res = {c: [] for c in self.cases}
        for r in range(len(self.procs)):
            per = {c: {} for c in self.cases}
            with np.load(self.out_dir / f"rank{r}.npz") as z:
                for key in z.files:
                    case, name = key.split("::", 1)
                    per[case][name] = z[key]
            for c in self.cases:
                res[c].append(per[c])
        return res


def error_of(result: dict) -> str:
    """A case's error ("Type: message"), or "" where it returned."""
    return str(result["error"]) if "error" in result else ""


# --- cases: the sharded forward (parallel/tp.py) ----------------------------

def _sparsity(sp):
    from teal_tpu_torch.config import SparsityConfig

    return SparsityConfig(**(sp or {}))


def _thresholds(cfg: dict, th):
    import torch

    c = model_config(cfg)
    a = np.zeros((c.n_layers, 7), np.float32) if th is None else \
        np.broadcast_to(np.asarray(th, np.float32), (c.n_layers, 7))
    return torch.from_numpy(np.ascontiguousarray(a))


def _gather_cache(cache, mesh, axes=(("tp", 2), ("dp", 1))):
    """The full cache from every rank's block: heads over tp, batch over
    dp (each group's blocks gathered in axis order)."""
    k, v = cache.k, cache.v
    for axis, dim in axes:
        g = mesh.group(axis)
        if g is not None:
            k, v = g.all_gather(k, dim), g.all_gather(v, dim)
    return k, v


def tp_forward(cfg, seed, tp, dp, tokens, max_seq=8, sp=None, th=None,
               quant=None, next_tokens=None):
    """The sharded forward on a dp x tp mesh of ranks 0..dp*tp-1: logits
    of tokens [B, S] at pos 0 (and of next_tokens [B, 1] at pos S after
    it), every rank's copy, and the full cache after the last call."""
    import torch

    from teal_tpu_torch.models import llama
    from teal_tpu_torch.parallel import make_mesh, tp as tpm

    mesh = make_mesh(tp=tp, dp=dp, ranks=range(dp * tp))
    params = port_params(cfg, seed, quant)
    c = model_config(cfg)
    local = tpm.shard_params(params, mesh, c)
    if not mesh.member:
        return {}
    toks = torch.tensor(tokens)
    dtype = torch.bfloat16 if quant else torch.float32
    cache = tpm.shard_cache(port_cache(cfg, toks.shape[0], max_seq,
                                       dtype=dtype), mesh)
    sp, th = _sparsity(sp), _thresholds(cfg, th)
    out = {}
    logits, cache = tpm.sharded_forward(local, toks, cache, 0, th, cfg=c,
                                        sp=sp, mesh=mesh)
    out["logits"] = _np(logits)
    if next_tokens is not None:
        logits, cache = tpm.sharded_forward(
            local, torch.tensor(next_tokens), cache, toks.shape[1], th,
            cfg=c, sp=sp, mesh=mesh)
        out["logits2"] = _np(logits)
    out["k"], out["v"] = (_np(t) for t in _gather_cache(cache, mesh))
    # the port's own single-device forward on the same inputs
    full = port_cache(cfg, toks.shape[0], max_seq, dtype=dtype)
    ref, full = llama.forward(params, toks, full, 0, th, cfg=c, sp=sp)
    out["single_logits"] = _np(ref)
    if next_tokens is not None:
        ref, _ = llama.forward(params, torch.tensor(next_tokens), full,
                               toks.shape[1], th, cfg=c, sp=sp)
        out["single_logits2"] = _np(ref)
    return out


def tp_refuses(cfg, seed, tp, what):
    """A call the sharded path refuses: "indivisible" (shard_params at a
    tp that does not divide), "kernel" (a single-token block-kernel step
    on the sharded forward), "moe-group" (a Mixtral prefill in the group
    rule)."""
    import torch

    from teal_tpu_torch.parallel import make_mesh, tp as tpm

    mesh = make_mesh(tp=tp, ranks=range(tp))
    c = model_config(cfg)
    params = port_params(cfg, seed)
    if what == "indivisible":
        tpm.shard_params(params, mesh, c)
        return {}
    local = tpm.shard_params(params, mesh, c)
    if not mesh.member:
        return {}
    cache = tpm.shard_cache(port_cache(cfg, 1, 8), mesh)
    if what == "kernel":
        sp, toks = dict(enabled=True, kernel="block", block_size=32,
                        block_thresholding=True), [[3]]
    else:
        sp, toks = dict(enabled=True, mode="group", apply_prefill=True), \
            [[3, 5, 7, 1]]
    tpm.sharded_forward(local, torch.tensor(toks), cache, 0,
                        _thresholds(cfg, 0.0), cfg=c, sp=_sparsity(sp),
                        mesh=mesh)
    return {}


# --- cases: decode through the kernels (parallel/tp_kernel.py) --------------

def tpk_run(cfg, seed, tp, dp=1, sp=None, th=0.02, quant=None, batch=1,
            max_seq=16, cache_seed=None, prompt=None, steps=()):
    """`tp_prefill` of `prompt` (if any), then one `tp_kernel_decode` a
    step of `steps` ([tokens [B, 1] or None for the argmax of the last
    logits, pos]) on a dp x tp mesh of ranks 0..dp*tp-1: every step's
    logits and tokens, and the full cache after the last."""
    import torch

    from teal_tpu_torch.parallel import tp_kernel

    mesh = tp_kernel.make_tp_mesh(tp, ranks=range(dp * tp), dp=dp)
    c = model_config(cfg)
    local = tp_kernel.shard_params(port_params(cfg, seed, quant), mesh, c)
    if not mesh.member:
        return {}
    dtype = torch.bfloat16 if quant else torch.float32
    cache = tp_kernel.shard_cache(
        port_cache(cfg, batch, max_seq, cache_seed, dtype), mesh)
    sp, th = _sparsity(sp), _thresholds(cfg, th)
    out, logits = {}, None
    if prompt is not None:
        logits, cache = tp_kernel.tp_prefill(local, torch.tensor(prompt),
                                             cache, th, cfg=c, sp=sp,
                                             mesh=mesh)
        out["prefill"] = _np(logits)
    for j, (tok, pos) in enumerate(steps):
        tok = (torch.argmax(logits[:, -1:], dim=-1) if tok is None
               else torch.tensor(tok))
        logits, cache = tp_kernel.tp_kernel_decode(local, tok, cache, pos, th,
                                                   cfg=c, sp=sp, mesh=mesh)
        out[f"logits{j}"], out[f"tok{j}"] = _np(logits), tok.numpy()
    out["k"], out["v"] = (_np(t) for t in _gather_cache(cache, mesh))
    return out


def tpk_streams(cfg, seed, tp, sp, th, pos, tok):
    """Every layer of one `tp_kernel_decode` step through
    `tp_decode_layer`: this rank's residual stream after the o and the
    down reductions (every rank must hold the same bits)."""
    import torch

    from teal_tpu_torch.models import llama
    from teal_tpu_torch.parallel import tp_kernel

    mesh = tp_kernel.make_tp_mesh(tp, ranks=range(tp))
    c = model_config(cfg)
    local = tp_kernel.shard_params(port_params(cfg, seed), mesh, c)
    if not mesh.member:
        return {}
    cache = tp_kernel.shard_cache(port_cache(cfg, 1, 16, seed=seed), mesh)
    sp, th = _sparsity(sp), _thresholds(cfg, th)
    pos_t = torch.tensor([pos], dtype=torch.int32)
    cos, sin = llama.precompute_rope(c, 16, "cpu")
    rope = llama._rope_rows(cos, sin, pos_t)
    h = local["embed"][torch.tensor([[tok]])]
    out = {}
    for i in range(c.n_layers):
        mid, h = tp_kernel.tp_decode_layer(local, h, cache, i, pos_t, rope, th,
                                           cfg=c, sp=sp, mesh=mesh)
        out[f"o{i}"], out[f"down{i}"] = _np(mid), _np(h)
    return out


# --- cases: sequence- and pipeline-parallel prefill (sp.py, pp.py) ---------

def sp_run(cfg, seed, n_sp, tokens, tp=1, base=0, max_seq=16,
           cache_seed=None, next_tokens=None):
    """`sp_prefill` of tokens [B, S] at `base` on an ("sp",) mesh, or an
    ("sp", "tp") mesh with tp-sharded params (ranks 0..sp*tp-1): logits
    and the full cache (gathered over tp); with next_tokens, one decode
    step after it through the sharded forward on the same mesh."""
    import torch

    from teal_tpu_torch.parallel import sp as spm, tp as tpm

    mesh = spm.make_sp_mesh(n_sp, ranks=range(n_sp * tp), tp=tp)
    c = model_config(cfg)
    params = port_params(cfg, seed)
    if tp > 1:
        params = tpm.shard_params(params, mesh, c)
    if not mesh.member:
        return {}
    toks = torch.tensor(tokens)
    cache = tpm.shard_cache(port_cache(cfg, toks.shape[0], max_seq,
                                       cache_seed), mesh)
    th, sp = _thresholds(cfg, None), _sparsity(None)
    logits, cache = spm.sp_prefill(params, toks, cache, base, th, cfg=c,
                                   sp=sp, mesh=mesh)
    out = {"logits": _np(logits)}
    if next_tokens is not None:
        logits, cache = tpm.sharded_forward(
            params, torch.tensor(next_tokens), cache, base + toks.shape[1],
            th, cfg=c, sp=sp, mesh=mesh)
        out["logits2"] = _np(logits)
    out["k"], out["v"] = (_np(t) for t in _gather_cache(cache, mesh))
    return out


def pp_run(cfg, seed, pp, n_micro, tokens, dp=1, tp=1, pos=0, max_seq=8,
           sp=None, th=None, quant=None, cache_seed=None):
    """`pp_forward` on a ("pp",) or ("dp", "pp", "tp") mesh of ranks
    0..dp*pp*tp-1 (fp32 activations; quant: only "int8-head"): logits and
    the full cache (gathered over tp, dp and pp)."""
    import torch

    from teal_tpu_torch.parallel import pp as ppm

    mesh = ppm.make_pp_mesh(pp, ranks=range(dp * pp * tp), dp=dp, tp=tp)
    c = model_config(cfg)
    local = ppm.pp_shard_params(port_params(cfg, seed, quant), mesh, c)
    if not mesh.member:
        return {}
    toks = torch.tensor(tokens)
    cache = ppm.pp_shard_cache(
        port_cache(cfg, toks.shape[0], max_seq, cache_seed), mesh)
    logits, cache = ppm.pp_forward(local, toks, cache, pos,
                                   _thresholds(cfg, th), cfg=c,
                                   sp=_sparsity(sp), mesh=mesh,
                                   n_micro=n_micro)
    k, v = _gather_cache(cache, mesh, (("tp", 2), ("dp", 1), ("pp", 0)))
    return {"logits": _np(logits), "k": _np(k), "v": _np(v)}


# --- cases: start-up, meshes and collectives (distributed.py, mesh.py) ------

def dist_probe():
    """What `initialize_distributed` started, the meshes' layouts and
    groups, and the collectives of one tp group of four."""
    import os

    import torch
    import torch.distributed as dist

    from teal_tpu_torch.parallel import (distributed, make_mesh, make_pp_mesh,
                                         make_sp_mesh, make_tp_mesh)

    out = {"rank": np.array([dist.get_rank(), int(os.environ["RANK"])]),
           "world": np.array(dist.get_world_size()),
           "backend": np.array(dist.get_backend()),
           "primary": np.array(distributed.is_primary())}
    meshes = {"dp2-tp2": make_mesh(tp=2, dp=2),
              "global": distributed.global_mesh(tp=2, dp=2),
              "tpk-dp2-tp2": make_tp_mesh(2, dp=2),
              "sp2-tp2": make_sp_mesh(2, tp=2),
              "pp2-dp2": make_pp_mesh(2, dp=2),
              "pp4": make_pp_mesh(4),
              "tp2-of-4": make_tp_mesh(2)}
    for name, m in meshes.items():
        out[f"{name}/ranks"] = m.ranks
        out[f"{name}/names"] = np.array(",".join(m.axis_names))
        for axis in m.axis_names:
            g = m.group(axis)
            out[f"{name}/{axis}"] = (np.array(g.ranks + (g.index,))
                                     if g is not None else np.array([-1]))
    m = make_tp_mesh(4)
    g = m.group("tp")
    r = dist.get_rank()
    out["gather"] = g.all_gather(torch.tensor([[float(r)]]), 1).numpy()
    # a sum whose value depends on the order: rank order gives 1
    vals = torch.tensor([1e8, 1.0, -1e8, 1.0], dtype=torch.float32)
    out["sum"] = g.reduce_sum(vals[r:r + 1]).numpy()
    out["sum_bf16"] = g.reduce_sum(
        torch.tensor([256.0, 1.0, -256.0, 1.0],
                     dtype=torch.bfloat16)[r:r + 1]).float().numpy()
    out["bcast"] = g.broadcast(torch.full((2,), float(r)), 2).numpy()
    # a chain 0 -> 1 -> 2 -> 3 of point-to-point sends
    x = torch.zeros(3) if r == 0 else g.recv(torch.empty(3), r - 1)
    x = x + r
    if r < 3:
        g.send(x, r + 1)
    out["chain"] = x.numpy()
    for what, fn in (("mesh-3x1", lambda: make_mesh(tp=3, dp=1)),
                     ("tp8", lambda: make_tp_mesh(8))):
        try:
            fn()
            out[f"err/{what}"] = np.array("")
        except ValueError as e:
            out[f"err/{what}"] = np.array(f"ValueError: {e}")
    return out


# --- cases: the server on a tp group (engine/serving.py) -------------------

def _serve(cfg, params, submissions, mesh=None, **kw):
    """A port server (fp32, CPU) on `params` (this rank's shards where a
    mesh is given), every submission [prompt, new tokens] run to its end:
    {out<id>: tokens} and the shapes of the caches it allocated."""
    import torch

    from teal_tpu_torch.engine import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(model_config(cfg), params, mesh=mesh,
                                   cache_dtype=torch.float32, device="cpu",
                                   **kw)
    subs, make_sub = [], eng._sub_cache

    def sub_cache(n):
        sub = make_sub(n)
        subs.append(tuple(sub.k.shape))
        return sub

    eng._sub_cache = sub_cache
    for prompt, n in submissions:
        eng.submit(prompt, n)
    out = {f"out{r.id}": np.array(r.out) for r in eng.run()}
    out["cache_shape"] = np.array(eng.cache.k.shape)
    out["sub_shapes"] = np.array(subs)
    return out


def serve_tp(cfg, seed, tp, submissions, slots=2, max_seq=32,
             prefill_chunk=None, temperature=0.0, sp=None, th=None,
             single=False):
    """The server on a ("dp", "tp") mesh of ranks 0..tp-1 (dp 1): every
    request's tokens on every rank, the shapes of the rank's cache and
    admission sub-caches, and the q shapes of every K6 call (plain on
    the CPU); with `single`, rank 0 also runs the single-process server
    on the full params ("single_" keys). A decode step the sharded
    forward refuses is the case's result: "raised", with the steps done
    and the tokens out before it."""
    from teal_tpu_torch.models import llama
    from teal_tpu_torch.parallel import make_mesh, tp as tpm

    mesh = make_mesh(tp=tp, ranks=range(tp))
    c = model_config(cfg)
    params = port_params(cfg, seed)
    local = tpm.shard_params(params, mesh, c)
    if not mesh.member:
        return {}
    kw = dict(slots=slots, max_seq=max_seq, prefill_chunk=prefill_chunk,
              temperature=temperature, sp=_sparsity(sp),
              thresholds=_thresholds(cfg, th))
    k6, real = [], llama.flash_prefill_attention

    def counting(q, k, v, *a, **k2):
        k6.append(tuple(q.shape))
        return real(q, k, v, *a, **k2)

    llama.flash_prefill_attention = counting
    try:
        if sp is not None and sp.get("kernel") == "block":
            return _serve_refused(c, local, submissions, mesh, kw)
        out = _serve(cfg, local, submissions, mesh, **kw)
        out["k6_q"] = np.array(k6)
        if single and mesh.coord("tp") == 0:
            k6.clear()
            ref = _serve(cfg, params, submissions, **kw)
            out.update({f"single_{k}": v for k, v in ref.items()})
            out["single_k6_q"] = np.array(k6)
    finally:
        llama.flash_prefill_attention = real
    return out


def _serve_refused(c, local, submissions, mesh, kw):
    import torch

    from teal_tpu_torch.engine import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(c, local, mesh=mesh, device="cpu",
                                   cache_dtype=torch.float32, **kw)
    for prompt, n in submissions:
        eng.submit(prompt, n)
    steps = 0
    try:
        while eng.has_work():
            eng.step()
            steps += 1
    except ValueError as e:
        n_out = sum(len(r.out) for r in eng.active if r is not None)
        return {"raised": np.array(f"ValueError: {e}"),
                "steps": np.array(steps),
                "tokens_out": np.array(n_out + len(eng.finished))}
    return {}


# --- cases: forward(return_hidden=True) on a tp group ----------------------

def hidden_tp(cfg, seed, tp, tokens, next_tokens, max_seq=16):
    """The sharded forward with `return_hidden` on a tp mesh of ranks
    0..tp-1: the hidden states of a prefill and a decode step, every
    rank's copy, and the single-process forward's."""
    import torch

    from teal_tpu_torch.models import llama
    from teal_tpu_torch.parallel import make_mesh, tp as tpm

    mesh = make_mesh(tp=tp, ranks=range(tp))
    c = model_config(cfg)
    params = port_params(cfg, seed)
    local = tpm.shard_params(params, mesh, c)
    if not mesh.member:
        return {}
    toks, nxt = torch.tensor(tokens), torch.tensor(next_tokens)
    th, sp = _thresholds(cfg, None), _sparsity(None)
    out = {}
    for name, p, m in (("", local, mesh), ("single_", params, None)):
        cache = port_cache(cfg, toks.shape[0], max_seq)
        if m is not None:
            cache = tpm.shard_cache(cache, m)
        g = None if m is None else m.group("tp")
        h, cache = llama.forward(p, toks, cache, 0, th, cfg=c, sp=sp,
                                 tp_group=g, return_hidden=True)
        h2, _ = llama.forward(p, nxt, cache, toks.shape[1], th, cfg=c, sp=sp,
                              tp_group=g, return_hidden=True)
        out[name + "hidden"], out[name + "hidden2"] = _np(h), _np(h2)
    return out


# --- cases: a launch over two nodes (torchrun's env://) ---------------------

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "GROUP_RANK", "MASTER_ADDR", "MASTER_PORT")


def mh_env(tp, dp):
    """How this rank was started: torchrun's variables, the rendezvous
    `init_process_group` was given, the card `local_card` names (read
    from the environment; no card is touched), the group's rank, world
    and backend, and `global_mesh(tp, dp)`'s layout and groups with a
    sum over each."""
    import os

    import torch
    import torch.distributed as dist
    import torch.distributed.distributed_c10d as c10d

    from teal_tpu_torch.parallel import distributed

    out = {f"env/{v}": np.array(os.environ.get(v, "")) for v in
           TORCHRUN_VARS}
    out["init_method"] = np.array(str(c10d._default_pg_init_method))
    out["card"] = np.array(distributed.local_card().index)
    out["rank"] = np.array([dist.get_rank(), dist.get_world_size()])
    out["backend"] = np.array(dist.get_backend())
    mesh = distributed.global_mesh(tp=tp, dp=dp)
    out["mesh"] = mesh.ranks
    for axis in ("dp", "tp"):
        g = mesh.group(axis)
        out[f"{axis}/ranks"] = np.array(g.ranks + (g.index,))
        out[f"{axis}/sum"] = g.reduce_sum(
            torch.tensor([float(dist.get_rank())])).numpy()
    return out


def mh_gspmd(cfg, seed, tp, dp, tokens, next_tokens, sp=None, th=None,
             max_seq=16):
    """The sharded forward on `global_mesh(tp, dp)` (dp over the nodes):
    `tp_forward`'s results on the same layout."""
    from teal_tpu_torch.parallel import distributed, make_mesh

    want = make_mesh(tp=tp, dp=dp, ranks=range(dp * tp)).ranks
    got = distributed.global_mesh(tp=tp, dp=dp).ranks
    if not np.array_equal(got, want):
        raise AssertionError(f"global_mesh {got.tolist()} != {want.tolist()}")
    return tp_forward(cfg, seed, tp, dp, tokens, max_seq=max_seq, sp=sp,
                      th=th, next_tokens=next_tokens)


def mh_kernel_tp(cfg, seed, tp, sp, th, prompt, steps, max_seq=16):
    """`tpk_run` over the whole world (tp across the nodes), then on every
    rank the single-process path on the full params: a dense prefill and
    `forward` at each step's token (the token path where
    `can_token_decode` holds; the kernels' plain versions on the CPU)."""
    import torch

    from teal_tpu_torch.models import llama

    out = tpk_run(cfg, seed, tp, sp=sp, th=th, max_seq=max_seq,
                  prompt=prompt, steps=steps)
    if not out:
        return out
    c = model_config(cfg)
    params = port_params(cfg, seed)
    spc, thr = _sparsity(sp), _thresholds(cfg, th)
    cache = port_cache(cfg, 1, max_seq)
    dense = spc.replace(enabled=False)
    logits, cache = llama.forward(params, torch.tensor(prompt), cache, 0, thr,
                                  cfg=c, sp=dense, causal_prefill=True)
    out["single_prefill"] = _np(logits)
    token_path = []
    for j, (_, pos) in enumerate(steps):
        tok = torch.from_numpy(out[f"tok{j}"])
        token_path.append(llama.can_token_decode(params, c, spc, 1, 1,
                                                 cache.k.dtype))
        logits, cache = llama.forward(params, tok, cache, pos, thr, cfg=c,
                                      sp=spc)
        out[f"single_logits{j}"] = _np(logits)
    out["single_k"], out["single_v"] = _np(cache.k), _np(cache.v)
    out["single_token_path"] = np.array(token_path)
    return out


def mh_serving(cfg, seed, tp, submissions, slots, max_seq, prefill_chunk):
    """The server on `global_mesh(tp)` over the whole world (tp across the
    nodes, chunked admission), and the single-process server on rank 0."""
    from teal_tpu_torch.parallel import distributed, tp as tpm

    mesh = distributed.global_mesh(tp=tp, dp=1)
    c = model_config(cfg)
    params = port_params(cfg, seed)
    kw = dict(slots=slots, max_seq=max_seq, prefill_chunk=prefill_chunk,
              temperature=0.0)
    out = _serve(cfg, tpm.shard_params(params, mesh, c), submissions, mesh,
                 **kw)
    if mesh.coord("tp") == 0:
        ref = _serve(cfg, params, submissions, **kw)
        out.update({f"single_{k}": v for k, v in ref.items()})
    return out


def mh_pp(cfg, seed, pp, tp, n_micro, tokens, max_seq=16):
    """`pp_run` on a (1, pp, tp) mesh of the whole world (the stages over
    the nodes), and the single-process forward on the full params."""
    import torch

    from teal_tpu_torch.models import llama

    out = pp_run(cfg, seed, pp, n_micro, tokens, tp=tp, max_seq=max_seq)
    toks = torch.tensor(tokens)
    cache = port_cache(cfg, toks.shape[0], max_seq)
    logits, cache = llama.forward(port_params(cfg, seed), toks, cache, 0,
                                  _thresholds(cfg, None), cfg=model_config(cfg),
                                  sp=_sparsity(None))
    out["single_logits"] = _np(logits)
    out["single_k"], out["single_v"] = _np(cache.k), _np(cache.v)
    return out
