"""Model and sparsity configuration for the PyTorch port.

A copy of `teal_tpu/config.py`, kept in this package so that the port
imports nothing of the JAX package. `tests/test_torch_config.py` holds
the two copies equal field for field; change both together.

Some `SparsityConfig` fields steer JAX-only dispatch (fused attention
block, packed pipeline, whole-token kernel); the port keeps them so that
one config means the same thing to both packages, and its own dispatch
reads only the fields `models/llama.py` names.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# The seven sparsifiable projections, in canonical order. This order is used
# everywhere a per-projection array is indexed (thresholds, sparsities,
# greedy schedules). Mirrors the reference's projection set
# (`teal/mlp.py:50-56`, `teal/self_attn.py:70-84`, `teal/greedyopt.py:26-52`).
PROJS: Tuple[str, ...] = ("q", "k", "v", "o", "gate", "up", "down")
PROJ_IDX = {p: i for i, p in enumerate(PROJS)}

# Distribution group feeding each projection: (module, hidden-type).
# q,k,v sparsify the post-LN hidden state (attn h1); o sparsifies the
# attention output (attn h2); gate,up sparsify the post-LN hidden state
# (mlp h1); down sparsifies act_fn(gate)*up (mlp h2).
# Reference: `teal/self_attn.py:70-84,146-151`, `teal/mlp.py:43-56`.
PROJ_GROUP = {
    "q": ("self_attn", "h1"),
    "k": ("self_attn", "h1"),
    "v": ("self_attn", "h1"),
    "o": ("self_attn", "h2"),
    "gate": ("mlp", "h1"),
    "up": ("mlp", "h1"),
    "down": ("mlp", "h2"),
}


def find_multiple(n: int, k: int) -> int:
    return n if n % k == 0 else n + k - (n % k)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for a Llama/Mistral-family transformer."""

    name: str = "unnamed"
    vocab_size: int = 32000
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = -1          # -1 => MHA (== n_heads)
    dim: int = 4096
    intermediate_size: int = -1   # -1 => Llama-2 style 8/3 * dim rounded
    max_seq_len: int = 2048       # reference "block_size"
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    sliding_window: Optional[int] = None  # Mistral
    # MoE (Mixtral) — 0 experts means dense FFN.
    n_experts: int = 0
    n_experts_per_tok: int = 0

    def __post_init__(self):
        if self.n_kv_heads == -1:
            object.__setattr__(self, "n_kv_heads", self.n_heads)
        if self.intermediate_size == -1:
            hidden = int(2 * (4 * self.dim) / 3)
            object.__setattr__(
                self, "intermediate_size", find_multiple(hidden, 256)
            )

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def proj_shape(self, proj: str) -> Tuple[int, int]:
        """(in_features, out_features) of one of the seven projections."""
        d, hk, it = self.dim, self.kv_dim, self.intermediate_size
        return {
            "q": (d, d),
            "k": (d, hk),
            "v": (d, hk),
            "o": (d, d),
            "gate": (d, it),
            "up": (d, it),
            "down": (it, d),
        }[proj]

    def proj_params(self, proj: str) -> int:
        i, o = self.proj_shape(proj)
        return i * o

    def non_embedding_params(self) -> int:
        """Parameter count excluding embeddings/lm_head, for bandwidth math.

        Mirrors the reference's `_get_model_size`
        (`gpt-fast/generate.py:336-346`), which excludes embedding modules
        when computing achieved GB/s.
        """
        per_layer = sum(self.proj_params(p) for p in PROJS)
        if self.n_experts > 0:
            moe = self.n_experts * (
                self.proj_params("gate") + self.proj_params("up") + self.proj_params("down")
            ) + self.dim * self.n_experts
            per_layer = sum(self.proj_params(p) for p in ("q", "k", "v", "o")) + moe
        norms = self.dim * (2 * self.n_layers + 1)
        return self.n_layers * per_layer + norms


# Name-keyed registry. Keys substring-match against checkpoint/model names
# (longest match wins), giving the same UX as the reference's fuzzy
# `from_name` (`gpt-fast/model.py:50-63`).
MODEL_REGISTRY = {
    "CodeLlama-7b-Python-hf": dict(
        max_seq_len=16384, vocab_size=32000, n_layers=32, dim=4096,
        rope_base=1e6),
    "7B": dict(n_layers=32, n_heads=32, dim=4096),
    "13B": dict(n_layers=40, n_heads=40, dim=5120),
    "30B": dict(n_layers=60, n_heads=52, dim=6656),
    "34B": dict(n_layers=48, n_heads=64, dim=8192, vocab_size=32000,
                n_kv_heads=8, intermediate_size=22016, rope_base=1e6),
    "70B": dict(n_layers=80, n_heads=64, dim=8192, n_kv_heads=8,
                intermediate_size=28672),
    "Mistral-7B": dict(n_layers=32, n_heads=32, n_kv_heads=8, dim=4096,
                       intermediate_size=14336, vocab_size=32000,
                       sliding_window=4096),
    "stories15M": dict(n_layers=6, n_heads=6, dim=288),
    "stories110M": dict(n_layers=12, n_heads=12, dim=768),
    "llama-3-8b": dict(max_seq_len=8192, n_layers=32, n_heads=32,
                       n_kv_heads=8, dim=4096, intermediate_size=14336,
                       vocab_size=128256, rope_base=500000.0),
    "llama-3-70b": dict(max_seq_len=8192, n_layers=80, n_heads=64,
                        n_kv_heads=8, dim=8192, intermediate_size=28672,
                        vocab_size=128256, rope_base=500000.0),
    "Mixtral-8x7B": dict(max_seq_len=32768, n_layers=32, n_heads=32,
                         n_kv_heads=8, dim=4096, intermediate_size=14336,
                         vocab_size=32000, rope_base=1e6,
                         n_experts=8, n_experts_per_tok=2),
    # Tiny config for tests/CI (not in the reference).
    "tiny": dict(n_layers=2, n_heads=4, n_kv_heads=2, dim=64,
                 intermediate_size=176, vocab_size=512, max_seq_len=256),
}


def get_model_config(name: str, **overrides) -> ModelConfig:
    """Resolve a model name to a ModelConfig via longest-substring match."""
    if name in MODEL_REGISTRY:
        cfg = dict(MODEL_REGISTRY[name])
        cfg["name"] = name
    else:
        matches = [k for k in MODEL_REGISTRY if k.lower() in name.lower()]
        if not matches:
            raise KeyError(
                f"no registry entry matches {name!r}; known: {sorted(MODEL_REGISTRY)}"
            )
        matches.sort(key=len, reverse=True)
        if len(matches) > 1 and len(matches[0]) == len(matches[1]):
            raise KeyError(f"ambiguous model name {name!r}: {matches[:2]}")
        cfg = dict(MODEL_REGISTRY[matches[0]])
        cfg["name"] = matches[0]
    cfg.update(overrides)
    return ModelConfig(**cfg)


@dataclass(frozen=True)
class SparsityConfig:
    """How activation sparsity is applied during a forward pass.

    This replaces the reference's mutable per-module state
    (`SparsifyFn.set_threshold`, `set_uniform_sparsity` etc.,
    `teal/model.py:131-155`, `utils/utils.py:28-30`) with an immutable spec;
    the actual per-(layer, projection) thresholds travel separately as a
    `[n_layers, 7]` array (a jit-friendly pytree leaf).

    kernel modes:
      - "masked_dense": sparsify as `x * (|x| > t)` then dense matmul — the
        accuracy path (identical to reference `utils/utils.py:51-52`).
      - "gather": Pallas unstructured row-gather sparse GEMV (decode only).
      - "block":  Pallas block-sparse GEMV; sparsity decided per channel
        group (TPU-structured mode; needs group-calibrated thresholds).
    """

    enabled: bool = False
    kernel: str = "masked_dense"
    # sparsity rule: "teal" = elementwise |x| > t (reference semantics);
    # "group" = per-position top-k channel-group selection (the block
    # kernel's semantics — use with the masked-dense path to measure its
    # accuracy cost)
    mode: str = "teal"
    # Prefill policy (reference `utils/utils.py:32-49`): the fast engine runs
    # prefill fully dense; the accuracy path optionally sparsifies only the
    # trailing `prefill_fraction` of prefill positions.
    apply_prefill: bool = False
    prefill_fraction: float = 0.5
    # Block ("group") mode: group size along the input dim (must be a
    # multiple of the bf16 sublane tile, 16) and the fraction of groups
    # kept per projection (top-k by group max-|x| score; static so the
    # gather capacity is compile-time fixed, the analog of the reference's
    # SPARSITY_BIN autotune key, kernels/sparse_gemv.py:47).
    block_size: int = 32
    block_keep_frac: float = 0.5
    # Optional per-projection keep fractions (PROJS order). Lets a greedy
    # per-projection sparsity profile drive the fast engine (the reference
    # never wired its greedy schedules into gpt-fast, README.md:109).
    # Static tuple: capacities stay compile-time constants. Uniform across
    # layers (scan-over-layers requires uniform gather capacities).
    block_keep_fracs: Optional[Tuple[float, ...]] = None
    # When True, the block kernel applies calibrated GROUP-SCORE thresholds
    # (the thresholds array holds group thresholds built by
    # `group_thresholds_for_uniform`); groups below threshold contribute
    # zero, and keep_frac becomes the static gather capacity (use a margin
    # over 1 - sparsity). When False: pure top-k selection.
    block_thresholding: bool = False
    # Unstructured "gather" mode capacity fraction (exact-semantics kernel).
    gather_cap_frac: float = 0.625
    # Fused decode attention (ops/decode_attention.py): single-token
    # attention reads the layer-stacked KV cache in-kernel instead of
    # slicing the 2 MB layer slab out of the scan carry and writing it
    # back every layer. None = auto (on for single-device TPU decode with
    # head_dim 128); True forces it (tests under interpret mode); False
    # disables. Orthogonal to `enabled` — it also speeds dense decode.
    fused_decode_attention: Optional[bool] = None
    # Fused attention block (ops/attn_block.py): norm + selection + QKV
    # gather + RoPE + cache write + attention in ONE kernel launch for
    # batch-1 threshold-mode decode. None = auto (on whenever the fused
    # decode attention path and the norm fold are both active and the
    # q/k/v weights are bf16/int4 with equal capacities); False disables
    # (falls back to the two-kernel path).
    fused_attn_block: Optional[bool] = None
    # Packed-pipeline decode (G=128): every kernel writes its output in
    # the packed-row layout the next kernel reads, with residual adds and
    # the MLP activation folded in — a whole layer is 4 Pallas launches
    # with zero XLA ops between them. None = auto (on when the fused
    # attention block is active and every projection's effective group
    # size is 128); False disables.
    packed_pipeline: Optional[bool] = None
    # Whole-token kernel: run the ENTIRE layer stack as one Pallas
    # launch (grid over layers, residual stream in persistent VMEM;
    # ops/token_block.py). None = auto (on whenever the packed pipeline
    # is eligible); False = fall back to 4 launches/layer.
    token_fused: Optional[bool] = None
    # Diagnostic (bench --fixed-selection): replace in-kernel threshold
    # selection with a static identity kept-set (groups 0..cap-1). Same
    # DMA/MXU work, no scores->SMEM->scalar-scan head — isolates the
    # selection latency at each launch. NOT a production mode.
    debug_fixed_selection: bool = False

    def replace(self, **kw) -> "SparsityConfig":
        return dataclasses.replace(self, **kw)
