"""teal_tpu_torch — the PyTorch + CUDA port of teal_tpu, for one NVIDIA H100.

`teal_tpu/` (JAX on a TPU) stays the reference; this package mirrors its
module layout and is held to it by `tests/test_torch_*.py`. It imports
neither JAX nor `teal_tpu`. Entry points run on the CUDA device unless
the caller passes `device="cpu"`, where every kernel wrapper runs its
plain PyTorch version instead.

Ported so far: the main decode path — batch-1 single-token group-sparse
decode (threshold mode, G = 128) through two hand-written CUDA kernels,
`ops/block_gemv.select_gather_gemv` (K1) and
`ops/decode_attention.decode_attention` (K2); the layer loop's sparse
decode (block mode in top-k or at G = 32/64, batches up to 8, and gather
mode) through K1, K2, `ops/block_gemv.block_gather_gemv_multi` (K3) and
`ops/gather_gemv.row_gather_gemv` (K4); weight-only int8 and packed int4
(`ops/quant.py`) on K1 and K3's weight plans; batched decode of up to
16 sequences on the token path (K1's rows form, K2 with B rows), which
the continuous-batching server (`engine/serving.py`) and
`Generator(batch=B)` run, and `models/llama.block_verify` (K1's fixed
selection, K2's seq_block form); the dense and masked-dense layer loop,
prefill and the generation engine; Mixtral's MoE decode (K5
`ops/token_block.moe_route`); the causal prefill of prompts of 256 or
more tokens through `ops/flash_prefill.flash_prefill_attention` (K6),
which `Generator`, the server's one-shot admission and the perplexity
harness `eval/ppl.py` take; calibration (`calibration/`: activation
histograms through the native library `native/histogram.cpp`, TEAL
thresholds, the greedy allocation, channel permutations) and GPTQ
(`ops/gptq.py`, `calibration/gptq_runner.py`), whose captures take K6;
speculative decoding (`engine/speculative.py`: self-speculation drafts on
the main path and verifies through `block_verify`); and the user's entry
points: checkpoints (`utils/checkpoint.py`: HF safetensors through the
port's own reader, and the JAX package's native store), tokenizers, text
sources and profiling (`utils/`), the lm-eval harness and its shim
(`eval/harness.py`, `eval/lm_eval_shim.py`) and the CLI, `python -m
teal_tpu_torch.cli` (`--device cpu` for the CPU). ROADMAP.md lists what
is still to port.
"""

__version__ = "0.1.0"

from teal_tpu_torch.config import ModelConfig, SparsityConfig, get_model_config

__all__ = ["ModelConfig", "SparsityConfig", "get_model_config", "__version__"]
