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
`ops/gather_gemv.row_gather_gemv` (K4); the dense and masked-dense layer
loop, prefill and the generation engine. ROADMAP.md lists what is still
to port.
"""

__version__ = "0.1.0"

from teal_tpu_torch.config import ModelConfig, SparsityConfig, get_model_config

__all__ = ["ModelConfig", "SparsityConfig", "get_model_config", "__version__"]
