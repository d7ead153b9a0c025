"""Sparsity ops, weight-only quantization (quant) and the port's kernels
(K1 and K3 in block_gemv, K2 in decode_attention, K4 in gather_gemv, K5
in token_block, K6 in flash_prefill)."""
