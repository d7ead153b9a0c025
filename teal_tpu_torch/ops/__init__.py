"""Sparsity ops and the port's kernels (K1 in block_gemv, K2 in
decode_attention)."""
