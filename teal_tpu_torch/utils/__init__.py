"""Checkpoints, tokenizers, text sources and profiling (port of
`teal_tpu/utils`). `download.py` (it needs the network) and
`compile_opts.py` (an XLA flag) have no counterpart here."""
