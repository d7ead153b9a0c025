"""Checkpoints, tokenizers, text sources, profiling and step timing
(`bench_utils`) (port of `teal_tpu/utils`). `download.py` (it needs the
network) and `compile_opts.py` (an XLA flag) have no counterpart here."""
