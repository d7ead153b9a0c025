"""Per-step timing by the slope of two chained runs.

Port of `teal_tpu/utils/bench_utils.py`. `bench_chained` times a step
whose input is the previous step's output, so that no step can be
skipped, cached or hoisted:

  - each timed call starts from a fresh carry (`carry0` with a different
    small offset on its floating tensors), so no two calls see the same
    input values;
  - every timed call ends in `sync`, which waits for the card;
  - two calls of different lengths are timed, and the step time is the
    slope (t_long - t_short) / (n_long - n_short), which cancels the
    fixed cost of a call; the median of `reps` such pairs is returned;
  - a non-positive slope raises (a step whose work was cached or
    skipped).

The reference runs the n steps inside one `lax.scan`, a single device
program; the port runs them as a host loop of `step_fn` calls, so the
slope here includes the host's cost of launching one step's kernels,
which is what a decode loop on the host pays too.

The reference also re-exports `decode_compiler_options` from its
`compile_opts.py`, an XLA compiler flag; PyTorch has no counterpart, so
that module is not ported and nothing is re-exported here.
"""

from __future__ import annotations

import time
from typing import Callable

import torch
from torch.utils._pytree import tree_leaves, tree_map


def sync(tree):
    """Wait for the work that produces the tensors of `tree` (a tensor, or
    dicts, lists and tuples of them): `torch.cuda.synchronize` on each
    card they lie on; nothing for tensors on the CPU, which are ready
    when returned. Returns tree."""
    for dev in {t.device for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


def bench_chained(step_fn: Callable, carry0, *, n_short: int = 128,
                  n_long: int = 1024, reps: int = 5) -> float:
    """Median per-step seconds of `step_fn(carry) -> carry`.

    `step_fn` must return a carry of the same structure such that every
    value the step consumes depends on the previous step's output."""

    def run(n, c):
        for _ in range(n):
            c = step_fn(c)
        return sync(c)

    def fresh(i):
        # perturb the carry so no two timed calls share input values
        return tree_map(lambda a: a + torch.tensor(1e-6 * (i + 1),
                                                   dtype=a.dtype,
                                                   device=a.device)
                        if isinstance(a, torch.Tensor)
                        and a.is_floating_point() else a, carry0)

    # warm up both lengths
    run(n_short, fresh(0))
    run(n_long, fresh(1))

    slopes = []
    for r in range(reps):
        cs, cl = fresh(2 + 2 * r), fresh(3 + 2 * r)
        sync((cs, cl))
        t0 = time.perf_counter()
        run(n_short, cs)
        t1 = time.perf_counter()
        run(n_long, cl)
        t2 = time.perf_counter()
        slopes.append(((t2 - t1) - (t1 - t0)) / (n_long - n_short))
    slopes.sort()
    slope = slopes[len(slopes) // 2]
    if slope <= 0:
        raise RuntimeError(
            f"non-positive per-step slope {slope:.3e}s — caching suspected; "
            "make step_fn's input depend on its previous output")
    return slope
