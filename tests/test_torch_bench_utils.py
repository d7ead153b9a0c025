"""`teal_tpu_torch/utils/bench_utils.py`: the port of the JAX package's
`bench_chained` protocol (`teal_tpu/utils/bench_utils.py`), on the CPU.
As `tests/test_bench_protocol.py` holds bench.py's slope to a planted
round time and never lets a garbage slope through, these hold the port's
slope to a planted step time: a step that sleeps, a fake clock that
plants each timed call's length (the median of the pairs, a
non-positive slope), and the fresh carry of every call."""

import time

import pytest
import torch

from teal_tpu_torch.utils import bench_utils


def test_slope_recovers_a_sleeping_step(monkeypatch):
    """A step that sleeps 2 ms: the slope over 4 and 24 steps is the step
    time (the fixed 30 ms that `sync` adds to every call cancels), within
    the host's sleep jitter."""
    def step(c):
        time.sleep(0.002)
        return c + 1

    real = bench_utils.sync

    def sync(tree):
        time.sleep(0.03)
        return real(tree)

    monkeypatch.setattr(bench_utils, "sync", sync)
    slope = bench_utils.bench_chained(step, torch.zeros(3), n_short=4,
                                      n_long=24, reps=3)
    assert 0.002 <= slope < 0.0035, slope


class FakeClock:
    """perf_counter that a step advances by the planted step time of its
    call (`per_call[i]`, seconds a step of the i-th timed run)."""

    def __init__(self, per_call):
        self.t = 0.0
        self.per_call = list(per_call)
        self.call = -1

    def __call__(self):
        return self.t


def _bench(monkeypatch, per_call, n_short=2, n_long=6, reps=5):
    clock = FakeClock(per_call)
    monkeypatch.setattr(bench_utils.time, "perf_counter", clock)
    starts = []

    def step(c):
        if c["x"].item() < 0.5:          # a fresh carry: a call starts
            starts.append(c["x"].item())
            clock.call += 1
        if clock.call >= 2:              # the warm-up calls take no time
            clock.t += clock.per_call[clock.call - 2]
        return {"x": c["x"] + 1.0, "n": c["n"]}

    carry0 = {"x": torch.zeros((), dtype=torch.float64),
              "n": torch.tensor(7)}
    slope = bench_utils.bench_chained(step, carry0, n_short=n_short,
                                      n_long=n_long, reps=reps)
    return slope, starts


def test_median_of_the_pairwise_slopes(monkeypatch):
    """Five pairs whose planted slopes are 1, 9, 3, 100, 5 ms: the median,
    5 ms, whatever the outliers."""
    slopes = [1e-3, 9e-3, 3e-3, 100e-3, 5e-3]
    per_call = []
    for s in slopes:
        # short run of 2 steps at 10 ms a step, long run of 6 steps whose
        # total is 2 * 10 ms + 4 * s
        per_call += [0.010, (0.020 + 4 * s) / 6]
    slope, _ = _bench(monkeypatch, per_call)
    assert slope == pytest.approx(5e-3, rel=1e-9)


def test_every_timed_call_gets_a_fresh_carry(monkeypatch):
    """Each of the 2 warm-up and 2 * reps timed calls starts from its own
    carry: carry0's floating tensors offset by 1e-6 * (i + 1), the
    integer ones as they are; the carry never leaks from one call into
    the next."""
    seen, clock = [], FakeClock([])

    def step(c):
        seen.append((c["x"].item(), int(c["n"])))
        clock.t += 1e-3
        return {"x": c["x"] + 1.0, "n": c["n"]}

    monkeypatch.setattr(bench_utils.time, "perf_counter", clock)
    bench_utils.bench_chained(step, {"x": torch.zeros((), dtype=torch.float64),
                                     "n": torch.tensor(7)},
                              n_short=2, n_long=3, reps=3)
    starts = [x for x, _ in seen if x < 0.5]
    assert starts == pytest.approx([1e-6 * (i + 1) for i in range(8)],
                                   rel=1e-9)
    assert len(seen) == 4 * (2 + 3)
    assert all(n == 7 for _, n in seen)


@pytest.mark.parametrize("long_step", [0.010, 0.008], ids=["zero",
                                                           "negative"])
def test_non_positive_slope_raises(monkeypatch, long_step):
    """A long run no slower a step than the short one's fixed cost allows
    (a zero or negative slope) raises instead of returning a time."""
    per_call = [0.010, 0.020 / 6 * (long_step / 0.010)] * 5
    with pytest.raises(RuntimeError, match="non-positive per-step slope"):
        _bench(monkeypatch, per_call)


def test_sync_waits_only_on_cards():
    """`sync` returns its argument and touches no card for CPU tensors
    (nested dicts, lists and tuples, other leaves left alone)."""
    tree = {"a": torch.ones(2), "b": [torch.zeros(1), (3, "x")]}
    assert bench_utils.sync(tree) is tree
    t = torch.ones(1)
    assert bench_utils.sync(t) is t
