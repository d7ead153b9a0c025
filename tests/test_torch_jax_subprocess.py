"""The harness that runs the port tests' JAX references in a child process
(`tests/jax_subprocess.py`): a child is judged hung by its CPU time, not
by the machine's speed."""

import subprocess
import sys
import time

import numpy as np
import pytest
from jax_subprocess import Watch, cpu_seconds, jax_results


def twice(x):
    """A case's result, computed in the child (run by `jax_results`)."""
    return {"y": np.asarray(x, np.float32) * 2}


def test_cpu_seconds_of_a_busy_process_grow():
    proc = subprocess.Popen([sys.executable, "-c",
                             "import time\nt = time.time()\n"
                             "while time.time() - t < 5: pass"])
    try:
        time.sleep(1.0)
        first = cpu_seconds(proc.pid)
        time.sleep(1.5)
        assert first >= 0 and cpu_seconds(proc.pid) > first + 0.5
    finally:
        proc.kill()
        proc.wait()
    assert cpu_seconds(proc.pid) == -1.0


@pytest.mark.parametrize("busy", [False, True], ids=["blocked", "busy"])
def test_watch_calls_a_blocked_process_hung(busy):
    """A process whose CPU time stands still (the interpreter's deadlock
    blocks it) is hung after `stall` seconds; a busy one is not, however
    long it runs under the cap."""
    code = ("import time\nt = time.time()\nwhile time.time() - t < 30: pass"
            if busy else "import time\ntime.sleep(30)")
    proc = subprocess.Popen([sys.executable, "-c", code])
    try:
        watch = Watch([proc.pid], cap=60.0, stall=1.5)
        t0 = time.perf_counter()
        while not watch.hung() and time.perf_counter() - t0 < 4.0:
            time.sleep(0.25)
        assert watch.hung() == (not busy)
    finally:
        proc.kill()
        proc.wait()


def test_child_results_come_back(tmp_path):
    """`jax_results` returns each case's arrays from the child, and a case
    that raises in the child fails the call with its error."""
    cases = {f"c{i}": dict(x=[i, i + 1]) for i in range(3)}
    got = jax_results(__file__, "twice", cases, tmp_path)
    for c, kw in cases.items():
        np.testing.assert_array_equal(
            got[c]["y"], np.asarray(kw["x"], np.float32) * 2)
    with pytest.raises(RuntimeError, match="failed"):
        jax_results(__file__, "twice", {"bad": dict(x="not a number")},
                    tmp_path)
