"""Reference results from the JAX package, computed in a subprocess with
its own timeout.

The JAX Pallas kernels run on the CPU only in interpret mode, whose
`io_callback`s can deadlock under pytest-xdist. A port test module that
needs such references names a function of its own that computes them
(keyword arguments in, a dict of numpy arrays out) and the cases to run;
`jax_results` runs every case in one child Python process, which pins
JAX to the CPU as `conftest.py` does (XLA's CPU work on one thread),
and hands the arrays back through an `.npz` file in `out_dir`. A child
that hangs (the deadlock strikes a fresh process too, at random: its CPU
time stops growing) is killed after `STALL_S` without progress, or past
a generous cap (`child_timeout`), and started once more; a crash, or a
second hang, raises in the caller (the module fixture), so it fails the
tests that needed the results and the run goes on.

Run as a script by `jax_results` only:
    python jax_subprocess.py SPEC.json
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
ATTEMPTS = 2
# A child's XLA CPU work on one thread: the tier-1 run has 6 workers on
# the machine's cores, each of whose children would otherwise start a
# thread pool the size of the machine. In 54 runs of two modules' children
# six at a time each way, none stalled; the longest took 59.8 s with these
# flags and 74.5 s without.
SINGLE_THREAD_FLAGS = ("--xla_cpu_multi_thread_eigen=false "
                       "intra_op_parallelism_threads=1")
# The longest a module's child took (s) with 6 workers: the larger of
# runs on 8 cores and one on 4 (`taskset -c 0-3`, the whole tier-1
# command), measured through `TEAL_TEST_CHILD_LOG`. A child is
# killed (and started once more) when its CPU time has not grown for
# STALL_S -- the interpreter's deadlock leaves it blocked -- or after
# CAP_FACTOR times this (at least MIN_TIMEOUT_S): a machine with fewer or
# slower cores stretches a healthy child's wall time, which must not
# cost it a second run (on 2 cores the old cap of twice the 8-core time
# killed five modules' children, some twice).
CHILD_WORST_S = {
    "test_torch_tp_kernel.py": 273,
    "test_torch_quant.py": 158,
    "test_torch_layer_loop.py": 141,
    "test_torch_batched.py": 135,
    "test_torch_verify.py": 115,
    "test_torch_serving.py": 87,
    "test_torch_moe.py": 75,
    "test_torch_speculative.py": 71,
    "test_torch_layer_ops.py": 66,
    "test_torch_token_kernel.py": 60,
    "test_torch_model.py": 60,
    "test_torch_serving_tp.py": 52,
    "test_torch_permute.py": 50,
    "test_torch_multihost.py": 42,
    "test_torch_hidden.py": 33,
    "test_torch_prefill.py": 23,
    "test_torch_attn_block.py": 32,
}
MIN_TIMEOUT_S = 600.0
CAP_FACTOR = 6.0
DEFAULT_TIMEOUT_S = 1800.0        # a module not measured yet
STALL_S = 120.0                   # no CPU progress this long: hung
POLL_S = 2.0


def child_timeout(module_file: str) -> float:
    """An attempt's longest wall time for a module's child
    (`CHILD_WORST_S`, `CAP_FACTOR`); a stalled child goes sooner
    (`STALL_S`)."""
    worst = CHILD_WORST_S.get(Path(module_file).name)
    return (DEFAULT_TIMEOUT_S if worst is None
            else max(MIN_TIMEOUT_S, CAP_FACTOR * worst))


def cpu_seconds(pid: int) -> float:
    """The CPU seconds (user and system, its threads included) a live
    process has used, from /proc; -1 where it cannot be read."""
    try:
        fields = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1]
    except OSError:
        return -1.0
    f = fields.split()
    return (int(f[11]) + int(f[12])) / os.sysconf("SC_CLK_TCK")


class Watch:
    """Whether a running process looks hung: its CPU time has not grown by
    half a second for `stall` seconds, or it has run `cap` seconds."""

    def __init__(self, pids, cap: float, stall: float = STALL_S):
        self.pids, self.cap, self.stall = list(pids), cap, stall
        self.t0 = self.seen = time.perf_counter()
        self.cpu = self._cpu()

    def _cpu(self) -> float:
        return sum(max(cpu_seconds(p), 0.0) for p in self.pids)

    def hung(self) -> bool:
        now, cpu = time.perf_counter(), self._cpu()
        if cpu > self.cpu + 0.5:
            self.cpu, self.seen = cpu, now
        return now - self.seen > self.stall or now - self.t0 > self.cap


def jax_results(module_file: str, fn: str, cases: Dict[str, dict],
                out_dir, timeout: Optional[float] = None
                ) -> Dict[str, Dict[str, np.ndarray]]:
    """{case: fn(**cases[case])} for every case, computed by the function
    `fn` of the module at `module_file` in one child process (killed when
    it stalls for `STALL_S` or runs past `timeout` seconds, by default
    `child_timeout(module_file)`, and started again, `ATTEMPTS` times at
    most). Case arguments must be JSON values."""
    if timeout is None:
        timeout = child_timeout(module_file)
    out_dir = Path(out_dir)
    spec = out_dir / "spec.json"
    out = out_dir / "results.npz"
    spec.write_text(json.dumps(dict(module=str(module_file), fn=fn,
                                    cases=cases, out=str(out))))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for attempt in range(1, ATTEMPTS + 1):
        t0 = time.perf_counter()
        # stderr to a file: no pipe fills while the parent polls
        with open(out_dir / "stderr.txt", "w") as err:
            proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), str(spec)],
                cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err)
        watch = Watch([proc.pid], timeout)
        while proc.poll() is None and not watch.hung():
            time.sleep(POLL_S)
        if proc.poll() is not None:
            _log(module_file, fn, attempt, t0, f"rc {proc.returncode}")
            break
        proc.kill()
        proc.wait()
        _log(module_file, fn, attempt, t0, "killed")
        if attempt == ATTEMPTS:
            raise RuntimeError(
                f"the JAX reference {fn} of {module_file} stalled for "
                f"{STALL_S:.0f} s or ran past {timeout:.0f} s, {ATTEMPTS} "
                "times (killed)")
    if proc.returncode != 0:
        err = (out_dir / "stderr.txt").read_text()
        raise RuntimeError(f"the JAX reference {fn} of {module_file} failed "
                           f"(rc {proc.returncode}):\n{err[-4000:]}")
    res: Dict[str, Dict[str, np.ndarray]] = {c: {} for c in cases}
    with np.load(out) as z:
        for key in z.files:
            case, name = key.split("::", 1)
            res[case][name] = z[key]
    return res


def _log(module_file, fn, attempt, t0, outcome) -> None:
    """One line a child run (module, function, attempt, seconds, outcome)
    appended to the file `TEAL_TEST_CHILD_LOG` names, where it is set:
    the measurement behind the timeouts above."""
    path = os.environ.get("TEAL_TEST_CHILD_LOG")
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(dict(
                module=Path(module_file).name, fn=fn, attempt=attempt,
                seconds=round(time.perf_counter() - t0, 2),
                outcome=outcome)) + "\n")


def _main(spec_path: str) -> None:
    import importlib.util

    spec = json.loads(Path(spec_path).read_text())
    # the CPU pinning of tests/conftest.py, before anything imports jax;
    # XLA's CPU work on one thread (`SINGLE_THREAD_FLAGS`)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags += " --xla_force_host_platform_device_count=8"
    if "xla_cpu_multi_thread_eigen" not in flags:
        flags += " " + SINGLE_THREAD_FLAGS
    os.environ["XLA_FLAGS"] = flags.strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    for p in (str(ROOT), str(Path(spec["module"]).parent)):
        if p not in sys.path:
            sys.path.insert(0, p)
    mspec = importlib.util.spec_from_file_location(
        "_jax_reference_module", spec["module"])
    mod = importlib.util.module_from_spec(mspec)
    mspec.loader.exec_module(mod)
    fn = getattr(mod, spec["fn"])
    arrays = {}
    for case, kwargs in spec["cases"].items():
        for name, a in fn(**kwargs).items():
            arrays[f"{case}::{name}"] = np.asarray(a)
    tmp = spec["out"] + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, spec["out"])


if __name__ == "__main__":
    _main(sys.argv[1])
