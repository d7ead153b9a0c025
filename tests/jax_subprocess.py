"""Reference results from the JAX package, computed in a subprocess with
its own timeout.

The JAX Pallas kernels run on the CPU only in interpret mode, whose
`io_callback`s can deadlock under pytest-xdist. A port test module that
needs such references names a function of its own that computes them
(keyword arguments in, a dict of numpy arrays out) and the cases to run;
`jax_results` runs every case in one child Python process, which pins
JAX to the CPU as `conftest.py` does (XLA's CPU work on one thread),
and hands the arrays back through an `.npz` file in `out_dir`. A child
that hangs (the deadlock strikes a fresh process too, at random) is
killed after twice the longest its module's child has taken
(`child_timeout`) and started once more; a crash, or a second hang,
raises in the caller (the module fixture), so it fails the tests that
needed the results and the run goes on.

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
# The longest a module's child took (s) in the builder's three runs with 6
# workers (twice the port's test files, once the whole tier-1 command),
# measured through `TEAL_TEST_CHILD_LOG`; an attempt gets twice that (at
# least MIN_TIMEOUT_S), so that a stalled child costs about one normal run
# more rather than 400 s.
CHILD_WORST_S = {
    "test_torch_tp_kernel.py": 252,
    "test_torch_layer_loop.py": 126,
    "test_torch_verify.py": 115,
    "test_torch_quant.py": 103,
    "test_torch_batched.py": 91,
    "test_torch_serving.py": 81,
    "test_torch_model.py": 52,
    "test_torch_moe.py": 52,
    "test_torch_serving_tp.py": 49,
    "test_torch_speculative.py": 45,
    "test_torch_layer_ops.py": 44,
    "test_torch_token_kernel.py": 44,
    "test_torch_permute.py": 38,
    "test_torch_hidden.py": 33,
    "test_torch_multihost.py": 33,
    "test_torch_prefill.py": 18,
}
MIN_TIMEOUT_S = 120.0
DEFAULT_TIMEOUT_S = 400.0         # a module not measured yet


def child_timeout(module_file: str) -> float:
    """An attempt's timeout for a module's child (`CHILD_WORST_S`)."""
    worst = CHILD_WORST_S.get(Path(module_file).name)
    return (DEFAULT_TIMEOUT_S if worst is None
            else max(MIN_TIMEOUT_S, 2.0 * worst))


def jax_results(module_file: str, fn: str, cases: Dict[str, dict],
                out_dir, timeout: Optional[float] = None
                ) -> Dict[str, Dict[str, np.ndarray]]:
    """{case: fn(**cases[case])} for every case, computed by the function
    `fn` of the module at `module_file` in one child process (killed
    after `timeout` seconds, by default `child_timeout(module_file)`, and
    started again, `ATTEMPTS` times at most). Case arguments must be JSON
    values."""
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
        try:
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), str(spec)],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=timeout)
            _log(module_file, fn, attempt, t0, f"rc {proc.returncode}")
            break
        except subprocess.TimeoutExpired as e:
            _log(module_file, fn, attempt, t0, "killed")
            if attempt == ATTEMPTS:
                raise RuntimeError(
                    f"the JAX reference {fn} of {module_file} did not finish "
                    f"in {timeout:.0f} s, {ATTEMPTS} times (killed)") from e
    if proc.returncode != 0:
        raise RuntimeError(f"the JAX reference {fn} of {module_file} failed "
                           f"(rc {proc.returncode}):\n{proc.stderr[-4000:]}")
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
