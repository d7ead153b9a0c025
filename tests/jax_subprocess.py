"""Reference results from the JAX package, computed in a subprocess with
its own timeout.

The JAX Pallas kernels run on the CPU only in interpret mode, whose
`io_callback`s can deadlock under pytest-xdist. A port test module that
needs such references names a function of its own that computes them
(keyword arguments in, a dict of numpy arrays out) and the cases to run;
`jax_results` runs every case in one child Python process, which pins
JAX to the CPU as `conftest.py` does, and hands the arrays back through
an `.npz` file in `out_dir`. A child that hangs (the deadlock strikes a
fresh process too, at random) is killed after `timeout` seconds and
started once more; a crash, or a second hang, raises in the caller (the
module fixture), so it fails the tests that needed the results and the
run goes on.

Run as a script by `jax_results` only:
    python jax_subprocess.py SPEC.json
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
DEFAULT_TIMEOUT_S = 400.0         # an attempt; the longest child takes ~2 min
ATTEMPTS = 2


def jax_results(module_file: str, fn: str, cases: Dict[str, dict],
                out_dir, timeout: float = DEFAULT_TIMEOUT_S
                ) -> Dict[str, Dict[str, np.ndarray]]:
    """{case: fn(**cases[case])} for every case, computed by the function
    `fn` of the module at `module_file` in one child process (killed
    after `timeout` seconds and started again, `ATTEMPTS` times at
    most). Case arguments must be JSON values."""
    out_dir = Path(out_dir)
    spec = out_dir / "spec.json"
    out = out_dir / "results.npz"
    spec.write_text(json.dumps(dict(module=str(module_file), fn=fn,
                                    cases=cases, out=str(out))))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for attempt in range(1, ATTEMPTS + 1):
        try:
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), str(spec)],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=timeout)
            break
        except subprocess.TimeoutExpired as e:
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


def _main(spec_path: str) -> None:
    import importlib.util

    spec = json.loads(Path(spec_path).read_text())
    # the CPU pinning of tests/conftest.py, before anything imports jax
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
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
