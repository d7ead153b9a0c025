"""Build-on-demand loader for the native calibration library.

Compiles `histogram.cpp` (host C++, OpenMP) with `g++` into
`build/teal_tpu_torch/` beside the package (listed in `.gitignore`),
named by a hash of the source and flags, so an edit rebuilds and an
unchanged source loads the cached library (the cache policy of the
kernels' builds, `_build.library_path` / `start_build`); binds it with
`ctypes`.

Unlike the reference loader (`teal_tpu/native/loader.py`), which returns
None when the build fails so that callers fall back to numpy, this one
raises with the compiler's output: the port has no silent fallback.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

from teal_tpu_torch._build import (BUILD_DIR, finish_build, library_path,
                                  start_build)

SRC = Path(__file__).resolve().parent / "histogram.cpp"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp"]

_lib = None
_lock = threading.Lock()


def _target() -> Path:
    return library_path("histogram", [SRC], FLAGS, BUILD_DIR)


def _build(out: Path) -> None:
    cmd = ["g++", *FLAGS, str(SRC)]
    try:
        rc, text = finish_build(start_build(cmd, out), timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {SRC.name} failed: {' '.join(cmd)}: "
                           f"{e}") from e
    if rc != 0:
        raise RuntimeError(f"building {SRC.name} failed (g++ exit {rc}): "
                           f"{' '.join(cmd)}\n{text}")


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built first where no cached build of
    this source exists. Raises RuntimeError when it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = _target()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        f32p, f64p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(
            ctypes.c_double)
        lib.teal_order_stats.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64, f32p]
        lib.teal_order_stats.restype = None
        lib.teal_histogram_count.argtypes = [f32p, ctypes.c_int64, f64p,
                                             ctypes.c_int64, f64p]
        lib.teal_histogram_count.restype = None
        _lib = lib
        return _lib
