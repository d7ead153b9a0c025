"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source is compiled by `nvcc` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), and
loaded with `ctypes`. All sources compile at once, one `nvcc` process each.
Libraries land in `build/teal_tpu_torch/` beside the package (listed in
`.gitignore`), named by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads the cached library.

Nothing is built at import time: the first kernel launch calls `load()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "teal_tpu_torch"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", ARCH,
         "-Xptxas", "-v", "-lineinfo"]

# C signatures of the kernels' entry points: (library stem, function) ->
# argtypes. Every function returns the launch's cudaGetLastError() as int.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    ("select_gather_gemv", "teal_select_gather_gemv"): [
        _I, _I,                 # dtype code (0 fp32, 1 bf16), weight plan
        _P, _P, _P, _F,         # x, thr, norm (or null), norm_eps
        _P, _P, _P,             # w0, w1, w2
        _P, _P, _P,             # int4 sz0-2 (or null)
        _P, _P, _P,             # int8 scale0-2 (or null)
        _I, _I, _I,             # n0, n1, n2
        _I, _P, _P, _P, _P,     # n_w, res (or null), out, idx, count
        _I, _I, _I, _I, _I,     # K, G, layer, cap, mode
        _I, _I,                 # rows, fixed selection
        _P, _I, _I, _P,         # device layers (or null), slot, L,
                                # routing weights (mode 3, or null)
        _P,                     # stream
    ],
    ("select_gather_gemv", "teal_sgg_plan"): [
        _I, _I, _I, _I,         # dtype code, weight plan, pair, G
        _I, _I, _I, _I,         # n0, n1, n2, n_w
        _I, _I, _I, _P,         # K, cap, SM count, out int32 [4]
    ],
    ("select_gather_gemv", "teal_sgg_rows_plan"): [
        _I, _I, _I, _I, _I,     # dtype code, weight plan, pair, K, n_out
        _I, _I, _P,             # cap, SM count, out int32 [4]
    ],
    ("select_gather_gemv", "teal_sgg_rows_residency"): [
        _I, _I, _I, _I, _I,     # dtype code, weight plan, pair, K, n_out
        _I, _P,                 # cap, out int32 [3]
    ],
    ("block_gather_gemv", "teal_block_gather_gemv"): [
        _I, _I, _P, _P,         # dtype code, weight plan, idx, xpack
        _P, _P, _P,             # w0, w1, w2
        _P, _P, _P,             # int4 sz0-2 (or null)
        _I, _I, _I, _I, _P,     # n0, n1, n2, n_w, out
        _I, _I, _I, _I, _I, _I,  # K, G, layer, k_keep, xpack rows, rows
        _P,                     # stream
    ],
    ("block_gather_gemv", "teal_block_gather_plan"): [
        _I, _I, _I,             # dtype code, weight plan, G
        _I, _I, _I, _I,         # n0, n1, n2, n_w
        _I, _I, _I, _P,         # k_keep, xpack rows R, SM count,
                                # out int32 [4]
    ],
    ("block_gather_gemv", "teal_block_gather_split"): [
        _I, _I, _I, _P,         # k_keep, S, split, out int32 [2]
    ],
    ("row_gather_gemv", "teal_row_gather_gemv"): [
        _I, _P, _P, _P, _P,     # dtype code, idx, xc, w, out
        _I, _I, _I, _P,         # K, N, nnz, stream
    ],
    ("row_gather_gemv", "teal_row_gather_plan"): [
        _I, _I, _I, _P,         # dtype code, N, SM count, out int32 [5]
    ],
    ("row_gather_gemv", "teal_row_gather_split"): [
        _I, _I, _I, _P,         # nnz, S, split, out int32 [2]
    ],
    ("decode_attention", "teal_decode_attention"): [
        _I,                     # dtype code
        _P, _P, _P, _P,         # q, k_new, v_new, cos|sin
        _P, _P, _P, _P,         # kc, vc, pos, out
        _I, _I, _I, _I, _I,     # B, Hq, Hkv, T, layer
        _I, _F,                 # window (0: none), scale
        _I, _I, _I,             # q row stride, k/v row stride, seq_block
        _I, _I, _P,             # splits, slots a cluster, stream
    ],
    ("decode_attention", "teal_decode_attention_smem"): [
        _I, _I, _I, _I, _I, _I,  # dtype code, GH, slots, rebuilt rows, T, S
    ],
    ("moe_route", "teal_moe_route"): [
        _I, _P, _P, _F, _P,     # dtype code, x, norm, norm_eps, router
        _P, _P, _P,             # xn, pseudo-layers, weights (outputs)
        _I, _I, _I, _I, _P,     # D, E, k_exp, layer, stream
    ],
    ("moe_route", "teal_moe_route_plan"): [
        _I, _I, _P,             # D, E, out int32 [3]
    ],
    ("moe_route", "teal_empty_launch"): [
        _I, _I, _P,             # blocks, in one cluster (0: no), stream
    ],
    ("flash_prefill", "teal_flash_prefill"): [
        _I, _P, _P, _P, _P,     # dtype code, q, k, v, out
        _I, _I, _I, _I, _F,     # B, Hq, Hkv, S, scale
        _P,                     # stream
    ],
    ("flash_prefill", "teal_flash_prefill_plan"): [
        _I, _I, _I, _I, _I, _P,  # dtype code, B, Hq, S, SM count,
                                # out int32 [4]
    ],
}

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Optional[float] = None
ptxas_report: List[str] = []
_sms: Dict[int, int] = {}        # CUDA device index -> SM count


def sm_count(index: int) -> int:
    """The SM count of CUDA device `index` (the kernels' launch plans
    read it)."""
    if index not in _sms:
        import torch

        _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sms[index]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset, no nvcc "
                           "on PATH): the port's kernels cannot be built")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(stem: str, inputs: List[Path], flags: List[str],
                 build_dir: Path = BUILD_DIR) -> Path:
    """Where a build of `inputs` with `flags` is cached:
    `build_dir/lib<stem>_<hash of the inputs and flags>.so`."""
    h = hashlib.sha256()
    for f in inputs:
        h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    return build_dir / f"lib{stem}_{h.hexdigest()[:16]}.so"


def start_build(cmd: List[str], out: Path):
    """Start `cmd -o <tmp>` (a compiler command without its output), the
    tmp file pid-suffixed beside `out`. Returns a job for `finish_build`."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def finish_build(job, timeout: Optional[float] = None) -> Tuple[int, str]:
    """Wait for a `start_build` job; on success move its output into
    place. Returns (exit code, the compiler's output). A job past
    `timeout` seconds is killed and raises subprocess.TimeoutExpired."""
    out, tmp, proc = job
    try:
        text, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode == 0:
        os.replace(tmp, out)
    return proc.returncode, text


def _target(src: Path) -> Path:
    return library_path(src.stem, sorted(CSRC.glob("*.cuh")) + [src], FLAGS)


def load() -> Dict[str, ctypes.CDLL]:
    """Build (where not cached) and load every kernel library. Returns
    {source stem: CDLL} with argtypes/restype set."""
    global build_seconds
    if _libs:
        return _libs
    t0 = time.perf_counter()
    srcs = sorted(CSRC.glob("*.cu"))
    jobs = [(src, start_build([_nvcc(), *FLAGS, str(src)], _target(src)))
            for src in srcs if not _target(src).exists()]
    errors = []
    for src, job in jobs:
        rc, out = finish_build(job)
        if rc != 0:
            errors.append(f"nvcc failed for {src.name}:\n{out}")
            continue
        ptxas_report.extend(line for line in out.splitlines()
                            if "ptxas" in line)
    if errors:
        raise RuntimeError("\n".join(errors))
    for src in srcs:
        lib = ctypes.CDLL(str(_target(src)))
        for (stem, fn), argtypes in SIGNATURES.items():
            if stem == src.stem:
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
        _libs[src.stem] = lib
    build_seconds = time.perf_counter() - t0
    return _libs


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaGetLastError() returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
