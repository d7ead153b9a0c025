"""Build an older commit's kernel source into a library of its own, for
the in-turns comparisons of `tools/*_vs_parent.py`.

The sources come from `git show` into a directory (the kernel's `.cu`
and the `common.cuh` it includes); the library is built with this tree's
`nvcc` flags into `build/<stem>/` (git-ignored) and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def build_older(src_dir: str, source: str, stem: str) -> ctypes.CDLL:
    """Compile `src_dir/source` (e.g. "decode_attention.cu") with the
    port's nvcc flags into `build/<stem>/lib<stem>.so` and load it. The
    caller sets each entry point's argtypes and restype."""
    from teal_tpu_torch import _build

    out_dir = ROOT / "build" / stem
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"lib{stem}.so"
    subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", str(so),
                    str(Path(src_dir) / source)], check=True,
                   capture_output=True, timeout=600)
    return ctypes.CDLL(str(so))
