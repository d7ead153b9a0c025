"""Profiling and structured run metrics.

Port of `teal_tpu/utils/profiling.py` (the reference wraps its last
sample in `torch.profiler` and exports a Chrome trace,
`gpt-fast/generate.py:460-485`): `trace()` wraps a region in
`torch.profiler.profile` with CPU and, where a card is present, CUDA
activities and writes one Chrome trace file into its directory;
`write_metrics` appends one JSON line a run; `device_memory_stats` reads
the allocator's live and peak bytes and the card's memory size.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """torch.profiler trace of the block, written as
    `trace_<time>.json` into trace_dir; a no-op when trace_dir is falsy."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{time.time_ns()}.json"))


def write_metrics(path: str, record: dict) -> None:
    """Append one JSON line of run metrics (timestamped)."""
    record = {"ts": time.time(), **record}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def device_memory_stats(device="cuda") -> dict:
    """Live and peak bytes of PyTorch's allocator on a CUDA `device` and
    the card's memory size, under the reference's keys; {} for a CPU
    device or where no card is present."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current"),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        "bytes_limit": total,
    }
