"""Profiling and structured run metrics.

Port of `teal_tpu/utils/profiling.py` (the reference wraps its last
sample in `torch.profiler` and exports a Chrome trace,
`gpt-fast/generate.py:460-485`): `trace()` wraps a region in
`torch.profiler.profile` with CPU and, where a card is present, CUDA
activities and writes one Chrome trace file into its directory;
`write_metrics` appends one JSON line a run; `device_memory_stats` reads
the allocator's live and peak bytes and the card's memory size;
`graph_kernels` counts the kernels a captured CUDA graph launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import time
from typing import Dict, Optional

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


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of the driver API (cuda.h)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_kernels(graph: "torch.cuda.CUDAGraph") -> Dict[str, int]:
    """The kernel nodes of a captured CUDA graph, by (mangled) kernel
    name: exactly the kernels each replay launches, read from the CUDA driver
    (`cuGraphGetNodes`, `cuFuncGetName`), where a profiler's trace may
    miss a record. The graph must keep its `cudaGraph_t`
    (`CUDAGraph(keep_graph=True)`, as `engine.generate.capture_graph`
    makes it)."""
    cu = ctypes.CDLL("libcuda.so.1")
    P = ctypes.c_void_p

    def ok(res, what):
        if res != 0:
            raise RuntimeError(f"{what} failed with CUresult {res}")

    counts: Dict[str, int] = {}

    def walk(g):
        n = ctypes.c_size_t(0)
        ok(cu.cuGraphGetNodes(P(g), None, ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (P * n.value)()
        ok(cu.cuGraphGetNodes(P(g), nodes, ctypes.byref(n)), "cuGraphGetNodes")
        for node in nodes:
            kind = ctypes.c_int()
            ok(cu.cuGraphNodeGetType(P(node), ctypes.byref(kind)),
               "cuGraphNodeGetType")
            if kind.value == 5:                # CU_GRAPH_NODE_TYPE_GRAPH
                child = P()
                ok(cu.cuGraphChildGraphNodeGetGraph(P(node),
                                                    ctypes.byref(child)),
                   "cuGraphChildGraphNodeGetGraph")
                walk(child.value)
            elif kind.value == 0:              # CU_GRAPH_NODE_TYPE_KERNEL
                prm = _KernelNodeParams()
                ok(cu.cuGraphKernelNodeGetParams_v2(P(node),
                                                    ctypes.byref(prm)),
                   "cuGraphKernelNodeGetParams")
                name = ctypes.c_char_p()
                if prm.func:
                    ok(cu.cuFuncGetName(ctypes.byref(name), P(prm.func)),
                       "cuFuncGetName")
                else:
                    ok(cu.cuKernelGetName(ctypes.byref(name), P(prm.kern)),
                       "cuKernelGetName")
                key = name.value.decode()
                counts[key] = counts.get(key, 0) + 1

    walk(graph.raw_cuda_graph())
    return counts
