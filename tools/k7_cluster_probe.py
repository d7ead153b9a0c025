#!/usr/bin/env python3
"""What the card and the CUDA runtime allow a K7 launch: clusters and
cooperative launches together, and how many clusters of each size can be
resident at once.

    python3 tools/k7_cluster_probe.py

Builds a small kernel of K7's block shape (288 threads, one block an SM
through 232448 bytes of dynamic shared memory) with the port's nvcc flags
into `build/k7_cluster_probe/`, then prints, for cluster sizes 1-16
(sizes above 8 with `cudaFuncAttributeNonPortableClusterSizeAllowed`),
`cudaOccupancyMaxActiveClusters`; and for sizes 2, 4, 8 and 16 whether a
launch of that many clusters with `cudaLaunchAttributeClusterDimension`,
with and without `cudaLaunchAttributeCooperative`, is taken, and whether
all its blocks were resident together (each block arrives at a counter
and spins until every block has, bounded by 1 s of `%globaltimer`).
Last, the card's name and power limit and one JSON object of it all.
It imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SOURCE = r"""
#include <cuda_runtime.h>

__global__ void __launch_bounds__(288, 1) probe_kernel(unsigned* ctr,
                                                       unsigned target,
                                                       unsigned* late) {
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" :: "l"(ctr)
                 : "memory");
    unsigned long long t0, t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    for (;;) {
      unsigned v;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v)
                   : "l"(ctr) : "memory");
      if (v >= target) break;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      if (t - t0 > 1000000000ull) {
        atomicAdd(late, 1u);
        break;
      }
    }
  }
  __syncthreads();
}

static void config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[2],
                   int C, int clusters, int coop, int smem) {
  cfg = {};
  cfg.gridDim = dim3(C * (clusters > 0 ? clusters : 1), 1, 1);
  cfg.blockDim = dim3(288, 1, 1);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = coop ? 2 : 1;
}

extern "C" int probe_attrs(int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaFuncSetAttribute(
      probe_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
}

extern "C" int probe_clusters(int C, int smem, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  config(cfg, attr, C, 1, 0, smem);
  *out = -1;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(out, probe_kernel, &cfg);
  cudaGetLastError();
  return static_cast<int>(e);
}

extern "C" int probe_launch(int C, int clusters, int coop, int smem,
                            unsigned* ctr, unsigned* late) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  config(cfg, attr, C, clusters, coop, smem);
  cudaError_t e = cudaLaunchKernelEx(&cfg, probe_kernel, ctr,
                                     static_cast<unsigned>(C * clusters),
                                     late);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  cudaGetLastError();
  return static_cast<int>(e);
}
"""

SMEM = 232448


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k7_cluster_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from teal_tpu_torch import _build

    out_dir = ROOT / "build" / "k7_cluster_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "probe.cu"
    src.write_text(SOURCE)
    so = out_dir / "libprobe.so"
    subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_attrs.argtypes = [I]
    lib.probe_clusters.argtypes = [I, I, P]
    lib.probe_launch.argtypes = [I, I, I, I, P, P]
    for f in (lib.probe_attrs, lib.probe_clusters, lib.probe_launch):
        f.restype = I
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)                     # a context first
    res = {"attrs": lib.probe_attrs(SMEM), "sms": _build.sm_count(0),
           "clusters": {}, "launches": {}}
    for C in range(1, 17):
        n = ctypes.c_int(-1)
        err = lib.probe_clusters(C, SMEM, ctypes.byref(n))
        res["clusters"][C] = (n.value, err)
        print(f"clusters of {C}: {n.value} resident ({C * n.value} blocks),"
              f" error {err}")
    for C in (2, 4, 8, 16):
        n = res["clusters"][C][0]
        if n < 1:
            continue
        for coop in (0, 1):
            ctr = torch.zeros(2, dtype=torch.int32, device=dev)
            err = lib.probe_launch(C, n, coop, SMEM, ctr.data_ptr(),
                                   ctr[1:].data_ptr())
            got = ctr.tolist()
            res["launches"][f"{C}x{n}{' coop' if coop else ''}"] = dict(
                error=err, arrived=got[0], late=got[1])
            print(f"{n} clusters of {C}, cooperative {coop}: error {err}, "
                  f"{got[0]} of {C * n} blocks arrived, {got[1]} late")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    res["card"] = card
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
