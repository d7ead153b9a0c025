#!/usr/bin/env python3
"""Write the bulk-copy variant of K7's rows form into a copy of the repo.

    git archive HEAD | tar -x -C build/variants/bulk
    python3 tools/k7_rows_bulk_variant.py build/variants/bulk
    python3 tools/k7_determinism.py --root build/variants/bulk --tag bulk

The rows form's producer warp stages the rows' input at a slot's rows by
generic loads through L2 and stores them beside the slot's TMA boxes. The
variant stages them instead by one 1-D bulk copy a row
(`cp.async.bulk`, completing on the slot's full barrier, which then
expects the boxes' bytes plus B rows' and counts one arrival), with
`fence.proxy.async.global` before every grid barrier and at the start of
each stage's producer: the staging the rows form had before. It rewrites
`teal_tpu_torch/csrc/token_decode_rows.cuh` of the tree given, so that
`tools/k7_determinism.py` and `tools/k7_rows_check.py` can hold the two
stagings against each other on the card. Nothing of the repo runs it.
"""

import sys
from pathlib import Path

SOURCE = "teal_tpu_torch/csrc/token_decode_rows.cuh"

HELPERS = """// generic-proxy writes of global memory before later async-proxy (bulk
// copy) reads of it, and the other way round
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\\n" ::: "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

"""

BULK = """        if (lane >= 2 && lane < 2 + B)
          bulk_load(smem_u32(sm + xring) + q.s * XSLOT + (lane - 2) * XS,
                    x + static_cast<size_t>(lane - 2) * K + g * HD +
                        half * KR,
                    KR * ESZ, full);
"""

PRODUCER = """  if (warp == NWORK) {                   // the producer
"""
LOADS = "        uint4 xv[XPL];"
FULL = "        const uint32_t full = bars + q.s * 8;"
STORES = ("#pragma unroll\n        for (int i = 0; i < XPL; ++i) {\n"
          "          const int j = lane + 32 * i, b = j / XCH;\n"
          "          if (b < B)\n            *reinterpret_cast")
ARRIVE = "        if (lane == 0) mbar_arrive(full);\n"
EXPECT = ("mbar_expect_tx(full, TX);",
          "mbar_expect_tx(full, TX + B * KR * ESZ);")
INIT = ("mbar_init(bars + s * 8, 2);", "mbar_init(bars + s * 8, 1);")
GRID = "  auto grid_barrier = [&]() {\n"


def variant(s: str) -> str:
    """The bulk-copy staging in place of the generic loads and stores."""
    def one(old):
        if s.count(old) != 1:
            raise SystemExit(f"k7_rows_bulk_variant: {SOURCE} has changed "
                             f"near {old[:60]!r}")
        return s.index(old)

    i = one("constexpr int MAXB = 16;")
    s = s[:i] + HELPERS + s[i:]
    i = one(PRODUCER) + len(PRODUCER)
    s = s[:i] + "    fence_proxy_global();\n" + s[i:]
    s = s[:one(LOADS)] + s[one(FULL):]
    one(EXPECT[0])
    s = s.replace(*EXPECT)
    s = s[:one(STORES)] + BULK + s[one(ARRIVE) + len(ARRIVE):]
    one(INIT[0])
    s = s.replace(*INIT)
    i = one(GRID) + len(GRID)
    return s[:i] + "    fence_proxy_global();\n" + s[i:]


def main() -> int:
    if len(sys.argv) != 2:
        print("usage: k7_rows_bulk_variant.py TREE", file=sys.stderr)
        return 2
    p = Path(sys.argv[1]) / SOURCE
    p.write_text(variant(p.read_text()))
    print(f"wrote the bulk-copy variant into {p}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
