"""K5's launch plan (`token_block._route_plan`) as a pure function of D
and E, on the CPU: the Python mirror of the kernel's `route_plan` (the
card test `test_k5_plan_matches_kernel` in test_torch_cuda.py holds the
two together). No kernel runs here."""

import pytest

from teal_tpu_torch.ops import gather_gemv as tgg
from teal_tpu_torch.ops import token_block as tb

SMEM_BLOCK = 232448              # a block's shared memory on Hopper


@pytest.mark.parametrize("E", [1, 4, 8, 16, 64])
@pytest.mark.parametrize("D", [1000, 1024, 4096, 6144])
def test_k5_plan_covers_rows_once(D, E):
    """One cluster of C <= 8 blocks (a power of two); the C row ranges
    (`split_range`, the kernel's `split_lo`) cover [0, D) once and in
    order, none empty and none above `rows`; a block's router slab (rows
    * E fp32) fits its shared memory, which fits a block's 227 KB."""
    C, rows, smem = tb._route_plan(D, E)
    assert C in (1, 2, 4, 8)
    shares = [tgg.split_range(D, C, s) for s in range(C)]
    assert shares[0][0] == 0 and shares[-1][1] == D
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    assert sum(hi - lo for lo, hi in shares) == D
    assert all(0 < hi - lo <= rows for lo, hi in shares)
    assert rows == max(hi - lo for lo, hi in shares)
    assert rows * E * 4 < smem == tb._route_smem(rows, E) <= SMEM_BLOCK


def test_k5_plan_rule():
    """Mixtral's D = 4096 over 8 blocks of 512 rows; a D too small for 8
    blocks of 64 rows takes fewer; E outside [1, 64], D < 1, a slab past
    shared memory or more than 1024 rows a block (4 a thread) has no
    plan (the wrapper raises on the card)."""
    assert tb._route_plan(4096, 8)[:2] == (8, 512)
    assert tb._route_plan(1020, 8)[:2] == (8, 128)
    assert tb._route_plan(256, 8)[:2] == (4, 64)
    assert tb._route_plan(100, 8)[:2] == (1, 100)
    assert tb._route_plan(8192, 8)[:2] == (8, 1024)
    for D, E in ((4096, 0), (4096, 65), (0, 8), (8192, 64), (8200, 1)):
        assert tb._route_plan(D, E) is None
    assert tb._route_plan(6144, 64) is not None
