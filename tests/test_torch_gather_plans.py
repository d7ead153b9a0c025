"""Launch plans of the gather GEMVs K3 (`block_gather_gemv`) and K4
(`row_gather_gemv`) as pure functions of shapes, and the split of their
kept groups and slots (`gather_gemv.split_range`), on the CPU: the Python
mirrors of the kernels' own plans and split (the card tests in
test_torch_cuda.py hold each mirror to the library's export). No kernel
runs here."""

import inspect

import pytest

from teal_tpu_torch.ops import block_gemv as tbg
from teal_tpu_torch.ops import gather_gemv as tgg

SMEM_BLOCK = 232448              # a block's shared memory on Hopper
SMEM_SM = 233472                 # an SM's; a resident block reserves 1 KB


def _covers_in_order(count: int, S: int) -> None:
    """The S splits of `count` items (`split_range`, the kernels' own
    `split_lo`) cover [0, count) once, in order; none is empty where
    count >= S."""
    shares = [tgg.split_range(count, S, s) for s in range(S)]
    assert shares[0][0] == 0 and shares[-1][1] == count
    assert all(a[1] == b[0] and a[0] <= a[1] for a, b in
               zip(shares, shares[1:]))
    assert sum(hi - lo for lo, hi in shares) == count
    if count >= S:
        assert all(hi > lo for lo, hi in shares)


# K4 at Llama-2-7B: (K, N) of the seven projections; nnz_cap = 0.625 K
_K4_7B = {"wq": (4096, 4096), "wgate": (4096, 11008),
          "wdown": (11008, 4096)}


@pytest.mark.parametrize("name", list(_K4_7B))
@pytest.mark.parametrize("esz", [2, 4])
@pytest.mark.parametrize("sms", [114, 132])
def test_k4_plan_at_7b(name, esz, sms):
    """K4's plan depends on the width and the card only; a tile is 256
    bytes of each row; the S slot ranges of every tile cover the nnz_cap
    slots once, in order, whatever their count; shared memory fits a
    block's 227 KB and two blocks an SM; the grid fills the card with at
    most two blocks an SM."""
    params = inspect.signature(tgg._plan).parameters
    assert not {"K", "nnz", "count"} & set(params)
    K, N = _K4_7B[name]
    tw, S, stages, chunk, smem = tgg._plan(esz, N, sms)
    assert tw * esz == 256 and S in (1, 2, 4, 8) and stages >= 3
    assert chunk % 256 == 0 and 2 * (smem + 1024) <= SMEM_SM
    tiles = -(-N // tw)
    grid = tiles * S
    assert sms <= grid <= 2 * sms or S == 8
    for nnz in (1, 7, int(K * 0.625), K):
        _covers_in_order(nnz, S)


def test_k4_plan_rule_at_7b():
    """On a 132-SM card, bf16: 32 tiles of 128 columns x 8 splits at
    N = 4096 (256 blocks), 86 x 2 at 11008 (172 blocks); each split's
    slots fit one compaction chunk at 7B's nnz_cap."""
    assert tgg._plan(2, 4096, 132)[:2] == (128, 8)
    assert tgg._plan(2, 11008, 132)[:2] == (128, 2)
    for K, N in _K4_7B.values():
        _, S, _, chunk, _ = tgg._plan(2, N, 132)
        assert -(-int(K * 0.625) // S) <= chunk


@pytest.mark.parametrize("N", [32, 96, 416, 1056, 4128])
def test_k4_plan_masks_a_last_tile(N):
    """Any N % 32 == 0: the tiles cover N with at most one partial tile,
    whose columns past N the kernel masks (no plan is refused)."""
    for esz in (2, 4):
        tw, S, _, _, _ = tgg._plan(esz, N, 132)
        tiles = -(-N // tw)
        assert (tiles - 1) * tw < N <= tiles * tw and S >= 1


# K3 on path A at Llama-2-7B, block size 32 (`chip_smoke.loop_stages`):
# (widths, G, k_keep at keep 0.5) for the stream and int8 plans, and G /
# k_keep for packed int4 (G >= 64)
_K3_7B = {"qkv": ((4096, 4096, 4096), 32, 64, 64, 32),
          "o": ((4096,), 32, 64, 64, 32),
          "gate|up": ((11008, 11008), 32, 64, 64, 32),
          "down": ((4096,), 64, 86, 64, 86)}


@pytest.mark.parametrize("stage", list(_K3_7B))
@pytest.mark.parametrize("plan", [tbg.PLAN_STREAM, tbg.PLAN_INT8,
                                  tbg.PLAN_INT4])
@pytest.mark.parametrize("esz", [2, 4])
@pytest.mark.parametrize("R", [1, 8])
@pytest.mark.parametrize("sms", [114, 132])
def test_k3_plan_at_7b(stage, plan, esz, R, sms):
    """K3's plan from shapes only (no row count, no kept count): the
    one-row stream for R = 1 (256 bytes of each slab row a block, an
    8-stage ring), the rows form for R = 8 (64-column tiles, a ring of
    2-8 stages as `_bgg_smem` counts it, and for bf16 room for two blocks
    an SM); S in {1, 2, 4, 8}; shared memory within a block's 227 KB; the
    grid within one block an SM; the S shares of a tile's kept list
    cover it once, in order, for every kept count."""
    params = inspect.signature(tbg._bgg_plan).parameters
    assert not {"rows", "count"} & set(params)
    ns, G, k_keep, G4, k4 = _K3_7B[stage]
    if plan == tbg.PLAN_INT4:
        G, k_keep = G4, k4
    form, S, stages, smem = tbg._bgg_plan(esz, plan, G, ns, k_keep, R, sms)
    assert form == (0 if R == 1 else 1) and S in (1, 2, 4, 8)
    if R == 1:
        tw = tbg._bgg_stream_tile(esz, plan)
        assert tw * (esz if plan == tbg.PLAN_STREAM else 1) == 256
        assert stages == 8 and smem == tbg._bgg_stream_smem(esz, plan, G)
        assert 2 * (smem + 1024) <= SMEM_SM
    else:
        tw = tbg.BGG_TILE
        assert 2 <= stages <= 8
        assert smem == tbg._bgg_smem(esz, plan, G, stages, S,
                                     -(-k_keep // S)) <= SMEM_BLOCK
        if esz == 2:
            assert 2 * (smem + 1024) <= SMEM_SM
    grid = sum(-(-n // tw) for n in ns) * S
    assert grid <= sms or S == 1
    for count in (1, S - 1, k_keep // 2, k_keep):
        if count >= 1:
            _covers_in_order(count, S)


def test_k3_plan_rule_at_7b():
    """On a 132-SM card, bf16. The one-row stream (R = 1): 128-column
    bf16 tiles, 256-column int8 / int4 tiles, and the splits that fill
    the card within one block an SM (o and down: 4 in bf16, 8 in int8 /
    int4; q|k|v 1 and 2; gate|up 1). The rows form (R = 8): the
    4096-wide o and down stages split over a cluster of 2 (64 tiles x 2 =
    128 blocks), q|k|v (192 tiles) and gate|up (344) take S = 1; the
    stream plan's ring keeps at least 4 stages, the int8 and int4 plans'
    at least 7."""
    one = {"qkv": (1, 2), "o": (4, 8), "gate|up": (1, 1), "down": (4, 8)}
    for stage, (ns, G, k_keep, G4, k4) in _K3_7B.items():
        want = 2 if stage in ("o", "down") else 1
        for plan, g, k, deep in ((tbg.PLAN_STREAM, G, k_keep, 4),
                                 (tbg.PLAN_INT8, G, k_keep, 7),
                                 (tbg.PLAN_INT4, G4, k4, 7)):
            form, S, stages, _ = tbg._bgg_plan(2, plan, g, ns, k, 8, 132)
            assert (form, S) == (1, want) and stages >= deep, \
                (stage, plan, S, stages)
            assert sum(-(-n // tbg.BGG_TILE) for n in ns) * S >= 128
            form, S, _, _ = tbg._bgg_plan(2, plan, g, ns, k, 1, 132)
            assert (form, S) == (0, one[stage][plan != tbg.PLAN_STREAM]), \
                (stage, plan, S)


@pytest.mark.parametrize("ns", [(32,), (96,), (256, 96, 32), (64, 64),
                                (4128,)])
@pytest.mark.parametrize("G", [32, 64, 128])
def test_k3_plan_small_shapes(ns, G):
    """Widths that are multiples of 32 but not of the tile (a masked last
    tile), 1-3 weights, every G, both forms, k_keep from 1 up, two SM
    counts: a plan always fits, and a kept count below S leaves some
    shares empty (the kernel skips them) while still covering the
    list."""
    for plan in (tbg.PLAN_STREAM, tbg.PLAN_INT8) + (
            (tbg.PLAN_INT4,) if G >= 64 else ()):
        for esz in (2, 4):
            for R in (1, 8):
                for k_keep in (1, 3, 9, 344):
                    for sms in (114, 132):
                        got = tbg._bgg_plan(esz, plan, G, ns, k_keep, R,
                                            sms)
                        assert got is not None
                        _, S, _, smem = got
                        assert smem <= SMEM_BLOCK
                        for count in (k_keep, 1, S - 1):
                            if count >= 1:
                                _covers_in_order(count, S)


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
def test_split_range_covers_in_order(S):
    """K3's and K4's split of a count into S contiguous ranges, at every
    count up to 40 and at 7B's slot and kept-group counts: each item
    once, in order, the ranges' sizes within one of each other."""
    for count in list(range(1, 41)) + [86, 2560, 6880, 11008]:
        _covers_in_order(count, S)
        sizes = [hi - lo for lo, hi in
                 (tgg.split_range(count, S, s) for s in range(S))]
        assert max(sizes) - min(sizes) <= 1


def test_k3_plan_refuses_nothing_to_do():
    assert tbg._bgg_plan(2, tbg.PLAN_STREAM, 32, (), 4, 1) is None
    assert tbg._bgg_plan(2, tbg.PLAN_STREAM, 32, (64,), 0, 8) is None
