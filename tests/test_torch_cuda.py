"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. This file
imports no JAX, so on a machine with a card and no JAX run it without the
JAX test setup of tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import pytest
import torch

from teal_tpu_torch import _build
from teal_tpu_torch.models import llama
from teal_tpu_torch.ops import block_gemv as bg
from teal_tpu_torch.ops import gather_gemv as gg
from teal_tpu_torch.ops import decode_attention as da
from teal_tpu_torch.ops import token_block as tb
from teal_tpu_torch.ops.decode_attention import (decode_attention,
                                                 decode_attention_plain)
from teal_tpu_torch.ops.flash_prefill import (flash_prefill_attention,
                                              flash_prefill_attention_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _close(got, want, rel):
    err = float((got.float() - want.float()).abs().max())
    return err <= rel * float(want.float().abs().max()) + 1e-6, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", ["qkv", "res", "silu"])
def test_k1_kernel_matches_plain(cuda, dtype, epilogue):
    g = torch.Generator(device=cuda).manual_seed(0)
    L, K, layer, cap = 3, 1024, 2, 4
    ns = {"qkv": (512, 256, 256), "res": (1024,), "silu": (512, 512)}
    ws = [(torch.randn(L, K, n, generator=g, device=cuda) * 0.05).to(dtype)
          for n in ns[epilogue]]
    x = torch.randn(K, generator=g, device=cuda).to(dtype)
    norm = (1 + 0.1 * torch.randn(L, K, generator=g, device=cuda)).to(dtype)
    kw = dict(norm=None if epilogue == "res" else norm,
              res=(torch.randn(K, generator=g, device=cuda).to(dtype)
                   if epilogue == "res" else None),
              silu=epilogue == "silu")
    for thr in (0.0, 2.5, 3.0, 100.0):
        t = torch.tensor(thr, device=cuda)
        got, gidx, gcnt = bg.select_gather_gemv(x, t, ws, layer, cap, **kw)
        want, widx, wcnt = bg.select_gather_gemv_plain(x, t, ws, layer, cap,
                                                       **kw)
        assert torch.equal(gcnt, wcnt) and torch.equal(gidx, widx), thr
        ok, err = _close(got, want, 1e-5 if dtype == torch.float32
                         else 2 ** -7)
        assert ok, (thr, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,window", [(4, 4, None), (8, 2, 16)])
def test_k2_kernel_matches_plain(cuda, dtype, Hq, Hkv, window):
    g = torch.Generator(device=cuda).manual_seed(1)
    L, B, T = 2, 2, 64
    kc = torch.randn(L, B, Hkv, T, 128, generator=g, device=cuda).to(dtype)
    vc = torch.randn(L, B, Hkv, T, 128, generator=g, device=cuda).to(dtype)
    q = torch.randn(B, Hq, 128, generator=g, device=cuda)
    kn = torch.randn(B, Hkv, 128, generator=g, device=cuda)
    vn = torch.randn(B, Hkv, 128, generator=g, device=cuda)
    rope = torch.rand(B, 2, 128, generator=g, device=cuda)
    pos = torch.tensor([0, T - 1], dtype=torch.int32, device=cuda)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got = decode_attention(q, kn, vn, k1, v1, 1, pos, window=window,
                           rope=rope)
    want = decode_attention_plain(q, kn, vn, k2, v2, 1, pos, window=window,
                                  rope=rope)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    ok, err = _close(got, want, 1e-5 if dtype == torch.float32 else 1e-2)
    assert ok, err


def test_kernels_count_launches(cuda):
    before = bg.select_gather_gemv.launches
    x = torch.ones(256, device=cuda)
    w = torch.ones(1, 256, 32, device=cuda)
    bg.select_gather_gemv(x, torch.tensor(0.5, device=cuda), [w], 0, 1)
    bg.select_gather_gemv_plain(x, torch.tensor(0.5, device=cuda), [w], 0, 1)
    assert bg.select_gather_gemv.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,norm", [(32, True), (64, False), (32, False)])
def test_k1_at_group_size_matches_plain(cuda, dtype, G, norm):
    g = torch.Generator(device=cuda).manual_seed(2)
    L, K, layer, cap = 2, 1024, 1, 12
    ws = [(torch.randn(L, K, n, generator=g, device=cuda) * 0.05).to(dtype)
          for n in (256, 128, 128)]
    x = torch.randn(K, generator=g, device=cuda).to(dtype)
    gain = (1 + 0.1 * torch.randn(L, K, generator=g, device=cuda)).to(dtype)
    for thr in (0.0, 1.8, 2.4, 100.0):
        t = torch.tensor(thr, device=cuda)
        kw = dict(G=G, norm=gain if norm else None)
        got, gidx, gcnt = bg.select_gather_gemv(x, t, ws, layer, cap, **kw)
        want, widx, wcnt = bg.select_gather_gemv_plain(x, t, ws, layer, cap,
                                                       **kw)
        assert torch.equal(gcnt, wcnt) and torch.equal(gidx, widx), thr
        ok, err = _close(got, want, 1e-5 if dtype == torch.float32 else 1e-4)
        assert ok, (thr, err)


def _k3_case(cuda, g, dtype, ws, G, rows, k_keep, layer, rel):
    """K3 against its plain version at one shape: outputs within `rel` of
    scale, two identical calls bit-identical, one launch a call."""
    K = bg._in_dim(ws[0])
    x = torch.randn(rows, K, generator=g, device=cuda).to(dtype)
    idx, xpack = (bg.select_groups(x, G, k_keep) if rows == 1
                  else bg.select_groups_batched(x, G, k_keep))
    before = bg.block_gather_gemv_multi.launches
    got = bg.block_gather_gemv_multi(idx, xpack, ws, layer, G, rows)
    again = bg.block_gather_gemv_multi(idx, xpack, ws, layer, G, rows)
    assert bg.block_gather_gemv_multi.launches == before + 2
    want = bg.block_gather_gemv_multi_plain(idx, xpack, ws, layer, G, rows)
    assert torch.equal(got, again), (G, rows, k_keep, "two calls differ")
    ok, err = _close(got, want, rel)
    assert ok, (G, rows, k_keep, len(ws), err)


# K3's kept counts: 1, below the cluster of the small shapes' plan (7
# tiles: S = 8), and 9
K3_KEEPS = (1, 3, 9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,rows", [(32, 1), (64, 1), (32, 8), (128, 5),
                                    (128, 1), (64, 4), (32, 4), (64, 8),
                                    (128, 8)])
def test_k3_kernel_matches_plain(cuda, dtype, G, rows):
    """K3 (weights of the stream type) at every G and rows 1-8 (1 and 4-5
    of an 8-row xpack), with 1-3 weights of widths 256 / 96 / 32 (masked
    half tiles), k_keep 1, below the split count and above it; two calls
    bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(3)
    L, K, layer = 3, 1024, 2
    ws = [(torch.randn(L, K, n, generator=g, device=cuda) * 0.05).to(dtype)
          for n in (256, 96, 32)]
    for n_w in (3, 1, 2):
        for k_keep in K3_KEEPS:
            _k3_case(cuda, g, dtype, ws[3 - n_w:] if n_w < 3 else ws, G,
                     rows, min(k_keep, K // G), layer,
                     1e-5 if dtype == torch.float32 else 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quantile", [0.5, 0.2])
def test_k4_kernel_matches_plain(cuda, dtype, quantile):
    g = torch.Generator(device=cuda).manual_seed(4)
    K, N = 1536, 416
    w = (torch.randn(K, N, generator=g, device=cuda) * 0.05).to(dtype)
    x = torch.randn(K, generator=g, device=cuda).to(dtype)
    thr = torch.quantile(x.float().abs(), quantile)
    idx, vals = gg.compact_indices(x, thr, int(K * 0.625))
    got = gg.row_gather_gemv(idx, vals, w)
    want = gg.row_gather_gemv_plain(idx, vals, w)
    ok, err = _close(got, want, 1e-5 if dtype == torch.float32 else 2 ** -7)
    assert ok, err


# K4's edge cases: (K, N, nnz, what the slots hold)
K4_EDGES = {
    "nnz=1": (1536, 416, 1, "compact"),
    "nnz below the splits": (1536, 416, 3, "compact"),
    "every xc zero": (1536, 416, 960, "zero"),
    "idx outside [0, K)": (1536, 416, 960, "bad idx"),
    "N=32": (512, 32, 320, "compact"),
    "N not a tile multiple": (768, 1056, 480, "compact"),
    "K=11008 uneven ranges": (11008, 256, 6883, "compact"),
    "more slots than a chunk": (32768, 64, 20480, "compact"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(K4_EDGES))
def test_k4_edge_cases_match_plain(cuda, dtype, case):
    """K4 against its plain version where the split or the masking could
    go wrong: one slot, fewer slots than the cluster's splits, no
    survivor, indices outside [0, K) (clamped: the plain version reads the
    clamped rows), a single 32-column tile, a last tile past N, slot
    ranges that do not divide evenly, a range longer than one compaction
    chunk; two calls bit-identical."""
    K, N, nnz, kind = K4_EDGES[case]
    g = torch.Generator(device=cuda).manual_seed(40 + len(case))
    w = (torch.randn(K, N, generator=g, device=cuda) * 0.05).to(dtype)
    x = torch.randn(K, generator=g, device=cuda).to(dtype)
    thr = torch.quantile(x.float().abs(), 0.5)
    idx, vals = gg.compact_indices(x, thr, nnz)
    if kind == "zero":
        vals = torch.zeros_like(vals)
    elif kind == "bad idx":
        bad = torch.randint(-3 * K, 3 * K, idx.shape, generator=g,
                            device=cuda, dtype=torch.int32)
        idx = torch.where(torch.arange(nnz, device=cuda) % 3 == 0, bad, idx)
    before = gg.row_gather_gemv.launches
    got = gg.row_gather_gemv(idx, vals, w)
    again = gg.row_gather_gemv(idx, vals, w)
    assert gg.row_gather_gemv.launches == before + 2
    assert torch.equal(got, again), "two calls differ"
    want = gg.row_gather_gemv_plain(idx.clamp(0, K - 1), vals, w)
    if kind == "zero":
        assert not bool(got.any())
    ok, err = _close(got, want, 1e-5 if dtype == torch.float32 else 2 ** -7)
    assert ok, err


def test_k4_plan_matches_kernel(cuda):
    """The wrapper's `_plan` (tile columns, splits, ring stages, chunk,
    shared bytes) equals the kernel's over widths, both types, and SM
    counts."""
    lib = _build.load()["row_gather_gemv"]
    out = torch.zeros(5, dtype=torch.int32)
    for N in (32, 96, 416, 1056, 4096, 11008, 14336):
        for code, esz in ((0, 4), (1, 2)):
            for sms in (78, 114, 132):
                assert lib.teal_row_gather_plan(code, N, sms,
                                                out.data_ptr()) == 0
                assert tuple(int(v) for v in out) == gg._plan(esz, N, sms), \
                    (N, esz, sms)


def test_k3_plan_matches_kernel(cuda):
    """The wrapper's `_bgg_plan` (form, splits, ring stages, shared bytes)
    equals the kernel's over the 7B stage shapes and small ones, both
    stream types, the three weight plans, every G, both forms and two SM
    counts."""
    lib = _build.load()["block_gather_gemv"]
    out = torch.zeros(4, dtype=torch.int32)
    shapes = [(4096, 4096, 4096), (4096,), (11008, 11008), (256, 96, 32),
              (32,), (96, 64), (14336,)]
    for ns in shapes:
        padded = list(ns) + [0] * (3 - len(ns))
        for G in bg.GROUP_SIZES:
            for k_keep in (1, 3, 64, 86, 344):
                for code, esz in ((0, 4), (1, 2)):
                    for plan in (0, 1, 2):
                        for R in (1, 8):
                            for sms in (114, 132):
                                want = bg._bgg_plan(esz, plan, G, ns,
                                                    k_keep, R, sms)
                                lib.teal_block_gather_plan(
                                    code, plan, G, *padded, len(ns), k_keep,
                                    R, sms, out.data_ptr())
                                got = tuple(int(v) for v in out)
                                assert (got[3] == -1 if want is None
                                        else got == want), (
                                    ns, G, k_keep, esz, plan, R, sms)


def test_split_range_matches_kernels(cuda):
    """`gather_gemv.split_range` equals the split both libraries cut by
    (`split_lo` through `teal_row_gather_split` and
    `teal_block_gather_split`) at every S the plans give, counts from 1
    to past an int32 product."""
    libs = _build.load()
    out = torch.zeros(2, dtype=torch.int32)
    for lib, fn in ((libs["row_gather_gemv"], "teal_row_gather_split"),
                    (libs["block_gather_gemv"], "teal_block_gather_split")):
        for S in (1, 2, 4, 8):
            for count in (1, 2, 3, 7, 13, 86, 6880, 11008, 300_000_000):
                for s in range(S):
                    assert getattr(lib, fn)(count, S, s, out.data_ptr()) == 0
                    assert tuple(int(v) for v in out) == \
                        gg.split_range(count, S, s), (fn, count, S, s)


def _widths_for_splits(esz, plan, R, splits, sms):
    """Widths 96 and 32 (masked half tiles) behind a first width that
    brings the tile count to where K3's plan takes `splits` on this card
    (the largest power of two <= 8 with tiles * S <= SMs)."""
    tw = bg._bgg_stream_tile(esz, plan) if R == 1 else bg.BGG_TILE
    tiles = sms // splits if splits > 1 else sms
    rest = -(-96 // tw) + -(-32 // tw)
    return ((tiles - rest) * tw, 96, 32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plan", ["stream", "int8", "int4"])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_k3_splits_match_plain(cuda, dtype, plan, splits):
    """K3 at each split count S (each tile's kept groups over S blocks of
    a cluster, added in split order), reached through the weights' widths
    at this card's SM count, in both forms (rows 1 and 4 of 8): k_keep 1,
    3 (below S) and 13 (uneven shares); 1e-4 of scale (bf16 stream) or
    1e-5; two calls bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(500 + splits)
    L, K, layer, G = 2, 2048, 1, 64
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    esz = torch.finfo(dtype).bits // 8
    code = {"stream": bg.PLAN_STREAM, "int8": bg.PLAN_INT8,
            "int4": bg.PLAN_INT4}[plan]
    rel = 1e-4 if plan == "stream" and dtype == torch.bfloat16 else 1e-5
    for rows, R in ((1, 1), (4, 8)):
        ns = _widths_for_splits(esz, code, R, splits, sms)
        assert bg._bgg_plan(esz, code, G, ns, 13, R, sms)[1] == splits, ns
        ws = (_plan_weights(g, cuda, plan, L, K, ns, G)
              if plan != "stream" else
              [(torch.randn(L, K, n, generator=g, device=cuda) * 0.05)
               .to(dtype) for n in ns])
        for k_keep in (1, 3, 13):
            _k3_case(cuda, g, dtype, ws, G, rows, k_keep, layer, rel)


def test_layer_loop_kernels_count_launches(cuda):
    w = torch.ones(1, 256, 32, device=cuda)
    idx, xpack = bg.select_groups(torch.ones(1, 256, device=cuda), 32, 2)
    b3, b4 = bg.block_gather_gemv_multi.launches, gg.row_gather_gemv.launches
    bg.block_gather_gemv_multi(idx, xpack, [w], 0, 32, 1)
    bg.block_gather_gemv_multi_plain(idx, xpack, [w], 0, 32, 1)
    i4 = torch.zeros(3, dtype=torch.int32, device=cuda)
    v4 = torch.ones(3, device=cuda)
    gg.row_gather_gemv(i4, v4, w[0])
    gg.row_gather_gemv_plain(i4, v4, w[0])
    assert bg.block_gather_gemv_multi.launches == b3 + 1
    assert gg.row_gather_gemv.launches == b4 + 1


def test_lm_head_keeps_fp32_sums_on_the_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    h = torch.randn(1, 1, 512, generator=g, device=cuda).bfloat16()
    w = (torch.randn(512, 320, generator=g, device=cuda) * 0.05).bfloat16()
    got = llama._lm_head({"lm_head": w}, h)
    want = torch.matmul(h.double(), w.double()).float()
    assert got.dtype == torch.float32
    ok, err = _close(got, want, 1e-5)
    assert ok, err


def _plan_weights(g, cuda, plan, L, K, ns, G):
    """Random int8 [L, K, N] weights, or packed int4 {"qp", "sz"} at G."""
    if plan == "int8":
        return [torch.randint(-128, 128, (L, K, n), generator=g, device=cuda,
                              dtype=torch.int8) for n in ns]
    out = []
    for n in ns:
        sz = torch.rand(L, K // G, 2, n, generator=g, device=cuda) * 0.01
        sz[:, :, 1] -= 0.05                       # zero points below 0
        out.append({"qp": torch.randint(-128, 128, (L, K // 2, n),
                                        generator=g, device=cuda,
                                        dtype=torch.int8), "sz": sz})
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plan,G", [("int8", 32), ("int8", 128),
                                    ("int4", 64), ("int4", 128)])
@pytest.mark.parametrize("epilogue", ["qkv", "res", "silu"])
def test_k1_plans_match_plain(cuda, dtype, plan, G, epilogue):
    g = torch.Generator(device=cuda).manual_seed(6)
    L, K, layer, cap = 2, 1024, 1, 4 if G == 128 else 12
    ns = {"qkv": (512, 256, 256), "res": (1024,), "silu": (512, 512)}
    ws = _plan_weights(g, cuda, plan, L, K, ns[epilogue], G)
    scales = ([torch.rand(L, n, generator=g, device=cuda) * 1e-3
               for n in ns[epilogue]] if plan == "int8" else None)
    x = torch.randn(K, generator=g, device=cuda).to(dtype)
    norm = (1 + 0.1 * torch.randn(L, K, generator=g, device=cuda)).to(dtype)
    kw = dict(G=G, norm=None if epilogue == "res" else norm,
              res=(torch.randn(K, generator=g, device=cuda).to(dtype)
                   if epilogue == "res" else None),
              silu=epilogue == "silu", scales=scales)
    for thr in (0.0, 1.8, 2.6, 100.0):
        t = torch.tensor(thr, device=cuda)
        got, gidx, gcnt = bg.select_gather_gemv(x, t, ws, layer, cap, **kw)
        want, widx, wcnt = bg.select_gather_gemv_plain(x, t, ws, layer, cap,
                                                       **kw)
        assert torch.equal(gcnt, wcnt) and torch.equal(gidx, widx), thr
        ok, err = _close(got, want, 1e-5 if got.dtype == torch.float32
                         else 2 ** -7)
        assert ok, (thr, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plan,G", [("int8", 32), ("int8", 64),
                                    ("int4", 64), ("int4", 128),
                                    ("int8", 128)])
@pytest.mark.parametrize("rows", [1, 4, 8])
def test_k3_plans_match_plain(cuda, dtype, plan, G, rows):
    """K3 with int8 and packed-int4 weights at every G they take, rows 1,
    4 and 8, 1-3 weights of widths 256 / 96 / 32, k_keep 1, below the
    split count and 7; two calls bit-identical; 1e-5 of scale."""
    g = torch.Generator(device=cuda).manual_seed(7)
    L, K, layer = 3, 1024, 2
    ws = _plan_weights(g, cuda, plan, L, K, (256, 96, 32), G)
    for n_w in (3, 1, 2):
        for k_keep in (1, 3, 7):
            _k3_case(cuda, g, dtype, ws[3 - n_w:] if n_w < 3 else ws, G,
                     rows, min(k_keep, K // G), layer, 1e-5)


def test_plan_kernels_raise_rather_than_fall_back(cuda):
    """int4 below G = 64 and mixed plans raise on the card."""
    x = torch.ones(256, device=cuda)
    w8 = torch.ones(1, 256, 32, dtype=torch.int8, device=cuda)
    i4 = {"qp": torch.zeros(1, 128, 32, dtype=torch.int8, device=cuda),
          "sz": torch.zeros(1, 8, 2, 32, device=cuda)}
    t = torch.tensor(0.5, device=cuda)
    for ws, G in (([i4], 32), ([w8, torch.ones(1, 256, 32, device=cuda)],
                               32)):
        with pytest.raises(ValueError):
            bg.select_gather_gemv(x, t, ws, 0, 1, G=G)
    before = bg.select_gather_gemv.launches
    bg.select_gather_gemv(x, t, [w8], 0, 1, G=32)
    assert bg.select_gather_gemv.launches == before + 1


def _rows_weights(g, cuda, plan, dtype, L, K, ns):
    """Weights of a plan for K1's rows form (G = 128), and int8 scales."""
    if plan == "stream":
        return [(torch.randn(L, K, n, generator=g, device=cuda) * 0.05)
                .to(dtype) for n in ns], None
    ws = _plan_weights(g, cuda, plan, L, K, ns, 128)
    scales = ([torch.rand(L, n, generator=g, device=cuda) * 1e-3
               for n in ns] if plan == "int8" else None)
    return ws, scales


# K1's rows form: the selection regimes every case runs (survivors at cap
# 4 of 8 groups; "fixed" keeps 0..cap-1; "none" keeps no group).
K1_ROWS_REGIMES = (("count<cap", 2), ("count==cap", 4), ("overflow", 6),
                   ("fixed", 4), ("none", 0))


def _rows_x(g, cuda, dtype, B, K, norm, layer, n_surv):
    """B rows of uniform noise in [-0.5, 0.5] where group i has its spike
    (3 * 1.3**rank, rank a permutation) in row i % B, so each pooled score
    comes from one row; and a threshold with exactly `n_surv` pooled
    scores of the selection input above it, more than 1e-2 (relative)
    from every score."""
    nb = K // 128
    gi = torch.arange(nb, device=cuda)
    for _ in range(16):
        x = torch.rand(B, nb, 128, generator=g, device=cuda) - 0.5
        lv = 3 * 1.3 ** torch.randperm(nb, generator=g, device=cuda).float()
        col = torch.randint(0, 128, (nb,), generator=g, device=cuda)
        x[gi % B, gi, col] = lv
        x = x.reshape(B, K).to(dtype)
        xs = bg.selection_input(x, norm, layer, 1e-5).float()
        pooled = xs.abs().reshape(B, nb, 128).amax(-1).amax(0)
        v = pooled.sort(descending=True).values
        if n_surv == 0:
            return x, torch.tensor(float(v[0]) * 2.0, device=cuda)
        thr = (float(v[n_surv - 1]) * float(v[n_surv])) ** 0.5 \
            if n_surv < nb else float(v[-1]) * 0.5
        if float(((pooled - thr).abs() / thr).min()) > 1e-2:
            return x, torch.tensor(thr, device=cuda)
    raise AssertionError("no threshold 1e-2 away from every pooled score")


def _rows_case(cuda, g, dtype, plan, epilogue, B, ns=None, K=1024, cap=4):
    """Every regime of `K1_ROWS_REGIMES` for one shape: the kernel's kept
    set and count equal to the plain version's, outputs within 1e-5 of
    scale (fp32 stream), 1e-4 (bf16 stream, fp32 q|k|v sums) or 2^-7
    (bf16 outputs), two identical calls bit-identical, one launch a call."""
    L, layer = 2, 1
    ns = ns or {"qkv": (512, 256, 256), "res": (1024,),
                "silu": (512, 512)}[epilogue]
    ws, scales = _rows_weights(g, cuda, plan, dtype, L, K, ns)
    norm = (1 + 0.1 * torch.randn(L, K, generator=g, device=cuda)).to(dtype)
    norm = None if epilogue == "res" else norm
    res = (torch.randn(B, sum(ns), generator=g, device=cuda).to(dtype)
           if epilogue == "res" else None)
    kw = dict(norm=norm, res=res, silu=epilogue == "silu", scales=scales)
    for case, n_surv in K1_ROWS_REGIMES:
        fixed = case == "fixed"
        x, t = _rows_x(g, cuda, dtype, B, K, norm, layer, n_surv)
        before = bg.select_gather_gemv.launches
        got, gidx, gcnt = bg.select_gather_gemv(x, t, ws, layer, cap,
                                                fixed=fixed, **kw)
        again, aidx, acnt = bg.select_gather_gemv(x, t, ws, layer, cap,
                                                  fixed=fixed, **kw)
        assert bg.select_gather_gemv.launches == before + 2
        want, widx, wcnt = bg.select_gather_gemv_plain(x, t, ws, layer, cap,
                                                       fixed=fixed, **kw)
        assert int(wcnt[0]) == min(n_surv, cap), case
        assert torch.equal(gcnt, wcnt) and torch.equal(gidx, widx), case
        assert torch.equal(got, again) and torch.equal(gidx, aidx) \
            and torch.equal(gcnt, acnt), f"{case}: two calls differ"
        assert got.shape == want.shape == (B, want.shape[-1])
        rel = (1e-5 if dtype == torch.float32 else
               1e-4 if got.dtype == torch.float32 else 2 ** -7)
        ok, err = _close(got, want, rel)
        assert ok, (case, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plan", ["stream", "int8", "int4"])
@pytest.mark.parametrize("epilogue", ["qkv", "res", "silu"])
@pytest.mark.parametrize("B", list(range(2, 17)))
def test_k1_rows_match_plain(cuda, dtype, plan, epilogue, B):
    """K1's rows form: the same kept set as the plain version (pooled
    scores, per-row norm; `fixed` keeps 0..cap-1) and the same outputs
    for every row, at every B (each pads the MMA's 16 rows differently),
    in every selection regime, deterministically."""
    g = torch.Generator(device=cuda).manual_seed(8 + B)
    _rows_case(cuda, g, dtype, plan, epilogue, B)


def _rows_widths_for_splits(epilogue, splits, sms):
    """Widths whose 64-column tile count brings the rows form's plan to
    `splits` on a card of `sms` SMs (S = 4 up to sms // 4 tiles, 2 up to
    sms // 2, 1 beyond): at 132 SMs res 3 / 34 / 67 tiles (clusters of 4,
    4, 1 blocks), qkv 16 / 66 / 72 (8, 4, 8) and silu 33 / 36 / 67 (4, 8,
    1)."""
    lo, hi = {4: (1, sms // 4), 2: (sms // 4 + 1, sms // 2),
              1: (sms // 2 + 1, 2 * sms)}[splits]
    tiles = {"res": {4: min(3, hi), 2: lo, 1: lo},
             "qkv": {4: min(16, hi), 2: hi, 1: (lo // 8 + 1) * 8},
             "silu": {4: hi, 2: min(hi, (lo // 4 + 1) * 4), 1: lo}
             }[epilogue][splits]
    if epilogue == "res":
        return (64 * tiles,)
    if epilogue == "silu":
        return (64 * tiles, 64 * tiles)
    a = max(1, tiles // 4)
    return (64 * (tiles - 2 * a), 64 * a, 64 * a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plan", ["stream", "int8", "int4"])
@pytest.mark.parametrize("splits", [1, 2, 4])
def test_k1_rows_splits_match_plain(cuda, dtype, plan, splits):
    """K1's rows form at each split count S (each tile's kept groups over
    S blocks of a cluster, their sums added in split order), reached
    through the widths at this card's SM count (`_rows_widths_for_splits`:
    clusters of S, 8 or 2 blocks); K = 11008 (86 groups: more than a warp
    each in a block of the prologue), 2816 (an odd group count) and 1024;
    B = 2, 9 and 16."""
    g = torch.Generator(device=cuda).manual_seed(300 + splits)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    esz = torch.finfo(dtype).bits // 8
    code = {"stream": bg.PLAN_STREAM, "int8": bg.PLAN_INT8,
            "int4": bg.PLAN_INT4}[plan]
    for epilogue, K, cap in (("res", 11008, 4), ("qkv", 2816, 4),
                             ("silu", 1024, 4)):
        ns = _rows_widths_for_splits(epilogue, splits, sms)
        nw = 2 if epilogue == "silu" else 1
        assert bg._rows_plan(esz, code, nw, K, ns[0] if nw == 2 else sum(ns),
                             cap, sms)[0] == splits, (epilogue, ns)
        for B in (2, 9, 16):
            _rows_case(cuda, g, dtype, plan, epilogue, B, ns=ns, K=K,
                       cap=cap)


def test_k1_rows_plan_matches_kernel(cuda):
    """The wrapper's `_rows_plan` (splits, cluster, ring stages, shared
    bytes) equals the kernel's `rows_plan` over the 7B stage shapes and
    small ones, both stream types, the three weight plans and two SM
    counts."""
    lib = _build.load()["select_gather_gemv"]
    out = (torch.zeros(4, dtype=torch.int32))
    shapes = [(4096, 12288, 1), (4096, 4096, 1), (4096, 11008, 2),
              (11008, 4096, 1), (1024, 1024, 1), (1024, 192, 1),
              (2816, 1024, 1), (1024, 1088, 2), (256, 64, 1), (256, 96, 1)]
    for K, n_out, nw in shapes:
        nb = K // 128
        for cap in sorted({1, nb // 2 or 1, nb}):
            for code, esz in ((0, 4), (1, 2)):
                for plan in (0, 1, 2):
                    for sms in (114, 132):
                        want = bg._rows_plan(esz, plan, nw, K, n_out, cap,
                                             sms)
                        lib.teal_sgg_rows_plan(code, plan, int(nw == 2), K,
                                               n_out, cap, sms,
                                               out.data_ptr())
                        got = tuple(int(v) for v in out)
                        assert (got[3] == -1 if want is None
                                else got == want), (K, n_out, nw, cap, esz,
                                                    plan, sms)


def test_k1_rows_grid_resident_at_7b(cuda):
    """At the 7B stage shapes (bf16 stream, every weight plan, caps at
    keep 0.5) every cluster of the rows kernel's grid can be resident at
    once on this card, as the plan intends."""
    lib = _build.load()["select_gather_gemv"]
    out = torch.zeros(3, dtype=torch.int32)
    for K, n_out, nw, cap in ((4096, 12288, 1, 16), (4096, 4096, 1, 16),
                              (4096, 11008, 2, 16), (11008, 4096, 1, 43)):
        for plan in (0, 1, 2):
            assert lib.teal_sgg_rows_residency(1, plan, int(nw == 2), K,
                                               n_out, cap,
                                               out.data_ptr()) == 0
            grid, C, clusters = (int(v) for v in out)
            assert grid % C == 0 and clusters * C >= grid, \
                (K, n_out, plan, grid, C, clusters)


# K1's single row: (K, widths, weights of one tile) at the 7B stages,
# Mixtral's expert stages, and small shapes with masked last tiles
K1_PLAN_SHAPES = [(4096, (4096, 4096, 4096), 1), (4096, (4096,), 1),
                  (4096, (11008, 11008), 2), (11008, (4096,), 1),
                  (4096, (14336, 14336), 2), (14336, (4096,), 1),
                  (1024, (512, 256, 256), 1), (1024, (1024,), 1),
                  (1024, (512, 512), 2), (512, (768, 768), 2),
                  (768, (512,), 1), (256, (32,), 1), (256, (96, 64), 1),
                  (2048, (4064, 96, 32), 1)]


def test_k1_plan_matches_kernel(cuda):
    """The wrapper's `_sgg_plan` (splits, cluster, ring stages, shared
    bytes) equals the kernel's `sgg_plan` over the 7B stage shapes,
    Mixtral's expert shapes and small ones, every G, caps 1 to nb, both
    stream types, the three weight plans and two SM counts."""
    lib = _build.load()["select_gather_gemv"]
    out = torch.zeros(4, dtype=torch.int32)
    for K, ns, nw in K1_PLAN_SHAPES:
        padded = list(ns) + [0] * (3 - len(ns))
        for G in bg.GROUP_SIZES:
            nb = K // G
            for cap in sorted({1, nb // 2 or 1, nb}):
                for code, esz in ((0, 4), (1, 2)):
                    for plan in (0, 1, 2):
                        for sms in (114, 132):
                            want = bg._sgg_plan(esz, plan, nw, G, ns, K, cap,
                                                sms)
                            lib.teal_sgg_plan(code, plan, int(nw == 2), G,
                                              *padded, len(ns), K, cap, sms,
                                              out.data_ptr())
                            got = tuple(int(v) for v in out)
                            assert (got[3] == -1 if want is None
                                    else got == want), (K, ns, G, cap, esz,
                                                        plan, sms)


def _k1_threshold(x, norm, layer, G, n_surv):
    """A group threshold with about `n_surv` survivors (the first count
    from n_surv on whose cut lies more than 2% from both neighbouring
    scores of the plain version's selection input), so the kept set
    does not turn on rounding."""
    xs = bg.selection_input(x, norm, layer, 1e-5).float()
    v = xs.abs().reshape(-1, G).amax(-1).sort(descending=True).values
    for i in range(n_surv, v.numel()):
        if float(v[i - 1]) > 1.02 * float(v[i]):
            return torch.tensor(float((v[i - 1] * v[i]).sqrt()),
                                device=x.device)
    return torch.tensor(float(v[-1]) * 0.5, device=x.device)


def _k1_widths_for_splits(esz, plan, mode, splits, sms):
    """Widths of one K1 call in `mode` whose 256-byte tiles (the last one
    masked: 32 columns short) bring the single row's plan to `splits` on
    this card (the largest power of two <= 8 with tiles * S <= SMs): mode
    0 three weights (a masked first tile and two 96 / 32-column ones),
    modes 1 and 3 one weight, mode 2 a pair."""
    tw = bg._sgg_tile(esz, plan)
    tiles = sms // splits if splits > 1 else sms
    if mode == 0:
        rest = -(-96 // tw) + -(-32 // tw)
        return ((tiles - rest) * tw - 32, 96, 32)
    n = tiles * tw - 32
    return (n, n) if mode == 2 else (n,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plan", ["stream", "int8", "int4"])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_k1_splits_match_plain(cuda, dtype, plan, splits):
    """K1's single row at each split count S (each tile's kept groups
    over S blocks of a cluster, added in rank order), reached through the
    widths at this card's SM count, in every mode: q|k|v (three weights,
    also `fixed`), the residual, silu(gate) * up, and the MoE weighted
    residual on a device layer; cap 1, below S and 13 (uneven shares) at
    threshold 0 (the first cap groups) and one with about 9 survivors,
    2% from every score (`_k1_threshold`); the same kept sets as
    the plain version, outputs within 1e-5 of scale (fp32 stream), 1e-4
    (bf16 stream, fp32 sums) or 2^-7 (bf16 outputs), two calls
    bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(700 + splits)
    L, K, G, layer = 2, 2048, 64, 1
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    esz = torch.finfo(dtype).bits // 8
    code = {"stream": bg.PLAN_STREAM, "int8": bg.PLAN_INT8,
            "int4": bg.PLAN_INT4}[plan]
    x = torch.randn(K, generator=g, device=cuda).to(dtype)
    norm = (1 + 0.1 * torch.randn(L, K, generator=g, device=cuda)).to(dtype)
    for mode in (0, 1, 2, 3):
        ns = _k1_widths_for_splits(esz, code, mode, splits, sms)
        nw = 2 if mode == 2 else 1
        assert bg._sgg_plan(esz, code, nw, G, ns, K, 13, sms)[0] == splits, \
            (mode, ns)
        if plan == "stream":
            ws = [(torch.randn(L, K, n, generator=g, device=cuda) * 0.05)
                  .to(dtype) for n in ns]
        else:
            ws = _plan_weights(g, cuda, plan, L, K, ns, G)
        scales = ([torch.rand(L, n, generator=g, device=cuda) * 1e-3
                   for n in ns] if plan == "int8" else None)
        n_out = ns[0] if mode == 2 else sum(ns)
        kw = dict(G=G, scales=scales, silu=mode == 2,
                  norm=norm if mode in (0, 2) else None,
                  res=(torch.randn(n_out, generator=g, device=cuda).to(dtype)
                       if mode in (1, 3) else None))
        lay = layer
        if mode == 3:
            lay = torch.tensor([0, layer], dtype=torch.int32, device=cuda)
            kw.update(slot=1, route_w=torch.tensor([0.25, 0.75],
                                                   device=cuda))
        mid = _k1_threshold(x, kw["norm"], layer, G, 9)
        for cap in sorted({1, max(1, splits // 2), 13}):
            for thr, fixed in ((0.0, False), (mid, False), (mid, mode == 0)):
                t = torch.as_tensor(thr, dtype=torch.float32, device=cuda)
                before = bg.select_gather_gemv.launches
                got, gidx, gcnt = bg.select_gather_gemv(x, t, ws, lay, cap,
                                                        fixed=fixed, **kw)
                again, aidx, acnt = bg.select_gather_gemv(x, t, ws, lay, cap,
                                                          fixed=fixed, **kw)
                assert bg.select_gather_gemv.launches == before + 2
                want, widx, wcnt = bg.select_gather_gemv_plain(
                    x, t, ws, lay, cap, fixed=fixed, **kw)
                case = (mode, cap, float(thr), fixed)
                assert torch.equal(gcnt, wcnt) and torch.equal(gidx, widx), \
                    case
                assert torch.equal(got, again) and torch.equal(gidx, aidx) \
                    and torch.equal(gcnt, acnt), f"{case}: two calls differ"
                rel = (1e-5 if dtype == torch.float32 else
                       1e-4 if got.dtype == torch.float32 else 2 ** -7)
                ok, err = _close(got, want, rel)
                assert ok, (case, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,window", [(4, 4, None), (8, 2, 16)])
@pytest.mark.parametrize("p0", [0, 5, 40])
def test_k2_seq_block_matches_plain(cuda, dtype, Hq, Hkv, window, p0):
    """K2's seq_block form (S = 8 consecutive positions of cache row 0,
    q/k/v as strided views of one [S, n_tot] row block): the whole cache
    after the call bit for bit, outputs as the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(9 + p0)
    L, T, S, layer = 2, 64, 8, 1
    kc = torch.randn(L, 1, Hkv, T, 128, generator=g, device=cuda).to(dtype)
    vc = torch.randn(L, 1, Hkv, T, 128, generator=g, device=cuda).to(dtype)
    qkv = torch.randn(S, (Hq + 2 * Hkv) * 128, generator=g, device=cuda)
    q = qkv[:, :Hq * 128].view(S, Hq, 128)
    kn = qkv[:, Hq * 128:(Hq + Hkv) * 128].view(S, Hkv, 128)
    vn = qkv[:, (Hq + Hkv) * 128:].view(S, Hkv, 128)
    rope = torch.rand(S, 2, 128, generator=g, device=cuda)
    pos = torch.arange(p0, p0 + S, dtype=torch.int32, device=cuda)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got = decode_attention(q, kn, vn, k1, v1, layer, pos, window=window,
                           rope=rope, seq_block=True)
    want = decode_attention_plain(q, kn, vn, k2, v2, layer, pos,
                                  window=window, rope=rope, seq_block=True)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    ok, err = _close(got, want, 1e-5 if dtype == torch.float32 else 1e-2)
    assert ok, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,k_exp", [(8, 2), (4, 1), (16, 4), (64, 8),
                                     (5, 2)])
@pytest.mark.parametrize("D", [1024, 1000, 1020])
def test_k5_route_matches_plain(cuda, dtype, E, k_exp, D):
    """K5 (`moe_route`): the same experts in the same order as the plain
    version, xn within one ulp of a bf16 stream (4 of an fp32 one: the two
    sum the squares of the norm in other orders, and xn rounds twice),
    weights within 1e-6; with two equal router columns at the top the
    lower expert comes first. D = 1020 is no multiple of the cluster's 8
    blocks; at E = 5 most blocks' router slabs start off 16 bytes."""
    g = torch.Generator(device=cuda).manual_seed(10 + E + D)
    L = 3
    router = torch.randn(L, D, E, generator=g, device=cuda) * 0.05
    norm = (1 + 0.1 * torch.randn(L, D, generator=g, device=cuda)).to(dtype)
    x = torch.randn(D, generator=g, device=cuda).to(dtype)
    for layer in range(L):
        for tie in (False, True):
            r = router.clone()
            if tie:       # experts E-1 and 1 equal and above the rest
                xn = tb.moe_route_plain(x, norm, r, layer, 1)[0].float()
                r[layer, :, 1] = r[layer, :, E - 1] = xn * 0.01
            got = tb.moe_route(x, norm, r, layer, k_exp)
            want = tb.moe_route_plain(x, norm, r, layer, k_exp)
            assert torch.equal(got[1], want[1]), (layer, tie)
            ulp = (torch.finfo(dtype).eps * want[0].float().abs()
                   * (4 if dtype == torch.float32 else 1))
            assert bool(((got[0].float() - want[0].float()).abs()
                         <= ulp).all()), (layer, tie)
            assert float((got[2] - want[2]).abs().max()) <= 1e-6
            if tie:
                assert int(got[1][0]) == layer * E + 1
                if k_exp > 1:
                    assert int(got[1][1]) == layer * E + E - 1
                    assert float((got[2][0] - got[2][1]).abs()) == 0.0


def test_k5_plan_matches_kernel(cuda):
    """The wrapper's `_route_plan` (cluster, rows a block, shared bytes)
    equals the kernel's `route_plan` (`teal_moe_route_plan`), None where
    the kernel has none."""
    lib = _build.load()["moe_route"]
    out = torch.zeros(3, dtype=torch.int32)
    for D in (1, 63, 64, 100, 255, 256, 1000, 1020, 1024, 4096, 6144, 8192,
              16384):
        for E in (1, 2, 4, 8, 16, 60, 64, 65):
            lib.teal_moe_route_plan(D, E, out.data_ptr())
            got, want = tuple(int(v) for v in out), tb._route_plan(D, E)
            assert (got[2] == -1 if want is None else got == want), (D, E)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plan", ["stream", "int8"])
def test_k1_moe_forms_match_plain(cuda, dtype, plan):
    """K1 reading its layer on the device (pseudo-layers of [L*E, K, N]
    stacks): gate|up (silu, no norm) and down with the weighted residual
    (mode 3), the same kept sets and outputs as the plain version; an out
    of range pseudo-layer is refused on the host for an int layer."""
    g = torch.Generator(device=cuda).manual_seed(11)
    LE, D, I, cap_gu, cap_dn = 6, 512, 768, 2, 3
    ws, scales = _rows_weights(g, cuda, plan, dtype, LE, D, (I, I))
    wd, sd = _rows_weights(g, cuda, plan, dtype, LE, I, (D,))
    eidx = torch.tensor([5, 2], dtype=torch.int32, device=cuda)
    route_w = torch.tensor([0.7, 0.3], device=cuda)
    x = torch.randn(D, generator=g, device=cuda).to(dtype)
    h = torch.randn(D, generator=g, device=cuda).to(dtype)
    for thr in (0.0, 2.0, 100.0):
        t = torch.tensor(thr, device=cuda)
        for slot in (0, 1):
            kw = dict(slot=slot, silu=True, scales=scales)
            got, gidx, gcnt = bg.select_gather_gemv(x, t, ws, eidx, cap_gu,
                                                    **kw)
            want, widx, wcnt = bg.select_gather_gemv_plain(x, t, ws, eidx,
                                                           cap_gu, **kw)
            assert torch.equal(gcnt, wcnt) and torch.equal(gidx, widx)
            ok, err = _close(got, want, 1e-5 if dtype == torch.float32
                             else 2 ** -7)
            assert ok, (thr, slot, err)
            kw = dict(slot=slot, res=h, route_w=route_w, scales=sd)
            inter = want.contiguous()
            got, gidx, _ = bg.select_gather_gemv(inter, t, wd, eidx, cap_dn,
                                                 **kw)
            want, widx, _ = bg.select_gather_gemv_plain(inter, t, wd, eidx,
                                                        cap_dn, **kw)
            assert torch.equal(gidx, widx)
            ok, err = _close(got, want, 1e-5 if dtype == torch.float32
                             else 2 ** -7)
            assert ok, (thr, slot, err)
    with pytest.raises(ValueError):
        bg.select_gather_gemv(x, torch.tensor(0.0, device=cuda), ws, LE,
                              cap_gu, silu=True, scales=scales)


def test_moe_route_counts_launches(cuda):
    before = tb.moe_route.launches
    x = torch.ones(256, device=cuda)
    norm = torch.ones(1, 256, device=cuda)
    r = torch.ones(1, 256, 4, device=cuda)
    tb.moe_route(x, norm, r, 0, 2)
    tb.moe_route_plain(x, norm, r, 0, 2)
    assert tb.moe_route.launches == before + 1


K6_CASES = [(1, 4, 4, 64), (2, 4, 2, 256), (1, 8, 1, 384), (1, 2, 2, 128),
            (2, 4, 2, 192), (1, 8, 2, 320), (1, 4, 4, 2048),
            (2, 8, 4, 2048)]


def _k6_inputs(cuda, dtype, B, Hq, Hkv, S):
    g = torch.Generator(device=cuda).manual_seed(S + Hq)
    return tuple(torch.randn(B, h, S, 128, generator=g,
                             device=cuda).to(dtype)
                 for h in (Hq, Hkv, Hkv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,S", K6_CASES)
def test_k6_matches_plain(cuda, dtype, B, Hq, Hkv, S):
    """K6 (causal flash prefill) against its plain version, each (head,
    query) row within a tolerance of that row's largest value: fp32 1e-5,
    bf16 2^-6 (two bf16 ulps: each side rounds its output to bf16, and
    the softmax weights are rounded to bf16 before PV at different
    points); one launch counted a call. S = 64, 192, 320: a last half
    tile of the bf16 kernel's 128-row query tiles; Hq/Hkv = 1, 2, 4, 8."""
    q, k, v = _k6_inputs(cuda, dtype, B, Hq, Hkv, S)
    before = flash_prefill_attention.launches
    got = flash_prefill_attention(q, k, v)
    assert flash_prefill_attention.launches == before + 1
    want = flash_prefill_attention_plain(q, k, v)
    assert got.dtype == dtype and got.shape == q.shape
    rel = 1e-5 if dtype == torch.float32 else 2 ** -6
    diff = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    assert bool((diff <= rel * scale).all()), \
        float((diff / scale.clamp_min(1e-30)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,S", [(1, 8, 2, 320), (2, 4, 4, 2048)])
def test_k6_two_calls_identical(cuda, dtype, B, Hq, Hkv, S):
    """Fixed-order sums, no atomics: two calls give identical bits."""
    q, k, v = _k6_inputs(cuda, dtype, B, Hq, Hkv, S)
    assert torch.equal(flash_prefill_attention(q, k, v),
                       flash_prefill_attention(q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_plan_matches_kernel(cuda, dtype):
    """The wrapper's launch plan (`_plan`) equals the kernel's own."""
    import ctypes

    from teal_tpu_torch.ops import flash_prefill as fp

    lib = _build.load()["flash_prefill"]
    for B, Hq in ((1, 32), (2, 4), (1, 2)):
        for S in (64, 128, 192, 320, 2048, 2560):
            out = (ctypes.c_int * 4)()
            assert lib.teal_flash_prefill_plan(fp._DTYPE_CODE[dtype], B, Hq,
                                               S, 132, out) == 0
            tiles, _, blocks, threads, smem = fp._plan(dtype, B, Hq, S, 132)
            assert tuple(out) == (tiles, blocks, threads, smem), (B, Hq, S)


def test_k6_raises_rather_than_falls_back(cuda):
    q = torch.randn(1, 2, 256, 64, device=cuda)
    with pytest.raises(ValueError):
        flash_prefill_attention(q, q, q)
    q = torch.randn(1, 2, 100, 128, device=cuda)
    with pytest.raises(ValueError):
        flash_prefill_attention(q, q, q)


# K2's split-context form: every case below forces the split count S by
# monkeypatching the split rule and holds three things: the whole cache
# equal bit for bit after the call, every (row, head) output within a
# tolerance of that row's largest value (fp32 1e-5; bf16 2^-6, two bf16
# ulps: both sides round the output and the rounded softmax weights, from
# scores summed in other orders), and two identical calls giving
# identical bits.
K2_ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}


def _k2_case(cuda, dtype, q, kn, vn, kc, vc, layer, pos, window, rope,
             seq_block=False):
    outs = []
    for _ in range(2):
        k1, v1 = kc.clone(), vc.clone()
        before = decode_attention.launches
        outs.append(decode_attention(q, kn, vn, k1, v1, layer, pos,
                                     window=window, rope=rope,
                                     seq_block=seq_block))
        assert decode_attention.launches == before + 1
    k2, v2 = kc.clone(), vc.clone()
    want = decode_attention_plain(q, kn, vn, k2, v2, layer, pos,
                                  window=window, rope=rope,
                                  seq_block=seq_block)
    assert torch.equal(k1, k2) and torch.equal(v1, v2), "caches differ"
    assert torch.equal(outs[0], outs[1]), "two identical calls differ"
    got = outs[0]
    assert got.dtype == dtype and bool(torch.isfinite(got.float()).all())
    diff = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    ok = diff <= K2_ROW_TOL[dtype] * scale
    assert bool(ok.all()), float((diff / scale.clamp_min(1e-30)).max())


def _k2_inputs(g, cuda, dtype, L, Bc, S, Hq, Hkv, T):
    kc = torch.randn(L, Bc, Hkv, T, 128, generator=g, device=cuda).to(dtype)
    vc = torch.randn(L, Bc, Hkv, T, 128, generator=g, device=cuda).to(dtype)
    qkv = torch.randn(S, (Hq + 2 * Hkv) * 128, generator=g, device=cuda)
    q = qkv[:, :Hq * 128].view(S, Hq, 128)
    kn = qkv[:, Hq * 128:(Hq + Hkv) * 128].view(S, Hkv, 128)
    vn = qkv[:, (Hq + Hkv) * 128:].view(S, Hkv, 128)
    rope = torch.rand(S, 2, 128, generator=g, device=cuda)
    return kc, vc, q, kn, vn, rope


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("GH,window", [(1, None), (1, 40), (4, None),
                                       (4, 200), (8, None), (8, 3)])
def test_k2_splits_match_plain(cuda, monkeypatch, dtype, splits, GH, window):
    """Two rows at T in {64, 512, 2048}, pos in {0, 1, 7, 256, T-1}: empty
    splits (pos < S), a window inside one split, GQA 1/4/8."""
    monkeypatch.setattr(da, "_splits", lambda *a, **k: splits)
    g = torch.Generator(device=cuda).manual_seed(splits * 10 + GH)
    Hkv = 2
    for T in (64, 512, 2048):
        kc, vc, q, kn, vn, rope = _k2_inputs(g, cuda, dtype, 2, 2, 2,
                                             GH * Hkv, Hkv, T)
        for p in (0, 1, 7, 256, T - 1):
            if p >= T:
                continue
            pos = torch.tensor([p, min(p + 3, T - 1)], dtype=torch.int32,
                               device=cuda)
            _k2_case(cuda, dtype, q, kn, vn, kc, vc, 1, pos, window, rope)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_k2_sixteen_rows_match_plain(cuda, monkeypatch, dtype, splits):
    """B = 16 rows at mixed positions, some at 0, MHA and GQA + window."""
    monkeypatch.setattr(da, "_splits", lambda *a, **k: splits)
    g = torch.Generator(device=cuda).manual_seed(100 + splits)
    T = 512
    pos = torch.tensor([0, 0, 1, 3, 7, 8, 31, 64, 100, 255, 256, 300, 411,
                        500, 510, T - 1], dtype=torch.int32, device=cuda)
    for Hq, Hkv, window in ((4, 4, None), (16, 2, 64)):
        kc, vc, q, kn, vn, rope = _k2_inputs(g, cuda, dtype, 2, 16, 16, Hq,
                                             Hkv, T)
        _k2_case(cuda, dtype, q, kn, vn, kc, vc, 1, pos, window, rope)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("S", [1, 8, 16])
def test_k2_seq_block_splits_match_plain(cuda, monkeypatch, dtype, splits, S):
    """seq_block with S slots at p0 in {0, 5, T-20}: one read of the cache
    for all slots (or groups of slots where they do not fit), MHA and
    GQA 8 with a window."""
    monkeypatch.setattr(da, "_splits", lambda *a, **k: splits)
    g = torch.Generator(device=cuda).manual_seed(200 + splits * S)
    T = 512
    for Hq, Hkv, window in ((2, 2, None), (16, 2, 24)):
        kc, vc, q, kn, vn, rope = _k2_inputs(g, cuda, dtype, 2, 1, S, Hq,
                                             Hkv, T)
        for p0 in (0, 5, T - 20):
            pos = torch.arange(p0, p0 + S, dtype=torch.int32, device=cuda)
            _k2_case(cuda, dtype, q, kn, vn, kc, vc, 1, pos, window, rope,
                     seq_block=True)


def test_k2_split_rule_on_this_card(cuda):
    """The rule's choice at the 7B shapes on this card, and a launch at
    the largest score slice the plan accepts."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert da._splits(1, 32, 2048, False, sms) == (8 if sms >= 128 else 4)
    assert da._splits(16, 32, 2048, False, sms) == 1
    g = torch.Generator(device=cuda).manual_seed(3)
    T = 12000
    assert da._plan(1, 8, 1, T, False, 2, sms) is not None
    kc, vc, q, kn, vn, rope = _k2_inputs(g, cuda, torch.bfloat16, 1, 1, 1,
                                         8, 1, T)
    pos = torch.tensor([T - 1], dtype=torch.int32, device=cuda)
    _k2_case(cuda, torch.bfloat16, q, kn, vn, kc, vc, 0, pos, None, rope)


def test_k2_smem_matches_kernel_layout(cuda):
    """The wrapper's `_smem_bytes` equals the kernel's `Layout::total`
    across the plans it may choose: both cache types, GH 1-8, seq_block
    slot groups with their rebuilt rows, short and long T, S 1-8."""
    lib = _build.load()["decode_attention"]
    for code, esz in ((0, 4), (1, 2)):
        for GH in (1, 2, 4, 8):
            for slots, nreb in ((1, 0), (1, 7), (4, 15), (8, 15), (16, 15)):
                for T in (1, 64, 100, 512, 2048, 12000):
                    for S in (1, 2, 4, 8):
                        assert da._smem_bytes(esz, GH, slots, nreb, T, S) == \
                            lib.teal_decode_attention_smem(code, GH, slots,
                                                           nreb, T, S)


# -- calibration on the card --------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [256, 512])
def test_capture_through_k6_matches_masked(cuda, dtype, S):
    """A calibration capture (`grab_acts._layer_capture`, one K6 launch)
    against the same layer with `causal_prefill=False` (the masked
    attention): the attention output (attn h2) each (position, head) row
    within 2^-6 (bf16) or 1e-5 (fp32) of its row's largest value, attn h1
    equal, and the later captures and the layer output within 2e-2 (bf16)
    or 1e-5 (fp32) of their scale."""
    from teal_tpu_torch.calibration import grab_acts
    from teal_tpu_torch.config import SparsityConfig, get_model_config

    cfg = get_model_config("tiny", n_layers=1, n_heads=4, n_kv_heads=2,
                           dim=512, intermediate_size=768, vocab_size=128)
    g = torch.Generator(device=cuda).manual_seed(S)
    params = llama.init_params(cfg, g, dtype, cuda)
    lp = grab_acts._layer_params(params, 0)
    h = torch.randn(2, S, cfg.dim, generator=g, device=cuda).to(dtype)
    before = flash_prefill_attention.launches
    out, caps = grab_acts._layer_capture(lp, h, cfg)
    assert flash_prefill_attention.launches == before + 1
    cos, sin = llama.precompute_rope(cfg, S, cuda)
    kc = torch.zeros((2, cfg.n_kv_heads, S, cfg.head_dim), dtype=dtype,
                     device=cuda)
    want, _, _, wcaps = llama.layer_forward(
        h, lp, kc, kc.clone(), torch.zeros(2, dtype=torch.int64, device=cuda),
        cos.expand(2, S, -1), sin.expand(2, S, -1), cfg,
        SparsityConfig(enabled=False), torch.zeros(7, device=cuda),
        capture=True, causal_prefill=False)
    assert flash_prefill_attention.launches == before + 1
    assert torch.equal(caps["self_attn"]["h1"], wcaps["self_attn"]["h1"])
    rows = (caps["self_attn"]["h2"].float().reshape(2, S, cfg.n_heads, -1),
            wcaps["self_attn"]["h2"].float().reshape(2, S, cfg.n_heads, -1))
    diff = (rows[0] - rows[1]).abs().amax(-1)
    scale = rows[1].abs().amax(-1)
    rel = 1e-5 if dtype == torch.float32 else 2 ** -6
    assert bool((diff <= rel * scale).all()), \
        float((diff / scale.clamp_min(1e-30)).max())
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    for got, ref in ((out, want), (caps["mlp"]["h1"], wcaps["mlp"]["h1"]),
                     (caps["mlp"]["h2"], wcaps["mlp"]["h2"])):
        ok, err = _close(got, ref, rel)
        assert ok, err


def test_accumulate_counts_on_card_matches_cpu(cuda):
    """Streaming histogram counts on the card equal the CPU's."""
    from teal_tpu_torch.ops.distribution import accumulate_counts

    g = torch.Generator().manual_seed(0)
    edges = torch.linspace(-3, 3, 1001)
    counts = torch.zeros(1000, dtype=torch.float64)
    dcounts = counts.to(cuda)
    for i in range(3):
        v = torch.randn(4096, 11, generator=g) * (1 + i)
        counts = accumulate_counts(edges, v, counts)
        dcounts = accumulate_counts(edges.to(cuda), v.to(cuda), dcounts)
    assert torch.equal(dcounts.cpu(), counts)
    assert float(counts.sum()) == 3 * 4096 * 11


@pytest.mark.parametrize("K,N,group", [(512, 256, 128), (1024, 384, 64)])
def test_gptq_on_card_matches_cpu(cuda, K, N, group):
    """GPTQ in float64 on the card: the CPU's codes, scale and zero within
    1e-6."""
    from teal_tpu_torch.ops import gptq

    g = torch.Generator().manual_seed(K)
    basis = torch.randn(32, K, generator=g, dtype=torch.float64)
    x = (torch.randn(2048, 32, generator=g, dtype=torch.float64) @ basis
         + 0.1 * torch.randn(2048, K, generator=g, dtype=torch.float64))
    x[:, 3] = 0.0                                     # a dead input
    w = torch.randn(K, N, generator=g) * 0.02
    want = gptq.gptq_quantize_int4(w, x, group=group)
    got = gptq.gptq_quantize_int4(w.to(cuda), x.to(cuda), group=group)
    assert got.q.device.type == "cuda"
    assert torch.equal(got.q.cpu(), want.q)
    for key in ("scale", "zero"):
        assert float((getattr(got, key).cpu() - getattr(want, key))
                     .abs().max()) <= 1e-6


def _spec_head128(device, dsp, margins=None):
    """Self-speculation on a head-128 config in fp32 on `device` (the
    weights drawn on the CPU from a seed): the main path's draft at G =
    128 and the verify through block_verify, temperature 0. With
    `margins` (a list), each logits row's top-2 margin is appended."""
    from teal_tpu_torch.config import get_model_config
    from teal_tpu_torch.engine import speculative as spec

    cfg = get_model_config("tiny", n_layers=2, n_heads=2, n_kv_heads=2,
                           dim=256, intermediate_size=384, vocab_size=128)
    p = llama.init_params(cfg, torch.Generator().manual_seed(1),
                          torch.float32, "cpu")
    p = {k: ({n: w.to(device) for n, w in v.items()} if isinstance(v, dict)
             else v.to(device)) for k, v in p.items()}
    orig = spec.logits_to_probs

    def rec(logits, *a):
        if margins is not None:
            top = torch.topk(logits.float(), 2, dim=-1).values
            margins.append(float((top[..., 0] - top[..., 1]).min()))
        return orig(logits, *a)

    spec.logits_to_probs = rec
    try:
        out = [spec.speculative_generate(
            p, p, cfg, cfg, [5, 2, 7], 12, speculate_k=3, temperature=0.0,
            max_seq=64, draft_sp=dsp, cache_dtype=torch.float32,
            device=device, **kw) for kw in ({}, {"device_loop": True,
                                                 "adaptive_k": True})]
    finally:
        spec.logits_to_probs = orig
    return out


def test_speculative_on_card_matches_cpu(cuda):
    """speculative_generate at temperature 0 in fp32 through K7 (the
    draft step, and the verify chunk in its seq_block form; no K1 or K2)
    gives the CPU run's tokens and stats, host loop and adaptive device
    loop; every logits row's top-2 margin exceeds 1e-4 on the CPU."""
    from teal_tpu_torch.config import SparsityConfig

    dsp = SparsityConfig(enabled=True, kernel="block", block_size=128,
                         block_keep_frac=0.75, block_thresholding=True)
    margins = []
    want = _spec_head128("cpu", dsp, margins)
    assert min(margins) > 1e-4
    before = (bg.select_gather_gemv.launches, da.decode_attention.launches,
              tb.token_kernel.launches)
    got = _spec_head128(cuda, dsp)
    assert bg.select_gather_gemv.launches == before[0]
    assert da.decode_attention.launches == before[1]
    assert tb.token_kernel.launches > before[2]
    assert 0.0 < want[0][1]["mean_accepted"] < 3.0
    for (t, st), (wt, wst) in zip(got, want):
        assert (t == wt).all() and st == wst


def _write_safetensors(path, tensors):
    """A safetensors file written by hand (8-byte header length, JSON
    header, raw data): the card's machine has no safetensors package."""
    import json
    import struct

    import numpy as np

    header, blobs, off = {}, [], 0
    for name, a in tensors.items():
        kind = {np.float32: "F32", np.float16: "F16"}[a.dtype.type]
        b = np.ascontiguousarray(a).tobytes()
        header[name] = {"dtype": kind, "shape": list(a.shape),
                        "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + b"".join(blobs))


@pytest.mark.parametrize("stored", ["float32", "float16"])
def test_safetensors_reader_on_card(cuda, tmp_path, stored):
    """load_hf_checkpoint onto the card gives the CPU's tensors."""
    import numpy as np

    from teal_tpu_torch.config import get_model_config
    from teal_tpu_torch.utils import checkpoint as ckpt

    cfg = get_model_config("tiny")
    rng = np.random.default_rng(0)
    D, I, KV, V = cfg.dim, cfg.intermediate_size, cfg.kv_dim, cfg.vocab_size
    shapes = {"model.embed_tokens.weight": (V, D), "model.norm.weight": (D,)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (D,),
            p + "post_attention_layernorm.weight": (D,),
            p + "self_attn.q_proj.weight": (D, D),
            p + "self_attn.k_proj.weight": (KV, D),
            p + "self_attn.v_proj.weight": (KV, D),
            p + "self_attn.o_proj.weight": (D, D),
            p + "mlp.gate_proj.weight": (I, D),
            p + "mlp.up_proj.weight": (I, D),
            p + "mlp.down_proj.weight": (D, I)})
    _write_safetensors(tmp_path / "model.safetensors", {
        k: rng.normal(0, 0.02, s).astype(stored) for k, s in shapes.items()})
    for dtype in (torch.float32, torch.bfloat16):
        want = ckpt._flatten(ckpt.load_hf_checkpoint(str(tmp_path), cfg,
                                                     dtype, "cpu"))
        got = ckpt._flatten(ckpt.load_hf_checkpoint(str(tmp_path), cfg,
                                                    dtype, cuda))
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert t.device.type == "cuda" and t.dtype == want[k].dtype
            assert torch.equal(t.cpu(), want[k]), k


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_decode_graph_matches_host_loop(cuda, b, temperature):
    """The decode step captured as a CUDA graph (`on_device_loop=True`) on
    the K1/K2 loop at batch 1 (`token_fused=False`) and on K7's rows form
    at batch 4 gives the host loop's tokens from one generator seed, and
    leaves the generator where the host loop does; the graph holds the
    step's 4*L K1 + L K2 at batch 1, one K7 rows node and no K1 or K2 at
    batch 4 (K7's one-row graph: `test_k7_decode_graph_matches_host_loop`)."""
    from teal_tpu_torch.config import SparsityConfig, get_model_config
    from teal_tpu_torch.engine import Generator
    from teal_tpu_torch.utils.profiling import graph_kernels

    cfg = get_model_config("tiny", n_layers=2, n_heads=2, n_kv_heads=1,
                           dim=256, intermediate_size=384, vocab_size=128)
    params = llama.init_params(cfg, torch.Generator(device=cuda).manual_seed(
        0), torch.bfloat16, cuda)
    sp = SparsityConfig(enabled=True, kernel="block", block_size=128,
                        block_keep_frac=0.5, block_thresholding=True,
                        token_fused=False if b == 1 else None)
    gen = Generator(cfg, params, sp=sp, max_seq=64, batch=b,
                    temperature=temperature, device=cuda)
    th = torch.full((cfg.n_layers, 7), 0.5, device=cuda)
    prompt = torch.randint(1, cfg.vocab_size, (b, 5),
                           generator=torch.Generator().manual_seed(b)).numpy()
    outs, states = [], []
    for dl in (False, True, True):
        g = torch.Generator(device=cuda).manual_seed(3)
        outs.append(gen.generate(prompt, 12, thresholds=th, generator=g,
                                 on_device_loop=dl)[0])
        states.append(g.get_state())
    assert gen._loop.graph is not None
    for got, state in zip(outs[1:], states[1:]):
        assert (got == outs[0]).all()
        assert torch.equal(state, states[0])
    # the graph's kernel nodes, read from the CUDA driver: what a replay runs
    nodes = graph_kernels(gen._loop.graph)
    assert [sum(c for k, c in nodes.items() if name in k)
            for name in ("sgg_", "attn_kernel", "token_rows_kernel")] == (
        [4 * cfg.n_layers, cfg.n_layers, 0] if b == 1 else [0, 0, 1]), nodes


@pytest.mark.parametrize("kw", [dict(temperature=1.0),
                                dict(temperature=1.0, adaptive_k=True)],
                         ids=["sampled", "adaptive"])
def test_round_graphs_match_host_round_loop(cuda, kw):
    """Speculative `device_loop=True` (each round a replay of its depth's
    CUDA graph) gives the tokens and stats of the host round loop, draw
    for draw (adaptive depth: of the eager round loop with the graphs
    turned off)."""
    from teal_tpu_torch.config import SparsityConfig, get_model_config
    from teal_tpu_torch.engine import speculative as spec

    cfg = get_model_config("tiny", n_layers=2, n_heads=2, n_kv_heads=2,
                           dim=256, intermediate_size=384, vocab_size=128)
    params = llama.init_params(cfg, torch.Generator(device=cuda).manual_seed(
        1), torch.bfloat16, cuda)
    draft = SparsityConfig(enabled=True, kernel="block", block_size=128,
                           block_keep_frac=0.5, block_thresholding=True)
    th = torch.zeros((cfg.n_layers, 7), device=cuda)

    def run(device_loop):
        return spec.speculative_generate(
            params, params, cfg, cfg, [1, 5, 9, 2], 24, speculate_k=4,
            max_seq=128, draft_sp=draft, draft_thresholds=th,
            generator=torch.Generator(device=cuda).manual_seed(3),
            device_loop=device_loop, device=cuda, **kw)

    toks, st = run(True)
    if kw.get("adaptive_k"):
        eager = spec._Rounds.round

        def no_graph(self, k_eff, replay=True):
            return eager(self, k_eff, replay=False)

        spec._Rounds.round = no_graph
        try:
            want, wst = run(True)
        finally:
            spec._Rounds.round = eager
        assert wst == st
    else:
        want, wst = run(False)
        assert (wst["new_tokens"], wst["mean_accepted"]) == (
            st["new_tokens"], st["mean_accepted"])
        assert len(wst["accepted_per_step"]) == st["rounds"]
    assert (toks == want).all()


# --- K7: the whole token in one launch --------------------------------------

K7_WS = ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown")


def _k7_quantize(ws, plan):
    """Seven bf16 [L, K, N] stacks as the port's int8 dicts ("int8") or
    packed int4 dicts at quant group 128 ("int4"), quantized on the card
    by `ops/quant` as a params tree is."""
    from teal_tpu_torch.ops import quant

    tree = {"lm_head": ws[0][0], "layers": dict(zip(K7_WS, ws))}
    if plan == "int8":
        tree = quant.quantize_params_int8(tree)
    else:
        tree = quant.pack_int4_params(quant.quantize_params_int4(tree, 128),
                                      128)
    return tuple(tree["layers"][n] for n in K7_WS)


def _k7_inputs(cuda, dtype, Hq, Hkv, L=2, T=64, seed=0):
    """Random 2-layer weights (D = 128 Hq, I = 3 D / 2), gains, caches,
    stream and RoPE row on the card; dtype "int8" or "int4": bf16 with
    the weights quantized (`_k7_quantize`)."""
    if dtype in ("int8", "int4"):
        h, ws, norms, rope, kc, vc = _k7_inputs(cuda, torch.bfloat16, Hq,
                                                Hkv, L, T, seed)
        return h, _k7_quantize(ws, dtype), norms, rope, kc, vc
    g = torch.Generator(device=cuda).manual_seed(seed)
    D, I = 128 * Hq, 192 * Hq

    def r(*shape, sc=1.0):
        return (torch.randn(*shape, generator=g, device=cuda) * sc).to(dtype)
    shapes = ((D, D), (D, 128 * Hkv), (D, 128 * Hkv), (D, D), (D, I),
              (D, I), (I, D))
    ws = tuple(r(L, k, n, sc=0.05) for k, n in shapes)
    norms = tuple((1 + 0.1 * torch.randn(L, D, generator=g, device=cuda))
                  .to(dtype) for _ in range(2))
    kc, vc = r(L, 1, Hkv, T, 128), r(L, 1, Hkv, T, 128)
    rope = torch.rand(1, 2, 128, generator=g, device=cuda)
    return r(D), ws, norms, rope, kc, vc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "int8",
                                   "int4"])
@pytest.mark.parametrize("Hq,Hkv,window,fixed", [
    (4, 4, None, False), (8, 2, None, False), (8, 2, 24, False),
    (4, 4, None, True), (32, 32, None, False), (32, 4, None, False)],
    ids=["mha", "gqa", "gqa-window", "fixed", "7b-heads", "gqa-32-4"])
@pytest.mark.parametrize("pos", [0, 40])
def test_k7_matches_plain(cuda, dtype, Hq, Hkv, window, fixed, pos):
    """K7 on 2 layers against its plain version (`token_kernel_plain`) on
    the same inputs: the same kept counts and groups at every stage, the
    stream and both caches within 1e-5 (fp32) or 2e-2 (bf16, and the
    int8 and packed-int4 weights with a bf16 stream: the partial sums are
    added in other orders, a bf16 ulp is 2^-8) of their largest value.
    fp32 selects at thresholds between the stages' group scores; bf16 at
    0 (every group survives, the first cap kept), where a one-ulp drift
    of a score cannot flip a group. At the 7B's width the 32 kv heads
    take the head-owned plan (a cluster a kv head), 4 kv heads the other
    plan (q|k|v column-owned, a grid barrier before attention)."""
    h, ws, (na, nm), rope, kc, vc = _k7_inputs(cuda, dtype, Hq, Hkv)
    L, D, I = 2, h.shape[0], 192 * Hq
    if Hq == 32:
        plan = tb.token_plan(h, kc, ws, Hq, (D // 256,) * 3 + (I // 256,))
        assert plan.head_owned == (Hkv == 32), plan
    th = torch.zeros((L, 7), device=cuda)
    if dtype == torch.float32:
        th[:, 0], th[:, 3], th[:, 4], th[:, 6] = 2.2, 0.05, 2.2, 0.02
    caps = (D // 256, D // 256, D // 256, I // 256)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=cuda)
    kw = dict(caps=caps, n_heads=Hq, window=window, fixed_sel=fixed)
    assert tb.k7_form(h, ws, kc, Hq)
    out, sels, caches = [], [], []
    for f in (tb.token_kernel, tb.token_kernel_plain):
        sel = torch.zeros((L, 4, 1 + max(caps)), dtype=torch.int32,
                          device=cuda)
        k, v = kc.clone(), vc.clone()
        out.append(f(h, th, ws, na, nm, rope, k, v, pos_t, sel=sel, **kw))
        sels.append(sel)
        caches.append((k, v))
    assert torch.equal(sels[0], sels[1]), (sels[0][..., :4], sels[1][..., :4])
    assert int(sels[0][:, :, 0].min()) >= 1
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    for got, want in ((out[0], out[1]), (caches[0][0], caches[1][0]),
                      (caches[0][1], caches[1][1])):
        ok, err = _close(got, want, rel)
        assert ok, err


K7_ROW_CONFIGS = pytest.mark.parametrize("Hq,Hkv,window,fixed", [
    (4, 4, None, False), (8, 2, None, False), (8, 2, 24, False),
    (4, 4, None, True), (32, 32, None, False), (32, 4, None, False)],
    ids=["mha", "gqa", "gqa-window", "fixed", "7b-heads", "gqa-32-4"])


def _k7_rows_case(cuda, dtype, Hq, Hkv, window, fixed, B, seq):
    """K7's rows form against its plain version on 2 layers (see
    `test_k7_rows_matches_plain` and `test_k7_seq_block_matches_plain`):
    B rows at pos 0, 5, 10, ... of their own cache rows, or with `seq`
    the positions 37..37 + B - 1 of one sequence in cache row 0."""
    h1, ws, (na, nm), _, _, _ = _k7_inputs(cuda, dtype, Hq, Hkv)
    dt = torch.bfloat16 if isinstance(dtype, str) else dtype
    g = torch.Generator(device=cuda).manual_seed(1)
    L, T, D, I = 2, 64, h1.shape[0], 192 * Hq
    Bc = 1 if seq else B
    h = (torch.randn(B, D, generator=g, device=cuda)).to(dt)
    kc = torch.randn(L, Bc, Hkv, T, 128, generator=g, device=cuda).to(dt)
    vc = torch.randn(L, Bc, Hkv, T, 128, generator=g, device=cuda).to(dt)
    rope = torch.rand(B, 2, 128, generator=g, device=cuda)
    pos_t = torch.tensor([37 + b if seq else (5 * b) % T for b in range(B)],
                         dtype=torch.int32, device=cuda)
    th = torch.zeros((L, 7), device=cuda)
    if dtype == torch.float32:
        th[:, 0], th[:, 3], th[:, 4], th[:, 6] = 2.2, 0.05, 2.2, 0.02
    caps = (D // 256, D // 256, D // 256, I // 256)
    kw = dict(caps=caps, n_heads=Hq, window=window, fixed_sel=fixed,
              seq_block=seq)
    assert tb.k7_form(h, ws, kc, Hq, seq_block=seq)
    assert tb.token_plan(h, kc, ws, Hq, caps, window) is not None
    out, sels, caches = [], [], []
    for f in (tb.token_kernel, tb.token_kernel_plain):
        sel = torch.zeros((L, 4, 1 + max(caps)), dtype=torch.int32,
                          device=cuda)
        k, v = kc.clone(), vc.clone()
        out.append(f(h, th, ws, na, nm, rope, k, v, pos_t, sel=sel, **kw))
        sels.append(sel)
        caches.append((k, v))
    assert torch.equal(sels[0], sels[1]), (sels[0][..., :4], sels[1][..., :4])
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    for got, want in ((out[0], out[1]), (caches[0][0], caches[1][0]),
                      (caches[0][1], caches[1][1])):
        ok, err = _close(got, want, rel)
        assert ok, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "int8",
                                   "int4"])
@K7_ROW_CONFIGS
@pytest.mark.parametrize("B", [2, 16])
def test_k7_rows_matches_plain(cuda, dtype, Hq, Hkv, window, fixed, B):
    """K7's rows form (B rows, each a sequence at its own position and
    cache row: pos 0, 5, 10, ... of a 64-row cache) on 2 layers against
    its plain version on the same inputs, as `test_k7_matches_plain`
    holds the one-row kernel: one kept set a stage (the score pooled over
    the rows) equal at every stage, the rows' streams and both caches
    within 1e-5 (fp32) or 2e-2 (bf16, and int8 and packed int4 with a
    bf16 stream) of their largest value."""
    _k7_rows_case(cuda, dtype, Hq, Hkv, window, fixed, B, seq=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "int8",
                                   "int4"])
@K7_ROW_CONFIGS
@pytest.mark.parametrize("S", [2, 8])
def test_k7_seq_block_matches_plain(cuda, dtype, Hq, Hkv, window, fixed, S):
    """K7's seq_block form (S consecutive positions 37.. of one sequence
    in cache row 0, the verify's chunk: every row's K/V written before any
    row attends, row i to the rows before 37 + i) on 2 layers against its
    plain version (K2's plain seq_block form), fixed and threshold
    selection, in the three weight plans: the same kept groups, the rows'
    streams and the whole cache within 1e-5 (fp32) or 2e-2 of their
    largest value."""
    _k7_rows_case(cuda, dtype, Hq, Hkv, window, fixed, S, seq=True)


@pytest.mark.parametrize("seq", [False, True], ids=["rows", "seq_block"])
@pytest.mark.parametrize("B", [2, 5])
def test_k7_rows_deterministic(cuda, B, seq):
    """K7's rows form launched 30 times on the same inputs gives the same
    stream and cache bit for bit, as rows and in its seq_block form, at B
    < 8, where the rows' input staged by bulk copies of rows other blocks
    had just written raced (the producer warp now stages it by generic
    loads through L2): the 7B's heads on 2 layers at full caps, fixed
    selection."""
    h1, ws, (na, nm), _, _, _ = _k7_inputs(cuda, torch.bfloat16, 32, 32)
    g = torch.Generator(device=cuda).manual_seed(2)
    L, T, D, I = 2, 64, h1.shape[0], 192 * 32
    Bc = 1 if seq else B
    h = torch.randn(B, D, generator=g, device=cuda).to(torch.bfloat16)
    kc = torch.randn(L, Bc, 32, T, 128, generator=g,
                     device=cuda).to(torch.bfloat16)
    vc = torch.randn(L, Bc, 32, T, 128, generator=g,
                     device=cuda).to(torch.bfloat16)
    rope = torch.rand(B, 2, 128, generator=g, device=cuda)
    pos = torch.tensor([40 + (1 if seq else 4) * b for b in range(B)],
                       dtype=torch.int32, device=cuda)
    th = torch.zeros((L, 7), device=cuda)
    kw = dict(caps=(D // 128,) * 3 + (I // 128,), n_heads=32,
              fixed_sel=True, seq_block=seq)
    first = None
    for _ in range(30):
        k, v = kc.clone(), vc.clone()
        out = tb.token_kernel(h, th, ws, na, nm, rope, k, v, pos, **kw)
        if first is None:
            first = (out, k, v)
            continue
        assert torch.equal(out, first[0]) and torch.equal(k, first[1]) \
            and torch.equal(v, first[2])


def test_k7_plan_matches_kernel(cuda):
    """`teal_token_plan` (the kernel's plan) equal to `_token_plan` (the
    wrapper's, on the card's resident clusters from `k7_clusters`) on this
    card at 7B, Mistral-7B with its window, GQA 32/4 and the tiny configs,
    fp32 and bf16 arrays, and int8 and packed int4 with a bf16 stream
    (`teal_token_plan_q`); the rows form's (`teal_token_plan_rows`,
    `teal_token_plan_rows_q`) at B = 2, 8 and 16 in the same four forms."""
    import ctypes

    lib = _build.load()["token_decode"]
    qlib = _build.load()["token_decode_quant"]
    rlib = _build.load()["token_decode_rows"]
    rqlib = _build.load()["token_decode_rows_quant"]
    sms = _build.sm_count(cuda.index)
    for D, I, Hq, Hkv, T, win, cm, L in (
            (4096, 11008, 32, 32, 4096, None, 43, 32),
            (4096, 14336, 32, 8, 32768, 4096, 56, 32),
            (4096, 11008, 32, 4, 2048, None, 43, 32),
            (256, 384, 2, 1, 16, None, 2, 3),
            (512, 768, 4, 2, 64, 24, 3, 2)):
        for dtype, code, esz in ((torch.float32, 0, 4),
                                 (torch.bfloat16, 1, 2)):
            out = (ctypes.c_int * 11)()
            rc = lib.teal_token_plan(code, D, I, Hq, Hkv, T, win or 0, cm,
                                     sms, L, out)
            want = tb._token_plan(esz, D, I, Hq, Hkv, T, win, cm, L, sms,
                                  tb.k7_clusters(cuda, dtype, Hq // Hkv))
            assert rc == 0 and tuple(out) == tuple(want), (D, esz, list(out),
                                                           want)
            for B in (2, 8, 16):
                out = (ctypes.c_int * 11)()
                rc = rlib.teal_token_plan_rows(code, B, D, I, Hq, Hkv, T,
                                               win or 0, cm, sms, L, out)
                want = tb._token_plan(esz, D, I, Hq, Hkv, T, win, cm, L, sms,
                                      tb.k7_clusters(cuda, dtype, Hq // Hkv,
                                                     rows=True), rows=B)
                assert rc == 0 and tuple(out) == tuple(want), (
                    D, esz, B, list(out), want)
        for plan in (bg.PLAN_INT8, bg.PLAN_INT4):
            out = (ctypes.c_int * 11)()
            rc = qlib.teal_token_plan_q(plan, D, I, Hq, Hkv, T, win or 0, cm,
                                        sms, L, out)
            want = tb._token_plan(2, D, I, Hq, Hkv, T, win, cm, L, sms,
                                  tb.k7_clusters(cuda, torch.bfloat16,
                                                 Hq // Hkv, plan), plan)
            assert rc == 0 and tuple(out) == tuple(want), (D, plan,
                                                           list(out), want)
            for B in (2, 8, 16):
                out = (ctypes.c_int * 11)()
                rc = rqlib.teal_token_plan_rows_q(plan, B, D, I, Hq, Hkv, T,
                                                  win or 0, cm, sms, L, out)
                want = tb._token_plan(
                    2, D, I, Hq, Hkv, T, win, cm, L, sms,
                    tb.k7_clusters(cuda, torch.bfloat16, Hq // Hkv, plan,
                                   rows=True), plan, B)
                assert rc == 0 and tuple(out) == tuple(want), (
                    D, plan, B, list(out), want)


def test_k7_decode_graph_matches_host_loop(cuda):
    """The main path's decode step (K7 at batch 1) captured as a CUDA graph
    gives the host loop's greedy tokens; the graph holds one K7 node and
    no K1 or K2 node; the host loop launches one K7 a decoded token."""
    from teal_tpu_torch.config import SparsityConfig, get_model_config
    from teal_tpu_torch.engine import Generator
    from teal_tpu_torch.utils.profiling import graph_kernels

    cfg = get_model_config("tiny", n_layers=2, n_heads=4, n_kv_heads=2,
                           dim=512, intermediate_size=768, vocab_size=128)
    params = llama.init_params(cfg, torch.Generator(device=cuda).manual_seed(
        0), torch.bfloat16, cuda)
    sp = SparsityConfig(enabled=True, kernel="block", block_size=128,
                        block_keep_frac=0.5, block_thresholding=True)
    gen = Generator(cfg, params, sp=sp, max_seq=64, temperature=0.0,
                    device=cuda)
    th = torch.full((cfg.n_layers, 7), 0.5, device=cuda)
    prompt = [3, 9, 1, 7, 5]
    gen.generate(prompt, 2, thresholds=th, on_device_loop=False)
    before = (tb.token_kernel.launches, bg.select_gather_gemv.launches)
    host = gen.generate(prompt, 12, thresholds=th, on_device_loop=False)[0]
    assert (tb.token_kernel.launches - before[0],
            bg.select_gather_gemv.launches - before[1]) == (11, 0)
    graph = gen.generate(prompt, 12, thresholds=th)[0]
    assert (graph == host).all()
    nodes = graph_kernels(gen._loop.graph)
    assert [sum(c for k, c in nodes.items() if name in k)
            for name in ("token_kernel", "sgg_", "attn_kernel")] == [1, 0, 0]


@pytest.mark.parametrize("plan", ["int8", "int4"])
def test_k7_quant_decode_graph_matches_host_loop(cuda, plan):
    """The main path's decode step on int8 or packed int4 (group 128)
    weights with a bf16 stream: K7 at batch 1, captured as a CUDA graph,
    gives the host loop's greedy tokens; the graph holds one K7 node and
    no K1 or K2 node; the host loop launches one K7 a decoded token."""
    from teal_tpu_torch.config import SparsityConfig, get_model_config
    from teal_tpu_torch.engine import Generator
    from teal_tpu_torch.ops import quant
    from teal_tpu_torch.utils.profiling import graph_kernels

    cfg = get_model_config("tiny", n_layers=2, n_heads=4, n_kv_heads=2,
                           dim=512, intermediate_size=768, vocab_size=128)
    params = llama.init_params(cfg, torch.Generator(device=cuda).manual_seed(
        0), torch.bfloat16, cuda)
    params = (quant.quantize_params_int8(params) if plan == "int8" else
              quant.pack_int4_params(quant.quantize_params_int4(params, 128),
                                     128))
    sp = SparsityConfig(enabled=True, kernel="block", block_size=128,
                        block_keep_frac=0.5, block_thresholding=True)
    gen = Generator(cfg, params, sp=sp, max_seq=64, temperature=0.0,
                    device=cuda)
    th = torch.full((cfg.n_layers, 7), 0.5, device=cuda)
    prompt = [3, 9, 1, 7, 5]
    gen.generate(prompt, 2, thresholds=th, on_device_loop=False)
    before = (tb.token_kernel.launches, bg.select_gather_gemv.launches)
    host = gen.generate(prompt, 12, thresholds=th, on_device_loop=False)[0]
    assert (tb.token_kernel.launches - before[0],
            bg.select_gather_gemv.launches - before[1]) == (11, 0)
    graph = gen.generate(prompt, 12, thresholds=th)[0]
    assert (graph == host).all()
    nodes = graph_kernels(gen._loop.graph)
    assert [sum(c for k, c in nodes.items() if name in k)
            for name in ("token_kernel", "sgg_", "attn_kernel")] == [1, 0, 0]
