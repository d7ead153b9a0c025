"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. This file
imports no JAX, so on a machine with a card and no JAX run it without the
JAX test setup of tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import pytest
import torch

from teal_tpu_torch.models import llama
from teal_tpu_torch.ops import block_gemv as bg
from teal_tpu_torch.ops import gather_gemv as gg
from teal_tpu_torch.ops.decode_attention import (decode_attention,
                                                 decode_attention_plain)

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,rows", [(32, 1), (64, 1), (32, 8), (128, 5)])
def test_k3_kernel_matches_plain(cuda, dtype, G, rows):
    g = torch.Generator(device=cuda).manual_seed(3)
    L, K, layer, k_keep = 3, 1024, 2, 9
    ws = [(torch.randn(L, K, n, generator=g, device=cuda) * 0.05).to(dtype)
          for n in (256, 96, 32)]
    x = torch.randn(rows, K, generator=g, device=cuda).to(dtype)
    idx, xpack = (bg.select_groups(x, G, min(k_keep, K // G)) if rows == 1
                  else bg.select_groups_batched(x, G, min(k_keep, K // G)))
    got = bg.block_gather_gemv_multi(idx, xpack, ws, layer, G, rows)
    want = bg.block_gather_gemv_multi_plain(idx, xpack, ws, layer, G, rows)
    ok, err = _close(got, want, 1e-5 if dtype == torch.float32 else 1e-4)
    assert ok, err


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
