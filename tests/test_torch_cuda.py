"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA card (the kernel has no
CPU mode).  This file imports neither JAX nor the JAX package, so it
runs on a machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances are those of ``tests/test_kernels.py``: 2e-5 for float32;
2e-2 (attention) and 3e-2 (RG-LRU) for bfloat16.
"""

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rg_lru as lru
from repro_torch.models.sharding import KernelDispatch, kernel_dispatch

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LRU_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def qkv(gen, B, S, T, H, hd, dtype):
    return (torch.randn((B, n, H, hd), generator=gen, device="cuda").to(dtype)
            for n in (S, T, T))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,T,causal", [(256, 256, True), (256, 256, False),
                                        (200, 333, True), (333, 200, True),
                                        (1000, 1000, True)])
def test_kernel_matches_plain(gen, dtype, S, T, causal):
    q, k, v = qkv(gen, 2, S, T, 4, 64, dtype)
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("hd", [16, 48, 128])
def test_every_head_dim_family(gen, hd):
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = qkv(gen, 1, 130, 130, 3, hd, dtype)
        got = fa.flash_attention(q, k, v, causal=True)
        want = fa.reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])


def test_dispatch_launches_only_for_cuda_sites(gen):
    q, k, v = qkv(gen, 1, 64, 64, 2, 64, torch.bfloat16)
    before = fa.launches
    with kernel_dispatch(KernelDispatch(impls={"flash_attention:0": "cuda",
                                               "flash_attention:1": "ref"})):
        ops.attention(q, k, v, causal=True)
        ops.attention(q, k, v, causal=True)
    assert fa.launches == before + 1


def test_raises_for_inputs_the_kernel_does_not_take(gen):
    q, k, v = qkv(gen, 1, 64, 64, 2, 40, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, k, v)
    packed = torch.zeros((1, 64, 2, 65), device="cuda",
                         dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="even"):
        fa.flash_attention(packed, packed, packed)


def lru_inputs(gen, shape, dtype, lo=None, hi=None):
    if lo is None:
        a = torch.sigmoid(torch.randn(shape, generator=gen, device="cuda"))
    else:
        a = lo + (hi - lo) * torch.rand(shape, generator=gen, device="cuda")
    b = 0.1 * torch.randn(shape, generator=gen, device="cuda")
    return a.to(dtype), b.to(dtype)


def assert_lru_close(a, b):
    got = lru.rg_lru(a, b)
    want = lru.reference(a, b)
    torch.cuda.synchronize()
    assert got.dtype == a.dtype
    tol = LRU_TOL[a.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 4096, 3840), (1, 64, 131),
                                   (1, 1000, 300)])
def test_rg_lru_matches_plain(gen, dtype, shape):
    assert_lru_close(*lru_inputs(gen, shape, dtype))


def test_rg_lru_carries_slow_gates(gen):
    assert_lru_close(*lru_inputs(gen, (4, 4096, 3840), torch.float32, 0.9,
                                 0.999))


def test_rg_lru_decay_matches_the_closed_form(gen):
    S = 2048
    a = torch.full((1, S, 128), 0.999, device="cuda")
    b = torch.full((1, S, 128), 0.01, device="cuda")
    h = assert_lru_close(a, b)
    want = 0.01 * (1 - 0.999 ** S) / 0.001
    torch.testing.assert_close(h[0, -1], torch.full_like(h[0, -1], want),
                               rtol=1e-3, atol=0)


def test_rg_lru_takes_strided_views(gen):
    packed = torch.rand((2, 300, 2, 256), generator=gen, device="cuda")
    assert_lru_close(packed[:, :, 0], packed[:, :, 1])


def test_rg_lru_raises_for_inputs_the_kernel_does_not_take(gen):
    before = lru.launches
    half = torch.zeros((1, 8, 16), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lru.rg_lru(half, half)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.rg_lru(half, half)
    strided = torch.zeros((1, 8, 32), device="cuda")[..., ::2]
    with pytest.raises(ValueError, match="contiguous channel"):
        lru.rg_lru(strided, strided)
    assert lru.launches == before
