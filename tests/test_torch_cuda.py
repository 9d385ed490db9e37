"""The CUDA flash-attention kernel against its plain version, on the card.

Marked ``cuda``: each test skips without a CUDA card (the kernel has no
CPU mode).  This file imports neither JAX nor the JAX package, so it
runs on a machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances are those of ``tests/test_kernels.py``: 2e-5 for float32,
2e-2 for bfloat16.
"""

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models.sharding import KernelDispatch, kernel_dispatch

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


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
