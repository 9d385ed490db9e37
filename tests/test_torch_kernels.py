"""The port's fused-attention modules against the JAX package.

``kernels/ref.py`` (the CUDA kernel's plain version) and ``kernels/ops``
on CPU tensors are held against the reference's Pallas kernel (run in
interpret mode, as ``tests/test_kernels.py`` runs it) and its jnp oracle
over the ``TestFlashAttention`` cases.  Inputs come from numpy seeds and
are handed to both packages.  Tolerances are those of
``tests/test_kernels.py``: 2e-5 for float32, 2e-2 for bfloat16.

The CUDA kernels themselves run only on a card: their checks are in
``tests/test_torch_cuda.py`` (marked ``cuda``, skipped without a card).
What surrounds them is tested here: the RG-LRU wrapper's route rule,
the tiles the wrappers and the sources share, and the build's hash.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import registry as jregistry
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import nvcc, ops, ref, registry
from repro_torch.kernels import rg_lru as lru
from repro_torch.kernels import tune_rg_lru
from repro_torch.models.layers import repeat_heads
from repro_torch.models.sharding import KernelDispatch, kernel_dispatch

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def randn(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def both(x, dtype):
    """The same numpy array as a jnp and a torch array of ``dtype``."""
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def close(got, want, dtype):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else
        np.asarray(got, np.float32),
        np.asarray(want, np.float32), rtol=TOL[dtype], atol=TOL[dtype])


class TestPlainAttention:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_pallas_interpret_and_oracle(self, causal, dtype):
        B, H, S, hd = 2, 2, 256, 64
        (jq, tq), (jk, tk), (jv, tv) = (both(randn(i, (B, H, S, hd)), dtype)
                                        for i in range(3))
        got = ref.reference_attention(tq, tk, tv, causal=causal)
        assert got.dtype == tq.dtype
        close(got, jflash(jq, jk, jv, causal=causal, block_q=64,
                          block_k=64, interpret=True), dtype)
        close(got, jref.reference_attention(jq, jk, jv, causal=causal),
              dtype)

    @pytest.mark.parametrize("causal", [True, False])
    def test_cross_lengths(self, causal):
        """S != T (prefill against a longer KV)."""
        B, H, S, T, hd = 1, 2, 64, 256, 32
        jq, tq = both(randn(10, (B, H, S, hd)), "float32")
        jk, tk = both(randn(11, (B, H, T, hd)), "float32")
        jv, tv = both(randn(12, (B, H, T, hd)), "float32")
        got = ref.reference_attention(tq, tk, tv, causal=causal)
        close(got, jflash(jq, jk, jv, causal=causal, block_q=32,
                          block_k=64, interpret=True), "float32")
        close(got, jref.reference_attention(jq, jk, jv, causal=causal),
              "float32")

    def test_model_layout_wrapper(self):
        """``flash_attention.reference`` is the oracle in (B,S,H,hd)."""
        B, S, H, hd = 2, 64, 4, 32
        (jq, tq), (jk, tk), (jv, tv) = (both(randn(20 + i, (B, S, H, hd)),
                                             "float32") for i in range(3))
        got = fa.reference(tq, tk, tv, causal=True)
        want = jref.reference_attention(
            *(x.transpose(0, 2, 1, 3) for x in (jq, jk, jv)),
            causal=True).transpose(0, 2, 1, 3)
        close(got, want, "float32")


class TestOpsOnCpu:
    @pytest.mark.parametrize("kv_heads", [1, 2, 4, 8])
    def test_gqa_group_counts(self, kv_heads):
        """Every GQA group count (MQA .. MHA), as the layer calls the op."""
        B, S, H, hd = 1, 128, 8, 32
        jq, tq = both(randn(30, (B, S, H, hd)), "float32")
        jk, tk = both(randn(31, (B, S, kv_heads, hd)), "float32")
        jv, tv = both(randn(32, (B, S, kv_heads, hd)), "float32")
        g = H // kv_heads
        got = ops.attention(tq, repeat_heads(tk, g), repeat_heads(tv, g),
                            causal=True)
        close(got, jops.gqa_flash_attention(jq, jk, jv, causal=True),
              "float32")

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("impl", ["cuda", "ref"])
    def test_cpu_tensors_take_the_plain_version(self, impl, dtype):
        """On CPU tensors every impl is the plain version; no launch."""
        (_, tq), (_, tk), (_, tv) = (both(randn(40 + i, (2, 96, 4, 16)),
                                          dtype) for i in range(3))
        before = fa.launches
        with kernel_dispatch(KernelDispatch(impls={"flash_attention:0":
                                                   impl})) as disp:
            got = ops.attention(tq, tk, tv, causal=True)
            assert disp.next_site("flash_attention") == "flash_attention:1"
        assert fa.launches == before
        torch.testing.assert_close(got, fa.reference(tq, tk, tv,
                                                     causal=True),
                                   rtol=0, atol=0)

    def test_unknown_impl_raises(self):
        t = torch.zeros((1, 8, 2, 16))
        with kernel_dispatch(KernelDispatch(default_impl="pallas")):
            with pytest.raises(ValueError, match="unknown"):
                ops.attention(t, t, t, causal=True)

    def test_wrapper_rejects_what_the_kernel_does_not_take(self):
        ok = torch.zeros((1, 8, 2, 16))
        fa._check(ok, ok, ok)
        with pytest.raises(ValueError, match="head_dim"):
            bad = torch.zeros((1, 8, 2, 40))
            fa._check(bad, bad, bad)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            half = ok.half()
            fa._check(half, half, half)
        with pytest.raises(ValueError, match="do not match"):
            fa._check(ok, torch.zeros((1, 8, 4, 16)), ok)
        with pytest.raises(ValueError, match="contiguous head dim"):
            strided = torch.zeros((1, 8, 2, 32))[..., ::2]
            fa._check(strided, strided, strided)

    @pytest.mark.parametrize("cut", [1, 2, 4])
    def test_bf16_tma_rule(self, cut):
        """bf16 tiles are TMA copies: 16-byte aligned, strides in 16 bytes."""
        packed = torch.zeros((2, 8, 2, 64 + cut), dtype=torch.bfloat16)
        view = packed[..., cut:]
        with pytest.raises(ValueError, match="16 bytes"):
            fa._check(view, view, view)
        # the f32 path reads scalars and takes the same view
        fa._check(view.float()[..., :16], view.float()[..., :16],
                  view.float()[..., :16])

    def test_bf16_tma_rule_passes_packed_views(self):
        """The slice's strided views (one packed projection) and size-1
        dims of any stride are taken."""
        packed = torch.zeros((2, 190, 3, 4, 64), dtype=torch.bfloat16)
        q, k, v = packed[:, :, 0], packed[:, :, 1], packed[:, :, 2]
        fa._check(q, k, v)
        one = torch.zeros((1, 1, 4, 68), dtype=torch.bfloat16)[..., :64]
        assert fa._strides(one) == [4 * 64, 4 * 64, 68]
        with pytest.raises(ValueError, match="16 bytes"):
            fa._check(one, one, one)
        one = torch.zeros((1, 1, 1, 64), dtype=torch.bfloat16)
        single = one.as_strided(one.shape, (3, 5, 7, 1))
        assert fa._strides(single) == [64, 64, 64]
        fa._check(single, single, single)
        with pytest.raises(ValueError, match="CUDA or CPU"):
            meta = torch.empty((1, 8, 2, 16), device="meta")
            fa.flash_attention(meta, meta, meta)


class TestRegistry:
    def test_contract_matches_the_reference(self):
        """Same kernels, roles, mappable and blocked roles; the Pallas
        impl is the port's "cuda" where a Hopper kernel exists."""
        assert set(registry.KERNELS) == set(jregistry.KERNELS)
        for name, spec in registry.KERNELS.items():
            jspec = jregistry.KERNELS[name]
            assert spec.operand_roles == jspec.operand_roles
            assert spec.result_roles == jspec.result_roles
            assert spec.mappable == jspec.mappable
            assert spec.blocked == jspec.blocked
            assert spec.dispatch_site == jspec.dispatch_site
            assert set(spec.impls) <= {registry.port_impl(i)
                                       for i in jspec.impls}
        assert registry.KERNELS["flash_attention"].impls == ("cuda", "ref")
        assert registry.port_impl("pallas") == "cuda"
        assert registry.port_impl("ref") == "ref"

    def test_cuda_feasible_for_every_sequence_length(self):
        dims = {"batch": 1, "heads": 2, "q_seq": 131, "kv_seq": 1000}
        for hd in (16, 48, 64, 128):
            assert registry.cuda_feasible("flash_attention",
                                          {**dims, "head_dim": hd})
        for hd in (8, 40, 256):
            assert not registry.cuda_feasible("flash_attention",
                                              {**dims, "head_dim": hd})
        # the RG-LRU kernel masks ragged channels and sequences itself
        for r in (128, 131, 3840):
            assert registry.cuda_feasible("rg_lru", {"batch": 1,
                                                     "seq": 1000,
                                                     "channels": r})

    def test_flops_and_bytes(self):
        spec = registry.KERNELS["flash_attention"]
        d = {"batch": 4, "heads": 14, "q_seq": 2048, "kv_seq": 2048,
             "head_dim": 64}
        jspec = jregistry.KERNELS["flash_attention"]
        assert spec.flops(d, {"causal": True}) == \
            jspec.flops(d, {"causal": True})
        # flash streaming: Q/O once, K/V once per 128-row q-block, as the
        # reference prices its Pallas kernel's 128-row blocks at S = 2048
        nq = -(-2048 // registry.BLOCK_Q)
        assert nq == 16
        assert spec.bytes_moved("cuda", d, {}, 2) == \
            4 * 14 * 64 * 2 * (2 * 2048 + 2 * 2048 * nq)
        assert spec.bytes_moved("cuda", d, {}, 2) == \
            jspec.bytes_moved("pallas", d, {}, 2)
        assert spec.bytes_moved("ref", d, {}, 2) == \
            jspec.bytes_moved("ref", d, {}, 2)

    def test_block_q_is_the_kernels_query_tile(self):
        """The cost model's K/V re-reads follow the kernel's query tile."""
        src = (Path(fa.__file__).parent / "csrc" /
               "flash_attention.cu").read_text()
        tiles = re.findall(r"constexpr int kBlockQ = (\d+);", src)
        assert tiles == [str(registry.BLOCK_Q)]


def _offset(shape, dtype, by=1):
    """A packed (B,S,R) view that starts ``by`` elements into its buffer."""
    flat = torch.zeros(math.prod(shape) + by, dtype=dtype)
    return flat[by:].view(shape)


def _strided(shape, strides):
    return torch.zeros(4096).as_strided(shape, strides)


_PACKED = torch.zeros((2, 300, 2, 256))
_WIDE = torch.zeros((2, 8, 136))
# name -> (a, b, the route the wrapper must pick)
_ROUTE_CASES = {
    "f32 R=3840": (torch.zeros((2, 8, 3840)),) * 2 + ("tma",),
    "bf16 R=3840": (torch.zeros((2, 8, 3840), dtype=torch.bfloat16),) * 2
    + ("tma",),
    "f32 R=131": (torch.zeros((1, 64, 131)),) * 2 + ("generic",),
    "bf16 R=300": (torch.zeros((2, 10, 300), dtype=torch.bfloat16),) * 2
    + ("generic",),
    "f32 R=300": (torch.zeros((2, 10, 300)),) * 2 + ("tma",),
    "packed halves": (_PACKED[:, :, 0], _PACKED[:, :, 1], "tma"),
    "offset by one element": (_offset((2, 8, 64), torch.float32),
                              torch.zeros((2, 8, 64)), "generic"),
    "b offset by one element": (torch.zeros((2, 8, 64)),
                                _offset((2, 8, 64), torch.float32),
                                "generic"),
    "offset by 16 bytes": (_offset((2, 8, 64), torch.float32, by=4),) * 2
    + ("tma",),
    "batch stride 2052 bytes": (_strided((2, 8, 64), (513, 64, 1)),) * 2
    + ("generic",),
    "sequence stride 260 bytes": (_strided((2, 8, 64), (520, 65, 1)),) * 2
    + ("generic",),
    "size-1 dims of any stride": (_strided((1, 1, 64), (3, 5, 1)),) * 2
    + ("tma",),
    # a and b lie on the grid, but h is allocated packed with 131 channels
    "h rows of 524 bytes": (_WIDE[..., :131], _WIDE[..., :131], "generic"),
}


class TestRgLruRoutes:
    @pytest.mark.parametrize("case", list(_ROUTE_CASES))
    def test_route_rule(self, case):
        """The wrapper's pure rule: TMA takes 16-byte aligned tensors with
        batch and sequence strides in 16-byte multiples (a, b and the
        packed h); every other input takes the generic route."""
        a, b, want = _ROUTE_CASES[case]
        lru._check(a, b)
        assert lru.route(a, b) == want

    def test_size_one_dims_get_packed_strides(self):
        one = _strided((1, 1, 64), (3, 5, 1))
        assert lru._strides(one) == [64, 64]
        assert lru._strides(_PACKED[:, :, 1]) == [300 * 512, 512]

    def test_cpu_tensors_take_the_plain_version(self):
        a = torch.rand((2, 16, 8))
        before = (lru.launches, dict(lru.route_launches))
        torch.testing.assert_close(lru.rg_lru(a, a), lru.reference(a, a),
                                   rtol=0, atol=0)
        assert (lru.launches, lru.route_launches) == before

    def test_ring_tile_is_the_kernels(self):
        """The wrapper's and the tuner's ring constants are the source's."""
        src = (Path(lru.__file__).parent / "csrc" / "rg_lru.cu").read_text()
        consts = {name: re.findall(rf"constexpr int {name} = (\d+);", src)
                  for name in ("kTileBytes", "kBoxS", "kStages",
                               "kOutBoxes")}
        shipped = (lru.TILE_BYTES, lru.BOX_S, lru.STAGES, lru.OUT_BOXES)
        assert list(consts.values()) == [[str(v)] for v in shipped]
        assert tune_rg_lru.VARIANTS[0] == shipped
        assert tune_rg_lru.variant_source(shipped) == src
        other = tune_rg_lru.variant_source((128, 16, 5, 3))
        assert re.findall(r"constexpr int k(?:TileBytes|BoxS|Stages|"
                          r"OutBoxes) = (\d+);", other) == \
            ["128", "16", "5", "3"]


def test_build_dir_follows_the_shared_headers(tmp_path, monkeypatch):
    """An edited header rebuilds every kernel that may include it."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(nvcc, "_CSRC", tmp_path)
    lib = nvcc.KernelLibrary("k.cu", "libk.so", lambda _: None)
    first = lib.build_dir()
    assert lib.build_dir() == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert lib.build_dir() != first
