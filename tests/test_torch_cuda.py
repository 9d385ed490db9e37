"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA card (the kernel has no
CPU mode).  This file imports neither JAX nor the JAX package, so it
runs on a machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances are those of ``tests/test_kernels.py``: 2e-5 for float32;
2e-2 (attention) and 3e-2 (RG-LRU) for bfloat16.  Training through the
attention kernel (its autograd: the kernel forward, the plain vjp back)
is held to autograd of the plain attention with the same tolerances,
and a small f32 model's gradients to its plain path within 1e-4.  The
RG-LRU kernel trains the same way (the kernel forward, the plain scan's
vjp back), on both of its routes, and so does a small f32 hybrid.
Two ranks of one gloo group share the card: gloo's collectives on CUDA
tensors, DTensor's all-gather through ``launch.mesh``'s route, and
small f32 models on a (1, 2) mesh against their one-card plan within
1e-4, their kernel sites on local shards.  MoE training: autograd
through ``repro_torch::top_k`` equal to the CPU's, a small f32 MoE
model's gradients within 1e-4 of the CPU's, and a small bf16 one's
captured, donated train steps equal to eager ones bit for bit.  MoE
training on two ranks sharing the card: the MoE ops' gradients on CUDA
DTensors as on the CPU group, and a small bf16 MoE train step through
``plan.apply`` of its (1, 2) plan against one card's.  xLSTM: a
16-layer f32 model (two sLSTMs) on the card within 1e-4 of the CPU, and
a bf16 one's captured prefill and decode equal to eager bit for bit.
Whisper: the kernel non-causal at the encoder's 1500 frames, a small
f32 ``whisper_small`` (its encoder's non-causal site and its decoder's
causal one on the kernel) on the card within 1e-4 of the CPU, forward
and 8 decode steps against the encoder's output, and a bf16 one's
captured prefill and decode equal to eager bit for bit.  Training the
xLSTM and the frontend models: a small f32 one's loss, gradients and
AdamW step with remat on the card within 1e-4 of the CPU's (xLSTM at 16
layers, its time scans nested in the layer scan; whisper's non-causal
encoder site on the kernel), and a small bf16 one's captured, donated
train steps equal to eager ones bit for bit.
"""

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, registry
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


def assert_fa_close(q, k, v, causal):
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[q.dtype],
                               atol=TOL[q.dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,T,causal", [(256, 256, True), (256, 256, False),
                                        (200, 333, True), (333, 200, True),
                                        (1000, 1000, True),
                                        (257, 300, True), (257, 300, False),
                                        (300, 257, True), (1, 1, True),
                                        (1, 300, False), (1, 300, True),
                                        (300, 1, True)])
def test_kernel_matches_plain(gen, dtype, S, T, causal):
    assert_fa_close(*qkv(gen, 2, S, T, 4, 64, dtype), causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", sorted(range(16, 129, 16)))
def test_every_head_dim_family(gen, hd, dtype, causal):
    assert hd in registry.CUDA_HEAD_DIMS
    assert_fa_close(*qkv(gen, 1, 130, 257, 3, hd, dtype), causal)


def test_whisper_encoder_shape_non_causal(gen):
    """whisper_small's encoder at its 1500 frames, no multiple of the
    128-row tile: (2, 1500, 12, 64) bf16, non-causal."""
    assert_fa_close(*qkv(gen, 2, 1500, 1500, 12, 64, torch.bfloat16), False)


def test_slice_shape(gen):
    """qwen2_05b prefill: (4, 2048, 14, 64) bf16 causal."""
    assert_fa_close(*qkv(gen, 4, 2048, 2048, 14, 64, torch.bfloat16), True)


def test_arctic_shape(gen):
    """arctic_480b prefill: (4, 2048, 56, 128) bf16 causal, its k and v
    the 7-way GQA repeat of 8 heads, as its attention block makes them."""
    from repro_torch.models.layers import repeat_heads
    _, k, v = qkv(gen, 4, 2048, 2048, 8, 128, torch.bfloat16)
    q = torch.randn((4, 2048, 56, 128), generator=gen,
                    device="cuda").to(torch.bfloat16)
    assert_fa_close(q, repeat_heads(k, 7), repeat_heads(v, 7), True)


@pytest.mark.parametrize("hd", [64, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_strided_views(gen, dtype, hd):
    """q, k, v as views of one packed (B, S, 3, H, hd) projection."""
    packed = torch.randn((2, 190, 3, 4, hd), generator=gen,
                         device="cuda").to(dtype)
    assert_fa_close(packed[:, :, 0], packed[:, :, 1], packed[:, :, 2], True)


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
    before = fa.launches
    # bf16 tiles are TMA copies: 16-byte aligned, strides in 16 bytes
    for cut in (1, 4):
        packed = torch.zeros((1, 64, 2, 64 + cut), device="cuda",
                             dtype=torch.bfloat16)[..., cut:]
        with pytest.raises(ValueError, match="16 bytes"):
            fa.flash_attention(packed, packed, packed)
    assert fa.launches == before


def plain_grads(q, k, v, do, causal):
    """Autograd of the plain attention itself (einsum, softmax)."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = fa.reference(q, k, v, causal=causal)
    return out, torch.autograd.grad(out, (q, k, v), do)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,T,causal,hd", [(256, 256, True, 64),
                                           (200, 333, False, 64),
                                           (130, 130, True, 128),
                                           (64, 64, True, 16)])
def test_attention_trains_through_the_kernel(gen, dtype, S, T, causal, hd):
    q, k, v = (x.requires_grad_() for x in qkv(gen, 2, S, T, 4, hd, dtype))
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    launches, bwd = fa.launches, ops.bwd_calls
    with kernel_dispatch(KernelDispatch(default_impl="cuda")):
        out = ops.attention(q, k, v, causal=causal)
    got = torch.autograd.grad(out, (q, k, v), do)
    # the forward launched the kernel once; the backward ran the plain vjp
    assert fa.launches == launches + 1 and ops.bwd_calls == bwd + 1
    want_out, want = plain_grads(q, k, v, do, causal)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), want_out.float(), rtol=tol,
                               atol=tol)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.device.type == "cuda"
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


def test_small_model_gradients_through_the_kernel(gen):
    import dataclasses

    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as TS
    cfg = dataclasses.replace(get_config("qwen2_05b").reduced(),
                              use_pallas=True, remat=True)
    params = T.init_params(cfg, gen)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                              device="cuda", dtype=torch.int32)
             for k in ("targets", "tokens")}
    grads = TS.value_and_grad(TS.make_loss_fn(cfg), remat=True)
    before = fa.launches
    with kernel_dispatch(KernelDispatch(default_impl="cuda")):
        got = grads(params, batch)
    # each layer's forward and its recomputation
    assert fa.launches == before + 2 * cfg.num_layers
    with kernel_dispatch(KernelDispatch(default_impl="ref")):
        want = grads(params, batch)
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


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


def assert_lru_route(a, b, want):
    """The wrapper picks route ``want``, launches it once, and is right."""
    before = dict(lru.route_launches)
    assert lru.route(a, b) == want
    assert_lru_close(a, b)
    assert {r: n - before[r] for r, n in lru.route_launches.items()} == \
        {r: int(r == want) for r in lru.ROUTES}


@pytest.mark.parametrize("shape,dtype", [((4, 4096, 3840), torch.float32),
                                         ((4, 4096, 3840), torch.bfloat16),
                                         ((1, 4096, 3840), torch.float32)])
def test_rg_lru_tma_route_matches_plain(gen, shape, dtype):
    assert_lru_route(*lru_inputs(gen, shape, dtype), "tma")


@pytest.mark.parametrize("shape,dtype", [((1, 64, 131), torch.float32),
                                         ((1, 64, 131), torch.bfloat16),
                                         ((2, 1000, 300), torch.bfloat16)])
def test_rg_lru_generic_route_matches_plain(gen, shape, dtype):
    assert_lru_route(*lru_inputs(gen, shape, dtype), "generic")


def test_rg_lru_views_off_the_16_byte_grid_take_the_generic_route(gen):
    flat = torch.rand((2 * 300 * 256 + 1,), generator=gen, device="cuda")
    off = flat[1:].view(2, 300, 256)
    assert_lru_route(off, off, "generic")
    packed = torch.rand((2, 300, 2, 256), generator=gen, device="cuda")
    assert_lru_route(packed[:, :, 0], packed[:, :, 1], "tma")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rg_lru_generic_route_at_the_slice_shape(gen, dtype):
    """The generic route is right where the ring runs, and the two agree
    bit for bit: both run the same f32 chain in the same order."""
    a, b = lru_inputs(gen, (4, 4096, 3840), dtype)
    got = lru.launch(lru.build(), a, b, "generic")
    tol = LRU_TOL[dtype]
    torch.testing.assert_close(got.float(), lru.reference(a, b).float(),
                               rtol=tol, atol=tol)
    assert torch.equal(got, lru.launch(lru.build(), a, b, "tma"))


def test_rg_lru_tma_route_refuses_what_tma_cannot_take(gen):
    a, b = lru_inputs(gen, (1, 64, 131), torch.float32)
    before = dict(lru.route_launches)
    with pytest.raises(RuntimeError, match="tma route"):
        lru.launch(lru.build(), a, b, "tma")
    assert lru.route_launches == before


def plain_lru_grads(a, b, dh):
    a, b = (x.detach().requires_grad_() for x in (a, b))
    out = lru.reference(a, b)
    return out, torch.autograd.grad(out, (a, b), dh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,route,strided", [
    ((1, 4096, 3840), "tma", False), ((2, 1000, 256), "tma", False),
    ((2, 300, 131), "generic", True), ((1, 64, 131), "generic", False)])
def test_rg_lru_trains_through_the_kernel(gen, dtype, shape, route,
                                          strided):
    if strided:
        # a and b as the halves of one packed tensor: rows of 2 x 131
        # channels put the sequence stride off TMA's 16-byte grid
        packed = torch.rand((*shape[:2], 2, shape[2]), generator=gen,
                            device="cuda").to(dtype)
        a, b = packed[:, :, 0], packed[:, :, 1]
    else:
        a, b = lru_inputs(gen, shape, dtype)
    a, b = a.detach().requires_grad_(), b.detach().requires_grad_()
    assert lru.route(a, b) == route
    dh = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    before = dict(lru.route_launches)
    calls = ops.rg_lru_bwd_calls
    with kernel_dispatch(KernelDispatch(default_impl="cuda")):
        out = ops.rg_lru(a, b)
    got = torch.autograd.grad(out, (a, b), dh)
    # the forward launched the kernel once, on its route; the backward
    # ran the plain vjp
    assert {r: n - before[r] for r, n in lru.route_launches.items()} == \
        {r: int(r == route) for r in lru.ROUTES}
    assert ops.rg_lru_bwd_calls == calls + 1
    want_out, want = plain_lru_grads(a, b, dh)
    tol = LRU_TOL[dtype]
    torch.testing.assert_close(out.float(), want_out.float(), rtol=tol,
                               atol=tol)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.device.type == "cuda"
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


def test_small_hybrid_gradients_through_the_kernel(gen):
    import dataclasses

    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as TS
    # two periods of (rglru, rglru, local) and a tail of two RG-LRU blocks
    cfg = dataclasses.replace(get_config("recurrentgemma_2b").reduced(),
                              num_layers=8, use_pallas=True, remat=True)
    params = T.init_params(cfg, gen)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                              device="cuda", dtype=torch.int32)
             for k in ("targets", "tokens")}
    grads = TS.value_and_grad(TS.make_loss_fn(cfg), remat=True)
    before, calls = lru.launches, ops.rg_lru_bwd_calls
    with kernel_dispatch(KernelDispatch(default_impl="cuda")):
        got = grads(params, batch)
    # 2 x 2 in the scanned bodies and 2 in the tail forward, the bodies'
    # 4 again recomputed; one plain-vjp backward per forward site
    assert lru.launches == before + 10
    assert ops.rg_lru_bwd_calls == calls + 6
    with kernel_dispatch(KernelDispatch(default_impl="ref")):
        want = grads(params, batch)
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


# --- plan.apply captured as CUDA graphs ------------------------------------


def small_config(arch, dtype):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(), use_pallas=True,
                               param_dtype=dtype)


def prefill_plan(cfg, B, S):
    """The small model's prefill step and its one-device plan."""
    from repro_torch.api import Request, Session
    from repro_torch.core.cost_model import MeshSpec
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_prefill_step
    step = make_prefill_step(cfg)
    plan = Session(step, (T.param_specs(cfg), {"tokens": torch.empty(
        (B, S), dtype=torch.int32, device="meta")})).partition(
            Request(mesh=MeshSpec(("data", "model"), (1, 1))))
    return step, plan


def tokens(gen, cfg, B, S):
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                    device="cuda", dtype=torch.int32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,kernel", [("qwen2_05b", "flash_attention"),
                                         ("recurrentgemma_2b", "rg_lru")])
def test_captured_prefill_equals_eager_bit_for_bit(gen, arch, kernel, dtype):
    """Both kernels run inside a graph: the replay of the small prefill
    step equals its eager run exactly, request by request."""
    from repro_torch.models import transformer as T
    cfg = small_config(arch, dtype)
    step, plan = prefill_plan(cfg, 2, 64)
    params = T.init_params(cfg, gen)
    captured = plan.apply(step)
    eager = plan.apply(step, capture=False)
    assert captured.capture and not eager.capture
    for _ in range(3):
        batch = tokens(gen, cfg, 2, 64)
        got = captured(params, batch)
        want = eager(params, batch)
        assert got.dtype == cfg.dtype and got.shape == (2, cfg.vocab_size)
        assert torch.equal(got, want)
    assert captured.captures == 1 and captured.replays == 3
    (graph,) = captured.graphs
    sites = sum(k == ("attn" if kernel == "flash_attention" else "rglru")
                for k in cfg.pattern[:cfg.num_layers])
    assert sites > 0
    assert graph.launches[kernel] == graph.warmup_launches[kernel] == sites
    assert graph.pool_bytes > 0 and graph.seconds > 0


@pytest.mark.parametrize("arch", ["qwen2_05b", "recurrentgemma_2b"])
def test_captured_decode_equals_eager_for_16_steps(gen, arch):
    """8 prompt tokens and 8 greedy tokens through one captured decode
    graph: the same tokens, prompt logits and final cache as eager."""
    from repro_torch import pytree
    from repro_torch.core.cost_model import MeshSpec
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_decode_step
    cfg = small_config(arch, "float32")
    B, P, G, max_seq = 2, 8, 8, 32
    sess, names = serve.decode_session(cfg, B, max_seq)
    plan = sess.partition(serve.decode_request(
        cfg, names, MeshSpec(("data", "model"), (1, 1))))
    params = T.init_params(cfg, gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device="cuda", dtype=torch.int32)
    captured = plan.apply(make_decode_step(cfg))
    got = serve.serve_loop(captured, params, T.init_cache(cfg, B, max_seq),
                           prompts, G)
    want = serve.serve_loop(plan.apply(make_decode_step(cfg),
                                       capture=False),
                            params, T.init_cache(cfg, B, max_seq), prompts, G)
    assert captured.captures == 1 and captured.replays == P + G - 1
    assert not any(captured.graphs[0].launches.values())
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.prompt_logits, want.prompt_logits)
    for a, b in zip(pytree.tree_leaves(got.cache),
                    pytree.tree_leaves(want.cache)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "arctic_480b"])
def test_captured_moe_prefill_and_decode_equal_eager(gen, arch):
    """A small bf16 MoE model (batch dispatch, capacity factor 1.0, so
    tokens drop) inside a graph: prefill replays equal eager exactly
    (arctic's attention sites on the kernel), and so does decode, 8
    prompt tokens and 8 greedy tokens."""
    import dataclasses

    from repro_torch import pytree
    from repro_torch.core.cost_model import MeshSpec
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_decode_step
    cfg = dataclasses.replace(small_config(arch, "bfloat16"),
                              moe_capacity_factor=1.0)
    step, plan = prefill_plan(cfg, 2, 64)
    params = T.init_params(cfg, gen)
    captured = plan.apply(step)
    eager = plan.apply(step, capture=False)
    for _ in range(3):
        batch = tokens(gen, cfg, 2, 64)
        assert torch.equal(captured(params, batch), eager(params, batch))
    (graph,) = captured.graphs
    sites = cfg.num_layers if arch == "arctic_480b" else 0
    assert graph.launches["flash_attention"] == sites
    B, P, G, max_seq = 2, 8, 8, 32
    sess, names = serve.decode_session(cfg, B, max_seq)
    dplan = sess.partition(serve.decode_request(
        cfg, names, MeshSpec(("data", "model"), (1, 1))))
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device="cuda", dtype=torch.int32)
    dec = dplan.apply(make_decode_step(cfg))
    got = serve.serve_loop(dec, params, T.init_cache(cfg, B, max_seq),
                           prompts, G)
    want = serve.serve_loop(dplan.apply(make_decode_step(cfg),
                                        capture=False),
                            params, T.init_cache(cfg, B, max_seq), prompts, G)
    assert dec.captures == 1 and dec.replays == P + G - 1
    assert torch.equal(got.tokens, want.tokens)
    for a, b in zip(pytree.tree_leaves(got.cache),
                    pytree.tree_leaves(want.cache)):
        assert torch.equal(a, b)


def small_xlstm(dtype):
    """The reduced xLSTM at 16 layers: two scanned super-blocks, each
    with an sLSTM whose time scan runs inside the layer scan."""
    import dataclasses
    return dataclasses.replace(small_config("xlstm_350m", dtype),
                               num_layers=16)


def test_small_xlstm_on_the_card_as_on_the_cpu(gen):
    """The 16-layer f32 xLSTM: forward logits and 8 decode steps' logits
    and caches on the card within 1e-4 of the same model on the CPU."""
    from repro_torch import pytree
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_decode_step
    cfg = small_xlstm("float32")
    params = T.init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 48), generator=gen,
                         device="cuda", dtype=torch.int32)
    host = pytree.tree_map(lambda x: x.cpu(), params)
    torch.testing.assert_close(T.forward(cfg, params, toks).cpu(),
                               T.forward(cfg, host, toks.cpu()),
                               rtol=1e-4, atol=1e-4)
    dec = make_decode_step(cfg)
    cache, hcache = T.init_cache(cfg, 2, 8), T.init_cache(cfg, 2, 8, "cpu")
    for t in range(8):
        pos = torch.tensor(t, dtype=torch.int32)
        got, cache = dec(params, cache, toks[:, t:t + 1], pos.cuda())
        want, hcache = dec(host, hcache, toks[:, t:t + 1].cpu(), pos)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for a, b in zip(pytree.tree_leaves(cache), pytree.tree_leaves(hcache)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def test_captured_xlstm_prefill_and_decode_equal_eager(gen):
    """The 16-layer bf16 xLSTM inside a graph (the sLSTM's time loop
    captured step by step): prefill replays equal eager exactly, and so
    does decode, 8 prompt tokens and 8 greedy tokens; no kernel site."""
    from repro_torch import pytree
    from repro_torch.core.cost_model import MeshSpec
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_decode_step
    cfg = small_xlstm("bfloat16")
    step, plan = prefill_plan(cfg, 2, 64)
    assert not plan.kernel_sites
    params = T.init_params(cfg, gen)
    captured = plan.apply(step)
    eager = plan.apply(step, capture=False)
    for _ in range(3):
        batch = tokens(gen, cfg, 2, 64)
        assert torch.equal(captured(params, batch), eager(params, batch))
    assert captured.captures == 1 and captured.replays == 3
    assert not any(captured.graphs[0].launches.values())
    B, P, G, max_seq = 2, 8, 8, 32
    sess, names = serve.decode_session(cfg, B, max_seq)
    dplan = sess.partition(serve.decode_request(
        cfg, names, MeshSpec(("data", "model"), (1, 1))))
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device="cuda", dtype=torch.int32)
    dec = dplan.apply(make_decode_step(cfg))
    got = serve.serve_loop(dec, params, T.init_cache(cfg, B, max_seq),
                           prompts, G)
    want = serve.serve_loop(dplan.apply(make_decode_step(cfg),
                                        capture=False),
                            params, T.init_cache(cfg, B, max_seq), prompts, G)
    assert dec.captures == 1 and dec.replays == P + G - 1
    assert torch.equal(got.tokens, want.tokens)
    for a, b in zip(pytree.tree_leaves(got.cache),
                    pytree.tree_leaves(want.cache)):
        assert torch.equal(a, b)


def whisper_inputs(gen, cfg, B, S, S_enc):
    return {"frames": torch.randn((B, S_enc, cfg.d_model), generator=gen,
                                  device="cuda"),
            "tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                    device="cuda", dtype=torch.int32)}


def test_small_whisper_on_the_card_as_on_the_cpu(gen):
    """The reduced f32 whisper (2 encoder, 4 decoder layers), its sites on
    the kernel on the card and on the plain version on the CPU: forward
    logits, the encoder's output, and 8 decode steps' logits and caches
    against the encoder's output within 1e-4."""
    import dataclasses

    from repro_torch import pytree
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_decode_step
    cfg = dataclasses.replace(small_config("whisper_small", "float32"),
                              num_layers=4)
    params = T.init_params(cfg, gen)
    host = pytree.tree_map(lambda x: x.cpu(), params)
    batch = whisper_inputs(gen, cfg, 2, 48, 150)
    hbatch = pytree.tree_map(lambda x: x.cpu(), batch)
    before = fa.launches
    with kernel_dispatch(KernelDispatch(default_impl="cuda")):
        got = T.forward(cfg, params, batch["tokens"],
                        frames=batch["frames"])
        enc = T.encode(cfg, params, batch["frames"])
    assert fa.launches - before == cfg.encoder_layers * 2 + cfg.num_layers
    want = T.forward(cfg, host, hbatch["tokens"], frames=hbatch["frames"])
    henc = T.encode(cfg, host, hbatch["frames"])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(enc.cpu(), henc, rtol=1e-4, atol=1e-4)
    dec = make_decode_step(cfg)
    cache, hcache = T.init_cache(cfg, 2, 8), T.init_cache(cfg, 2, 8, "cpu")
    toks = batch["tokens"]
    for t in range(8):
        pos = torch.tensor(t, dtype=torch.int32)
        out, cache = dec(params, cache, toks[:, t:t + 1], pos.cuda(), enc)
        hout, hcache = dec(host, hcache, toks[:, t:t + 1].cpu(), pos, henc)
        torch.testing.assert_close(out.cpu(), hout, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(out[:, 0].cpu(), want[:, t], rtol=1e-4,
                                   atol=1e-4)
    for a, b in zip(pytree.tree_leaves(cache), pytree.tree_leaves(hcache)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def test_captured_whisper_prefill_and_decode_equal_eager(gen):
    """The reduced bf16 whisper through its one-device plans: prefill (the
    encoder's non-causal site and the decoder's causal one on the kernel)
    replays equal eager exactly, and so does decode against the encoder's
    output, 8 prompt tokens and 8 greedy tokens."""
    from repro_torch import pytree
    from repro_torch.api import Request, Session
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.cost_model import MeshSpec
    from repro_torch.launch import serve, specs
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_decode_step
    cfg = small_config("whisper_small", "bfloat16")
    step, args, _ = specs.step_and_inputs(cfg, ShapeConfig("s", 300, 2,
                                                           "prefill"))
    plan = Session(step, args).partition(
        Request(mesh=MeshSpec(("data", "model"), (1, 1))))
    assert [(r["site"], r["impl"]) for r in plan.kernel_sites] == \
        [("flash_attention:0", "cuda"), ("flash_attention:1", "cuda")]
    params = T.init_params(cfg, gen)
    captured = plan.apply(step)
    eager = plan.apply(step, capture=False)
    for _ in range(3):
        batch = whisper_inputs(gen, cfg, 2, 150, 150)
        assert torch.equal(captured(params, batch), eager(params, batch))
    assert captured.captures == 1 and captured.replays == 3
    assert captured.graphs[0].launches["flash_attention"] == \
        cfg.encoder_layers + cfg.num_layers
    B, P, G, max_seq = 2, 8, 8, 32
    enc = T.encode(cfg, params, batch["frames"])
    sess, names = serve.decode_session(cfg, B, max_seq)
    dplan = sess.partition(serve.decode_request(
        cfg, names, MeshSpec(("data", "model"), (1, 1))))
    prompts = batch["tokens"][:, :P]
    dec = dplan.apply(make_decode_step(cfg))
    got = serve.serve_loop(dec, params, T.init_cache(cfg, B, max_seq),
                           prompts, G, enc)
    want = serve.serve_loop(dplan.apply(make_decode_step(cfg),
                                        capture=False),
                            params, T.init_cache(cfg, B, max_seq), prompts,
                            G, enc)
    assert dec.captures == 1 and dec.replays == P + G - 1
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.prompt_logits, want.prompt_logits)
    for a, b in zip(pytree.tree_leaves(got.cache),
                    pytree.tree_leaves(want.cache)):
        assert torch.equal(a, b)


def test_top_k_breaks_ties_as_on_the_cpu(gen):
    """``layers.top_k`` on the card: values from a set of 4 (rows full of
    ties) and a capacity selection of exact zeros give the indices the
    CPU gives, lower index first among equals, inside a graph too."""
    from repro_torch.models.layers import top_k
    x = torch.randint(0, 4, (8, 128, 2048), generator=gen,
                      device="cuda").float()
    x[:, :, ::7] = 0.5
    for k in (2, 640, 2048):
        values, indices = top_k(x, k)
        cpu_values, cpu_indices = top_k(x.cpu(), k)
        assert torch.equal(values.cpu(), cpu_values)
        assert torch.equal(indices.cpu(), cpu_indices)
    graph = torch.cuda.CUDAGraph()
    out = top_k(x, 640)                        # warm-up on the stream
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        out = top_k(x, 640)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[1].cpu(), top_k(x.cpu(), 640)[1])


def test_top_k_trains_as_on_the_cpu(gen):
    """Autograd through ``repro_torch::top_k`` on the card: the values'
    cotangent lands where the CPU puts it (ties broken alike), the
    indices take none; the router's top-2 of 8 and a capacity selection
    of 1,280 over 4,096 tokens."""
    from repro_torch.models.layers import top_k
    for shape, k in (((1, 4096, 8), 2), ((1, 8, 4096), 1280)):
        x = torch.randint(0, 4, shape, generator=gen, device="cuda").float()
        ct = torch.randn((*shape[:-1], k), generator=gen, device="cuda")
        xs = [x.clone().requires_grad_(), x.cpu().requires_grad_()]
        grads = [torch.autograd.grad(top_k(a, k)[0], a, c)[0]
                 for a, c in zip(xs, (ct, ct.cpu()))]
        assert torch.equal(grads[0].cpu(), grads[1])
        assert not top_k(xs[0], k)[1].requires_grad


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "arctic_480b"])
def test_small_moe_gradients_as_on_the_cpu(gen, arch):
    """A small f32 MoE model with remat, capacity factor 1.0 (tokens
    drop): loss and every gradient on the card within 1e-4 of the CPU's
    (arctic's attention sites on the kernel there, the plain version
    here)."""
    import dataclasses

    from repro_torch import pytree
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import KernelDispatch, kernel_dispatch
    from repro_torch.train import steps as TS
    cfg = dataclasses.replace(small_config(arch, "float32"), remat=True,
                              moe_capacity_factor=1.0)
    params = T.init_params(cfg, gen)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "targets")}
    grads = TS.value_and_grad(TS.make_loss_fn(cfg), remat=True)
    with kernel_dispatch(KernelDispatch(default_impl="cuda")):
        got = grads(params, batch)
    want = grads(pytree.tree_map(lambda x: x.cpu(), params),
                 pytree.tree_map(lambda x: x.cpu(), batch))
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "arctic_480b"])
def test_captured_donated_moe_train_steps_equal_eager(gen, arch):
    """A small bf16 MoE model's train step (remat, capacity factor 1.0)
    through one graph with its state donated: 4 steps' metrics and the
    final state equal 4 eager steps exactly."""
    from repro_torch import pytree
    cfg, opt, step, plan = train_setup(arch, "bfloat16",
                                       moe_capacity_factor=1.0)
    captured = plan.apply(step, donate_argnums=0)
    eager = plan.apply(step, capture=False)
    state, want = train_state(cfg, opt), train_state(cfg, opt)
    for batch in train_batches(gen, cfg, 4):
        state, metrics = captured(state, batch)
        want, want_metrics = eager(want, batch)
        for k in ("loss", "ce", "grad_norm", "step"):
            assert torch.equal(metrics[k], want_metrics[k]), k
    assert captured.captures == 1 and captured.replays == 4
    for a, b in zip(pytree.tree_leaves(state), pytree.tree_leaves(want)):
        assert torch.equal(a, b)
    (graph,) = captured.graphs
    sites = 2 * cfg.num_layers if arch == "arctic_480b" else 0
    assert graph.launches["flash_attention"] == sites


def test_a_kept_result_is_not_overwritten_by_the_next_call(gen):
    from repro_torch.models import transformer as T
    cfg = small_config("qwen2_05b", "float32")
    step, plan = prefill_plan(cfg, 2, 64)
    params = T.init_params(cfg, gen)
    applied = plan.apply(step)
    first = applied(params, tokens(gen, cfg, 2, 64))
    kept = first.clone()
    second = applied(params, tokens(gen, cfg, 2, 64))
    assert torch.equal(first, kept) and not torch.equal(first, second)
    assert first.data_ptr() not in [o.data_ptr()
                                    for o in applied.graphs[0].outputs]


def test_a_new_shape_makes_a_second_capture(gen):
    from repro_torch.models import transformer as T
    cfg = small_config("qwen2_05b", "float32")
    step, plan = prefill_plan(cfg, 2, 64)
    params = T.init_params(cfg, gen)
    applied = plan.apply(step)
    eager = plan.apply(step, capture=False)
    for S in (64, 32, 64, 32):
        batch = tokens(gen, cfg, 2, S)
        assert torch.equal(applied(params, batch), eager(params, batch))
    assert applied.captures == 2 and len(applied.graphs) == 2
    assert [g.replays for g in applied.graphs] == [2, 2]


def test_a_moved_input_is_copied_and_an_unchanged_parameter_is_not(gen):
    """The parameters (the first argument) are read in place while the
    caller passes the same tensors; the other leaves are copied into the
    plan's buffers; no caller's tensor is written.  A parameter that
    arrives as another tensor is copied from then on (one new capture)."""
    from repro_torch.api import Request, Session
    from repro_torch.core.cost_model import MeshSpec

    def step(p, x):
        return torch.tanh(x @ p["w"]) + p["b"]

    plan = Session(step, ({"w": torch.empty((32, 16), device="meta"),
                           "b": torch.empty((16,), device="meta")},
                          torch.empty((8, 32), device="meta"))).partition(
        Request(mesh=MeshSpec(("data", "model"), (1, 1)), min_dims=1,
                backend="greedy"))
    params = {"b": torch.randn((16,), generator=gen, device="cuda"),
              "w": torch.randn((32, 16), generator=gen, device="cuda")}
    applied = plan.apply(step)
    xs = [torch.randn((8, 32), generator=gen, device="cuda")
          for _ in range(3)]
    versions = [t._version for t in (*params.values(), *xs)]
    for x in xs:
        assert torch.equal(applied(params, x), step(params, x))
    (graph,) = applied.graphs
    # flattening order: b, w, x
    assert graph.held == [True, True, False]
    assert graph.inputs[0] is params["b"] and graph.inputs[1] is params["w"]
    assert graph.inputs[2].data_ptr() not in [x.data_ptr() for x in xs]
    assert graph.inputs[2]._version >= len(xs)       # copied into, each call
    assert [t._version for t in (*params.values(), *xs)] == versions
    moved = {"b": params["b"], "w": params["w"].clone()}
    assert torch.equal(applied(moved, xs[0]), step(moved, xs[0]))
    assert applied.captures == 2
    assert applied.graphs[0].held == [True, False, False]
    moved["w"].mul_(2.0)                              # copied, not held
    assert torch.equal(applied(moved, xs[1]), step(moved, xs[1]))
    assert applied.captures == 2


def test_release_returns_the_pool_memory(gen):
    from repro_torch.models import transformer as T
    cfg = small_config("recurrentgemma_2b", "float32")
    step, plan = prefill_plan(cfg, 2, 64)
    params = T.init_params(cfg, gen)
    applied = plan.apply(step)
    applied(params, tokens(gen, cfg, 2, 64))
    (graph,) = applied.graphs
    pool = graph.pool_bytes
    assert pool > 0
    del graph
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    applied.release()
    torch.cuda.empty_cache()
    assert applied.graphs == [] and not applied._cache
    assert held - torch.cuda.memory_reserved() >= pool


# --- train steps captured with their state donated --------------------------


def train_setup(arch, dtype, **fields):
    """A small remat model's train step, its optimizer and its 1x1 plan
    (batch 2 x 32)."""
    import dataclasses

    from repro_torch.api import Request, Session
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.cost_model import MeshSpec
    from repro_torch.launch import specs
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train import steps as TS
    cfg = dataclasses.replace(small_config(arch, dtype), remat=True,
                              **fields)
    opt = AdamConfig(lr=1e-3, warmup_steps=2, total_steps=4)
    step = TS.make_train_step(cfg, opt)
    bspec, _ = specs.batch_specs(cfg, ShapeConfig("t", 32, 2, "train"))
    plan = Session(step, (TS.train_state_specs(cfg, opt), bspec)).partition(
        Request(mesh=MeshSpec(("data", "model"), (1, 1))))
    return cfg, opt, step, plan


def train_state(cfg, opt, seed=1):
    from repro_torch.train import steps as TS
    return TS.init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(seed), opt)


def train_batches(gen, cfg, n):
    return [{k: torch.randint(0, cfg.vocab_size, (2, 32), generator=gen,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "targets")} for _ in range(n)]


@pytest.mark.parametrize("via", ["plan", "jit"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,kernel", [("qwen2_05b", "flash_attention"),
                                         ("recurrentgemma_2b", "rg_lru")])
def test_captured_donated_train_steps_equal_eager(gen, arch, kernel, dtype,
                                                  via):
    """4 steps through one graph whose state is donated: every metric and
    the final state equal 4 eager steps exactly, and the state comes back
    as the caller's own tensors, written in place."""
    from repro_torch import pytree
    from repro_torch.jit import jit
    cfg, opt, step, plan = train_setup(arch, dtype)
    if via == "plan":
        captured = plan.apply(step, donate_argnums=0)
        eager = plan.apply(step, capture=False)
    else:
        captured = jit(step, donate_argnums=0)
        eager = jit(step, capture=False)
    state, want = train_state(cfg, opt), train_state(cfg, opt)
    mine = pytree.tree_leaves(state)
    for batch in train_batches(gen, cfg, 4):
        state, metrics = captured(state, batch)
        want, want_metrics = eager(want, batch)
        for k in ("loss", "ce", "grad_norm", "step"):
            assert torch.equal(metrics[k], want_metrics[k]), k
    assert captured.captures == 1 and captured.replays == 4
    got = pytree.tree_leaves(state)
    assert all(a is b for a, b in zip(got, mine))
    for a, b in zip(got, pytree.tree_leaves(want)):
        assert torch.equal(a, b)
    (graph,) = captured.graphs
    for k in (kernel, kernel + "_bwd"):
        assert graph.launches[k] == graph.warmup_launches[k] > 0
    assert len(graph.pairs) == len(got)


def test_donation_holds_one_train_state_less_and_release_frees_it(gen):
    """After 4 captured steps, the card holds one train state less with
    the state donated than without (where each call returns a copy, and
    the copy passed back is copied into the step's own buffers); and
    ``release()`` returns the graph's pool."""
    from repro_torch import pytree
    cfg, opt, step, plan = train_setup("qwen2_05b", "float32",
                                       vocab_size=32768, d_model=256)
    batches = train_batches(gen, cfg, 4)

    def reserved():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    def run(donate):
        base = reserved()
        state = train_state(cfg, opt)
        applied = plan.apply(step, donate_argnums=donate)
        for batch in batches:
            state, _ = applied(state, batch)
        return applied, state, reserved() - base

    nbytes = sum(x.numel() * x.element_size()
                 for x in pytree.tree_leaves(train_state(cfg, opt)))
    assert nbytes > 100e6
    kept, kept_state, kept_bytes = run(())
    assert kept.captures == 2                  # the returned state moved
    kept.release()
    del kept, kept_state
    donated, state, donated_bytes = run(0)
    assert donated.captures == 1
    assert donated_bytes < kept_bytes - nbytes // 2
    (graph,) = donated.graphs
    pool_id = tuple(graph.graph.pool())

    def pool_segments():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return [s["total_size"] for s in torch.cuda.memory_snapshot()
                if tuple(s.get("segment_pool_id", ())) == pool_id]

    held = pool_segments()
    assert sum(held) > 0, (graph.pool_bytes, held)
    del graph
    donated.release()
    assert donated.graphs == [] and pool_segments() == []


# --- two ranks sharing the card over gloo -----------------------------------

COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor",
               "all_reduce", "all_to_all_single")


def probe_rank(rank):
    """Each collective DTensor issues, on CUDA tensors of card 0, over
    gloo: ``"ok"`` when its result is right, else the error."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    n = dist.get_world_size()
    iota = torch.arange(8, dtype=torch.float32, device="cuda")
    x = iota + 8 * rank                   # this rank's 8 values
    whole = torch.arange(8 * n, dtype=torch.float32, device="cuda")
    half = 8 // n

    def run(name):
        if name == "all_gather_into_tensor":
            out = torch.empty(8 * n, device="cuda")
            dist.all_gather_into_tensor(out, x)
            return out, whole
        if name == "reduce_scatter_tensor":
            out = torch.empty(8, device="cuda")
            dist.reduce_scatter_tensor(out, whole)
            return out, n * whole.view(n, 8)[rank]
        if name == "all_reduce":
            out = x.clone()
            dist.all_reduce(out)
            return out, sum(iota + 8 * r for r in range(n))
        out = torch.empty(8, device="cuda")
        dist.all_to_all_single(out, x)
        return out, torch.cat([iota[rank * half:(rank + 1) * half] + 8 * r
                               for r in range(n)])

    res = {}
    for name in COLLECTIVES:
        try:
            got, want = run(name)
            torch.cuda.synchronize()
            res[name] = "ok" if torch.equal(got, want) else \
                f"wrong result {got.tolist()}"
        except RuntimeError as err:
            res[name] = f"{type(err).__name__}: {err}"
    return res


@pytest.fixture(scope="module")
def probe():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: two ranks share card 0")
    from repro_torch.launch.mesh import run_ranks
    return run_ranks(probe_rank, 2, timeout=120)


@pytest.mark.parametrize("name", COLLECTIVES)
def test_gloo_collective_on_cuda_tensors(probe, name):
    """The collectives DTensor lowers a redistribution to, run by gloo on
    CUDA tensors (through host copies) with two ranks on one card."""
    for rank, res in enumerate(probe):
        assert res[name] == "ok", (rank, res[name])


def functional_gather_rank(rank, routed):
    """DTensor's all-gather op on CUDA tensors of card 0 over gloo, with
    or without ``launch.mesh.route_gloo_all_gather``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import route_gloo_all_gather
    torch.cuda.set_device(0)
    if routed:
        route_gloo_all_gather()
    x = torch.arange(4, dtype=torch.float32, device="cuda") + 4 * rank
    out = torch.ops._c10d_functional.all_gather_into_tensor(
        x, 2, dist.group.WORLD.group_name)
    return torch.ops._c10d_functional.wait_tensor(out).cpu()


def test_functional_all_gather_on_cuda_takes_the_route(gen):
    """Through the route the functional all-gather is right; without it
    the rank dies of a segmentation fault in gloo's coalesced all-gather
    (torch 2.11): the defect the route avoids, pinned so that a torch
    that repairs it shows here."""
    from repro_torch.launch.mesh import run_ranks
    for got in run_ranks(functional_gather_rank, 2, True, timeout=120):
        assert torch.equal(got, torch.arange(8, dtype=torch.float32))
    with pytest.raises(RuntimeError, match="exited with code -11"):
        run_ranks(functional_gather_rank, 2, False, timeout=120)


def small_mesh_rank(rank, arch, plan_json):
    """The small f32 model's prefill on the (1, 2) plan, on card 0."""
    from repro_torch.core.partitioner import ShardingPlan
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_prefill_step
    cfg = small_config(arch, "float32")
    applied = ShardingPlan.from_json(plan_json).apply(make_prefill_step(cfg))
    g = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, g)
    batch = tokens(g, cfg, 2, 64)
    before = ops.launch_counts()
    ops.local_calls.clear()
    out = applied(params, batch).full_tensor().cpu()
    after = ops.launch_counts()
    return {"logits": out,
            "launches": {k: after[k] - before[k] for k in after},
            "local_calls": dict(ops.local_calls),
            "copies": ops.site_copies}


@pytest.mark.parametrize("arch,kernel", [("qwen2_05b", "flash_attention"),
                                         ("recurrentgemma_2b", "rg_lru")])
def test_small_prefill_on_two_ranks_equals_one_card(gen, arch, kernel):
    """Two ranks share the card on a (1, 2) mesh: the kernel sites run on
    local shards under ``local_map`` and the gathered logits equal the
    one-card plan's within 1e-4."""
    from repro_torch.api import Request, Session
    from repro_torch.core.cost_model import MeshSpec
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import transformer as T
    cfg = small_config(arch, "float32")
    step, plan1 = prefill_plan(cfg, 2, 64)
    sess = Session(step, (T.param_specs(cfg), {"tokens": torch.empty(
        (2, 64), dtype=torch.int32, device="meta")}))
    plan2 = sess.partition(Request(mesh=MeshSpec(("data", "model"), (1, 2))))
    sharded = [r for r in plan2.kernel_sites if r["sharded"]]
    assert sharded and all(r["impl"] == "cuda" for r in plan2.kernel_sites)
    (fa if kernel == "flash_attention" else lru).build()   # ranks load it
    ranks = run_ranks(small_mesh_rank, 2, arch, plan2.to_json(), timeout=300)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, g)
    want = plan1.apply(step)(params, tokens(g, cfg, 2, 64)).cpu()
    sites = sum(k == ("attn" if kernel == "flash_attention" else "rglru")
                for k in cfg.pattern[:cfg.num_layers])
    spec = sharded[0]["in_specs"][0]
    glob = (2, 64, cfg.num_heads, cfg.resolved_head_dim) \
        if kernel == "flash_attention" else (2, 64, cfg.d_model * 3 // 2)
    local = tuple(g // 2 if e is not None else g for g, e in zip(glob, spec))
    for r in ranks:
        torch.testing.assert_close(r["logits"], want, rtol=1e-4, atol=1e-4)
        assert r["launches"][kernel] == sites and r["copies"] == 0
        assert r["local_calls"]
        for (k, impl, shapes, _), n in r["local_calls"].items():
            assert (k, impl, shapes[0]) == (kernel, "cuda", local)


# --- the launchers on two ranks sharing the card -----------------------------


def launcher_argv(ckpt_dir, *extra):
    return ["--arch", "qwen2_05b", "--steps", "4", "--batch", "2", "--seq",
            "64", "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "2", *extra]


def small_train_config():
    import dataclasses
    return dataclasses.replace(small_config("qwen2_05b", "float32"),
                               remat=True)


def mesh_launcher_rank(rank, ckpt_dir):
    """The small model through the launcher on (1, 2), a failure at step
    3 and a restart; then a capture asked of a step on DTensors."""
    from repro_torch import pytree
    from repro_torch.jit import jit
    from repro_torch.launch import train as launcher
    fa.launches = 0
    attempts = launcher.supervise(small_train_config(), launcher.parse_args(
        launcher_argv(ckpt_dir, "--fail-at", "3")))
    state = attempts[-1].state
    try:
        jit(lambda s: s, "cuda", capture=True)(state)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"starts": [a.start_step for a in attempts],
            "launches": fa.launches, "refused": refused,
            "state": [x.full_tensor().cpu()
                      for x in pytree.tree_leaves(state)]}


def test_the_launcher_restarts_on_two_ranks_as_one_card(gen, tmp_path):
    """The train launcher on two ranks sharing the card (CUDA tensors over
    gloo; autograd's backward, and remat's recomputation, on its own
    thread under the forward's rules): a restart from step 2, every
    attention site on the kernel, the final state within 1e-4 of one
    card's uninterrupted run; a step on DTensors refuses a capture."""
    from repro_torch import pytree
    from repro_torch.launch import train as launcher
    from repro_torch.launch.mesh import run_ranks
    fa.build()
    (one,) = launcher.supervise(small_train_config(), launcher.parse_args(
        launcher_argv(tmp_path / "one")))
    ranks = run_ranks(mesh_launcher_rank, 2, tmp_path / "two", timeout=300)
    cfg = small_train_config()
    # 3 + 2 steps, each the forward's sites and their recomputation
    sites = 2 * sum(k == "attn" for k in cfg.pattern[:cfg.num_layers])
    for r in ranks:
        assert r["starts"] == [0, 2] and r["launches"] == 5 * sites
        assert "eagerly" in r["refused"]
        for a, b in zip(r["state"], pytree.tree_leaves(one.state)):
            torch.testing.assert_close(a, b.cpu(), rtol=1e-4, atol=1e-4)


def mesh_serve_rank(rank, arch):
    from repro_torch.launch import serve as server
    res = server.serve(server.parse_args(
        ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "4",
         "--gen", "4", "--plan", "toast"]))
    return res.tokens.full_tensor().cpu(), \
        res.prompt_logits.full_tensor().cpu()


@pytest.mark.parametrize("arch", ["qwen2_05b", "recurrentgemma_2b"])
def test_two_ranks_serve_as_one_card(gen, arch):
    """The serving launcher on two ranks sharing the card: the decode
    step's cache writes and attention einsums run per shard (torch 2.11's
    DTensor has no rule for them); tokens equal one card's, prompt logits
    within 1e-4."""
    from repro_torch.launch import serve as server
    from repro_torch.launch.mesh import run_ranks
    want = server.serve(server.parse_args(
        ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "4",
         "--gen", "4", "--plan", "manual"]))
    for tokens_, logits in run_ranks(mesh_serve_rank, 2, arch, timeout=300):
        assert torch.equal(tokens_, want.tokens.cpu())
        torch.testing.assert_close(logits, want.prompt_logits.cpu(),
                                   rtol=1e-4, atol=1e-4)


# --- MoE on two ranks sharing the card ---------------------------------------


def moe_ops_rank(rank):
    """The MoE ops on CUDA DTensors of a (1, 2) mesh over gloo."""
    from test_torch_moe_mesh import check_ops

    from repro_torch.launch.mesh import compat_make_mesh
    return check_ops(compat_make_mesh((1, 2), ("data", "model"), "cuda"))


def test_moe_ops_on_cuda_dtensors(gen):
    """``top_k`` with ties (indices exact), the dispatch gather (exact)
    and the combine (1e-6) with the index sharded on the expert dim and
    on the batch, and the expert products with ``f`` sharded, on CUDA
    DTensors of two ranks sharing the card: as on the CPU group
    (``tests/test_torch_moe_mesh.py``), placements included."""
    from test_torch_moe_mesh import OP_TOL

    from repro_torch.launch.mesh import run_ranks
    for ops_ in run_ranks(moe_ops_rank, 2, timeout=300):
        for name, (err, exact, placements) in ops_.items():
            if name.startswith(("top_k", "gather")):
                assert exact, (name, err)
            assert err <= OP_TOL, (name, err)
            want = "Partial(sum)" if name in (
                "combine experts", "einsum f contracted") else \
                "Replicate()" if name == "top_k last" else "Shard"
            assert all(want in p for p in placements), (name, placements)


def small_moe_mesh_rank(rank, arch, plan_json):
    """The small bf16 MoE model's prefill on the (1, 2) plan, on card 0:
    the gathered logits and the attention launches."""
    from repro_torch.core.partitioner import ShardingPlan
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_prefill_step
    cfg = small_config(arch, "bfloat16")
    applied = ShardingPlan.from_json(plan_json).apply(make_prefill_step(cfg))
    g = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, g)
    batch = tokens(g, cfg, 2, 64)
    fa.launches = 0
    out = applied(params, batch).full_tensor().float().cpu()
    return {"logits": out, "launches": fa.launches}


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "arctic_480b"])
def test_small_moe_prefill_on_two_ranks_equals_one_card(gen, arch):
    """A small bf16 MoE prefill (batch dispatch) on the (1, 2) plan over
    two ranks sharing the card: the gathered logits within 2e-2 of the
    largest of one card's 1x1 plan; arctic's attention sites on the
    kernel on each rank."""
    from repro_torch.api import Request, Session
    from repro_torch.core.cost_model import MeshSpec
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import transformer as T
    cfg = small_config(arch, "bfloat16")
    step, plan1 = prefill_plan(cfg, 2, 64)
    plan2 = Session(step, (T.param_specs(cfg), {"tokens": torch.empty(
        (2, 64), dtype=torch.int32, device="meta")})).partition(
            Request(mesh=MeshSpec(("data", "model"), (1, 2))))
    fa.build()                                  # the ranks load it
    ranks = run_ranks(small_moe_mesh_rank, 2, arch, plan2.to_json(),
                      timeout=300)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, g)
    want = plan1.apply(step, capture=False)(
        params, tokens(g, cfg, 2, 64)).float().cpu()
    sites = cfg.num_layers if arch == "arctic_480b" else 0
    for r in ranks:
        rel = ((r["logits"] - want).abs().max() / want.abs().max()).item()
        assert rel <= 2e-2, rel
        assert r["launches"] == sites


# --- MoE training on two ranks sharing the card ----------------------------


def moe_grads_rank(rank):
    """The MoE ops' gradient cases on CUDA DTensors of a (1, 2) mesh."""
    from test_torch_moe_mesh_train import op_cases

    from repro_torch.launch.mesh import compat_make_mesh
    return op_cases(compat_make_mesh((1, 2), ("data", "model"), "cuda"))


def test_moe_op_gradients_on_cuda_dtensors(gen):
    """Each MoE op's outputs and gradients on CUDA DTensors of two ranks
    sharing the card (the all-gathers through ``route_gloo_all_gather``),
    for a replicated and a pending-sum cotangent, within 1e-6 of the
    plain op's on the card, ``top_k``'s exact: as on the CPU group
    (``tests/test_torch_moe_mesh_train.py``; on the card the gathers'
    scatter-add backward sums with atomics, in no fixed order)."""
    from test_torch_moe_mesh_train import OP_TOL

    from repro_torch.launch.mesh import run_ranks
    for cases in run_ranks(moe_grads_rank, 2, timeout=300):
        for name, res in cases.items():
            assert max(res["replicated"], res["pending"]) <= OP_TOL, (
                name, res)
            if name in ("top_k lead", "top_k last"):
                assert res["replicated"] == 0.0, (name, res)


MOE_TRAIN = (2, 64)
def moe_train_opt():
    """AdamW with a short warmup, so that 3 steps move the loss."""
    from repro_torch.optim.adam import AdamConfig
    return AdamConfig(lr=1e-3, warmup_steps=1, total_steps=10)


def small_moe_train_rank(rank, plan_json, steps):
    """The small bf16 MoE train step on its (1, 2) plan on card 0, the
    state donated: per step the loss and grad norm, and the final
    parameters gathered to the host."""
    from repro_torch import pytree
    from repro_torch.core.partitioner import ShardingPlan
    from repro_torch.train import steps as TS
    cfg = small_config("mixtral_8x22b", "bfloat16")
    step = TS.make_train_step(cfg, moe_train_opt())
    applied = ShardingPlan.from_json(plan_json).apply(step,
                                                      donate_argnums=0)
    state = TS.init_train_state(cfg, torch.Generator(
        device="cuda").manual_seed(0), moe_train_opt())
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, MOE_TRAIN, generator=g,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "targets")}
    state, batch = applied.place((state, batch))
    rows = []
    for _ in range(steps):
        state, m = applied(state, batch)
        rows.append((m["loss"].full_tensor().item(),
                     m["grad_norm"].full_tensor().item()))
    return {"rows": rows, "params": [x.full_tensor().float().cpu() for x in
                                     pytree.tree_leaves(state.params)]}


def test_small_bf16_moe_train_step_on_two_ranks_equals_one_card(gen):
    """A small bf16 mixtral (batch dispatch) trained 3 steps through
    ``plan.apply(step, donate_argnums=0)`` of the (1, 2) plan the
    default ``Request`` searches, on two ranks sharing the card: every
    loss and grad norm within 2e-2 (relative) of one card's eager steps
    from the same state and batch, every parameter leaf within 2e-2
    (relative, in norm), the loss falling."""
    from repro_torch import pytree
    from repro_torch.api import Request, Session
    from repro_torch.core.cost_model import MeshSpec
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.specs import batch_specs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train import steps as TS
    cfg = small_config("mixtral_8x22b", "bfloat16")
    step = TS.make_train_step(cfg, moe_train_opt())
    bspec, _ = batch_specs(cfg, ShapeConfig("t", MOE_TRAIN[1], MOE_TRAIN[0],
                                            "train"))
    plan2 = Session(step, (TS.train_state_specs(cfg, moe_train_opt()),
                           bspec)).partition(
        Request(mesh=MeshSpec(("data", "model"), (1, 2))))
    ranks = run_ranks(small_moe_train_rank, 2, plan2.to_json(), 3,
                      timeout=300)
    state = TS.init_train_state(cfg, torch.Generator(
        device="cuda").manual_seed(0), moe_train_opt())
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, MOE_TRAIN, generator=g,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "targets")}
    want = []
    for _ in range(3):
        state, m = step(state, batch)
        want.append((m["loss"].item(), m["grad_norm"].item()))
    params = [x.float().cpu() for x in pytree.tree_leaves(state.params)]
    for r in ranks:
        for got, ref in zip(r["rows"], want):
            for a, b in zip(got, ref):
                assert abs(a - b) <= 2e-2 * abs(b), (got, ref)
        assert r["rows"][-1][0] < r["rows"][0][0]
        for a, b in zip(r["params"], params):
            assert ((a - b).norm() / b.norm()).item() <= 2e-2


# -- training the xLSTM and the frontend models ------------------------------


TRAIN_LAYERS = {"xlstm_350m": 16, "whisper_small": 2, "phi3_vision": 2}


def frontend_train_batch(gen, cfg, B, S):
    """A train batch as ``launch.specs`` lays it out: frames or patches
    beside the tokens."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import batch_specs
    spec, _ = batch_specs(cfg, ShapeConfig("t", S, B, "train"))
    return {k: torch.randint(0, cfg.vocab_size, tuple(v.shape),
                             generator=gen, device="cuda", dtype=torch.int32)
            if v.dtype == torch.int32 else
            torch.randn(tuple(v.shape), generator=gen, device="cuda")
            for k, v in spec.items()}


@pytest.mark.parametrize("arch", sorted(TRAIN_LAYERS))
def test_small_train_step_on_the_card_as_on_the_cpu(gen, arch):
    """A small f32 model with remat (xLSTM at 16 layers: two sLSTM time
    scans inside the layer scan; whisper's encoder site non-causal and its
    decoder's causal on the kernel): loss, every gradient leaf and one
    AdamW step's state (``eps`` 1e-3) on the card within 1e-4 of the
    CPU's."""
    import dataclasses

    from repro_torch import pytree
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train import steps as TS
    cfg = dataclasses.replace(small_config(arch, "float32"), remat=True,
                              num_layers=TRAIN_LAYERS[arch])
    # eps 1e-3: with 1e-8 the first AdamW step turns a gradient element
    # near zero into lr * g / |g|, whose sign the two devices need not
    # agree on (tests/test_torch_train.py)
    opt = AdamConfig(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=4)
    state = train_state(cfg, opt)
    batch = frontend_train_batch(gen, cfg, 2, 48)
    host = pytree.tree_map(lambda x: x.cpu(), (state, batch))
    grads = TS.value_and_grad(TS.make_loss_fn(cfg), remat=True)
    step = TS.make_train_step(cfg, opt)
    before = fa.launches
    with kernel_dispatch(KernelDispatch(default_impl="cuda")):
        got = grads(state.params, batch) + step(state, batch)
    assert (fa.launches > before) == (arch != "xlstm_350m")
    want = grads(host[0].params, host[1]) + step(*host)
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", sorted(TRAIN_LAYERS))
def test_captured_donated_frontend_and_xlstm_train_steps_equal_eager(
        gen, arch):
    """A small bf16 model's train step (remat) through one graph with its
    state donated: 4 steps' metrics and the final state equal 4 eager
    steps exactly; the graph records each forward site twice (the
    forward and remat's recomputation) and no other kernel."""
    from repro_torch import pytree
    from repro_torch.models import transformer as T
    cfg, opt, step, plan = train_setup(arch, "bfloat16",
                                       num_layers=TRAIN_LAYERS[arch])
    captured = plan.apply(step, donate_argnums=0)
    eager = plan.apply(step, capture=False)
    state, want = train_state(cfg, opt), train_state(cfg, opt)
    for _ in range(4):
        batch = frontend_train_batch(gen, cfg, 2, 32)
        state, metrics = captured(state, batch)
        want, want_metrics = eager(want, batch)
        for k in ("loss", "ce", "grad_norm", "step"):
            assert torch.equal(metrics[k], want_metrics[k]), k
    assert captured.captures == 1 and captured.replays == 4
    for a, b in zip(pytree.tree_leaves(state), pytree.tree_leaves(want)):
        assert torch.equal(a, b)
    (graph,) = captured.graphs
    period, tail = T.kernel_sites(cfg)["flash_attention"]
    assert graph.launches["flash_attention"] == \
        2 * period * T.n_scan_blocks(cfg) + tail
    assert not graph.launches["rg_lru"]


# --- the xLSTM and the frontend models on two ranks sharing the card -------


def family_mesh_rank(rank, arch, num_layers, plans):
    """A small f32 model on card 0 through each (1, 2) plan (``plans``:
    kind -> JSON): the prefill's gathered logits, one train step's loss,
    grad norm and new state gathered to the host, the attention
    launches and the per-shard sLSTM loops (``sharding.per_shard``)."""
    import dataclasses

    from repro_torch import pytree
    from repro_torch.core.partitioner import ShardingPlan
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as TS
    cfg = dataclasses.replace(small_config(arch, "float32"), remat=True,
                              num_layers=num_layers)
    opt = moe_train_opt()
    g = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, g)
    batch = frontend_train_batch(g, cfg, 2, 32)
    sharding.per_shard.clear()
    fa.launches = 0
    prefill = ShardingPlan.from_json(plans["prefill"]).apply(
        TS.make_prefill_step(cfg))
    logits = prefill(params, {k: v for k, v in batch.items()
                              if k != "targets"}).full_tensor().cpu()
    state = TS.init_train_state(cfg, torch.Generator(
        device="cuda").manual_seed(1), opt)
    train = ShardingPlan.from_json(plans["train"]).apply(
        TS.make_train_step(cfg, opt))
    new, metrics = train(state, batch)
    return {"logits": logits, "launches": fa.launches,
            "scans": sharding.per_shard["scan"],
            "metrics": {k: metrics[k].full_tensor().item()
                        for k in ("loss", "grad_norm")},
            "state": [x.full_tensor().cpu()
                      for x in pytree.tree_leaves(new)]}


@pytest.mark.parametrize("arch,num_layers", [("xlstm_350m", 8),
                                             ("whisper_small", 2)])
def test_small_family_on_two_ranks_equals_one_card(gen, arch, num_layers):
    """Two ranks share the card on (1, 2) plans of a small f32 model with
    remat: the xLSTM at 8 layers (its sLSTM's time loop one per-shard
    scan, its mLSTMs' prefix sums per shard: torch 2.11's DTensor has no
    rule for the ``flip`` their backward issues), whisper with the
    attention sites its plans put on the kernel (its encoder's
    non-causal, its decoder's causal) launching it on each rank.  The gathered prefill logits, the train step's loss, grad
    norm and every leaf of the new state within 1e-4 of one card's."""
    import dataclasses

    from repro_torch import pytree
    from repro_torch.api import Request, Session
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.cost_model import MeshSpec
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as TS
    cfg = dataclasses.replace(small_config(arch, "float32"), remat=True,
                              num_layers=num_layers)
    opt = moe_train_opt()
    mesh = MeshSpec(("data", "model"), (1, 2))
    plans, cuda = {}, {}
    # the sites of one layer body, whose keys remat's recomputation
    # reuses on a mesh
    body = [f"flash_attention:{i}"
            for i in range(sum(T.kernel_sites(cfg)["flash_attention"]))]
    for kind, step, state in (
            ("prefill", TS.make_prefill_step(cfg), T.param_specs(cfg)),
            ("train", TS.make_train_step(cfg, opt),
             TS.train_state_specs(cfg, opt))):
        bspec, _ = specs.batch_specs(cfg, ShapeConfig("t", 32, 2, kind))
        plan = Session(step, (state, bspec)).partition(Request(mesh=mesh))
        plans[kind] = plan.to_json()
        cuda[kind] = sum(r["impl"] == "cuda" for r in plan.kernel_sites
                         if r["site"] in body)
    fa.build()                                  # the ranks load it
    ranks = run_ranks(family_mesh_rank, 2, arch, num_layers, plans,
                      timeout=300)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, g)
    batch = frontend_train_batch(g, cfg, 2, 32)
    with kernel_dispatch(KernelDispatch(default_impl="cuda")):
        logits = TS.make_prefill_step(cfg)(params, {
            k: v for k, v in batch.items() if k != "targets"}).cpu()
        new, metrics = TS.make_train_step(cfg, opt)(train_state(cfg, opt),
                                                    batch)
    for r in ranks:
        torch.testing.assert_close(r["logits"], logits, rtol=1e-4,
                                   atol=1e-4)
        for k in ("loss", "grad_norm"):
            assert abs(r["metrics"][k] - metrics[k].item()) <= \
                1e-4 * max(1.0, abs(metrics[k].item())), k
        for a, b in zip(r["state"], pytree.tree_leaves(new)):
            torch.testing.assert_close(a, b.cpu(), rtol=1e-4, atol=1e-4)
        # each layer's sites the plans put on the kernel: the prefill's
        # once, the train step's and remat's recomputation of them
        assert r["launches"] == T.n_scan_blocks(cfg) * (
            cuda["prefill"] + 2 * cuda["train"])
        assert (r["launches"] > 0) == (arch == "whisper_small")
        assert r["scans"] == (2 * (num_layers // 8) + num_layers // 8
                              if arch == "xlstm_350m" else 0)
