"""The port's train step against the JAX package: AdamW, the loss, the
gradients, the step with and without microbatches, the attention
backward op, and the prefill step's fresh result.

The same inputs, made from a numpy seed (or the reference's train state
carried over by ``train_state_from_numpy``), go through the reference
and the port on the CPU.  Tolerances, all f32: the optimizer's functions
and the cross-entropy 1e-6; the reduced models' loss, every gradient
leaf and the updated train state 1e-4 (on the einsum path and with
``use_pallas`` set, where the CPU tensors take the fused op's plain
version and its plain-vjp backward); the attention backward op against
``jax.vjp`` of the reference's plain attention 2e-5.

The step is compared under the default ``AdamConfig`` and under one
with a short warmup, so that one step moves the parameters well past
the tolerance.  That one also raises ``eps`` to 1e-3: the key bias's
true gradient is zero (the softmax does not see a shift of all scores),
so both packages compute it as float noise, and with ``eps`` 1e-8 the
first AdamW step turns that noise into ``lr * noise / |noise|``, a sign
the two cannot agree on.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.kernels import ops as jops
from repro.optim import adam as jadam
from repro.train import steps as JS
from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.core.ir import extract_program, program_fingerprint
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import specs
from repro_torch.models import transformer as T
from repro_torch.models.sharding import KernelDispatch, kernel_dispatch
from repro_torch.optim import adam
from repro_torch.train import steps as S
from repro_torch.configs.base import ShapeConfig

ARCHS = ["qwen2_05b", "phi3_mini"]
OPT_TOL = 1e-6
STEP_TOL = 1e-4
BWD_TOL = 2e-5
B, L = 4, 16
# a short warmup, so one step moves the parameters visibly (eps: see the
# module docstring)
OPT = dict(lr=1e-2, eps=1e-3, warmup_steps=1, total_steps=10)
OPT_CASES = {"default": {}, "short-warmup": OPT}


def normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def close_trees(got, want, tol):
    gl, jl = pytree.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(jl)
    for g, w in zip(gl, jl):
        assert tuple(g.shape) == tuple(np.shape(w))
        close(g, w, tol)


def tree_of(seed):
    """A small parameter-like tree: nested dicts and a tuple."""
    return {"a": normal(seed, (3, 4)), "b": (normal(seed + 1, (5,)),),
            "c": {"d": normal(seed + 2, (2, 2, 3))}}


def to_torch(tree):
    return pytree.tree_map(torch.from_numpy, tree)


# -- optim/adam.py ------------------------------------------------------------


class TestAdam:
    @pytest.mark.parametrize("step", [0, 1, 50, 100, 101, 5000, 10000,
                                      12000])
    def test_schedule(self, step):
        cfg_j, cfg_t = jadam.AdamConfig(), adam.AdamConfig()
        want = jadam.schedule(cfg_j, jnp.asarray(step, jnp.int32))
        got = adam.schedule(cfg_t, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.ndim == 0
        close(got, want, OPT_TOL)

    @pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
    def test_init(self, state_dtype):
        tree = tree_of(0)
        want = jadam.init(jadam.AdamConfig(state_dtype=state_dtype), tree)
        got = adam.init(adam.AdamConfig(state_dtype=state_dtype),
                        to_torch(tree))
        assert got.step.dtype == torch.int32 and got.step.ndim == 0
        for g, w in zip(pytree.tree_leaves(got.m) + pytree.tree_leaves(got.v),
                        jax.tree_util.tree_leaves((want.m, want.v))):
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
            assert not g.any()

    def test_global_norm_and_clip(self):
        tree = tree_of(1)
        close(adam.global_norm(to_torch(tree)), jadam.global_norm(tree),
              OPT_TOL)
        for max_norm in (0.5, 100.0):
            g, n = adam.clip_by_global_norm(to_torch(tree), max_norm)
            wg, wn = jadam.clip_by_global_norm(tree, max_norm)
            close(n, wn, OPT_TOL)
            close_trees(g, wg, OPT_TOL)

    @pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
    def test_apply_updates_leaf_by_leaf(self, state_dtype):
        params, grads = tree_of(2), tree_of(10)
        m = jax.tree_util.tree_map(lambda x: 0.1 * x, tree_of(20))
        v = jax.tree_util.tree_map(lambda x: 0.01 * x * x, tree_of(30))
        dt = jnp.dtype(state_dtype)
        jstate = jadam.AdamState(
            jnp.asarray(7, jnp.int32),
            jax.tree_util.tree_map(lambda x: jnp.asarray(x, dt), m),
            jax.tree_util.tree_map(lambda x: jnp.asarray(x, dt), v))
        tstate = adam.AdamState(
            torch.tensor(7, dtype=torch.int32),
            pytree.tree_map(lambda x: x.to(getattr(torch, state_dtype)),
                            to_torch(m)),
            pytree.tree_map(lambda x: x.to(getattr(torch, state_dtype)),
                            to_torch(v)))
        jcfg = jadam.AdamConfig(state_dtype=state_dtype, **OPT)
        tcfg = adam.AdamConfig(state_dtype=state_dtype, **OPT)
        wp, wst, wn = jadam.apply_updates(jcfg, jstate, params, grads)
        gp, gst, gn = adam.apply_updates(tcfg, tstate, to_torch(params),
                                         to_torch(grads))
        close(gn, wn, OPT_TOL)
        assert int(gst.step) == int(wst.step) == 8
        close_trees(gp, wp, OPT_TOL)
        for g, w in zip(pytree.tree_leaves((gst.m, gst.v)),
                        jax.tree_util.tree_leaves((wst.m, wst.v))):
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
            close(g, np.asarray(w, np.float32), OPT_TOL)


# -- the loss ------------------------------------------------------------------


def test_cross_entropy_with_z_loss():
    logits = normal(3, (B, L, 50), scale=4.0)
    targets = np.random.default_rng(4).integers(0, 50, (B, L)).astype(
        np.int32)
    want = JS.cross_entropy(jnp.asarray(logits), jnp.asarray(targets))
    got = S.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.ndim == 0
        close(g, w, OPT_TOL)


def test_cross_entropy_takes_bf16_logits_in_f32():
    logits = normal(5, (2, 8, 32), scale=3.0)
    targets = np.random.default_rng(6).integers(0, 32, (2, 8)).astype(
        np.int32)
    want = JS.cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                            jnp.asarray(targets))
    got = S.cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                          torch.from_numpy(targets))
    for g, w in zip(got, want):
        close(g, w, OPT_TOL)


# -- the reduced models: loss, gradients, one step -------------------------------


def models(arch, use_pallas=False, remat=False):
    jc = dataclasses.replace(jax_config(arch).reduced(), remat=remat)
    tc = dataclasses.replace(get_config(arch).reduced(),
                             use_pallas=use_pallas, remat=remat)
    return jc, tc


def batch(seed, vocab):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (B, L)).astype(np.int32)
    tgt = rng.integers(0, vocab, (B, L)).astype(np.int32)
    return ({"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)},
            {"tokens": torch.from_numpy(tok),
             "targets": torch.from_numpy(tgt)})


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """The reference's reduced model, train state and a batch."""
    arch = request.param
    jc, _ = models(arch)
    jstate = JS.init_train_state(jc, jax.random.PRNGKey(0),
                                 jadam.AdamConfig(**OPT))
    jb, tb = batch(7, jc.vocab_size)
    return arch, jstate, jb, tb


def port_state(jstate):
    return S.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["einsum", "fused-plain"])
def test_loss_and_every_gradient_leaf(reference, use_pallas):
    arch, jstate, jb, tb = reference
    jc, tc = models(arch, use_pallas)
    (wl, wce), wg = jax.value_and_grad(JS.make_loss_fn(jc), has_aux=True)(
        jstate.params, jb)
    gl, gce, gg = S.value_and_grad(S.make_loss_fn(tc))(
        port_state(jstate).params, tb)
    close(gl, wl, STEP_TOL)
    close(gce, wce, STEP_TOL)
    close_trees(gg, wg, STEP_TOL)


def test_remat_gives_the_same_gradients(reference):
    arch, jstate, jb, tb = reference
    _, tc = models(arch, remat=False)
    _, tr = models(arch, remat=True)
    params = port_state(jstate).params
    plain = S.value_and_grad(S.make_loss_fn(tc))(params, tb)
    remat = S.value_and_grad(S.make_loss_fn(tr), remat=True)(params, tb)
    for a, b in zip(pytree.tree_leaves(plain), pytree.tree_leaves(remat)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("opt", sorted(OPT_CASES))
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["einsum", "fused-plain"])
@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_matches_the_reference(reference, accum_steps,
                                          use_pallas, opt):
    arch, jstate, jb, tb = reference
    jc, tc = models(arch, use_pallas)
    kw = OPT_CASES[opt]
    jnew, jm = jax.jit(JS.make_train_step(
        jc, jadam.AdamConfig(**kw), accum_steps=accum_steps))(jstate, jb)
    tnew, tm = S.make_train_step(tc, adam.AdamConfig(**kw),
                                 accum_steps=accum_steps)(
        port_state(jstate), tb)
    assert isinstance(tnew, S.TrainState)
    assert sorted(tm) == sorted(jm)
    for k in ("loss", "ce", "grad_norm"):
        close(tm[k], jm[k], STEP_TOL)
    assert tm["step"].dtype == torch.int32 and int(tm["step"]) == 1
    close_trees(tnew, jnew, STEP_TOL)
    if not kw:
        return
    # the step moved the parameters by more than the tolerance
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree_util.tree_leaves(jnew.params),
                                jax.tree_util.tree_leaves(jstate.params)))
    assert moved > 100 * STEP_TOL


def test_microbatch_step_sums_gradients_in_f32():
    # a bf16 model: the accumulated gradients are f32, as the reference's
    jc, tc = models("qwen2_05b")
    jc = dataclasses.replace(jc, param_dtype="bfloat16")
    tc = dataclasses.replace(tc, param_dtype="bfloat16")
    jstate = JS.init_train_state(jc, jax.random.PRNGKey(1),
                                 jadam.AdamConfig(**OPT))
    jb, tb = batch(8, jc.vocab_size)
    _, jm = jax.jit(JS.make_train_step(jc, jadam.AdamConfig(**OPT),
                                       accum_steps=2))(jstate, jb)
    tnew, tm = S.make_train_step(tc, adam.AdamConfig(**OPT),
                                 accum_steps=2)(port_state(jstate), tb)
    assert pytree.tree_leaves(tnew.params)[0].dtype == torch.bfloat16
    for k in ("loss", "ce", "grad_norm"):
        close(tm[k], jm[k], 2e-2)


def test_train_state_helpers():
    _, tc = models("qwen2_05b")
    st = S.init_train_state(tc, torch.Generator().manual_seed(0),
                            device="cpu")
    spec = S.train_state_specs(tc)
    assert isinstance(st, S.TrainState) and isinstance(st.opt,
                                                       adam.AdamState)
    got, paths = pytree.flatten_with_paths((st,))
    sp, spaths = pytree.flatten_with_paths((spec,))
    assert paths == spaths
    assert all(x.device.type == "meta" for x in sp)
    assert [(tuple(a.shape), a.dtype) for a in got] == \
        [(tuple(a.shape), a.dtype) for a in sp]
    assert "[0].opt.step" in paths and "[0].params['embed']" in paths
    jc, _ = models("qwen2_05b")
    jflat, _ = jax.tree_util.tree_flatten_with_path(
        (JS.train_state_specs(jc),))
    assert paths == [jax.tree_util.keystr(p) for p, _ in jflat]


# -- the attention backward --------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S_,T_", [(16, 16), (12, 20)])
def test_flash_attention_bwd_matches_the_reference_vjp(causal, S_, T_):
    q = normal(11, (2, S_, 4, 16))
    k = normal(12, (2, T_, 4, 16))
    v = normal(13, (2, T_, 4, 16))
    do = normal(14, (2, S_, 4, 16))
    _, vjp = jax.vjp(lambda a, b, c: jops._ref_attention_model_layout(
        a, b, c, causal), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = torch.ops.repro_torch.flash_attention_bwd(
        *map(torch.from_numpy, (q, k, v, do)), causal)
    for g, w in zip(got, want):
        close(g, w, BWD_TOL)


@pytest.mark.parametrize("impl", ["cuda", "ref"])
def test_attention_trains_through_the_custom_op(impl):
    q, k, v = (torch.from_numpy(normal(s, (2, 12, 4, 16))).requires_grad_()
               for s in (21, 22, 23))
    do = torch.from_numpy(normal(24, (2, 12, 4, 16)))
    with kernel_dispatch(KernelDispatch(default_impl=impl)):
        out = ops.attention(q, k, v, causal=True)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = fa.reference_bwd(q.detach(), k.detach(), v.detach(), do,
                            causal=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_rg_lru_backward_names_its_roadmap_item():
    # the backward of ROADMAP item 20: the op repro_torch::rg_lru_bwd,
    # the plain scan's vjp
    a = torch.rand(1, 8, 4, requires_grad=True)
    b = torch.rand(1, 8, 4, requires_grad=True)
    calls = ops.rg_lru_bwd_calls
    h = ops.rg_lru(a, b)
    h.sum().backward()
    assert ops.rg_lru_bwd_calls == calls + 1
    da, db = torch.ops.repro_torch.rg_lru_bwd(a.detach(), b.detach(),
                                               torch.ones_like(h))
    torch.testing.assert_close(a.grad, da, rtol=0, atol=0)
    torch.testing.assert_close(b.grad, db, rtol=0, atol=0)


def test_remat_recomputes_under_the_following_site_keys():
    _, tc = models("qwen2_05b", use_pallas=True, remat=True)
    params = T.init_params(tc, torch.Generator().manual_seed(0),
                           device="cpu")
    sites = []

    class Recording(KernelDispatch):
        def next_site(self, kernel):
            sites.append(super().next_site(kernel))
            return sites[-1]

    _, tb = batch(9, tc.vocab_size)
    with kernel_dispatch(Recording()):
        S.value_and_grad(S.make_loss_fn(tc), remat=True)(params, tb)
    n = tc.num_layers
    assert sites == ["flash_attention:0"] * n + ["flash_attention:1"] * n


def test_remat_recomputes_under_the_forwards_dispatch_on_another_thread():
    # autograd runs a CUDA backward on a thread of its own, where no
    # dispatch is installed: the recomputed sites must still take the
    # plan's decisions
    import threading
    _, tc = models("qwen2_05b", use_pallas=True, remat=True)
    params = T.init_params(tc, torch.Generator().manual_seed(0),
                           device="cpu")
    _, tb = batch(9, tc.vocab_size)
    impls = []
    orig = ops._resolve

    def resolve(kernel):
        site, impl = orig(kernel)
        impls.append(impl)
        return site, impl

    ops._resolve = resolve
    try:
        with kernel_dispatch(KernelDispatch(impls={
                "flash_attention:0": "ref", "flash_attention:1": "ref"},
                default_impl="cuda")):
            with torch.enable_grad():
                live = [p.detach().requires_grad_()
                        for p in pytree.tree_leaves(params)]
                loss, _ = S.make_loss_fn(tc)(pytree.unflatten(params, live),
                                             tb)
            out = []
            worker = threading.Thread(target=lambda: out.append(
                torch.autograd.grad(loss, live)))
            worker.start()
            worker.join()
    finally:
        ops._resolve = orig
    assert len(out) == 1
    assert impls == ["ref"] * (2 * tc.num_layers)


# -- the prefill step's result -------------------------------------------------


def test_prefill_returns_a_fresh_b_by_vocab_tensor():
    cfg = get_config("qwen2_05b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32)
    with torch.no_grad():
        out = S.make_prefill_step(cfg)(params, {"tokens": tokens})
        full = T.forward(cfg, params, tokens)
    assert out.shape == (2, cfg.vocab_size)
    assert out.untyped_storage().nbytes() == \
        2 * cfg.vocab_size * out.element_size()
    torch.testing.assert_close(out, full[:, -1], rtol=0, atol=0)


# the prefill programs: the copy lowers as an identity and the softmax's
# detached shift as a mark, so the train step does not move them
PREFILL_FINGERPRINTS = {
    "qwen2_05b": "226eb0717f8c3435f602cd01229853533001c0769532a376715bc1653fece8ac",
    "phi3_mini": "cfdbae43ca286b31b7781f45822ff0c5ef6c5cbfca997b5b31db64344023884d",
    "recurrentgemma_2b": "0958980ec55d1a8459b1afa4835377727f281819018344020d62bb9d9353e1e0",
}


@pytest.mark.parametrize("arch", sorted(PREFILL_FINGERPRINTS))
def test_prefill_programs_did_not_move(arch):
    fn, args, _ = specs.step_and_inputs(
        get_config(arch).reduced(), ShapeConfig("p", 64, 2, "prefill"))
    assert program_fingerprint(extract_program(fn, *args)) == \
        PREFILL_FINGERPRINTS[arch]


@pytest.mark.parametrize("aliased", [False, True])
def test_detach_marks_a_value_only_when_nothing_else_reads_it(aliased):
    # the mark stops the gradient of the value itself; when another node
    # lowered to the same value is read elsewhere, a stop_gradient op is
    # emitted instead, so that other read keeps its gradient
    def loss_fn(params, batch):
        y = params["w"] * batch
        z = y.clone() if aliased else y * 3.0
        loss = (z.detach() * params["w"]).sum()
        if aliased:
            loss = loss + (y * y).sum()
        return loss, loss

    w = torch.empty((4,), device="meta")
    x = torch.empty((4,), device="meta")
    prog = extract_program(
        lambda p, b: S.value_and_grad(loss_fn)(p, b)[2], {"w": w}, x)
    prims = [op.prim for op in prog.ops]
    assert ("stop_gradient" in prims) == aliased
