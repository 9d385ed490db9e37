"""The port's hybrid train step against the JAX package: the RG-LRU
backward op, the reduced ``recurrentgemma_2b`` train step, and the site
keys its remat recomputations take.

The same inputs, made from a numpy seed (or the reference's train state
carried over by ``train_state_from_numpy``), go through the reference
and the port on the CPU.  Tolerances: the RG-LRU backward op against
``jax.vjp`` of the reference's plain scan 2e-5 (f32) and 2e-2 (bf16
inputs, cotangents in bf16); the reduced f32 models' loss, every
gradient leaf and the updated train state 1e-4, on the einsum path and
with ``use_pallas`` set (the CPU tensors take the fused op's plain
version and its plain-vjp backward), remat off and on, one and two
microbatches.  The models are the reduced config (3 layers: one period
of (rglru, rglru, local), no tail) and 8 layers (two periods and a tail
of two RG-LRU blocks).  The step uses a short warmup and ``eps`` 1e-3,
as ``tests/test_torch_train.py`` explains, so that one step moves the
parameters well past the tolerance.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.kernels import ref as jref
from repro.optim import adam as jadam
from repro.train import steps as JS
from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models import transformer as T
from repro_torch.models.sharding import KernelDispatch, kernel_dispatch
from repro_torch.optim import adam
from repro_torch.train import steps as S

ARCH = "recurrentgemma_2b"
BWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
STEP_TOL = 1e-4
B, L = 4, 16
OPT = dict(lr=1e-2, eps=1e-3, warmup_steps=1, total_steps=10)
DEPTHS = [3, 8]


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


# -- the RG-LRU backward ------------------------------------------------------


def lru_case(S_, dtype):
    rng = np.random.default_rng(S_)
    a = rng.uniform(0.5, 1.0, (2, S_, 8)).astype(np.float32)
    b = rng.standard_normal((2, S_, 8)).astype(np.float32)
    dh = rng.standard_normal((2, S_, 8)).astype(np.float32)
    _, vjp = jax.vjp(jref.reference_rg_lru,
                     *(jnp.asarray(x, dtype) for x in (a, b)))
    want = vjp(jnp.asarray(dh, dtype))
    tdt = getattr(torch, dtype)
    return tuple(torch.from_numpy(x).to(tdt) for x in (a, b, dh)), want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S_", [15, 16])
def test_rg_lru_bwd_matches_the_reference_vjp(S_, dtype):
    (a, b, dh), want = lru_case(S_, dtype)
    for fn in (ref.reference_rg_lru_bwd, torch.ops.repro_torch.rg_lru_bwd):
        got = fn(a, b, dh)
        for g, w in zip(got, want):
            assert g.dtype == a.dtype and g.shape == a.shape
            close(g, w, BWD_TOL[dtype])


@pytest.mark.parametrize("impl", ["cuda", "ref"])
def test_rg_lru_trains_through_the_custom_op(impl):
    (a, b, dh), _ = lru_case(16, "float32")
    a, b = a.requires_grad_(), b.requires_grad_()
    calls = ops.rg_lru_bwd_calls
    with kernel_dispatch(KernelDispatch(default_impl=impl)):
        out = ops.rg_lru(a, b)
    got = torch.autograd.grad(out, (a, b), dh)
    assert ops.rg_lru_bwd_calls == calls + 1
    want = ref.reference_rg_lru_bwd(a.detach(), b.detach(), dh)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_rg_lru_bwd_traces_as_one_kernel_op():
    from repro_torch.core.ir import extract_program
    m = torch.empty((2, 16, 8), device="meta")
    prog = extract_program(
        lambda a, b, dh: torch.ops.repro_torch.rg_lru_bwd(a, b, dh), m, m, m)
    assert [op.prim for op in prog.ops] == ["kernel:rg_lru_bwd"]
    assert [prog.types[v].shape for v in prog.ops[0].results] == \
        [(2, 16, 8)] * 2


# -- the reduced models: loss, gradients, one step -------------------------------


def configs(layers, use_pallas=False, remat=False):
    jc = dataclasses.replace(jax_config(ARCH).reduced(), num_layers=layers,
                             remat=remat)
    tc = dataclasses.replace(get_config(ARCH).reduced(), num_layers=layers,
                             remat=remat, use_pallas=use_pallas)
    return jc, tc


@pytest.fixture(scope="module", params=DEPTHS, ids=lambda n: f"{n}-layers")
def reference(request):
    """The reference's reduced model, its train state, a batch, and its
    results, each computed once."""
    layers = request.param
    jc, _ = configs(layers)
    jstate = JS.init_train_state(jc, jax.random.PRNGKey(0),
                                 jadam.AdamConfig(**OPT))
    rng = np.random.default_rng(7)
    tok = rng.integers(0, jc.vocab_size, (B, L)).astype(np.int32)
    tgt = rng.integers(0, jc.vocab_size, (B, L)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)}
    tb = {"tokens": torch.from_numpy(tok), "targets": torch.from_numpy(tgt)}
    cache: dict = {}

    def result(kind, remat, accum=1):
        key = (kind, remat, accum)
        if key not in cache:
            jcr = configs(layers, remat=remat)[0]
            if kind == "grads":
                cache[key] = jax.jit(jax.value_and_grad(
                    JS.make_loss_fn(jcr), has_aux=True))(jstate.params, jb)
            else:
                cache[key] = jax.jit(JS.make_train_step(
                    jcr, jadam.AdamConfig(**OPT), accum_steps=accum))(
                        jstate, jb)
        return cache[key]

    return layers, jstate, tb, result


def port_state(jstate):
    return S.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")


@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["einsum", "fused-plain"])
def test_loss_and_every_gradient_leaf(reference, use_pallas, remat):
    layers, jstate, tb, result = reference
    _, tc = configs(layers, use_pallas, remat)
    (wl, wce), wg = result("grads", remat)
    gl, gce, gg = S.value_and_grad(S.make_loss_fn(tc), remat=remat)(
        port_state(jstate).params, tb)
    close(gl, wl, STEP_TOL)
    close(gce, wce, STEP_TOL)
    close_trees(gg, wg, STEP_TOL)


@pytest.mark.parametrize("accum_steps", [1, 2])
@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["einsum", "fused-plain"])
def test_train_step_matches_the_reference(reference, use_pallas, remat,
                                          accum_steps):
    layers, jstate, tb, result = reference
    _, tc = configs(layers, use_pallas, remat)
    jnew, jm = result("step", remat, accum_steps)
    tnew, tm = S.make_train_step(tc, adam.AdamConfig(**OPT),
                                 accum_steps=accum_steps)(
        port_state(jstate), tb)
    for k in ("loss", "ce", "grad_norm"):
        close(tm[k], jm[k], STEP_TOL)
    assert int(tm["step"]) == 1
    close_trees(tnew, jnew, STEP_TOL)
    # the step moved the parameters by more than the tolerance
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree_util.tree_leaves(jnew.params),
                                jax.tree_util.tree_leaves(jstate.params)))
    assert moved > 100 * STEP_TOL


# -- remat: the recomputed sites' keys -------------------------------------------


def hybrid(layers=8):
    _, tc = configs(layers, use_pallas=True, remat=True)
    params = T.init_params(tc, torch.Generator().manual_seed(0),
                           device="cpu")
    g = torch.Generator().manual_seed(9)
    batch = {k: torch.randint(0, tc.vocab_size, (2, L), generator=g,
                              dtype=torch.int32)
             for k in ("targets", "tokens")}
    return tc, params, batch


def test_remat_recomputes_under_the_traced_programs_site_keys():
    # forward: the period's two sites in every scanned layer, then the
    # tail's two; the backward recomputes each scanned body under the
    # keys that follow every forward site, as the traced program holds
    # the recomputed sites in its backward scan
    from repro_torch.api import Request, Session
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.cost_model import MeshSpec
    from repro_torch.launch import specs
    tc, params, batch = hybrid()
    sites = []

    class Recording(KernelDispatch):
        def next_site(self, kernel):
            sites.append(super().next_site(kernel))
            return sites[-1]

    with kernel_dispatch(Recording()):
        S.value_and_grad(S.make_loss_fn(tc), remat=True)(params, batch)
    n = T.n_scan_blocks(tc)
    assert sites == ["rg_lru:0", "rg_lru:1"] * n + \
        ["rg_lru:2", "rg_lru:3"] + ["rg_lru:4", "rg_lru:5"] * n
    fn, args, _ = specs.step_and_inputs(tc, ShapeConfig("t", L, 2, "train"))
    sess = Session(fn, args)
    plan = sess.partition(Request(mesh=MeshSpec(("data", "model"), (1, 1))))
    trips = sess.artifacts.prog.trip_counts
    assert [(r["site"], trips[r["op"]]) for r in plan.kernel_sites] == [
        ("rg_lru:0", n), ("rg_lru:1", n), ("rg_lru:2", 1), ("rg_lru:3", 1),
        ("rg_lru:4", n), ("rg_lru:5", n)]


def test_remat_recomputes_under_the_forwards_dispatch_on_another_thread():
    # autograd runs a CUDA backward on a thread of its own, where no
    # dispatch is installed: the recomputed sites must still take the
    # plan's decisions, under their own keys
    tc, params, batch = hybrid()
    impls = []
    orig = ops._resolve

    def resolve(kernel):
        site, impl = orig(kernel)
        impls.append(impl)
        return site, impl

    ops._resolve = resolve
    try:
        with kernel_dispatch(KernelDispatch(impls={
                "rg_lru:4": "ref", "rg_lru:5": "ref"}, default_impl="cuda")):
            with torch.enable_grad():
                live = [p.detach().requires_grad_()
                        for p in pytree.tree_leaves(params)]
                loss, _ = S.make_loss_fn(tc)(pytree.unflatten(params, live),
                                             batch)
            out = []
            worker = threading.Thread(target=lambda: out.append(
                torch.autograd.grad(loss, live)))
            worker.start()
            worker.join()
    finally:
        ops._resolve = orig
    n = T.n_scan_blocks(tc)
    assert len(out) == 1
    assert impls == ["cuda"] * (2 * n + 2) + ["ref"] * (2 * n)
