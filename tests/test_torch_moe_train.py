"""MoE training on one device: the port's gradients, train step and
training launcher against the JAX package's.

``mixtral_8x22b`` and ``arctic_480b`` (its dense residual path) at
``.reduced()`` size in f32 (2 layers, d 64, 4 experts, top-2), B 2 x S
32, the batch made from a numpy seed and the reference's own train state
carried over by ``train_state_from_numpy``, go through both packages on
the CPU.

Tolerances, all f32, 1e-4: the loss and every gradient leaf against
``jax.value_and_grad`` of the reference's loss, in the three dispatch
modes (global, batch, local with 4 pools), at capacity factor 4.0 (no
token dropped) and 1.0 (tokens dropped; the test checks that some are),
with remat off and on; one AdamW step leaf by leaf against the
reference's jitted ``make_train_step`` with one and two microbatches.
Exact: ``top_k``'s values' gradient against ``jax.vjp`` of
``lax.top_k`` on inputs full of ties (both put the cotangent where the
lower index won the tie), the gradients through the broadcast operands
of ``take_along_axis`` and ``scatter_add_rows`` against ``jax.vjp`` of
``jnp.take_along_axis`` and the ``vmap``'d ``.at[].add`` (1e-6), the
tokens remat's recomputation selects (the same as the forward's), and
the launcher's final state after a failure and a restart against an
uninterrupted run's (bit for bit).  The launcher from one checkpoint the
reference wrote agrees with the reference's launcher within 1e-4.

A step handed DTensor state (here on a one-rank gloo group) equals the
plain step; MoE training on two or more ranks is held in
``tests/test_torch_moe_mesh_train*.py``.
"""

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs.base import get_config as jax_config
from repro.launch import train as jtrain
from repro.optim import adam as jadam
from repro.train import steps as JS
from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.launch import mesh as M
from repro_torch.launch import train as launcher
from repro_torch.models import layers as L
from repro_torch.optim import adam
from repro_torch.train import steps as S

ARCHS = ["mixtral_8x22b", "arctic_480b"]
MODES = ["global", "batch", "local"]
TOL = 1e-4
OP_TOL = 1e-6
B, SEQ = 2, 32
POOLS = 4
# a short warmup, so one step moves the parameters visibly; eps as in
# tests/test_torch_train.py (a gradient that cancels to float noise)
OPT = dict(lr=1e-2, eps=1e-3, warmup_steps=1, total_steps=10)


def configs(arch, **kw):
    """The reference's and the port's reduced config, with ``kw``."""
    kw.setdefault("moe_local_pools", POOLS)
    return (dataclasses.replace(jax_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


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


def batch(seed, vocab):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (B, SEQ)).astype(np.int32)
    tgt = rng.integers(0, vocab, (B, SEQ)).astype(np.int32)
    return ({"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)},
            {"tokens": torch.from_numpy(tok),
             "targets": torch.from_numpy(tgt)})


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """The reference's reduced train state (AdamW of ``OPT``) and a
    batch."""
    jc, _ = configs(request.param)
    jstate = JS.init_train_state(jc, jax.random.PRNGKey(0),
                                 jadam.AdamConfig(**OPT))
    return request.param, jstate, *batch(7, jc.vocab_size)


def port_state(jstate):
    return S.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")


class TopKCalls:
    """Every ``layers.top_k`` call of a run, in order: (input, values,
    indices).  Each MoE layer calls it twice: the router's top k, then
    the capacity selection over its tokens."""

    def __init__(self, monkeypatch):
        self.calls = []
        inner = L.top_k

        def recorded(x, k):
            out = inner(x, k)
            self.calls.append((x.detach(), out[0].detach(), out[1]))
            return out

        monkeypatch.setattr(L, "top_k", recorded)

    def dropped(self, calls=None) -> int:
        """The routed (token, expert) pairs no expert had room for."""
        calls = self.calls if calls is None else calls
        return sum(int((x > 0).sum() - (v > 0).sum())
                   for x, v, _ in calls[1::2])


# -- top_k and the dispatch's gather and combine --------------------------------


@pytest.mark.parametrize("shape,k", [((6, 16), 3), ((2, 5, 16), 16),
                                     ((3, 4, 40), 1)])
def test_top_k_gradient_equals_lax_top_k_vjp(shape, k):
    # values from a set of 4: ties everywhere, which both break toward
    # the lower index, so the cotangent lands on the same elements
    x = np.random.default_rng(k).integers(0, 4, shape).astype(np.float32)
    ct = normal(k + 1, (*shape[:-1], k))
    _, vjp = jax.vjp(lambda a: jax.lax.top_k(a, k)[0], jnp.asarray(x))
    (want,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    values, indices = L.top_k(xt, k)
    assert not indices.requires_grad
    (got,) = torch.autograd.grad(values, xt, torch.from_numpy(ct))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_top_k_gradient_in_a_product_of_values_and_indices():
    # the router's use: the values renormalized and placed by one-hot
    # rows of the indices; the indices carry no gradient
    x = normal(3, (4, 8, 6))
    w = normal(4, (4, 8, 6))

    def jf(a):
        v, i = jax.lax.top_k(jax.nn.softmax(a, -1), 2)
        v = v / v.sum(-1, keepdims=True)
        hot = jax.nn.one_hot(i, 6) * v[..., None]
        return (hot.sum(-2) * w).sum()

    want = jax.grad(jf)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    v, i = L.top_k(torch.softmax(xt, -1), 2)
    v = v / v.sum(-1, keepdim=True)
    hot = torch.nn.functional.one_hot(i, 6) * v[..., None]
    (got,) = torch.autograd.grad((hot.sum(-2) * torch.from_numpy(w)).sum(),
                                 xt)
    close(got, want, OP_TOL)


@pytest.mark.parametrize("lead", [1, 2])
def test_gather_gradient_sums_back_to_the_broadcast_operand(lead):
    # take_along_axis of h[:, None] (or h[:, :, None]) at (.., E, C, 1)
    # token indices: the expanded operand's gradient sums over the
    # experts into h, as jnp.take_along_axis's transpose does
    dims = (2, 3)[:lead]
    h = normal(5, (*dims, 12, 8))
    idx = np.random.default_rng(6).integers(0, 12, (*dims, 4, 5)).astype(
        np.int32)
    ct = normal(7, (*dims, 4, 5, 8))
    axis = lead + 1
    _, vjp = jax.vjp(lambda a: jnp.take_along_axis(
        jnp.expand_dims(a, lead), jnp.asarray(idx)[..., None], axis=axis),
        jnp.asarray(h))
    (want,) = vjp(jnp.asarray(ct))
    ht = torch.from_numpy(h).requires_grad_()
    out = L.take_along_axis(ht.unsqueeze(lead),
                            torch.from_numpy(idx).long()[..., None], axis)
    (got,) = torch.autograd.grad(out, ht, torch.from_numpy(ct))
    close(got, want, OP_TOL)


def test_scatter_add_gradient_gathers_the_updates():
    # the batch dispatch's vmap'd combine: zeros (S, d) per row, the
    # rows of the updates added at their tokens; the updates' gradient is
    # the cotangent gathered at the indices, the base's the cotangent
    base = normal(8, (3, 10, 4))
    idx = np.random.default_rng(9).integers(0, 10, (3, 12)).astype(np.int32)
    upd = normal(10, (3, 12, 4))
    ct = normal(11, (3, 10, 4))

    def combine(b, u):
        return jax.vmap(lambda bb, ii, uu: bb.at[ii].add(uu))(
            b, jnp.asarray(idx), u)

    _, vjp = jax.vjp(combine, jnp.asarray(base), jnp.asarray(upd))
    want = vjp(jnp.asarray(ct))
    bt, ut = (torch.from_numpy(a).requires_grad_() for a in (base, upd))
    out = L.scatter_add_rows(bt, 1, torch.from_numpy(idx).long(), ut)
    got = torch.autograd.grad(out, (bt, ut), torch.from_numpy(ct))
    for g, w in zip(got, want):
        close(g, w, OP_TOL)


# -- the reduced models: loss, gradients, one step --------------------------------


@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
@pytest.mark.parametrize("capacity_factor", [4.0, 1.0])
@pytest.mark.parametrize("mode", MODES)
def test_loss_and_every_gradient_leaf(reference, mode, capacity_factor,
                                      remat, monkeypatch):
    arch, jstate, jb, tb = reference
    jc, tc = configs(arch, moe_dispatch=mode,
                     moe_capacity_factor=capacity_factor, remat=remat)
    (wl, wce), wg = jax.value_and_grad(JS.make_loss_fn(jc), has_aux=True)(
        jstate.params, jb)
    calls = TopKCalls(monkeypatch)
    gl, gce, gg = S.value_and_grad(S.make_loss_fn(tc), remat=remat)(
        port_state(jstate).params, tb)
    close(gl, wl, TOL)
    close(gce, wce, TOL)
    close_trees(gg, wg, TOL)
    # every layer's router takes a gradient (through both top-k's)
    assert (gg["layers"][0]["ffn"]["wg"].abs().amax((1, 2)) > 0).all()
    forward = calls.calls[:2 * tc.num_layers]
    assert (calls.dropped(forward) > 0) == (capacity_factor == 1.0)


@pytest.mark.parametrize("mode", MODES)
def test_remat_recomputes_the_forwards_selections(reference, mode,
                                                  monkeypatch):
    """Remat's recomputation of each layer body (in the backward, last
    layer first) picks the same experts and the same tokens as the
    forward: the stable sort keeps the tie order, and duplicated tokens
    tie at the capacity cut of factor 1.0."""
    arch, jstate, _, _ = reference
    _, tc = configs(arch, moe_dispatch=mode, moe_capacity_factor=1.0,
                    remat=True)
    tok = np.repeat(np.random.default_rng(12).integers(
        0, tc.vocab_size, (B, SEQ // 4)), 4, axis=1).astype(np.int32)
    tb = {"tokens": torch.from_numpy(tok), "targets": torch.from_numpy(tok)}
    calls = TopKCalls(monkeypatch)
    S.value_and_grad(S.make_loss_fn(tc), remat=True)(
        port_state(jstate).params, tb)
    n = tc.num_layers
    assert len(calls.calls) == 4 * n
    forward = [calls.calls[2 * i:2 * i + 2] for i in range(n)]
    recomputed = [calls.calls[2 * n + 2 * i:2 * n + 2 * i + 2]
                  for i in range(n)][::-1]
    for fwd, again in zip(forward, recomputed):
        for (x, v, i), (x2, v2, i2) in zip(fwd, again):
            assert torch.equal(x, x2) and torch.equal(v, v2)
            assert torch.equal(i, i2)
    assert calls.dropped(calls.calls[:2 * n]) > 0


@pytest.mark.parametrize("accum_steps", [1, 2])
@pytest.mark.parametrize("opt", ["default", "short-warmup"])
def test_train_step_matches_the_reference(reference, opt, accum_steps):
    arch, jstate, jb, tb = reference
    jc, tc = configs(arch, moe_capacity_factor=1.0)
    kw = OPT if opt == "short-warmup" else {}
    jnew, jm = jax.jit(JS.make_train_step(
        jc, jadam.AdamConfig(**kw), accum_steps=accum_steps))(jstate, jb)
    tnew, tm = S.make_train_step(tc, adam.AdamConfig(**kw),
                                 accum_steps=accum_steps)(
        port_state(jstate), tb)
    assert sorted(tm) == sorted(jm)
    for k in ("loss", "ce", "grad_norm"):
        close(tm[k], jm[k], TOL)
    assert int(tm["step"]) == 1
    close_trees(tnew, jnew, TOL)
    if not kw:
        return
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree_util.tree_leaves(jnew.params),
                                jax.tree_util.tree_leaves(jstate.params)))
    assert moved > 100 * TOL


# -- the launcher ---------------------------------------------------------------


def launcher_args(arch, ckpt_dir, *extra):
    return launcher.parse_args(
        ["--arch", arch, "--reduced", "--steps", "4", "--batch", "2",
         "--seq", "32", "--ckpt-dir", str(ckpt_dir), "--device", "cpu",
         *extra])


def load_checkpoint(directory, step):
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    return manifest, [np.load(d / e["file"]) for e in manifest["leaves"]]


@pytest.mark.parametrize("arch,plan", [("mixtral_8x22b", "manual"),
                                       ("arctic_480b", "manual"),
                                       ("mixtral_8x22b", "toast")])
def test_a_restart_ends_equal_to_an_uninterrupted_run(arch, plan, tmp_path,
                                                      capsys):
    cfg = get_config(arch).reduced()
    (whole,) = launcher.supervise(cfg, launcher_args(
        arch, tmp_path / "whole", "--ckpt-every", "2", "--plan", plan))
    attempts = launcher.supervise(cfg, launcher_args(
        arch, tmp_path / "run", "--ckpt-every", "2", "--fail-at", "3",
        "--plan", plan))
    out = capsys.readouterr().out
    assert "[resume] from step 2" in out and "training complete" in out
    assert [a.start_step for a in attempts] == [0, 2]
    for a, b in zip(pytree.tree_leaves(attempts[1].state),
                    pytree.tree_leaves(whole.state)):
        assert torch.equal(a, b)
    man, leaves = load_checkpoint(tmp_path / "run", 4)
    wman, wleaves = load_checkpoint(tmp_path / "whole", 4)
    assert man == wman
    assert any("['ffn']['wgate']" in e["path"] for e in man["leaves"])
    for a, b in zip(leaves, wleaves):
        np.testing.assert_array_equal(a, b)


def test_the_launcher_matches_the_reference_from_one_checkpoint(tmp_path):
    arch = "mixtral_8x22b"
    jstate = JS.init_train_state(jax_config(arch).reduced(),
                                 jax.random.PRNGKey(0))
    for name in ("ref", "port"):
        jckpt.save(tmp_path / name, 0, jstate)
    jargs = argparse.Namespace(
        arch=arch, reduced=True, steps=4, batch=2, seq=32, plan="manual",
        compress="none", seed=0, ckpt_dir=str(tmp_path / "ref"),
        ckpt_every=10, log_every=5, fail_at=None, max_failures=0)
    assert jtrain.run_once(jargs, 0)
    report = launcher.Attempt(0)
    assert launcher.run_once(get_config(arch).reduced(),
                             launcher_args(arch, tmp_path / "port"), 0,
                             report)
    jman, jleaves = load_checkpoint(tmp_path / "ref", 4)
    man, leaves = load_checkpoint(tmp_path / "port", 4)
    assert man == jman
    for entry, got, want in zip(man["leaves"], leaves, jleaves):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=entry["path"])


# -- no guard: MoE state on meshes ---------------------------------------------


def test_make_train_step_builds_moe_steps_with_no_guard():
    """No guard is left on MoE training: ``make_train_step`` builds the
    MoE models' steps at full size and reduced (the step on meshes:
    ``tests/test_torch_moe_mesh*.py``)."""
    assert not hasattr(S, "check_trainable")
    for arch in ARCHS:
        assert callable(S.make_train_step(get_config(arch)))
        assert callable(S.make_train_step(get_config(arch).reduced()))


def dtensor_step(rank):
    """On a one-rank group: the step, made there, handed its state as
    DTensors on a (1, 1) mesh, and the same step on the plain state: the
    new states' leaves and the metrics of both."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    cfg = get_config("mixtral_8x22b").reduced()
    step = S.make_train_step(cfg)
    state = S.init_train_state(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    mesh = M.compat_make_mesh((1, 1), ("data", "model"), "cpu")
    placed = pytree.tree_map(
        lambda x: distribute_tensor(x, mesh, [Replicate(), Replicate()]),
        state)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    batch = {"tokens": tokens, "targets": tokens}
    got = step(placed, {k: distribute_tensor(v, mesh, [Replicate()] * 2)
                        for k, v in batch.items()})
    want = step(state, batch)
    return ([x.full_tensor() for x in pytree.tree_leaves(got)],
            pytree.tree_leaves(want))


def test_a_step_on_dtensor_state_equals_the_plain_step():
    """A step handed DTensor state on a (1, 1) mesh trains, and equals
    the plain step leaf by leaf (within 1e-6: one rank, the same ops)."""
    ((got, want),) = M.run_ranks(dtensor_step, 1, timeout=120.0)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=OP_TOL, atol=OP_TOL)
