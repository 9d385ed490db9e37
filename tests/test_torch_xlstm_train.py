"""The port's xLSTM train step against the JAX package: the rules of
``cumsum`` and ``split``, a toy nested scan, the reduced ``xlstm_350m``
train step and the training launcher.

The same inputs, made from a numpy seed (or the reference's train state
carried over by ``train_state_from_numpy``), go through the reference
and the port on the CPU.

*Rules.*  ``cumsum`` (forwards and in reverse) and a four-way ``split``
whose pieces are read in part: the port's autograd against ``jax.vjp``
(1e-6), and the backward the tracer builds (``core.autodiff``) against
the reference's trace of ``jax.grad``, prim for prim with their params:
a ``cumsum`` transposes into one the other way, a ``split`` into a
``concatenate`` with zeros for the pieces nothing read.

*A toy nested scan.*  An outer scan over two layers whose body runs an
inner scan over time: the inner carry starts from zeros (no tangent:
JAX instantiates zero tangents for it), its body closes over the outer
layer's weights and the outer carry (constants with gradients) and it
returns its states stacked as ``ys``, which the outer body reads.  The
loss and every gradient against ``jax.value_and_grad`` (1e-5), remat off
and on (the outer body checkpointed); the traced program's (prim, trip
count) pairs equal the reference's.

*The model.*  Reduced f32 ``xlstm_350m`` at 4 layers (the stock
``.reduced()``: a pattern of period 8, so an empty layer stack and four
mLSTM tail layers; its stacked leaves have a leading dim of 0 and take
zero gradients, as ``jax.value_and_grad`` gives them), 8 (one scanned
period, 7 mLSTM and 1 sLSTM: the time scan nested in the layer scan) and
16 (two periods): the loss and every gradient leaf against
``jax.value_and_grad`` within 1e-4, remat off and on; one AdamW step
against the jitted reference step within 1e-4, with a short warmup and
``eps`` 1e-3 (``tests/test_torch_train.py``).  The gates x20 case of
``tests/test_torch_xlstm.py`` is held per block, its input and weight
cotangents against ``jax.vjp``: the sLSTM within 1e-5 of each leaf's
largest cotangent, the mLSTM within 1e-6 x max|F| of it (~2.5e-4 here;
~2.3e-5 seen), as its forward (the prefix sums of the log forget gates
reach ~250 and each package rounds them in its own order).  A whole
model at gates x20 is not compared: the blocks' differences grow layer
by layer into gradients that differ at their own scale.

*The launcher.*  The port's and the reference's launchers train the
stock reduced config 3 steps at B 2 x S 32 from one step-0 checkpoint
the reference wrote; the final checkpoints agree within 1e-4.  On two
ranks the port's launcher trains it too (item 11e), one step within 1e-4
of one process.
"""

import argparse
import collections
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.ckpt import checkpoint as jckpt
from repro.configs.base import get_config as jax_config
from repro.core.ir import extract_program as jax_extract
from repro.launch import train as jtrain
from repro.models import layers as JL
from repro.optim import adam as jadam
from repro.train import steps as JS
from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.core.ir import extract_program
from repro_torch.launch import train as launcher
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import adam
from repro_torch.train import steps as S
from test_torch_xlstm import block_params, log_forget_prefix, normal

ARCH = "xlstm_350m"
RULE_TOL = 1e-6
TOY_TOL = 1e-5
STEP_TOL = 1e-4
B, SEQ = 2, 16
OPT = dict(lr=1e-2, eps=1e-3, warmup_steps=1, total_steps=10)
DEPTHS = [4, 8, 16]


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


def meta(*shape):
    return torch.empty(shape, device="meta")


def port_grad_program(loss, *shapes):
    """The port's traced program of the gradients of ``loss``."""
    def loss_fn(params, batch):
        value = loss(*params)
        return value, value

    vg = S.value_and_grad(loss_fn)
    return extract_program(lambda *xs: vg(list(xs), {})[2],
                           *[meta(*s) for s in shapes])


def prims_and_params(prog):
    """Each op's prim and params, but for the reference's sharding
    annotations."""
    return [(op.prim, {k: v for k, v in op.params.items()
                       if k not in ("out_sharding", "sharding")})
            for op in prog.ops]


# -- the rules of cumsum and split --------------------------------------------


@pytest.mark.parametrize("reverse", [False, True],
                         ids=["forwards", "reverse"])
def test_cumsum_gradient_matches_jax_vjp(reverse):
    rng = np.random.default_rng(1)
    x, ct = (rng.standard_normal((2, 8, 4)).astype(np.float32)
             for _ in range(2))
    _, vjp = jax.vjp(lambda a: lax.cumsum(a, 1, reverse=reverse),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    out = torch.cumsum(xt.flip(1), 1).flip(1) if reverse else \
        torch.cumsum(xt, 1)
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(ct))
    close(got, want, RULE_TOL)


@pytest.mark.parametrize("reverse", [False, True],
                         ids=["forwards", "reverse"])
def test_cumsum_transposes_into_the_other_direction(reverse):
    from repro_torch.core import autodiff
    from repro_torch.core.ir import Op, Program
    # the port's tracer emits forward cumsums only; the rule is held on
    # a program made by hand for the reverse one
    prog = Program()
    x = prog.new_value((2, 8, 4), "float32")
    c = prog.new_value((2, 8, 4), "float32")
    loss = prog.new_value((), "float32")
    prog.inputs = [x]
    prog.add_op(Op("cumsum", {"axis": 1, "reverse": reverse}, [x], [c]))
    prog.add_op(Op("reduce_sum", {"axes": (0, 1, 2)}, [c], [loss]))
    (g,) = autodiff.value_and_grad(prog, [], loss, [x], set(), False)
    assert prog.types[g].shape == (2, 8, 4)
    jprog = jax_extract(
        jax.grad(lambda a: lax.cumsum(a, 1, reverse=reverse).sum()),
        jnp.zeros((2, 8, 4)))
    assert prims_and_params(prog) == prims_and_params(jprog)
    assert prims_and_params(prog)[-1] == (
        "cumsum", {"axis": 1, "reverse": not reverse})


def split_losses():
    def tfn(x):
        a, _, c, _ = torch.split(x, 4, dim=-1)
        return (a * c).sum()

    def jfn(x):
        a, _, c, _ = jnp.split(x, 4, axis=-1)
        return (a * c).sum()

    return tfn, jfn


def test_split_gradient_matches_jax_vjp():
    tfn, jfn = split_losses()
    x = np.random.default_rng(2).standard_normal((2, 16)).astype(
        np.float32)
    want = jax.grad(jfn)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(tfn(xt), xt)
    close(got, want, RULE_TOL)
    assert not got[:, 4:8].any() and not got[:, 12:].any()


def test_split_transposes_into_concatenate_with_zeros():
    tfn, jfn = split_losses()
    prog = port_grad_program(tfn, (2, 16))
    jprog = jax_extract(jax.grad(jfn), jnp.zeros((2, 16)))
    assert prims_and_params(prog) == prims_and_params(jprog)
    assert [p for p, _ in prims_and_params(prog)[-4:]] == [
        "mul", "broadcast_in_dim", "broadcast_in_dim", "concatenate"]


# -- a toy nested scan --------------------------------------------------------


TOY_N, TOY_T, TOY_B, TOY_D = 2, 5, 3, 4


def toy_loss(remat):
    """An outer scan over layers, an inner scan over time in its body."""
    def loss(p, x):
        def outer(h, ps):
            def inner(c, xt):
                c = torch.tanh(c @ ps["R"] + xt * ps["w"] + h)
                # a scan's outputs may not alias: ys get their own copy
                return c, c.clone()

            c, ys = T.scan_layers(inner, torch.zeros_like(h), x,
                                  with_ys=True)
            return h + c * ys.mean(0)

        h = T.scan_layers(outer, x.new_zeros(x.shape[1:]), p, remat=remat)
        return (h * h).sum()
    return loss


def jax_toy_loss(remat):
    def loss(p, x):
        def outer(h, ps):
            def inner(c, xt):
                c = jnp.tanh(c @ ps["R"] + xt * ps["w"] + h)
                return c, c

            c, ys = lax.scan(inner, jnp.zeros_like(h), x)
            return h + c * ys.mean(0), None

        body = jax.checkpoint(outer) if remat else outer
        h, _ = lax.scan(body, jnp.zeros(x.shape[1:]), p)
        return (h * h).sum()
    return loss


def toy_inputs():
    rng = np.random.default_rng(3)
    p = {"R": 0.5 * rng.standard_normal((TOY_N, TOY_D, TOY_D)),
         "w": rng.standard_normal((TOY_N, TOY_D))}
    x = rng.standard_normal((TOY_T, TOY_B, TOY_D))
    return ({k: v.astype(np.float32) for k, v in p.items()},
            x.astype(np.float32))


@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
def test_toy_nested_scan_gradients_match_jax(remat):
    p, x = toy_inputs()
    wl, wg = jax.value_and_grad(jax_toy_loss(remat))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    loss = toy_loss(remat)
    gl, _, gg = S.value_and_grad(
        lambda params, batch: (loss(params, batch["x"]),) * 2,
        remat=remat)({k: torch.from_numpy(v) for k, v in p.items()},
                     {"x": torch.from_numpy(x)})
    close(gl, wl, TOY_TOL)
    close_trees(gg, wg, TOY_TOL)
    assert all(float(g.abs().max()) > 0 for g in pytree.tree_leaves(gg))


def trip_counts(prog):
    return collections.Counter((op.prim, prog.trip_counts[i])
                               for i, op in enumerate(prog.ops))


@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
def test_toy_nested_scan_program_matches_the_reference(remat):
    loss = toy_loss(remat)
    vg = S.value_and_grad(
        lambda params, batch: (loss(params, batch["x"]),) * 2, remat=remat)
    p = {"R": meta(TOY_N, TOY_D, TOY_D), "w": meta(TOY_N, TOY_D)}
    prog = extract_program(lambda p, x: vg(p, {"x": x})[2], p,
                           meta(TOY_T, TOY_B, TOY_D))
    jprog = jax_extract(jax.grad(jax_toy_loss(remat)), {
        "R": jnp.zeros((TOY_N, TOY_D, TOY_D)),
        "w": jnp.zeros((TOY_N, TOY_D))}, jnp.zeros((TOY_T, TOY_B, TOY_D)))
    assert trip_counts(prog) == trip_counts(jprog)
    assert set(prog.trip_counts.values()) == {1, TOY_N, TOY_N * TOY_T}
    # the inner scan's gradient to its constants is carried across time:
    # an accumulator of R's (d, d) shape in the inner backward body
    inner = [op for i, op in enumerate(prog.ops)
             if prog.trip_counts[i] == TOY_N * TOY_T and
             op.prim == "add_any" and
             prog.types[op.results[0]].shape == (TOY_D, TOY_D)]
    assert len(inner) == 1


# -- the reduced model --------------------------------------------------------


def configs(layers, remat=False):
    jc = dataclasses.replace(jax_config(ARCH).reduced(), num_layers=layers,
                             remat=remat)
    tc = dataclasses.replace(get_config(ARCH).reduced(), num_layers=layers,
                             remat=remat)
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
    tok = rng.integers(0, jc.vocab_size, (B, SEQ)).astype(np.int32)
    tgt = rng.integers(0, jc.vocab_size, (B, SEQ)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)}
    tb = {"tokens": torch.from_numpy(tok), "targets": torch.from_numpy(tgt)}
    cache: dict = {}

    def result(kind, remat):
        key = (kind, remat)
        if key not in cache:
            jcr = configs(layers, remat)[0]
            if kind == "grads":
                cache[key] = jax.jit(jax.value_and_grad(
                    JS.make_loss_fn(jcr), has_aux=True))(jstate.params, jb)
            else:
                cache[key] = jax.jit(JS.make_train_step(
                    jcr, jadam.AdamConfig(**OPT)))(jstate, jb)
        return cache[key]

    return layers, jstate, tb, result


def port_state(jstate):
    return S.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")


@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
def test_loss_and_every_gradient_leaf(reference, remat):
    layers, jstate, tb, result = reference
    _, tc = configs(layers, remat)
    (wl, wce), wg = result("grads", remat)
    gl, gce, gg = S.value_and_grad(S.make_loss_fn(tc), remat=remat)(
        port_state(jstate).params, tb)
    close(gl, wl, STEP_TOL)
    close(gce, wce, STEP_TOL)
    close_trees(gg, wg, STEP_TOL)
    # the sLSTM's recurrent weight, a constant of the time scan, takes
    # its gradient through the scan
    if T.n_scan_blocks(tc):
        assert float(gg["layers"][7]["mix"]["R"].abs().max()) > 0


def test_train_step_matches_the_reference(reference):
    layers, jstate, tb, result = reference
    _, tc = configs(layers)
    jnew, jm = result("step", False)
    tnew, tm = S.make_train_step(tc, adam.AdamConfig(**OPT))(
        port_state(jstate), tb)
    for k in ("loss", "ce", "grad_norm"):
        close(tm[k], jm[k], STEP_TOL)
    assert int(tm["step"]) == 1
    close_trees(tnew, jnew, STEP_TOL)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max(initial=0))
                for a, b in zip(jax.tree_util.tree_leaves(jnew.params),
                                jax.tree_util.tree_leaves(jstate.params)))
    assert moved > 100 * STEP_TOL


def test_an_empty_layer_stack_trains():
    # the stock reduced config: 4 layers against a period of 8, so every
    # stacked leaf has a leading dim of 0 and no part in the loss
    jc, tc = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    assert T.n_scan_blocks(tc) == 0
    jstate = JS.init_train_state(jc, jax.random.PRNGKey(1))
    rng = np.random.default_rng(8)
    batch = {k: rng.integers(0, jc.vocab_size, (B, SEQ)).astype(np.int32)
             for k in ("tokens", "targets")}
    jnew, jm = jax.jit(JS.make_train_step(jc))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = port_state(jstate)
    tnew, tm = S.make_train_step(tc)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    close(tm["loss"], jm["loss"], STEP_TOL)
    close_trees(tnew, jnew, STEP_TOL)
    stacked = pytree.tree_leaves(tnew.params["layers"])
    assert stacked and all(x.shape[0] == 0 for x in stacked)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_gates_x20_block_gradients(kind):
    from test_torch_xlstm import B as XB
    from test_torch_xlstm import S as XS
    from test_torch_xlstm import configs as block_configs
    jcfg, tcfg = block_configs()
    jp, tp = block_params(kind, jcfg, 20.0)
    x = normal(2, (XB, XS, jcfg.d_model))
    ct = normal(3, (XB, XS, jcfg.d_model))
    jfn = JL.mlstm_apply if kind == "mlstm" else JL.slstm_apply
    tfn = L.mlstm_apply if kind == "mlstm" else L.slstm_apply
    _, vjp = jax.vjp(lambda p, a: jfn(jcfg, p, a), jp, jnp.asarray(x))
    wp, wx = vjp(jnp.asarray(ct))
    live = {k: v.detach().requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    keys = sorted(live)
    got = torch.autograd.grad(tfn(tcfg, live, xt),
                              [xt] + [live[k] for k in keys],
                              torch.from_numpy(ct))
    rel = 1e-5
    if kind == "mlstm":
        rel = 1e-6 * float(log_forget_prefix(tp, x).abs().max())
        assert 1e-4 < rel < 1e-3
    for g, w in zip(got, [wx] + [wp[k] for k in keys]):
        w = np.asarray(w, np.float32)
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=rel * float(np.abs(w).max()))


# -- the launcher -------------------------------------------------------------


def load_checkpoint(directory, step):
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    return manifest, [np.load(d / e["file"]) for e in manifest["leaves"]]


def test_the_launcher_matches_the_reference_from_one_checkpoint(tmp_path):
    jstate = JS.init_train_state(jax_config(ARCH).reduced(),
                                 jax.random.PRNGKey(0))
    for name in ("ref", "port"):
        jckpt.save(tmp_path / name, 0, jstate)
    jargs = argparse.Namespace(
        arch=ARCH, reduced=True, steps=3, batch=2, seq=32, plan="manual",
        compress="none", seed=0, ckpt_dir=str(tmp_path / "ref"),
        ckpt_every=10, log_every=5, fail_at=None, max_failures=0)
    assert jtrain.run_once(jargs, 0)
    report = launcher.Attempt(0)
    args = launcher.parse_args(
        ["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "2",
         "--seq", "32", "--ckpt-dir", str(tmp_path / "port"), "--device",
         "cpu"])
    assert launcher.run_once(get_config(ARCH).reduced(), args, 0, report)
    assert report.start_step == 0 and report.restore_s is not None
    jman, jleaves = load_checkpoint(tmp_path / "ref", 3)
    man, leaves = load_checkpoint(tmp_path / "port", 3)
    assert man == jman
    for entry, got, want in zip(man["leaves"], leaves, jleaves):
        np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=entry["path"])


def test_the_launcher_trains_on_two_ranks(tmp_path):
    # no longer refused (item 11e): the launcher trains the stock reduced
    # model on two ranks, its loss within 1e-4 of one process's (the
    # sLSTM's per-shard loop: tests/test_torch_xlstm_mesh_train.py)
    from test_torch_xlstm_mesh_train import check_entry_points_on_two_ranks
    check_entry_points_on_two_ranks(ARCH, tmp_path, serving=False)
