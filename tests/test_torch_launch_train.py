"""Donated steps and the training launcher, on the CPU.

Donation (``donate_argnums``, ``repro_torch.jit``): each output, in
flattening order, takes the earliest donated leaf of its shape and dtype
that no output took yet, as XLA aliases buffers; the step's value is
written into that leaf and the leaf itself is returned.  On the CPU the
write happens after the step returns, as the captured graph does it on
the card (``tests/test_torch_cuda.py``).

The launcher (``repro_torch.launch.train``) runs against the reference's
(``repro.launch.train``) on a reduced f32 ``qwen2_05b`` at B 2 x S 32:
both checkpoint directories are seeded with one step-0 checkpoint that
the reference's ``save`` wrote from the reference's initial state, so
each launcher resumes from the same weights (the port through its own
checkpoint module) and trains 4 steps on the same pipeline; the final
checkpoints agree within 1e-4 (f32 sums in another order), their step
exactly.  A run with a failure injected resumes from its checkpoint and
ends equal, bit for bit, to an uninterrupted run.
"""

import argparse
import json
import re

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.launch import train as jtrain
from repro.train import steps as jsteps
from repro_torch import pytree
from repro_torch.api import Request, Session
from repro_torch.configs import get_config
from repro_torch.core.cost_model import MeshSpec
from repro_torch.jit import jit
from repro_torch.launch import train as launcher
from repro_torch.train import steps as TS

TOL = 1e-4


def toy_step(state, x):
    new = {"n": state["n"] + 1, "w": state["w"] * 0.5 + x}
    return new, {"n": state["n"] * 2, "sum": (state["w"] * x).sum()}


def toy_args():
    return ({"n": torch.tensor(1.0), "w": torch.arange(4.0)},
            torch.ones(4))


def toy_plan(fn):
    state, x = toy_args()
    meta = pytree.tree_map(lambda t: torch.empty(t.shape, device="meta"),
                           (state, x))
    return Session(fn, meta).partition(Request(
        mesh=MeshSpec(("data", "model"), (1, 1)), min_dims=1,
        backend="greedy"))


def compiled(via, fn, traced=None, **kw):
    """``fn`` through ``jit`` or through the plan of ``traced`` (default:
    ``fn``; a step that writes into its input cannot be traced)."""
    if via == "plan":
        return toy_plan(traced or fn).apply(fn, device="cpu", **kw)
    return jit(fn, "cpu", **kw)


VIAS = ["jit", "plan"]
# the first argument's path under each: the plan's paths hold the
# reference's (args, kwargs) wrapping
STATE_PATH = {"jit": "[0]", "plan": "[0][0]"}


@pytest.mark.parametrize("via", VIAS)
def test_donated_leaves_come_back_as_the_input_tensors(via):
    state, x = toy_args()
    want, want_m = toy_step(*toy_args())
    x_version = x._version
    got, got_m = compiled(via, toy_step, donate_argnums=0)(state, x)
    assert got["n"] is state["n"] and got["w"] is state["w"]
    for k in ("n", "w"):
        assert torch.equal(got[k], want[k])
    for k in ("n", "sum"):
        assert torch.equal(got_m[k], want_m[k])
        assert all(got_m[k] is not t for t in state.values())
    assert x._version == x_version and torch.equal(x, torch.ones(4))


@pytest.mark.parametrize("via", VIAS)
def test_without_donation_nothing_is_written(via):
    state, x = toy_args()
    got, _ = compiled(via, toy_step)(state, x)
    assert got["w"] is not state["w"]
    assert torch.equal(state["w"], torch.arange(4.0))


def test_outputs_take_donated_buffers_in_flattening_order():
    """As XLA: the metrics, returned first, take the first donated leaf
    of their shape; the new state's leaf of that shape then has none."""
    def metrics_first(state, x):
        new, metrics = toy_step(state, x)
        return metrics, new

    state, x = toy_args()
    metrics, new = jit(metrics_first, "cpu", donate_argnums=0)(state, x)
    assert metrics["n"] is state["n"] and new["w"] is state["w"]
    assert new["n"] is not state["n"]
    assert torch.equal(metrics["n"], torch.tensor(2.0))


def test_donate_argnums_takes_any_argument():
    def swapped(x, state):
        return toy_step(state, x)

    state, x = toy_args()
    got, _ = jit(swapped, "cpu", donate_argnums=(1,))(x, state)
    assert got["w"] is state["w"]
    assert torch.equal(got["w"], torch.arange(4.0) * 0.5 + 1)


@pytest.mark.parametrize("via", VIAS)
def test_a_donated_leaf_with_no_output_to_take_it_raises(via):
    def drops_n(state, x):
        return {"w": state["w"] * 0.5 + x}

    state, x = toy_args()
    with pytest.raises(ValueError, match=rf"donated input "
                       rf"{re.escape(STATE_PATH[via])}\['n'\] has no "
                       rf"output"):
        compiled(via, drops_n, donate_argnums=0)(state, x)


@pytest.mark.parametrize("via", VIAS)
def test_a_step_writing_into_its_donated_input_raises(via):
    def in_place(state, x):
        state["w"].add_(x)
        return toy_step(state, x)

    state, x = toy_args()
    with pytest.raises(ValueError, match=rf"wrote into its input "
                       rf"{re.escape(STATE_PATH[via])}\['w'\]"):
        compiled(via, in_place, toy_step, donate_argnums=0)(state, x)


def test_the_train_step_donates_its_state_not_its_metrics():
    """The reduced f32 train step: every new state leaf is written into
    the old one's tensor (moments and parameters of equal shapes pair by
    position), the metrics are fresh, and the values equal a call without
    donation."""
    cfg = get_config("qwen2_05b").reduced()
    step = TS.make_train_step(cfg)
    state = TS.init_train_state(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    copy = pytree.tree_map(torch.clone, state)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16),
                                              dtype=np.int32))
             for k in ("tokens", "targets")}
    want, want_m = jit(step, "cpu")(copy, batch)
    mine = pytree.tree_leaves(state)
    got, got_m = jit(step, "cpu", donate_argnums=0)(state, batch)
    assert all(a is b for a, b in zip(pytree.tree_leaves(got), mine))
    assert not any(m is t for m in got_m.values() for t in mine)
    for a, b in zip(pytree.tree_leaves((got, got_m)),
                    pytree.tree_leaves((want, want_m))):
        assert torch.equal(a, b)


# --- the launcher -------------------------------------------------------------


def port_args(ckpt_dir, *extra):
    return launcher.parse_args(
        ["--arch", "qwen2_05b", "--reduced", "--steps", "4", "--batch", "2",
         "--seq", "32", "--ckpt-dir", str(ckpt_dir), "--device", "cpu",
         *extra])


def load_checkpoint(directory, step):
    """The manifest and every leaf of a committed checkpoint."""
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    return manifest, [np.load(d / e["file"]) for e in manifest["leaves"]]


def test_the_launcher_matches_the_reference_from_one_checkpoint(tmp_path):
    jstate = jsteps.init_train_state(jget_config("qwen2_05b").reduced(),
                                     jax.random.PRNGKey(0))
    for name in ("ref", "port"):
        jckpt.save(tmp_path / name, 0, jstate)
    jargs = argparse.Namespace(
        arch="qwen2_05b", reduced=True, steps=4, batch=2, seq=32,
        plan="manual", compress="none", seed=0,
        ckpt_dir=str(tmp_path / "ref"), ckpt_every=10, log_every=5,
        fail_at=None, max_failures=0)
    assert jtrain.run_once(jargs, 0)
    report = launcher.Attempt(0)
    cfg = get_config("qwen2_05b").reduced()
    assert launcher.run_once(cfg, port_args(tmp_path / "port"), 0, report)
    assert report.start_step == 0 and report.restore_s is not None
    jman, jleaves = load_checkpoint(tmp_path / "ref", 4)
    man, leaves = load_checkpoint(tmp_path / "port", 4)
    assert man == jman
    for entry, got, want in zip(man["leaves"], leaves, jleaves):
        if entry["path"] == ".opt.step":
            assert got == want == 4
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=entry["path"])


def test_a_failure_resumes_and_ends_equal_to_an_uninterrupted_run(
        tmp_path, capsys):
    cfg = get_config("qwen2_05b").reduced()
    (whole,) = launcher.supervise(cfg, port_args(
        tmp_path / "whole", "--ckpt-every", "2"))
    attempts = launcher.supervise(cfg, port_args(
        tmp_path / "run", "--ckpt-every", "2", "--fail-at", "3"))
    out = capsys.readouterr().out
    assert "[supervisor] attempt 0 failed: injected node failure" in out
    assert "[resume] from step 2" in out
    assert [a.start_step for a in attempts] == [0, 2]
    assert attempts[0].error == "RuntimeError: injected node failure"
    assert attempts[0].state is None
    assert [s["step"] for s in attempts[0].saves] == [2]
    for a, b in zip(pytree.tree_leaves(attempts[1].state),
                    pytree.tree_leaves(whole.state)):
        assert torch.equal(a, b)
    man, leaves = load_checkpoint(tmp_path / "run", 4)
    wman, wleaves = load_checkpoint(tmp_path / "whole", 4)
    assert man == wman
    for a, b in zip(leaves, wleaves):
        np.testing.assert_array_equal(a, b)


def test_the_toast_plan_runs_on_the_cpu(tmp_path, capsys):
    cfg = get_config("qwen2_05b").reduced()
    (run,) = launcher.supervise(cfg, port_args(
        tmp_path, "--plan", "toast", "--steps", "2", "--log-every", "1"))
    out = capsys.readouterr().out
    assert "[toast] cost=1.0000" in out and "training complete" in out
    assert run.captures == 0 and run.replays == 0      # eager on the CPU
    assert all(torch.isfinite(x.float()).all()
               for x in pytree.tree_leaves(run.state))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_for_sizes_the_mesh_as_the_reference(n):
    """The reference's ``run_once`` sizes its mesh ``(max(1, n // 2),
    min(2, n))`` and ``build_mesh`` trims it to the devices; the port's
    ``mesh_for`` gives the same ``MeshSpec`` (the reference's fields)."""
    from repro.core.cost_model import MeshSpec as JMeshSpec
    want = JMeshSpec(("data", "model"), (max(1, n // 2), min(2, n)))
    got = launcher.mesh_for(n)
    assert (got.axes, got.sizes, got.dcn_axes) == \
        (want.axes, want.sizes, want.dcn_axes)
    assert got.num_devices == want.num_devices == (1 if n == 1 else n)


def test_without_a_card_the_launcher_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--reduced", "--steps", "1", "--ckpt-dir",
                       str(tmp_path)])
