"""Training the reduced ``xlstm_350m`` on gloo meshes (CPU): train steps
through ``plan.apply`` on (1, 2) and 2x2, and the training launcher on
two ranks against the reference's launcher.

*plan.apply.*  The reduced f32 model at 8 layers (one period: 7 mLSTM
blocks and an sLSTM, whose time loop runs per shard), its train step
(``launch.specs``'s: loss, AdamW, default ``AdamConfig``) at B 4 x S
32, planned greedily under one explicit ``HardwareSpec`` for each mesh;
each plan runs the step with remat off and on (the body recomputed,
the per-shard loop with it).  The loss, the metrics and every leaf of
the new state within 1e-4 of one process (relative to the largest, at
least 1); the gradients enter the first moment as ``(1 - b1)`` times
the clipped gradient, so they are held too.

*The launcher.*  ``launch/train.py`` on two ranks (the reference's rules
route: the (data 1, model 2) mesh, ``--plan manual``'s
``MANUAL_RULES``, which shard the sequence on ``model``: each sLSTM's
time dim made whole once before its loop) at 8 layers, B 2 x S 32, 3
steps: uninterrupted; with a failure at step 2 and a checkpoint every
step, resumed and ending bit for bit as the uninterrupted run; and from
the reference's step-0 checkpoint, ending within 1e-4 of the
reference's launcher (``run_once`` of the same 8-layer config on one
device) from the same checkpoint.  The two ranks' losses within 1e-4 of
one process's.

The frontend models' counterparts are in
``tests/test_torch_frontend_mesh_train.py``, which shares these helpers.
"""

import argparse
import dataclasses
import json
import shutil

import numpy as np
import pytest

from repro_torch.launch import mesh as M
from repro_torch.launch import train as launcher
from test_torch_xlstm_mesh import (TOL, apply_rank, close, family_config,
                                   port_plan)

ARCH = "xlstm_350m"
LAYERS = 8
B, S = 4, 32
RANKS_TIMEOUT = 300.0
# the launcher: steps, batch, sequence
STEPS, LB, LS = 3, 2, 32
# run name -> the launcher's extra flags; "ref" resumes from the
# reference's step-0 checkpoint, copied into its directory first
RUNS = {"whole": ["--ckpt-every", "1"],
        "restart": ["--ckpt-every", "1", "--fail-at", "2"],
        "ref": []}


def train_cases(arch, layers, mesh):
    """The (1, 2) or 2x2 train plan of ``arch`` at ``layers``, with remat
    off and on (``apply_rank`` cases)."""
    text = port_plan(arch, layers, "train", B, S, mesh).to_json()
    return [(arch, layers, "train", B, S, {"port": text}, (), remat)
            for remat in (False, True)]


def argv(arch, ckpt_dir, *extra):
    return ["--arch", arch, "--steps", str(STEPS), "--batch", str(LB),
            "--seq", str(LS), "--log-every", "1", "--ckpt-dir",
            str(ckpt_dir), "--device", "cpu", *extra]


def launch_rank(rank, root, models):
    """Every run of ``RUNS`` for each model (``models``: arch -> layers),
    on this rank (or in one process)."""
    out = {}
    for arch, layers in models.items():
        cfg = family_config(arch, layers)
        for name, extra in RUNS.items():
            attempts = launcher.supervise(cfg, launcher.parse_args(
                argv(arch, root / arch / name, *extra)))
            out[arch, name] = {
                "attempts": [(a.start_step, a.error, a.mesh, len(a.step_ms))
                             for a in attempts],
                "losses": [lg for a in attempts for lg in a.losses]}
    return out


def load(directory, step):
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    return manifest, [np.load(d / e["file"]) for e in manifest["leaves"]]


def reference_run(arch, layers, root, monkeypatch):
    """The reference launcher (one device) at ``layers`` from its own
    step-0 checkpoint, which is copied for the port's ``ref`` run."""
    import jax

    from repro.ckpt import checkpoint as jckpt
    from repro.configs.base import get_config as jax_config
    from repro.launch import train as jtrain
    from repro.train import steps as JS
    jcfg = jax_config(arch).reduced()
    if layers is not None:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
    jckpt.save(root / arch / "reference", 0,
               JS.init_train_state(jcfg, jax.random.PRNGKey(0)))
    shutil.copytree(root / arch / "reference", root / arch / "ref")
    # the launcher takes its config by name: the cut one here
    monkeypatch.setattr(jtrain, "get_config", lambda name: jcfg)
    jargs = argparse.Namespace(
        arch=arch, reduced=False, steps=STEPS, batch=LB, seq=LS,
        plan="manual", compress="none", seed=0,
        ckpt_dir=str(root / arch / "reference"), ckpt_every=10,
        log_every=5, fail_at=None, max_failures=0)
    assert jtrain.run_once(jargs, 0)


def launcher_runs(models, root, monkeypatch):
    """One process's uninterrupted run and the reference's, then the
    ranks' runs, for each model."""
    one = {}
    for arch, layers in models.items():
        (one[arch],) = launcher.supervise(
            family_config(arch, layers), launcher.parse_args(
                argv(arch, root / arch / "one")))
        reference_run(arch, layers, root, monkeypatch)
    ranks = M.run_ranks(launch_rank, 2, root, models, timeout=RANKS_TIMEOUT)
    return root, one, ranks


def check_restart(root, ranks, arch):
    for r in ranks:
        assert r[arch, "whole"]["attempts"] == [(0, None, (1, 2), STEPS)]
        assert r[arch, "restart"]["attempts"] == [
            (0, "RuntimeError: injected node failure", (1, 2), 2),
            (2, None, (1, 2), 1)]
    man, leaves = load(root / arch / "restart", STEPS)
    wman, wleaves = load(root / arch / "whole", STEPS)
    assert man == wman
    for a, b in zip(leaves, wleaves):
        np.testing.assert_array_equal(a, b)


def check_one_process(one, ranks, arch):
    for name in RUNS:
        assert ranks[0][arch, name]["losses"] == \
            ranks[1][arch, name]["losses"]
    np.testing.assert_allclose(np.array(ranks[0][arch, "whole"]["losses"]),
                               np.array(one[arch].losses), rtol=TOL,
                               atol=TOL)


def check_reference(root, ranks, arch):
    for r in ranks:
        assert r[arch, "ref"]["attempts"] == [(0, None, (1, 2), STEPS)]
    man, leaves = load(root / arch / "ref", STEPS)
    wman, wleaves = load(root / arch / "reference", STEPS)
    assert man == wman
    for entry, x, y in zip(man["leaves"], leaves, wleaves):
        np.testing.assert_allclose(x, y, rtol=TOL, atol=TOL,
                                   err_msg=entry["path"])


@pytest.fixture(scope="module")
def steps():
    out = {}
    for mesh in ((1, 2), (2, 2)):
        runs = M.run_ranks(apply_rank, mesh[0] * mesh[1],
                           train_cases(ARCH, LAYERS, mesh),
                           timeout=RANKS_TIMEOUT)
        out["x".join(map(str, mesh))] = runs
    return out


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        yield launcher_runs({ARCH: LAYERS},
                            tmp_path_factory.mktemp("xlstm_launch_mesh"), mp)
    finally:
        mp.undo()


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_equals_one_process(steps, mesh, remat):
    for r in steps[mesh]:
        res = r["cases"][ARCH, LAYERS, "train", S, remat]["port"]
        assert close(res), (mesh, remat, max(res["errors"]))
        # the sLSTM's loop once a step, once more recomputed under remat
        assert len(res["scans"]) == 1 + remat


def test_a_restart_on_two_ranks_ends_bit_for_bit(launched):
    root, _, ranks = launched
    check_restart(root, ranks, ARCH)


def test_the_ranks_agree_and_match_one_process(launched):
    _, one, ranks = launched
    check_one_process(one, ranks, ARCH)


def test_two_ranks_match_the_reference_launcher(launched):
    root, _, ranks = launched
    check_reference(root, ranks, ARCH)


# -- the entry points on two ranks, for each family's own test file ----------


def entry_points(arch, ckpt_dir, serving=True, training=True):
    """The stock reduced model of ``arch`` through the serving launcher
    (``--plan toast``, 2 prompts of 2 tokens, 2 generated) and one step
    of the training launcher (``--plan manual``, B 2 x S 16), on this
    group or in one process: the tokens and the loss."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    out = {}
    if serving:
        res = serve.serve(serve.parse_args([
            "--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "2", "--gen", "2", "--plan", "toast", "--device", "cpu"]))
        out["mesh"] = hasattr(res.tokens, "device_mesh")
        out["tokens"] = res.tokens.full_tensor() if out["mesh"] else \
            res.tokens
    if training:
        (att,) = launcher.supervise(
            get_config(arch).reduced(), launcher.parse_args([
                "--arch", arch, "--reduced", "--steps", "1", "--batch", "2",
                "--seq", "16", "--ckpt-dir", str(ckpt_dir), "--device",
                "cpu"]))
        out["losses"], out["rules"] = att.losses, att.rules
    return out


def entry_points_rank(rank, arch, ckpt_dir, serving, training):
    return entry_points(arch, ckpt_dir, serving, training)


def check_entry_points_on_two_ranks(arch, tmp_path, serving=True,
                                    training=True):
    """Both launchers run ``arch`` on two ranks (no refusal is left): the
    served tokens equal one process's, the loss within 1e-4."""
    import torch
    one = entry_points(arch, tmp_path / "one", serving, training)
    ranks = M.run_ranks(entry_points_rank, 2, arch, tmp_path / "two",
                        serving, training, timeout=RANKS_TIMEOUT)
    for r in ranks:
        if serving:
            assert r["mesh"] and not one["mesh"]
            assert torch.equal(r["tokens"], one["tokens"])
        if training:
            assert r["rules"] is not None and one["rules"] is None
            np.testing.assert_allclose(r["losses"], one["losses"],
                                       rtol=TOL, atol=TOL)
