"""The training launcher with the MoE models on two gloo ranks (CPU):
restarts, checkpoints that cross between one process and two ranks, and
the reference's launcher.

``repro_torch.launch.train`` runs reduced f32 ``mixtral_8x22b`` and
``arctic_480b`` (2 layers, d 64, 4 experts, top-2) at B 2 x S 32 for 4
steps on a process group of two ranks (``launch.mesh.run_ranks``), the
reference's rules route: the (data 1, model 2) mesh, the state placed by
``specs_from_rules`` (the expert stacks by the rules' ``"experts"``
entry), the step eager on DTensors.  Per model:

- ``--plan manual --fail-at 3 --ckpt-every 2`` ends bit for bit equal to
  the uninterrupted run (their final checkpoints, file by file);
- a checkpoint written by two ranks resumes in one process, and one
  written by one process resumes on two ranks, each ending within 1e-4
  of the uninterrupted run of the other kind (f32 sums in another
  order), the two ranks' losses within 1e-4 of one process's;
- every state leaf of every run is placed as ``placements_for`` of the
  ``specs_from_rules`` spec;
- ``--plan manual`` and ``--plan toast`` from one step-0 checkpoint the
  reference's ``save`` wrote end within 1e-4 of the reference launcher's
  ``run_once`` from the same checkpoint, the manifests equal.

Four ranks, the rules against the reference's search, and
``specs_from_rules`` against the reference's are in
``tests/test_torch_moe_mesh_train_launch_rules.py``.
"""

import argparse
import json
import shutil

import jax
import numpy as np
import pytest

from repro.ckpt import checkpoint as jckpt
from repro.configs.base import get_config as jax_config
from repro.launch import train as jtrain
from repro.train import steps as JS
from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.launch import mesh as M
from repro_torch.launch import train as launcher

TOL = 1e-4
STEPS = 4
RANKS_TIMEOUT = 300.0
ARCHS = ("mixtral_8x22b", "arctic_480b")
# run name -> the launcher's extra flags; "from_one" resumes from a
# one-process checkpoint, "ref_*" from the reference's step-0 checkpoint,
# each copied into its directory first
RUNS = {"whole": ["--ckpt-every", "2"],
        "restart": ["--ckpt-every", "2", "--fail-at", "3"],
        "from_one": [],
        "ref_manual": ["--plan", "manual"],
        "ref_toast": ["--plan", "toast"]}


def argv(arch, ckpt_dir, *extra):
    return ["--arch", arch, "--reduced", "--steps", str(STEPS), "--batch",
            "2", "--seq", "32", "--ckpt-dir", str(ckpt_dir), "--device",
            "cpu", *extra]


def placement_errors(cfg, state, rules, mesh):
    """Leaf paths whose placements are not ``placements_for`` of the
    rules' spec."""
    from repro_torch.launch.specs import (shardings_from_rules,
                                          state_logical_axes)
    want = shardings_from_rules(state, state_logical_axes(cfg, state),
                                rules, mesh)
    leaves, paths = pytree.flatten_with_paths(state)
    return [p for x, sh, p in zip(leaves, pytree.tree_leaves(want), paths)
            if tuple(x.placements) != sh.placements(x.ndim)]


def launch_rank(rank, root, runs):
    """Every run of ``runs`` for each model, in order, on this rank."""
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        for name in runs:
            attempts = launcher.supervise(cfg, launcher.parse_args(
                argv(arch, root / arch / name, *RUNS[name])))
            final = attempts[-1]
            mesh = pytree.tree_leaves(final.state)[0].device_mesh
            out[arch, name] = {
                "attempts": [(a.start_step, a.error, a.mesh, len(a.step_ms))
                             for a in attempts],
                "rules": final.rules,
                "misplaced": placement_errors(cfg, final.state, final.rules,
                                              mesh),
                "losses": [lg for a in attempts for lg in a.losses]}
    return out


def load(directory, step):
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    return manifest, [np.load(d / e["file"]) for e in manifest["leaves"]]


def copy_step(src, dst, step):
    name = f"step_{step:08d}"
    shutil.copytree(src / name, dst / name)


def reference_run(arch, root):
    """The reference launcher from its own step-0 checkpoint (one device:
    its two plans take the same steps), and that checkpoint copied for
    the port's runs."""
    jstate = JS.init_train_state(jax_config(arch).reduced(),
                                 jax.random.PRNGKey(0))
    for name in ("ref", "ref_manual", "ref_toast"):
        jckpt.save(root / arch / name, 0, jstate)
    jargs = argparse.Namespace(
        arch=arch, reduced=True, steps=STEPS, batch=2, seq=32, plan="manual",
        compress="none", seed=0, ckpt_dir=str(root / arch / "ref"),
        ckpt_every=10, log_every=5, fail_at=None, max_failures=0)
    assert jtrain.run_once(jargs, 0)


def assert_close_checkpoints(a, b, step):
    man, leaves = load(a, step)
    wman, wleaves = load(b, step)
    assert man == wman
    for entry, x, y in zip(man["leaves"], leaves, wleaves):
        np.testing.assert_allclose(x, y, rtol=TOL, atol=TOL,
                                   err_msg=entry["path"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_launch_mesh")
    one, from_two = {}, {}
    for arch in ARCHS:
        (one[arch],) = launcher.supervise(
            get_config(arch).reduced(), launcher.parse_args(
                argv(arch, root / arch / "one", "--ckpt-every", "2")))
        copy_step(root / arch / "one", root / arch / "from_one", 2)
        reference_run(arch, root)
    ranks = M.run_ranks(launch_rank, 2, root, list(RUNS),
                        timeout=RANKS_TIMEOUT)
    for arch in ARCHS:
        copy_step(root / arch / "whole", root / arch / "from_two", 2)
        (from_two[arch],) = launcher.supervise(
            get_config(arch).reduced(), launcher.parse_args(
                argv(arch, root / arch / "from_two")))
    return root, one, ranks, from_two


@pytest.mark.parametrize("arch", ARCHS)
def test_a_restart_on_two_ranks_ends_bit_for_bit_as_the_uninterrupted_run(
        runs, arch):
    root, _, ranks, _ = runs
    for r in ranks:
        assert r[arch, "whole"]["attempts"] == [(0, None, (1, 2), 4)]
        assert r[arch, "restart"]["attempts"] == [
            (0, "RuntimeError: injected node failure", (1, 2), 3),
            (2, None, (1, 2), 2)]
    man, leaves = load(root / arch / "restart", STEPS)
    wman, wleaves = load(root / arch / "whole", STEPS)
    assert man == wman
    assert any("['ffn']['wgate']" in e["path"] for e in man["leaves"])
    for a, b in zip(leaves, wleaves):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_ranks_agree_and_match_one_process(runs, arch):
    _, one, ranks, _ = runs
    for name in RUNS:
        assert ranks[0][arch, name]["losses"] == \
            ranks[1][arch, name]["losses"]
    got = ranks[0][arch, "whole"]["losses"]
    np.testing.assert_allclose(np.array(got), np.array(one[arch].losses),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_one_process_checkpoint_resumes_on_two_ranks(runs, arch):
    root, _, ranks, _ = runs
    assert ranks[0][arch, "from_one"]["attempts"] == [(2, None, (1, 2), 2)]
    assert_close_checkpoints(root / arch / "from_one", root / arch / "one",
                             STEPS)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_two_rank_checkpoint_resumes_in_one_process(runs, arch):
    root, _, _, from_two = runs
    assert from_two[arch].start_step == 2 and from_two[arch].mesh is None
    assert_close_checkpoints(root / arch / "from_two", root / arch / "whole",
                             STEPS)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_state_leaf_is_placed_by_the_rules(runs, arch):
    _, _, ranks, _ = runs
    for r in ranks:
        for name in RUNS:
            assert r[arch, name]["misplaced"] == [], (arch, name)
        assert r[arch, "ref_toast"]["rules"]["experts"] == ("model",)


@pytest.mark.parametrize("plan", ["manual", "toast"])
@pytest.mark.parametrize("arch", ARCHS)
def test_two_ranks_match_the_reference_launcher(runs, arch, plan):
    root, _, ranks, _ = runs
    for r in ranks:
        assert r[arch, f"ref_{plan}"]["attempts"] == [(0, None, (1, 2), 4)]
    assert_close_checkpoints(root / arch / f"ref_{plan}", root / arch / "ref",
                             STEPS)

