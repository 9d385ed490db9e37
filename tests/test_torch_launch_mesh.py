"""The training launcher on a mesh of gloo ranks (CPU): restarts and the
elastic re-shard of its checkpoints.

``repro_torch.launch.train`` runs on a process group of two ranks
(``launch.mesh.run_ranks``) as the reference's launcher runs on a mesh:
the (data 1, model 2) mesh, ``MANUAL_RULES``, the state placed by
``specs_from_rules``, the step eager on DTensors, checkpoints made whole
on the host and written by rank 0, and restored onto the shards.  Reduced
f32 ``qwen2_05b`` at B 2 x S 32, 4 steps:

- ``--fail-at 3 --ckpt-every 2`` on 2 ranks ends bit for bit equal to the
  uninterrupted 2-rank run (their final checkpoints, file by file);
- a checkpoint written by 2 ranks resumes in one process, and one written
  by one process resumes on 2 ranks, each continuing within 1e-4 of the
  uninterrupted run of the other kind (f32 sums in another order);
- every rank's state leaves are placed as ``placements_for`` of the
  ``specs_from_rules`` spec;
- in bf16 (remat, B 4 x S 64, 6 steps, the rules the full-width search
  chose on the card: batch and hidden on ``model``), the check the card
  makes: every leaf of the two ranks' final state within 2e-2
  (``|a - b| / |b|``) of one process's, beyond the distance from that
  run of one process taking each batch as two microbatches (the same
  math rounded otherwise); the key bias, whose gradient cancels, is the
  one leaf that regrouping moves by more than 2e-2 (AdamW normalises
  its rounding noise).
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.launch import mesh as M
from repro_torch.launch import train as launcher

TOL = 1e-4
RANKS_TIMEOUT = 240.0
# run name -> the launcher's extra flags; "from_one" resumes from a
# one-process checkpoint copied into its directory first
RUNS = {"whole": ["--ckpt-every", "2"],
        "restart": ["--ckpt-every", "2", "--fail-at", "3"],
        "from_one": []}


def argv(ckpt_dir, *extra):
    return ["--arch", "qwen2_05b", "--reduced", "--steps", "4", "--batch",
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


BF16_RULES = {"batch": ("model",), "hidden": ("model",)}
BF16_ARGV = ["--steps", "6", "--batch", "4", "--seq", "64", "--device",
             "cpu", "--ckpt-every", "6"]


def bf16_config():
    return dataclasses.replace(get_config("qwen2_05b").reduced(),
                               param_dtype="bfloat16", remat=True)


def bf16_run(ckpt_dir, mesh_rules=None, accum_steps=1):
    """The bf16 schedule through the launcher; its final state, whole."""
    from repro_torch.train import steps as TS
    saved = launcher.mesh_rules, launcher.make_train_step
    if mesh_rules is not None:
        launcher.mesh_rules = lambda *a: dict(mesh_rules)
    launcher.make_train_step = lambda c: TS.make_train_step(
        c, accum_steps=accum_steps)
    try:
        (run,) = launcher.supervise(bf16_config(), launcher.parse_args(
            BF16_ARGV + ["--ckpt-dir", str(ckpt_dir)]))
    finally:
        launcher.mesh_rules, launcher.make_train_step = saved
    leaves, paths = pytree.flatten_with_paths(run.state)
    return [(p, (x.full_tensor() if hasattr(x, "full_tensor") else x)
             .double()) for x, p in zip(leaves, paths)]


def launch_rank(rank, root):
    """Every run of ``RUNS`` in order on this rank; what each did."""
    cfg = get_config("qwen2_05b").reduced()
    out = {"bf16": bf16_run(root / "bf16", BF16_RULES)}
    for name, extra in RUNS.items():
        attempts = launcher.supervise(
            cfg, launcher.parse_args(argv(root / name, *extra)))
        final = attempts[-1]
        mesh = pytree.tree_leaves(final.state)[0].device_mesh
        out[name] = {
            "attempts": [(a.start_step, a.error, a.mesh, len(a.step_ms))
                         for a in attempts],
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("launch_mesh")
    cfg = get_config("qwen2_05b").reduced()
    # one process: the uninterrupted run, whose step-2 checkpoint the
    # ranks resume from
    (one,) = launcher.supervise(cfg, launcher.parse_args(
        argv(root / "one", "--ckpt-every", "2")))
    copy_step(root / "one", root / "from_one", 2)
    ranks = M.run_ranks(launch_rank, 2, root, timeout=RANKS_TIMEOUT)
    # one process resumes from the ranks' step-2 checkpoint
    copy_step(root / "whole", root / "from_two", 2)
    (from_two,) = launcher.supervise(cfg, launcher.parse_args(
        argv(root / "from_two")))
    one_bf16 = {"whole": bf16_run(root / "bf16_whole"),
                "split": bf16_run(root / "bf16_split", accum_steps=2)}
    return root, one, ranks, from_two, one_bf16


def test_a_restart_on_the_mesh_ends_bit_for_bit_as_the_uninterrupted_run(
        runs):
    root, _, ranks, _, _ = runs
    for r in ranks:
        assert r["whole"]["attempts"] == [(0, None, (1, 2), 4)]
        assert r["restart"]["attempts"] == [
            (0, "RuntimeError: injected node failure", (1, 2), 3),
            (2, None, (1, 2), 2)]
    man, leaves = load(root / "restart", 4)
    wman, wleaves = load(root / "whole", 4)
    assert man == wman
    for a, b in zip(leaves, wleaves):
        np.testing.assert_array_equal(a, b)


def test_the_ranks_agree_on_every_loss(runs):
    _, _, ranks, _, _ = runs
    for name in RUNS:
        assert ranks[0][name]["losses"] == ranks[1][name]["losses"]


def test_a_one_process_checkpoint_resumes_on_two_ranks(runs):
    root, one, ranks, _, _ = runs
    assert ranks[0]["from_one"]["attempts"] == [(2, None, (1, 2), 2)]
    man, leaves = load(root / "from_one", 4)
    oman, oleaves = load(root / "one", 4)
    assert man == oman
    for entry, a, b in zip(man["leaves"], leaves, oleaves):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                   err_msg=entry["path"])


def test_a_two_rank_checkpoint_resumes_in_one_process(runs):
    root, _, _, from_two, _ = runs
    assert from_two.start_step == 2 and from_two.mesh is None
    man, leaves = load(root / "from_two", 4)
    wman, wleaves = load(root / "whole", 4)
    assert man == wman
    for entry, a, b in zip(man["leaves"], leaves, wleaves):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                   err_msg=entry["path"])


def test_the_two_rank_checkpoint_holds_the_one_process_files(runs):
    """The files rank 0 writes from the shards are those a one-process
    save of the same values writes: the same manifest, and each leaf's
    ``.npy`` header."""
    root, _, _, _, _ = runs
    for d in ("whole", "one"):
        assert (root / d / "step_00000004" / "manifest.json").exists()
    man, _ = load(root / "whole", 4)
    oman, _ = load(root / "one", 4)
    assert man == oman
    for entry in man["leaves"]:
        heads = [(root / d / "step_00000004" / entry["file"]).read_bytes()
                 [:128] for d in ("whole", "one")]
        assert heads[0] == heads[1], entry["path"]


def test_every_state_leaf_is_placed_by_the_rules(runs):
    _, _, ranks, _, _ = runs
    for r in ranks:
        for name in RUNS:
            assert r[name]["misplaced"] == [], name


def test_the_mesh_runs_match_one_process_losses(runs):
    _, one, ranks, _, _ = runs
    got = ranks[0]["whole"]["losses"]
    np.testing.assert_allclose(np.array(got), np.array(one.losses),
                               rtol=TOL, atol=TOL)
    assert not torch.is_tensor(got[0][0])


def rel(a, b) -> float:
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def test_bf16_on_two_ranks_within_the_regrouping_noise_of_one_process(
        runs):
    _, _, ranks, _, one = runs
    far = {}
    for (path, mesh), (_, split), (_, whole) in zip(
            ranks[0]["bf16"], one["split"], one["whole"]):
        assert rel(mesh, whole) <= rel(split, whole) + 2e-2, path
        far[path] = rel(split, whole)
    # the noise floor of the batch split, the one leaf above 2e-2
    assert [p for p, d in far.items() if d > 2e-2] == [
        ".params['layers'][0]['mix']['bk']"]
