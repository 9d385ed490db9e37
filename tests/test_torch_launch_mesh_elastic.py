"""The training launcher on other meshes (CPU gloo ranks): a checkpoint of
one process restored onto a (data 2, model 2) group of 4, the hybrid
model with remat on 2 ranks, the command line under ``torchrun``, and the
pieces of ``launch/mesh.py`` the launchers stand on.

Reduced f32 models at B 2 x S 32 (B 4 on the (2, 2) mesh, whose batch
is split two ways), ``MANUAL_RULES``; every mesh run is held against one
process within 1e-4 (f32 sums in another order).
"""

import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.launch import mesh as M
from repro_torch.launch import train as launcher
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.train import steps as TS

TOL = 1e-4
RANKS_TIMEOUT = 240.0


def argv(arch, ckpt_dir, *extra, batch=2):
    return ["--arch", arch, "--reduced", "--steps", "4", "--batch",
            str(batch), "--seq", "32", "--ckpt-dir", str(ckpt_dir),
            "--device", "cpu", *extra]


def load(directory, step):
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    return manifest, [np.load(d / e["file"]) for e in manifest["leaves"]]


def assert_close_checkpoints(a, b, step):
    man, leaves = load(a, step)
    wman, wleaves = load(b, step)
    assert man == wman
    for entry, x, y in zip(man["leaves"], leaves, wleaves):
        np.testing.assert_allclose(x, y, rtol=TOL, atol=TOL,
                                   err_msg=entry["path"])


def hybrid_cfg():
    return get_config("recurrentgemma_2b").reduced().__class__(
        **{**get_config("recurrentgemma_2b").reduced().__dict__,
           "remat": True})


def elastic_rank(rank, ckpt_dir):
    """Resume the one-process step-2 checkpoint on this group; the mesh
    and each leaf's placements."""
    (run,) = launcher.supervise(
        get_config("qwen2_05b").reduced(),
        launcher.parse_args(argv("qwen2_05b", ckpt_dir, batch=4)))
    return {"start": run.start_step, "mesh": run.mesh, "rules": run.rules,
            "placements": [str(tuple(x.placements)) for x in
                           pytree.tree_leaves(run.state)]}


def hybrid_rank(rank, ckpt_dir):
    (run,) = launcher.supervise(hybrid_cfg(), launcher.parse_args(
        argv("recurrentgemma_2b", ckpt_dir, "--steps", "2")))
    return {"mesh": run.mesh, "losses": run.losses,
            "local_ops": dict(sharding.local_ops)}


def test_a_one_process_checkpoint_resumes_on_a_2x2_group(tmp_path):
    cfg = get_config("qwen2_05b").reduced()
    (one,) = launcher.supervise(cfg, launcher.parse_args(
        argv("qwen2_05b", tmp_path / "one", "--ckpt-every", "2",
             batch=4)))
    shutil.copytree(tmp_path / "one" / "step_00000002",
                    tmp_path / "four" / "step_00000002")
    ranks = M.run_ranks(elastic_rank, 4, tmp_path / "four",
                        timeout=RANKS_TIMEOUT)
    for r in ranks:
        assert r["start"] == 2 and r["mesh"] == (2, 2)
    # MANUAL_RULES shard the weights on model (the batch takes data)
    assert "(Replicate(), Shard(" in " ".join(ranks[0]["placements"])
    assert_close_checkpoints(tmp_path / "four", tmp_path / "one", 4)


def test_the_hybrid_with_remat_trains_on_two_ranks_as_in_one_process(
        tmp_path):
    (one,) = launcher.supervise(hybrid_cfg(), launcher.parse_args(
        argv("recurrentgemma_2b", tmp_path / "one", "--steps", "2")))
    ranks = M.run_ranks(hybrid_rank, 2, tmp_path / "two",
                        timeout=RANKS_TIMEOUT)
    for r in ranks:
        assert r["mesh"] == (1, 2)
        np.testing.assert_allclose(np.array(r["losses"]),
                                   np.array(one.losses), rtol=TOL, atol=TOL)
    assert_close_checkpoints(tmp_path / "two", tmp_path / "one", 2)


def test_the_launcher_runs_under_torchrun(tmp_path):
    """The command line on two ranks as ``torchrun`` starts them: the
    group from the environment, one line per step from rank 0 only."""
    env = dict(os.environ, PYTHONPATH="src" + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         *argv("qwen2_05b", tmp_path, "--steps", "2", "--log-every", "1")],
        capture_output=True, text=True, timeout=RANKS_TIMEOUT, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    assert out.count("step 2: loss=") == 1, out
    assert out.count("training complete") == 1, out
    assert (tmp_path / "step_00000002" / "manifest.json").exists()


def test_without_the_torchrun_environment_the_process_stays_alone():
    import torch.distributed as dist
    keys = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.pop(k) for k in keys if k in os.environ}
    try:
        assert M.init_from_env() == 1
        assert not dist.is_initialized()
        assert M.group_size() == 1 and M.group_rank() == 0
        assert M.from_rank0(lambda: {"a": 1}) == {"a": 1}
    finally:
        os.environ.update(saved)


def test_remat_recomputes_under_the_forwards_rules_on_another_thread():
    """Autograd runs a CUDA backward on a thread of its own, where no
    rules are installed: the recomputed layer bodies must still see the
    forward's rules, or their ``constrain`` hooks would place activations
    otherwise than the forward did."""
    cfg = get_config("qwen2_05b").reduced().__class__(
        **{**get_config("qwen2_05b").reduced().__dict__, "remat": True})
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16),
                                              dtype=np.int32))
             for k in ("tokens", "targets")}
    seen = []
    orig = sharding.spec_for

    def spy(names):
        # the rules each constrain hook sees, and on which thread
        seen.append((threading.current_thread().name, sharding.get_rules()))
        return orig(names)

    sharding.spec_for = spy
    try:
        rules = {"seq": ("model",)}
        with sharding.logical_rules(rules), torch.enable_grad():
            live = [p.detach().requires_grad_()
                    for p in pytree.tree_leaves(params)]
            loss, _ = TS.make_loss_fn(cfg)(pytree.unflatten(params, live),
                                           batch)
        worker = threading.Thread(target=lambda: torch.autograd.grad(
            loss, live), name="backward")
        worker.start()
        worker.join()
    finally:
        sharding.spec_for = orig
    recomputed = [r for name, r in seen if name == "backward"]
    assert recomputed and all(r == rules for r in recomputed)


def test_named_sharding_places_as_placements_for():
    """``NamedSharding(mesh, spec).placements(ndim)`` is
    ``placements_for(spec, mesh, ndim)``: checked on a stand-in mesh
    (no process group)."""
    class Mesh:
        mesh_dim_names = ("data", "model")
        shape = (2, 2)

    sh = M.NamedSharding(Mesh(), ("model", None))
    assert sh.placements(2) == M.placements_for(("model", None), Mesh(), 2)
    assert hash(sh) == hash(M.NamedSharding(sh.mesh, ("model", None)))
