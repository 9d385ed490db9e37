"""The training launcher's rules route on a mesh of gloo ranks (CPU),
against the reference's launcher and GSPMD.

On two or more ranks ``repro_torch.launch.train`` follows the reference
launcher's route: ``--plan toast`` takes the searched plan's
``logical_rules`` (else ``MANUAL_RULES``), ``--plan manual`` takes
``MANUAL_RULES``, the state is placed by ``specs_from_rules`` and the
step runs under those rules.  Reduced f32 ``qwen2_05b`` at B 2 x S 32 on
a (data 1, model 2) mesh of two gloo processes:

- both plans, resuming from one step-0 checkpoint the reference's
  ``save`` wrote, end within 1e-4 of the reference launcher's
  ``run_once`` from the same checkpoint (its one device places nothing,
  so its ``--plan manual`` and ``--plan toast`` take the same steps), the
  manifests equal;
- the port's ``specs_from_rules`` equals the reference's, leaf by leaf,
  for both rules maps on (1, 2) and (2, 2) meshes;
- by design, the rules route does not place the state as the plan's
  ``in_specs``: the reference's launcher projects the plan onto logical
  names by a majority vote (``_logical_rules``), and so does the port's;
- the collectives of the launcher's step, counted per rank by
  ``launch.mesh.collective_tally``, against those of the reference's
  ``jax.jit(train_step, donate_argnums=0)`` under the same rules on two
  forced host devices, counted in its compiled HLO (loop-aware, as
  ``tests/test_torch_mesh_comm.py`` counts them): the port's result
  bytes at most twice GSPMD's in all, and its all-reduce and
  reduce-scatter bytes at most twice GSPMD's.

Run as a script, it prints the table PERF.md quotes::

    PYTHONPATH=src python tests/test_torch_launch_mesh_rules.py
"""

import argparse
import collections
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.ckpt import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.launch import specs as jspecs
from repro.launch import train as jtrain
from repro.train import steps as jsteps
from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.partitioner import flatten_logical_axes
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as S
from repro_torch.launch import train as launcher
from repro_torch.models.sharding import MANUAL_RULES
from repro_torch.train.steps import train_state_specs

TOL = 1e-4
STEPS = 4
RANKS_TIMEOUT = 240.0
SHAPE = ShapeConfig("cli", 32, 2, "train")
# HLO's names of the port's collectives (DTensor's own all-to-all too)
KIND = {"all_gather_into_tensor": "all-gather",
        "all_gather_into_tensor_coalesced": "all-gather",
        "reduce_scatter_tensor": "reduce-scatter",
        "reduce_scatter_tensor_coalesced": "reduce-scatter",
        "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
        "all_to_all_single": "all-to-all",
        "shard_dim_alltoall": "all-to-all",
        "broadcast": "collective-permute"}
REDUCTIONS = ("all-reduce", "reduce-scatter")

GSPMD_SCRIPT = r"""
import collections, json, os, sys
jobs = json.load(sys.stdin)
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch import specs
from repro.launch.hlo_analysis import top_collectives
from repro.launch.mesh import compat_make_mesh, mesh_context
from repro.models.sharding import logical_rules
from repro.train.steps import init_train_state, make_train_step
cfg = get_config("qwen2_05b").reduced()
shape = ShapeConfig("cli", jobs["S"], jobs["B"], "train")
mesh = compat_make_mesh((1, 2), ("data", "model"))
out = {}
for name, rules in jobs["rules"].items():
    rules = {k: tuple(v) for k, v in rules.items()}
    state = init_train_state(cfg, jax.random.PRNGKey(0))
    spec = specs.specs_from_rules(
        jax.eval_shape(lambda: state), specs.state_logical_axes(cfg, state),
        rules, {"data": 1, "model": 2})
    state = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, jax.sharding.NamedSharding(mesh, s)),
        state, spec, is_leaf=lambda x: isinstance(x, jax.Array))
    batch, _ = specs.batch_specs(cfg, shape)
    # as the reference's launcher: the batch unplaced, the state donated
    with mesh_context(mesh), logical_rules(rules):
        hlo = jax.jit(make_train_step(cfg), donate_argnums=0).lower(
            state, batch).compile().as_text()
    calls, nbytes = collections.Counter(), collections.Counter()
    for total, kind, _, mult, _ in top_collectives(hlo, n=1 << 30):
        calls[kind] += int(mult)
        nbytes[kind] += int(total)
    out[name] = {"calls": calls, "bytes": nbytes}
print("GSPMD" + json.dumps(out))
"""


def argv(ckpt_dir, plan):
    return ["--arch", "qwen2_05b", "--reduced", "--steps", str(STEPS),
            "--batch", "2", "--seq", "32", "--ckpt-dir", str(ckpt_dir),
            "--device", "cpu", "--plan", plan, "--ckpt-every", "10"]


def toast_rules():
    """The port's searched rules for the launcher's (1, 2) mesh, and the
    plan."""
    plan = launcher.toast_plan(get_config("qwen2_05b").reduced(), SHAPE,
                               launcher.mesh_for(2))
    return plan.logical_rules, plan


def start_gspmd(rules):
    """The reference's compile, started in a subprocess (jax fixes its
    device count at first use)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c", GSPMD_SCRIPT], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    # written now, closed by communicate()
    proc.stdin.write(json.dumps({"B": 2, "S": 32, "rules": rules}))
    proc.stdin.flush()
    return proc


def finish_gspmd(proc):
    out, err = proc.communicate(timeout=600)
    line = [x for x in out.splitlines() if x.startswith("GSPMD")]
    assert line, err[-3000:]
    return json.loads(line[0][len("GSPMD"):])


def rules_rank(rank, root):
    """``--plan manual`` and ``--plan toast`` from the step-0 checkpoint
    in each run's directory; the collectives of their steps per step."""
    cfg = get_config("qwen2_05b").reduced()
    out = {}
    for plan in ("manual", "toast"):
        (run,) = launcher.supervise(
            cfg, launcher.parse_args(argv(root / plan, plan)))
        calls, nbytes = collections.Counter(), collections.Counter()
        for name, n in run.collectives["calls"].items():
            calls[KIND[name]] += n / len(run.step_ms)
            nbytes[KIND[name]] += run.collectives["bytes"][name] / len(
                run.step_ms)
        out[plan] = {"start": run.start_step, "rules": run.rules,
                     "steps": len(run.step_ms), "calls": calls,
                     "bytes": nbytes}
    return out


def load(directory, step):
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    return manifest, [np.load(d / e["file"]) for e in manifest["leaves"]]


def measure(root):
    """The reference launcher's run, the two ranks' runs and GSPMD's
    collectives."""
    rules, plan = toast_rules()
    proc = start_gspmd({"manual": dict(MANUAL_RULES), "toast": rules})
    jstate = jsteps.init_train_state(jget_config("qwen2_05b").reduced(),
                                     jax.random.PRNGKey(0))
    for name in ("ref", "manual", "toast"):
        jckpt.save(root / name, 0, jstate)
    jargs = argparse.Namespace(
        arch="qwen2_05b", reduced=True, steps=STEPS, batch=2, seq=32,
        plan="manual", compress="none", seed=0, ckpt_dir=str(root / "ref"),
        ckpt_every=10, log_every=5, fail_at=None, max_failures=0)
    assert jtrain.run_once(jargs, 0)
    ranks = M.run_ranks(rules_rank, 2, root, timeout=RANKS_TIMEOUT)
    return {"rules": rules, "plan": plan, "ranks": ranks,
            "gspmd": finish_gspmd(proc), "root": root}


@pytest.fixture(scope="module")
def measured(tmp_path_factory):
    return measure(tmp_path_factory.mktemp("launch_rules"))


@pytest.mark.parametrize("plan", ["manual", "toast"])
def test_two_ranks_match_the_reference_launcher(measured, plan):
    root = measured["root"]
    for r in measured["ranks"]:
        assert r[plan]["start"] == 0 and r[plan]["steps"] == STEPS
    assert measured["ranks"][0]["toast"]["rules"] == measured["rules"]
    assert measured["ranks"][0]["manual"]["rules"] == dict(MANUAL_RULES)
    jman, jleaves = load(root / "ref", STEPS)
    man, leaves = load(root / plan, STEPS)
    assert man == jman
    for entry, got, want in zip(man["leaves"], leaves, jleaves):
        if entry["path"] == ".opt.step":
            assert got == want == STEPS
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=entry["path"])


def reference_state():
    return jsteps.init_train_state(jget_config("qwen2_05b").reduced(),
                                   jax.random.PRNGKey(0))


@pytest.mark.parametrize("sizes", [(1, 2), (2, 2)])
def test_specs_from_rules_equal_the_references(measured, sizes):
    cfg = get_config("qwen2_05b").reduced()
    jcfg = jget_config("qwen2_05b").reduced()
    axis_sizes = dict(zip(("data", "model"), sizes))
    state = train_state_specs(cfg)
    names = flatten_logical_axes(S.state_logical_axes(cfg, state))
    jstate = jax.eval_shape(reference_state)
    for rules in (dict(MANUAL_RULES), measured["rules"]):
        jspec = jax.tree_util.tree_leaves(
            jspecs.specs_from_rules(
                jstate, jspecs.state_logical_axes(jcfg, jstate), rules,
                axis_sizes),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        mine = [S.specs_from_rules(x, n, rules, axis_sizes)
                for x, n in zip(pytree.tree_leaves(state), names)]
        assert len(mine) == len(jspec) == 46
        for a, b in zip(mine, jspec):
            assert tuple(a) == tuple(b)


def test_the_rules_route_places_the_state_otherwise_than_the_plan(
        measured):
    """By design (the reference's own launcher does the same): the
    plan's rules are a majority vote of its colors' logical names, so
    leaves whose colors lost the vote keep the plan's sharding in
    ``in_specs`` but not under the rules."""
    cfg = get_config("qwen2_05b").reduced()
    plan = measured["plan"]
    state = train_state_specs(cfg)
    leaves, paths = pytree.flatten_with_paths(state)
    names = flatten_logical_axes(S.state_logical_axes(cfg, state))
    in_specs = dict(zip(plan.input_paths, plan.in_specs))
    sizes = dict(zip(plan.mesh.axes, plan.mesh.sizes))
    differ = {p: (tuple(in_specs["[0][0]" + p]),
                  tuple(S.specs_from_rules(x, n, plan.logical_rules, sizes)))
              for x, n, p in zip(leaves, names, paths)
              if tuple(in_specs["[0][0]" + p]) !=
              tuple(S.specs_from_rules(x, n, plan.logical_rules, sizes))}
    assert len(differ) == 15
    assert differ[".params['final_ln']"] == (("model",), (None,))
    assert differ[".params['layers'][0]['ffn']['wg']"] == (
        ("model", None, None), (None, "model", None))
    for tree in ("params", "opt.m", "opt.v"):
        assert differ[f".{tree}['layers'][0]['mix']['bq']"] == (
            (None, "model"), (None, None))


@pytest.mark.parametrize("plan", ["manual", "toast"])
def test_the_step_moves_at_most_twice_what_gspmd_moves(measured, plan):
    ref = measured["gspmd"][plan]
    want = sum(ref["bytes"].values())
    want_red = sum(ref["bytes"].get(k, 0) for k in REDUCTIONS)
    for r in measured["ranks"]:
        got = sum(r[plan]["bytes"].values())
        got_red = sum(r[plan]["bytes"].get(k, 0) for k in REDUCTIONS)
        assert got <= 2 * want, (plan, dict(r[plan]["bytes"]), ref)
        assert got_red <= 2 * want_red, (plan, dict(r[plan]["bytes"]), ref)


def main(root):
    res = measure(root)
    print("| rules | GSPMD (reference HLO): calls, bytes | port (launcher "
          "step, gloo CPU): calls, bytes | port / GSPMD bytes |")
    print("| --- | --- | --- | --- |")
    for plan in ("manual", "toast"):
        ref, mine = res["gspmd"][plan], res["ranks"][0][plan]

        def cell(r):
            return "; ".join(f"{k} {r['calls'][k]:g} calls, "
                             f"{r['bytes'][k]:,.0f} B"
                             for k in sorted(r["calls"]))
        ratio = sum(mine["bytes"].values()) / sum(ref["bytes"].values())
        print(f"| {plan} {mine['rules'] if plan == 'toast' else ''} | "
              f"{cell(ref)} | {cell(mine)} | {ratio:.2f} |")


if __name__ == "__main__":
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        import pathlib
        main(pathlib.Path(tmp))
