"""The collectives of TOAST's MoE train plans, run by the port (DTensor)
and compiled by the reference (GSPMD), in the pattern of
``tests/test_torch_moe_comm.py``.

Cases, reduced f32 models, the train step of ``launch.specs`` (default
``AdamConfig``): ``mixtral_8x22b`` with the batch dispatch at B 2 x S 32
and ``arctic_480b`` at B 1 x S 32 with remat, each on the plan the
port's ``Session`` searches for a (1, 2) mesh with the default
``Request`` and on the greedy 2x2 plan under one explicit
``HardwareSpec``.

The reference: ``ShardingPlan.from_json(...).apply(step)`` compiled on
forced host devices in a subprocess, its collectives counted by the
reference's loop-aware ``launch.hlo_analysis.top_collectives`` and the
shapes of its all-gathers read from the HLO.  The port: the same JSON
applied on a gloo group of as many processes, the second step counted
by ``launch.mesh.collective_tally``.  Bounds: the port's result bytes at
most twice GSPMD's in all; where GSPMD gathers no expert stack whole
(parameter, gradient or moment), neither does the port; the new state
and metrics equal the unsharded step's within 1e-4 (relative to the
largest, at least 1).

Run as a script, it prints the table PERF.md quotes::

    PYTHONPATH=src python tests/test_torch_moe_mesh_train_comm.py
"""

import collections
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import pytree
from repro_torch.api import Request, Session
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.cost_model import HardwareSpec, MeshSpec
from repro_torch.core.partitioner import ShardingPlan
from repro_torch.launch import mesh as M
from repro_torch.launch import specs
from test_torch_mesh_comm import KIND
from test_torch_moe_mesh import expert_gathers

AXES = ("data", "model")
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
TOL = 1e-4
RANKS_TIMEOUT = 240.0
# model -> (dispatch, remat, B, S)
MODELS = {"mixtral_8x22b": ("batch", False, 2, 32),
          "arctic_480b": ("batch", True, 1, 32)}
MESHES = ("1x2", "2x2")

GSPMD_SCRIPT = r"""
import collections, dataclasses, json, os, re, sys
jobs = json.load(sys.stdin)
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=%d"
                           % jobs["devices"])
from repro.configs.base import ShapeConfig, get_config
from repro.core.partitioner import ShardingPlan
from repro.launch import specs
from repro.launch.hlo_analysis import top_collectives
out = []
for arch, (mode, remat, B, S), text in jobs["plans"]:
    cfg = dataclasses.replace(get_config(arch).reduced(), moe_dispatch=mode,
                              remat=remat)
    fn, args, _ = specs.step_and_inputs(cfg, ShapeConfig("t", S, B, "train"))
    plan = ShardingPlan.from_json(text)
    hlo = plan.apply(fn).lower(*args).compile().as_text()
    calls, nbytes = collections.Counter(), collections.Counter()
    for total, k, _, mult, _ in top_collectives(hlo, n=1 << 30):
        calls[k] += int(mult)
        nbytes[k] += int(total)
    gathers = []
    for line in hlo.splitlines():
        m = re.search(r"=\s*(.*?)\s+all-gather(-start)?\(", line)
        if m:
            gathers += [[int(n) for n in dims.split(",")] for dims in
                        re.findall(r"\[([\d,]+)\]", m.group(1))]
    out.append({"calls": calls, "bytes": nbytes, "gathers": gathers})
print("GSPMD" + json.dumps(out))
"""


def config(arch):
    mode, remat, _, _ = MODELS[arch]
    return dataclasses.replace(get_config(arch).reduced(), moe_dispatch=mode,
                               remat=remat)


def devices(mesh) -> int:
    return int(np.prod([int(n) for n in mesh.split("x")]))


def plan_for(arch, mesh):
    B, S = MODELS[arch][2:]
    fn, args, _ = specs.step_and_inputs(config(arch), ShapeConfig(
        "t", S, B, "train"))
    sess = Session(fn, args)
    shape = tuple(int(n) for n in mesh.split("x"))
    if mesh == "1x2":
        return sess.partition(Request(mesh=MeshSpec(AXES, shape)))
    return sess.partition(Request(mesh=MeshSpec(AXES, shape),
                                  hw=HardwareSpec(**HW), backend="greedy"))


def start_gspmd(texts, devices):
    """The reference's compiles, started in a subprocess (jax fixes its
    device count at first use)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c", GSPMD_SCRIPT], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    proc.stdin.write(json.dumps({"devices": devices, "plans": texts}))
    proc.stdin.flush()
    return proc


def finish_gspmd(proc):
    out, err = proc.communicate(timeout=600)
    line = [x for x in out.splitlines() if x.startswith("GSPMD")]
    assert line, err[-3000:]
    return json.loads(line[0][len("GSPMD"):])


def port_rank(rank, cases):
    """Apply each case's plan JSON to the seeded state and batch; tally
    the second step."""
    from repro_torch.train import steps as TS
    out = []
    for arch, (mode, remat, B, S), text in cases:
        cfg = config(arch)
        fn, _, _ = specs.step_and_inputs(cfg, ShapeConfig("t", S, B,
                                                          "train"))
        state = TS.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
        rng = np.random.default_rng(1)
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32))
            for k in ("tokens", "targets")}
        want = fn(*fn(state, batch)[:1], batch)
        applied = ShardingPlan.from_json(text).apply(fn, device="cpu")
        placed = applied.place((state, batch))
        new, _ = applied(*placed)
        with M.collective_tally() as tally:
            got = applied(new, placed[1])
        calls, nbytes = collections.Counter(), collections.Counter()
        for name, n in tally.calls.items():
            calls[KIND[name]] += n
            nbytes[KIND[name]] += tally.bytes[name]
        out.append({
            "calls": calls, "bytes": nbytes,
            "expert_gathers": expert_gathers(tally.shapes, cfg),
            "errors": [((g.full_tensor().double() - w.double()).abs().max() /
                        max(1.0, w.abs().max().item())).item()
                       for g, w in zip(pytree.tree_leaves(got),
                                       pytree.tree_leaves(want))]})
    return out


def gspmd_expert_gathers(ref, cfg) -> list:
    """GSPMD's all-gathers whose result is a whole expert stack."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return [g for g in ref["gathers"] if len(g) >= 3 and
            tuple(g[-3:]) in ((e, d, f), (e, f, d))]


def measure():
    """Per case: the plan, GSPMD's counts and each rank's."""
    plans = {mesh: [(arch, plan_for(arch, mesh)) for arch in MODELS]
             for mesh in MESHES}
    texts = {mesh: [(a, MODELS[a], p.to_json()) for a, p in ps]
             for mesh, ps in plans.items()}
    procs = {mesh: start_gspmd(t, devices(mesh))
             for mesh, t in texts.items()}
    port = {mesh: M.run_ranks(port_rank, devices(mesh), t,
                              timeout=RANKS_TIMEOUT)
            for mesh, t in texts.items()}
    out = {}
    for mesh, ps in plans.items():
        ref = finish_gspmd(procs[mesh])
        for i, (arch, plan) in enumerate(ps):
            out[mesh, arch] = (plan, ref[i], [r[i] for r in port[mesh]])
    return out


@pytest.fixture(scope="module")
def measured():
    return measure()


CASE_IDS = [(m, a) for m in MESHES for a in MODELS]


@pytest.mark.parametrize("case", CASE_IDS, ids="-".join)
def test_port_step_equals_unsharded(measured, case):
    for r in measured[case][2]:
        assert max(r["errors"]) <= TOL, (case, max(r["errors"]))


@pytest.mark.parametrize("case", CASE_IDS, ids="-".join)
def test_port_moves_at_most_twice_what_gspmd_moves(measured, case):
    _, ref, port = measured[case]
    want = sum(ref["bytes"].values())
    for r in port:
        got = sum(r["bytes"].values())
        assert got <= 2 * want, (case, r["bytes"], ref["bytes"])


@pytest.mark.parametrize("case", CASE_IDS, ids="-".join)
def test_no_expert_stack_gathered_where_gspmd_gathers_none(measured, case):
    """Where GSPMD gathers no expert stack whole, the port gathers none;
    where it does (a plan that shards a stack's layer dim: the layer scan
    needs each layer whole), the port gathers no stack of another kind,
    (E, d, f) or (E, f, d)."""
    _, ref, port = measured[case]
    want = {tuple(g[-3:]) for g in gspmd_expert_gathers(ref,
                                                        config(case[1]))}
    for r in port:
        for k in r["expert_gathers"]:
            assert {g[-3:] for g in M.gathered_shapes(eval(k)[1])} & want, (
                case, r["expert_gathers"], want)


def main():
    print("| mesh | model | GSPMD (reference HLO): calls, bytes | port "
          "(DTensor, gloo CPU): calls, bytes | port / GSPMD bytes | expert "
          "stacks gathered whole: GSPMD, port |")
    print("| --- | --- | --- | --- | --- | --- |")
    for (mesh, arch), (plan, ref, port) in measure().items():
        def cell(r):
            return "; ".join(f"{k} {r['calls'][k]} calls, "
                             f"{r['bytes'][k]:,} B" for k in
                             sorted(r["calls"])) or "none"
        ratio = sum(port[0]["bytes"].values()) / max(
            1, sum(ref["bytes"].values()))
        print(f"| {mesh} | {arch} | {cell(ref)} | {cell(port[0])} "
              f"| {ratio:.2f} | "
              f"{len(gspmd_expert_gathers(ref, config(arch)))}, "
              f"{sum(port[0]['expert_gathers'].values())} |")


if __name__ == "__main__":
    main()
