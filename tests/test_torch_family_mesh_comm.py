"""The collectives of TOAST's (1, 2) plans for the xLSTM and the frontend
models, run by the port (DTensor) and compiled by the reference (GSPMD),
in the pattern of ``tests/test_torch_moe_comm.py``.

Cases, reduced f32 models at B 4 x S 32 (``xlstm_350m`` at 8 layers,
so that an sLSTM runs; ``whisper_small`` 16 frames + 16 tokens;
``phi3_vision`` 8 patches + 24 tokens): each model's prefill step (the
frontend models with their kernel sites) and train step
(``launch.specs``'s, default ``AdamConfig``; the einsum attention path),
each on the plan the port's ``Session`` searches for a (1, 2) mesh with
the default ``Request``.

The reference: ``ShardingPlan.from_json(...).apply(step)`` compiled on
two forced host devices in a subprocess, its collectives counted by the
reference's loop-aware ``launch.hlo_analysis.top_collectives``.  The
port: the same JSON applied on a gloo group of two processes, the call
counted by ``launch.mesh.collective_tally``.  Bounds: the port's
result bytes at most twice GSPMD's in all; the outputs equal the
unsharded step's within 1e-4 (relative to the largest, at least 1).

Run as a script, it prints the table PERF.md quotes::

    PYTHONPATH=src:tests python tests/test_torch_family_mesh_comm.py
"""

import collections
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro_torch import pytree
from repro_torch.api import Request, Session
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.cost_model import MeshSpec
from repro_torch.core.partitioner import ShardingPlan
from repro_torch.launch import mesh as M
from repro_torch.launch import specs
from test_torch_mesh_comm import KIND
from test_torch_xlstm_mesh import seeded_inputs

B, S = 4, 32
AXES = ("data", "model")
TOL = 1e-4
RANKS_TIMEOUT = 300.0
# model -> layers (None: the reduced config's)
MODELS = {"xlstm_350m": 8, "whisper_small": None, "phi3_vision": None}
CASES = [(arch, kind) for arch in MODELS for kind in ("prefill", "train")]

GSPMD_SCRIPT = r"""
import collections, dataclasses, json, os, sys
jobs = json.load(sys.stdin)
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
from repro.configs.base import ShapeConfig, get_config
from repro.core.partitioner import ShardingPlan
from repro.launch import specs
from repro.launch.hlo_analysis import top_collectives
out = []
for arch, layers, kind, text in jobs["plans"]:
    cfg = get_config(arch).reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if kind == "prefill" and (cfg.is_encoder_decoder or cfg.frontend):
        cfg = dataclasses.replace(cfg, use_pallas=True)
    fn, args, _ = specs.step_and_inputs(
        cfg, ShapeConfig("t", jobs["S"], jobs["B"], kind))
    # the port writes its kernels' impl as "cuda", the reference "pallas"
    plan = ShardingPlan.from_json(text.replace('"cuda"', '"pallas"'))
    hlo = plan.apply(fn).lower(*args).compile().as_text()
    calls, nbytes = collections.Counter(), collections.Counter()
    for total, k, _, mult, _ in top_collectives(hlo, n=1 << 30):
        calls[k] += int(mult)
        nbytes[k] += int(total)
    out.append({"calls": calls, "bytes": nbytes})
print("GSPMD" + json.dumps(out))
"""


def config(arch, kind):
    """The case's reduced f32 config: the frontend models' prefill with
    their kernel sites, every train step on the einsum path."""
    cfg = get_config(arch).reduced()
    if MODELS[arch] is not None:
        cfg = dataclasses.replace(cfg, num_layers=MODELS[arch])
    if kind == "prefill" and (cfg.is_encoder_decoder or cfg.frontend):
        cfg = dataclasses.replace(cfg, use_pallas=True)
    return cfg


def plan_for(arch, kind):
    fn, args, _ = specs.step_and_inputs(config(arch, kind),
                                        ShapeConfig("t", S, B, kind))
    return Session(fn, args).partition(Request(mesh=MeshSpec(AXES, (1, 2))))


def port_rank(rank, cases):
    """Apply each case's plan JSON to seeded inputs; tally the call."""
    out = []
    for arch, kind, text in cases:
        cfg = config(arch, kind)
        fn, meta, _ = specs.step_and_inputs(cfg, ShapeConfig("t", S, B,
                                                             kind))
        args = seeded_inputs(cfg, kind, meta)
        want = pytree.tree_leaves(fn(*args))
        applied = ShardingPlan.from_json(text).apply(fn, device="cpu")
        placed = applied.place(args)
        with M.collective_tally() as tally:
            got = pytree.tree_leaves(applied(*placed))
        calls, nbytes = collections.Counter(), collections.Counter()
        for name, n in tally.calls.items():
            calls[KIND[name]] += n
            nbytes[KIND[name]] += tally.bytes[name]
        out.append({"calls": calls, "bytes": nbytes, "errors": [
            ((g.full_tensor() - w).abs().max() /
             max(1.0, w.abs().max().item())).item()
            for g, w in zip(got, want)]})
    return out


def measure():
    """Per case: the plan, GSPMD's counts and each rank's."""
    plans = [(arch, kind, plan_for(arch, kind)) for arch, kind in CASES]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c", GSPMD_SCRIPT], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    proc.stdin.write(json.dumps({"B": B, "S": S, "plans": [
        (a, MODELS[a], k, p.to_json()) for a, k, p in plans]}))
    proc.stdin.flush()
    port = M.run_ranks(port_rank, 2, [(a, k, p.to_json())
                                      for a, k, p in plans],
                       timeout=RANKS_TIMEOUT)
    out, err = proc.communicate(timeout=600)
    line = [x for x in out.splitlines() if x.startswith("GSPMD")]
    assert line, err[-3000:]
    ref = json.loads(line[0][len("GSPMD"):])
    return {(a, k): (p, ref[i], [r[i] for r in port])
            for i, (a, k, p) in enumerate(plans)}


@pytest.fixture(scope="module")
def measured():
    return measure()


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_port_equals_unsharded(measured, case):
    for r in measured[case][2]:
        assert max(r["errors"]) <= TOL, (case, r["errors"])


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_port_moves_at_most_twice_what_gspmd_moves(measured, case):
    _, ref, port = measured[case]
    want = sum(ref["bytes"].values())
    for r in port:
        got = sum(r["bytes"].values())
        assert got <= 2 * want, (case, r["bytes"], ref["bytes"])


def main():
    print("| model | step | GSPMD (reference HLO): calls, bytes | port "
          "(DTensor, gloo CPU): calls, bytes | port / GSPMD bytes |")
    print("| --- | --- | --- | --- | --- |")
    for (arch, kind), (_, ref, port) in measure().items():
        def cell(r):
            return "; ".join(f"{k} {r['calls'][k]} calls, "
                             f"{r['bytes'][k]:,} B" for k in
                             sorted(r["calls"])) or "none"
        ratio = sum(port[0]["bytes"].values()) / max(
            1, sum(ref["bytes"].values()))
        print(f"| {arch} | {kind} | {cell(ref)} | {cell(port[0])} | "
              f"{ratio:.2f} |")


if __name__ == "__main__":
    main()
