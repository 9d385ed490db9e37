"""The collectives of one TOAST plan, run by the port (DTensor) and
compiled by the reference (GSPMD).

The port hands a plan to DTensor through its input and output
placements; what DTensor issues in between is the port's execution of
the plan, and the verifier's conformance will read it.  This file holds
it against what GSPMD issues for the same plan JSON.  Cases: the
``qwen2_05b`` and ``recurrentgemma_2b`` prefills at reduced width
(f32, B 4 x S 64, ``use_pallas``), each with the plan the port's
``Session`` searches for a (1, 2) mesh as ``chip_smoke.py`` searches its
full-width ones (the default ``Request``), and with the greedy 2x2 plan
of ``test_torch_mesh_models.py``.  TOAST picks FSDP-like plans here:
the batch and every weight sharded over the mesh.

- The reference: ``ShardingPlan.from_json(...).apply(step)`` lowered
  and compiled on forced host devices (a subprocess: the XLA device
  count is fixed at jax's first use), its collectives counted in the
  compiled HLO by the reference's loop-aware
  ``launch.hlo_analysis.top_collectives`` (each ``while`` body times its
  trip count): per device, the bytes of each result.
- The port: the same JSON applied on a gloo group of as many processes,
  the second call counted by ``launch.mesh.collective_tally``: per rank,
  the bytes of each result.

GSPMD all-gathers each weight per layer and moves no activation but
the embedding's output (one all-to-all); so must the port.  On a CPU
group DTensor's all-to-all runs as an all-gather and a chunk (its
warning says so), and a weight sharded over both axes is gathered one
axis at a time, so the port's all-gathers number and weigh more.

Run as a script, it prints the table PERF.md quotes::

    PYTHONPATH=src python tests/test_torch_mesh_comm.py
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

from repro_torch.api import Request, Session
from repro_torch.configs import get_config
from repro_torch.core.cost_model import HardwareSpec, MeshSpec
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.train.steps import make_prefill_step

B, S = 4, 64
AXES = ("data", "model")
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
ARCHS = ("qwen2_05b", "recurrentgemma_2b")
MESHES = {"1x2": ((1, 2), None), "2x2": ((2, 2), "greedy")}
TOL = 1e-4
RANKS_TIMEOUT = 240.0
# HLO's names of the port's collectives (DTensor's own all-to-all too)
KIND = {"all_gather_into_tensor": "all-gather",
        "all_gather_into_tensor_coalesced": "all-gather",
        "reduce_scatter_tensor": "reduce-scatter",
        "reduce_scatter_tensor_coalesced": "reduce-scatter",
        "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
        "all_to_all_single": "all-to-all",
        "shard_dim_alltoall": "all-to-all",
        "broadcast": "collective-permute"}

GSPMD_SCRIPT = r"""
import collections, dataclasses, json, os, sys
jobs = json.load(sys.stdin)
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=%d"
                           % jobs["devices"])
from repro.configs.base import ShapeConfig, get_config
from repro.core.partitioner import ShardingPlan
from repro.launch import specs
from repro.launch.hlo_analysis import top_collectives
out = {}
for arch, text in jobs["plans"].items():
    cfg = dataclasses.replace(get_config(arch).reduced(), use_pallas=True)
    fn, args, _ = specs.step_and_inputs(
        cfg, ShapeConfig("t", jobs["S"], jobs["B"], "prefill"))
    # the port writes its kernels' impl as "cuda", the reference "pallas"
    plan = ShardingPlan.from_json(text.replace('"cuda"', '"pallas"'))
    hlo = plan.apply(fn).lower(*args).compile().as_text()
    calls, nbytes = collections.Counter(), collections.Counter()
    for total, kind, _, mult, _ in top_collectives(hlo, n=1 << 30):
        calls[kind] += int(mult)
        nbytes[kind] += int(total)
    out[arch] = {"calls": calls, "bytes": nbytes}
print("GSPMD" + json.dumps(out))
"""


def plan_for(arch, mesh):
    """The port's plan for the reduced prefill on ``mesh`` (a MESHES key)."""
    shape, backend = MESHES[mesh]
    cfg = dataclasses.replace(get_config(arch).reduced(), use_pallas=True)
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                   device="meta")}
    sess = Session(make_prefill_step(cfg), (T.param_specs(cfg), batch))
    req = Request(mesh=MeshSpec(AXES, shape)) if backend is None else \
        Request(mesh=MeshSpec(AXES, shape), hw=HardwareSpec(**HW),
                backend=backend)
    return sess.partition(req)


def gspmd(plans, devices):
    """The reference's collectives per device for each plan JSON."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", GSPMD_SCRIPT], input=json.dumps(
            {"devices": devices, "B": B, "S": S, "plans": plans}),
        capture_output=True, text=True, timeout=600, env=env)
    line = [x for x in res.stdout.splitlines() if x.startswith("GSPMD")]
    assert line, res.stderr[-3000:]
    return json.loads(line[0][len("GSPMD"):])


def port_rank(rank, plans):
    """Apply each plan JSON to seeded inputs; tally the second call."""
    from repro_torch.core.partitioner import ShardingPlan
    out = {}
    for arch, text in plans.items():
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  use_pallas=True)
        fn = make_prefill_step(cfg)
        params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32))
        want = fn(params, {"tokens": tokens})
        applied = ShardingPlan.from_json(text).apply(fn, device="cpu")
        args = applied.place((params, {"tokens": tokens}))
        applied(*args)
        with M.collective_tally() as tally:
            y = applied(*args)
        calls, nbytes = collections.Counter(), collections.Counter()
        for name, n in tally.calls.items():
            calls[KIND[name]] += n
            nbytes[KIND[name]] += tally.bytes[name]
        out[arch] = {"calls": calls, "bytes": nbytes,
                     "error": (y.full_tensor() - want).abs().max().item(),
                     "scale": want.abs().max().item()}
    return out


def measure(mesh):
    """Plans, GSPMD's and the port's collectives for one MESHES entry."""
    plans = {arch: plan_for(arch, mesh) for arch in ARCHS}
    texts = {arch: p.to_json() for arch, p in plans.items()}
    n = int(np.prod(MESHES[mesh][0]))
    ref = gspmd(texts, n)
    port = M.run_ranks(port_rank, n, texts, timeout=RANKS_TIMEOUT)
    return {arch: (plans[arch], ref[arch], [r[arch] for r in port])
            for arch in ARCHS}


@pytest.fixture(scope="module", params=sorted(MESHES))
def measured(request):
    return request.param, measure(request.param)


def test_plans_shard_batch_and_weights(measured):
    """Every case is FSDP-like: the tokens' batch and each large weight
    sharded on the same mesh axes, which TOAST's cost model prices at 0
    bytes."""
    mesh, cases = measured
    for arch, (plan, _, _) in cases.items():
        tokens = plan.in_specs[plan.input_paths.index("[0][1]['tokens']")]
        assert tokens[0] is not None, (mesh, arch, tokens)
        for path in ("['unembed']", "['ffn']['wi']"):
            spec = [s for p, s in zip(plan.input_paths, plan.in_specs)
                    if p.endswith(path)][0]
            assert tokens[0] in spec, (mesh, arch, path, spec)
        assert plan.breakdown["comm_bytes"] == 0.0


def test_port_equals_unsharded(measured):
    mesh, cases = measured
    for arch, (_, _, port) in cases.items():
        for r in port:
            assert r["error"] <= TOL * max(1.0, r["scale"]), (mesh, arch)


def test_no_activation_reductions(measured):
    """GSPMD reduces no activation for these plans, and neither does the
    port: no all-reduce, no reduce-scatter."""
    mesh, cases = measured
    for arch, (_, ref, port) in cases.items():
        assert set(ref["calls"]) <= {"all-gather", "all-to-all"}, ref
        assert ref["calls"]["all-gather"] > 0
        for r in port:
            assert set(r["calls"]) <= {"all-gather", "all-to-all"}, \
                (mesh, arch, r["calls"])


def test_port_gathers_what_gspmd_gathers(measured):
    """The port's collectives weigh what GSPMD's do: at least GSPMD's
    all-gathered bytes, at most twice GSPMD's bytes in all (a two-axis
    weight gathered one axis at a time writes half of it once more, and
    the CPU group's all-to-all is an all-gather)."""
    mesh, cases = measured
    for arch, (_, ref, port) in cases.items():
        want = sum(ref["bytes"].values())
        for r in port:
            got = sum(r["bytes"].values())
            assert ref["bytes"]["all-gather"] <= got <= 2 * want, \
                (mesh, arch, r["bytes"], ref["bytes"])


def main():
    print("| plan | model | GSPMD (reference HLO): calls, bytes | "
          "port (DTensor, gloo CPU): calls, bytes | cost model bytes |")
    print("| --- | --- | --- | --- | --- |")
    for mesh in sorted(MESHES):
        for arch, (plan, ref, port) in measure(mesh).items():
            def cell(r):
                return ", ".join(f"{k} {r['calls'][k]} calls, "
                                 f"{r['bytes'][k]:,} B" for k in
                                 sorted(r["calls"]))
            print(f"| {mesh} {MESHES[mesh][1] or 'mcts'} | {arch} | "
                  f"{cell(ref)} | {cell(port[0])} | "
                  f"{plan.breakdown['comm_bytes']:.0f} |")


if __name__ == "__main__":
    main()
