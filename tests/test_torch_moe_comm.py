"""The collectives of TOAST's MoE plans, run by the port (DTensor) and
compiled by the reference (GSPMD), in the pattern of
``tests/test_torch_mesh_comm.py``.

Cases, reduced f32 models (B 4 x S 64 for prefill, ``use_pallas``):

- prefill: ``mixtral_8x22b`` and ``arctic_480b`` (batch dispatch) on
  the plan the port's ``Session`` searches for a (1, 2) mesh with the
  default ``Request`` and on the greedy 2x2 plan;
- decode: one step of ``mixtral_8x22b`` and of the dense ``qwen2_05b``
  (B 4, cache 8) on the 2x2 plan of the serving launcher's request (the
  KV cache pinned replicated).

The reference: ``ShardingPlan.from_json(...).apply(step)`` compiled on
forced host devices in a subprocess, its collectives counted by the
reference's loop-aware ``launch.hlo_analysis.top_collectives``, and the
shapes of its all-gathers read from the HLO.  The port: the same JSON
applied on a gloo group of as many processes, the second call counted
by ``launch.mesh.collective_tally``.  Bounds: the port's result bytes at
most twice GSPMD's in all (a CPU group's all-to-all runs as an
all-gather and a chunk, and a weight sharded over both axes is gathered
one axis at a time); where GSPMD gathers no expert stack whole, neither
does the port (it gathers none: its expert stacks stay where the plan
put them and the tokens move to them); the outputs equal the unsharded
step's within 1e-4.

Run as a script, it prints the table PERF.md quotes::

    PYTHONPATH=src python tests/test_torch_moe_comm.py
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
from repro_torch.launch import serve, specs
from test_torch_mesh_comm import KIND
from test_torch_moe_mesh import expert_gathers

B, S = 4, 64
MAX_SEQ = 8
AXES = ("data", "model")
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
TOL = 1e-4
RANKS_TIMEOUT = 240.0
CASES = {"1x2": (("mixtral_8x22b", "prefill"), ("arctic_480b", "prefill")),
         "2x2": (("mixtral_8x22b", "prefill"), ("arctic_480b", "prefill"),
                 ("mixtral_8x22b", "decode"), ("qwen2_05b", "decode"))}

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
for arch, kind, text in jobs["plans"]:
    cfg = get_config(arch).reduced()
    if kind == "prefill":
        cfg = dataclasses.replace(cfg, use_pallas=True)
        shape = ShapeConfig("t", jobs["S"], jobs["B"], "prefill")
    else:
        shape = ShapeConfig("serve", jobs["max_seq"], jobs["B"], "decode")
    fn, args, _ = specs.step_and_inputs(cfg, shape)
    # the port writes its kernels' impl as "cuda", the reference "pallas"
    plan = ShardingPlan.from_json(text.replace('"cuda"', '"pallas"'))
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


def config(arch, kind):
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, use_pallas=True) if kind == "prefill" \
        else cfg


def devices(mesh) -> int:
    return int(np.prod([int(n) for n in mesh.split("x")]))


def plan_for(arch, kind, mesh):
    """The port's plan of one case (a CASES entry on ``mesh``)."""
    cfg = config(arch, kind)
    shape = tuple(int(n) for n in mesh.split("x"))
    if kind == "decode":
        sess, names = serve.decode_session(cfg, B, MAX_SEQ)
        return sess.partition(dataclasses.replace(serve.decode_request(
            cfg, names, MeshSpec(AXES, shape)), hw=HardwareSpec(**HW)))
    fn, args, _ = specs.step_and_inputs(cfg, ShapeConfig("t", S, B,
                                                         "prefill"))
    sess = Session(fn, args)
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
    proc.stdin.write(json.dumps({"devices": devices, "B": B, "S": S,
                                 "max_seq": MAX_SEQ, "plans": texts}))
    proc.stdin.flush()
    return proc


def finish_gspmd(proc):
    out, err = proc.communicate(timeout=600)
    line = [x for x in out.splitlines() if x.startswith("GSPMD")]
    assert line, err[-3000:]
    return json.loads(line[0][len("GSPMD"):])


def inputs(arch, kind):
    """The step and its seeded inputs, on the CPU."""
    from repro_torch.models import transformer as T
    cfg = config(arch, kind)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(1)
    if kind == "prefill":
        fn, _, _ = specs.step_and_inputs(cfg, ShapeConfig("t", S, B,
                                                          "prefill"))
        return cfg, fn, (params, {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32))})
    fn, _, _ = specs.step_and_inputs(cfg, ShapeConfig("serve", MAX_SEQ, B,
                                                      "decode"))
    token = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)).astype(
        np.int32))
    return cfg, fn, (params, T.init_cache(cfg, B, MAX_SEQ, device="cpu"),
                     token, torch.tensor(3, dtype=torch.int32))


def port_rank(rank, cases):
    """Apply each case's plan JSON to seeded inputs; tally the second
    call."""
    out = []
    for arch, kind, text in cases:
        cfg, fn, args = inputs(arch, kind)
        want = pytree.tree_leaves(fn(*args))
        applied = ShardingPlan.from_json(text).apply(fn, device="cpu")
        placed = applied.place(args)
        applied(*placed)
        with M.collective_tally() as tally:
            got = pytree.tree_leaves(applied(*placed))
        calls, nbytes = collections.Counter(), collections.Counter()
        for name, n in tally.calls.items():
            calls[KIND[name]] += n
            nbytes[KIND[name]] += tally.bytes[name]
        out.append({
            "calls": calls, "bytes": nbytes,
            "expert_gathers": expert_gathers(tally.shapes, cfg)
            if cfg.num_experts else {},
            "errors": [((g.full_tensor() - w).abs().max() /
                        max(1.0, w.abs().max().item())).item()
                       for g, w in zip(got, want)]})
    return out


def gspmd_expert_gathers(ref, cfg) -> list:
    """GSPMD's all-gathers whose result is a whole expert stack."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return [g for g in ref["gathers"] if len(g) >= 3 and
            tuple(g[-3:]) in ((e, d, f), (e, f, d))]


def measure():
    """Per case: the plan, GSPMD's counts and each rank's."""
    plans = {mesh: [(arch, kind, plan_for(arch, kind, mesh))
                    for arch, kind in cases]
             for mesh, cases in CASES.items()}
    texts = {mesh: [(a, k, p.to_json()) for a, k, p in ps]
             for mesh, ps in plans.items()}
    procs = {mesh: start_gspmd(t, devices(mesh))
             for mesh, t in texts.items()}
    port = {mesh: M.run_ranks(port_rank, devices(mesh), t,
                              timeout=RANKS_TIMEOUT)
            for mesh, t in texts.items()}
    out = {}
    for mesh, ps in plans.items():
        ref = finish_gspmd(procs[mesh])
        for i, (arch, kind, plan) in enumerate(ps):
            out[mesh, arch, kind] = (plan, ref[i], [r[i] for r in
                                                    port[mesh]])
    return out


@pytest.fixture(scope="module")
def measured():
    return measure()


CASE_IDS = [(m, a, k) for m, cs in CASES.items() for a, k in cs]


@pytest.mark.parametrize("case", CASE_IDS, ids="-".join)
def test_port_equals_unsharded(measured, case):
    for r in measured[case][2]:
        assert max(r["errors"]) <= TOL, (case, r["errors"])


@pytest.mark.parametrize("case", CASE_IDS, ids="-".join)
def test_port_moves_at_most_twice_what_gspmd_moves(measured, case):
    _, ref, port = measured[case]
    want = sum(ref["bytes"].values())
    for r in port:
        got = sum(r["bytes"].values())
        assert got <= 2 * want, (case, r["bytes"], ref["bytes"])


@pytest.mark.parametrize("case", [c for c in CASE_IDS
                                  if c[1] != "qwen2_05b"], ids="-".join)
def test_no_expert_stack_gathered_where_gspmd_gathers_none(measured, case):
    """The port gathers no expert stack whole in any case; the cases
    where GSPMD gathers none (mixtral's (1, 2) prefill among them) hold
    it to that."""
    _, ref, port = measured[case]
    cfg = config(case[1], case[2])
    for r in port:
        assert r["expert_gathers"] == {}, (case, r["expert_gathers"])
    if case == ("1x2", "mixtral_8x22b", "prefill"):
        assert gspmd_expert_gathers(ref, cfg) == []


def main():
    print("| mesh | model | step | GSPMD (reference HLO): calls, bytes | "
          "port (DTensor, gloo CPU): calls, bytes | port / GSPMD bytes | "
          "expert stacks gathered whole: GSPMD, port |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for (mesh, arch, kind), (plan, ref, port) in measure().items():
        def cell(r):
            return "; ".join(f"{k} {r['calls'][k]} calls, "
                             f"{r['bytes'][k]:,} B" for k in
                             sorted(r["calls"])) or "none"
        ratio = sum(port[0]["bytes"].values()) / max(
            1, sum(ref["bytes"].values()))
        cfg = config(arch, kind)
        experts = f"{len(gspmd_expert_gathers(ref, cfg))}, " \
            f"{sum(port[0]['expert_gathers'].values())}" \
            if cfg.num_experts else "-"
        print(f"| {mesh} | {arch} | {kind} | {cell(ref)} | {cell(port[0])} "
              f"| {ratio:.2f} | {experts} |")


if __name__ == "__main__":
    main()
