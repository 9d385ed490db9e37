"""The serving launcher on a mesh of gloo ranks (CPU), its decode rules
against the reference's, and the API the launchers lean on:
``Session.plan_for_state`` and ``auto_partition``.

``repro_torch.launch.serve`` with ``--plan toast`` on two ranks serves as
the reference's launcher does on two devices: the decode step planned
for the (data 1, model 2) mesh with the cache pinned replicated, the
parameters, cache and prompts replicated on the mesh, the step eager on
DTensors under the plan's logical rules.  Reduced f32 models, B 2 x (4
prompt + 4 generated) tokens: the greedy tokens equal one process's and
the prompt logits agree within 1e-4; the rules equal those the
reference's ``toast_decode_rules`` returns on two forced host devices.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.api import Request as JRequest
from repro.api import Session as JSession
from repro.configs.base import get_config as jax_config
from repro.core.cost_model import HardwareSpec as JHardwareSpec
from repro.core.cost_model import MeshSpec as JMeshSpec
from repro.models import transformer as JT
from repro.train.steps import make_prefill_step as jax_prefill
from repro_torch.api import Request, Session
from repro_torch.configs import get_config
from repro_torch.core.cost_model import HardwareSpec, MeshSpec
from repro_torch.core.mcts import MCTSConfig
from repro_torch.core.partitioner import auto_partition
from repro_torch.launch import mesh as M
from repro_torch.launch import serve as server
from repro_torch.models import transformer as T
from repro_torch.train.steps import make_prefill_step

TOL = 1e-4
COST_REL_TOL = 0.02
ARCHS = ("qwen2_05b", "recurrentgemma_2b")
B, P, G = 2, 4, 4
RANKS_TIMEOUT = 240.0
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
AXES = ("data", "model")

REFERENCE_SCRIPT = r"""
import json, os, sys
jobs = json.load(sys.stdin)
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
from repro.configs import get_config
from repro.launch.serve import toast_decode_rules
out = {}
for arch in jobs["archs"]:
    rules, mesh = toast_decode_rules(get_config(arch).reduced(), jobs["B"],
                                     jobs["max_seq"])
    out[arch] = {"rules": rules, "mesh": list(mesh.devices.shape)}
print("RULES" + json.dumps(out))
"""


def argv(arch, plan):
    return ["--arch", arch, "--reduced", "--batch", str(B), "--prompt-len",
            str(P), "--gen", str(G), "--plan", plan, "--device", "cpu"]


def serve_rank(rank):
    """Serve every model on this rank's group; the gathered results."""
    out = {}
    for arch in ARCHS:
        res = server.serve(server.parse_args(argv(arch, "toast")))
        out[arch] = {"tokens": res.tokens.full_tensor(),
                     "logits": res.prompt_logits.full_tensor(),
                     "placements": str(tuple(res.tokens.placements)),
                     "steps": len(res.step_ms)}
    return out


def reference_rules():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", REFERENCE_SCRIPT], input=json.dumps(
            {"archs": ARCHS, "B": B, "max_seq": P + G}),
        capture_output=True, text=True, timeout=600, env=env)
    line = [x for x in res.stdout.splitlines() if x.startswith("RULES")]
    assert line, res.stderr[-3000:]
    return json.loads(line[0][len("RULES"):])


@pytest.fixture(scope="module")
def served():
    one = {arch: server.serve(server.parse_args(argv(arch, "manual")))
           for arch in ARCHS}
    ranks = M.run_ranks(serve_rank, 2, timeout=RANKS_TIMEOUT)
    return one, ranks


@pytest.mark.parametrize("arch", ARCHS)
def test_two_ranks_serve_the_tokens_of_one_process(served, arch):
    one, ranks = served
    for r in ranks:
        got = r[arch]
        assert got["steps"] == G - 1
        assert torch.equal(got["tokens"], one[arch].tokens)
        torch.testing.assert_close(got["logits"], one[arch].prompt_logits,
                                   rtol=TOL, atol=TOL)
        # the greedy tokens stay on the mesh
        assert got["placements"] == "(Replicate(), Replicate())"


def test_one_device_serves_without_a_mesh():
    cfg = get_config("qwen2_05b").reduced()
    assert server.toast_decode_rules(cfg, B, P + G, 1) == ({}, None)


def test_decode_rules_equal_the_references():
    ref = reference_rules()
    for arch in ARCHS:
        plan = server.decode_plan(get_config(arch).reduced(), B, P + G, 2)
        assert tuple(plan.mesh.sizes) == tuple(ref[arch]["mesh"]) == (1, 2)
        want = {k: tuple(v) for k, v in ref[arch]["rules"].items()}
        assert plan.logical_rules == want, arch


# --- Session.plan_for_state and auto_partition ------------------------------


def prefill_args(cfg, pkg):
    if pkg == "jax":
        return (JT.param_specs(cfg), {
            "tokens": jax.ShapeDtypeStruct((2, 64), jnp.int32)})
    return (T.param_specs(cfg), {
        "tokens": torch.empty((2, 64), dtype=torch.int32, device="meta")})


@pytest.fixture(scope="module")
def sessions():
    jcfg, tcfg = jax_config("qwen2_05b").reduced(), \
        get_config("qwen2_05b").reduced()
    js = JSession(jax_prefill(jcfg), prefill_args(jcfg, "jax"))
    ts = Session(make_prefill_step(tcfg), prefill_args(tcfg, "torch"))
    jreq = JRequest(mesh=JMeshSpec(AXES, (2, 2)), hw=JHardwareSpec(**HW),
                    backend="greedy")
    treq = Request(mesh=MeshSpec(AXES, (2, 2)), hw=HardwareSpec(**HW),
                   backend="greedy")
    return js, ts, jreq, treq, js.partition(jreq), ts.partition(treq)


def test_plan_for_state_gives_the_searched_plan(sessions):
    _, ts, _, treq, _, tp = sessions
    again = ts.plan_for_state(treq, tp.state, label="replay")
    assert again.in_specs == tp.in_specs and again.out_specs == tp.out_specs
    # the dense cost model against the search's incremental one
    assert again.cost == pytest.approx(tp.cost, rel=1e-9)
    assert again.breakdown == pytest.approx(tp.breakdown, rel=1e-9)
    assert again.logical_rules == tp.logical_rules
    assert (again.backend, again.search_seconds, again.evaluations) == \
        ("replay", 0.0, 0)


def test_plan_for_state_matches_the_references(sessions):
    js, ts, jreq, treq, jp, tp = sessions
    mine = ts.plan_for_state(treq, tp.state)
    ref = js.plan_for_state(jreq, jp.state)
    assert [tuple(s) for s in mine.in_specs] == \
        [tuple(s) for s in ref.in_specs]
    assert [tuple(s) for s in mine.out_specs] == \
        [tuple(s) for s in ref.out_specs]
    assert abs(mine.cost - ref.cost) <= COST_REL_TOL * ref.cost
    assert mine.backend == ref.backend == "manual"


@pytest.mark.parametrize("backend", ["greedy", "mcts"])
def test_auto_partition_equals_session_partition(backend):
    cfg = get_config("qwen2_05b").reduced()
    fn, args = make_prefill_step(cfg), prefill_args(cfg, "torch")
    mesh = MeshSpec(AXES, (1, 2))
    search = MCTSConfig(rounds=2) if backend == "mcts" else None
    got = auto_partition(fn, args, mesh, hw=HardwareSpec(**HW),
                         backend=backend, mcts=search)
    want = Session(fn, args).partition(Request(
        mesh=mesh, hw=HardwareSpec(**HW), backend=backend,
        search_config=search))
    assert got.in_specs == want.in_specs and got.out_specs == want.out_specs
    assert got.cost == want.cost and got.backend == want.backend


def cheap_portfolio(pkg):
    """Greedy and a narrow beam, one thread: the same result every run."""
    from repro.core import portfolio as jp
    from repro.core import search as js
    from repro_torch.core import portfolio as tp
    from repro_torch.core import search as ts
    pf, search = (jp, js) if pkg == "jax" else (tp, ts)
    return pf.PortfolioConfig(members=(
        pf.PortfolioMember("greedy", config=search.BeamConfig(patience=1)),
        pf.PortfolioMember("beam", config=search.BeamConfig(width=2,
                                                            patience=1))),
        max_workers=1)


@pytest.mark.parametrize("kwarg", ["portfolio", "plan_store"])
def test_auto_partition_takes_a_portfolio_and_a_plan_store(kwarg, tmp_path):
    """``auto_partition(portfolio=...)`` and ``(plan_store=dir)`` give the
    reference's plans; a second call with the store is a hit."""
    from repro.core.partitioner import analyze as jax_analyze
    from repro.core.partitioner import auto_partition as jax_auto_partition
    from repro_torch.core.partitioner import analyze
    cfg = dataclasses.replace(get_config("qwen2_05b").reduced())
    jcfg = jax_config("qwen2_05b").reduced()
    plans = {}
    for pkg, fn, args, Mesh, Hw, auto, trace in (
            ("torch", make_prefill_step(cfg), prefill_args(cfg, "torch"),
             MeshSpec, HardwareSpec, auto_partition, analyze),
            ("jax", jax_prefill(jcfg), prefill_args(jcfg, "jax"), JMeshSpec,
             JHardwareSpec, jax_auto_partition, jax_analyze)):
        # one trace for both calls: the second finds the first's entry
        kw = dict(hw=Hw(**HW), backend="greedy", artifacts=trace(fn, args))
        if kwarg == "portfolio":
            kw.update(portfolio=True, search_config=cheap_portfolio(pkg))
        else:
            kw.update(plan_store=str(tmp_path / pkg))
        plans[pkg] = auto(fn, args, Mesh(AXES, (1, 2)), **kw)
        if kwarg == "plan_store":
            assert not plans[pkg].cached
            again = auto(fn, args, Mesh(AXES, (1, 2)), **kw)
            assert again.cached and again.state == plans[pkg].state
    got, want = plans["torch"], plans["jax"]
    assert [tuple(s) for s in got.in_specs] == \
        [tuple(s) for s in want.in_specs]
    assert [tuple(s) for s in got.out_specs] == \
        [tuple(s) for s in want.out_specs]
    assert abs(got.cost - want.cost) <= COST_REL_TOL * want.cost
    assert got.backend == want.backend == (
        "portfolio" if kwarg == "portfolio" else "greedy")
    if kwarg == "portfolio":
        mine, ref = (p.eval_stats["portfolio"] for p in (got, want))
        assert mine["winner"] == ref["winner"]
        assert [m["status"] for m in mine["members"]] == \
            [m["status"] for m in ref["members"]] == ["done", "done"]
