"""TOAST's MoE train plans run by ``plan.apply`` on meshes of gloo ranks
(CPU), against one process.

Reduced f32 ``mixtral_8x22b`` and ``arctic_480b`` (2 layers, d 64, 4
experts, top-2), the train step of ``launch.specs`` (default
``AdamConfig``), a batch from a numpy seed:

- the four 2x2 plans ``tests/test_torch_moe_train_plans.py`` holds
  against the reference's, searched greedily under one explicit
  ``HardwareSpec``: mixtral's batch dispatch at B 2 x S 32 without remat,
  its global dispatch with remat, its local dispatch (4 pools) without,
  and arctic's batch dispatch at B 1 x S 32 with remat; each plan runs
  the step it was searched for (capacity factor 4.0) and the same step
  at capacity 1.0 (tokens dropped) with remat the other way.

``plan.apply(step, donate_argnums=0)`` runs two steps eagerly on the
placed state.  Within 1e-4 (relative to the largest, at least 1) of two
steps of the plain step: the loss, the metrics (``ce``, ``grad_norm``,
``step``) and every leaf of the new state; each new leaf placed as the
plan's ``out_specs`` and written into the donated leaf's shards, as on
one device; the expert stacks' moments placed as their parameters; no
expert stack, gradient or moment gathered whole.  Mixtral's (1, 2)
plan from the default ``Request`` and the 2x4 plans pinned to the
full-depth plans' expert and router specs run in
``tests/test_torch_moe_mesh_train_pinned.py``.  This file imports no
JAX.
"""

import dataclasses

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
from repro_torch.train import steps as TS
from test_torch_moe_mesh import expert_gathers

TOL = 1e-4
STEPS = 2
RANKS_TIMEOUT = 300.0
AXES = ("data", "model")
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
POOLS = 4
# id -> (arch, dispatch, remat, B, S)
CASES = {
    "mixtral-batch": ("mixtral_8x22b", "batch", False, 2, 32),
    "mixtral-global-remat": ("mixtral_8x22b", "global", True, 2, 32),
    "mixtral-local": ("mixtral_8x22b", "local", False, 2, 32),
    "arctic-batch-remat-b1": ("arctic_480b", "batch", True, 1, 32),
}
# each plan's runs: (capacity factor, remat as searched or flipped)
RUNS = ((4.0, False), (1.0, True))
STACKS = ("wi", "wgate", "wo")


def config(case, capacity=4.0, flip=False):
    arch, mode, remat, _, _ = CASES[case]
    return dataclasses.replace(
        get_config(arch).reduced(), moe_dispatch=mode, moe_local_pools=POOLS,
        moe_capacity_factor=capacity, remat=remat != flip)


def session(case):
    cfg = config(case)
    B, L = CASES[case][3:]
    fn, args, _ = specs.step_and_inputs(cfg, ShapeConfig("t", L, B, "train"))
    return Session(fn, args)


def batch_of(cfg, B, L):
    rng = np.random.default_rng(1)
    return {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, L)).astype(np.int32))
        for k in ("tokens", "targets")}


def run_plan(text, cfg, B, L):
    """``STEPS`` steps of the plan (JSON) applied with the state donated,
    against the plain step: the worst differences and what the run
    showed."""
    step = TS.make_train_step(cfg)
    state = TS.init_train_state(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    batch = batch_of(cfg, B, L)
    want, wmetrics = state, []
    for _ in range(STEPS):
        want, m = step(want, batch)
        wmetrics.append(m)
    plan = ShardingPlan.from_json(text)
    applied = plan.apply(step, device="cpu", donate_argnums=0)
    got, pbatch = applied.place((state, batch))
    mine = [x.to_local().data_ptr() for x in pytree.tree_leaves(got)]
    gmetrics = []
    with M.collective_tally() as tally:
        for _ in range(STEPS):
            got, m = applied(got, pbatch)
            gmetrics.append(m)
    leaves, paths = pytree.flatten_with_paths(got)
    want_pl = plan.torch_out_placements(applied.mesh)
    placements = dict(zip(paths, (tuple(x.placements) for x in leaves)))

    def diff(a, b):
        return ((a.double() - b.double()).abs().max() /
                max(1.0, b.abs().max().item())).item()
    return {
        "state": max(diff(a.full_tensor(), b) for a, b in
                     zip(leaves, pytree.tree_leaves(want))),
        "metrics": {k: max(diff(g[k].full_tensor(), w[k])
                           for g, w in zip(gmetrics, wmetrics))
                    for k in ("loss", "ce", "grad_norm", "step")},
        "steps": [int(g["step"].full_tensor()) for g in gmetrics],
        "misplaced": [p for x, p, w in zip(leaves, paths, want_pl)
                      if tuple(x.placements) != w],
        "in_place": sum(x.to_local().data_ptr() == p for x, p in
                        zip(leaves, mine)),
        "leaves": len(leaves),
        "moments_as_params": [
            p for p in paths if p.startswith(".params") and
            p.endswith(tuple(f"['{k}']" for k in STACKS)) and not
            placements[p] == placements[".opt.m" + p[7:]] ==
            placements[".opt.v" + p[7:]]],
        "expert_gathers": expert_gathers(tally.shapes, cfg)}


def dropped(cfg, B, L) -> int:
    """The routed pairs one plain forward of the seeded batch drops."""
    from repro_torch.models import layers as L_
    from repro_torch.models import transformer as T
    calls, inner = [], L_.top_k

    def recorded(x, k):
        out = inner(x, k)
        calls.append((x, out[0]))
        return out
    L_.top_k = recorded
    try:
        T.forward(cfg, T.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu"),
                  batch_of(cfg, B, L)["tokens"])
    finally:
        L_.top_k = inner
    return sum(int((x > 0).sum() - (v > 0).sum()) for x, v in calls[1::2])


def rank_runs(rank, cases):
    """Each (case, capacity, flip, plan JSON) on this group."""
    out = {}
    for case, capacity, flip, text in cases:
        B, L = CASES[case][3:]
        out[case, capacity, flip] = run_plan(
            text, config(case, capacity, flip), B, L)
    return out


@pytest.fixture(scope="module")
def plans():
    return {case: session(case).partition(Request(
        mesh=MeshSpec(AXES, (2, 2)), hw=HardwareSpec(**HW),
        backend="greedy")) for case in CASES}


@pytest.fixture(scope="module")
def ranks(plans):
    return M.run_ranks(rank_runs, 4, [
        (case, capacity, flip, plans[case].to_json())
        for case in CASES for capacity, flip in RUNS],
        timeout=RANKS_TIMEOUT)


IDS = [(case, capacity, flip) for case in CASES for capacity, flip in RUNS]


def ids(c):
    case, capacity, flip = c
    remat = config(case, capacity, flip).remat
    return f"2x2-{case}-cf{capacity}-{'remat' if remat else 'noremat'}"


@pytest.mark.parametrize("c", IDS, ids=ids)
def test_two_steps_equal_one_process(ranks, c):
    for r in ranks:
        res = r[c]
        assert res["state"] <= TOL, (c, res["state"])
        for k, err in res["metrics"].items():
            assert err <= TOL, (c, k, err)
        assert res["steps"] == [1, 2]


@pytest.mark.parametrize("c", IDS, ids=ids)
def test_new_state_placed_as_out_specs_in_the_donated_shards(ranks, c):
    """Every new leaf placed as the plan's ``out_specs`` and written into
    the donated leaf's shards (the state pairs with itself, as on one
    device); the expert stacks' moments lie as their parameters."""
    for r in ranks:
        res = r[c]
        assert res["misplaced"] == [], res["misplaced"]
        assert res["in_place"] == res["leaves"]
        assert res["moments_as_params"] == []


def layer_sharded(plan) -> set:
    """The expert stacks' shapes whose layer dim the plan shards (their
    layers live on different ranks, so the layer scan needs them
    whole, as GSPMD's scan does)."""
    cfg = config("mixtral-batch")
    _, args, _ = specs.step_and_inputs(cfg, ShapeConfig("t", 32, 2,
                                                        "train"))
    return {tuple(x.shape) for p, s, x in zip(
        plan.input_paths, plan.in_specs, pytree.tree_leaves(args))
        if p.endswith(tuple(f"['{k}']" for k in STACKS)) and s and s[0]}


@pytest.mark.parametrize("c", IDS, ids=ids)
def test_no_expert_stack_gathered_whole(ranks, plans, c):
    """No expert stack, gradient or moment is gathered whole (no 2x2 plan
    shards a stack's layer dim; see :func:`layer_sharded`)."""
    assert not layer_sharded(plans[c[0]])
    for r in ranks:
        assert r[c]["expert_gathers"] == {}, r[c]["expert_gathers"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_capacity_one_drops_tokens(case):
    """The runs at capacity 1.0 drop routed pairs (the plain forward of
    the same batch), those at 4.0 none."""
    B, L = CASES[case][3:]
    assert dropped(config(case, 4.0), B, L) == 0
    assert dropped(config(case, 1.0), B, L) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_plans_shard_the_expert_stacks(plans, case):
    """Each 2x2 plan shards every expert stack (parameters and moments)
    on some mesh axis: the runs above exercise sharded experts."""
    plan = plans[case]
    for p, s in zip(plan.input_paths, plan.in_specs):
        if p.endswith(tuple(f"['{k}']" for k in STACKS)):
            assert any(e is not None for e in s), (p, s)
