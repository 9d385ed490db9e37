"""Mixtral's (1, 2) train plan from the default ``Request``, and the
full-depth MoE train plans' expert and router specs pinned onto the
reduced models' 2x4 train plans, run by ``plan.apply`` on two and on
eight gloo ranks (CPU), against one process.

*(1, 2).*  Reduced f32 ``mixtral_8x22b``'s train step (batch dispatch,
B 2 x S 32) planned by ``Session`` with the default ``Request``, run as
``tests/test_torch_moe_mesh_train_plans.py`` runs its 2x2 plans (two
donated steps at capacity 4.0 and 1.0, remat both ways, 1e-4).  The
plan shards the layer dim of ``wgate`` and ``wo``: those two stacks are
gathered on their layer dim (GSPMD's layer loop needs each layer
whole too), no other.

*2x4.*
``mixtral_8x22b`` (56 layers) and ``arctic_480b`` (35) at full width,
their train step at B 1 x S 4096 (remat on, the configs' own), are
planned for a 2x4 mesh with the default ``Request`` on ``meta``
tensors, as the card's MoE train phase plans them.  The specs those
plans give the expert stacks (``wi``, ``wgate``, ``wo``) and the router
(``wg``), for the parameters and both moments, are pinned, path by
path, onto the reduced f32 model's train step (2 layers, d 64, 4
experts; batch dispatch, B 4 x S 32), searched greedily under one
explicit ``HardwareSpec``.  ``plan.apply(step, donate_argnums=0)`` of
that plan runs two steps on eight ranks: the loss, the metrics and every
leaf of the new state within 1e-4 (relative to the largest, at least 1)
of the plain step's, every leaf placed as ``out_specs``, and no expert
stack, gradient or moment gathered whole.  This file imports no JAX.
"""

import dataclasses

import pytest

from repro_torch.api import Pin, Request, Session
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.cost_model import HardwareSpec, MeshSpec
from repro_torch.launch import mesh as M
from repro_torch.launch import specs
from test_torch_moe_mesh_train_plans import (AXES, HW, RUNS, STACKS, TOL,
                                             config, layer_sharded,
                                             rank_runs, run_plan, session)

RANKS_TIMEOUT = 300.0
SHAPE = (2, 4)
ARCHS = ("mixtral_8x22b", "arctic_480b")
B, S = 4, 32
PINNED = STACKS + ("wg",)


def pinned_paths(plan) -> dict:
    """The plan's specs of the expert stacks and the router: path ->
    spec, for the parameters and both moments."""
    return {p: tuple(s) for p, s in zip(plan.input_paths, plan.in_specs)
            if "['ffn']" in p and p.endswith(
                tuple(f"['{k}']" for k in PINNED))}


def full_plan(arch):
    cfg = dataclasses.replace(get_config(arch), use_pallas=False)
    fn, args, _ = specs.step_and_inputs(cfg, ShapeConfig("t", 4096, 1,
                                                         "train"))
    return Session(fn, args).partition(Request(mesh=MeshSpec(AXES, SHAPE)))


def reduced_config(arch):
    return dataclasses.replace(get_config(arch).reduced(),
                               moe_dispatch="batch")


def pinned_plan(arch, pins):
    cfg = reduced_config(arch)
    fn, args, _ = specs.step_and_inputs(cfg, ShapeConfig("t", S, B,
                                                         "train"))
    return Session(fn, args).partition(Request(
        mesh=MeshSpec(AXES, SHAPE), hw=HardwareSpec(**HW), backend="greedy",
        constraints=tuple(Pin(p, s) for p, s in pins.items())))


def eight_ranks(rank, texts):
    return {arch: run_plan(text, reduced_config(arch), B, S)
            for arch, text in texts.items()}


@pytest.fixture(scope="module")
def one_by_two():
    plan = session("mixtral-batch").partition(
        Request(mesh=MeshSpec(AXES, (1, 2))))
    return plan, M.run_ranks(rank_runs, 2, [
        ("mixtral-batch", capacity, flip, plan.to_json())
        for capacity, flip in RUNS], timeout=RANKS_TIMEOUT)


@pytest.mark.parametrize("capacity,flip", RUNS)
def test_the_1x2_plan_equals_one_process(one_by_two, capacity, flip):
    """Two donated steps within 1e-4, placed as ``out_specs`` in the
    donated shards, the moments as their parameters (remat
    ``config("mixtral-batch", capacity, flip).remat``)."""
    _, ranks = one_by_two
    for r in ranks:
        res = r["mixtral-batch", capacity, flip]
        assert res["state"] <= TOL, res["state"]
        for k, err in res["metrics"].items():
            assert err <= TOL, (k, err)
        assert res["steps"] == [1, 2]
        assert res["misplaced"] == [] and res["moments_as_params"] == []
        assert res["in_place"] == res["leaves"]
    assert config("mixtral-batch", capacity, flip).remat == flip


@pytest.mark.parametrize("capacity,flip", RUNS)
def test_the_1x2_plan_gathers_only_its_layer_sharded_stacks(
        one_by_two, capacity, flip):
    plan, ranks = one_by_two
    stacked = layer_sharded(plan)
    assert stacked
    for r in ranks:
        for k in r["mixtral-batch", capacity, flip]["expert_gathers"]:
            assert set(M.gathered_shapes(eval(k)[1])) & stacked, k


@pytest.fixture(scope="module")
def plans():
    out = {}
    for arch in ARCHS:
        full = full_plan(arch)
        out[arch] = (full, pinned_plan(arch, pinned_paths(full)))
    return out


@pytest.fixture(scope="module")
def ranks(plans):
    return M.run_ranks(eight_ranks, 8,
                       {arch: p.to_json() for arch, (_, p) in plans.items()},
                       timeout=RANKS_TIMEOUT)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_pins_hold_and_shard_the_experts(plans, arch):
    """The reduced plan takes the full-depth plan's expert and router
    specs, and they shard every expert stack."""
    full, plan = plans[arch]
    want = pinned_paths(full)
    assert len(want) == 3 * len(PINNED)
    assert pinned_paths(plan) == want
    for p, s in want.items():
        if p.endswith(tuple(f"['{k}']" for k in STACKS)):
            assert any(e is not None for e in s), (p, s)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_steps_on_eight_ranks_equal_one_process(ranks, arch):
    for r in ranks:
        res = r[arch]
        assert res["state"] <= TOL, res["state"]
        for k, err in res["metrics"].items():
            assert err <= TOL, (k, err)
        assert res["steps"] == [1, 2]


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_donated_and_no_expert_stack_gathered(ranks, arch):
    for r in ranks:
        res = r[arch]
        assert res["misplaced"] == [] and res["moments_as_params"] == []
        assert res["in_place"] == res["leaves"]
        assert res["expert_gathers"] == {}, res["expert_gathers"]

