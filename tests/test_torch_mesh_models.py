"""The port's models sharded on 2x2 gloo meshes against the unsharded run.

Three programs at reduced width, in float32: the ``qwen2_05b`` prefill,
its train step (``launch.specs``'s train cell: loss, AdamW, default
``AdamConfig``) and the ``recurrentgemma_2b`` prefill, each with
``use_pallas`` set, so the fused sites run through ``kernels.ops`` (on
CPU tensors the kernels' plain versions).  Each program gets two plans
for the 2x2 mesh, searched greedily under one explicit ``HardwareSpec``:

- the port's, whose kernel sites carry per-site specs: the sharded ones
  run under ``local_map`` on local shards;
- the reference's, written as JSON by the JAX package's ``Session`` and
  read by the port's ``ShardingPlan.from_json``.  Both packages spell the
  input paths alike (pinned below), so no mapping by flattening order is
  needed.  The reference's jax 0.9 trace records no fused sites
  (ROADMAP queue 3), so under its plan every site runs under
  ``local_map`` with every placement ``Replicate``.

Four gloo processes apply each plan to the same seeded inputs (weights
from a torch generator, tokens from a numpy seed).  Every output leaf,
gathered, must equal the unsharded step's within 1e-4 (the sharded
products sum in another order), and lie as the plan's ``out_specs``
say.  For the train step the outputs are the loss, the metrics and the
new train state; after one step the first moment is ``(1 - b1)`` times
the clipped gradient, so every gradient leaf is held too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.api import Request as JRequest
from repro.api import Session as JSession
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jax_config
from repro.core.cost_model import HardwareSpec as JHardwareSpec
from repro.core.cost_model import MeshSpec as JMeshSpec
from repro.launch import specs as jspecs
from repro_torch import pytree
from repro_torch.api import Request, Session
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.cost_model import HardwareSpec, MeshSpec
from repro_torch.core.partitioner import ShardingPlan
from repro_torch.launch import mesh as M
from repro_torch.launch import specs

TOL = 1e-4
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
AXES = ("data", "model")
B, S = 4, 16
RANKS_TIMEOUT = 240.0
CASES = {"qwen2_05b-prefill": ("qwen2_05b", "prefill"),
         "qwen2_05b-train": ("qwen2_05b", "train"),
         "recurrentgemma_2b-prefill": ("recurrentgemma_2b", "prefill")}


def port_cell(arch, kind):
    cfg = dataclasses.replace(get_config(arch).reduced(), use_pallas=True)
    fn, args, _ = specs.step_and_inputs(cfg, ShapeConfig("t", S, B, kind))
    return cfg, fn, args


def inputs(arch, kind):
    """The step's seeded inputs, on the CPU."""
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as St
    cfg, _, _ = port_cell(arch, kind)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    if kind == "prefill":
        return T.init_params(cfg, gen, device="cpu"), {"tokens": tokens}
    targets = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    return (St.init_train_state(cfg, gen, device="cpu"),
            {"tokens": tokens, "targets": targets})


def mesh_rank(rank, arch, kind, plans):
    """Apply each plan (JSON) and the unsharded step to the same inputs."""
    from repro_torch.kernels import ops
    from repro_torch.models import sharding
    _, fn, _ = port_cell(arch, kind)
    args = inputs(arch, kind)
    want = pytree.tree_leaves(fn(*args))
    out = {}
    for name, text in plans.items():
        ops.local_calls.clear()
        sharding.made_whole.clear()
        sharding.local_ops.clear()
        applied = ShardingPlan.from_json(text).apply(fn, device="cpu")
        got = pytree.tree_leaves(applied(*args))
        mesh = applied.mesh
        out[name] = {
            "errors": [(g.full_tensor() - w).abs().max().item()
                       for g, w in zip(got, want)],
            "scale": [w.abs().max().item() for w in want],
            "specs": [M.spec_for_placements(g.placements, mesh, g.ndim)
                      for g in got],
            "local_calls": dict(ops.local_calls),
            "copies": ops.site_copies,
            "made_whole": dict(sharding.made_whole),
            "local_ops": dict(sharding.local_ops)}
        if kind == "train":
            out[name]["donated"] = donated_step(fn, text, args, want)
    return out


def donated_step(fn, text, args, want):
    """The train step applied with its state donated: once on placed
    arguments (the state's DTensors take the new state), once on the
    full tensors (placed anew by the call, so none of them is written)."""
    applied = ShardingPlan.from_json(text).apply(fn, device="cpu",
                                                 donate_argnums=0)
    mesh = applied.mesh
    placed = applied.place(args)
    before = pytree.tree_leaves(placed[0])
    got = applied(*placed)
    leaves = pytree.tree_leaves(got)
    full = [x.clone() for x in pytree.tree_leaves(args[0])]
    again = pytree.tree_leaves(applied(*args))
    return {
        "errors": [(g.full_tensor() - w).abs().max().item()
                   for g, w in zip(leaves, want)],
        "again_errors": [(g.full_tensor() - w).abs().max().item()
                         for g, w in zip(again, want)],
        "specs": [M.spec_for_placements(g.placements, mesh, g.ndim)
                  for g in leaves],
        "state_is_input": [o is i for o, i in
                           zip(pytree.tree_leaves(got[0]), before)],
        "full_unwritten": all(torch.equal(a, b) for a, b in
                              zip(full, pytree.tree_leaves(args[0])))}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    arch, kind = CASES[request.param]
    jc = jax_config(arch).reduced()
    jfn, jargs, _ = jspecs.step_and_inputs(jc, JShapeConfig("t", S, B, kind))
    jp = JSession(jfn, jargs).partition(JRequest(
        mesh=JMeshSpec(AXES, (2, 2)), hw=JHardwareSpec(**HW),
        backend="greedy"))
    _, fn, args = port_cell(arch, kind)
    tp = Session(fn, args).partition(Request(
        mesh=MeshSpec(AXES, (2, 2)), hw=HardwareSpec(**HW),
        backend="greedy"))
    runs = M.run_ranks(mesh_rank, 4, arch, kind,
                       {"port": tp.to_json(), "reference": jp.to_json()},
                       timeout=RANKS_TIMEOUT)
    return request.param, tp, ShardingPlan.from_json(jp.to_json()), runs


def test_reference_paths_are_the_ports(case):
    _, tp, jp, _ = case
    assert jp.input_paths == tp.input_paths


@pytest.mark.parametrize("plan", ["port", "reference"])
def test_sharded_equals_unsharded(case, plan):
    name, _, _, runs = case
    for r in runs:
        res = r[plan]
        assert len(res["errors"]) == len(res["scale"])
        for i, (err, scale) in enumerate(zip(res["errors"], res["scale"])):
            assert err <= TOL * max(1.0, scale), (name, plan, i, err)


@pytest.mark.parametrize("plan", ["port", "reference"])
def test_outputs_lie_as_out_specs(case, plan):
    _, tp, jp, runs = case
    want = (tp if plan == "port" else jp).out_specs
    for r in runs:
        assert r[plan]["specs"] == want


@pytest.mark.parametrize("case", ["qwen2_05b-train"], indirect=True)
@pytest.mark.parametrize("plan", ["port", "reference"])
def test_donated_train_state(case, plan):
    """``donate_argnums=0`` on the mesh: the placed state's DTensors are
    returned holding the new state, placed as ``out_specs``, equal to
    the unsharded step; a full-tensor state is placed anew by the call
    and not written."""
    name, tp, jp, runs = case
    want = (tp if plan == "port" else jp).out_specs
    for r in runs:
        res = r[plan]["donated"]
        assert res["specs"] == want
        assert all(res["state_is_input"]) and res["state_is_input"]
        assert res["full_unwritten"]
        for i, (err, again, scale) in enumerate(zip(
                res["errors"], res["again_errors"], r[plan]["scale"])):
            assert err <= TOL * max(1.0, scale), (name, plan, i, err)
            assert again <= TOL * max(1.0, scale), (name, plan, i, again)


def test_sharded_sites_run_on_local_shards(case):
    """Each sharded site's local call takes the global shape split as its
    specs say; no local shard needed a copy."""
    name, tp, _, runs = case
    sharded = [r for r in tp.kernel_sites if r["sharded"]]
    assert sharded, f"{name}: the port's 2x2 plan shards no kernel site"
    sizes = dict(zip(tp.mesh.axes, tp.mesh.sizes))
    kernel = sharded[0]["kernel"]
    for r in runs:
        calls = r["port"]["local_calls"]
        assert calls and r["port"]["copies"] == 0
        for (k, impl, shapes, _), n in calls.items():
            assert k == kernel and impl == "cuda" and n >= 1
            spec = sharded[0]["in_specs"][0]
            glob = (B, S) + shapes[0][2:]
            for dim, entry in enumerate(spec):
                axes = () if entry is None else \
                    (entry,) if isinstance(entry, str) else entry
                div = int(np.prod([sizes[a] for a in axes]))
                assert shapes[0][dim] * div == glob[dim], (name, shapes)


def test_what_dtensor_cannot_shard_is_counted(case):
    """Each RG-LRU block's NaN test runs on local shards (one per block
    and call).  The plans shard the batch and every weight over both
    axes; the weights are gathered before their products
    (``sharding.gather_for``), so the projections keep the batch's
    sharding and no head split has a sharded dim to make whole."""
    name, _, _, runs = case
    arch, kind = CASES[name]
    cfg = port_cell(arch, kind)[0]
    n_lru = sum(k == "rglru" for k in cfg.pattern[:cfg.num_layers])
    for r in runs:
        for plan in ("port", "reference"):
            assert r[plan]["local_ops"] == ({"ne": n_lru} if n_lru else {})
            assert all(k.startswith("split of a dim sharded")
                       for k in r[plan]["made_whole"])
        assert r["port"]["made_whole"] == {}


def test_reference_sites_run_whole(case):
    """The reference's plan records no fused sites: each runs under
    ``local_map`` on the whole tensors (every placement ``Replicate``)."""
    _, _, jp, runs = case
    assert jp.kernel_sites == []
    for r in runs:
        calls = r["reference"]["local_calls"]
        assert calls
        for (_, _, shapes, _), _ in calls.items():
            assert shapes[0][:2] == (B, S)
