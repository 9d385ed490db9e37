"""Multi-device ``plan.apply`` on gloo CPU groups, against the reference.

*Placements.*  ``launch.mesh.placements_for`` turns a plan's JAX-style
``PartitionSpec`` into DTensor placements, one per mesh dim, and
``spec_for_placements`` turns them back.  A tuple entry is major-to-
minor as in JAX, which is DTensor's own order when the axes run in the
mesh's order.  Two axes against it (``("model", "data")`` on a
``("data", "model")`` mesh, which the searched 2x4 plan of the apply
script gives its weights) become DTensor's strided shard; each rank's
block is JAX's (pinned below on 8 ranks).  Three such axes raise
``NotImplementedError``.

*Rules.*  The port's rules maps and ``spec_for`` give the reference's
specs for the same rules and names; ``constrain`` redistributes a DTensor
under installed rules and leaves plain tensors alone.

*The reference's own apply script* (``tests/test_api.py``,
``APPLY_SCRIPT``): the MLP planned for a 2x4 mesh with the first input
pinned to ``("data", None)``, applied on 8 gloo processes, one per
device.  The output's placement is ``plan.out_specs[0]`` and its value
the unsharded product's; a plan read back from JSON applies the same.
The script's AOT ``lower(...).compile()`` has no counterpart in the port
yet (``AppliedPlan.lower`` is ROADMAP queue 1, item 17).  Each group of
ranks runs under its own wall-clock limit.
"""

import dataclasses
from types import SimpleNamespace

import pytest
import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.placement_types import _StridedShard

from repro.models import sharding as jsharding
from repro_torch.api import Pin, Request, Session
from repro_torch.core.cost_model import MeshSpec
from repro_torch.core.mcts import MCTSConfig
from repro_torch.core.partitioner import PartitionSpec as P
from repro_torch.core.partitioner import ShardingPlan
from repro_torch.launch import mesh as M
from repro_torch.models import sharding

MESH = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 4))
MESH3 = SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                        shape=(2, 2, 2))
RANKS_TIMEOUT = 120.0


def mlp(x, w1, w2):
    return torch.relu(x @ w1) @ w2


def mlp_args(device):
    mk = (lambda *s: torch.empty(s, device="meta")) if device == "meta" \
        else (lambda *s: torch.ones(s))
    return mk(1024, 512), mk(512, 2048), mk(2048, 512)


# -- placements ---------------------------------------------------------


@pytest.mark.parametrize("spec, ndim, want", [
    (P(), 0, (Replicate(), Replicate())),
    (P(None, None), 2, (Replicate(), Replicate())),
    (P("data", None), 2, (Shard(0), Replicate())),
    (P(None, "model"), 2, (Replicate(), Shard(1))),
    (P("model", "data"), 2, (Shard(1), Shard(0))),
    (P(("data", "model"), None), 2, (Shard(0), Shard(0))),
    (P(None, ("data", "model")), 3, (Shard(1), Shard(1))),
    (P("data"), 3, (Shard(0), Replicate())),
])
def test_placements_for(spec, ndim, want):
    assert M.placements_for(spec, MESH, ndim) == want


@pytest.mark.parametrize("spec, ndim", [
    (P("data", None), 2), (P(None, "model", None), 3),
    (P(("data", "model"), None), 2), (P("model", "data"), 2),
    (P(None, None), 2), (P(None, ("data", "model"), None), 3),
])
def test_spec_round_trip(spec, ndim):
    placements = M.placements_for(spec, MESH, ndim)
    assert M.spec_for_placements(placements, MESH, ndim) == spec


def test_reversed_multi_axis_entry_is_a_strided_shard():
    # ("model", "data") on a ("data", "model") mesh: model major, data
    # minor; DTensor shards data (mesh dim 0) first, so data's shard is
    # strided by model's size
    got = M.placements_for(P(None, ("model", "data")), MESH, 2)
    assert got == (_StridedShard(1, split_factor=4), Shard(1))
    assert M.spec_for_placements(got, MESH, 2) == P(None, ("model", "data"))


def test_three_reversed_axes_raise():
    with pytest.raises(NotImplementedError, match="strided"):
        M.placements_for(P(("model", "pod", "data")), MESH3, 1)
    # in the mesh's order, three axes are plain shards
    assert M.placements_for(P(("pod", "data", "model")), MESH3, 1) == \
        (Shard(0),) * 3


@pytest.mark.parametrize("spec, match", [
    (P("pod", None), "not an axis"),
    (P("data", "data"), "twice"),
    (P("data", None, None), "more entries"),
])
def test_bad_specs_raise(spec, match):
    with pytest.raises(ValueError, match=match):
        M.placements_for(spec, MESH, 2)


def test_partial_and_foreign_strided_have_no_spec():
    with pytest.raises(ValueError, match="no PartitionSpec"):
        M.spec_for_placements((Partial(), Replicate()), MESH, 2)
    # a split factor that is not the major axis's size
    with pytest.raises(NotImplementedError, match="strided"):
        M.spec_for_placements((_StridedShard(0, split_factor=2), Shard(0)),
                              MESH, 2)


def test_mesh_specs_match_the_reference():
    from repro.launch import mesh as jmesh
    for multi in (False, True):
        want = jmesh.production_mesh_spec(multi_pod=multi)
        assert M.production_mesh_spec(multi_pod=multi).as_dict() == \
            want.as_dict()
    assert M.smoke_mesh_spec().as_dict() == jmesh.smoke_mesh_spec().as_dict()


# -- rules --------------------------------------------------------------

NAMES = [("act_batch", "seq", "embed"), ("batch", None, "vocab"),
         ("embed", "hidden"), ("heads", "embed"), ("act_batch", "seq",
                                                   "heads"),
         ("seq", "hidden", "vocab"), (None, None), ("experts", "embed"),
         ("kv_heads", "embed")]


@pytest.mark.parametrize("rules", ["MANUAL_RULES", "MANUAL_RULES_MULTIPOD",
                                   "DECODE_WEIGHT_STATIONARY_RULES"])
def test_rules_match_the_reference(rules):
    mine, ref = getattr(sharding, rules), getattr(jsharding, rules)
    assert mine == ref
    for names in NAMES:
        with sharding.logical_rules(mine):
            got = sharding.spec_for(names)
        with jsharding.logical_rules(ref):
            want = jsharding.spec_for(names)
        assert (got is None) == (want is None), names
        if got is not None:
            assert tuple(got) == tuple(want), names


def test_no_rules_no_spec():
    assert sharding.get_rules() is None
    assert sharding.spec_for(("batch", "seq")) is None
    assert jsharding.spec_for(("batch", "seq")) is None
    with sharding.logical_rules(sharding.MANUAL_RULES):
        assert sharding.get_rules() == sharding.MANUAL_RULES
    assert sharding.get_rules() is None


def test_constrain_leaves_plain_tensors():
    x = torch.ones(4, 8, 16)
    with sharding.logical_rules(sharding.MANUAL_RULES):
        assert sharding.constrain(x, ("act_batch", "seq", "embed")) is x
    assert sharding.constrain(x, ("act_batch", "seq", "embed")) is x


# -- errors without a group ---------------------------------------------


@pytest.fixture(scope="module")
def plan():
    sess = Session(mlp, mlp_args("meta"))
    return sess.partition(Request(
        mesh=MeshSpec(("data", "model"), (2, 4)), min_dims=1,
        search_config=MCTSConfig(rounds=4),
        constraints=(Pin("[0][0]", P("data", None)),)))


def test_capture_on_a_mesh_raises(plan):
    with pytest.raises(ValueError, match="runs eagerly"):
        plan.apply(mlp, device="cpu", capture=True)


def test_missing_process_group_raises(plan):
    with pytest.raises(RuntimeError, match="init_process_group"):
        plan.apply(mlp, device="cpu")


def test_one_device_plan_takes_no_mesh(plan):
    import dataclasses
    one = dataclasses.replace(plan, mesh=MeshSpec(("data", "model"),
                                                  (1, 1)))
    with pytest.raises(ValueError, match="without a mesh"):
        one.apply(mlp, device="cpu", mesh=object())


def test_in_and_out_placements(plan):
    mesh = SimpleNamespace(mesh_dim_names=plan.mesh.axes,
                           shape=plan.mesh.sizes)
    ins = plan.torch_in_placements(mesh)
    assert ins[0] == (Shard(0), Replicate())
    assert [M.spec_for_placements(p, mesh, len(s))
            for p, s in zip(ins, plan.in_specs)] == plan.in_specs
    outs = plan.torch_out_placements(mesh)
    assert M.spec_for_placements(outs[0], mesh, 2) == plan.out_specs[0]


# -- the apply script on 8 gloo processes -------------------------------


def apply_rank(rank, plan):
    """One rank of the reference's apply script, ported; then constrain
    under rules on the same mesh."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    x, w1, w2 = mlp_args("cpu")
    step = plan.apply(mlp, device="cpu")
    y = step(x, w1, w2)
    assert x.shape == (1024, 512)
    mesh = step.mesh
    out = {"spec": M.spec_for_placements(y.placements, mesh, y.ndim),
           "local": tuple(y.to_local().shape),
           "equal": torch.equal(y.full_tensor(), mlp(x, w1, w2)),
           "mesh": (tuple(mesh.shape), tuple(mesh.mesh_dim_names))}
    step2 = ShardingPlan.from_json(plan.to_json()).apply(mlp, device="cpu")
    y2 = step2(x, w1, w2)
    out["json_spec"] = M.spec_for_placements(y2.placements, mesh, y2.ndim)
    out["json_equal"] = torch.equal(y2.full_tensor(), y.full_tensor())
    # the same call on placed arguments (DTensors): no redistribution of
    # the inputs, the same result, a signature of its own
    placed = step.place((x, w1, w2))
    y3 = step(*placed)
    out["placed_equal"] = torch.equal(y3.full_tensor(), y.full_tensor())
    out["placed_inputs"] = [M.spec_for_placements(a.placements, mesh, 2)
                            for a in placed]
    out["signatures"] = len(step._cache)
    # donation pairs a placed leaf with an output placed as it is: x
    # (P("data", None)) takes y's value when y is placed so, and raises
    # when the plan places y otherwise
    for name, spec in (("kept", P("data", None)), ("moved", P(None, "model"))):
        donating = dataclasses.replace(plan, out_specs=[spec]).apply(
            mlp, device="cpu", donate_argnums=0)
        px = donating.place((x, w1, w2))
        try:
            y4 = donating(*px)
            out[f"donated_{name}"] = (y4 is px[0],
                                      torch.equal(y4.full_tensor(),
                                                  y.full_tensor()))
        except ValueError as err:
            out[f"donated_{name}"] = str(err)

    # a reversed two-axis entry gives each rank JAX's block: device
    # (data d, model m) holds block m * 2 + d of 8
    d_i, m_i = mesh.get_coordinate()
    w = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
    s = distribute_tensor(w, mesh, M.placements_for(
        P(None, ("model", "data")), mesh, 2))
    out["strided_block"] = torch.equal(s.to_local(),
                                       w.chunk(8, 1)[m_i * 2 + d_i])
    out["strided_whole"] = torch.equal(s.full_tensor(), w)

    # constrain under the manual rules redistributes a DTensor
    h = torch.arange(4 * 8 * 16, dtype=torch.float32).reshape(4, 8, 16)
    d = distribute_tensor(h, mesh, [Replicate(), Replicate()])
    names = ("act_batch", "seq", "embed")
    out["no_rules_same"] = sharding.constrain(d, names) is d
    with sharding.logical_rules(sharding.MANUAL_RULES):
        c = sharding.constrain(d, names)
        out["constrained"] = M.spec_for_placements(c.placements, mesh, 3)
        out["constrained_equal"] = torch.equal(c.full_tensor(), h)
        out["constrained_local"] = tuple(c.to_local().shape)
        out["again_same"] = sharding.constrain(c, names) is c
    with sharding.logical_rules(jsharding.MANUAL_RULES_MULTIPOD):
        try:
            sharding.constrain(d, names)
            out["missing_axis"] = None
        except ValueError as err:
            out["missing_axis"] = str(err)
    # a split DTensor cannot shard (2 heads of a dim sharded 8 ways) is
    # made whole first and counted; one it can shard moves nothing
    sharding.made_whole.clear()
    e = distribute_tensor(h.reshape(4, 8, 16)[:, :, :16].reshape(4, 128),
                          mesh, [Shard(1), Shard(1)])
    split = sharding.split_dim(e, -1, (2, 64))
    out["split_equal"] = torch.equal(split.full_tensor(),
                                     e.full_tensor().reshape(4, 2, 64))
    out["split_whole"] = dict(sharding.made_whole)
    kept = sharding.split_dim(e, -1, (16, 8))
    out["kept_equal"] = torch.equal(kept.full_tensor(),
                                    e.full_tensor().reshape(4, 16, 8))
    out["kept_spec"] = M.spec_for_placements(kept.placements, mesh, 3)
    out["after_kept"] = dict(sharding.made_whole)
    # a mesh that is not the plan's
    try:
        plan.apply(mlp, device="cpu", mesh=DeviceMeshLike(mesh))
        out["wrong_mesh"] = None
    except ValueError as err:
        out["wrong_mesh"] = str(err)
    out["is_dtensor"] = isinstance(y, DTensor)
    return out


class DeviceMeshLike:
    """A mesh of the plan's size whose axes are named otherwise."""

    def __init__(self, mesh):
        self.shape = tuple(mesh.shape)
        self.mesh_dim_names = ("rows", "cols")
        self.device_type = mesh.device_type


@pytest.fixture(scope="module")
def apply_ranks(plan):
    return M.run_ranks(apply_rank, 8, plan, timeout=RANKS_TIMEOUT)


def test_apply_script_output_spec(plan, apply_ranks):
    for r in apply_ranks:
        assert r["is_dtensor"]
        assert r["mesh"] == ((2, 4), ("data", "model"))
        assert r["spec"] == plan.out_specs[0]
        assert r["equal"]


def test_apply_script_json_plan(plan, apply_ranks):
    for r in apply_ranks:
        assert r["json_spec"] == plan.out_specs[0]
        assert r["json_equal"]


def test_strided_shard_is_jax_block(apply_ranks):
    for r in apply_ranks:
        assert r["strided_block"] and r["strided_whole"]


def test_apply_script_placed_inputs(plan, apply_ranks):
    for r in apply_ranks:
        assert r["placed_equal"]
        assert r["placed_inputs"] == plan.in_specs
        assert r["placed_inputs"][0] == P("data", None)
        assert r["signatures"] == 2


def test_donation_pairs_placed_leaves(apply_ranks):
    for r in apply_ranks:
        assert r["donated_kept"] == (True, True)
        assert "placements" in r["donated_moved"]
        assert "[0]" in r["donated_moved"]


def test_constrain_under_rules(apply_ranks):
    for r in apply_ranks:
        assert r["no_rules_same"] and r["again_same"]
        assert r["constrained"] == P("data", "model", None)
        assert r["constrained_local"] == (2, 2, 16)
        assert r["constrained_equal"]
        # the multi-pod rules name "pod", which this mesh lacks: raised,
        # not swallowed as the reference's try does
        assert "pod" in r["missing_axis"]
        assert "not the plan's" in r["wrong_mesh"]


def test_unshardable_split_is_made_whole_and_counted(apply_ranks):
    for r in apply_ranks:
        assert r["split_equal"] and r["kept_equal"]
        assert r["split_whole"] == {
            "split of a dim sharded 8 ways into (2, 64)": 1}
        assert r["after_kept"] == r["split_whole"]
        assert r["kept_spec"] == P(None, ("data", "model"), None)


def test_partition_spec_pickles():
    import pickle
    for spec in (P(), P("data", None), P(("model", "data"), None, "x")):
        again = pickle.loads(pickle.dumps(spec))
        assert again == spec and type(again) is P


def failing_rank(rank):
    if rank == 1:
        raise ArithmeticError("rank one fails")
    return rank


def test_run_ranks_reraises_the_failure():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"
                       "(.|\n)*ArithmeticError: rank one fails"):
        M.run_ranks(failing_rank, 2, timeout=RANKS_TIMEOUT)


def sleeping_rank(rank):
    import time
    time.sleep(60)


def test_run_ranks_times_out():
    with pytest.raises(TimeoutError, match="outlived"):
        M.run_ranks(sleeping_rank, 2, timeout=4.0)
