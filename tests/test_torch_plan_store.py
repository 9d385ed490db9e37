"""The port's plan store against the JAX package's.

``ckpt/plan_store.py`` is a copy of the reference's.  For the same
fingerprint string, mesh, hardware fields and request params its keys
(``plan_key``, ``plan_key_v2``) and ``canonical_request_params`` must be
the reference's, bit for bit (``==``).  The port's program fingerprints
are its own, and its ``HardwareSpec`` defaults describe an H100, so the
store itself is checked on the port's own sessions, as the reference's
tests check the reference's: a second ``Session`` hits with
``cached=True`` and builds no cost model; a hit is checked against the
request's constraints again; a changed ``min_dims``, constraint, mesh or
hardware misses; temp files are swept; concurrent writers commit whole
entries; a corrupt entry is a miss; calibrated hardware round-trips.
The port's ``program_fingerprint`` of the reduced ``qwen2_05b`` prefill
step is the same in two processes with different ``PYTHONHASHSEED``s.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from repro.ckpt import plan_store as j_store
from repro.core import constraints as j_cons
from repro.core import cost_model as j_cost
from repro_torch.api import Request, Session
from repro_torch.ckpt import plan_store as t_store
from repro_torch.ckpt.plan_store import PlanStore, plan_key, plan_key_v2
from repro_torch.core import constraints as t_cons
from repro_torch.core import cost_model as t_cost
from repro_torch.core.constraints import ConstraintError, Pin, Replicate
from repro_torch.core.cost_model import HardwareSpec, MeshSpec
from repro_torch.core.partitioner import ShardingPlan, auto_partition
from repro_torch.core.portfolio import PortfolioConfig, PortfolioMember
from repro_torch.core.search import BeamConfig
from test_torch_core import HW, MICRO, meta

REPO = Path(__file__).resolve().parent.parent
AXES = ("data", "model")
MESH = MeshSpec(AXES, (2, 2))
_, T_MLP, MLP_SHAPES = MICRO["mlp"]


def mlp_args():
    return tuple(meta(*s) for s in MLP_SHAPES)


def request(**kw):
    kw.setdefault("mesh", MESH)
    kw.setdefault("hw", HardwareSpec(**HW))
    kw.setdefault("backend", "greedy")
    kw.setdefault("min_dims", 1)
    return Request(**kw)


def without_provenance(plan):
    d = plan.as_dict()
    d.pop("search_seconds")
    return d


@pytest.fixture(scope="module")
def sess():
    return Session(T_MLP, mlp_args())


@pytest.fixture(scope="module")
def mlp_plan(sess):
    return sess.partition(request())


# -- keys against the reference's ---------------------------------------------


FINGERPRINTS = ("a" * 64, "0123abcd" * 8)
MESHES = ((AXES, (4, 4), ()), (AXES, (2, 8), ()), (AXES, (4, 2), ("data",)),
          (("pod", "data", "model"), (2, 2, 2), ("pod",)), (("model",), (1,),
                                                           ()))
HARDWARE = (
    HW,
    dict(HW, coll_latency=4e-6, axis_bw=(("data", 1e9), ("model", 2e9))),
    dict(HW, hbm_per_chip=8e9, kernel_rates=(("flash_attention:cuda",
                                               3e14),)),
)


def params_cases(cons):
    la = [("batch", "embed"), ("embed", "hidden"), None]
    return [
        None, {}, {"min_dims": 2}, {"min_dims": 1, "logical_axes": None},
        {"min_dims": 1, "logical_axes": la},
        {"logical_axes": tuple(la)},
        {"logical_axes": [None if e is None else list(e) for e in la]},
        {"logical_axes": [None, None]},
        {"constraints": (cons.Pin("['x']", ("data",)),)},
        {"constraints": [["pin", "['x']", [["data"]]]]},
        {"min_dims": 4, "constraints": (cons.Replicate("*w1*"),
                                        cons.Forbid("embed", "model"))},
        {"min_dims": 1, "logical_axes": la,
         "constraints": (cons.Pin("batch", "data"),)},
    ]


@pytest.mark.parametrize("hw", range(len(HARDWARE)))
def test_keys_equal_the_references(hw):
    jhw = j_cost.HardwareSpec(**HARDWARE[hw])
    thw = t_cost.HardwareSpec(**HARDWARE[hw])
    for axes, sizes, dcn in MESHES:
        jm, tm = (j_cost.MeshSpec(axes, sizes, dcn),
                  t_cost.MeshSpec(axes, sizes, dcn))
        for jp, tp in zip(params_cases(j_cons), params_cases(t_cons)):
            assert t_store.canonical_request_params(tp) == \
                j_store.canonical_request_params(jp)
            for fp in FINGERPRINTS:
                assert t_store.plan_key_v2(fp, tm, thw, tp) == \
                    j_store.plan_key_v2(fp, jm, jhw, jp)
                if not (tp or {}).get("constraints"):
                    # v1 never keyed constraints
                    assert t_store.plan_key(fp, tm, thw, tp) == \
                        j_store.plan_key(fp, jm, jhw, jp)
            assert t_store._legacy_candidate_params(tp) == \
                j_store._legacy_candidate_params(jp)


def test_default_hardware_keys_as_the_h100():
    """``hw=None`` keys the port's defaults, an H100's data sheet."""
    fields = dataclasses.asdict(t_cost.HardwareSpec())
    jhw = j_cost.HardwareSpec(**fields)
    tm, jm = t_cost.MeshSpec(AXES, (2, 4)), j_cost.MeshSpec(AXES, (2, 4))
    assert plan_key_v2("a" * 64, tm) == j_store.plan_key_v2("a" * 64, jm, jhw)
    assert plan_key("a" * 64, tm) == j_store.plan_key("a" * 64, jm, jhw)
    assert plan_key_v2("a" * 64, tm) != j_store.plan_key_v2("a" * 64, jm)


# -- the store on the port's sessions -----------------------------------------


def test_a_second_session_hits_without_an_evaluation(tmp_path):
    store = PlanStore(tmp_path)
    cfg = PortfolioConfig(members=(
        PortfolioMember("greedy", config=BeamConfig(patience=1)),
        PortfolioMember("beam", config=BeamConfig(width=2, patience=1))),
        max_workers=1)
    req = request(backend="portfolio", search_config=cfg)
    first = Session(T_MLP, mlp_args(), plan_store=store)
    p1 = first.partition(req)
    assert not p1.cached and p1.evaluations > 0
    pf = p1.eval_stats["portfolio"]
    assert pf["winner"] == "greedy#0" and not pf["early_stopped"]
    assert [m["status"] for m in pf["members"]] == ["done", "done"]
    assert (store.stats.hits, store.stats.misses, store.stats.puts) == \
        (0, 1, 1)
    second = Session(T_MLP, mlp_args(), plan_store=str(tmp_path))
    assert second.fingerprint == first.fingerprint
    mine = PlanStore(tmp_path)
    p2 = second.partition(req, plan_store=mine)
    assert p2.cached and p2.search_seconds == 0.0
    assert second._cost_models == {}          # nothing was evaluated
    assert (mine.stats.hits, mine.stats.misses, mine.stats.puts) == (1, 0, 0)
    assert without_provenance(p2) == without_provenance(p1)
    # the session's own store (a path) hits too; any backend reuses it
    p3 = second.partition(request())
    assert p3.cached and p3.state == p1.state and second._cost_models == {}


def test_auto_partition_and_session_share_one_entry(sess, tmp_path):
    old = auto_partition(T_MLP, mlp_args(), MESH, hw=HardwareSpec(**HW),
                         backend="greedy", min_dims=1,
                         artifacts=sess.artifacts, plan_store=str(tmp_path))
    assert not old.cached and old.fingerprint == sess.fingerprint
    new = sess.partition(request(), plan_store=str(tmp_path))
    assert new.cached and new.state == old.state


def test_constraints_are_checked_again_on_a_hit(sess, mlp_plan, tmp_path):
    sharded = next(p for p, s in zip(mlp_plan.input_paths, mlp_plan.in_specs)
                   if any(e is not None for e in s))
    req = request(constraints=(Replicate(sharded),))
    store = PlanStore(tmp_path)
    # a plan that violates the request, planted under the request's key
    store.put(mlp_plan, req.hw, req.store_params())
    with pytest.raises(ConstraintError):
        sess.partition(req, plan_store=store)
    assert store.stats.hits == 1
    # a plan that satisfies it comes back
    store.clear()
    good = sess.partition(req, plan_store=store)
    assert not good.cached and good.check(req.constraints)
    again = sess.partition(req, plan_store=store)
    assert again.cached and again.state == good.state


def test_a_changed_request_misses(sess, tmp_path):
    store = PlanStore(tmp_path)
    base = request()
    assert not sess.partition(base, plan_store=store).cached
    changed = [
        dataclasses.replace(base, min_dims=2),
        dataclasses.replace(base, constraints=(Pin("[0][0]", ("data", None)),)),
        dataclasses.replace(base, constraints=(Replicate("[0][1]"),)),
        dataclasses.replace(base, mesh=MeshSpec(AXES, (4, 1))),
        dataclasses.replace(base, mesh=MeshSpec(AXES, (2, 2), ("data",))),
        dataclasses.replace(base, hw=HardwareSpec(**dict(HW,
                                                         hbm_per_chip=8e9))),
    ]
    for req in changed:
        assert not sess.partition(req, plan_store=store).cached, req
    assert len(store) == 1 + len(changed)
    for req in [base] + changed:
        assert sess.partition(req, plan_store=store).cached, req
    # the backend is not part of the key
    assert sess.partition(dataclasses.replace(base, backend="beam"),
                          plan_store=store).cached


def test_corrupt_entry_is_a_miss(mlp_plan, tmp_path):
    store = PlanStore(tmp_path)
    params = {"min_dims": 1, "logical_axes": None}
    store.put(mlp_plan, HardwareSpec(**HW), params)
    key = plan_key_v2(mlp_plan.fingerprint, MESH, HardwareSpec(**HW), params)
    assert store.get(mlp_plan.fingerprint, MESH, HardwareSpec(**HW),
                     params) is not None
    (tmp_path / f"{key}.json").write_text("{not json")
    assert store.get(mlp_plan.fingerprint, MESH, HardwareSpec(**HW),
                     params) is None
    (tmp_path / f"{key}.json").write_text('{"plan": {"mesh": null}}')
    assert store.get(mlp_plan.fingerprint, MESH, HardwareSpec(**HW),
                     params) is None
    assert (store.stats.hits, store.stats.misses) == (1, 2)


def test_store_round_trip_keeps_the_plan_and_its_mesh(mlp_plan, tmp_path):
    store = PlanStore(tmp_path)
    plan = ShardingPlan.from_json(mlp_plan.to_json())
    assert plan.as_dict() == mlp_plan.as_dict()
    plan.fingerprint = "c" * 64
    plan.mesh = MeshSpec(("pod", "data", "model"), (2, 2, 1), ("pod",))
    store.put(plan)
    got = store.get("c" * 64, plan.mesh)
    assert got.cached and got.mesh.dcn_axes == ("pod",)
    assert without_provenance(got) == without_provenance(plan)
    # the same shape without the DCN axis is another mesh
    assert store.get("c" * 64, MeshSpec(plan.mesh.axes, plan.mesh.sizes)) \
        is None
    # a plan without a fingerprint is not stored
    plan.fingerprint = ""
    assert store.put(plan) is None and len(store) == 1


def test_v1_entries_remain_readable(mlp_plan, tmp_path):
    params = {"min_dims": 1,
              "logical_axes": [("batch", "embed"), ("embed", "hidden"),
                               ("hidden", "embed")]}
    key = plan_key("e" * 64, MESH, HardwareSpec(), params)
    (tmp_path / f"{key}.json").write_text(json.dumps({
        "fingerprint": "e" * 64, "mesh": MESH.as_dict(),
        "params": {k: repr(v) for k, v in params.items()},
        "hardware": dataclasses.asdict(HardwareSpec()),
        "plan": mlp_plan.as_dict()}))
    store = PlanStore(tmp_path)
    got = store.get("e" * 64, MESH, params=params)
    assert got is not None and got.cached and got.state == mlp_plan.state
    with_cons = dict(params, constraints=(Replicate("['x']"),))
    assert store.get("e" * 64, MESH, params=with_cons) is None


# -- temp files and concurrent writers ------------------------------------------


def test_stale_tmps_are_swept_on_open(tmp_path):
    (tmp_path / "hardware").mkdir()
    stale = [tmp_path / "put-999-abc.tmp", tmp_path / "hardware/put-7-y.tmp"]
    for p in stale:
        p.write_text("{truncated")
        os.utime(p, (1_000_000.0, 1_000_000.0))
    fresh = tmp_path / "put-998-def.tmp"
    fresh.write_text("{live writer}")
    store = PlanStore(tmp_path)
    assert not any(p.exists() for p in stale) and fresh.exists()
    assert store._cleanup_stale_tmps() == 0
    PlanStore(tmp_path, stale_tmp_seconds=0)
    assert not fresh.exists()


def test_a_failed_put_leaves_no_tmp(mlp_plan, tmp_path, monkeypatch):
    store = PlanStore(tmp_path)

    def boom(*a, **k):
        raise RuntimeError("disk full")

    monkeypatch.setattr(json, "dump", boom)
    with pytest.raises(RuntimeError):
        store.put(mlp_plan)
    with pytest.raises(RuntimeError):
        store.save_hardware(HardwareSpec())
    assert list(tmp_path.rglob("*.tmp")) == [] and len(store) == 0


def test_two_concurrent_writers_commit_valid_entries(mlp_plan, tmp_path):
    params = {"min_dims": 1}
    errors = []

    def writer():
        store = PlanStore(tmp_path)
        try:
            for _ in range(25):
                store.put(mlp_plan, params=params)
        except Exception as e:                  # noqa: BLE001
            errors.append(e)

    def reader():
        store = PlanStore(tmp_path)
        try:
            for _ in range(50):
                got = store.get(mlp_plan.fingerprint, MESH, params=params)
                if got is not None:
                    assert got.state == mlp_plan.state
        except Exception as e:                  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=writer) for _ in range(2)]
    threads.append(threading.Thread(target=reader))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert list(tmp_path.glob("*.tmp")) == []
    (entry,) = tmp_path.glob("*.json")
    json.loads(entry.read_text())
    assert PlanStore(tmp_path).get(mlp_plan.fingerprint, MESH,
                                   params=params) is not None


# -- calibrated hardware ----------------------------------------------------------


def test_hardware_round_trips_beside_the_plans(mlp_plan, tmp_path):
    store = PlanStore(tmp_path)
    assert store.load_hardware() is None and store.load_hardware("x") is None
    hw = HardwareSpec(flops_per_chip=5e14, hbm_bw=2e12, coll_latency=4e-6,
                      axis_bw=(("data", 1e11), ("model", 2e11)),
                      kernel_rates=(("flash_attention:cuda", 3e14),))
    store.save_hardware(hw)
    store.save_hardware(HardwareSpec(coll_latency=2e-6), "other")
    assert PlanStore(tmp_path).load_hardware() == hw
    assert store.load_hardware("other") == HardwareSpec(coll_latency=2e-6)
    assert len(store) == 0                      # plans only
    store.put(mlp_plan)
    assert len(store) == 1 and store.clear() == 1 and len(store) == 0
    assert store.load_hardware() == hw          # clear() spares hardware
    store._hw_path("calibrated").write_text("{not json")
    assert store.load_hardware() is None


# -- the fingerprint across processes -------------------------------------------


FINGERPRINT_SCRIPT = r"""
import dataclasses, torch
from repro_torch.configs import get_config
from repro_torch.core.ir import extract_program, program_fingerprint
from repro_torch.models import transformer as T
from repro_torch.train.steps import make_prefill_step
cfg = dataclasses.replace(get_config("qwen2_05b").reduced(), use_pallas=True)
tokens = torch.empty((2, 64), dtype=torch.int32, device="meta")
prog = extract_program(make_prefill_step(cfg), T.param_specs(cfg),
                       {"tokens": tokens})
print("FP", program_fingerprint(prog), len(prog.ops))
"""


def test_prefill_fingerprint_is_the_same_in_two_processes():
    procs = []
    for seed in ("0", "12345"):
        env = dict(os.environ, PYTHONHASHSEED=seed)
        env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + \
            env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", FINGERPRINT_SCRIPT], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        outs.append([x for x in out.splitlines() if x.startswith("FP ")][-1])
    fp, n_ops = outs[0].split()[1:]
    assert outs[0] == outs[1] and len(fp) == 64 and int(n_ops) > 50
