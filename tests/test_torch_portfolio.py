"""The port's portfolio search and mesh co-search against the JAX package.

``core/portfolio.py`` and ``core/mesh_search.py`` are copies of the
reference's, over the port's ``actions``, ``cost_model``, ``evaluator``
and ``search``.  Both packages are fed the same ``Program`` — the
reference tracer's, converted to the port's class (``test_torch_core``)
— with one explicit ``HardwareSpec``: the ``mlp`` micro-program and the
reduced ``qwen2_05b`` prefill program.  Tolerance: none (``==``).

- a portfolio at ``max_workers=1``, with and without early stopping:
  the best state, cost, evaluations, winner, ``early_stopped`` and each
  member's outcome apart from its seconds.  A member that sleeps before
  its search (registered in both packages as ``"slow greedy"``) is the
  one running when early stopping fires, so which members are cancelled
  does not depend on thread timing;
- ``factorizations``, ``enumerate_meshes`` and ``candidate_meshes`` (the
  pruned flags and peak bounds from each package's own cost model);
- ``Session.co_search`` rows (mesh, status, pruned, cost, feasible,
  peak bound), ``best_mesh`` and ``best_multi_pod`` over both sessions
  built on the same artifacts, with and without pruning.
"""

import dataclasses
import time

import pytest

from repro.api import Request as JRequest
from repro.api import Session as JSession
from repro.core import cost_model as j_cost
from repro.core import evaluator as j_eval
from repro.core import mcts as j_mcts
from repro.core import mesh_search as j_mesh
from repro.core import portfolio as j_pf
from repro.core import search as j_search
from repro.core.partitioner import ToastArtifacts as JArtifacts
from repro_torch.api import Request as TRequest
from repro_torch.api import Session as TSession
from repro_torch.core import cost_model as t_cost
from repro_torch.core import evaluator as t_eval
from repro_torch.core import mcts as t_mcts
from repro_torch.core import mesh_search as t_mesh
from repro_torch.core import portfolio as t_pf
from repro_torch.core import search as t_search
from repro_torch.core.partitioner import ToastArtifacts as TArtifacts
from test_torch_core import HW, _Pair, jax_program, prefill_program, state_key

SLOW = "slow greedy"
SLOW_SECONDS = 0.3
PROGRAMS = ["mlp", "prefill"]

PKGS = {
    "jax": dict(pf=j_pf, search=j_search, mcts=j_mcts, ev=j_eval,
                cost=j_cost, mesh=j_mesh),
    "torch": dict(pf=t_pf, search=t_search, mcts=t_mcts, ev=t_eval,
                  cost=t_cost, mesh=t_mesh),
}


def _slow_greedy(search):
    """A greedy backend that sleeps first: the member in flight when the
    early stop fires, whatever the threads' timing."""
    class Slow(search.BeamSearchBackend):
        def search(self, *args, **kwargs):
            time.sleep(SLOW_SECONDS)
            return super().search(*args, **kwargs)
    return lambda: Slow(width=1, name="greedy")


@pytest.fixture(scope="module", autouse=True)
def slow_backend():
    for mods in PKGS.values():
        mods["search"].register_backend(SLOW, _slow_greedy(mods["search"]))
    yield
    for mods in PKGS.values():
        del mods["search"]._REGISTRY[SLOW]


@pytest.fixture(scope="module", params=PROGRAMS)
def pair(request):
    if request.param == "prefill":
        p = _Pair(prefill_program())
    else:
        p = _Pair(jax_program(request.param))
    p.name = request.param
    return p


def members(pkg):
    m = PKGS[pkg]
    Member, Beam, MCTS = (m["pf"].PortfolioMember, m["search"].BeamConfig,
                          m["mcts"].MCTSConfig)
    return (Member("greedy", config=Beam(patience=1)),
            Member("beam", config=Beam(width=2, patience=1)),
            Member(SLOW, seed=5, config=Beam(max_depth=1), label="slow"),
            Member("mcts", seed=0, config=MCTS(seed=0, rounds=2,
                                               trajectories_per_round=8)),
            Member("mcts", seed=1, config=MCTS(seed=1, rounds=2,
                                               trajectories_per_round=8)))


def outcome_key(res):
    return {
        "best": state_key(res.best_state), "cost": res.best_cost,
        "evaluations": res.evaluations, "rounds": res.rounds_run,
        "history": list(res.history), "winner": res.winner,
        "early_stopped": res.early_stopped,
        "members": [{k: v for k, v in m.as_dict().items() if k != "seconds"}
                    for m in res.members]}


@pytest.mark.parametrize("patience", [100, 1])
def test_portfolio_equals_the_references(pair, patience):
    got = {}
    for pkg, cm, actions in (("jax", pair.jcm, pair.ja),
                             ("torch", pair.tcm, pair.ta)):
        m = PKGS[pkg]
        cfg = m["pf"].PortfolioConfig(members=members(pkg), max_workers=1,
                                      patience=patience)
        res = m["pf"].PortfolioBackend().search(
            m["ev"].IncrementalEvaluator(cm), actions, cfg)
        got[pkg] = outcome_key(res)
    assert got["torch"] == got["jax"]
    statuses = [o["status"] for o in got["torch"]["members"]]
    if patience == 1:
        # greedy and beam tie: the plateau cancels the queued MCTS members
        assert got["torch"]["early_stopped"]
        assert statuses == ["done"] * 3 + ["cancelled"] * 2
    else:
        assert not got["torch"]["early_stopped"]
        assert statuses == ["done"] * 5


def test_portfolio_backend_is_registered():
    assert isinstance(t_search.get_backend("portfolio"), t_pf.PortfolioBackend)
    with pytest.raises(TypeError, match="PortfolioConfig"):
        t_pf.PortfolioBackend().search(None, [], t_search.BeamConfig())
    assert [dataclasses.astuple(m) for m in t_pf.default_portfolio((0, 1))] \
        == [dataclasses.astuple(m) for m in j_pf.default_portfolio((0, 1))]


def test_guidance_reaches_unguided_mcts_members_only():
    marker = object()
    mine = t_mcts.MCTSConfig(seed=3, guidance="own")
    mcts = t_search.get_backend("mcts")
    got = t_pf._member_config(t_pf.PortfolioMember("mcts", seed=2), mcts,
                              marker)
    assert (got.seed, got.guidance) == (2, marker)
    got = t_pf._member_config(t_pf.PortfolioMember("mcts", config=mine),
                              mcts, marker)
    assert got is mine
    assert t_pf._member_config(t_pf.PortfolioMember("greedy"),
                               t_search.get_backend("greedy"), marker) is None


# -- mesh enumeration ---------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 8, 12, 16, 64])
def test_factorizations_and_meshes_equal_the_references(n):
    for k in (1, 2, 3):
        assert t_mesh.factorizations(n, k) == j_mesh.factorizations(n, k)
    for pods in ((1,), (1, 2), (1, 2, 4), (3,)):
        for k in (1, 2, 3):
            want = [m.as_dict() for m in j_mesh.enumerate_meshes(
                n, pods=pods, max_ici_axes=k)]
            got = [m.as_dict() for m in t_mesh.enumerate_meshes(
                n, pods=pods, max_ici_axes=k)]
            assert got == want


def candidates_key(cands):
    return [(c.mesh.as_dict(), c.mesh_str, c.peak_lower_bound, c.pruned)
            for c in cands]


def test_candidate_meshes_equal_the_references(pair):
    dims = sorted({d for t in pair.jprog.types.values() for d in t.shape})
    tdims = sorted({d for t in pair.tprog.types.values() for d in t.shape})
    assert tdims == dims
    base = pair.tcm._base_peak
    assert base == pair.jcm._base_peak
    for n in (8, 12):
        for budget in (None, 1.0, base / 3, base / 8):
            kw = dict(pods=(1, 2), dim_sizes=dims, base_peak=base,
                      memory_budget=budget)
            assert candidates_key(t_mesh.candidate_meshes(n, **kw)) == \
                candidates_key(j_mesh.candidate_meshes(n, **kw))
    assert candidates_key(t_mesh.candidate_meshes(8)) == \
        candidates_key(j_mesh.candidate_meshes(8))


# -- co-search ----------------------------------------------------------------


def sessions(pair):
    js = JSession(None, artifacts=JArtifacts(pair.jprog, pair.jn, pair.jc))
    ts = TSession(None, artifacts=TArtifacts(pair.tprog, pair.tn, pair.tc))
    return js, ts


def row_key(row):
    return {k: row.get(k) for k in (
        "mesh", "mesh_str", "devices", "multi_pod", "peak_lower_bound_gb",
        "pruned", "status", "cost", "feasible", "runtime_est", "peak_gb",
        "cached", "backend")}


def co_search_key(res):
    mp = res.best_multi_pod()
    return {"rows": [row_key(r) for r in res.rows],
            "best_mesh": None if res.best_mesh is None
            else res.best_mesh.as_dict(),
            "best_state": None if res.best_plan is None
            else state_key(res.best_plan.state),
            "best_multi_pod": None if mp is None
            else (mp[0].as_dict(), state_key(mp[1].state), mp[1].cost),
            "devices": res.devices,
            "candidates": candidates_key(res.candidates)}


@pytest.mark.parametrize("budget", ["free", "pruning"])
def test_co_search_equals_the_references(pair, budget):
    js, ts = sessions(pair)
    # 12 devices: the meshes with a 3-way axis shard less of these
    # programs, so a third of the unsharded peak prunes some of them
    n, hbm = 8, HW["hbm_per_chip"]
    if budget == "pruning":
        n, hbm = 12, pair.jcm._base_peak / 3
    # the prefill program's greedy descent cut at 6 levels keeps it short
    backend, depth = ("greedy", 6) if pair.name == "prefill" else ("beam", 30)
    got = {}
    for pkg, sess, Request in (("jax", js, JRequest), ("torch", ts, TRequest)):
        m = PKGS[pkg]
        hw = m["cost"].HardwareSpec(**dict(HW, hbm_per_chip=hbm))
        template = Request(mesh=m["cost"].MeshSpec(("data", "model"), (1, 1)),
                           hw=hw, backend=backend,
                           search_config=m["search"].BeamConfig(
                               width=4, max_depth=depth, patience=1),
                           min_dims=1)
        got[pkg] = co_search_key(sess.co_search(template, n, pods=(1, 2)))
    assert got["torch"] == got["jax"]
    rows = got["torch"]["rows"]
    statuses = {r["status"] for r in rows}
    assert statuses == ({"ok", "pruned"} if budget == "pruning" else {"ok"})
    assert got["torch"]["best_multi_pod"] is not None
    # every candidate's cost model is a with_mesh clone of one base
    assert len(ts._hw_base_models) == 1


def test_co_search_without_a_divisible_pod_count_raises(pair):
    _, ts = sessions(pair)
    template = TRequest(mesh=t_cost.MeshSpec(("data", "model"), (1, 1)),
                        hw=t_cost.HardwareSpec(**HW), backend="greedy")
    with pytest.raises(ValueError, match="no candidate meshes"):
        ts.co_search(template, 8, pods=(3,))
