"""The gradients of the MoE ops on DTensors (CPU, gloo ranks), against
their plain versions in one process.

Each op of ``models/sharding.py`` that the MoE block runs per shard
under ``local_map`` (``top_k``, ``take_along_axis``, ``lookup``,
``scatter_add``, ``einsum``) and the non-expert weights' products
(``matmul``, after ``gather_for``) takes f32 inputs from a numpy seed,
placed on a (1, 2) mesh of two ranks or a 2x2 mesh of four, and a
cotangent for each float output: once replicated, once as a pending
sum split at random over the ranks (what a later product hands back).
``torch.autograd.grad`` of the op on the DTensors must equal the plain
op's on the whole tensors, exactly or within 1e-6:

- ``top_k`` on inputs full of ties, sharded on a leading dim and on the
  last (made whole): the cotangent goes where the lower index won the
  tie; the integer indices take none;
- the dispatch gather with the index sharded on the experts, on the
  batch and on the gathered axis, the tokens broadcast over the experts
  (their gradient a sum over the experts) and sharded on the batch or on
  the features;
- the global dispatch's lookup with its ids sharded and the table's
  features sharded;
- the combine with the updates sharded on their expert rows, so each
  rank adds its own rows and the result is a pending sum: ``base``
  counts on one rank, so its gradient is the cotangent once (not twice,
  not zero); and with the batch sharded;
- the expert products with the stacks sharded on ``e`` and on ``f``
  (the second product contracts ``f``: a pending sum), on 2x2 with the
  expert dim strided over ``("model", "data")`` on the weights, or on
  the tokens alone: each stack's gradient comes back in the stack's own
  placement, never gathered whole;
- the dispatched tokens moved from their features onto the experts on
  every mesh dim (``sharding.moved``): on 2x2 one all-to-all over the
  mesh flattened;
- the token lookup with the tokens' sequence and the table's features
  sharded on the same mesh dims: the result keeps the features' shard;
- the non-expert weights' products with the weight sharded on its rows
  against a batch-sharded activation (``gather_for`` gathers it first:
  its gradient reduces back onto the shards) and kept where it lies
  against a replicated one.

A train step handed DTensor state on two ranks (``make_train_step``, no
plan) equals the plain step, and with remat each rank's recomputation
of a layer body selects the experts and tokens its forward selected.
This file imports no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.launch import mesh as M

OP_TOL = 1e-6
TOL = 1e-4
RANKS_TIMEOUT = 240.0
AXES = ("data", "model")
B, S, E, C, d, f = 4, 16, 4, 8, 16, 12


def normal(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def ties(shape, seed):
    """f32 values from {0, 1, 2}: most of them tie."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 3, shape).astype(np.float32))


def ints(high, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, high, shape)).to(torch.int64)


def placed(x, mesh, spec):
    return M.distribute(x, M.NamedSharding(mesh, spec))


def pending(x, mesh, seed):
    """``x`` as a pending sum over every mesh dim: each rank holds a
    random part, the parts summing to ``x``."""
    from torch.distributed.tensor import DTensor, Partial
    n = mesh.size()
    parts = [normal(x.shape, seed + r).to(x.device) for r in range(1, n)]
    rank = torch.distributed.get_rank()
    mine = x - sum(parts) if rank == 0 else parts[rank - 1]
    return DTensor.from_local(mine, mesh, [Partial()] * mesh.ndim,
                              run_check=False)


def grad_case(mesh, fn, inputs, specs, wrt, seed):
    """``fn`` on ``inputs`` placed by ``specs`` (``None``: left plain)
    against ``fn`` on the whole tensors: the worst output and gradient
    difference (:func:`diff`) for a replicated cotangent and for a
    pending-sum one, and each gradient's placements beside its
    input's."""
    from torch.distributed.tensor import Replicate

    def leaves(xs):
        return [x.detach().requires_grad_(i in wrt) if x.is_floating_point()
                else x for i, x in enumerate(xs)]

    def floats(out):
        out = out if isinstance(out, tuple) else (out,)
        return [o for o in out if o.is_floating_point()]

    dev = mesh.device_type
    inputs = [x.to(dev) for x in inputs]
    plain = leaves(inputs)
    want = floats(fn(*plain))
    cots = [normal(w.shape, seed + 10 * j).to(dev)
            for j, w in enumerate(want)]
    wgrads = torch.autograd.grad(want, [plain[i] for i in wrt], cots)
    res = {"grad_placements": [], "input_placements": []}
    for kind in ("replicated", "pending"):
        xs = leaves([x if s is None else placed(x, mesh, s)
                     for x, s in zip(inputs, specs)])
        got = floats(fn(*xs))
        errs = [diff(g.full_tensor(), w) for g, w in zip(got, want)]
        gcots = [placed(c, mesh, ()) if kind == "replicated" else
                 pending(c, mesh, seed + 100 * j)
                 for j, c in enumerate(cots)]
        grads = torch.autograd.grad(got, [xs[i] for i in wrt], gcots)
        for i, g, w in zip(wrt, grads, wgrads):
            errs.append(diff(g.full_tensor() if hasattr(g, "full_tensor")
                             else g, w))
            if kind == "replicated" and hasattr(g, "placements"):
                res["grad_placements"].append(str(tuple(g.placements)))
                res["input_placements"].append(str(tuple(
                    xs[i].placements)) if hasattr(xs[i], "placements")
                    else str((Replicate(),) * mesh.ndim))
        res[kind] = max(errs)
    return res


def diff(got, want) -> float:
    """max|got - want| relative to max(1, max|want|)."""
    return ((got - want).abs().max() /
            max(1.0, want.abs().max().item())).item()


def op_cases(mesh):
    """The MoE ops' gradient cases on ``mesh``: name -> result."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Shard

    from repro_torch.models import layers as L
    from repro_torch.models import sharding
    two_d = mesh.ndim == 2 and mesh.size(0) > 1
    m = "model"
    experts = (m, "data") if two_d else m
    out = {}
    x = ties((B, 6, S), 0)
    for name, spec in (("top_k lead", (m, None, None)),
                       ("top_k last", (None, None, m))):
        out[name] = grad_case(mesh, lambda t: L.top_k(t, 5), [x], [spec],
                              [0], 1)
    h = normal((B, S, d), 2)[:, None]
    tsel = ints(S, (B, E, C), 3)[..., None]
    for name, a_spec, i_spec in (
            ("gather experts", (), (None, experts, None, None)),
            ("gather batch", (m, None, None, None), (m, None, None, None)),
            ("gather axis", (), (None, None, m, None)),
            ("gather features", (None, None, None, m), (None, m, None,
                                                        None))):
        out[name] = grad_case(
            mesh, lambda a, i: L.take_along_axis(a, i, 2), [h, tsel],
            [a_spec, i_spec], [0], 4)
    table = normal((B * S, d), 5)
    ids = ints(B * S, (E * C,), 6)
    for name, i_spec, t_spec in (("lookup ids", (m,), ()),
                                 ("lookup features", (), (None, m))):
        out[name] = grad_case(
            mesh, lambda i, t: sharding.lookup(F.embedding, i, t),
            [ids, table], [i_spec, t_spec], [1], 7)
    base = normal((B, S, d), 8)
    idx = ints(S, (B, E * C), 9)
    upd = normal((B, E * C, d), 10)
    for name, spec in (("combine experts", (None, experts)),
                       ("combine batch", (m, None))):
        out[name] = grad_case(
            mesh, lambda b, i, u: L.scatter_add_rows(b, 1, i, u),
            [base, idx, upd], [(), spec, spec + (None,)], [0, 2], 11)
    xe, w = normal((B, E, C, d), 12), normal((E, d, f), 13)
    he, wo = normal((B, E, C, f), 14), normal((E, f, d), 15)
    up, down = "becd,edf->becf", "becf,efd->becd"
    for name, eq, a, b, a_spec, b_spec in (
            ("einsum e", up, xe, w, (None, experts, None, None),
             (experts, None, None)),
            ("einsum e tokens only", up, xe, w,
             (None, experts, None, None), ()),
            ("einsum f", up, xe, w, (), (None, None, m)),
            ("einsum f contracted", down, he, wo, (None, None, None, m),
             (None, m, None))):
        out[name] = grad_case(
            mesh, lambda p, q, eq=eq: L.einsum(eq, p, q), [a, b],
            [a_spec, b_spec], [0, 1], 16)
    # the dispatched tokens moved from their features onto the experts
    # on every mesh dim (one all-to-all over the flattened mesh)
    onto = [Shard(1)] * mesh.ndim
    out["moved experts"] = grad_case(
        mesh, lambda t: sharding.moved(t, onto) if hasattr(
            t, "device_mesh") else t, [xe],
        [(None, None, None, AXES if two_d else m)], [0], 21)
    xa, wd = normal((B, S, d), 17), normal((d, f), 18)
    out["matmul gathered"] = grad_case(
        mesh, lambda p, q: sharding.matmul(p, sharding.gather_for(q, p)),
        [xa, wd], [(m, None, None), (m, None)], [0, 1], 19)
    out["matmul stationary"] = grad_case(
        mesh, lambda p, q: sharding.matmul(p, q), [xa, wd],
        [(), (m, None)], [0, 1], 20)
    return out


def lookup_case(mesh):
    """The token lookup with the tokens' sequence and the table's
    features sharded on the same mesh dims: the result keeps the
    features' shard (the residual stream runs whole in the sequence, as
    GSPMD partitions such plans), its values and the table's gradient
    equal the plain lookup's; and the one all-to-all of
    ``sharding.moved`` over every mesh dim, counted."""
    from torch.distributed.tensor import Shard

    from repro_torch.models import sharding
    spec = AXES if mesh.size(0) > 1 else "model"
    ids, table = ints(64, (B, S), 22), normal((64, d), 23)
    out = grad_case(mesh, sharding.embedding, [ids, table],
                    [(None, spec), (None, spec)], [1], 24)
    h = sharding.embedding(placed(ids, mesh, (None, spec)),
                           placed(table, mesh, (None, spec)))
    out["placements"] = [(type(p).__name__, getattr(p, "dim", None))
                         for p in h.placements]
    xe = placed(normal((B, E, C, d), 25), mesh, (None, None, None, spec))
    with M.collective_tally() as tally:
        sharding.moved(xe, [Shard(1)] * mesh.ndim)
    out["moved calls"] = dict(tally.calls)
    return out


def train_on_dtensors(mesh, remat):
    """Two steps of reduced f32 mixtral (batch dispatch, capacity 1.0)
    with the state placed by ``MANUAL_RULES`` and the step made by
    ``make_train_step`` (no plan), against the plain steps; with remat,
    each layer's recomputed selections against its forward's."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import (batch_specs, shardings_from_rules,
                                          state_logical_axes)
    from repro_torch.models import layers as L
    from repro_torch.models.sharding import MANUAL_RULES, logical_rules
    from repro_torch.train import steps as TS
    cfg = dataclasses.replace(get_config("mixtral_8x22b").reduced(),
                              moe_capacity_factor=1.0, remat=remat)
    step = TS.make_train_step(cfg)
    state = TS.init_train_state(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32))
        for k in ("tokens", "targets")}
    want, losses = state, []
    for _ in range(2):
        want, m = step(want, batch)
        losses.append(m["loss"].item())
    sh = shardings_from_rules(state, state_logical_axes(cfg, state),
                              MANUAL_RULES, mesh)
    got = pytree.unflatten(state, [M.distribute(x, s) for x, s in zip(
        pytree.tree_leaves(state), pytree.tree_leaves(sh))])
    bsh = shardings_from_rules(*batch_specs(cfg, ShapeConfig(
        "t", 32, 2, "train")), MANUAL_RULES, mesh)
    placed_batch = {k: M.distribute(v, bsh[k]) for k, v in batch.items()}
    calls, inner = [], L.top_k

    def recorded(x, k):
        v, i = inner(x, k)
        calls.append(i.to_local().clone() if hasattr(i, "to_local") else i)
        return v, i
    L.top_k = recorded
    try:
        with logical_rules(MANUAL_RULES):
            for _ in range(2):
                got, m = step(got, placed_batch)
                losses.append(m["loss"].full_tensor().item())
    finally:
        L.top_k = inner
    n = cfg.num_layers
    per_step = 2 * n * (1 + remat)
    moved = 0
    for s in range(2):
        run = calls[s * per_step:(s + 1) * per_step]
        fwd = [run[2 * j:2 * j + 2] for j in range(n)]
        again = [run[2 * n + 2 * j:2 * n + 2 * j + 2]
                 for j in range(n)][::-1] if remat else fwd
        moved += sum(int((a != b).sum()) for fw, ag in zip(fwd, again)
                     for a, b in zip(fw, ag))
    err = max(((a.full_tensor() - b).abs().max() /
               max(1.0, b.abs().max().item())).item()
              for a, b in zip(pytree.tree_leaves(got),
                              pytree.tree_leaves(want)))
    return {"error": err, "losses": losses, "calls": len(calls),
            "moved": moved, "misplaced": [
                p for x, s, p in zip(pytree.tree_leaves(got),
                                     pytree.tree_leaves(sh),
                                     pytree.flatten_with_paths(got)[1])
                if tuple(x.placements) != s.placements(x.ndim)]}


def two_ranks(rank):
    mesh = M.compat_make_mesh((1, 2), AXES, "cpu")
    return {"ops": op_cases(mesh), "lookup": lookup_case(mesh),
            "train": {remat: train_on_dtensors(mesh, remat)
                      for remat in (False, True)}}


def four_ranks(rank):
    mesh = M.compat_make_mesh((2, 2), AXES, "cpu")
    return {"ops": op_cases(mesh), "lookup": lookup_case(mesh),
            "train": {True: train_on_dtensors(mesh, True)}}


@pytest.fixture(scope="module")
def ranks():
    return {2: M.run_ranks(two_ranks, 2, timeout=RANKS_TIMEOUT),
            4: M.run_ranks(four_ranks, 4, timeout=RANKS_TIMEOUT)}


OPS = ["top_k lead", "top_k last", "gather experts", "gather batch",
       "gather axis", "gather features", "lookup ids", "lookup features",
       "combine experts", "combine batch", "einsum e",
       "einsum e tokens only", "einsum f", "einsum f contracted",
       "moved experts", "matmul gathered", "matmul stationary"]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", OPS)
def test_op_gradient_equals_the_plain_ops(ranks, name, n):
    """Outputs and gradients within 1e-6 (relative to the largest) of
    the plain op's, for a replicated cotangent and for a pending-sum
    one."""
    for r in ranks[n]:
        res = r["ops"][name]
        assert max(res["replicated"], res["pending"]) <= OP_TOL, (
            name, n, res)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["top_k lead", "top_k last",
                                  "gather batch"])
def test_tie_and_gather_gradients_are_exact(ranks, name, n):
    """``top_k``'s values' cotangent goes back to the tied entries the
    forward picked, and a batch-sharded gather's to the rows it read,
    each rank summing its rows as one process does: exact.  (Where the
    index is sharded on the experts or the gathered axis, the tokens'
    gradient is summed over ranks: within 1e-6.)"""
    for r in ranks[n]:
        assert r["ops"][name]["replicated"] == 0.0, (name, r["ops"][name])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["einsum e", "einsum f",
                                  "einsum f contracted",
                                  "matmul stationary", "matmul gathered"])
def test_weight_gradients_come_back_on_their_shards(ranks, name, n):
    """An expert stack's (or a sharded weight's) gradient comes back in
    the weight's own placement: sharded where the weight is, never made
    whole."""
    for r in ranks[n]:
        res = r["ops"][name]
        assert res["grad_placements"][1] == res["input_placements"][1], (
            name, res)


@pytest.mark.parametrize("n", [2, 4])
def test_combine_base_counts_once(ranks, n):
    """The combine's ``base`` adds on one rank of each mesh dim that
    splits the updates' rows; its gradient is the cotangent once."""
    for r in ranks[n]:
        res = r["ops"]["combine experts"]
        assert max(res["replicated"], res["pending"]) <= OP_TOL, res


@pytest.mark.parametrize("n,remat", [(2, False), (2, True), (4, True)])
def test_make_train_step_on_dtensor_state_equals_the_plain_step(
        ranks, n, remat):
    """Two steps of ``make_train_step`` on state placed by
    ``MANUAL_RULES``: every leaf within 1e-4 of the plain steps', placed
    by the rules, the losses equal within 1e-4."""
    for r in ranks[n]:
        res = r["train"][remat]
        assert res["error"] <= TOL, res["error"]
        assert res["misplaced"] == []
        np.testing.assert_allclose(res["losses"][2:], res["losses"][:2],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_remat_recomputes_each_ranks_selections(ranks, n):
    """Per rank and layer, remat's recomputation picks the same router
    experts and capacity tokens on its shards as the forward did: none
    differs."""
    cfg = get_config("mixtral_8x22b").reduced()
    for r in ranks[n]:
        res = r["train"][True]
        assert res["calls"] == 2 * 2 * cfg.num_layers * 2
        assert res["moved"] == 0


@pytest.mark.parametrize("n", [2, 4])
def test_lookup_keeps_the_features_shard_against_a_sharded_sequence(
        ranks, n):
    for r in ranks[n]:
        res = r["lookup"]
        assert res["replicated"] <= OP_TOL and res["pending"] <= OP_TOL, res
        assert res["placements"] == ([("Shard", 2)] * 2 if n == 4 else
                                     [("Replicate", None), ("Shard", 2)]), \
            res["placements"]


def test_moved_takes_one_all_to_all_over_both_mesh_dims(ranks):
    """On 2x2 the move from the features onto the experts on both mesh
    dims is one all-to-all (DTensor alone: an all-gather on one mesh
    dim and an all-to-all on the other)."""
    for r in ranks[4]:
        assert r["lookup"]["moved calls"] == {"shard_dim_alltoall": 1}, \
            r["lookup"]["moved calls"]
