"""The MoE block and models on meshes of gloo ranks (CPU), against their
plain versions and the unsharded runs.

Reduced f32 ``mixtral_8x22b`` and ``arctic_480b`` (4 experts, top-2,
capacity factor 4.0), ``use_pallas`` set (arctic's attention sites run
through ``kernels.ops``; on CPU tensors the kernels' plain versions):

- The MoE ops on DTensors (``models/sharding.py``) on a (1, 2) mesh of
  two ranks, against the same op on the whole tensors, inputs from a
  numpy seed: ``top_k`` on inputs full of ties, sharded on a leading
  dim and on the last dim (values and indices exact); the dispatch
  gather (exact) and the combine (1e-6) with the index sharded on the
  expert dim and on the batch dim; the expert products with ``f``
  sharded, the second a pending sum (1e-6).  On a 2x2 mesh of four
  ranks, the products with the expert dim on ``("model", "data")``, a
  strided shard, on the weights or on the tokens alone (a replicated
  weight is sliced): kept where it lies, no collective.
- Prefill through ``plan.apply`` (B 4 x S 64): both models' batch
  dispatch on the plan the port's ``Session`` searches for a (1, 2)
  mesh with the default ``Request`` (as ``chip_smoke.py`` searches its
  full-width ones) and on the greedy 2x2 plan; mixtral's global and
  local dispatch on the greedy 2x2 plan.  Logits within 1e-4 of the
  unsharded run, placed as ``out_specs``; the top-k, gathers and
  combines ran per shard, and no expert stack was all-gathered.  No op
  was handed a strided shard without the plain shard that gives it its
  blocks (torch 2.11 refuses one; 2.13 takes it).
- Decode: each model's decode step on its 2x2 plan from the serving
  launcher's request (``serve.decode_plan``), 8 steps (4 prompt tokens,
  then 4 steps generating 5 tokens) through ``serve_loop``: tokens
  exact, prompt logits within 1e-4 of one process.
- The serving launcher on 2 and 4 ranks, both models, ``--plan toast``
  and ``--plan manual``: tokens equal to one process's.
- The entry points on 2 ranks: ``plan.apply`` and the serving launcher
  run an MoE model, and the training launcher and ``make_train_step``
  train it, within 1e-4 of one process (MoE training on meshes is held
  in full in ``tests/test_torch_moe_mesh_train*.py``).

The reference's plans (JSON from the JAX package) run in
``tests/test_torch_moe_mesh_plans.py``; the collectives against GSPMD's
in ``tests/test_torch_moe_comm.py``.  This file imports no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import Request, Session
from repro_torch.configs import get_config
from repro_torch.core.cost_model import HardwareSpec, MeshSpec
from repro_torch.core.partitioner import ShardingPlan
from repro_torch.launch import mesh as M
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.train.steps import make_decode_step, make_prefill_step

TOL = 1e-4
OP_TOL = 1e-6
RANKS_TIMEOUT = 240.0
AXES = ("data", "model")
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
B, S = 4, 64
ARCHS = ("mixtral_8x22b", "arctic_480b")
# prefill cases per mesh: (model, dispatch mode)
PREFILL = {"1x2": (("mixtral_8x22b", "batch"), ("arctic_480b", "batch")),
           "2x2": (("mixtral_8x22b", "batch"), ("mixtral_8x22b", "global"),
                   ("mixtral_8x22b", "local"), ("arctic_480b", "batch"))}
# the local dispatch's sequence pools
POOLS = 4
# serving: prompts, prompt tokens, generated tokens
SB, SP, SG = 4, 4, 4
# the decode plans' run: 4 prompt steps and 4 generating steps
DECODE_GEN = 5
PLANS = ("toast", "manual")


def config(arch, dispatch="batch"):
    return dataclasses.replace(get_config(arch).reduced(),
                               moe_dispatch=dispatch, moe_local_pools=POOLS,
                               use_pallas=True)


def prefill_plan(arch, dispatch, mesh):
    """The port's plan for the reduced prefill on ``mesh`` ("1x2": the
    default ``Request``; "2x2": greedy under ``HW``)."""
    cfg = config(arch, dispatch)
    sess = Session(make_prefill_step(cfg), (T.param_specs(cfg), {
        "tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}))
    shape = tuple(int(n) for n in mesh.split("x"))
    if mesh == "1x2":
        return sess.partition(Request(mesh=MeshSpec(AXES, shape)))
    return sess.partition(Request(mesh=MeshSpec(AXES, shape),
                                  hw=HardwareSpec(**HW), backend="greedy"))


def expert_gathers(shapes, cfg) -> dict:
    """The all-gathers among ``collective_tally`` shapes whose result is
    a whole expert stack (E, d, f) or (E, f, d), stacked or not, joined
    on any dim."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {str(k): n for k, n in shapes.items()
            if k[0].startswith("all_gather") and any(
                len(g) >= 3 and g[-3:] in ((e, d, f), (e, f, d))
                for g in M.gathered_shapes(k[1]))}


def lone_strided(placements, mesh) -> bool:
    """Whether a strided shard in ``placements`` lacks the plain shard of
    its dim on a later mesh dim of its split factor (no block layout:
    torch 2.11 refuses it)."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    return any(isinstance(p, _StridedShard) and not any(
        type(q) is Shard and q.dim == p.dim and
        mesh.size(j) == p.split_factor
        for j, q in enumerate(placements) if j > i)
        for i, p in enumerate(placements))


class LoneStrided:
    """Records the placements with a lone strided shard that the MoE ops
    hand ``local_map`` while the context is open."""

    def __enter__(self):
        from repro_torch.models import sharding
        self.found, self._run = [], sharding._run_local

        def run(fn, mesh, operands, in_pl, out_pl):
            self.found += [str(pl) for pl in (*in_pl, *out_pl)
                           if lone_strided(pl, mesh)]
            return self._run(fn, mesh, operands, in_pl, out_pl)
        sharding._run_local = run
        return self

    def __exit__(self, *exc):
        from repro_torch.models import sharding
        sharding._run_local = self._run


def run_prefill(cases):
    """Apply each (arch, dispatch, plan JSON) and the unsharded step to
    the same seeded inputs."""
    from repro_torch.kernels import ops
    from repro_torch.models import sharding
    out = []
    for arch, dispatch, text in cases:
        cfg = config(arch, dispatch)
        fn = make_prefill_step(cfg)
        params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32))
        want = fn(params, {"tokens": tokens})
        applied = ShardingPlan.from_json(text).apply(fn, device="cpu")
        sharding.per_shard.clear()
        ops.local_calls.clear()
        with M.collective_tally() as tally, LoneStrided() as lone:
            got = applied(params, {"tokens": tokens})
        out.append({
            "lone_strided": lone.found,
            "error": (got.full_tensor() - want).abs().max().item(),
            "scale": want.abs().max().item(),
            "spec": M.spec_for_placements(got.placements, applied.mesh,
                                          got.ndim),
            "per_shard": dict(sharding.per_shard),
            "expert_gathers": expert_gathers(tally.shapes, cfg),
            "local_calls": [k[2] for k in ops.local_calls]})
    return out


def serve_runs():
    """Both models served by the launcher with both plans (this group's
    ranks, or one process): the gathered tokens."""
    out = {}
    for arch in ARCHS:
        for plan in PLANS:
            res = serve.serve(serve.parse_args(serve_argv(arch, plan)))
            tokens = res.tokens
            out[arch, plan] = tokens.full_tensor() if \
                hasattr(tokens, "full_tensor") else tokens
    return out


def serve_argv(arch, plan):
    return ["--arch", arch, "--reduced", "--batch", str(SB), "--prompt-len",
            str(SP), "--gen", str(SG), "--plan", plan, "--device", "cpu"]


def ties(shape, seed):
    """f32 values from {0, 1, 2}: most of them tie."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 3, shape).astype(np.float32))


def normal(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def placed(x, mesh, spec):
    return M.distribute(x.to(mesh.device_type), M.NamedSharding(mesh, spec))


def check_ops(mesh):
    """Each MoE op on DTensors of the (1, 2) mesh (on its device) against
    its plain version on the whole tensors: name -> (max|diff|, equal,
    output placements)."""
    from repro_torch.models import layers as L
    out = {}
    dev = mesh.device_type

    def record(name, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        placements = [str(tuple(g.placements)) for g in got]
        got = [g.full_tensor() for g in got]
        err = max((g.double() - w.double()).abs().max().item()
                  for g, w in zip(got, want))
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        out[name] = (err, exact, placements)

    def to_dev(*xs):
        return [x.to(dev) for x in xs]

    x, = to_dev(ties((4, 6, 16), 0))
    for name, spec in (("top_k lead", ("model", None, None)),
                       ("top_k last", (None, None, "model"))):
        record(name, L.top_k(placed(x, mesh, spec), 5), L.top_k(x, 5))
    E, C, d = 4, 8, 16
    h, tsel = to_dev(normal((B, S, d), 1), torch.from_numpy(
        np.random.default_rng(2).integers(0, S, (B, E, C))).to(torch.int64))
    for name, a_spec, i_spec in (
            ("gather experts", None, (None, "model", None, None)),
            ("gather batch", ("model", None, None, None),
             ("model", None, None, None))):
        arr = h[:, None] if a_spec is None else \
            placed(h[:, None], mesh, a_spec)
        record(name, L.take_along_axis(
            arr, placed(tsel[..., None], mesh, i_spec), 2),
            L.take_along_axis(h[:, None], tsel[..., None], 2))
    upd, = to_dev(normal((B, E * C, d), 3))
    idx = tsel.reshape(B, E * C)
    base = torch.zeros((S, d), device=dev).expand(B, S, d)
    for name, spec in (("combine experts", (None, "model")),
                       ("combine batch", ("model", None))):
        record(name, L.scatter_add_rows(
            base, 1, placed(idx, mesh, spec), placed(upd, mesh, spec + (
                None,))), L.scatter_add_rows(base, 1, idx, upd))
    f = 12
    xe, w, he, wo = to_dev(normal((B, E, C, d), 4), normal((E, d, f), 5),
                           normal((B, E, C, f), 6), normal((E, f, d), 7))
    record("einsum f", L.einsum("becd,edf->becf", placed(xe, mesh, ()),
                                placed(w, mesh, (None, None, "model"))),
           torch.einsum("becd,edf->becf", xe, w))
    record("einsum f contracted", L.einsum(
        "becf,efd->becd", placed(he, mesh, (None, None, None, "model")),
        placed(wo, mesh, (None, "model", None))),
        torch.einsum("becf,efd->becd", he, wo))
    return out


def check_strided(mesh):
    """The expert products on the 2x2 mesh with the expert dim on
    ("model", "data"): (case -> (max|diff|, output spec, collectives))."""
    from repro_torch.models import layers as L
    out = {}
    E, C, d, f = 4, 8, 16, 12
    xe = normal((B, E, C, d), 4)
    w = normal((E, d, f), 5)
    want = torch.einsum("becd,edf->becf", xe, w)
    experts = ("model", "data")
    for name, w_spec in (("weights strided", (experts, None, None)),
                         ("weights replicated", ())):
        x = placed(xe, mesh, (None, experts, None, None))
        wt = placed(w, mesh, w_spec)
        with M.collective_tally() as tally, LoneStrided() as lone:
            got = L.einsum("becd,edf->becf", x, wt)
        out[name] = ((got.full_tensor() - want).abs().max().item(),
                     M.spec_for_placements(got.placements, mesh, got.ndim),
                     dict(tally.calls), lone.found)
    # a layer of a stacked expert leaf (torch 2.11's index of it leaves
    # the strided shard behind: sharding.layer indexes each block)
    from repro_torch.models.sharding import layer
    stack = normal((2, E, d, f), 8)
    one = layer(placed(stack, mesh, (None, experts, None, None)), 1)
    out["layer"] = ((one.full_tensor() - stack[1]).abs().max().item(),
                    M.spec_for_placements(one.placements, mesh, one.ndim),
                    {}, [])
    return out


TRAIN_ARGV = ["--arch", "mixtral_8x22b", "--reduced", "--device", "cpu",
              "--steps", "2", "--batch", "2", "--seq", "16",
              "--log-every", "1"]


def train_runs(ckpt_dir):
    """The training entry points on this group (or one process): the
    launcher's losses, and one ``make_train_step`` step's loss on the
    state placed by ``MANUAL_RULES`` (two ranks) or plain."""
    from repro_torch import pytree
    from repro_torch.launch import train
    from repro_torch.launch.specs import (shardings_from_rules,
                                          state_logical_axes)
    from repro_torch.models.sharding import MANUAL_RULES, logical_rules
    from repro_torch.train.steps import init_train_state, make_train_step
    (run,) = train.supervise(get_config("mixtral_8x22b").reduced(),
                             train.parse_args(TRAIN_ARGV + [
                                 "--ckpt-dir", str(ckpt_dir)]))
    cfg = get_config("mixtral_8x22b").reduced()
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    batch = {"tokens": tokens, "targets": tokens}
    if M.group_size() > 1:
        mesh = M.compat_make_mesh((1, 2), AXES, "cpu")
        sh = shardings_from_rules(state, state_logical_axes(cfg, state),
                                  MANUAL_RULES, mesh)
        state = pytree.unflatten(state, [M.distribute(x, s) for x, s in zip(
            pytree.tree_leaves(state), pytree.tree_leaves(sh))])
        batch = {k: M.distribute(v, M.NamedSharding(mesh, ("data", None)))
                 for k, v in batch.items()}
        with logical_rules(MANUAL_RULES):
            _, metrics = make_train_step(cfg)(state, batch)
        loss = metrics["loss"].full_tensor().item()
    else:
        loss = make_train_step(cfg)(state, batch)[1]["loss"].item()
    return {"launcher": run.losses, "make_train_step": loss}


def two_ranks(rank, prefill, ckpt_dir):
    """On a group of two ranks: the ops, the (1, 2) prefills, the serving
    launcher, and the training entry points."""
    mesh = M.compat_make_mesh((1, 2), AXES, "cpu")
    return {"ops": check_ops(mesh), "prefill": run_prefill(prefill),
            "serve": serve_runs(), "train": train_runs(ckpt_dir)}


def four_ranks(rank, prefill, decode):
    """On a group of four ranks: the strided products, the 2x2 prefills,
    the decode plans and the serving launcher."""
    mesh = M.compat_make_mesh((2, 2), AXES, "cpu")
    out = {"strided": check_strided(mesh), "prefill": run_prefill(prefill),
           "decode": {}, "serve": serve_runs()}
    for arch, text in decode.items():
        cfg = get_config(arch).reduced()
        dec = make_decode_step(cfg)
        params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        prompts = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (SB, SP)).astype(np.int32))
        want = serve.serve_loop(dec, params, T.init_cache(
            cfg, SB, SP + DECODE_GEN, device="cpu"), prompts, DECODE_GEN)
        with LoneStrided() as lone:
            got = serve.serve_loop(
                ShardingPlan.from_json(text).apply(dec, device="cpu"),
                params, T.init_cache(cfg, SB, SP + DECODE_GEN, device="cpu"),
                prompts, DECODE_GEN)
        out["decode"][arch] = {
            "lone_strided": lone.found,
            "tokens": torch.equal(got.tokens.full_tensor(), want.tokens),
            "steps": SP + len(got.step_ms),
            "error": (got.prompt_logits.full_tensor() -
                      want.prompt_logits).abs().max().item(),
            "scale": want.prompt_logits.abs().max().item()}
    return out


@pytest.fixture(scope="module")
def one_process():
    return serve_runs()


@pytest.fixture(scope="module")
def plans():
    return {mesh: {(arch, mode): prefill_plan(arch, mode, mesh)
                   for arch, mode in cases}
            for mesh, cases in PREFILL.items()}


@pytest.fixture(scope="module")
def two(plans, tmp_path_factory):
    cases = [(a, m, p.to_json()) for (a, m), p in plans["1x2"].items()]
    return M.run_ranks(two_ranks, 2, cases,
                       tmp_path_factory.mktemp("moe_mesh_train"),
                       timeout=RANKS_TIMEOUT)


@pytest.fixture(scope="module")
def four(plans):
    cases = [(a, m, p.to_json()) for (a, m), p in plans["2x2"].items()]
    decode = {arch: serve.decode_plan(get_config(arch).reduced(), SB,
                                      SP + DECODE_GEN, 4).to_json()
              for arch in ARCHS}
    return M.run_ranks(four_ranks, 4, cases, decode, timeout=RANKS_TIMEOUT)


@pytest.mark.parametrize("name", ["top_k lead", "top_k last"])
def test_top_k_ties_on_dtensors(two, name):
    """Values and indices exact; a leading dim's shard is kept, the last
    dim made whole."""
    for r in two:
        err, exact, placements = r["ops"][name]
        assert exact, (name, err)
        want = "Shard(dim=0)" if name.endswith("lead") else "Replicate()"
        assert all(p.endswith(f"{want})") for p in placements), placements


@pytest.mark.parametrize("name", ["gather experts", "gather batch"])
def test_dispatch_gather_on_dtensors(two, name):
    """Exact, and sharded as the index is."""
    dim = 1 if name.endswith("experts") else 0
    for r in two:
        err, exact, placements = r["ops"][name]
        assert exact, (name, err)
        assert placements == [f"(Replicate(), Shard(dim={dim}))"]


@pytest.mark.parametrize("name", ["combine experts", "combine batch"])
def test_combine_on_dtensors(two, name):
    """Within 1e-6; updates sharded on their expert rows leave a pending
    sum, on the batch a batch shard."""
    want = "Partial(sum)" if name.endswith("experts") else "Shard(dim=0)"
    for r in two:
        err, _, placements = r["ops"][name]
        assert err <= OP_TOL, (name, err)
        assert placements == [f"(Replicate(), {want})"]


def test_expert_products_with_f_sharded(two):
    """The weights' ``f`` kept where it lies: a shard of the first
    product, a pending sum of the second (``f`` contracted)."""
    for r in two:
        for name, want in (("einsum f", "Shard(dim=3)"),
                           ("einsum f contracted", "Partial(sum)")):
            err, _, placements = r["ops"][name]
            assert err <= OP_TOL, (name, err)
            assert placements == [f"(Replicate(), {want})"], name


def test_strided_experts_kept_where_they_lie(four):
    """A strided expert dim (the decode plans' ("model", "data")) is kept
    on the weights and the tokens, and a replicated weight is sliced to
    it: the product is sharded as the tokens, with no collective.  A
    layer of a stacked leaf so placed keeps the placement, one dim
    down."""
    for r in four:
        for name, (err, spec, calls, lone) in r["strided"].items():
            assert err <= OP_TOL, (name, err)
            assert tuple(spec) == ((("model", "data"), None, None)
                                   if name == "layer" else
                                   (None, ("model", "data"), None, None))
            assert calls == {} and lone == [], (name, calls, lone)


@pytest.mark.parametrize("mesh", sorted(PREFILL))
def test_prefill_equals_unsharded(two, four, plans, mesh):
    runs = two if mesh == "1x2" else four
    for r in runs:
        for (case, plan), res in zip(plans[mesh].items(), r["prefill"]):
            assert res["error"] <= TOL * max(1.0, res["scale"]), \
                (mesh, case, res["error"])
            assert tuple(res["spec"]) == tuple(plan.out_specs[0])
            assert res["lone_strided"] == [], (mesh, case)


@pytest.mark.parametrize("mesh", sorted(PREFILL))
def test_prefill_runs_the_moe_ops_per_shard(two, four, plans, mesh):
    """Every MoE layer's two top-k, its gather and its combine ran per
    shard, and no expert stack was gathered whole: the tokens move to
    the experts."""
    runs = two if mesh == "1x2" else four
    for r in runs:
        for (arch, mode), res in zip(plans[mesh], r["prefill"]):
            layers = config(arch, mode).num_layers
            gather = "lookup" if mode == "global" else "take_along_axis"
            assert res["per_shard"]["top_k"] == 2 * layers
            assert res["per_shard"][gather] == layers
            assert res["per_shard"]["scatter_add"] == layers
            assert res["expert_gathers"] == {}, (mesh, arch, mode)


def test_arctic_attention_sites_on_local_shards(two, four, plans):
    """Arctic's flash-attention sites run on each rank's shard with q's
    heads and k's (repeated to q's) alike; mixtral's windowed attention
    has no site."""
    for mesh, runs in (("1x2", two), ("2x2", four)):
        for r in runs:
            for (arch, _), res in zip(plans[mesh], r["prefill"]):
                if arch == "mixtral_8x22b":
                    assert res["local_calls"] == []
                    continue
                assert res["local_calls"]
                for q, k, v in res["local_calls"]:
                    assert q[2] == k[2] == v[2] and q[3] == 16, (q, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_plan_equals_one_process(four, arch):
    for r in four:
        res = r["decode"][arch]
        assert res["tokens"] and res["steps"] == 8
        assert res["lone_strided"] == []
        assert res["error"] <= TOL * max(1.0, res["scale"]), res["error"]


@pytest.mark.parametrize("ranks", [2, 4])
def test_serving_launcher_equals_one_process(two, four, one_process, ranks):
    runs = two if ranks == 2 else four
    for r in runs:
        assert r["serve"].keys() == one_process.keys()
        for key, tokens in one_process.items():
            assert torch.equal(r["serve"][key], tokens), (ranks, key)


def test_moe_entry_points_serve_and_train_on_two_ranks(two, tmp_path):
    """On two ranks ``plan.apply`` and the serving launcher run an MoE
    model, and so do the training entry points: the training launcher
    takes its 2 steps and ``make_train_step`` a step on the state placed
    by ``MANUAL_RULES``, the losses within 1e-4 of one process's."""
    one = train_runs(tmp_path / "one")
    for r in two:
        assert len(r["prefill"]) == len(PREFILL["1x2"])
        assert len(r["serve"]) == len(ARCHS) * len(PLANS)
        assert len(r["train"]["launcher"]) == 2
        np.testing.assert_allclose(np.array(r["train"]["launcher"]),
                                   np.array(one["launcher"]), rtol=TOL,
                                   atol=TOL)
        assert abs(r["train"]["make_train_step"] -
                   one["make_train_step"]) <= TOL
