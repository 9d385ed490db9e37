"""The port's hybrid train programs and their plans against the JAX
package's.

Both packages trace the ``recurrentgemma_2b`` train step
(``launch.specs``'s train cell: the default ``AdamConfig``, one
microbatch) with ``use_pallas=False`` at three sizes, and search a 2x2
mesh greedily under one explicit ``HardwareSpec``:

- reduced: 3 layers, one period of (rglru, rglru, local) and no tail,
  B 4 x S 16, no remat;
- 8 layers: two periods and a tail of two RG-LRU blocks, B 4 x S 16,
  no remat;
- full: 26 layers (8 periods and the tail), full width, B 1 x S 4096,
  remat (the config's default).

*Programs.*  The period's body appears once in a forward scan and once
in a backward scan, with trip count ``n_scan_blocks``, never unrolled;
the tail's blocks run forward and backward at the top level, not
recomputed.  Both programs hold the same number of ``dot_general``,
``pad``, ``slice``, ``concatenate``, ``add_any``, ``tanh`` (and more)
ops at each trip count.

*Plans.*  Identical ``in_specs`` and ``out_specs``, conflicts, compat
sets, resolution bits and communication bytes; costs within 2%.

*By design, not copied* (pinned below): the reference's loss head keeps
dead ops its trace never removed (``jnp.take_along_axis``'s index
fix-up, ``logsumexp``'s ``max(-inf, ·)`` and its tie weights, the
unused ``sign``), its softmax the ``max(-inf, ·)`` before its
``stop_gradient``, and its schedule two integer ``max`` ops; the port's
iotas are int64.  So the two count a few colors apart, with the same
conflicts and costs within a fraction of a percent.

*Fused sites.*  With ``use_pallas`` every RG-LRU block is one
``kernel:rg_lru`` op forward (in the forward body and in the tail) and
one ``kernel:rg_lru_bwd`` back, with the registry's roles; under remat
the backward body recomputes its forward sites.  The reference's jax
0.9 trace records no fused sites (ROADMAP queue 3), so these are held to
the registry contracts.
"""

import collections
import dataclasses

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
from repro_torch.core.partitioner import flatten_logical_axes
from repro_torch.kernels import registry
from repro_torch.launch import specs
from repro_torch.models import transformer as T
from repro_torch.train import steps as S

ARCH = "recurrentgemma_2b"
COST_REL_TOL = 0.02
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
AXES = ("data", "model")
# size -> (layers, B, S); full width and depth keep the config's own
SIZES = {"reduced": (3, 4, 16), "8-layers": (8, 4, 16), "full": (None, 1, 4096)}
# ops whose count per trip must be the reference's
COUNTED = ("dot_general", "pad", "slice", "concatenate", "add_any", "tanh",
           "split", "transpose", "logistic", "log1p", "exp", "rsqrt")


def configs(size, use_pallas=False):
    layers = SIZES[size][0]
    jc, tc = jax_config(ARCH), get_config(ARCH)
    if layers is not None:
        jc = dataclasses.replace(jc.reduced(), num_layers=layers)
        tc = dataclasses.replace(tc.reduced(), num_layers=layers)
    return jc, dataclasses.replace(tc, use_pallas=use_pallas)


def cells(size, use_pallas=False):
    jc, tc = configs(size, use_pallas)
    _, B, L = SIZES[size]
    return (jspecs.step_and_inputs(jc, JShapeConfig("t", L, B, "train")),
            specs.step_and_inputs(tc, ShapeConfig("t", L, B, "train")))


@pytest.fixture(scope="module", params=sorted(SIZES))
def plans(request):
    (jfn, jargs, _), (tfn, targs, _) = cells(request.param)
    js, ts = JSession(jfn, jargs), Session(tfn, targs)
    jp = js.partition(JRequest(mesh=JMeshSpec(AXES, (2, 2)),
                               hw=JHardwareSpec(**HW), backend="greedy"))
    tp = ts.partition(Request(mesh=MeshSpec(AXES, (2, 2)),
                              hw=HardwareSpec(**HW), backend="greedy"))
    return request.param, js, ts, jp, tp


def by_trip(prog):
    """prim -> trip count -> number of ops."""
    out: dict = collections.defaultdict(collections.Counter)
    for i, op in enumerate(prog.ops):
        out[op.prim][prog.trip_counts[i]] += 1
    return out


def body_runs(prog, trip):
    """The maximal runs of consecutive ops with trip count ``trip``."""
    runs, start = [], None
    for i in range(len(prog.ops) + 1):
        inside = i < len(prog.ops) and prog.trip_counts[i] == trip
        if inside and start is None:
            start = i
        elif not inside and start is not None:
            runs.append((start, i))
            start = None
    return runs


class TestPrograms:
    def test_one_forward_and_one_backward_body(self, plans):
        size, _, ts, _, _ = plans
        cfg = configs(size)[1]
        prog = ts.artifacts.prog
        n = T.n_scan_blocks(cfg)
        assert set(prog.trip_counts.values()) == ({1, n} if n > 1 else {1})
        if n == 1:
            return
        # forward body, then backward body; nothing unrolled
        runs = body_runs(prog, n)
        assert len(runs) == 2
        fwd, bwd = (prog.ops[a:b] for a, b in runs)
        n_dots = lambda ops: sum(o.prim == "dot_general" for o in ops)
        # per period: 2 RG-LRU blocks of 6 products (wx, wy, wo, and the
        # MLP's 3) and the local attention's 9 (q, k, v, scores, PV, wo,
        # and the MLP's 3); two per product back, plus the recomputed
        # ones the transpose reads under remat
        assert n_dots(fwd) == 21
        assert n_dots(bwd) == 42 + (20 if cfg.remat else 0)
        assert cfg.remat == (size == "full")

    def test_the_tail_runs_at_the_top_level(self, plans):
        size, _, ts, _, _ = plans
        cfg = configs(size)[1]
        _, tail = T.block_kinds(cfg)
        tanh = by_trip(ts.artifacts.prog)["tanh"]
        # each RG-LRU block's gelu holds one tanh forward, recomputed
        # nowhere at the top level; the period's run once per body
        assert tanh[1] == len(tail) + (2 if T.n_scan_blocks(cfg) == 1
                                       else 0)

    def test_prim_counts_per_trip_match_the_reference(self, plans):
        _, js, ts, _, _ = plans
        jt, tt = by_trip(js.artifacts.prog), by_trip(ts.artifacts.prog)
        for prim in COUNTED:
            assert tt[prim] == jt[prim], prim

    def test_inputs_and_outputs(self, plans):
        _, js, ts, _, _ = plans
        jprog, tprog = js.artifacts.prog, ts.artifacts.prog
        assert tprog.input_paths == jprog.input_paths
        assert [tprog.types[v].shape for v in tprog.inputs] == \
            [tuple(jprog.types[v].shape) for v in jprog.inputs]
        assert [tprog.types[v].shape for v in tprog.outputs] == \
            [tuple(jprog.types[v].shape) for v in jprog.outputs]

    def test_no_dead_body_values(self, plans):
        # a scan body's dead forward ops leave the program with their
        # values, as the reference's partial evaluation drops them
        _, _, ts, _, _ = plans
        prog = ts.artifacts.prog
        produced = {r for op in prog.ops for r in op.results}
        read = {v for op in prog.ops for v in op.operands}
        linked = {v for link in prog.value_links for v in link[:2]}
        orphans = [v for v, t in prog.types.items() if t.shape and
                   v not in produced | read | linked | set(prog.inputs)]
        assert orphans == []


class TestPlanParity:
    def test_identical_in_and_out_specs(self, plans):
        _, _, _, jp, tp = plans
        assert tp.input_paths == jp.input_paths
        assert [tuple(s) for s in tp.in_specs] == \
            [tuple(s) for s in jp.in_specs]
        assert [tuple(s) for s in tp.out_specs] == \
            [tuple(s) for s in jp.out_specs]

    def test_identical_analysis_counts(self, plans):
        _, _, _, jp, tp = plans
        assert tp.num_conflicts == jp.num_conflicts
        assert tp.num_compat_sets == jp.num_compat_sets
        assert tp.num_resolution_bits == jp.num_resolution_bits

    def test_cost_within_tolerance(self, plans):
        _, _, _, jp, tp = plans
        assert abs(tp.cost - jp.cost) <= COST_REL_TOL * jp.cost
        assert tp.breakdown["comm_bytes"] == jp.breakdown["comm_bytes"]
        for key in ("flops", "peak_bytes"):
            assert abs(tp.breakdown[key] - jp.breakdown[key]) <= \
                COST_REL_TOL * jp.breakdown[key]

    def test_by_design_the_colors_differ_by_a_few(self, plans):
        # the reference's dead loss-head and softmax ops (module
        # docstring): a few colors apart, never a conflict apart
        _, _, _, jp, tp = plans
        assert tp.num_colors != jp.num_colors
        assert abs(tp.num_colors - jp.num_colors) <= 5


@pytest.mark.parametrize("size", ["reduced", "full"])
def test_train_cell_inputs_and_names(size):
    # every leaf of the hybrid's train state (the RG-LRU ones: rnn, conv,
    # lam and the gates) carries the reference's logical names
    (_, jargs, jnames), (_, targs, tnames) = cells(size)
    import jax
    jflat, _ = jax.tree_util.tree_flatten_with_path(jargs)
    tleaves, tpaths = pytree.flatten_with_paths(targs)
    assert tpaths == [jax.tree_util.keystr(p) for p, _ in jflat]
    assert [(tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for x in tleaves] == [(tuple(x.shape), str(x.dtype))
                                  for _, x in jflat]
    assert flatten_logical_axes(tnames) == flatten_logical_axes(jnames)
    names = dict(zip(tpaths, flatten_logical_axes(tnames)))
    assert names["[0].params['layers'][0]['mix']['lam']"] == (None, "rnn")
    assert names["[0].opt.m['layers'][0]['mix']['conv_w']"] == \
        (None, None, "rnn")


# -- fused sites ------------------------------------------------------------


@pytest.fixture(scope="module", params=["reduced", "8-layers-remat"])
def fused(request):
    size = request.param.removesuffix("-remat")
    jc, tc = configs(size, use_pallas=True)
    tc = dataclasses.replace(tc, remat=request.param.endswith("-remat"))
    _, B, L = SIZES[size]
    fn, args, _ = specs.step_and_inputs(tc, ShapeConfig("t", L, B, "train"))
    return tc, fn, args, Session(fn, args)


def test_fused_sites_follow_the_registry(fused):
    cfg, _, _, sess = fused
    prog, nda = sess.artifacts.prog, sess.artifacts.nda
    n = T.n_scan_blocks(cfg)
    kops = [(i, op) for i, op in enumerate(prog.ops)
            if op.prim.startswith("kernel:")]
    fwd, bwd = "kernel:rg_lru", "kernel:rg_lru_bwd"
    tail = 2 if n > 1 else 0
    # the forward body's two sites, the tail's forward sites and their
    # backward, then the backward body: recomputed sites and backwards
    assert [(op.prim, prog.trip_counts[i]) for i, op in kops] == \
        [(fwd, n)] * 2 + [(fwd, 1)] * tail + [(bwd, 1)] * tail + \
        [(fwd, n)] * (2 * cfg.remat) + [(bwd, n)] * 2
    for i, op in kops:
        spec = registry.spec_for_prim(op.prim)
        assert [prog.types[v].rank for v in op.operands] == \
            [len(r) for r in spec.operand_roles]
        assert [prog.types[v].rank for v in op.results] == \
            [len(r) for r in spec.result_roles]
        # one color per role across every operand and result
        colors: dict = {}
        for roles, v in list(zip(spec.operand_roles, op.operands)) + \
                list(zip(spec.result_roles, op.results)):
            for role, c in zip(roles, nda.colors_of_value(v)):
                assert colors.setdefault(role, c) == c
        if op.prim == bwd:
            assert op.params == {"kernel": "rg_lru_bwd"}
    # a backward reads its forward site's (a, b): at the top level the
    # tail's own, in the body the recomputed ones under remat, else
    # their slices of the forward scan's residual stacks
    sites = [op for _, op in kops if op.prim == fwd]
    bwds = [op for _, op in kops if op.prim == bwd]
    for site, back in zip(sites[2:2 + tail], reversed(bwds[:tail])):
        assert back.operands[:2] == site.operands
    body_bwds = bwds[tail:]
    if cfg.remat:
        recomputed = sites[2 + tail:]
        assert {tuple(b.operands[:2]) for b in body_bwds} == \
            {tuple(s.operands) for s in recomputed}
    else:
        stacked = collections.defaultdict(set)
        for a, b, off in prog.value_links:
            if off == 1:
                stacked[a].add(b)
        for back in body_bwds:
            assert any({back.operands[0], s.operands[0]} <= vs
                       for vs in stacked.values() for s in sites[:2])


def test_one_device_plan_runs_the_train_step():
    _, (fn, args, _) = cells("8-layers", use_pallas=True)
    cfg = configs("8-layers", use_pallas=True)[1]
    plan = Session(fn, args).partition(Request(mesh=MeshSpec(AXES, (1, 1))))
    # the period's two sites and the tail's two (no remat here)
    assert [r["site"] for r in plan.kernel_sites] == \
        [f"rg_lru:{i}" for i in range(4)]
    assert {r["impl"] for r in plan.kernel_sites} == {"cuda"}
    state = S.init_train_state(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    _, B, L = SIZES["8-layers"]
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, L), generator=g,
                              dtype=torch.int32)
             for k in ("targets", "tokens")}
    got = plan.apply(fn, device="cpu")(state, batch)
    want = fn(state, batch)
    assert len(pytree.tree_leaves(got)) == len(plan.out_specs)
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("B", [1, 2])
def test_a_size_one_gather_dim_lowers_as_the_references(B):
    # jnp.take_along_axis takes a size-1 dim whole (an offset dim) and
    # drops it from the index; other dims are batching dims
    from jax import ShapeDtypeStruct
    import jax.numpy as jnp
    from repro.core.ir import extract_program as jextract
    from repro.train.steps import cross_entropy as jce
    from repro_torch.core.ir import extract_program
    want = jextract(jce, ShapeDtypeStruct((B, 8, 16), jnp.float32),
                    ShapeDtypeStruct((B, 8), jnp.int32))
    got = extract_program(
        S.cross_entropy, torch.empty((B, 8, 16), device="meta"),
        torch.empty((B, 8), dtype=torch.int32, device="meta"))

    def gathers(prog):
        return [(op.params["dimension_numbers"],
                 [tuple(prog.types[v].shape) for v in op.operands])
                for op in prog.ops if op.prim == "gather"]

    assert gathers(got) == gathers(want)


def test_einsums_lower_in_jnp_einsums_operand_order():
    # the pairwise contraction as jnp.einsum builds it: the second
    # operand first unless the swap makes the product the result's order
    import jax.numpy as jnp
    from jax import ShapeDtypeStruct
    from repro.core.ir import extract_program as jextract
    from repro_torch.core.ir import extract_program
    shapes = {"q": (2, 5, 1, 4, 8), "k": (2, 6, 1, 8), "p": (2, 1, 4, 5, 6)}
    for eq, a, b in [("bskgh,btkh->bkgst", "q", "k"),
                     ("bkgst,btkh->bskgh", "p", "k"),
                     ("ij,jk->ik", (3, 4), (4, 5)),
                     ("ij,kj->ki", (3, 4), (5, 4))]:
        sa = shapes.get(a, a)
        sb = shapes.get(b, b) if not isinstance(b, tuple) else b
        want = jextract(lambda x, y: jnp.einsum(eq, x, y),
                        ShapeDtypeStruct(sa, jnp.float32),
                        ShapeDtypeStruct(sb, jnp.float32))
        got = extract_program(lambda x, y: torch.einsum(eq, x, y),
                              torch.empty(sa, device="meta"),
                              torch.empty(sb, device="meta"))
        assert [(op.prim, op.operands, op.params.get("dimension_numbers"),
                 op.params.get("permutation")) for op in got.ops] == \
            [(op.prim, op.operands, op.params.get("dimension_numbers"),
              op.params.get("permutation")) for op in want.ops], eq
