"""The port's ``xlstm_350m`` train programs and their plans against the
JAX package's.

Both packages trace the train step (``launch.specs``'s train cell: the
default ``AdamConfig``, one microbatch) on abstract / ``meta`` inputs
and search a 2x2 mesh greedily under one explicit ``HardwareSpec``:

- reduced width, 16 layers (two periods of 7 mLSTM and 1 sLSTM blocks),
  B 2 x S 16, no remat;
- full width and depth (24 layers, three periods), B 4 x S 2048, remat
  on (the config's own).

*Programs.*  The sLSTM's time scan runs inside the layer scan's body, so
its ops run ``n x S`` times: in the forward body (with its residuals
stacked as ``ys``, or without them under remat, where the backward body
recomputes it with them) and in the backward body, whose inner backward
scan carries the gradient of the recurrent weight ``R`` (a constant of
the time scan) across time and reads the stacked ``hs`` cotangents as
its ``xs``.  Every (prim, trip count) pair occurs as often as in the
reference's program but for the named differences below.

*Records.*  The tracer records the layer scan as a top-level
``ScanRecord`` and the time scan as its child: its trip count ``n``, its
length ``S``, the recurrent weight among its constants, its ``ys`` the
carry's ``h``.

*Plans.*  Identical input paths, ``in_specs``, ``out_specs``, logical
rules, conflicts, compat sets, resolution bits and communication bytes;
the cost, FLOPs and peak bytes within 2%; colors a few apart.

*By design, not copied* (ROADMAP queue 3), each of rank 0 or at the top
level: the reference's loss head keeps dead ops its trace never removed
and ``jnp.take``'s index fix-ups, and ``jnp.where`` converts its scalar
before each mLSTM's ``-inf`` mask (hoisted out of the forward body, and
again in the recomputed one under remat); the port's loss head scales
by one ``mul`` where the reference divides in a convert's dtype.
"""

import collections
import dataclasses

import pytest

from repro.api import Request as JRequest
from repro.api import Session as JSession
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jax_config
from repro.core.cost_model import HardwareSpec as JHardwareSpec
from repro.core.cost_model import MeshSpec as JMeshSpec
from repro.launch import specs as jspecs
from repro_torch.api import Request, Session
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import ir
from repro_torch.core.cost_model import HardwareSpec, MeshSpec
from repro_torch.launch import specs
from repro_torch.models import transformer as T
from repro_torch.train import steps as S

ARCH = "xlstm_350m"
COST_REL_TOL = 0.02
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
AXES = ("data", "model")
# case -> (layers, B, S, remat); full width and depth keep the config's
CASES = {"16-layers": (16, 2, 16, False), "full": (None, 4, 2048, True)}
# the loss head's differences, the same in every train program
LOSS_HEAD = collections.Counter({
    ("lt", 1): 2, ("add", 1): 2, ("select_n", 1): 4,
    ("broadcast_in_dim", 1): 5, ("eq", 1): 2, ("div", 1): 1, ("max", 1): 3,
    ("stop_gradient", 1): 1, ("sign", 1): 1, ("convert_element_type", 1): 3})


def configs(case):
    layers, _, _, remat = CASES[case]
    jc, tc = jax_config(ARCH), get_config(ARCH)
    if layers is not None:
        jc = dataclasses.replace(jc.reduced(), num_layers=layers)
        tc = dataclasses.replace(tc.reduced(), num_layers=layers)
    return (dataclasses.replace(jc, remat=remat),
            dataclasses.replace(tc, remat=remat))


@pytest.fixture(scope="module", params=sorted(CASES))
def plans(request):
    case = request.param
    jc, tc = configs(case)
    _, B, L, _ = CASES[case]
    jfn, jargs, _ = jspecs.step_and_inputs(jc, JShapeConfig("t", L, B,
                                                            "train"))
    tfn, targs, _ = specs.step_and_inputs(tc, ShapeConfig("t", L, B,
                                                          "train"))
    js, ts = JSession(jfn, jargs), Session(tfn, targs)
    jp = js.partition(JRequest(mesh=JMeshSpec(AXES, (2, 2)),
                               hw=JHardwareSpec(**HW), backend="greedy"))
    tp = ts.partition(Request(mesh=MeshSpec(AXES, (2, 2)),
                              hw=HardwareSpec(**HW), backend="greedy"))
    return case, js, ts, jp, tp


def trip_counts(prog):
    return collections.Counter((op.prim, prog.trip_counts[i])
                               for i, op in enumerate(prog.ops))


class TestPrograms:
    def test_prim_counts_per_trip_but_the_named_ones(self, plans):
        case, js, ts, _, _ = plans
        cfg = configs(case)[1]
        n = T.n_scan_blocks(cfg)
        want, got = trip_counts(js.artifacts.prog), \
            trip_counts(ts.artifacts.prog)
        # one jnp.where convert per mLSTM of the period, hoisted out of
        # the forward body; under remat also in the recomputed body
        named = LOSS_HEAD + collections.Counter(
            {("convert_element_type", 1): 7})
        if cfg.remat:
            named[("convert_element_type", n)] += 7
        assert want - got == named
        assert got - want == collections.Counter({("mul", 1): 1})

    def test_the_time_scan_runs_inside_both_layer_bodies(self, plans):
        case, _, ts, _, _ = plans
        cfg = configs(case)[1]
        n, L = T.n_scan_blocks(cfg), CASES[case][2]
        prog = ts.artifacts.prog
        assert set(prog.trip_counts.values()) == {1, n, n * L}
        inner = [(op.prim, prog.types[op.results[0]].shape)
                 for i, op in enumerate(prog.ops)
                 if prog.trip_counts[i] == n * L]
        prims = collections.Counter(p for p, _ in inner)
        # forward: the split of the gates (again when recomputed);
        # backward: their concatenation, and the accumulator of R's
        # gradient (h, hd, 4 hd) carried across time
        assert prims["split"] == 1 + cfg.remat
        assert prims["concatenate"] == 1
        h, hd = cfg.num_heads, cfg.resolved_head_dim
        assert ("add_any", (h, hd, 4 * hd)) in inner

    def test_inputs_and_outputs(self, plans):
        _, js, ts, _, _ = plans
        jprog, tprog = js.artifacts.prog, ts.artifacts.prog
        assert tprog.input_paths == jprog.input_paths
        assert [tprog.types[v].shape for v in tprog.inputs] == \
            [tuple(jprog.types[v].shape) for v in jprog.inputs]
        assert [tprog.types[v].shape for v in tprog.outputs] == \
            [tuple(jprog.types[v].shape) for v in jprog.outputs]


class TestPlanParity:
    def test_identical_in_and_out_specs(self, plans):
        _, _, _, jp, tp = plans
        assert tp.input_paths == jp.input_paths
        assert [tuple(s) for s in tp.in_specs] == \
            [tuple(s) for s in jp.in_specs]
        assert [tuple(s) for s in tp.out_specs] == \
            [tuple(s) for s in jp.out_specs]

    def test_identical_analysis_counts_and_rules(self, plans):
        _, _, _, jp, tp = plans
        assert tp.num_conflicts == jp.num_conflicts
        assert tp.num_compat_sets == jp.num_compat_sets
        assert tp.num_resolution_bits == jp.num_resolution_bits
        assert tp.logical_rules == jp.logical_rules

    def test_cost_within_tolerance(self, plans):
        _, _, _, jp, tp = plans
        assert abs(tp.cost - jp.cost) <= COST_REL_TOL * jp.cost
        assert tp.breakdown["comm_bytes"] == jp.breakdown["comm_bytes"]
        for key in ("flops", "peak_bytes"):
            assert abs(tp.breakdown[key] - jp.breakdown[key]) <= \
                COST_REL_TOL * jp.breakdown[key]

    def test_by_design_the_colors_differ_by_a_few(self, plans):
        _, _, _, jp, tp = plans
        assert abs(tp.num_colors - jp.num_colors) <= 5


# -- the scan records ---------------------------------------------------------


def loss_records(cfg, B, L):
    """The tracer's scan records of the loss's forward (no gradient
    node consumes them)."""
    _, (state, batch), _ = specs.step_and_inputs(
        cfg, ShapeConfig("t", L, B, "train"))
    ep, leaves, _ = ir.export_graph(S.make_loss_fn(cfg),
                                    (state.params, batch))
    ex = ir._Extractor()
    ex.walk(ep.graph_module, [ex.prog.new_value(x.shape, x.dtype)
                              for x in leaves])
    return ex


@pytest.mark.parametrize("layers", [8, 16])
def test_the_time_scan_is_the_layer_scans_child(layers):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), num_layers=layers)
    n, L = T.n_scan_blocks(cfg), 12
    ex = loss_records(cfg, 2, L)
    (outer,) = ex.scans
    (inner,) = outer.children
    assert outer.parent is None and inner.parent is outer
    assert (outer.length, outer.trip) == (n, 1)
    assert (inner.length, inner.trip, inner.children) == (L, n, [])
    assert outer.lo <= inner.lo < inner.hi <= outer.hi
    prog = ex.prog
    assert {prog.trip_counts[i] for i in range(inner.lo, inner.hi)} == \
        {n * L}
    # its constant is the recurrent weight, one layer's slice of the
    # stacked leaf; its ys are the carry's h
    (R,) = inner.consts
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    assert prog.types[R].shape == (h, hd, 4 * hd)
    assert R in outer.body_xs
    assert inner.y_outs == [inner.carry_outs[2]]
    # the four carries start from zeros, each a body value of its own
    assert len(set(inner.body_carry)) == 4
    producer = {r: op for op in prog.ops for r in op.results}
    assert {producer[c].prim for c in inner.carries} == {"broadcast_in_dim"}


def test_an_empty_layer_stack_records_no_scan():
    ex = loss_records(get_config(ARCH).reduced(), 2, 12)
    assert ex.scans == []
    prog = ex.prog
    assert set(prog.trip_counts.values()) == {1}
    assert sum(op.prim == "cumsum" for op in prog.ops) == 4
