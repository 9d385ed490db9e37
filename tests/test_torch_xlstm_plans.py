"""The port's plans of the ``xlstm_350m`` prefill and decode steps against
the JAX package's.

Both packages trace the model at reduced width with 16 layers (two
scanned super-blocks, each with its sLSTM, whose time scan is nested in
the layer scan's body; the stock 4-layer ``.reduced()`` holds mLSTM
tail layers only) and at full width and full depth (24 layers, three
super-blocks), on abstract / ``meta`` inputs: the prefill step at B 2 x
S 64 (reduced) and 4 x 2048 (full), the decode step at B 4 with a cache
of 32 (reduced) and 256 (full), each through its package's own entry
points.  Each plan is a greedy search of a 2x2 mesh under one explicit
``HardwareSpec``, the decode step's with the serving launcher's request
(no cache pinned: the model has no attention block).  The plans have
identical input paths, ``in_specs``, ``out_specs``, ``logical_rules``,
conflicts, compat sets, resolution bits, colors (all of them, those on
live values, and the partition of the inputs' and outputs' dims) and
communication bytes, and equal ``peak_bytes``; the costs agree within
2% relative.  The reference's plan JSON loads into the port.  Both
programs hold the same ``cumsum`` and ``split`` prims, with the same
params and trip counts.

What differs, and why (by design; each op is of rank 0 or an index
computation, and carries no color of its own):

- ``jnp.where``'s scalar: the reference converts the weakly typed
  ``-inf`` of each mLSTM's causal mask with a ``convert_element_type``
  of rank 0 before broadcasting it; the port broadcasts the literal
  (one op less per mLSTM layer, 7 in the scanned body).
- The negative-index fix-up (``lt``, ``add``, ``select_n``) of the
  token ids ``jnp.take`` receives (prefill and decode), and the
  prefill's last-token logits, a ``dynamic_slice`` at a fixed-up index
  in the reference and a ``slice`` in the port.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.api import Request as JRequest
from repro.api import Session as JSession
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jax_config
from repro.core.cost_model import HardwareSpec as JHardwareSpec
from repro.core.cost_model import MeshSpec as JMeshSpec
from repro.launch.specs import step_and_inputs as jax_step_and_inputs
from repro.models import transformer as JT
from repro.train.steps import make_prefill_step as jax_prefill
from repro_torch.api import Request, Session
from repro_torch.configs import get_config
from repro_torch.core.cost_model import HardwareSpec, MeshSpec
from repro_torch.core.partitioner import ShardingPlan
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.train.steps import make_prefill_step
from test_torch_core import io_color_labels
from test_torch_hybrid_plans import live_colors

ARCH = "xlstm_350m"
COST_REL_TOL = 0.02
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
AXES = ("data", "model")
# reduced width, two scanned super-blocks (each with its sLSTM)
REDUCED_LAYERS = 16
CASES = [(s, k) for s in ("reduced", "full") for k in ("prefill", "decode")]


def configs(size):
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    if size == "reduced":
        jcfg = dataclasses.replace(jcfg.reduced(), num_layers=REDUCED_LAYERS)
        tcfg = dataclasses.replace(tcfg.reduced(), num_layers=REDUCED_LAYERS)
    return jcfg, tcfg


def prefill_plans(jcfg, tcfg, full):
    B, S = (4, 2048) if full else (2, 64)
    js = JSession(jax_prefill(jcfg), (JT.param_specs(jcfg), {
        "tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}))
    ts = Session(make_prefill_step(tcfg), (T.param_specs(tcfg), {
        "tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}))
    jp = js.partition(JRequest(mesh=JMeshSpec(AXES, (2, 2)),
                               hw=JHardwareSpec(**HW), backend="greedy"))
    tp = ts.partition(Request(mesh=MeshSpec(AXES, (2, 2)),
                              hw=HardwareSpec(**HW), backend="greedy"))
    return js, ts, jp, tp


def decode_plans(jcfg, tcfg, full, B=4):
    max_seq = 256 if full else 32
    jfn, jargs, jnames = jax_step_and_inputs(
        jcfg, JShapeConfig("serve", max_seq, B, "decode"))
    js = JSession(jfn, jargs)
    # the reference launcher pins the KV cache only when there is one
    jp = js.partition(JRequest(
        mesh=JMeshSpec(AXES, (2, 2)), hw=JHardwareSpec(**HW),
        backend="greedy", min_dims=4, logical_axes=jnames))
    ts, tnames = serve.decode_session(tcfg, B, max_seq)
    req = serve.decode_request(tcfg, tnames, MeshSpec(AXES, (2, 2)))
    assert req.constraints == ()
    tp = ts.partition(dataclasses.replace(req, hw=HardwareSpec(**HW)))
    return js, ts, jp, tp


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def plans(request):
    size, kind = request.param
    make = prefill_plans if kind == "prefill" else decode_plans
    return (request.param, *make(*configs(size), size == "full"))


class TestPlanParity:
    def test_identical_in_and_out_specs(self, plans):
        _, _, _, jp, tp = plans
        assert tp.input_paths == jp.input_paths
        assert [tuple(s) for s in tp.in_specs] == \
            [tuple(s) for s in jp.in_specs]
        assert [tuple(s) for s in tp.out_specs] == \
            [tuple(s) for s in jp.out_specs]
        assert any("['R']" in p for p in tp.input_paths)

    def test_identical_analysis_counts(self, plans):
        _, _, _, jp, tp = plans
        assert tp.num_conflicts == jp.num_conflicts
        assert tp.num_colors == jp.num_colors
        assert tp.num_compat_sets == jp.num_compat_sets
        assert tp.num_resolution_bits == jp.num_resolution_bits

    def test_same_colors_on_inputs_outputs_and_live_values(self, plans):
        _, js, ts, _, _ = plans
        jart, tart = js.artifacts, ts.artifacts
        assert io_color_labels(tart.prog, tart.nda) == \
            io_color_labels(jart.prog, jart.nda)
        assert len(live_colors(tart.prog, tart.nda)) == \
            len(live_colors(jart.prog, jart.nda))

    def test_identical_logical_rules(self, plans):
        _, _, _, jp, tp = plans
        assert tp.logical_rules == jp.logical_rules

    def test_cost_and_bytes(self, plans):
        _, _, _, jp, tp = plans
        assert abs(tp.cost - jp.cost) <= COST_REL_TOL * jp.cost
        assert tp.breakdown["comm_bytes"] == jp.breakdown["comm_bytes"]
        assert tp.breakdown["peak_bytes"] == jp.breakdown["peak_bytes"]

    def test_reference_plan_json_loads_into_the_port(self, plans):
        _, _, _, jp, tp = plans
        loaded = ShardingPlan.from_json(jp.to_json())
        assert loaded.in_specs == tp.in_specs
        assert loaded.input_paths == tp.input_paths
        again = ShardingPlan.from_json(tp.to_json())
        assert again.as_dict() == tp.as_dict()


def _ops(prog, prim):
    return [(op.params, prog.trip_counts[i])
            for i, op in enumerate(prog.ops) if op.prim == prim]


class TestPrograms:
    def test_cumsum_and_split_match_with_their_trip_counts(self, plans):
        (size, kind), js, ts, _, _ = plans
        jprog, tprog = js.artifacts.prog, ts.artifacts.prog
        jcfg, _ = configs(size)
        n_scan = JT.n_scan_blocks(jcfg)
        S = 2048 if size == "full" else 64
        for prim in ("cumsum", "split"):
            want = [({k: tuple(int(n) for n in v) if k == "sizes" else v
                      for k, v in p.items()}, trip)
                    for p, trip in _ops(jprog, prim)]
            assert _ops(tprog, prim) == want, prim
        splits = _ops(tprog, "split")
        hd = jcfg.resolved_head_dim
        # one split per sLSTM step: the time scan nested in the layer
        # scan runs n_scan x S times in prefill, n_scan times in decode
        assert splits == [({"sizes": (hd,) * 4, "axis": 2},
                           n_scan * (S if kind == "prefill" else 1))]
        # one cumsum per mLSTM layer in prefill (7 in the scanned body),
        # none in decode
        cumsums = _ops(tprog, "cumsum")
        assert len(cumsums) == (7 if kind == "prefill" else 0)
        assert {trip for _, trip in cumsums} <= {n_scan}

    def test_the_programs_differ_by_the_named_ops(self, plans):
        (size, kind), js, ts, _, _ = plans
        jprog, tprog = js.artifacts.prog, ts.artifacts.prog
        jops = collections.Counter(op.prim for op in jprog.ops)
        tops = collections.Counter(op.prim for op in tprog.ops)
        fixups = {"lt": 1, "add": 1, "select_n": 1}
        if kind == "prefill":
            fixups = {"lt": 2, "add": 2, "select_n": 2, "dynamic_slice": 1,
                      "convert_element_type": 7}
            assert tops - jops == {"slice": 1}
        else:
            assert not tops - jops
        assert jops - tops == fixups
