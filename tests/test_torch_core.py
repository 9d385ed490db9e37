"""The port's analysis core and tracer against the JAX package.

*Analysis core.*  The eight copied modules (``nda``, ``conflicts``,
``actions``, ``constraints``, ``cost_model``, ``evaluator``, ``search``,
``mcts``) are fed the same ``Program`` — taken from the reference
tracer and converted to the port's class — and must be bit-identical to
the reference: colors, groups, conflicts, the action list, the cost of
fixed states under one explicit ``HardwareSpec``, the greedy / beam
results and the fixed-seed MCTS best plan.  Tolerance: none (``==``).

*Tracer.*  On the ``tests/test_nda.py`` micro-programs the port's
tracer (``torch.export`` on ``meta`` tensors) must give the same color
partition of the inputs' and outputs' dims and the same conflicts as
the reference tracer, and it must raise on an aten op it cannot lower.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._higher_order_ops.scan import scan

from repro.configs.base import get_config as jax_config
from repro.core import actions as j_actions
from repro.core import conflicts as j_conflicts
from repro.core import cost_model as j_cost
from repro.core import evaluator as j_eval
from repro.core import mcts as j_mcts
from repro.core import nda as j_nda
from repro.core import search as j_search
from repro.core.ir import extract_program as jax_extract
from repro.models import transformer as JT
from repro.train.steps import make_prefill_step as jax_prefill
from repro_torch.core import actions as t_actions
from repro_torch.core import conflicts as t_conflicts
from repro_torch.core import constraints as t_constraints
from repro_torch.core import cost_model as t_cost
from repro_torch.core import evaluator as t_eval
from repro_torch.core import ir as t_ir
from repro_torch.core import mcts as t_mcts
from repro_torch.core import nda as t_nda
from repro_torch.core import search as t_search
from repro_torch.core.ir import UnsupportedOpError, extract_program

# the reference's TPU defaults, passed explicitly to both packages
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)


def sh(*s):
    return jax.ShapeDtypeStruct(s, jnp.float32)


def meta(*s):
    return torch.empty(s, device="meta")


# -- the test_nda.py micro-programs, in both frameworks ------------------


def j_mlp(x, w1, w2):
    return jax.nn.relu(x @ w1) @ w2


def t_mlp(x, w1, w2):
    return torch.relu(x @ w1) @ w2


def j_attn(x, wq, wk, wv):
    k, v, q = x @ wk, x @ wv, x @ wq
    a = k @ q.T
    b = jnp.sum(a, axis=1)
    return (a / jnp.broadcast_to(b[None, :], a.shape)) @ v


def t_attn(x, wq, wk, wv):
    k, v, q = x @ wk, x @ wv, x @ wq
    a = k @ q.T
    b = a.sum(1)
    return (a / b[None, :].expand(a.shape)) @ v


def j_two_layer(x, *w):
    return j_attn(j_attn(x, *w[:3]), *w[3:])


def t_two_layer(x, *w):
    return t_attn(t_attn(x, *w[:3]), *w[3:])


def j_loop(x, ws):
    return jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), ()), x, ws)[0]


def t_loop(x, ws):
    return scan(lambda h, w: (torch.tanh(h @ w), ()), x, ws)[0]


MICRO = {
    "mlp": (j_mlp, t_mlp, [(256, 32), (32, 64), (64, 16)]),
    "attn": (j_attn, t_attn, [(128, 32)] + [(32, 16)] * 3),
    "transpose_matmul": (lambda x: x @ x.T, lambda x: x @ x.T, [(32, 4)]),
    "two_layer": (j_two_layer, t_two_layer, [(64, 32)] + [(32, 32)] * 6),
    "scan": (j_loop, t_loop, [(16, 32), (4, 32, 32)]),
    "reduce": (lambda x: jnp.sum(jnp.exp(x), axis=1),
               lambda x: torch.exp(x).sum(1), [(8, 4)]),
    "broadcast": (lambda x, b: x + jnp.broadcast_to(b[None, :], x.shape),
                  lambda x, b: x + b[None, :].expand(x.shape),
                  [(8, 4), (4,)]),
}


def jax_program(name):
    jfn, _, shapes = MICRO[name]
    return jax_extract(jfn, *(sh(*s) for s in shapes))


def prefill_program():
    cfg = jax_config("qwen2_05b").reduced()
    return jax_extract(jax_prefill(cfg), JT.param_specs(cfg),
                       {"tokens": jax.ShapeDtypeStruct((2, 64), jnp.int32)})


def to_port(jprog) -> t_ir.Program:
    """The reference's Program as the port's class (same ids, params)."""
    prog = t_ir.Program()
    for vid, t in jprog.types.items():
        prog.types[vid] = t_ir.TensorType(tuple(t.shape),
                                          np.dtype(t.dtype).name)
    prog.ops = [t_ir.Op(op.prim, dict(op.params), list(op.operands),
                        list(op.results), dict(op.meta))
                for op in jprog.ops]
    prog.inputs = list(jprog.inputs)
    prog.outputs = list(jprog.outputs)
    prog.input_paths = list(jprog.input_paths)
    prog.value_links = list(jprog.value_links)
    prog.trip_counts = dict(jprog.trip_counts)
    return prog


def state_key(s):
    return (s.color_axes, s.bits, s.kernel_impls)


def action_key(a):
    return dataclasses.astuple(a)


class _Pair:
    """Both packages' analysis of one program."""

    def __init__(self, jprog, mesh=(2, 2)):
        self.jprog, self.tprog = jprog, to_port(jprog)
        self.jn, self.tn = j_nda.run_nda(self.jprog), t_nda.run_nda(self.tprog)
        self.jc = j_conflicts.analyze_conflicts(self.jn)
        self.tc = t_conflicts.analyze_conflicts(self.tn)
        axes = ("data", "model")
        self.jmesh = j_cost.MeshSpec(axes, mesh)
        self.tmesh = t_cost.MeshSpec(axes, mesh)
        self.jcm = j_cost.CostModel(self.jprog, self.jn, self.jc, self.jmesh,
                                    j_cost.HardwareSpec(**HW))
        self.tcm = t_cost.CostModel(self.tprog, self.tn, self.tc, self.tmesh,
                                    t_cost.HardwareSpec(**HW))
        self.ja = j_actions.build_action_space(self.jn, self.jc, self.jmesh,
                                               min_dims=1)
        self.ta = t_actions.build_action_space(self.tn, self.tc, self.tmesh,
                                               min_dims=1)


PROGRAMS = ["mlp", "attn", "two_layer", "scan", "prefill"]


@pytest.fixture(scope="module", params=PROGRAMS)
def pair(request):
    if request.param == "prefill":
        return _Pair(prefill_program())
    return _Pair(jax_program(request.param))


class TestAnalysisCoreBitIdentical:
    def test_colors_and_groups(self, pair):
        np.testing.assert_array_equal(pair.jn.colors_arr, pair.tn.colors_arr)
        np.testing.assert_array_equal(pair.jn.groups_arr, pair.tn.groups_arr)
        assert pair.jn.m_edges == pair.tn.m_edges
        assert pair.jn.color_summary() == pair.tn.color_summary()

    def test_conflicts(self, pair):
        def key(ca):
            return ([(c.color, [(w.site.kind, w.site.op_index, w.site.slot,
                                 w.site.value) for w in c.witnesses])
                     for c in ca.conflicts],
                    [cs.signature for cs in ca.compat_sets],
                    ca.num_resolution_bits)
        assert key(pair.jc) == key(pair.tc)

    def test_action_list(self, pair):
        assert [action_key(a) for a in pair.ja] == \
            [action_key(a) for a in pair.ta]

    def test_cost_of_fixed_states(self, pair):
        """Root, then each action applied alone and all in sequence."""
        js, ts = j_cost.ShardingState(), t_cost.ShardingState()
        states = [(js, ts)]
        for ja, ta in zip(pair.ja, pair.ta):
            states.append((ja.apply(j_cost.ShardingState()),
                           ta.apply(t_cost.ShardingState())))
            if ja in j_actions.valid_actions([ja], js):
                js, ts = ja.apply(js), ta.apply(ts)
                states.append((js, ts))
        jev = j_eval.IncrementalEvaluator(pair.jcm)
        tev = t_eval.IncrementalEvaluator(pair.tcm)
        for j, t in states:
            assert state_key(j) == state_key(t)
            assert pair.jcm.evaluate(j).as_dict() == \
                pair.tcm.evaluate(t).as_dict()
            assert pair.jcm.paper_cost(j) == pair.tcm.paper_cost(t)
            assert jev.evaluate(j).as_dict() == tev.evaluate(t).as_dict()

    @pytest.mark.parametrize("backend", ["greedy", "beam"])
    def test_deterministic_search(self, pair, backend):
        jr = j_search.get_backend(backend).search(
            j_eval.IncrementalEvaluator(pair.jcm), pair.ja, None)
        tr = t_search.get_backend(backend).search(
            t_eval.IncrementalEvaluator(pair.tcm), pair.ta, None)
        assert state_key(jr.best_state) == state_key(tr.best_state)
        assert jr.best_cost == tr.best_cost
        assert jr.evaluations == tr.evaluations

    def test_fixed_seed_mcts(self, pair):
        jr = j_mcts.MCTSBackend().search(
            j_eval.IncrementalEvaluator(pair.jcm), pair.ja,
            j_mcts.MCTSConfig(rounds=4, trajectories_per_round=16, seed=7))
        tr = t_mcts.MCTSBackend().search(
            t_eval.IncrementalEvaluator(pair.tcm), pair.ta,
            t_mcts.MCTSConfig(rounds=4, trajectories_per_round=16, seed=7))
        assert state_key(jr.best_state) == state_key(tr.best_state)
        assert jr.best_cost == tr.best_cost
        assert jr.evaluations == tr.evaluations


class TestCopiesDiffer:
    def test_hardware_defaults_describe_an_h100(self):
        hw = t_cost.HardwareSpec()
        assert (hw.flops_per_chip, hw.hbm_bw, hw.ici_bw, hw.hbm_per_chip) \
            == (989e12, 3.35e12, 450e9, 80e9)

    def test_portfolio_backend_searches(self):
        """The ``"portfolio"`` backend runs and gives the reference's best
        plan (``tests/test_torch_portfolio.py`` holds the rest)."""
        from repro.core import portfolio as j_pf
        from repro_torch.core import portfolio as t_pf
        p = _Pair(jax_program("mlp"))
        got = {}
        for name, pf, search, mcts, ev, cm, actions in (
                ("jax", j_pf, j_search, j_mcts, j_eval, p.jcm, p.ja),
                ("torch", t_pf, t_search, t_mcts, t_eval, p.tcm, p.ta)):
            cfg = pf.PortfolioConfig(members=(
                pf.PortfolioMember("greedy", config=search.BeamConfig()),
                pf.PortfolioMember("mcts", seed=7, config=mcts.MCTSConfig(
                    seed=7, rounds=2, trajectories_per_round=8))),
                max_workers=1)
            backend = search.get_backend("portfolio")
            assert backend.name == "portfolio"
            res = backend.search(ev.IncrementalEvaluator(cm), actions, cfg)
            got[name] = (state_key(res.best_state), res.best_cost,
                         res.evaluations, res.winner)
        assert got["torch"] == got["jax"]
        assert got["torch"][1] < 1.0

    def test_constraints_compile_identically(self):
        from repro.core import constraints as j_constraints
        p = _Pair(jax_program("mlp"))
        jcs = j_constraints.compile_constraints(
            (j_constraints.Pin("[0][0]", ("data", None)),), p.jn, p.jprog, None,
            p.jmesh)
        tcs = t_constraints.compile_constraints(
            (t_constraints.Pin("[0][0]", ("data", None)),), p.tn, p.tprog, None,
            p.tmesh)
        assert state_key(jcs.root_state()) == state_key(tcs.root_state())
        assert [action_key(a) for a in jcs.prune(p.ja)] == \
            [action_key(a) for a in tcs.prune(p.ta)]


# -- tracer ------------------------------------------------------------------


def io_color_labels(prog, res):
    """Canonical color labels of every input and output dim."""
    labels: dict = {}
    out = []
    for vid in prog.inputs + prog.outputs:
        for c in res.colors_of_value(vid):
            out.append(labels.setdefault(c, len(labels)))
    return out


class TestTracer:
    @pytest.mark.parametrize("name", sorted(MICRO))
    def test_same_colors_and_conflicts_as_reference(self, name):
        jfn, tfn, shapes = MICRO[name]
        jprog = jax_program(name)
        tprog = extract_program(tfn, *(meta(*s) for s in shapes))
        jres, tres = j_nda.run_nda(jprog), t_nda.run_nda(tprog)
        assert io_color_labels(jprog, jres) == io_color_labels(tprog, tres)
        jca = j_conflicts.analyze_conflicts(jres)
        tca = t_conflicts.analyze_conflicts(tres)
        assert len(jca.conflicts) == len(tca.conflicts)
        assert [cs.signature for cs in jca.compat_sets] == \
            [cs.signature for cs in tca.compat_sets]
        assert jca.num_resolution_bits == tca.num_resolution_bits
        assert tprog.input_paths == jprog.input_paths

    def test_scan_is_one_body_with_trip_counts(self):
        tprog = extract_program(t_loop, meta(16, 32), meta(4, 32, 32))
        prims = [op.prim for op in tprog.ops]
        assert prims == ["dot_general", "tanh"]
        assert set(tprog.trip_counts.values()) == {4}
        assert len(tprog.value_links) == 4

    def test_raises_on_an_unmapped_aten_op(self):
        with pytest.raises(UnsupportedOpError, match="flip"):
            extract_program(lambda x: torch.flip(x, [0]) @ x, meta(4, 4))

    def test_raises_on_non_tensor_inputs(self):
        with pytest.raises(TypeError, match="tensor"):
            extract_program(lambda x, n: x * n, meta(4), 3)

    def test_itemsize_table_has_no_numpy_bfloat16(self):
        """bf16 sizes come from the port's own table (no ml_dtypes)."""
        prog = extract_program(lambda x: x * 2, torch.empty(
            (4, 8), dtype=torch.bfloat16, device="meta"))
        t = prog.types[prog.outputs[0]]
        assert (t.dtype, t.nbytes) == ("bfloat16", 64)
        assert len(t_ir.program_fingerprint(prog)) == 64
