"""The port's MoE train programs and their plans against the JAX
package's.

Both packages trace the train step of ``mixtral_8x22b`` and
``arctic_480b`` (``launch.specs``'s train cell: the default
``AdamConfig``, one microbatch) on abstract / ``meta`` inputs with
``use_pallas=False``, and search greedily under one explicit
``HardwareSpec``:

- reduced (2 layers, d 64, 4 experts) on a 2x2 mesh: mixtral's batch
  dispatch at B 2 x S 32 without remat, its global dispatch with remat
  and its local dispatch (4 pools) without, and arctic's
  batch dispatch at B 1 x S 32 with remat (a batch of one: the
  ``vmap``'d combine keeps its batch dim as a batching dim);
- full width and full depth (mixtral 56 layers, arctic 35) on a 2x4
  mesh at B 1 x S 4096, remat on (the configs' own): the plans the card's
  MoE train phase reports.

*Programs.*  The reference's program is its ``jax.make_jaxpr`` of the
step, lowered by its own tracer (``repro.core.ir``).  Both hold the same
``top_k``, ``gather`` and ``scatter-add`` ops, in the same order, with
equal ``k``, axes and dimension numbers: each ``top_k``'s JVP gather,
transposed into a ``scatter-add`` into zeros; the dispatch gather's
transpose (a ``scatter-add``) and the combine's (a ``gather`` of its
cotangent); the embedding's and the loss head's.  The prims of
``COUNTED`` occur as often at each trip count: one forward and one
backward layer scan, with remat the forward body recomputed in the
backward one.  So do the fills of a scalar (the zeros of each
transposed gather and each instantiated tangent), but for the
reference's dead loss-head ones.

*Plans.*  Identical input paths, ``in_specs`` (the expert stacks' among
them, for the parameters and both moments), ``out_specs``, logical
rules, conflicts, compat sets, resolution bits and communication bytes;
the cost, FLOPs and peak bytes within 2%.

*By design, not copied* (ROADMAP queue 3): the reference's programs
carry the softmax's ``max(-inf, .)`` and ``stop_gradient``, each
index's negative-index fix-up, the loss head's dead ops and the
schedule's integer ``max``; the port's carry one_hot's iotas at their
own shape with a broadcast.  So the two count a few colors apart, with
the same conflicts.

*Fused sites.*  With ``use_pallas`` arctic's full-causal attention is
one ``kernel:flash_attention`` op in the forward body, one recomputed
under remat, and one ``kernel:flash_attention_bwd`` in the backward
body, with the registry's roles; the one-device plan runs the step with
the ``"cuda"`` impl (on CPU tensors the plain version, so the applied
step equals the unapplied one).  Mixtral's windowed attention has none.
The reference's jax 0.9 trace records no fused sites (ROADMAP queue 3).
"""

import collections
import dataclasses

import jax
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

COST_REL_TOL = 0.02
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
AXES = ("data", "model")
MOE_PRIMS = ("top_k", "gather", "scatter-add")
# prims whose count per trip must be the reference's
COUNTED = MOE_PRIMS + ("dot_general", "transpose", "reshape", "reduce_sum",
                       "squeeze", "pad", "slice", "concatenate", "split",
                       "add_any", "logistic", "exp", "rsqrt", "sub", "neg",
                       "integer_pow", "square", "sqrt")
# id -> (arch, size, dispatch, remat, B, S, mesh)
CASES = {
    "mixtral-batch": ("mixtral_8x22b", "reduced", "batch", False, 2, 32,
                      (2, 2)),
    "mixtral-global-remat": ("mixtral_8x22b", "reduced", "global", True, 2,
                             32, (2, 2)),
    "mixtral-local": ("mixtral_8x22b", "reduced", "local", False, 2, 32,
                      (2, 2)),
    "arctic-batch-remat-b1": ("arctic_480b", "reduced", "batch", True, 1,
                              32, (2, 2)),
    "mixtral-full": ("mixtral_8x22b", "full", None, None, 1, 4096, (2, 4)),
    "arctic-full": ("arctic_480b", "full", None, None, 1, 4096, (2, 4)),
}


def configs(case, use_pallas=False):
    arch, size, mode, remat, _, _, _ = CASES[case]
    jc, tc = jax_config(arch), get_config(arch)
    if size == "reduced":
        kw = dict(moe_dispatch=mode, remat=remat, moe_local_pools=4)
        jc = dataclasses.replace(jc.reduced(), **kw)
        tc = dataclasses.replace(tc.reduced(), **kw)
    return jc, dataclasses.replace(tc, use_pallas=use_pallas)


def cells(case, use_pallas=False):
    jc, tc = configs(case, use_pallas)
    B, L = CASES[case][4:6]
    return (jspecs.step_and_inputs(jc, JShapeConfig("t", L, B, "train")),
            specs.step_and_inputs(tc, ShapeConfig("t", L, B, "train")))


@pytest.fixture(scope="module", params=sorted(CASES))
def plans(request):
    case = request.param
    (jfn, jargs, _), (tfn, targs, _) = cells(case)
    mesh = CASES[case][6]
    js, ts = JSession(jfn, jargs), Session(tfn, targs)
    jp = js.partition(JRequest(mesh=JMeshSpec(AXES, mesh),
                               hw=JHardwareSpec(**HW), backend="greedy"))
    tp = ts.partition(Request(mesh=MeshSpec(AXES, mesh),
                              hw=HardwareSpec(**HW), backend="greedy"))
    return case, js, ts, jp, tp


def by_trip(prog):
    """prim -> trip count -> number of ops."""
    out: dict = collections.defaultdict(collections.Counter)
    for i, op in enumerate(prog.ops):
        out[op.prim][prog.trip_counts[i]] += 1
    return out


def moe_ops(prog):
    """Each top_k, gather and scatter-add in order: its prim, trip count,
    operand and result shapes, and ``k`` and axis or dimension
    numbers."""
    out = []
    for i, op in enumerate(prog.ops):
        if op.prim not in MOE_PRIMS:
            continue
        if op.prim == "top_k":
            key = (op.params["k"], op.params["axis"])
        else:
            key = tuple(tuple(int(d) for d in f)
                        for f in op.params["dimension_numbers"])
        out.append((op.prim, prog.trip_counts[i],
                    [tuple(prog.types[v].shape) for v in op.operands],
                    [tuple(prog.types[v].shape) for v in op.results], key))
    return out


class TestPrograms:
    def test_the_moe_prims_in_order_with_their_dimension_numbers(
            self, plans):
        case, js, ts, _, _ = plans
        want, got = moe_ops(js.artifacts.prog), moe_ops(ts.artifacts.prog)
        assert got == want
        remat = configs(case)[1].remat
        n = T.n_scan_blocks(configs(case)[1])
        # per layer body: two top_k forward (again when recomputed); the
        # dispatch gather forward and recomputed, the combine's transpose
        # back; the combine forward, and back the dispatch gather's and
        # both top_k's transposes
        trips = collections.Counter((p, t) for p, t, *_ in got)
        assert trips["top_k", n] == 2 * (1 + remat)
        assert trips["gather", n] == 2 + remat
        assert trips["scatter-add", n] == 4

    def test_prim_counts_per_trip_match_the_reference(self, plans):
        _, js, ts, _, _ = plans
        jt, tt = by_trip(js.artifacts.prog), by_trip(ts.artifacts.prog)
        for prim in COUNTED:
            assert tt[prim] == jt[prim], prim

    def test_zero_fills_match_but_the_loss_heads(self, plans):
        # every fill of a scalar (the zeros each gather's transpose
        # scatters into, the zeros scatter-add instantiates for its
        # operand's missing tangent, the router's and the combine's
        # zeros) at each trip count and shape, but the five dead (B, S)
        # fills of the reference's loss head at the top level
        case, js, ts, _, _ = plans
        B, L = CASES[case][4:6]

        def fills(prog):
            return collections.Counter(
                (prog.trip_counts[i], tuple(prog.types[op.results[0]].shape))
                for i, op in enumerate(prog.ops)
                if op.prim == "broadcast_in_dim" and
                not op.params["broadcast_dimensions"] and
                not prog.types[op.operands[0]].shape)

        want, got = fills(js.artifacts.prog), fills(ts.artifacts.prog)
        assert not got - want
        assert want - got == collections.Counter({(1, (B, L)): 5})

    def test_one_forward_and_one_backward_body(self, plans):
        case, _, ts, _, _ = plans
        cfg = configs(case)[1]
        prog = ts.artifacts.prog
        n = T.n_scan_blocks(cfg)
        assert set(prog.trip_counts.values()) == {1, n}
        body = [i for i in range(len(prog.ops)) if prog.trip_counts[i] == n]
        runs = sum(1 for a, b in zip(body, body[1:]) if b != a + 1) + 1
        assert runs == 2

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
        for tree in ("params", "opt.m", "opt.v"):
            assert any(f"{tree}['layers'][0]['ffn']['wgate']" in p
                       for p in tp.input_paths)

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


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "arctic_480b"])
def test_train_cell_inputs_and_names(arch):
    # the expert stacks of params, m and v carry the reference's logical
    # names
    jc, tc = jax_config(arch).reduced(), get_config(arch).reduced()
    _, jargs, jnames = jspecs.step_and_inputs(
        jc, JShapeConfig("t", 32, 2, "train"))
    _, targs, tnames = specs.step_and_inputs(
        tc, ShapeConfig("t", 32, 2, "train"))
    jflat, _ = jax.tree_util.tree_flatten_with_path(jargs)
    tleaves, tpaths = pytree.flatten_with_paths(targs)
    assert tpaths == [jax.tree_util.keystr(p) for p, _ in jflat]
    assert [(tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for x in tleaves] == [(tuple(x.shape), str(x.dtype))
                                  for _, x in jflat]
    assert flatten_logical_axes(tnames) == flatten_logical_axes(jnames)
    names = dict(zip(tpaths, flatten_logical_axes(tnames)))
    for tree in ("params", "opt.m", "opt.v"):
        assert names[f"[0].{tree}['layers'][0]['ffn']['wi']"] == \
            (None, "experts", "embed", "hidden")


# -- fused sites ------------------------------------------------------------


@pytest.fixture(scope="module")
def fused():
    case = "arctic-batch-remat-b1"
    _, (fn, args, _) = cells(case, use_pallas=True)
    return configs(case, use_pallas=True)[1], fn, Session(fn, args)


def test_arctic_fused_sites_follow_the_registry(fused):
    cfg, _, sess = fused
    prog, nda = sess.artifacts.prog, sess.artifacts.nda
    n = T.n_scan_blocks(cfg)
    kops = [(i, op) for i, op in enumerate(prog.ops)
            if op.prim.startswith("kernel:")]
    fwd, bwd = "kernel:flash_attention", "kernel:flash_attention_bwd"
    # the forward body's site, then the backward body: the recomputed
    # site (remat) and its backward
    assert [(op.prim, prog.trip_counts[i]) for i, op in kops] == \
        [(fwd, n), (fwd, n), (bwd, n)]
    for i, op in kops:
        spec = registry.spec_for_prim(op.prim)
        assert [prog.types[v].rank for v in op.operands] == \
            [len(r) for r in spec.operand_roles]
        assert [prog.types[v].rank for v in op.results] == \
            [len(r) for r in spec.result_roles]
        colors: dict = {}
        for roles, v in list(zip(spec.operand_roles, op.operands)) + \
                list(zip(spec.result_roles, op.results)):
            for role, c in zip(roles, nda.colors_of_value(v)):
                assert colors.setdefault(role, c) == c
    # the backward reads the recomputed site's q, k, v
    (_, recomputed), (_, back) = kops[1], kops[2]
    assert back.operands[:3] == recomputed.operands


def test_one_device_plan_runs_the_train_step(fused):
    cfg, fn, sess = fused
    plan = sess.partition(Request(mesh=MeshSpec(AXES, (1, 1))))
    # the forward site and the recomputed one
    assert [(r["site"], r["impl"]) for r in plan.kernel_sites] == \
        [("flash_attention:0", "cuda"), ("flash_attention:1", "cuda")]
    state = S.init_train_state(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (1, 32), generator=g,
                              dtype=torch.int32)
             for k in ("targets", "tokens")}
    got = plan.apply(fn, device="cpu")(state, batch)
    want = fn(state, batch)
    assert len(pytree.tree_leaves(got)) == len(plan.out_specs)
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
