"""The port's train programs and their plans against the JAX package's.

Both packages trace the ``qwen2_05b`` train step (``launch.specs``'s
train cell: the default ``AdamConfig``, one microbatch, B 4) with the
einsum path, reduced (S 16, no remat) and at full width (S 2048, remat,
the config's default), and search a 2x2 mesh greedily under one explicit
``HardwareSpec``.

*Programs.*  Each holds the layer body once in a forward scan and once
in a backward scan, with trip counts, never unrolled: ops at the top
level and ops inside the bodies only.  The backward body transposes the
forward one (and recomputes it under remat), and the loss head, its
gradient and the AdamW update follow at the top level.  Both programs
have the same number of ``dot_general``s, ``add_any``s, ``scatter-add``s,
``pad``s and ``split``s at each trip count.

*Plans.*  Identical ``in_specs`` and ``out_specs``, conflicts, compat
sets, resolution bits and communication bytes; costs within 2%.

*By design, not copied* (pinned below): the reference's loss head keeps
dead ops its trace never removed — ``jnp.take_along_axis``'s index
fix-up, ``logsumexp``'s ``max(-inf, ·)`` and its JVP's tie weights, the
unused ``sign`` — and its softmax the ``max(-inf, ·)`` before its
``stop_gradient``; the port's iotas are int64.  So the two count a few
colors apart, with the same conflicts and costs.

*Fused sites.*  With ``use_pallas`` the forward body holds one
``kernel:flash_attention`` op, the backward body one
``kernel:flash_attention_bwd`` with the registry's roles (and, under
remat, the recomputed forward site).  The reference's jax 0.9 trace
records no fused sites (ROADMAP queue 3), so these are held to the
registry contracts.
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
from repro_torch.core.ir import extract_program
from repro_torch.core.partitioner import flatten_logical_axes
from repro_torch.kernels import registry
from repro_torch.launch import specs
from repro_torch.train import steps as S

ARCH = "qwen2_05b"
COST_REL_TOL = 0.02
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
AXES = ("data", "model")
SIZES = {"reduced": (4, 16), "full": (4, 2048)}
# ops whose count per trip must be the reference's
COUNTED = ("dot_general", "add_any", "scatter-add", "pad", "split",
           "transpose", "concatenate", "logistic", "rsqrt", "exp")


def configs(size, use_pallas=False):
    jc, tc = jax_config(ARCH), get_config(ARCH)
    if size == "reduced":
        jc, tc = jc.reduced(), tc.reduced()
    return jc, dataclasses.replace(tc, use_pallas=use_pallas)


def cells(size, use_pallas=False):
    jc, tc = configs(size, use_pallas)
    B, L = SIZES[size]
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
        size, js, ts, _, _ = plans
        cfg = configs(size)[1]
        prog = ts.artifacts.prog
        assert set(prog.trip_counts.values()) == {1, cfg.num_layers}
        # forward body, then backward body; nothing unrolled
        runs = body_runs(prog, cfg.num_layers)
        assert len(runs) == 2
        fwd, bwd = (prog.ops[a:b] for a, b in runs)
        n_dots = lambda ops: sum(o.prim == "dot_general" for o in ops)
        # 9 products forward (q, k, v, scores, PV, wo, wi, wg, wo); two
        # per product back, plus the recomputed 8 the transpose reads
        assert n_dots(fwd) == 9
        assert n_dots(bwd) == 18 + (8 if cfg.remat else 0)
        assert cfg.remat == (size == "full")

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

    def test_unknown_ops_still_raise(self):
        from repro_torch.core import autodiff
        from repro_torch.core.ir import Op, Program
        prog = Program()
        x = prog.new_value((3,), "float32")
        y = prog.new_value((3,), "float32")
        prog.add_op(Op("erf_inv", {}, [x], [y]))
        loss = prog.new_value((), "float32")
        prog.add_op(Op("reduce_sum", {"axes": (0,)}, [y], [loss]))
        with pytest.raises(NotImplementedError, match="erf_inv"):
            autodiff.value_and_grad(prog, [], loss, [x], set(), False)


class TestPlanParity:
    def test_identical_in_and_out_specs(self, plans):
        _, _, _, jp, tp = plans
        assert tp.input_paths == jp.input_paths
        assert [tuple(s) for s in tp.in_specs] == \
            [tuple(s) for s in jp.in_specs]
        assert [tuple(s) for s in tp.out_specs] == \
            [tuple(s) for s in jp.out_specs]
        assert len(tp.out_specs) == 50

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
        # the reference's dead loss-head ops and int32 iotas (module
        # docstring): a few colors apart, never a conflict apart
        _, _, _, jp, tp = plans
        assert tp.num_colors != jp.num_colors
        assert abs(tp.num_colors - jp.num_colors) <= 5


# -- launch/specs.py: the train cell ----------------------------------------


@pytest.mark.parametrize("size", sorted(SIZES))
def test_train_cell_inputs_and_names(size):
    (_, jargs, jnames), (fn, targs, tnames) = cells(size)
    import jax
    jflat, _ = jax.tree_util.tree_flatten_with_path(jargs)
    tleaves, tpaths = pytree.flatten_with_paths(targs)
    assert tpaths == [jax.tree_util.keystr(p) for p, _ in jflat]
    assert [(tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for x in tleaves] == [(tuple(x.shape), str(x.dtype))
                                  for _, x in jflat]
    assert all(x.device.type == "meta" for x in tleaves)
    # the reference's names tree, walked by the same flattener
    assert flatten_logical_axes(tnames) == flatten_logical_axes(jnames)
    assert set(targs[1]) == {"tokens", "targets"}


# -- fused sites ------------------------------------------------------------


@pytest.fixture(scope="module", params=sorted(SIZES))
def fused(request):
    _, (fn, args, _) = cells(request.param, use_pallas=True)
    return request.param, fn, args, Session(fn, args)


def test_fused_sites_follow_the_registry(fused):
    size, _, _, sess = fused
    cfg = configs(size)[1]
    prog, nda = sess.artifacts.prog, sess.artifacts.nda
    kops = [(i, op) for i, op in enumerate(prog.ops)
            if op.prim.startswith("kernel:")]
    prims = [op.prim for _, op in kops]
    fwd = ["kernel:flash_attention"]
    assert prims == fwd + fwd * cfg.remat + ["kernel:flash_attention_bwd"]
    for i, op in kops:
        assert prog.trip_counts[i] == cfg.num_layers
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
    bwd = kops[-1][1]
    # the backward reads the forward site's q, k, v: recomputed under
    # remat, else their slices of the forward scan's residual stacks
    site = kops[-2][1]
    if cfg.remat:
        assert bwd.operands[:3] == site.operands
    else:
        stacked = collections.defaultdict(set)
        for a, b, off in prog.value_links:
            if off == 1:
                stacked[a].add(b)
        for q, f in zip(bwd.operands[:3], site.operands):
            assert any({q, f} <= vs for vs in stacked.values())
    assert bwd.params == {"kernel": "flash_attention_bwd", "causal": True}


def test_one_device_plan_runs_the_train_step():
    size = "reduced"
    _, (fn, args, _) = cells(size, use_pallas=True)
    plan = Session(fn, args).partition(Request(mesh=MeshSpec(AXES, (1, 1))))
    cfg = configs(size, use_pallas=True)[1]
    # dispatch sites: the forward one, and its recomputation under remat
    assert [r["site"] for r in plan.kernel_sites] == \
        [f"flash_attention:{i}" for i in range(1 + cfg.remat)]
    assert {r["impl"] for r in plan.kernel_sites} == {"cuda"}
    state = S.init_train_state(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    B, L = SIZES[size]
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, L), generator=g,
                              dtype=torch.int32)
             for k in ("targets", "tokens")}
    got = plan.apply(fn, device="cpu")(state, batch)
    want = fn(state, batch)
    assert len(pytree.tree_leaves(got)) == len(plan.out_specs)
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_a_traced_step_takes_one_microbatch():
    cfg = get_config(ARCH).reduced()
    step = S.make_train_step(cfg, accum_steps=2)
    with pytest.raises(NotImplementedError, match="accum_steps=1"):
        extract_program(step, S.train_state_specs(cfg),
                        specs.batch_specs(cfg, ShapeConfig(
                            "t", 16, 4, "train"))[0])
