"""The port's plans of the MoE models' prefill and decode steps against
the JAX package's.

Both packages trace ``mixtral_8x22b`` and ``arctic_480b`` (batch
dispatch, their configs' own) at reduced size and at full width and full
depth on abstract / ``meta`` inputs: the prefill step at B 2 x S 64
(reduced) and 4 x 2048 (full), the decode step at B 4 with a cache of 32
(reduced) and 256 (full), each through its package's own entry points.
Each plan is a greedy search of a 2x2 mesh under one explicit
``HardwareSpec``, the decode step's with the serving launcher's request.
The plans have identical input paths, ``in_specs`` (the expert weights'
among them), ``out_specs``, ``logical_rules``, conflicts, compat sets,
resolution bits, colors (all of them, those on live values, and the
partition of the inputs' and outputs' dims) and communication bytes; the
costs agree within 2% relative.  The reference's plan JSON loads into
the port.  Both programs hold the reference's MoE prims: ``top_k`` (k =
2, then the capacity), ``gather`` and ``scatter-add`` with equal
dimension numbers.

What differs, and why (by design; ROADMAP queue 3):

- The reference's program carries ops the port's does not: the
  softmax's ``max(-inf, .)`` and ``stop_gradient``, and the
  negative-index fix-up (``lt``, ``add``, ``select_n``) of every index
  ``jnp.take``, ``take_along_axis`` and ``.at[].add`` receive.  The
  port's carries one_hot's iota at its own shape, (E,), and a
  ``broadcast_in_dim`` of it, where the reference makes it at the
  comparison's rank.  None carries a color of its own.
- Indices are int64 in the port (torch's index type) and int32 in the
  reference.  At reduced size the prefill's peak is the expert FFN's,
  where the capacity selection's (B, E, C) token indices are live: the
  port's peak is larger by their extra 4 bytes an element, on the 2x2
  mesh's 4 devices.  At full width the peak lies elsewhere and the two
  are equal.

*Fused sites.*  With ``use_pallas=True`` arctic's full-causal attention
is one ``kernel:flash_attention`` op for all layers, its operands'
roles as the registry's contract says, and the one-device plan runs it
with the ``"cuda"`` impl (on CPU tensors the plain version, so the
applied step equals the unapplied one); mixtral's windowed attention
has no site.  The rest of the program is held against the reference
traced with ``use_pallas=False`` above, as the reference's fused trace
is broken (ROADMAP queue 3, caveats).
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Replicate as JReplicate
from repro.api import Request as JRequest
from repro.api import Session as JSession
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jax_config
from repro.core.ir import extract_program as jax_extract
from repro.core.cost_model import HardwareSpec as JHardwareSpec
from repro.core.cost_model import MeshSpec as JMeshSpec
from repro.launch.specs import step_and_inputs as jax_step_and_inputs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train.steps import make_prefill_step as jax_prefill
from repro_torch.api import Request, Session
from repro_torch.configs import get_config
from repro_torch.core.cost_model import HardwareSpec, MeshSpec
from repro_torch.core.ir import extract_program
from repro_torch.core.partitioner import ShardingPlan
from repro_torch.kernels import registry
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train.steps import make_prefill_step
from test_torch_core import io_color_labels
from test_torch_hybrid_plans import live_colors

COST_REL_TOL = 0.02
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
AXES = ("data", "model")
ARCHS = ["mixtral_8x22b", "arctic_480b"]
CASES = [(a, s, k) for a in ARCHS for s in ("reduced", "full")
         for k in ("prefill", "decode")]


def prefill_plans(jcfg, tcfg, full, B=None):
    B, S = (4, 2048) if full else (B or 2, 64)
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
    jp = js.partition(JRequest(
        mesh=JMeshSpec(AXES, (2, 2)), hw=JHardwareSpec(**HW),
        backend="greedy", min_dims=4, logical_axes=jnames,
        constraints=(JReplicate("['k']"), JReplicate("['v']"))))
    ts, tnames = serve.decode_session(tcfg, B, max_seq)
    req = serve.decode_request(tcfg, tnames, MeshSpec(AXES, (2, 2)))
    tp = ts.partition(dataclasses.replace(req, hw=HardwareSpec(**HW)))
    return js, ts, jp, tp


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def plans(request):
    arch, size, kind = request.param
    jcfg, tcfg = jax_config(arch), get_config(arch)
    if size == "reduced":
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    make = prefill_plans if kind == "prefill" else decode_plans
    return (request.param, *make(jcfg, tcfg, size == "full"))


class TestPlanParity:
    def test_identical_in_and_out_specs(self, plans):
        _, _, _, jp, tp = plans
        assert tp.input_paths == jp.input_paths
        assert [tuple(s) for s in tp.in_specs] == \
            [tuple(s) for s in jp.in_specs]
        assert [tuple(s) for s in tp.out_specs] == \
            [tuple(s) for s in jp.out_specs]
        assert any("['wgate']" in p for p in tp.input_paths)

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
        (_, _, kind), _, _, jp, tp = plans
        assert tp.logical_rules == jp.logical_rules
        if kind == "decode":
            assert "experts" in tp.logical_rules

    def test_cost_and_bytes(self, plans):
        (_, size, kind), js, ts, jp, tp = plans
        assert abs(tp.cost - jp.cost) <= COST_REL_TOL * jp.cost
        assert tp.breakdown["comm_bytes"] == jp.breakdown["comm_bytes"]
        extra = 0
        if (size, kind) == ("reduced", "prefill"):
            # the (B, E, C) int64 token indices against int32, on 4
            # devices
            (sel,) = [op for op in ts.artifacts.prog.ops
                      if op.prim == "top_k" and op.params["k"] > 2]
            tsel = ts.artifacts.prog.types[sel.results[1]]
            assert tsel.dtype == "int64"
            extra = tsel.size * 4 / 4
            assert extra == 512
        assert tp.breakdown["peak_bytes"] == \
            jp.breakdown["peak_bytes"] + extra

    def test_reference_plan_json_loads_into_the_port(self, plans):
        _, _, _, jp, tp = plans
        loaded = ShardingPlan.from_json(jp.to_json())
        assert loaded.in_specs == tp.in_specs
        assert loaded.input_paths == tp.input_paths
        again = ShardingPlan.from_json(tp.to_json())
        assert again.as_dict() == tp.as_dict()


# a batch of one: the reduced 2x2 greedy prefill plans (S 64) in each
# dispatch mode and the decode plans (cache 32), both models
B1_CASES = [(a, k, m) for a in ARCHS for k, m in (
    ("prefill", "global"), ("prefill", "batch"), ("prefill", "local"),
    ("decode", "batch"))]


@pytest.fixture(scope="module", params=B1_CASES, ids=lambda c: "-".join(c))
def b1_plans(request):
    arch, kind, mode = request.param
    kw = dict(moe_dispatch=mode, moe_local_pools=4)
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    make = prefill_plans if kind == "prefill" else decode_plans
    return (request.param, *make(jcfg, tcfg, False, B=1))


class TestBatchOfOne:
    """At B 1 the ``vmap``'d combine keeps its lead dim as a batching dim
    (``ir._aten_scatter_add``), so the traced prefill and decode programs
    plan as the reference's: the same conflicts, colors, in-specs and
    communication bytes, the cost within 2%."""

    def test_identical_specs_counts_and_rules(self, b1_plans):
        _, js, ts, jp, tp = b1_plans
        assert tp.input_paths == jp.input_paths
        assert [tuple(s) for s in tp.in_specs] == \
            [tuple(s) for s in jp.in_specs]
        assert [tuple(s) for s in tp.out_specs] == \
            [tuple(s) for s in jp.out_specs]
        assert (tp.num_conflicts, tp.num_colors, tp.num_compat_sets,
                tp.num_resolution_bits) == \
            (jp.num_conflicts, jp.num_colors, jp.num_compat_sets,
             jp.num_resolution_bits)
        assert tp.logical_rules == jp.logical_rules
        assert io_color_labels(ts.artifacts.prog, ts.artifacts.nda) == \
            io_color_labels(js.artifacts.prog, js.artifacts.nda)

    def test_cost_within_2_percent_and_bytes_equal(self, b1_plans):
        _, _, _, jp, tp = b1_plans
        assert abs(tp.cost - jp.cost) <= COST_REL_TOL * jp.cost
        assert tp.breakdown["comm_bytes"] == jp.breakdown["comm_bytes"]
        assert abs(tp.breakdown["peak_bytes"] - jp.breakdown["peak_bytes"]) \
            <= COST_REL_TOL * jp.breakdown["peak_bytes"]

    def test_the_combine_is_one_scatter_add_with_equal_numbers(
            self, b1_plans):
        _, js, ts, _, _ = b1_plans
        names = ("top_k", "gather", "scatter-add")
        jops = prims(js.artifacts.prog, names)
        tops = prims(ts.artifacts.prog, names)
        assert [op.prim for op in tops] == [op.prim for op in jops]
        for j, t in zip(jops, tops):
            if t.prim != "top_k":
                assert tuple(tuple(int(i) for i in f)
                             for f in t.params["dimension_numbers"]) == \
                    tuple(tuple(int(i) for i in f)
                          for f in j.params["dimension_numbers"])


def prims(prog, names):
    return [op for op in prog.ops if op.prim in names]


class TestPrograms:
    def test_the_moe_prims_and_their_dimension_numbers(self, plans):
        _, js, ts, _, _ = plans
        jprog, tprog = js.artifacts.prog, ts.artifacts.prog
        names = ("top_k", "gather", "scatter-add")
        jops, tops = prims(jprog, names), prims(tprog, names)
        assert [op.prim for op in tops] == [op.prim for op in jops]
        assert [op.prim for op in tops].count("scatter-add") == 1
        for j, t in zip(jops, tops):
            assert [tprog.types[v].shape for v in t.results] == \
                [jprog.types[v].shape for v in j.results]
            if t.prim == "top_k":
                assert (t.params["k"], t.params["axis"]) == \
                    (j.params["k"], j.params["axis"])
                continue
            assert tuple(tuple(int(i) for i in f)
                         for f in t.params["dimension_numbers"]) == \
                tuple(tuple(int(i) for i in f)
                      for f in j.params["dimension_numbers"])



@pytest.mark.parametrize("mode", ["global", "batch", "local"])
@pytest.mark.parametrize("arch", ARCHS)
def test_the_blocks_differ_by_the_named_ops(arch, mode):
    """``moe_apply`` alone, in each dispatch mode: the reference's extra
    ops are the softmax's two and the index fix-ups; the port's extra ops
    are one_hot's iotas at their own shape and their broadcasts."""
    kw = dict(moe_dispatch=mode, moe_local_pools=2)
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    jp = JL.init_moe(jcfg, jax.random.PRNGKey(0))
    x = jnp.zeros((2, 8, jcfg.d_model), jnp.float32)
    jprog = jax_extract(lambda p, x: JL.moe_apply(jcfg, p, x), jp, x)
    tprog = extract_program(
        lambda p, x: L.moe_apply(tcfg, p, x),
        {k: torch.empty(v.shape, device="meta") for k, v in jp.items()},
        torch.empty(x.shape, device="meta"))

    def ops(prog):
        return collections.Counter(
            (op.prim, prog.types[op.results[0]].shape) for op in prog.ops)

    jops, tops = ops(jprog), ops(tprog)
    E, k = jcfg.num_experts, jcfg.experts_per_token
    by_prim = collections.Counter()
    for (prim, _), n in (jops - tops).items():
        by_prim[prim] += n
    # the softmax's max(-inf, .) and stop_gradient; one fix-up (lt, add,
    # select_n) for each of the two indices handed to jnp.take /
    # take_along_axis and .at[].add; one_hot's k iotas at (..., E)
    assert by_prim == {"max": 1, "stop_gradient": 1, "lt": 2, "add": 2,
                       "select_n": 2, "iota": k}
    (iota,) = {s for p, s in jops - tops if p == "iota"}
    assert iota == (1,) * (len(iota) - 1) + (E,)
    assert tops - jops == collections.Counter(
        {("iota", (E,)): k, ("broadcast_in_dim", iota): k})


@pytest.fixture(scope="module")
def fused():
    cfg = dataclasses.replace(get_config("arctic_480b").reduced(),
                              use_pallas=True)
    step = make_prefill_step(cfg)
    sess = Session(step, (T.param_specs(cfg), {
        "tokens": torch.empty((2, 64), dtype=torch.int32, device="meta")}))
    return cfg, step, sess


class TestFusedSites:
    def test_arctic_has_one_attention_site_for_all_layers(self, fused):
        cfg, _, sess = fused
        prog = sess.artifacts.prog
        idx = [i for i, op in enumerate(prog.ops)
               if op.prim.startswith("kernel:")]
        assert [prog.ops[i].prim for i in idx] == ["kernel:flash_attention"]
        assert prog.trip_counts[idx[0]] == cfg.num_layers
        assert T.kernel_sites(cfg) == {"flash_attention": (1, 0),
                                       "rg_lru": (0, 0)}
        mixtral = get_config("mixtral_8x22b")
        assert T.kernel_sites(mixtral) == {"flash_attention": (0, 0),
                                           "rg_lru": (0, 0)}

    def test_roles_match_the_registry(self, fused):
        _, _, sess = fused
        prog, nda = sess.artifacts.prog, sess.artifacts.nda
        op = next(op for op in prog.ops if op.prim.startswith("kernel:"))
        spec = registry.spec_for_prim(op.prim)
        colors: dict = {}
        for roles, vid in list(zip(spec.operand_roles, op.operands)) + \
                list(zip(spec.result_roles, op.results)):
            assert len(prog.types[vid].shape) == len(roles)
            for role, c in zip(roles, nda.colors_of_value(vid)):
                colors.setdefault(role, set()).add(c)
        assert all(len(c) == 1 for c in colors.values())
        assert colors["q_seq"] == colors["kv_seq"]

    def test_one_device_plan_picks_cuda_and_applies(self, fused):
        cfg, step, sess = fused
        plan = sess.partition(Request(mesh=MeshSpec(AXES, (1, 1))))
        assert [(r["site"], r["impl"]) for r in plan.kernel_sites] == \
            [("flash_attention:0", "cuda")]
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        batch = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (2, 64)).astype(np.int32))}
        got = plan.apply(step, device="cpu")(params, batch)
        torch.testing.assert_close(got, step(params, batch), rtol=0, atol=0)
        assert got.shape == (2, cfg.vocab_size)
