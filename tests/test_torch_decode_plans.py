"""The port's plans of the decode step against the JAX package's.

Both packages trace the decode step of ``qwen2_05b`` and
``recurrentgemma_2b`` (B = 4; cache 32 reduced, 256 at full width) from
their ``launch/specs.step_and_inputs``, and search a 2x2 mesh with the
serving launcher's request: greedy, ``min_dims=4``, the step's logical
names, and the KV cache pinned ``Replicate`` where the model has full
attention blocks (the hybrid has only local ones, so its request has no
constraint, in both packages), under one explicit ``HardwareSpec``.
The plans have identical input paths, ``in_specs``, ``out_specs``,
``logical_rules``, conflicts, compat sets, resolution bits, colors (all
of them and those on live values), color partition of the inputs' and
outputs' dims, and peak and communication bytes; the costs agree within
2% relative.

What differs, and why (by design, as in ``test_torch_slice.py``): the
reference's program carries ops the port's does not, and the port's
contractions emit their outputs in another dim order (a
``dot_general`` then a ``transpose``).  The reference's extra ops are
``jnp.remainder``'s sign fix-up and ``dynamic_update_slice``'s start
clamping, both on scalars (the port's ``%`` of a non-negative position
needs neither), ``jnp.take``'s negative-index fix-up of the (B, 1)
token ids, and the softmax's ``max(-inf, .)`` and ``stop_gradient``.
None carries a color of its own, so only the cost moves, well inside
the 2%.
"""

import collections
import dataclasses

import pytest

from repro.api import Replicate as JReplicate
from repro.api import Request as JRequest
from repro.api import Session as JSession
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jax_config
from repro.core.cost_model import HardwareSpec as JHardwareSpec
from repro.core.cost_model import MeshSpec as JMeshSpec
from repro.launch.specs import step_and_inputs as jax_step_and_inputs
from repro_torch.configs import get_config
from repro_torch.core.cost_model import HardwareSpec, MeshSpec
from repro_torch.core.partitioner import ShardingPlan
from repro_torch.launch import serve
from test_torch_core import io_color_labels
from test_torch_hybrid_plans import live_colors

COST_REL_TOL = 0.02
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
AXES = ("data", "model")
B = 4


def jax_request(cfg, names):
    """The reference serving launcher's request (``toast_decode_rules``) on a
    2x2 mesh with an explicit ``HardwareSpec``."""
    has_kv = "attn" in cfg.pattern and not cfg.is_encoder_decoder
    return JRequest(mesh=JMeshSpec(AXES, (2, 2)), hw=JHardwareSpec(**HW),
                    backend="greedy", min_dims=4, logical_axes=names,
                    constraints=(JReplicate("['k']"), JReplicate("['v']"))
                    if has_kv else ())


@pytest.fixture(scope="module", params=[
    ("qwen2_05b", "reduced"), ("qwen2_05b", "full"),
    ("recurrentgemma_2b", "reduced"), ("recurrentgemma_2b", "full")],
    ids=lambda p: "-".join(p))
def plans(request):
    arch, size = request.param
    jcfg, tcfg = jax_config(arch), get_config(arch)
    max_seq = 256
    if size == "reduced":
        jcfg, tcfg, max_seq = jcfg.reduced(), tcfg.reduced(), 32
    jfn, jargs, jnames = jax_step_and_inputs(
        jcfg, JShapeConfig("serve", max_seq, B, "decode"))
    js = JSession(jfn, jargs)
    jp = js.partition(jax_request(jcfg, jnames))
    ts, tnames = serve.decode_session(tcfg, B, max_seq)
    req = serve.decode_request(tcfg, tnames, MeshSpec(AXES, (2, 2)))
    tp = ts.partition(dataclasses.replace(req, hw=HardwareSpec(**HW)))
    return js, ts, jp, tp, req


class TestDecodePlanParity:
    def test_identical_in_and_out_specs(self, plans):
        _, _, jp, tp, _ = plans
        assert tp.input_paths == jp.input_paths
        assert [tuple(s) for s in tp.in_specs] == \
            [tuple(s) for s in jp.in_specs]
        assert [tuple(s) for s in tp.out_specs] == \
            [tuple(s) for s in jp.out_specs]

    def test_identical_analysis_counts(self, plans):
        _, _, jp, tp, _ = plans
        assert tp.num_conflicts == jp.num_conflicts
        assert tp.num_colors == jp.num_colors
        assert tp.num_compat_sets == jp.num_compat_sets
        assert tp.num_resolution_bits == jp.num_resolution_bits

    def test_same_colors_on_inputs_outputs_and_live_values(self, plans):
        js, ts, _, _, _ = plans
        jart, tart = js.artifacts, ts.artifacts
        assert io_color_labels(tart.prog, tart.nda) == \
            io_color_labels(jart.prog, jart.nda)
        assert len(live_colors(tart.prog, tart.nda)) == \
            len(live_colors(jart.prog, jart.nda))

    def test_identical_logical_rules(self, plans):
        _, _, jp, tp, _ = plans
        assert tp.logical_rules == jp.logical_rules
        assert tp.logical_rules

    def test_cost_within_tolerance(self, plans):
        _, _, jp, tp, _ = plans
        assert abs(tp.cost - jp.cost) <= COST_REL_TOL * jp.cost
        for key in ("peak_bytes", "comm_bytes"):
            assert tp.breakdown[key] == jp.breakdown[key]

    def test_the_plan_satisfies_the_serve_request(self, plans):
        _, _, jp, tp, req = plans
        assert tp.check(req.constraints)
        cfg_has_attn = bool(req.constraints)
        if cfg_has_attn:
            for path, spec in zip(tp.input_paths, tp.in_specs):
                if path.endswith("['k']") or path.endswith("['v']"):
                    assert all(e is None for e in spec), path
        loaded = ShardingPlan.from_json(jp.to_json())
        assert loaded.in_specs == tp.in_specs
        again = ShardingPlan.from_json(tp.to_json())
        assert again.as_dict() == tp.as_dict()

    def test_the_reference_extra_ops_are_the_named_ones(self, plans):
        js, ts, _, _, _ = plans

        def ops(prog):
            return collections.Counter(
                (op.prim, prog.types[op.results[0]].shape)
                for op in prog.ops)

        jops, tops = ops(js.artifacts.prog), ops(ts.artifacts.prog)
        # the port's extra ops: contractions in another output order
        assert {p for p, _ in tops - jops} <= {"dot_general"}
        for (prim, shape), _ in (jops - tops).items():
            known = (shape == () or prim in ("dot_general", "stop_gradient")
                     or (prim == "max" and len(shape) == 4)
                     or shape == (B, 1))
            assert known, (prim, shape)
