"""The port's plans of the ``recurrentgemma_2b`` prefill step against the
JAX package's.

Both packages' Sessions analyze the associative-scan (``use_pallas=False``)
prefill step, reduced and at full width on abstract / ``meta`` inputs,
and search a 2x2 mesh greedily under one explicit ``HardwareSpec``.  The
plans have identical ``in_specs``, ``out_specs``, conflicts, compat
sets, resolution bits and communication bytes, and the same number of
colors on live values (values an output depends on); the costs agree
within 2% relative.

What differs, and why: ``torch.export`` drops dead values from the
layer scan's body, while the reference's jaxpr keeps them — the a-half
of the associative scan's interleave at every level (the model uses
only h) and the convolution's unused decode state.  Each dead value
carries colors of its own and a buffer in the peak-memory sum, so the
reference counts more colors in all and a larger ``peak_bytes``;
neither reaches a sharding decision.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.api import Request as JRequest
from repro.api import Session as JSession
from repro.configs.base import get_config as jax_config
from repro.core.cost_model import HardwareSpec as JHardwareSpec
from repro.core.cost_model import MeshSpec as JMeshSpec
from repro.models import transformer as JT
from repro.train.steps import make_prefill_step as jax_prefill
from repro_torch.api import Request, Session
from repro_torch.configs import get_config
from repro_torch.core.cost_model import HardwareSpec, MeshSpec
from repro_torch.models import transformer as T
from repro_torch.train.steps import make_prefill_step

ARCH = "recurrentgemma_2b"
COST_REL_TOL = 0.02
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
AXES = ("data", "model")


def live_colors(prog, nda):
    """Colors of the values the outputs depend on (through ops and scan
    value links)."""
    producer = {r: op for op in prog.ops for r in op.results}
    linked: dict = {}
    for a, b, _ in prog.value_links:
        linked.setdefault(a, []).append(b)
        linked.setdefault(b, []).append(a)
    live, stack = set(), list(prog.outputs)
    while stack:
        v = stack.pop()
        if v in live:
            continue
        live.add(v)
        if v in producer:
            stack.extend(producer[v].operands)
        stack.extend(linked.get(v, ()))
    return {c for v in live for c in nda.colors_of_value(v)}


@pytest.fixture(scope="module", params=["reduced", "full"])
def plans(request):
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    if request.param == "reduced":
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    B, S = (4, 4096) if request.param == "full" else (2, 64)
    js = JSession(jax_prefill(jcfg), (JT.param_specs(jcfg), {
        "tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}))
    ts = Session(make_prefill_step(tcfg), (T.param_specs(tcfg), {
        "tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}))
    jp = js.partition(JRequest(mesh=JMeshSpec(AXES, (2, 2)),
                               hw=JHardwareSpec(**HW), backend="greedy"))
    tp = ts.partition(Request(mesh=MeshSpec(AXES, (2, 2)),
                              hw=HardwareSpec(**HW), backend="greedy"))
    return js, ts, jp, tp


class TestPlanParity:
    def test_identical_in_and_out_specs(self, plans):
        _, _, jp, tp = plans
        assert tp.input_paths == jp.input_paths
        assert [tuple(s) for s in tp.in_specs] == \
            [tuple(s) for s in jp.in_specs]
        assert [tuple(s) for s in tp.out_specs] == \
            [tuple(s) for s in jp.out_specs]

    def test_identical_analysis_counts(self, plans):
        _, _, jp, tp = plans
        assert tp.num_conflicts == jp.num_conflicts
        assert tp.num_compat_sets == jp.num_compat_sets
        assert tp.num_resolution_bits == jp.num_resolution_bits

    def test_same_colors_on_live_values(self, plans):
        js, ts, jp, tp = plans
        jart, tart = js.artifacts, ts.artifacts
        assert len(live_colors(tart.prog, tart.nda)) == \
            len(live_colors(jart.prog, jart.nda))
        # the dead values the reference keeps add colors of their own
        assert tp.num_colors < jp.num_colors

    def test_cost_within_tolerance(self, plans):
        _, _, jp, tp = plans
        assert abs(tp.cost - jp.cost) <= COST_REL_TOL * jp.cost
        assert tp.breakdown["comm_bytes"] == jp.breakdown["comm_bytes"]
        assert tp.breakdown["peak_bytes"] <= jp.breakdown["peak_bytes"]
