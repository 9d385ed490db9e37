"""The port's train programs and plans of the frontend models against
the JAX package's: ``whisper_small`` and ``phi3_vision``.

Both packages trace the train step (``launch.specs``'s train cell: the
default ``AdamConfig``, one microbatch, the batch split as the specs
split it) on abstract / ``meta`` inputs with ``use_pallas=False``, and
search a 2x2 mesh greedily under one explicit ``HardwareSpec``:

- whisper at its stock reduced size (2 encoder and 2 decoder layers),
  B 2 x S 32 (16 frames + 16 tokens), remat off and on; at full width
  and depth (12 + 12 layers), B 4 x S 3000 (1500 frames + 1500 tokens),
  remat on (the config's own);
- phi3_vision at its stock reduced size (2 layers, 8 patches), B 2 x S
  32, no remat; at full width and depth (32 layers), B 4 x S 2048 (576
  patches + 1472 tokens), remat on.

*Programs.*  Whisper's encoder scan and decoder scan each run forward and
backward; the decoder's backward scan carries the gradient of its
constant, the encoder's output, from zeros across the layers, and the
encoder's backward scan takes it (through ``enc_ln``) as its carry's
cotangent.  Every (prim, trip count) pair occurs as often as in the
reference's program but for the named differences below.

*Plans.*  Identical input paths, ``in_specs``, ``out_specs``, logical
rules, conflicts, compat sets, resolution bits and communication bytes;
the cost, FLOPs and peak bytes within 2%; colors a few apart.

*By design, not copied* (ROADMAP queue 3): the reference's loss head
keeps dead ops and ``jnp.take``'s index fix-ups; its attention keeps
the softmax's ``max(-inf, .)`` and ``stop_gradient`` and a dead
position ``add`` (hoisted, and recomputed with a rank-0 convert under
remat), each of rank 0 or on values nothing reads; the port's loss
head scales by one ``mul``.

*Fused sites.*  With ``use_pallas`` every attention is one
``kernel:flash_attention`` op forward (whisper's encoder non-causal, its
decoder causal), one recomputed under remat, and one
``kernel:flash_attention_bwd`` of the same causality back, with the
registry's roles; under remat the backward reads the recomputed site's
q, k and v.
The one-device plan runs the step with the ``"cuda"`` impl (on CPU
tensors the plain version, so the applied step equals the unapplied
one).  The reference's jax 0.9 trace records no fused sites (ROADMAP
queue 3).
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import Request as JRequest
from repro.api import Session as JSession
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jax_config
from repro.core.cost_model import HardwareSpec as JHardwareSpec
from repro.core.cost_model import MeshSpec as JMeshSpec
from repro.kernels import registry as jregistry
from repro.launch import specs as jspecs
from repro_torch import pytree
from repro_torch.api import Request, Session
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.cost_model import HardwareSpec, MeshSpec
from repro_torch.kernels import registry
from repro_torch.launch import specs
from repro_torch.models import transformer as T
from repro_torch.train import steps as S

COST_REL_TOL = 0.02
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
AXES = ("data", "model")
# case -> (arch, full, B, S, remat)
CASES = {
    "whisper-reduced": ("whisper_small", False, 2, 32, False),
    "whisper-reduced-remat": ("whisper_small", False, 2, 32, True),
    "whisper-full": ("whisper_small", True, 4, 3000, True),
    "phi3-reduced": ("phi3_vision", False, 2, 32, False),
    "phi3-full": ("phi3_vision", True, 4, 2048, True),
}
# the loss head's differences, the same in every train program
LOSS_HEAD = collections.Counter({
    ("lt", 1): 2, ("add", 1): 2, ("select_n", 1): 4,
    ("broadcast_in_dim", 1): 5, ("eq", 1): 2, ("div", 1): 1, ("max", 1): 3,
    ("stop_gradient", 1): 1, ("sign", 1): 1, ("convert_element_type", 1): 3})


def configs(case, use_pallas=False):
    arch, full, _, _, remat = CASES[case]
    jc, tc = jax_config(arch), get_config(arch)
    if not full:
        jc, tc = jc.reduced(), tc.reduced()
    return (dataclasses.replace(jc, remat=remat),
            dataclasses.replace(tc, remat=remat, use_pallas=use_pallas))


def cells(case, use_pallas=False):
    jc, tc = configs(case, use_pallas)
    _, _, B, L, _ = CASES[case]
    return (jspecs.step_and_inputs(jc, JShapeConfig("t", L, B, "train")),
            specs.step_and_inputs(tc, ShapeConfig("t", L, B, "train")))


@pytest.fixture(scope="module", params=sorted(CASES))
def plans(request):
    case = request.param
    (jfn, jargs, _), (tfn, targs, _) = cells(case)
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
        # per self- or cross-attention the softmax's max and
        # stop_gradient, in the forward body and again when recomputed;
        # the hoisted dead position add and its attention mask's convert
        attn = n * (1 + cfg.is_encoder_decoder) + cfg.encoder_layers
        per_body = (attn // n) * (1 + cfg.remat)
        named = LOSS_HEAD + collections.Counter({
            ("max", n): per_body, ("stop_gradient", n): per_body,
            ("add", 1): 1, ("convert_element_type", 1): 1})
        if cfg.remat:
            named += collections.Counter({("add", n): 1,
                                          ("convert_element_type", n): 1})
        assert want - got == named
        assert got - want == collections.Counter({("mul", 1): 1})

    def test_forward_and_backward_bodies(self, plans):
        case, _, ts, _, _ = plans
        cfg = configs(case)[1]
        prog = ts.artifacts.prog
        n = T.n_scan_blocks(cfg)
        assert set(prog.trip_counts.values()) == {1, n}
        body = [i for i in range(len(prog.ops)) if prog.trip_counts[i] == n]
        runs = sum(1 for a, b in zip(body, body[1:]) if b != a + 1) + 1
        # whisper: the encoder's and the decoder's forward, then their
        # backward in reverse order
        assert runs == (4 if cfg.is_encoder_decoder else 2)

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


# -- fused sites --------------------------------------------------------------


FUSED = ["whisper-reduced-remat", "phi3-reduced"]


@pytest.fixture(scope="module", params=FUSED)
def fused(request):
    case = request.param
    cfg = configs(case, use_pallas=True)[1]
    _, (fn, args, _) = cells(case, use_pallas=True)
    return cfg, fn, Session(fn, args)


def test_fused_sites_follow_the_registry(fused):
    cfg, _, sess = fused
    prog, nda = sess.artifacts.prog, sess.artifacts.nda
    kops = [(i, op) for i, op in enumerate(prog.ops)
            if op.prim.startswith("kernel:")]
    fwd, bwd = "kernel:flash_attention", "kernel:flash_attention_bwd"
    n = T.n_scan_blocks(cfg)
    if cfg.is_encoder_decoder:
        # forward: the encoder's (non-causal), the decoder's; backward:
        # the decoder's recomputed site and its backward, then the
        # encoder's
        want = [(fwd, False), (fwd, True), (fwd, True), (bwd, True),
                (fwd, False), (bwd, False)]
    else:
        want = [(fwd, True), (bwd, True)]
    assert [(op.prim, op.params["causal"]) for _, op in kops] == want
    assert {prog.trip_counts[i] for i, _ in kops} == {n}
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
    # under remat each backward reads the q, k, v of the recomputed site
    # before it (without remat, their stacked residuals)
    for (_, a), (_, b) in zip(kops, kops[1:]):
        if b.prim == bwd:
            assert (b.operands[:3] == a.operands) == cfg.remat


def test_one_device_plan_runs_the_train_step(fused):
    cfg, fn, sess = fused
    plan = sess.partition(Request(mesh=MeshSpec(AXES, (1, 1))))
    sites = plan.kernel_sites
    assert {r["impl"] for r in sites} == {"cuda"}
    assert len(sites) == (4 if cfg.is_encoder_decoder else 1)
    state = S.init_train_state(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    rng = np.random.default_rng(1)
    spec, _ = specs.batch_specs(cfg, ShapeConfig("t", 32, 2, "train"))
    batch = {k: torch.from_numpy(
        rng.integers(0, cfg.vocab_size, tuple(v.shape)).astype(np.int32)
        if v.dtype == torch.int32 else
        rng.standard_normal(tuple(v.shape)).astype(np.float32))
        for k, v in spec.items()}
    got = plan.apply(fn, device="cpu")(state, batch)
    want = fn(state, batch)
    assert len(pytree.tree_leaves(got)) == len(plan.out_specs)
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_registry_prices_the_backward_sites_as_the_reference(causal):
    # whisper's (4, 1500, 12, 64) backward sites, non-causal (encoder)
    # and causal (decoder): the plain vjp ("ref"), the only impl in both
    # packages
    dims = {"batch": 4, "q_seq": 1500, "kv_seq": 1500, "heads": 12,
            "head_dim": 64}
    p = {"causal": causal}
    spec, jspec = registry.KERNELS["flash_attention_bwd"], \
        jregistry.KERNELS["flash_attention_bwd"]
    assert spec.impls == jspec.impls == ("ref",)
    assert spec.flops(dims, p) == jspec.flops(dims, p) == \
        2.5 * (13.824e9 if causal else 27.648e9)
    assert spec.bytes_moved("ref", dims, p, 2) == \
        jspec.bytes_moved("ref", dims, p, 2)
