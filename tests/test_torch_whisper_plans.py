"""The port's plans of the ``whisper_small`` prefill and decode steps
against the JAX package's, and its fused attention sites.

Both packages trace the model from their ``launch/specs.step_and_inputs``
at reduced width (2 encoder and 2 decoder layers) and at full width and
full depth (12 + 12), on abstract / ``meta`` inputs: the prefill step at
B 4 x S 64 (reduced: 32 frames + 32 tokens) and 4 x 3000 (full: Whisper's
1500 frames, its 30-second window after the conv stem, + 1500 tokens),
the decode step at B 4 with a cache of 32 (reduced) and 256 (full)
against the encoder's output (16 and 128 frames).  The reference is
traced with ``use_pallas=False``, its default; so is the port.  Each plan
is a greedy search of a 2x2 mesh under one explicit ``HardwareSpec``, the
decode step's with the serving launcher's request (no cache pinned: the
reference pins none for an encoder-decoder).  The plans have identical
input paths, ``in_specs``, ``out_specs``, ``logical_rules``, conflicts,
compat sets, resolution bits, colors on live values, partitions of the
inputs' and outputs' dims, and communication and peak bytes; the costs
agree within 2% relative.  The prefill program holds two top-level
scans, the encoder's then the decoder's, each with its ``ScanRecord``;
the decoder body reads the encoder's result as a const.

What differs, and why (by design):

- The reference's cross-attention makes the keys' positions
  (``jnp.arange(T)[None, :]``) and, in decode, the query's
  (``pos[None, None]``) and hands them to a projection that reads
  neither (``use_rope=False``).  These dead values carry colors of their
  own: the reference counts 2 colors more (prefill) and 4 (decode), none
  of them on a live value.  The port makes no such value.
- As for every model (``tests/test_torch_decode_plans.py``): rank-0
  scalar fix-ups, ``jnp.take``'s negative-index fix-up of the token ids,
  the softmax's ``max(-inf, .)`` and ``stop_gradient``, the causal
  mask's ``+ 0`` offset, and the prefill's last-token ``dynamic_slice``
  (a ``slice`` in the port).

With ``use_pallas=True`` the port's prefill holds two
``kernel:flash_attention`` ops, the encoder's non-causal site first, the
decoder's causal one second, each instantiated once in its scan; the
one-device plan's decision for each lands on its own calls, and the
registry prices the non-causal site as the reference's registry does.
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
from repro.launch.specs import step_and_inputs as jax_step_and_inputs
from repro_torch.api import Request, Session
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import ir
from repro_torch.core.cost_model import HardwareSpec, MeshSpec
from repro_torch.core.partitioner import ShardingPlan
from repro_torch.kernels import registry
from repro_torch.launch import serve, specs
from repro_torch.models import transformer as T
from test_torch_core import io_color_labels
from test_torch_hybrid_plans import live_colors

ARCH = "whisper_small"
COST_REL_TOL = 0.02
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
AXES = ("data", "model")
B = 4
CASES = [(s, k) for s in ("reduced", "full") for k in ("prefill", "decode")]
SEQ = {("reduced", "prefill"): 64, ("full", "prefill"): 3000,
       ("reduced", "decode"): 32, ("full", "decode"): 256}


def configs(size):
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    if size == "reduced":
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    return jcfg, tcfg


def plans_for(size, kind):
    jcfg, tcfg = configs(size)
    seq = SEQ[size, kind]
    jfn, jargs, jnames = jax_step_and_inputs(
        jcfg, JShapeConfig("s", seq, B, kind))
    js = JSession(jfn, jargs)
    if kind == "prefill":
        tfn, targs, _ = specs.step_and_inputs(
            tcfg, ShapeConfig("s", seq, B, kind))
        ts = Session(tfn, targs)
        jp = js.partition(JRequest(mesh=JMeshSpec(AXES, (2, 2)),
                                   hw=JHardwareSpec(**HW), backend="greedy"))
        tp = ts.partition(Request(mesh=MeshSpec(AXES, (2, 2)),
                                  hw=HardwareSpec(**HW), backend="greedy"))
        return js, ts, jp, tp
    # the reference launcher's request: no cache pinned (has_kv is false
    # for an encoder-decoder)
    jp = js.partition(JRequest(
        mesh=JMeshSpec(AXES, (2, 2)), hw=JHardwareSpec(**HW),
        backend="greedy", min_dims=4, logical_axes=jnames))
    ts, tnames = serve.decode_session(tcfg, B, seq)
    req = serve.decode_request(tcfg, tnames, MeshSpec(AXES, (2, 2)))
    assert req.constraints == ()
    tp = ts.partition(dataclasses.replace(req, hw=HardwareSpec(**HW)))
    return js, ts, jp, tp


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def plans(request):
    return (request.param, *plans_for(*request.param))


def ops(prog):
    return collections.Counter((op.prim, prog.types[op.results[0]].shape)
                               for op in prog.ops)


def dead_positions(size, kind):
    """The reference's unused cross-attention positions: the keys'
    ``arange(T)[None, :]`` and, in decode, the query's
    ``pos[None, None]``."""
    T_enc = SEQ[size, kind] // 2
    if kind == "decode":
        T_enc = min(1500, T_enc)
    dead = {("iota", (T_enc,)): 1, ("broadcast_in_dim", (1, T_enc)): 1}
    if kind == "decode":
        dead[("broadcast_in_dim", (1, 1))] = 1
    return collections.Counter(dead)


class TestPlanParity:
    def test_identical_in_and_out_specs(self, plans):
        _, _, _, jp, tp = plans
        assert tp.input_paths == jp.input_paths
        assert [tuple(s) for s in tp.in_specs] == \
            [tuple(s) for s in jp.in_specs]
        assert [tuple(s) for s in tp.out_specs] == \
            [tuple(s) for s in jp.out_specs]
        assert any("['cross']['wo']" in p for p in tp.input_paths)

    def test_identical_analysis_counts(self, plans):
        (_, kind), _, _, jp, tp = plans
        assert tp.num_conflicts == jp.num_conflicts
        assert tp.num_compat_sets == jp.num_compat_sets
        assert tp.num_resolution_bits == jp.num_resolution_bits
        # the reference's dead cross-attention positions (module docstring)
        assert jp.num_colors - tp.num_colors == \
            (2 if kind == "prefill" else 4)

    def test_same_colors_on_inputs_outputs_and_live_values(self, plans):
        _, js, ts, jp, tp = plans
        jart, tart = js.artifacts, ts.artifacts
        assert io_color_labels(tart.prog, tart.nda) == \
            io_color_labels(jart.prog, jart.nda)
        jlive = live_colors(jart.prog, jart.nda)
        assert len(live_colors(tart.prog, tart.nda)) == len(jlive)
        # every color the reference has beyond the port's is dead
        assert len(jlive) <= tp.num_colors

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


class TestPrograms:
    def test_the_programs_differ_by_the_named_ops(self, plans):
        (size, kind), js, ts, _, _ = plans
        jops, tops = ops(js.artifacts.prog), ops(ts.artifacts.prog)
        seq = SEQ[size, kind]
        tokens = (B, 1) if kind == "decode" else (B, seq // 2)
        extra = jops - tops
        dead = dead_positions(size, kind)
        assert extra & dead == dead
        for (prim, shape), _ in (extra - dead).items():
            known = (shape == () or prim in ("stop_gradient",
                                             "dynamic_slice")
                     or (prim == "max" and len(shape) == 4)
                     or shape == tokens
                     or (prim == "add" and shape == (seq // 2, 1)))
            assert known, (prim, shape)
        if kind == "prefill":
            assert {p for p, _ in tops - jops} == {"slice"}
        else:
            assert not tops - jops

    def test_two_top_level_scans_in_prefill(self):
        _, tcfg = configs("reduced")
        fn, targs, _ = specs.step_and_inputs(
            tcfg, ShapeConfig("s", SEQ["reduced", "prefill"], B, "prefill"))
        ep, leaves, _ = ir.export_graph(fn, targs)
        ex = ir._Extractor()
        ex.walk(ep.graph_module, [ex.prog.new_value(x.shape, x.dtype)
                                  for x in leaves])
        enc, dec = ex.scans
        assert (enc.length, dec.length) == \
            (tcfg.encoder_layers, T.n_scan_blocks(tcfg))
        assert enc.hi <= dec.lo
        # a const of the decoder's body is the encoder's output, computed
        # (enc_ln) from the encoder scan's result
        producer = {r: op for op in ex.prog.ops for r in op.results}
        reached, stack = set(), [c for c in dec.consts if c in producer]
        while stack:
            v = stack.pop()
            if v in reached:
                continue
            reached.add(v)
            if v in producer:
                stack.extend(producer[v].operands)
        assert enc.results[0] in reached
        trips = {ex.prog.trip_counts[i] for i in range(enc.lo, enc.hi)}
        assert trips == {tcfg.encoder_layers}


# -- fused sites ----------------------------------------------------------


@pytest.fixture(scope="module")
def fused():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), num_layers=4,
                              use_pallas=True)
    fn, args, _ = specs.step_and_inputs(cfg, ShapeConfig("s", 300, 2,
                                                         "prefill"))
    return cfg, fn, Session(fn, args)


class TestFusedSites:
    def test_encoder_site_first_then_the_decoders(self, fused):
        cfg, _, sess = fused
        prog = sess.artifacts.prog
        idx = [i for i, op in enumerate(prog.ops)
               if op.prim.startswith("kernel:")]
        assert [prog.ops[i].params for i in idx] == [
            {"kernel": "flash_attention", "causal": False},
            {"kernel": "flash_attention", "causal": True}]
        assert [prog.trip_counts[i] for i in idx] == \
            [cfg.encoder_layers, cfg.num_layers]
        # the encoder's 150 frames, the decoder's 150 tokens
        assert [prog.types[prog.ops[i].operands[0]].shape for i in idx] == \
            [(2, 150, 4, 16)] * 2

    def test_roles_match_the_registry(self, fused):
        _, _, sess = fused
        prog, nda = sess.artifacts.prog, sess.artifacts.nda
        spec = registry.spec_for_prim("kernel:flash_attention")
        seqs = []
        for op in prog.ops:
            if op.prim != spec.prim:
                continue
            colors: dict = {}
            for roles, vid in list(zip(spec.operand_roles, op.operands)) + \
                    list(zip(spec.result_roles, op.results)):
                assert len(prog.types[vid].shape) == len(roles)
                for role, c in zip(roles, nda.colors_of_value(vid)):
                    colors.setdefault(role, set()).add(c)
            assert all(len(c) == 1 for c in colors.values())
            assert colors["q_seq"] == colors["kv_seq"]
            seqs.append(colors["q_seq"])
        # the frames' and the tokens' sequences are distinct dims
        assert len(seqs) == 2 and seqs[0] != seqs[1]

    def test_each_site_decision_lands_on_its_own_calls(self, fused,
                                                       monkeypatch):
        cfg, fn, sess = fused
        plan = sess.partition(Request(mesh=MeshSpec(AXES, (1, 1))))
        assert [(r["site"], r["impl"]) for r in plan.kernel_sites] == \
            [("flash_attention:0", "cuda"), ("flash_attention:1", "cuda")]
        # the encoder's site on the plain version, the decoder's on the
        # kernel: each call must take its own site's decision
        plain = ShardingPlan.from_dict({**plan.as_dict(), "kernel_sites": [
            {**r, "impl": "ref" if r["site"].endswith(":0") else "cuda"}
            for r in plan.kernel_sites]})
        calls = []
        from repro_torch.kernels import ops as kops
        resolve = kops._resolve

        def recorded(kernel):
            site, impl = resolve(kernel)
            calls.append((site, impl))
            return site, impl

        monkeypatch.setattr(kops, "_resolve", recorded)
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        rng = np.random.default_rng(2)
        batch = {"frames": torch.from_numpy(rng.standard_normal(
                     (2, 150, cfg.d_model)).astype(np.float32)),
                 "tokens": torch.from_numpy(rng.integers(
                     0, cfg.vocab_size, (2, 150)).astype(np.int32))}
        got = plain.apply(fn, device="cpu")(params, batch)
        assert calls == [("flash_attention:0", "ref")] * cfg.encoder_layers \
            + [("flash_attention:1", "cuda")] * cfg.num_layers
        torch.testing.assert_close(got, fn(params, batch), rtol=0, atol=0)

    @pytest.mark.parametrize("causal", [False, True])
    def test_registry_prices_whispers_sites_as_the_reference(self, causal):
        # (4, 1500, 12, 64): the encoder's site (non-causal) and the
        # decoder's (causal); the port's 128-row tiles and the reference's
        # 125-row blocks cut 1500 into 12 each
        dims = {"batch": 4, "q_seq": 1500, "kv_seq": 1500, "heads": 12,
                "head_dim": 64}
        p = {"causal": causal}
        spec, jspec = registry.KERNELS["flash_attention"], \
            jregistry.KERNELS["flash_attention"]
        assert jregistry.pick_block(1500, 128) == 125
        assert spec.flops(dims, p) == jspec.flops(dims, p)
        assert spec.bytes_moved("cuda", dims, p, 2) == \
            jspec.bytes_moved("pallas", dims, p, 2)
        assert spec.bytes_moved("ref", dims, p, 2) == \
            jspec.bytes_moved("ref", dims, p, 2)
        assert spec.feasible("cuda", dims) and \
            jspec.feasible("pallas", dims)
        flops = spec.flops(dims, p)
        assert flops == (13.824e9 if causal else 27.648e9)
