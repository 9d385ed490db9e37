"""The MoE models on 2x4 meshes of eight gloo ranks (CPU), on the port's
plans and on the reference's (JSON from the JAX package), against the
unsharded runs.

Reduced f32 ``mixtral_8x22b`` and ``arctic_480b`` (4 experts, top-2),
plans searched greedily under one explicit ``HardwareSpec`` by both
packages' ``Session`` and read by the port's ``ShardingPlan.from_json``:

- *A plan that shards the experts against the batch.*  Mixtral's
  prefill (batch dispatch, B 4 x S 64, ``use_pallas``) on 2x4.  Left to
  itself the search puts the expert stacks and the tokens' batch on the
  same axis (``data``), so both requests pin them apart: the tokens'
  batch on ``model`` and the expert dim of ``wi``, ``wgate`` and ``wo``
  on ``data``.  Every token then has to reach experts that another rank
  holds.  Logits within 1e-4 of the unsharded run, on both plans, and no
  expert stack gathered whole.
- *Decode.*  Each model's decode step on the 2x4 plan of the serving
  launcher's request (the KV cache pinned replicated), the port's and
  the reference's, 8 steps through ``serve_loop`` (4 prompt tokens, 4
  generating steps): tokens exact, prompt logits within 1e-4 of one
  process.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.api import Pin as JPin
from repro.api import Replicate as JReplicate
from repro.api import Request as JRequest
from repro.api import Session as JSession
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jax_config
from repro.core.cost_model import HardwareSpec as JHardwareSpec
from repro.core.cost_model import MeshSpec as JMeshSpec
from repro.launch import specs as jspecs
from repro_torch.api import Pin, Request, Session
from repro_torch.configs import get_config
from repro_torch.core.cost_model import HardwareSpec, MeshSpec
from repro_torch.core.partitioner import ShardingPlan
from repro_torch.launch import mesh as M
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.train.steps import make_decode_step, make_prefill_step
from test_torch_moe_mesh import expert_gathers

TOL = 1e-4
RANKS_TIMEOUT = 240.0
AXES = ("data", "model")
SHAPE = (2, 4)
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
B, S = 4, 64
ARCHS = ("mixtral_8x22b", "arctic_480b")
# decode: prompts, prompt tokens, generated tokens (8 decode steps)
DB, DP, DG = 4, 4, 5
STACKS = ("wi", "wgate", "wo")
# the experts against the batch: each pin in both packages' spelling
PINS = [("[0][1]['tokens']", ("model", None))] + [
    (f"['ffn']['{k}']", (None, "data", None, None)) for k in STACKS]


def prefill_config():
    return dataclasses.replace(get_config("mixtral_8x22b").reduced(),
                               use_pallas=True)


def prefill_plans():
    """The port's and the reference's pinned 2x4 prefill plans."""
    jcfg = dataclasses.replace(jax_config("mixtral_8x22b").reduced(),
                               use_pallas=True)
    jfn, jargs, _ = jspecs.step_and_inputs(
        jcfg, JShapeConfig("t", S, B, "prefill"))
    jp = JSession(jfn, jargs).partition(JRequest(
        mesh=JMeshSpec(AXES, SHAPE), hw=JHardwareSpec(**HW),
        backend="greedy", constraints=tuple(JPin(t, s) for t, s in PINS)))
    cfg = prefill_config()
    tp = Session(make_prefill_step(cfg), (T.param_specs(cfg), {
        "tokens": torch.empty((B, S), dtype=torch.int32, device="meta")})
    ).partition(Request(mesh=MeshSpec(AXES, SHAPE), hw=HardwareSpec(**HW),
                        backend="greedy",
                        constraints=tuple(Pin(t, s) for t, s in PINS)))
    return {"port": tp, "reference": ShardingPlan.from_json(jp.to_json())}


def decode_plans(arch):
    """The port's and the reference's 2x4 decode plans with the serving
    launcher's request."""
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jfn, jargs, jnames = jspecs.step_and_inputs(
        jcfg, JShapeConfig("serve", DP + DG, DB, "decode"))
    has_kv = "attn" in jcfg.pattern
    jp = JSession(jfn, jargs).partition(JRequest(
        mesh=JMeshSpec(AXES, SHAPE), hw=JHardwareSpec(**HW),
        backend="greedy", min_dims=4, logical_axes=jnames,
        constraints=(JReplicate("['k']"), JReplicate("['v']"))
        if has_kv else ()))
    sess, names = serve.decode_session(cfg, DB, DP + DG)
    tp = sess.partition(dataclasses.replace(serve.decode_request(
        cfg, names, MeshSpec(AXES, SHAPE)), hw=HardwareSpec(**HW)))
    return {"port": tp, "reference": ShardingPlan.from_json(jp.to_json())}


def eight_ranks(rank, prefill, decode):
    """Each prefill and decode plan (JSON) against the unsharded step."""
    cfg = prefill_config()
    fn = make_prefill_step(cfg)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    want = fn(params, {"tokens": tokens})
    out = {"prefill": {}, "decode": {}}
    for name, text in prefill.items():
        applied = ShardingPlan.from_json(text).apply(fn, device="cpu")
        with M.collective_tally() as tally:
            got = applied(params, {"tokens": tokens})
        out["prefill"][name] = {
            "error": (got.full_tensor() - want).abs().max().item(),
            "scale": want.abs().max().item(),
            "expert_gathers": expert_gathers(tally.shapes, cfg)}
    for arch, texts in decode.items():
        dcfg = get_config(arch).reduced()
        dec = make_decode_step(dcfg)
        dparams = T.init_params(dcfg, torch.Generator().manual_seed(0),
                                device="cpu")
        prompts = torch.from_numpy(np.random.default_rng(1).integers(
            0, dcfg.vocab_size, (DB, DP)).astype(np.int32))
        one = serve.serve_loop(dec, dparams, T.init_cache(
            dcfg, DB, DP + DG, device="cpu"), prompts, DG)
        for name, text in texts.items():
            got = serve.serve_loop(
                ShardingPlan.from_json(text).apply(dec, device="cpu"),
                dparams, T.init_cache(dcfg, DB, DP + DG, device="cpu"),
                prompts, DG)
            out["decode"][arch, name] = {
                "tokens": torch.equal(got.tokens.full_tensor(), one.tokens),
                "steps": DP + len(got.step_ms),
                "error": (got.prompt_logits.full_tensor() -
                          one.prompt_logits).abs().max().item(),
                "scale": one.prompt_logits.abs().max().item()}
    return out


@pytest.fixture(scope="module")
def plans():
    return {"prefill": prefill_plans(),
            "decode": {arch: decode_plans(arch) for arch in ARCHS}}


@pytest.fixture(scope="module")
def ranks(plans):
    return M.run_ranks(
        eight_ranks, 8, {k: p.to_json() for k, p in plans["prefill"].items()},
        {arch: {k: p.to_json() for k, p in ps.items()}
         for arch, ps in plans["decode"].items()}, timeout=RANKS_TIMEOUT)


def spec_of(plan, suffix):
    return next(tuple(s) for p, s in zip(plan.input_paths, plan.in_specs)
                if p.endswith(suffix))


@pytest.mark.parametrize("name", ["port", "reference"])
def test_the_plan_shards_the_experts_against_the_batch(plans, name):
    """Pinned: the expert stacks' expert dim on ``data``, the tokens'
    batch on ``model``; the plans agree on every input."""
    plan = plans["prefill"][name]
    assert spec_of(plan, "['tokens']")[0] == "model"
    for k in STACKS:
        assert spec_of(plan, f"['ffn']['{k}']")[1] == "data"
    port = plans["prefill"]["port"]
    assert plan.input_paths == port.input_paths


@pytest.mark.parametrize("name", ["port", "reference"])
def test_prefill_equals_unsharded(ranks, name):
    for r in ranks:
        res = r["prefill"][name]
        assert res["error"] <= TOL * max(1.0, res["scale"]), res["error"]
        assert res["expert_gathers"] == {}


@pytest.mark.parametrize("name", ["port", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_plans_equal_one_process(ranks, arch, name):
    for r in ranks:
        res = r["decode"][arch, name]
        assert res["tokens"] and res["steps"] == 8
        assert res["error"] <= TOL * max(1.0, res["scale"]), res["error"]
