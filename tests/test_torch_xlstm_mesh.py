"""The reduced ``xlstm_350m`` on (1, 2) and 2x2 gloo meshes against one
process: prefill and decode through ``plan.apply``, and the serving
launcher on two ranks.

The model is the reduced f32 config at 8 layers (one scanned period of 7
mLSTM blocks and an sLSTM) and 16 (two periods), so that an sLSTM runs.
On DTensors the sLSTM's time loop runs per shard
(``sharding.scan_per_shard``): one ``local_map`` region around the whole
loop, the batch and the heads kept as the plan put them, the time dim
and ``R``'s ``hd`` and gate dims made whole once, before the loop.

Plans of the prefill step (B 4 x S 32), each searched greedily under one
explicit ``HardwareSpec``: the port's (its ``Session``) and the
reference's (the JAX package's ``Session``, its JSON read by the port)
for (1, 2) and 2x2, and on (1, 2) three plans pinned by ``Pin``
constraints: the sLSTM's heads sharded (``R`` on its head dim, ``W`` on
its gate outputs, the tokens whole), ``R``'s contracted ``hd`` sharded
(made whole before the loop, counted), and the sequence sharded with the
sLSTM's weights and the embedding table whole, so that the gates' input
products reach the loop sequence-sharded (the time dim made whole,
counted), besides a batch-sharded plan.  Decode (16
layers on (1, 2), 8 on 2x2): the serving launcher's plan
(``serve.decode_plan``), and on 2x2 the reference's from the same
request, over 4 prompt and 5 generated tokens.  Every output leaf within 1e-4 of one process (relative to the
largest, at least 1), the tokens exact.

The sLSTM's loop issues no collective and no redistribution per step:
the same plan applied at S 32 and at S 64 dispatches the same DTensor
ops (``launch.mesh.dtensor_ops``) and the same collectives.

The helpers here (``family_config``, ``seeded_inputs``, the plan
searches and ``apply_rank``) serve the frontend models' mesh tests too.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import pytree
from repro_torch.api import Pin, Request, Session
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.cost_model import HardwareSpec, MeshSpec
from repro_torch.core.partitioner import ShardingPlan
from repro_torch.launch import mesh as M
from repro_torch.launch import serve, specs

ARCH = "xlstm_350m"
AXES = ("data", "model")
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
TOL = 1e-4
RANKS_TIMEOUT = 300.0
B, S = 4, 32
# decode: prompts, prompt tokens, generated tokens; the layer counts
# served on each mesh
SB, SP, GEN = 4, 4, 5
DECODE = {"1x2": (16,), "2x2": (8,)}
SLSTM = "[0][0]['layers'][7]['mix']"
PINS = {
    "heads": {f"{SLSTM}['R']": (None, "model", None, None),
              f"{SLSTM}['W']": (None, None, "model"),
              "[0][1]['tokens']": (None, None)},
    "hd": {f"{SLSTM}['R']": (None, None, "model", None),
           "[0][1]['tokens']": (None, None)},
    "seq": {"[0][1]['tokens']": (None, "model"),
            "[0][0]['embed']": (None, None),
            f"{SLSTM}['W']": (None, None, None),
            f"{SLSTM}['R']": (None, None, None, None)},
    "batch": {"[0][1]['tokens']": ("model", None)},
}


def family_config(arch, layers=None, remat=False):
    """The reduced f32 config of ``arch``, at ``layers`` layers (``None``:
    the reduced config's), ``remat`` set; the frontend models with their
    kernel sites (``use_pallas``: on CPU tensors the kernels' plain
    versions, under ``local_map`` on a mesh)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=remat)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if cfg.is_encoder_decoder or cfg.frontend:
        cfg = dataclasses.replace(cfg, use_pallas=True)
    return cfg


def cell(arch, layers, kind, b, s, remat=False):
    """``(cfg, step, meta args)`` of one cell (``launch.specs``)."""
    cfg = family_config(arch, layers, remat)
    fn, args, _ = specs.step_and_inputs(cfg, ShapeConfig("t", s, b, kind))
    return cfg, fn, args


@functools.lru_cache(maxsize=None)
def port_session(arch, layers, kind, b, s):
    return Session(*cell(arch, layers, kind, b, s)[1:])


def port_plan(arch, layers, kind, b, s, mesh, pins=None):
    """The port's greedy plan of a cell for ``mesh`` under ``HW``."""
    return port_session(arch, layers, kind, b, s).partition(Request(
        mesh=MeshSpec(AXES, mesh), hw=HardwareSpec(**HW), backend="greedy",
        constraints=tuple(Pin(p, v) for p, v in (pins or {}).items())))


def reference_plan(arch, layers, kind, b, s, mesh) -> str:
    """The reference's greedy plan of the same cell (its own ``Session``),
    as JSON."""
    from repro.api import Request as JRequest
    from repro.api import Session as JSession
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.configs.base import get_config as jax_config
    from repro.core.cost_model import HardwareSpec as JHardwareSpec
    from repro.core.cost_model import MeshSpec as JMeshSpec
    from repro.launch import specs as jspecs
    jc = jax_config(arch).reduced()
    if layers is not None:
        jc = dataclasses.replace(jc, num_layers=layers)
    jfn, jargs, _ = jspecs.step_and_inputs(jc, JShapeConfig("t", s, b, kind))
    return JSession(jfn, jargs).partition(JRequest(
        mesh=JMeshSpec(AXES, mesh), hw=JHardwareSpec(**HW),
        backend="greedy")).to_json()


@functools.lru_cache(maxsize=None)
def decode_session(arch, layers):
    return serve.decode_session(family_config(arch, layers), SB, SP + GEN)


def decode_plans(arch, layers, n_dev, reference=True) -> dict:
    """The serving launcher's decode plan for ``n_dev`` devices and, with
    ``reference``, the reference's from the same request, as JSON."""
    from repro.api import Request as JRequest
    from repro.api import Session as JSession
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.configs.base import get_config as jax_config
    from repro.core.cost_model import MeshSpec as JMeshSpec
    from repro.launch import specs as jspecs
    cfg = family_config(arch, layers)
    mesh = (max(1, n_dev // 2), min(2, n_dev))
    sess, names = decode_session(arch, layers)
    # serve.decode_plan's search, on a session traced once
    port = sess.partition(serve.decode_request(cfg, names,
                                               MeshSpec(AXES, mesh)))
    if not reference:
        return {"port": port.to_json()}
    jc = jax_config(arch).reduced()
    if layers is not None:
        jc = dataclasses.replace(jc, num_layers=layers)
    jfn, jargs, names = jspecs.step_and_inputs(
        jc, JShapeConfig("serve", SP + GEN, SB, "decode"))
    ref = JSession(jfn, jargs).partition(JRequest(
        mesh=JMeshSpec(AXES, mesh), backend="greedy", min_dims=4,
        logical_axes=names))
    return {"port": port.to_json(), "reference": ref.to_json()}


def seeded_inputs(cfg, kind, args):
    """A cell's inputs on the CPU: the weights (or the train state) from
    torch generator 0, the batch from numpy seed 1 (token ids; frames
    and patch embeddings standard normal)."""
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as St
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(1)
    batch = {}
    for k, v in args[1].items():
        if v.dtype == torch.int32:
            batch[k] = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, tuple(v.shape)).astype(np.int32))
        else:
            batch[k] = torch.from_numpy(rng.standard_normal(
                tuple(v.shape)).astype(np.float32))
    if kind == "train":
        return St.init_train_state(cfg, gen, device="cpu"), batch
    return T.init_params(cfg, gen, device="cpu"), batch


class Recorded:
    """While open, records the local shapes each per-shard sLSTM loop
    runs on (``scans``), each attention site's local call, causal or
    not (``sites``: (causal, q's shape)), and the placements of the
    residual stream entering the layers (``residual``)."""

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as T
        self.scans, self.sites, self.residual = [], [], []
        self._saved = (L._slstm_scan, ops._flash_attention_op,
                       T._run_layers)
        scan0, site0, layers0 = self._saved

        def scan(cfg, pre, R):
            self.scans.append((tuple(pre.shape), tuple(R.shape)))
            return scan0(cfg, pre, R)

        def site(q, k, v, causal, impl):
            self.sites.append((causal, tuple(q.shape)))
            return site0(q, k, v, causal, impl)

        def run_layers(cfg, params, h, positions, **kw):
            self.residual.append(str(getattr(h, "placements", None)))
            return layers0(cfg, params, h, positions, **kw)
        L._slstm_scan, ops._flash_attention_op, T._run_layers = \
            scan, site, run_layers
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as T
        L._slstm_scan, ops._flash_attention_op, T._run_layers = self._saved


def run_plan(fn, args, text, want, count_ops=False) -> dict:
    """Apply one plan (JSON) to ``args``: each output leaf's distance from
    ``want`` (relative to the largest, at least 1), its spec, and what
    the run counted (with ``count_ops``, its collectives and DTensor
    ops too)."""
    from repro_torch.kernels import ops
    from repro_torch.models import sharding
    applied = ShardingPlan.from_json(text).apply(fn, device="cpu")
    ops.local_calls.clear()
    sharding.made_whole.clear()
    sharding.per_shard.clear()
    # the dispatch modes see every op, the local loop's too: only the
    # counted runs take them
    with contextlib.ExitStack() as stack:
        seen = stack.enter_context(Recorded())
        if count_ops:
            tally = stack.enter_context(M.collective_tally())
            dops = stack.enter_context(M.dtensor_ops())
        got = pytree.tree_leaves(applied(*args))
    mesh = applied.mesh
    return {
        "errors": [((g.full_tensor() - w).abs().max() /
                    max(1.0, w.abs().max().item())).item()
                   for g, w in zip(got, want)],
        "specs": [M.spec_for_placements(g.placements, mesh, g.ndim)
                  for g in got],
        "calls": dict(tally.calls) if count_ops else None,
        "dtensor_ops": dict(dops.calls) if count_ops else None,
        "scans": seen.scans, "sites": seen.sites,
        "residual": seen.residual, "made_whole": dict(sharding.made_whole),
        "per_shard": dict(sharding.per_shard),
        "local_calls": [[k, impl, shp] for (k, impl, shp, _), n in
                        ops.local_calls.items() for _ in range(n)]}


def run_decode(cfg, text) -> dict:
    """The serving loop through one decode plan (JSON) against one
    process, over ``SP`` prompt and ``GEN`` generated tokens; an
    encoder-decoder's ``enc_out`` from 16 seeded frames."""
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_decode_step
    dec = make_decode_step(cfg)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (SB, SP)).astype(np.int32))
    extra = {}
    if cfg.is_encoder_decoder:
        frames = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (SB, 16, cfg.d_model)).astype(np.float32))
        extra["enc_out"] = T.encode(cfg, params, frames)
    want = serve.serve_loop(dec, params, T.init_cache(
        cfg, SB, SP + GEN, device="cpu"), prompts, GEN, **extra)
    got = serve.serve_loop(
        ShardingPlan.from_json(text).apply(dec, device="cpu"), params,
        T.init_cache(cfg, SB, SP + GEN, device="cpu"), prompts, GEN,
        **extra)
    return {"tokens": torch.equal(got.tokens.full_tensor(), want.tokens),
            "error": (got.prompt_logits.full_tensor() -
                      want.prompt_logits).abs().max().item(),
            "scale": want.prompt_logits.abs().max().item()}


def apply_rank(rank, cases, decodes=(), launcher=None):
    """On each rank of the group: every prefill / train case's plans
    (``cases``: (arch, layers, kind, b, s, {label: JSON}, labels to
    count DTensor ops for[, remat])), every decode case's plans
    (``decodes``: (arch, layers, {label: JSON})) and, with ``launcher``
    set to ``(arch, layers)``, the serving launcher (``--plan toast``).
    Each case's results are keyed (arch, layers, kind, s[, remat])."""
    out = {"cases": {}, "decode": {}}
    for arch, layers, kind, b, s, plans, counted, *remat in cases:
        cfg, fn, meta = cell(arch, layers, kind, b, s, *remat)
        args = seeded_inputs(cfg, kind, meta)
        want = pytree.tree_leaves(fn(*args))
        out["cases"][(arch, layers, kind, s, *remat)] = {
            label: run_plan(fn, args, text, want, label in counted)
            for label, text in plans.items()}
    for arch, layers, plans in decodes:
        cfg = family_config(arch, layers)
        out["decode"][arch, layers] = {label: run_decode(cfg, text)
                                       for label, text in plans.items()}
    if launcher is not None:
        out["launcher"] = serve_tokens(*launcher)
    return out


def serve_tokens(arch, layers, plan="toast"):
    """The serving launcher's tokens for the reduced model at ``layers``,
    on this group or in one process."""
    res = serve.serve(serve.parse_args([
        "--arch", arch, "--batch", str(SB), "--prompt-len", str(SP),
        "--gen", str(GEN), "--plan", plan, "--device", "cpu"]),
        family_config(arch, layers))
    tokens = res.tokens
    return tokens.full_tensor() if hasattr(tokens, "full_tensor") else tokens


@pytest.fixture(scope="module")
def two():
    plans = {"port": port_plan(ARCH, 8, "prefill", B, S, (1, 2)).to_json(),
             "reference": reference_plan(ARCH, 8, "prefill", B, S, (1, 2))}
    for name, pins in PINS.items():
        plans[name] = port_plan(ARCH, 8, "prefill", B, S, (1, 2),
                                pins).to_json()
    # the port's plan at S 32, applied at S 64 too (the time loop's ops
    # counted at both lengths)
    cases = [(ARCH, 8, "prefill", B, S, plans, ("port",)),
             (ARCH, 8, "prefill", B, 2 * S, {"port": plans["port"]},
              ("port",)),
             (ARCH, 16, "prefill", B, S, {"port": port_plan(
                 ARCH, 16, "prefill", B, S, (1, 2)).to_json()}, ())]
    decodes = [(ARCH, n, decode_plans(ARCH, n, 2, reference=False))
               for n in DECODE["1x2"]]
    return M.run_ranks(apply_rank, 2, cases, decodes, (ARCH, 8),
                       timeout=RANKS_TIMEOUT), plans


@pytest.fixture(scope="module")
def four():
    cases = [(ARCH, n, "prefill", B, S, {
        "port": port_plan(ARCH, n, "prefill", B, S, (2, 2)).to_json(),
        "reference": reference_plan(ARCH, n, "prefill", B, S, (2, 2))}, ())
        for n in (8, 16)]
    decodes = [(ARCH, n, decode_plans(ARCH, n, 4)) for n in DECODE["2x2"]]
    return M.run_ranks(apply_rank, 4, cases, decodes, timeout=RANKS_TIMEOUT)


def close(res):
    return all(e <= TOL for e in res["errors"]) and res["errors"]


PREFILL = [("1x2", 8, lab) for lab in ("port", "reference", *PINS)] + [
    ("1x2", 16, "port")] + [("2x2", n, lab) for n in (8, 16)
                            for lab in ("port", "reference")]


@pytest.mark.parametrize("mesh,layers,plan", PREFILL,
                         ids=["-".join(map(str, c)) for c in PREFILL])
def test_prefill_equals_one_process(two, four, mesh, layers, plan):
    runs = two[0] if mesh == "1x2" else four
    for r in runs:
        res = r["cases"][ARCH, layers, "prefill", S][plan]
        assert close(res), (mesh, layers, plan, res["errors"])
        # one per-shard loop per sLSTM layer
        assert len(res["scans"]) == layers // 8
        assert res["per_shard"].get("scan") == layers // 8


@pytest.mark.parametrize("mesh,layers,plan", [
    (m, n, p) for m, ns in DECODE.items() for n in ns
    for p in (("port",) if m == "1x2" else ("port", "reference"))])
def test_decode_equals_one_process(two, four, mesh, layers, plan):
    runs = two[0] if mesh == "1x2" else four
    for r in runs:
        res = r["decode"][ARCH, layers][plan]
        assert res["tokens"], (mesh, layers, plan)
        assert res["error"] <= TOL * max(1.0, res["scale"])


def test_heads_plan_runs_the_loop_on_a_rank_s_heads(two):
    """The pinned heads plan: each rank's loop takes its two of the four
    heads of ``pre`` (B, S, h/2 x 4hd) and of ``R`` (h/2, hd, 4hd), and
    nothing is made whole."""
    cfg = family_config(ARCH, 8)
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    for r in two[0]:
        res = r["cases"][ARCH, 8, "prefill", S]["heads"]
        assert res["scans"] == [((B, S, h // 2 * 4 * hd),
                                 (h // 2, hd, 4 * hd))]
        assert res["made_whole"] == {}


@pytest.mark.parametrize("plan,letter", [("hd", "j"), ("seq", "s")])
def test_dims_the_loop_cannot_split_are_made_whole_once(two, plan, letter):
    """``R``'s contracted ``hd`` and the time dim, when a plan shards
    them, are made whole once before the loop (counted), and the loop
    runs on whole heads and steps."""
    cfg = family_config(ARCH, 8)
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    for r in two[0]:
        res = r["cases"][ARCH, 8, "prefill", S][plan]
        scan = [k for k in res["made_whole"] if k.startswith("scan")]
        assert scan == [f"scan operand dim {letter!r} of "
                        f"{'Hjk' if letter == 'j' else 'bsH'}"]
        assert res["made_whole"][scan[0]] == 1
        (pre, R), = res["scans"]
        assert pre[1] == S and R == (h, hd, 4 * hd)


def test_batch_plan_keeps_the_batch_sharded_in_the_loop(two):
    for r in two[0]:
        res = r["cases"][ARCH, 8, "prefill", S]["batch"]
        assert [pre[0] for pre, _ in res["scans"]] == [B // 2]


def test_time_loop_ops_do_not_grow_with_the_sequence(two):
    """The same plan at S 32 and S 64 dispatches the same DTensor ops and
    the same collectives (their bytes grow with S, not their number)."""
    for r in two[0]:
        a = r["cases"][ARCH, 8, "prefill", S]["port"]
        b = r["cases"][ARCH, 8, "prefill", 2 * S]["port"]
        assert close(b)
        assert a["dtensor_ops"] == b["dtensor_ops"] and a["dtensor_ops"]
        assert a["calls"] == b["calls"]
        assert [pre[1] for pre, _ in b["scans"]] == [2 * S]


def test_reference_plan_loads_with_the_port_s_paths(two):
    _, plans = two
    port = ShardingPlan.from_json(plans["port"])
    ref = ShardingPlan.from_json(plans["reference"])
    assert ref.input_paths == port.input_paths


def test_serving_launcher_on_two_ranks_equals_one_process(two):
    """``--plan toast`` on two ranks (the decode plan's rules, every
    tensor replicated) against one process's serving loop."""
    one = serve_tokens(ARCH, 8, "manual")
    for r in two[0]:
        assert torch.equal(r["launcher"], one)
