"""The reduced frontend models, ``whisper_small`` (encoder-decoder) and
``phi3_vision`` (patch embeddings before the tokens), on (1, 2) and 2x2
gloo meshes against one process: prefill and decode through
``plan.apply``, and the serving launcher on two ranks.

Both models in f32 with their kernel sites (``use_pallas``: the
attention's plain version on CPU tensors, under ``local_map`` on a
mesh), the prefill step at B 4 x S 32 (whisper: 16 frames and 16
tokens; phi3_vision: 8 patches and 24 tokens).  Plans, each searched
greedily under one explicit ``HardwareSpec``: the port's and the
reference's (the JAX package's ``Session``, its JSON read by the port)
for (1, 2) and 2x2, and on (1, 2) a plan pinned to shard the sequence
(the tokens, and whisper's frames, on ``model``).  Decode: the serving
launcher's plan and the reference's from the same request, whisper's
against the encoder's output of 16 seeded frames.  Every output leaf
within 1e-4 of one process (relative to the largest, at least 1), the
tokens exact.

What the mesh must keep: whisper's encoder site runs non-causal and its
decoder's causal, each under ``local_map`` on a rank's block (the batch
halved under the batch-sharded plans); phi3_vision's patch embeddings
concatenated before sequence-sharded tokens leave the residual stream
sequence-sharded as it enters the layers (``sharding.cat_like``:
DTensor's concatenation would make it whole for every layer).  The
serving launcher (``--plan toast`` on two ranks: the decode plan's
rules, every tensor replicated, whisper's ``enc_out`` too) gives one
process's tokens.
"""

import pytest
import torch

from repro_torch.launch import mesh as M
from test_torch_xlstm_mesh import (apply_rank, close, decode_plans,
                                   family_config, port_plan, reference_plan,
                                   serve_tokens)

ARCHS = ("whisper_small", "phi3_vision")
B, S = 4, 32
RANKS_TIMEOUT = 300.0
SEQ_PINS = {"whisper_small": {"[0][1]['tokens']": (None, "model"),
                              "[0][1]['frames']": (None, "model", None)},
            "phi3_vision": {"[0][1]['tokens']": (None, "model")}}


def prefill_cases(mesh, pinned=False):
    out = []
    for arch in ARCHS:
        plans = {"port": port_plan(arch, None, "prefill", B, S,
                                   mesh).to_json(),
                 "reference": reference_plan(arch, None, "prefill", B, S,
                                             mesh)}
        if pinned:
            plans["seq"] = port_plan(arch, None, "prefill", B, S, mesh,
                                     SEQ_PINS[arch]).to_json()
        out.append((arch, None, "prefill", B, S, plans, ()))
    return out


def ranks_rank(rank, cases, decodes):
    """``apply_rank``, and on two ranks the serving launcher for both
    models."""
    out = apply_rank(rank, cases, decodes)
    if M.group_size() == 2:
        out["launcher"] = {arch: serve_tokens(arch, None) for arch in ARCHS}
    return out


@pytest.fixture(scope="module")
def runs():
    out = {}
    for mesh in ((1, 2), (2, 2)):
        n = mesh[0] * mesh[1]
        decodes = [(arch, None, decode_plans(arch, None, n))
                   for arch in ARCHS]
        out["x".join(map(str, mesh))] = M.run_ranks(
            ranks_rank, n, prefill_cases(mesh, pinned=n == 2), decodes,
            timeout=RANKS_TIMEOUT)
    return out


PREFILL = [(m, a, p) for m in ("1x2", "2x2") for a in ARCHS
           for p in ("port", "reference")] + [("1x2", a, "seq")
                                              for a in ARCHS]


@pytest.mark.parametrize("mesh,arch,plan", PREFILL,
                         ids=["-".join(c) for c in PREFILL])
def test_prefill_equals_one_process(runs, mesh, arch, plan):
    for r in runs[mesh]:
        res = r["cases"][arch, None, "prefill", S][plan]
        assert close(res), (mesh, arch, plan, res["errors"])


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("plan", ["port", "reference"])
def test_decode_equals_one_process(runs, mesh, arch, plan):
    for r in runs[mesh]:
        res = r["decode"][arch, None][plan]
        assert res["tokens"], (mesh, arch, plan)
        assert res["error"] <= 1e-4 * max(1.0, res["scale"])


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_whisper_encoder_site_runs_non_causal_under_local_map(runs, mesh):
    """Each encoder layer's site non-causal, each decoder layer's causal,
    every one on a rank's block of the batch-sharded port plan."""
    cfg = family_config("whisper_small")
    ways = 2 if mesh == "1x2" else 4
    for r in runs[mesh]:
        sites = r["cases"]["whisper_small", None, "prefill", S]["port"][
            "sites"]
        assert [c for c, _ in sites] == \
            [False] * cfg.encoder_layers + [True] * cfg.num_layers
        assert {shape[0] for _, shape in sites} == {B // ways}


def test_patches_before_sharded_tokens_keep_the_sequence_sharded(runs):
    """Under the sequence plan the residual stream enters the layers
    sharded on its sequence, not made whole."""
    for r in runs["1x2"]:
        res = r["cases"]["phi3_vision", None, "prefill", S]["seq"]
        assert res["residual"] == ["(Replicate(), Shard(dim=1))"]


def test_serving_launcher_on_two_ranks_equals_one_process(runs):
    """``--plan toast`` on two ranks against one process's serving loop;
    whisper serves against its encoder's output, replicated."""
    for arch in ARCHS:
        one = serve_tokens(arch, None, "manual")
        for r in runs["1x2"]:
            assert torch.equal(r["launcher"][arch], one), arch
