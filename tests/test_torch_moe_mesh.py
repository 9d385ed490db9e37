"""MoE on two or more devices raises, naming ROADMAP item 10b.

Two ranks of one gloo group (CPU tensors) try the reduced
``mixtral_8x22b`` three ways: its prefill step through ``plan.apply`` of
a searched (1, 2) plan (the tensors are DTensors there, and the MoE
block refuses them), and the training and serving launchers, which
refuse the model before they make anything.  Each must raise
``NotImplementedError`` citing item 10b on both ranks.  The dense model
runs through the same ``plan.apply`` on the same ranks, so the refusal is
the MoE block's, not the mesh's.
"""

import dataclasses

import torch

from repro_torch.api import Request, Session
from repro_torch.configs import get_config
from repro_torch.core.cost_model import MeshSpec
from repro_torch.launch import mesh as M
from repro_torch.launch import serve, train
from repro_torch.models import transformer as T
from repro_torch.train.steps import make_prefill_step

RANKS_TIMEOUT = 240.0


def refusals(rank):
    """Per entry point, the ``NotImplementedError`` it raised (or
    ``None``), and the dense model's applied logits' shape."""
    out = {}
    tokens = torch.randint(0, 256, (2, 16), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    for arch in ("mixtral_8x22b", "qwen2_05b"):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  moe_dispatch="batch")
        step = make_prefill_step(cfg)
        sess = Session(step, (T.param_specs(cfg), {"tokens": torch.empty(
            (2, 16), dtype=torch.int32, device="meta")}))
        plan = sess.partition(Request(mesh=MeshSpec(("data", "model"),
                                                    (1, 2))))
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        try:
            logits = plan.apply(step, device="cpu")(params,
                                                   {"tokens": tokens})
            out[arch] = tuple(logits.shape)
        except NotImplementedError as e:
            out[arch] = str(e)
    common = ["--arch", "mixtral_8x22b", "--reduced", "--device", "cpu"]
    for name, main, argv in (
            ("train", train.main, ["--steps", "1", "--batch", "2",
                                   "--seq", "16"]),
            ("serve", serve.main, ["--gen", "2", "--prompt-len", "2"])):
        try:
            main(common + argv)
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def test_moe_on_two_ranks_raises_item_10b():
    ranks = M.run_ranks(refusals, 2, timeout=RANKS_TIMEOUT)
    for out in ranks:
        assert out["qwen2_05b"] == (2, 256)
        for key in ("mixtral_8x22b", "train", "serve"):
            assert "item 10b" in out[key], (key, out[key])
            assert "mesh of 2 or more devices" in out[key]
