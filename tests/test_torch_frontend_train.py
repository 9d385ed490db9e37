"""The port's train steps of the frontend models against the JAX package:
``whisper_small`` (an encoder-decoder: the decoder's layer scan closes
over the encoder's output) and ``phi3_vision`` (patch embeddings before
the tokens, no target on the image positions).

The same inputs, made from a numpy seed (or the reference's train state
carried over by ``train_state_from_numpy``), go through the reference
and the port on the CPU, at the stock reduced configs (whisper: 2
encoder and 2 decoder layers; phi3_vision: 2 layers, 8 patches) and B 2
x S 32 positions, split as ``launch.specs`` splits them (whisper: 16
frames and 16 tokens; phi3_vision: 8 patches and 24 tokens).

Tolerances: the loss and every gradient leaf against
``jax.value_and_grad`` 1e-4, remat off and on, on the einsum path and
with ``use_pallas`` set (the CPU tensors take the fused sites' plain
versions and their plain-vjp backward: whisper's encoder site is the
non-causal one); one AdamW step against the jitted reference step 1e-4,
with a short warmup and ``eps`` 1e-3 (``tests/test_torch_train.py``);
the launchers' final checkpoints after 3 steps from one step-0
checkpoint the reference wrote 1e-4.  Exact: which leaves take nonzero
gradients, the loss head's positions, and the site keys remat's
recomputations run under.
"""

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs.base import get_config as jax_config
from repro.launch import train as jtrain
from repro.optim import adam as jadam
from repro.train import steps as JS
from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import specs
from repro_torch.launch import train as launcher
from repro_torch.models import transformer as T
from repro_torch.models.sharding import KernelDispatch, kernel_dispatch
from repro_torch.optim import adam
from repro_torch.train import steps as S

ARCHS = ["whisper_small", "phi3_vision"]
TOL = 1e-4
B, SEQ = 2, 32
OPT = dict(lr=1e-2, eps=1e-3, warmup_steps=1, total_steps=10)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def close_trees(got, want, tol=TOL):
    gl, jl = pytree.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(jl)
    for g, w in zip(gl, jl):
        assert tuple(g.shape) == tuple(np.shape(w))
        close(g, w, tol)


def configs(arch, remat=False, use_pallas=False):
    jc = dataclasses.replace(jax_config(arch).reduced(), remat=remat)
    tc = dataclasses.replace(get_config(arch).reduced(), remat=remat,
                             use_pallas=use_pallas)
    return jc, tc


def make_batch(cfg, seed=7):
    """A batch as the train specs lay it out, drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    spec, _ = specs.batch_specs(cfg, ShapeConfig("t", SEQ, B, "train"))
    out = {}
    for k, v in spec.items():
        shape = tuple(v.shape)
        out[k] = rng.integers(0, cfg.vocab_size, shape).astype(np.int32) \
            if v.dtype == torch.int32 else \
            rng.standard_normal(shape).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """One model's reference train state, a batch, and its results, each
    computed once."""
    arch = request.param
    jc, tc = configs(arch)
    jstate = JS.init_train_state(jc, jax.random.PRNGKey(0),
                                 jadam.AdamConfig(**OPT))
    batch = make_batch(tc)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    cache: dict = {}

    def result(kind, remat):
        key = (kind, remat)
        if key not in cache:
            jcr = configs(arch, remat)[0]
            if kind == "grads":
                cache[key] = jax.jit(jax.value_and_grad(
                    JS.make_loss_fn(jcr), has_aux=True))(jstate.params, jb)
            else:
                cache[key] = jax.jit(JS.make_train_step(
                    jcr, jadam.AdamConfig(**OPT)))(jstate, jb)
        return cache[key]

    return arch, jstate, tb, result


def port_state(jstate):
    return S.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")


@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["einsum", "fused-plain"])
def test_loss_and_every_gradient_leaf(reference, use_pallas, remat):
    arch, jstate, tb, result = reference
    _, tc = configs(arch, remat, use_pallas)
    (wl, wce), wg = result("grads", remat)
    gl, gce, gg = S.value_and_grad(S.make_loss_fn(tc), remat=remat)(
        port_state(jstate).params, tb)
    close(gl, wl)
    close(gce, wce)
    close_trees(gg, wg)


def test_train_step_matches_the_reference(reference):
    arch, jstate, tb, result = reference
    _, tc = configs(arch)
    jnew, jm = result("step", False)
    tnew, tm = S.make_train_step(tc, adam.AdamConfig(**OPT))(
        port_state(jstate), tb)
    for k in ("loss", "ce", "grad_norm"):
        close(tm[k], jm[k])
    assert int(tm["step"]) == 1
    close_trees(tnew, jnew)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree_util.tree_leaves(jnew.params),
                                jax.tree_util.tree_leaves(jstate.params)))
    assert moved > 100 * TOL


def test_whisper_encoder_takes_gradients_through_enc_out():
    # the encoder reaches the loss only through the decoder's cross
    # attention: the decoder scan's constant enc_out
    _, tc = configs("whisper_small")
    params = T.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(tc).items()}
    _, _, grads = S.value_and_grad(S.make_loss_fn(tc))(params, batch)
    enc = pytree.tree_leaves(grads["enc_layers"]) + [grads["enc_ln"]]
    assert len(enc) > 2
    for g in enc:
        assert g.abs().amax(dim=tuple(range(1, g.ndim)) or None).gt(0).all()


def test_phi3_vision_loss_covers_text_positions_only():
    _, tc = configs("phi3_vision")
    params = T.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(tc).items()}
    P = tc.num_patches
    assert tuple(batch["targets"].shape) == (B, SEQ - P)
    loss, ce = S.make_loss_fn(tc)(params, batch)
    logits = T.forward(tc, params, batch["tokens"],
                       patch_embeds=batch["patch_embeds"])
    assert logits.shape[1] == SEQ
    want = S.cross_entropy(logits[:, P:], batch["targets"])
    torch.testing.assert_close(loss, want[0], rtol=0, atol=0)
    torch.testing.assert_close(ce, want[1], rtol=0, atol=0)


def test_whisper_remat_recomputes_under_the_traced_programs_site_keys():
    # forward: the encoder's site, then the decoder's; the backward
    # recomputes the decoder's body first, then the encoder's, each
    # under keys that follow every earlier site, as the traced program
    # holds them
    from repro_torch.api import Request, Session
    from repro_torch.core.cost_model import MeshSpec
    _, tc = configs("whisper_small", remat=True, use_pallas=True)
    params = T.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(tc).items()}
    sites = []

    class Recording(KernelDispatch):
        def next_site(self, kernel):
            sites.append(super().next_site(kernel))
            return sites[-1]

    with kernel_dispatch(Recording()):
        S.value_and_grad(S.make_loss_fn(tc), remat=True)(params, batch)
    n_enc, n_dec = tc.encoder_layers, T.n_scan_blocks(tc)
    assert sites == ["flash_attention:0"] * n_enc + \
        ["flash_attention:1"] * n_dec + ["flash_attention:2"] * n_dec + \
        ["flash_attention:3"] * n_enc
    fn, args, _ = specs.step_and_inputs(tc, ShapeConfig("t", SEQ, B,
                                                        "train"))
    sess = Session(fn, args)
    plan = sess.partition(Request(mesh=MeshSpec(("data", "model"), (1, 1))))
    prog = sess.artifacts.prog
    got = [(r["site"], prog.ops[r["op"]].params["causal"])
           for r in plan.kernel_sites]
    assert got == [("flash_attention:0", False), ("flash_attention:1", True),
                   ("flash_attention:2", True), ("flash_attention:3", False)]


# -- the launcher -------------------------------------------------------------


def load_checkpoint(directory, step):
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    return manifest, [np.load(d / e["file"]) for e in manifest["leaves"]]


@pytest.mark.parametrize("arch", ARCHS)
def test_the_launcher_matches_the_reference_from_one_checkpoint(
        arch, tmp_path):
    jstate = JS.init_train_state(jax_config(arch).reduced(),
                                 jax.random.PRNGKey(0))
    for name in ("ref", "port"):
        jckpt.save(tmp_path / name, 0, jstate)
    jargs = argparse.Namespace(
        arch=arch, reduced=True, steps=3, batch=2, seq=32, plan="manual",
        compress="none", seed=0, ckpt_dir=str(tmp_path / "ref"),
        ckpt_every=10, log_every=5, fail_at=None, max_failures=0)
    assert jtrain.run_once(jargs, 0)
    report = launcher.Attempt(0)
    args = launcher.parse_args(
        ["--arch", arch, "--reduced", "--steps", "3", "--batch", "2",
         "--seq", "32", "--ckpt-dir", str(tmp_path / "port"), "--device",
         "cpu"])
    assert launcher.run_once(get_config(arch).reduced(), args, 0, report)
    assert report.start_step == 0 and report.restore_s is not None
    assert all(np.isfinite(loss) for loss, _ in report.losses)
    jman, jleaves = load_checkpoint(tmp_path / "ref", 3)
    man, leaves = load_checkpoint(tmp_path / "port", 3)
    assert man == jman
    for entry, got, want in zip(man["leaves"], leaves, jleaves):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=entry["path"])
