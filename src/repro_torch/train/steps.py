"""Train and serve step factories.

``make_train_step(cfg, opt_cfg, accum_steps)`` builds the train step:
softmax cross-entropy with z-loss (float32), gradients, global-norm
clipping and the AdamW update, returning the new :class:`TrainState`
and the loss, cross-entropy and grad-norm metrics.  ``make_prefill_step``
builds the prefill entry point (the last position's logits) and
``make_decode_step`` the one-token decode step over the caches.

Run eagerly, the train step takes its gradients with ``torch.autograd``
(each layer body checkpointed under ``cfg.remat``, as the reference's
``jax.checkpoint``).  Under ``torch.export`` it emits the loss's forward
and one ``repro_torch::grad`` node; the tracer (``core.ir``) builds the
backward program from the forward by the reference's differentiation
rules (``core.autodiff``), so the planned program has the reference's
structure: a forward and a backward layer scan (an encoder's beside
the decoder's, an sLSTM's time scan inside the bodies), the loss head
and its gradient, and the AdamW update per leaf.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.sharding import placed_like, reduced
from repro_torch.optim import adam


class TrainState(NamedTuple):
    params: Any
    opt: adam.AdamState


def init_train_state(cfg, generator: torch.Generator,
                     opt_cfg: adam.AdamConfig | None = None, device=None):
    """Random parameters (``transformer.init_params``) and a fresh
    optimizer state.

    Args:
        cfg: the model configuration.
        generator: the ``torch.Generator`` to draw from; it must live on
            ``device``.
        opt_cfg: the optimizer configuration (default ``AdamConfig()``).
        device: where the state lives (``None``: the CUDA card).

    Returns:
        The :class:`TrainState`.
    """
    params = T.init_params(cfg, generator, device=resolve_device(device))
    return TrainState(params, adam.init(opt_cfg or adam.AdamConfig(),
                                        params))


def train_state_specs(cfg, opt_cfg: adam.AdamConfig | None = None):
    """The train state as ``meta`` tensors (nothing is allocated)."""
    params = T.param_specs(cfg)
    return TrainState(params, adam.init(opt_cfg or adam.AdamConfig(),
                                        params))


def train_state_from_numpy(state, device=None) -> TrainState:
    """Carry a reference ``TrainState`` (numpy-convertible leaves) into
    the port, beside ``transformer.params_from_numpy``.

    Args:
        state: a ``(params, (step, m, v))`` named tuple with array-like
            leaves, e.g. the reference package's train state.
        device: where the tensors live (``None``: the CUDA card).

    Returns:
        The port's :class:`TrainState`, dtypes kept.
    """
    dev = resolve_device(device)
    params, opt = state
    step, m, v = opt
    return TrainState(
        T.params_from_numpy(params, dev),
        adam.AdamState(torch.from_numpy(np.array(step, np.int32)).to(dev),
                       T.params_from_numpy(m, dev),
                       T.params_from_numpy(v, dev)))


def logsumexp(x):
    """``log(sum(exp(x)))`` over the last dim, in ``jax.nn.logsumexp``'s
    steps: the finite max, detached, shifts the exponentials."""
    amax = x.amax(-1)
    amax = torch.where(torch.isfinite(amax), amax, 0).detach()
    sumexp = torch.exp(x - amax[..., None]).sum(-1)
    return torch.log(sumexp.abs()) + amax


def cross_entropy(logits, targets, *, z_loss: float = 1e-4):
    """Float32 cross-entropy with z-loss regularisation.

    Args:
        logits: (..., vocab) logits of any float dtype.
        targets: (...) int gold token ids.
        z_loss: the weight of ``logsumexp**2``.

    Returns:
        ``(mean(ce + z_loss * lse**2), mean(ce))``, 0-d float32.
    """
    # a pending sum (a product over a sharded d_model) is reduced where
    # the product left it, in its own dtype, as GSPMD reduces it
    logits = reduced(logits).to(torch.float32)
    lse = logsumexp(logits)
    gold = reduced(torch.gather(
        logits, -1, targets[..., None].to(torch.int64))).squeeze(-1)
    ce = lse - gold
    zl = z_loss * torch.square(lse)
    return torch.mean(ce + zl), torch.mean(ce)


def make_loss_fn(cfg):
    """``loss_fn(params, batch) -> (loss, ce)`` over ``batch["tokens"]``
    and ``batch["targets"]`` (both (B, S) int), with ``batch["frames"]``
    (an encoder-decoder model's frame embeddings) or
    ``batch["patch_embeds"]`` (a vision model's patch embeddings) when
    the model takes them; the image positions have no target."""
    def loss_fn(params, batch):
        kwargs = {k: batch[k] for k in ("patch_embeds", "frames")
                  if k in batch}
        logits = T.forward(cfg, params, batch["tokens"], **kwargs)
        if "patch_embeds" in batch:
            logits = logits[:, batch["patch_embeds"].shape[1]:]
        return cross_entropy(logits, batch["targets"])
    return loss_fn


@torch.library.custom_op("repro_torch::grad", mutates_args=())
def _grad_op(loss: torch.Tensor, wrt: list[torch.Tensor],
             remat: bool) -> list[torch.Tensor]:
    """The gradients of ``loss`` with respect to ``wrt``, as a traced
    node only: ``core.ir`` differentiates the program that computes
    ``loss`` (``remat``: the backward recomputes each layer body)."""
    raise RuntimeError("repro_torch::grad is a trace-time node; eager "
                       "steps take their gradients with torch.autograd")


@_grad_op.register_fake
def _(loss, wrt, remat):
    return [torch.empty_like(w) for w in wrt]


def value_and_grad(loss_fn, remat: bool = False):
    """``f(params, batch) -> (loss, aux, grads)`` for a ``loss_fn``
    returning ``(loss, aux)``.

    Eagerly the gradients come from ``torch.autograd``; under
    ``torch.export`` from one ``repro_torch::grad`` node over the traced
    loss (see the module docstring).  Gradients have their parameters'
    dtypes.
    """
    def run(params, batch):
        leaves = pytree.tree_leaves(params)
        if torch.compiler.is_exporting():
            loss, aux = loss_fn(params, batch)
            return loss, aux, pytree.unflatten(
                params, _grad_op(loss, leaves, remat))
        with torch.enable_grad():
            live = [p.detach().requires_grad_() for p in leaves]
            loss, aux = loss_fn(pytree.unflatten(params, live), batch)
            # a leaf the loss does not reach (an empty layer stack) gets
            # zeros of its shape, as jax.value_and_grad gives it
            grads = torch.autograd.grad(loss, live, allow_unused=True,
                                        materialize_grads=True)
        grads = [placed_like(g, p) for g, p in zip(grads, leaves)]
        return loss.detach(), aux.detach(), pytree.unflatten(params, grads)
    return run


def make_train_step(cfg, opt_cfg: adam.AdamConfig | None = None,
                    accum_steps: int = 1):
    """``train_step(state, batch) -> (state, metrics)``.

    Args:
        cfg: the model configuration.
        opt_cfg: the optimizer configuration (default ``AdamConfig()``).
        accum_steps: microbatches per step.  Above 1 the batch's leading
            dim is split and the gradients summed in float32 over the
            microbatches, as the reference's microbatch ``lax.scan``;
            such a step runs eagerly only (the traced step takes 1, as
            ``launch.specs.step_and_inputs`` builds it).

    Returns:
        The train step; ``metrics`` holds ``loss``, ``ce``, ``grad_norm``
        and ``step`` (the new 0-d int32 step).

    Raises:
        NotImplementedError: for the ``"dots"`` remat policy, which the
            port does not have.
    """
    if cfg.remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat policy {cfg.remat_policy!r}: the port checkpoints "
            f"whole layer bodies only (\"full\")")
    opt_cfg = opt_cfg or adam.AdamConfig()
    single = value_and_grad(make_loss_fn(cfg), remat=cfg.remat)

    def train_step(state: TrainState, batch):
        if accum_steps == 1:
            loss, ce, grads = single(state.params, batch)
        else:
            if torch.compiler.is_exporting():
                raise NotImplementedError(
                    "a traced train step takes accum_steps=1")
            mbs = pytree.tree_map(
                lambda x: x.reshape(accum_steps, x.shape[0] // accum_steps,
                                    *x.shape[1:]), batch)
            dev = pytree.tree_leaves(batch)[0].device
            loss = torch.zeros((), device=dev)
            ce = torch.zeros((), device=dev)
            grads = pytree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), state.params)
            for i in range(accum_steps):
                l, c, g = single(state.params,
                                 pytree.tree_map(lambda x: x[i], mbs))
                grads = pytree.unflatten(grads, [
                    a + b for a, b in zip(pytree.tree_leaves(grads),
                                          pytree.tree_leaves(g))])
                loss, ce = loss + l, ce + c
            loss, ce = loss / accum_steps, ce / accum_steps
            grads = pytree.tree_map(lambda g: g / accum_steps, grads)
        new_params, new_opt, gnorm = adam.apply_updates(
            opt_cfg, state.opt, state.params, grads)
        metrics = {"loss": loss, "ce": ce, "grad_norm": gnorm,
                   "step": new_opt.step}
        return TrainState(new_params, new_opt), metrics

    return train_step


def make_prefill_step(cfg):
    """``prefill(params, batch) -> (B, vocab)`` next-token logits.

    Args:
        cfg: the model configuration.

    Returns:
        The prefill step; ``batch["tokens"]`` is a ``(B, S)`` int tensor,
        with ``batch["frames"]`` (an encoder-decoder model's frame
        embeddings) or ``batch["patch_embeds"]`` (a vision model's patch
        embeddings) when the model takes them.  The result is a fresh
        tensor, not a view of the (B, S, vocab) logits, so holding it
        does not hold them (the reference's jitted step returns a fresh
        buffer too); the tracer lowers the copy as an identity.
    """
    def prefill(params, batch):
        kwargs = {k: batch[k] for k in ("patch_embeds", "frames")
                  if k in batch}
        logits = T.forward(cfg, params, batch["tokens"], **kwargs)
        return logits[:, -1].clone()
    return prefill


def make_decode_step(cfg):
    """``decode(params, cache, token, pos, enc_out=None) -> (logits, new
    cache)``.

    Args:
        cfg: the model configuration.

    Returns:
        The decode step: ``token`` is ``(B, 1)`` int, ``pos`` a 0-d int32
        tensor, the cache as ``transformer.init_cache`` builds it,
        ``enc_out`` an encoder-decoder model's encoder output
        (``transformer.encode``); ``logits`` is ``(B, 1, vocab)``.
    """
    def decode(params, cache, token, pos, enc_out=None):
        return T.decode_step(cfg, params, cache, token, pos,
                             enc_out=enc_out)
    return decode
