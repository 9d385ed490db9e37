"""AdamW in PyTorch, with gradient clipping by global norm, a warmup +
cosine learning-rate schedule and an optional low-precision optimizer
state (``state_dtype="bfloat16"``).

The counterpart of the reference package's ``optim/adam.py``, with its
casts: gradients are taken to float32, ``m`` and ``v`` are kept in
``state_dtype``, the update is computed in float32 and cast back to
each parameter's dtype.  Every function is functional (no tensor is
written in place), so the train step traces under ``torch.export``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch import pytree


class AdamState(NamedTuple):
    step: torch.Tensor           # 0-d int32
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    state_dtype: str = "float32"      # "bfloat16" for very large models


def schedule(cfg: AdamConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step``: linear warmup, then a cosine decay
    to a tenth of ``cfg.lr`` at ``cfg.total_steps``.

    Args:
        cfg: the optimizer configuration.
        step: the (1-based) step, a 0-d integer tensor.

    Returns:
        A 0-d float32 tensor.
    """
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cosine = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cosine)


def init(cfg: AdamConfig, params) -> AdamState:
    """Zero moments in ``cfg.state_dtype`` and step 0.

    Args:
        cfg: the optimizer configuration.
        params: the parameter tree (any device, ``meta`` included).

    Returns:
        The initial :class:`AdamState`, on the parameters' device.
    """
    dt = getattr(torch, cfg.state_dtype)
    leaves = pytree.tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     m=pytree.tree_map(zeros, params),
                     v=pytree.tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm over every leaf of ``tree``."""
    return torch.sqrt(sum(torch.square(x.to(torch.float32)).sum()
                          for x in pytree.tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` down to a global norm of at most ``max_norm``.

    Returns:
        ``(clipped grads in their own dtypes, the norm before clipping)``.
    """
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return pytree.tree_map(
        lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm


def apply_updates(cfg: AdamConfig, state: AdamState, params, grads):
    """One AdamW step with global-norm clipping.

    Args:
        cfg: the optimizer configuration.
        state: the optimizer state before the step.
        params: the parameter tree.
        grads: gradients shaped like ``params`` (any float dtype).

    Returns:
        ``(new params, new AdamState, grad norm before clipping)``.
    """
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))
    dt = getattr(torch, cfg.state_dtype)

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g32 * g32
        mh = m32 / bc1
        vh = v32 / bc2
        # p is cast twice, as in the reference (two ops in its program)
        delta = lr * (mh / (torch.sqrt(vh) + cfg.eps) +
                      cfg.weight_decay * p.to(torch.float32))
        return ((p.to(torch.float32) - delta).to(p.dtype), m32.to(dt),
                v32.to(dt))

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        pytree.tree_leaves(params), pytree.tree_leaves(grads),
        pytree.tree_leaves(state.m), pytree.tree_leaves(state.v))]
    new_p = pytree.unflatten(params, [o[0] for o in out])
    new_m = pytree.unflatten(params, [o[1] for o in out])
    new_v = pytree.unflatten(params, [o[2] for o in out])
    return new_p, AdamState(step, new_m, new_v), gnorm
