"""Dispatching public entry points for the fused kernels.

Model code (``use_pallas=True`` paths) calls :func:`attention` and
:func:`rg_lru`.  Each call

- resolves the implementation (``"cuda"`` vs ``"ref"``) from the ambient
  kernel-dispatch state (``repro_torch.models.sharding``): the plan's
  per-site decision, else the registry's default (``"cuda"``);
- runs the computation inside a custom op (``repro_torch::flash_attention``,
  ``repro_torch::rg_lru``), which ``torch.export`` keeps as one opaque
  node — the tracer (``core.ir``) records it as a single fused IR op
  (``prim="kernel:<name>"``) instead of its internals.

The op runs the kernel's plain version on a CPU tensor.  On a CUDA
tensor, ``"cuda"`` launches the hand-written kernel (raising for a
shape the kernel does not take) and ``"ref"`` runs the plain version on
the card.  There is no fallback from one to the other.

*Autograd.*  ``repro_torch::flash_attention`` trains: its backward is
its own op, ``repro_torch::flash_attention_bwd`` (q, k, v, dO -> dq,
dk, dv), registered with ``torch.library.register_autograd``.  It
computes the plain version's vjp, as the reference package's
``_fa_bwd_jit`` does: the reference has no backward kernel (its
registry lists only ``"ref"`` for ``flash_attention_bwd``), so this is
the one implementation on every device, not a fallback.
``repro_torch::rg_lru`` trains the same way: its backward is the op
``repro_torch::rg_lru_bwd`` (a, b, dh -> da, db), the plain scan's vjp,
as the reference's ``_lru_bwd_jit`` (its registry lists only ``"ref"``
for ``rg_lru_bwd``).  Both keep the forward's inputs as their residuals,
as the reference's ``custom_vjp``s do, so the forward itself stays the
kernel on a CUDA tensor.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import registry
from repro_torch.kernels import rg_lru as lru

__all__ = ["attention", "rg_lru"]

# attention and RG-LRU backward calls made by this process (each runs
# the plain vjp; read by the chip smoke run, beside the kernels' launch
# counts)
bwd_calls = 0
rg_lru_bwd_calls = 0


def launch_counts() -> dict[str, int]:
    """Each kernel wrapper's launches so far, the RG-LRU's by route
    (``"rg_lru.tma"``, ``"rg_lru.generic"``), and the backward ops'
    calls (``"flash_attention_bwd"``, ``"rg_lru_bwd"``: plain vjps)."""
    return {"flash_attention": fa.launches, "rg_lru": lru.launches,
            **{f"rg_lru.{r}": n for r, n in lru.route_launches.items()},
            "flash_attention_bwd": bwd_calls, "rg_lru_bwd": rg_lru_bwd_calls}


def _check_impl(kernel: str, impl: str) -> None:
    if impl not in registry.KERNELS[kernel].impls:
        raise ValueError(f"unknown {kernel} impl {impl!r}")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, impl: str) -> torch.Tensor:
    _check_impl("flash_attention", impl)
    if impl == "ref":
        return fa.reference(q, k, v, causal=causal)
    return fa.flash_attention(q, k, v, causal=causal)


@_flash_attention_op.register_fake
def _(q, k, v, causal, impl):
    return q.new_empty(q.shape)


@torch.library.custom_op("repro_torch::flash_attention_bwd",
                         mutates_args=())
def _flash_attention_bwd_op(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        do: torch.Tensor,
        causal: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention backward: the plain version's vjp on any device
    (the reference's backward has no kernel either)."""
    global bwd_calls
    bwd_calls += 1
    return tuple(x.contiguous() for x in
                 fa.reference_bwd(q, k, v, do, causal=causal))


@_flash_attention_bwd_op.register_fake
def _(q, k, v, do, causal):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _fa_setup_context(ctx, inputs, output):
    q, k, v, causal, _ = inputs
    ctx.save_for_backward(q, k, v)
    ctx.causal = causal


def _fa_backward(ctx, do):
    q, k, v = ctx.saved_tensors
    dq, dk, dv = _flash_attention_bwd_op(q, k, v, do, ctx.causal)
    return dq, dk, dv, None, None


_flash_attention_op.register_autograd(_fa_backward,
                                      setup_context=_fa_setup_context)


def _resolve(kernel: str) -> str:
    """The impl for the next ``kernel`` site: plan decision or default."""
    from repro_torch.models.sharding import get_kernel_dispatch
    disp = get_kernel_dispatch()
    impl = None
    if disp is not None:
        impl = disp.impl_for(disp.next_site(kernel))
    return impl or registry.KERNELS[kernel].default_impl


def attention(q, k, v, *, causal: bool = True):
    """Fused attention dispatch: q (B,S,H,hd); k, v (B,T,H,hd).

    GQA group expansion happens in the caller (the model layer), so the
    fused op's head dim is shared across q/k/v and a plan may map it
    over the mesh.

    Args:
        q: queries, model layout.
        k: keys with q's head count.
        v: values shaped like ``k``.
        causal: causal mask on absolute positions.

    Returns:
        The attention output, (B,S,H,hd).
    """
    impl = _resolve("flash_attention")
    return _flash_attention_op(q, k, v, causal, impl)


@torch.library.custom_op("repro_torch::rg_lru", mutates_args=())
def _rg_lru_op(a: torch.Tensor, b: torch.Tensor, impl: str) -> torch.Tensor:
    _check_impl("rg_lru", impl)
    if impl == "ref":
        return lru.reference(a, b)
    return lru.rg_lru(a, b)


@_rg_lru_op.register_fake
def _(a, b, impl):
    return a.new_empty(a.shape)


@torch.library.custom_op("repro_torch::rg_lru_bwd", mutates_args=())
def _rg_lru_bwd_op(a: torch.Tensor, b: torch.Tensor,
                   dh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU backward: the plain scan's vjp on any device (the
    reference's backward has no kernel either)."""
    global rg_lru_bwd_calls
    rg_lru_bwd_calls += 1
    return lru.reference_bwd(a, b, dh)


@_rg_lru_bwd_op.register_fake
def _(a, b, dh):
    return a.new_empty(a.shape), b.new_empty(b.shape)


def _lru_setup_context(ctx, inputs, output):
    a, b, _ = inputs
    ctx.save_for_backward(a, b)


def _lru_backward(ctx, dh):
    a, b = ctx.saved_tensors
    da, db = _rg_lru_bwd_op(a, b, dh)
    return da, db, None


_rg_lru_op.register_autograd(_lru_backward, setup_context=_lru_setup_context)


def rg_lru(a, b):
    """Fused gated linear recurrence dispatch: a, b (B,S,R) -> h (B,S,R).

    Args:
        a: decay gates.
        b: inputs, a's shape and dtype.

    Returns:
        ``h_t = a_t h_{t-1} + b_t`` from h = 0, in a's dtype.
    """
    impl = _resolve("rg_lru")
    return _rg_lru_op(a, b, impl)
