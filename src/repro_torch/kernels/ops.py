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

*On a mesh* (the counterpart of the reference's ``_maybe_shard_map``).
When a site's inputs are DTensors, the custom op runs on each rank's
local tensors under ``local_map``: a sharded site with the placements of
the plan's per-site specs (``KernelDispatch.specs_for``), which shard
only the kernel's mappable roles, so a blocked role (attention's
sequence, the RG-LRU's S) is made whole first; an unsharded site, and a
site with no plan, with every placement ``Replicate`` (a custom op has no
DTensor sharding rule of its own).  Autograd passes through ``local_map``
to the backward ops on the local tensors.  The kernel takes a local
shard in place; one whose last dim is not contiguous, which the kernels
do not take, is copied first, and each such copy is counted in
``site_copies``.  ``local_calls`` counts the local calls by kernel,
impl, local shapes and strides.
"""

from __future__ import annotations

import collections

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
# local shards copied to hand a kernel a contiguous last dim, and the
# local calls under local_map: (kernel, impl, shapes, strides) -> calls
site_copies = 0
local_calls: collections.Counter = collections.Counter()


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


def _resolve(kernel: str) -> tuple[str | None, str]:
    """The next ``kernel`` site's key (``None`` with no dispatch) and its
    impl: the plan's decision or the registry's default."""
    from repro_torch.models.sharding import get_kernel_dispatch
    disp = get_kernel_dispatch()
    site = impl = None
    if disp is not None:
        site = disp.next_site(kernel)
        impl = disp.impl_for(site)
    return site, impl or registry.KERNELS[kernel].default_impl


def _run_site(kernel: str, op, args: tuple, *static):
    """``op(*args, *static, impl)`` at the next ``kernel`` site: the impl
    is the plan's decision or the registry's default; on DTensors the op
    runs under ``local_map`` (see the module docstring)."""
    from repro_torch.models.sharding import get_kernel_dispatch, is_dtensor
    disp = get_kernel_dispatch()
    site, impl = _resolve(kernel)
    if not any(is_dtensor(x) for x in args):
        return op(*args, *static, impl)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.launch.mesh import placements_for
    spec = disp.specs_for(site) if disp is not None else None
    if spec is None:
        mesh = next(x for x in args if is_dtensor(x)).device_mesh
        whole = (Replicate(),) * mesh.ndim
        in_pl, out_pl = (whole,) * len(args), whole
    else:
        mesh, in_specs, out_spec = spec
        in_pl = tuple(placements_for(s, mesh, x.ndim)
                      for s, x in zip(in_specs, args))
        out_pl = placements_for(out_spec, mesh, args[0].ndim)

    def local(*xs):
        global site_copies
        if impl == "cuda":
            ready = []
            for x in xs:
                if x.is_cuda and x.stride(-1) != 1:
                    x = x.contiguous()
                    site_copies += 1
                ready.append(x)
            xs = ready
        local_calls[(kernel, impl, tuple(tuple(x.shape) for x in xs),
                     tuple(x.stride() for x in xs))] += 1
        return op(*xs, *static, impl)

    # one output: a tuple of one placement tuple
    return local_map(local, out_placements=(out_pl,), in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


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
    return _run_site("flash_attention", _flash_attention_op, (q, k, v),
                     causal)


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
    return _run_site("rg_lru", _rg_lru_op, (a, b))
