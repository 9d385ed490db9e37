"""Logical-axis annotations and the kernel-dispatch state.

Models annotate activations with *logical dimension names* (``batch``,
``seq``, ``embed``, ``hidden``, ``heads`` …) through :func:`constrain`.
In the reference a rules map ``{logical name -> mesh axes}`` (the plan's
``logical_rules``) turns them into sharding constraints.  The port runs
plans on one device only, where every placement is the same, so
:func:`constrain` is a no-op and the rules map comes with multi-device
execution through DTensor (ROADMAP queue 1, item 8).

:class:`KernelDispatch` carries a plan's per-site kernel decisions to
``kernels.ops``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

_STATE = threading.local()


def constrain(x, names: tuple[str | None, ...]):
    """Annotate ``x``'s dims with logical names.

    A no-op in the port: plans execute on one device, where every
    placement is the same (see the module docstring).
    """
    return x


# ---------------------------------------------------------------------------
# kernel dispatch: per-site impl registry for the fused kernels
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KernelDispatch:
    """Ambient per-run kernel-dispatch state (``kernels.ops`` reads it).

    Sites are keyed ``"<kernel>:<ordinal>"`` in call-occurrence order
    per kernel kind — the same order the fused ops appear in the traced
    IR.  The traced layer scan holds one instance of its body, so every
    iteration of the eager layer loop runs under the body's site keys
    (``transformer.scan_layers`` rewinds the counters with
    :meth:`mark` / :meth:`rewind`).  ``plan.apply`` installs one of these
    carrying the searched plan's per-site impl decisions.

    Attributes:
        impls: site key -> impl name ("cuda" | "ref").
        default_impl: impl for sites without an explicit entry
            (``None`` = the registry's default).
    """

    impls: dict = dataclasses.field(default_factory=dict)
    default_impl: str | None = None
    _counters: dict = dataclasses.field(default_factory=dict)

    def next_site(self, kernel: str) -> str:
        """Allocate the next site key for one ``kernel`` call."""
        n = self._counters.get(kernel, 0)
        self._counters[kernel] = n + 1
        return f"{kernel}:{n}"

    def reset(self) -> None:
        """Reset the per-run ordinal counters."""
        self._counters.clear()

    def mark(self) -> dict:
        """A snapshot of the ordinal counters (see :meth:`rewind`)."""
        return dict(self._counters)

    def rewind(self, mark: dict) -> None:
        """Return the ordinal counters to a :meth:`mark` snapshot."""
        self._counters = dict(mark)

    def impl_for(self, site: str) -> str | None:
        """The impl decision for ``site`` (falls back to the default)."""
        return self.impls.get(site, self.default_impl)


def get_kernel_dispatch() -> KernelDispatch | None:
    """The thread's active :class:`KernelDispatch`, or ``None``."""
    return getattr(_STATE, "kernel_dispatch", None)


@contextlib.contextmanager
def kernel_dispatch(disp: KernelDispatch | None, *, reset: bool = True):
    """Install ``disp`` as the ambient dispatch for this thread.

    Entering resets the site ordinal counters, so one context spans
    exactly one run of the model function.  With ``reset=False`` the
    counters are kept: autograd's backward, which runs on a thread of
    its own for CUDA tensors, re-enters a forward's dispatch that way to
    recompute a checkpointed layer body.
    """
    prev = get_kernel_dispatch()
    if disp is not None and reset:
        disp.reset()
    _STATE.kernel_dispatch = disp
    try:
        yield disp
    finally:
        _STATE.kernel_dispatch = prev

