"""Compiled steps: the port's ``jax.jit``, with ``donate_argnums``.

``jit(fn, device=None, *, capture=None, donate_argnums=())`` binds a
step to one device and keys it by argument signature: the arguments'
treedef and each leaf's shape and dtype, as ``jax.jit`` keys its
compilations.  On a CUDA device each signature runs as one captured
CUDA graph; on the CPU, or with ``capture=False``, the step runs
eagerly.  ``ShardingPlan.apply`` builds its ``AppliedPlan`` on the same
class (:class:`Compiled`), adding the plan's kernel dispatch and its
spec checks; the launchers call :func:`jit` where they have no plan.

*Donation.*  The leaves of the arguments named by ``donate_argnums``
give their buffers to the step's results, as XLA aliases a donated
input with an output: outputs are taken in flattening order, and each
takes the earliest donated leaf not yet taken with its shape and dtype
(for ``train_step(state, batch) -> (state, metrics)`` with
``donate_argnums=0``: each state leaf with its new value, never with a
metric).  The step's value for that output is written into the donated
tensor, and the donated tensor itself is returned in its place.  A
donated leaf that no output takes raises ``ValueError`` (``jax.jit``
only warns; an undonated leaf would keep one more copy of the state
alive).  The caller must not use a donated argument's old values after
the call, as under ``jax.jit``.

    step = jit(train_step, donate_argnums=0)
    state, metrics = step(state, batch)   # state: the same tensors
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Callable

from repro_torch import pytree


@dataclasses.dataclass
class CapturedStep:
    """One argument signature's CUDA graph (see :class:`Compiled`).

    Attributes:
        graph: the ``torch.cuda.CUDAGraph``.
        inputs: the static input buffers, one per argument leaf.
        held: per leaf, True when the graph reads the caller's tensor in
            place (held by the step), False when each call copies the
            leaf into a buffer the step owns.
        outputs: the graph's output buffers, in flattening order.
        template: the output tree of the capture (its structure).
        launches: kernel launches recorded in the graph, as
            ``kernels.ops.launch_counts`` names them; each replay runs
            them again, though the wrappers' counters do not move.
        warmup_launches: kernel launches of the eager warm-up run.
        seconds: host seconds of the warm-up and the capture.
        pool_bytes: device bytes the capture reserved (its private pool).
        replays: replays of this graph.
        pairs: output index -> the donated input leaf whose buffer the
            graph writes that output into (and which is returned for it).
    """

    graph: Any
    inputs: list
    held: list[bool]
    outputs: list
    template: Any
    launches: dict[str, int]
    warmup_launches: dict[str, int]
    seconds: float
    pool_bytes: int
    replays: int = 0
    pairs: dict[int, int] = dataclasses.field(default_factory=dict)

    def holds(self, leaves) -> list[bool]:
        """Per leaf: held, and ``leaves``' tensor is the held one (same
        address and strides; the step holds it, so no other tensor can
        take its address)."""
        return [h and x.data_ptr() == s.data_ptr() and
                x.stride() == s.stride()
                for h, x, s in zip(self.held, leaves, self.inputs)]


def _aval(x):
    """A tensor's shape and dtype, and a DTensor's placements, as
    donation pairs buffers; ``None`` for any other leaf."""
    import torch
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype, getattr(x, "placements", None)
    return None


def _donation_pairs(paths, leaves, donated, outs) -> dict[int, int]:
    """Pair donated input leaves with outputs, as XLA aliases buffers.

    Args:
        paths: each input leaf's key path (for the error).
        leaves: the input leaves.
        donated: per input leaf, whether it is donated.
        outs: the output leaves, in flattening order.

    Returns:
        ``{output index: donated input index}``: each output, in order,
        takes the earliest donated leaf not yet taken with its shape and
        dtype (and, for DTensors, its placements).

    Raises:
        ValueError: naming every donated leaf that no output takes.
    """
    free = collections.defaultdict(collections.deque)
    unpaired = []
    for i, (x, d) in enumerate(zip(leaves, donated)):
        if d:
            aval = _aval(x)
            (unpaired if aval is None else free[aval]).append(i)
    pairs = {}
    for j, o in enumerate(outs):
        queue = free.get(_aval(o))
        if queue:
            pairs[j] = queue.popleft()
    unpaired += [i for q in free.values() for i in q]
    if unpaired:
        names = ", ".join(paths[i] for i in sorted(unpaired))
        raise ValueError(
            f"donated input {names} has no output of the same shape and "
            f"dtype (and placements, on a mesh) to take its buffer "
            f"(donate_argnums): donate only what the step returns anew, "
            f"placed as it came")
    return pairs


class Compiled:
    """A step bound to one device, one entry per argument signature.

    *Capture* (the default on a CUDA device): the first call of a
    signature runs ``fn`` once eagerly on a side stream (which builds
    the kernels and sets their attributes), captures it as a CUDA graph
    on static input buffers, replays it and returns that replay's
    result; every later call replays.  The leaves of the first argument
    (the parameters or the train state, by the steps' convention) and
    every donated leaf are captured in place: the graph reads the
    caller's tensors, which the step holds, so no address can be reused
    under it.  Every other leaf (a batch, a cache, a position) is copied
    on each call into a buffer the step owns; no caller's tensor is
    written except a donated one.  A held leaf that arrives as another
    tensor is moved to the copied side (a donated one stays held) and
    the signature is captured anew.  Results are copies of the graph's
    outputs, so a result the caller keeps is never overwritten by the
    next call, as ``jax.jit``'s fresh arrays are not; an output that
    takes a donated buffer is written into it by the graph itself and
    returned as the donated tensor.  Steps must be functional, as under
    ``jit``: a step that writes into an input raises.  A capture that
    fails raises; nothing runs eagerly in a graph's place.
    :meth:`release`, or dropping the object, frees the graphs and their
    memory pools.

    *Eager* (the CPU, or ``capture=False``): each call runs ``fn``; a
    donated leaf then takes its output's value after ``fn`` returns, so
    eager and captured calls return the same tensors.  A subclass may
    place the arguments before the call and the result after it
    (``_place``, ``_finish``: ``AppliedPlan`` on a mesh of DTensors).
    A donated DTensor pairs only with an output placed as it is, and a
    leaf that ``_place`` replaced (a full tensor split, a DTensor
    redistributed) donates nothing: its output comes back as a new
    tensor and the caller's is not written.

    Attributes:
        captures: graphs captured so far.
        replays: graph replays so far (first calls included).
    """

    def __init__(self, fn: Callable, device=None,
                 capture: bool | None = None, donate_argnums=()) -> None:
        """Bind ``fn`` to a device.

        Args:
            fn: the step; it takes positional arguments only.
            device: where it runs (``None``: the CUDA card).
            capture: capture CUDA graphs (``None``: on a CUDA device).
            donate_argnums: an index or a tuple of indices of the
                positional arguments whose leaves are donated.

        Raises:
            RuntimeError: when no CUDA device is available and
                ``device`` is not given.
            ValueError: for ``capture=True`` on a device other than CUDA.
        """
        from repro_torch.device import resolve_device
        self.fn = fn
        self.device = resolve_device(device)
        cuda = self.device.type == "cuda"
        if capture and not cuda:
            raise ValueError(f"capture=True needs a CUDA device; this "
                             f"step runs on {self.device}")
        self.capture = cuda if capture is None else capture
        self.donate_argnums = (
            (donate_argnums,) if isinstance(donate_argnums, int)
            else tuple(donate_argnums))
        self.captures = 0
        self.replays = 0
        # signature -> CapturedStep (capture) or None (eager)
        self._cache: dict = {}
        self._stream = None

    @property
    def graphs(self) -> list[CapturedStep]:
        """The live graphs, one per captured signature."""
        return [e for e in self._cache.values() if e is not None]

    def release(self) -> None:
        """Free every graph, its static buffers and its memory pool
        (returned to the card by ``torch.cuda.empty_cache()``)."""
        graphs = self.graphs
        self._cache.clear()
        for entry in graphs:
            entry.inputs.clear()
            entry.outputs.clear()
            entry.template = None
            entry.graph.reset()

    # -- hooks (AppliedPlan overrides them) ---------------------------------

    def _flatten(self, args) -> tuple[list, list[str]]:
        """The argument leaves and their key paths."""
        return pytree.flatten_with_paths(args)

    def _check_call(self, kwargs, leaves, paths) -> None:
        import torch
        if kwargs:
            raise ValueError("compiled steps take positional arguments "
                             "only")
        for path, leaf in zip(paths, leaves):
            if isinstance(leaf, torch.Tensor) and \
                    leaf.device.type != self.device.type:
                raise ValueError(f"input {path} lies on {leaf.device}, "
                                 f"the step runs on {self.device}")

    def _dispatch(self):
        return contextlib.nullcontext()

    def _check_outputs(self, out) -> None:
        pass

    def _place(self, args, leaves) -> tuple[Any, list]:
        """The arguments and leaves an eager run takes."""
        return args, leaves

    def _finish(self, out):
        """An eager run's result, as it is returned."""
        return out

    # -- calls ---------------------------------------------------------------

    def __call__(self, *args, **kwargs):
        """Run ``fn`` on ``args``.

        Args:
            *args: positional arguments, every tensor on the step's
                device.
            **kwargs: rejected.

        Returns:
            ``fn``'s result (under capture: copies of the graph's
            outputs; the donated tensors where outputs take them).

        Raises:
            ValueError: for keyword arguments, a leaf on another device,
                a step that wrote into an input, or a donated leaf no
                output takes.
        """
        import torch
        leaves, paths = self._flatten(args)
        self._check_call(kwargs, leaves, paths)
        donated = [i in self.donate_argnums
                   for i, a in enumerate(args)
                   for _ in pytree.tree_leaves(a)]
        # a DTensor keys on its global shape and its placements
        key = (pytree.treedef(args), tuple(
            (tuple(x.shape), x.dtype, getattr(x, "placements", None))
            if isinstance(x, torch.Tensor)
            else ((), type(x).__name__) for x in leaves))
        if not self.capture:
            return self._run_eager(args, leaves, paths, donated, key)
        if any(getattr(x, "placements", None) is not None for x in leaves):
            raise ValueError(
                "a step on DTensors runs eagerly (capture=False): no "
                "multi-card graph can be checked on a host with one card "
                "(ROADMAP queue 1, item 8)")
        entry = self._cache.get(key)
        if entry is None:
            n_first = len(pytree.tree_leaves(args[0])) if args else 0
            held = [i < n_first or d for i, d in enumerate(donated)]
        else:
            same = entry.holds(leaves)
            if same != entry.held:
                # a held leaf moved: copy it from now on (a donated one
                # is held anew), capture anew
                self._cache.pop(key)
                entry.graph.reset()
                entry = None
                held = [s or d for s, d in zip(same, donated)]
        if entry is None:
            entry = self._capture(args, leaves, paths, held, donated)
            self._cache[key] = entry
        for buf, x, h in zip(entry.inputs, leaves, entry.held):
            if not h:
                buf.copy_(x)
        entry.graph.replay()
        entry.replays += 1
        self.replays += 1
        return pytree.unflatten(entry.template, [
            entry.inputs[entry.pairs[j]] if j in entry.pairs else o.clone()
            for j, o in enumerate(entry.outputs)])

    def _check_functional(self, paths, leaves, versions) -> None:
        for path, x, v in zip(paths, leaves, versions):
            if v is not None and x._version != v:
                raise ValueError(
                    f"the step wrote into its input {path}: a compiled "
                    f"step must be functional, as under jit")

    def _run_eager(self, args, leaves, paths, donated, key):
        import torch
        given = leaves
        args, leaves = self._place(args, leaves)
        # a leaf placed anew is not the caller's tensor: none of the
        # caller's buffers is donated for it
        donated = [d and x is g for d, x, g in zip(donated, leaves, given)]
        versions = [x._version if isinstance(x, torch.Tensor) else None
                    for x in leaves]
        with self._dispatch():
            out = self.fn(*args)
        self._check_functional(paths, leaves, versions)
        if key not in self._cache:
            self._check_outputs(out)
        out = self._finish(out)
        if not any(donated):
            self._cache[key] = None
            return out
        outs = pytree.tree_leaves(out)
        pairs = _donation_pairs(paths, leaves, donated, outs)
        self._cache[key] = None
        for j, i in pairs.items():
            leaves[i].copy_(outs[j])
            outs[j] = leaves[i]
        return pytree.unflatten(out, outs)

    def _capture(self, args, leaves, paths, held, donated) -> CapturedStep:
        """Warm ``fn`` up eagerly on static buffers, then capture it (and
        the write-back of the donated leaves)."""
        import torch

        from repro_torch.kernels.ops import launch_counts
        for path, x in zip(paths, leaves):
            if not isinstance(x, torch.Tensor):
                raise TypeError(f"input {path} is a {type(x).__name__}: a "
                                f"captured step takes tensors only (pass "
                                f"capture=False to run it eagerly)")
        static = [x if h else x.clone() for x, h in zip(leaves, held)]
        sargs = pytree.unflatten(args, static)
        versions = [x._version for x in static]
        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            # one side stream warms up and captures: the warm-up gives it
            # its cuBLAS workspace, outside the graph's pool
            if self._stream is None:
                self._stream = torch.cuda.Stream()
            side = self._stream
            before = launch_counts()
            side.wait_stream(torch.cuda.current_stream())
            # the warm-up writes nothing back: the first replay takes
            # the first step
            with torch.cuda.stream(side), self._dispatch():
                out = self.fn(*sargs)
            torch.cuda.current_stream().wait_stream(side)
            self._check_functional(paths, static, versions)
            self._check_outputs(out)
            outs, out_paths = pytree.flatten_with_paths(out)
            for x, path in zip(outs, out_paths):
                if not isinstance(x, torch.Tensor):
                    raise TypeError(f"output {path} is a "
                                    f"{type(x).__name__}: a captured step "
                                    f"returns tensors only")
            pairs = _donation_pairs(paths, static, donated, outs)
            del out, outs
            # torch.cuda.graph empties the allocator's cache as it enters:
            # empty it first, so that the pool's bytes are read after it
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            warm = launch_counts()
            reserved = torch.cuda.memory_reserved()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, stream=side), self._dispatch():
                    out = self.fn(*sargs)
                    outs = pytree.tree_leaves(out)
                    self._check_functional(paths, static, versions)
                    for j, i in pairs.items():
                        static[i].copy_(outs[j])
            except RuntimeError as err:
                name = getattr(self.fn, "__name__", repr(self.fn))
                err.add_note(f"while capturing {name} as a CUDA graph "
                             f"(capture=False runs it eagerly)")
                raise
            torch.cuda.synchronize()
            after = launch_counts()
            pool = torch.cuda.memory_reserved() - reserved
        self.captures += 1
        return CapturedStep(
            graph=graph, inputs=static, held=list(held), outputs=outs,
            template=out,
            launches={k: after[k] - warm[k] for k in after},
            warmup_launches={k: warm[k] - before[k] for k in warm},
            seconds=time.perf_counter() - t0, pool_bytes=pool, pairs=pairs)


def jit(fn: Callable, device=None, *, capture: bool | None = None,
        donate_argnums=()) -> Compiled:
    """``fn`` compiled per argument signature, the port's ``jax.jit``.

    Args:
        fn: the step; it takes positional arguments only.
        device: where it runs (``None``: the CUDA card; ``"cpu"`` runs
            it eagerly on the CPU).
        capture: capture each signature as a CUDA graph (``None``: on a
            CUDA device; ``False``: run eagerly).
        donate_argnums: an index or a tuple of indices of the arguments
            whose leaves are donated (see the module docstring).

    Returns:
        A :class:`Compiled`; call it like ``fn``.
    """
    return Compiled(fn, device, capture, donate_argnums)
