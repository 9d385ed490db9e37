"""Device meshes over ``torch.distributed``: the port's counterpart of the
reference's ``launch/mesh.py``.

A mesh is a ``DeviceMesh`` over an initialised process group, one rank
per device, with the plan's axis names as its ``mesh_dim_names``.
:func:`compat_make_mesh` builds one on the CUDA cards (each rank on card
``local_rank % device_count``, so several ranks may share one card) or,
when asked, on the CPU, where a gloo group of N processes simulates an
N-device mesh.  Building a mesh never starts a process group: a program
starts one per rank first, with ``torch.distributed.init_process_group``
or, for N ranks on one host, with :func:`run_ranks`.

:func:`placements_for` and :func:`spec_for_placements` convert between a
plan's JAX-style ``PartitionSpec`` (one entry per tensor dim: a mesh
axis, a tuple of axes, or ``None``) and DTensor placements (one per mesh
dim), as the reference gets them from ``NamedSharding``.

``make_production_mesh`` is a function, never a module-level constant, so
importing this module touches no device and no process group.  The
single-pod mesh is 16x16 = 256 devices (``data``, ``model``); the
multi-pod mesh adds a ``pod`` axis: 2x16x16 = 512, the pod axis across
the data-centre network.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable

from repro_torch.core.cost_model import MeshSpec


def compat_make_mesh(shape, axes, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the process group.

    Args:
        shape: devices along each mesh axis; their product must equal the
            process group's size.
        axes: the mesh axis names (``mesh_dim_names``).
        device: ``None`` or ``"cuda"``: each rank's CUDA card, card
            ``local_rank % device_count`` (ranks may share a card);
            ``"cpu"``: the CPU.

    Returns:
        The ``DeviceMesh``.

    Raises:
        RuntimeError: when no process group is initialised, or its size
            differs from the mesh's; when a card is asked for and none
            is available.
    """
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import resolve_device
    shape, axes = tuple(shape), tuple(axes)
    n = 1
    for s in shape:
        n *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs an initialised "
            f"process group of {n} ranks (found {have or 'none'}): start "
            f"one per rank with torch.distributed.init_process_group("
            f"backend, init_method=..., rank=r, world_size={n}), or run "
            f"the ranks with repro_torch.launch.mesh.run_ranks(fn, {n})")
    dev = resolve_device(device)
    if dev.type == "cuda":
        # LOCAL_RANK as torchrun (and run_ranks) set it
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
        if dist.get_backend() == "gloo":
            route_gloo_all_gather()
    mesh = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    if sum(s > 1 for s in shape) > 1:
        # the mesh flattened: torch's DTensor (2.13) then reduces or
        # gathers over several mesh dims in one collective, not one per
        # mesh dim, as GSPMD does over a device group
        _FLAT[id(mesh)] = (mesh, mesh._flatten())
    return mesh


# id of a mesh made by compat_make_mesh -> (the mesh, kept so that its id
# is not reused, and the mesh flattened)
_FLAT: dict = {}


def flat_mesh(mesh):
    """``mesh`` flattened to one dim, where :func:`compat_make_mesh` made
    it (a mesh of two or more dims above one device); else ``None``."""
    made, flat = _FLAT.get(id(mesh), (None, None))
    return flat if made is mesh else None


_ROUTED: list = []


def route_gloo_all_gather() -> None:
    """Send the functional all-gather of CUDA tensors through c10d's
    ``all_gather_into_tensor``.

    DTensor gathers with ``_c10d_functional.all_gather_into_tensor``,
    which reaches gloo's ``allgather_into_tensor_coalesced``; on CUDA
    tensors that path dies of a segmentation fault (torch 2.11, two ranks
    on one H100: PERF.md, ROADMAP queue 3), while
    ``torch.distributed.all_gather_into_tensor`` (gloo's
    ``_allgather_base``) gathers CUDA tensors right.  This installs, once
    per process, a CUDA kernel for the functional op that calls the
    latter and returns its result when it has completed, so
    ``wait_tensor`` finds no pending work.  (DTensor's redistribution has
    autograd of its own and calls the op without it.)  The tensors stay
    on the card; gloo stages them through the host either way.
    ``compat_make_mesh`` calls it for a CUDA mesh over gloo.
    """
    if _ROUTED:
        return
    import torch
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    def all_gather_into_tensor(input, group_size, group_name):
        out = input.new_empty((input.shape[0] * group_size,
                               *input.shape[1:]))
        dist.all_gather_into_tensor(out, input.contiguous(),
                                    group=_resolve_process_group(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather_into_tensor, "CUDA")
    _ROUTED.append(lib)


def mesh_context(mesh):
    """A context manager installing ``mesh`` as the ambient mesh (a
    ``DeviceMesh`` is its own context manager)."""
    return mesh


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` on a mesh: the port's
    ``jax.sharding.NamedSharding``.

    Attributes:
        mesh: the ``DeviceMesh``.
        spec: one entry per tensor dim (a mesh axis, a tuple of axes, or
            ``None``).
    """

    mesh: Any
    spec: Any

    def placements(self, ndim: int) -> tuple:
        """The DTensor placements of a tensor of rank ``ndim``
        (:func:`placements_for`)."""
        return placements_for(self.spec, self.mesh, ndim)


def distribute(x, sharding: NamedSharding):
    """``x``, the same whole tensor on every rank, as a DTensor placed as
    ``sharding`` says: each rank keeps its block (no collective), copied
    out of ``x`` where it would be a view of it, so that writing into the
    DTensor (a donated step) never writes ``x``."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    placements = sharding.placements(x.ndim)
    d = distribute_tensor(x, sharding.mesh, placements, src_data_rank=None)
    local = d.to_local()
    if local.untyped_storage().data_ptr() != x.untyped_storage().data_ptr():
        return d
    return DTensor.from_local(local.clone(), sharding.mesh, placements,
                              run_check=False, shape=d.shape,
                              stride=d.stride())


def init_from_env() -> int:
    """Join the process group that ``torchrun`` describes, on gloo.

    ``torchrun`` sets ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` in every rank; with them this
    process joins a gloo group of ``WORLD_SIZE`` ranks (CPU tensors, and
    CUDA tensors through host copies), unless a group is already
    initialised (:func:`run_ranks` starts one).  Without them it leaves
    the process alone: one device.

    Returns:
        The size of the process group (1 without one).
    """
    import torch.distributed as dist
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group("gloo", init_method="env://")
    return group_size()


def group_size() -> int:
    """The size of the initialised process group, else 1."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def group_rank() -> int:
    """This process's rank in the initialised process group, else 0."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def print0(*args) -> None:
    """``print`` on rank 0 only (in every process without a group)."""
    if group_rank() == 0:
        print(*args, flush=True)


def from_rank0(fn: Callable) -> Any:
    """``fn()`` computed on rank 0 and sent to every rank of the group
    (``fn()`` itself without a group): a search whose result every rank
    must share, as the reference's single controller computes it once."""
    import torch.distributed as dist
    if group_size() < 2:
        return fn()
    box = [fn() if group_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def build_mesh(spec: MeshSpec, device=None):
    """The ``DeviceMesh`` of ``spec`` over the process group, as the
    reference's launcher builds its mesh: each axis trimmed to what is
    left of the group's devices (``repro/launch/train.py``'s
    ``build_mesh``).

    Args:
        spec: the mesh the plan or rules were made for.
        device: as :func:`compat_make_mesh`.

    Returns:
        The ``DeviceMesh``.

    Raises:
        RuntimeError: when the trimmed sizes do not multiply to the
            group's size (:func:`compat_make_mesh`).
    """
    sizes = []
    remaining = group_size()
    for s in spec.sizes:
        s = min(s, remaining)
        sizes.append(s)
        remaining //= s
    return compat_make_mesh(tuple(sizes), spec.axes, device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh over the process group (256 or 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_make_mesh(shape, axes, device)


def production_mesh_spec(*, multi_pod: bool = False) -> MeshSpec:
    """Abstract description for the cost model (no devices touched)."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16),
                        dcn_axes=("pod",))
    return MeshSpec(("data", "model"), (16, 16))


def smoke_mesh_spec() -> MeshSpec:
    """The 2x2 mesh of the smoke runs."""
    return MeshSpec(("data", "model"), (2, 2))


# ---------------------------------------------------------------------------
# PartitionSpec <-> DTensor placements
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_for(spec, mesh, ndim: int) -> tuple:
    """DTensor placements, one per mesh dim, of a ``PartitionSpec``.

    A tensor dim whose entry names mesh axes is sharded on each of them;
    every other mesh dim is ``Replicate``.  A tuple entry is major-to-
    minor, as in JAX.  DTensor shards a dim over mesh dims left to right,
    so an entry whose axes run in the mesh's order (``("data", "model")``
    on a ``("data", "model")`` mesh) is ``Shard`` on both.  Two axes
    against the mesh's order (``("model", "data")``, as searched plans
    give them) place the minor axis, which comes first in the mesh, as
    DTensor's strided shard: ``_StridedShard(dim, split_factor=<the major
    axis's size>)`` on it and ``Shard(dim)`` on the major axis, which
    gives every device the block JAX gives it.

    Args:
        spec: one entry per tensor dim (a shorter spec leaves the
            trailing dims whole).
        mesh: the ``DeviceMesh`` (its ``mesh_dim_names`` name the axes,
            its ``shape`` sizes them).
        ndim: the tensor's rank.

    Returns:
        A tuple of placements, one per mesh dim.

    Raises:
        ValueError: for a spec longer than the tensor's rank, an axis the
            mesh lacks, or an axis named twice.
        NotImplementedError: for three or more axes on one dim against
            the mesh's order, which one strided shard does not describe.
    """
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    names = tuple(mesh.mesh_dim_names)
    if len(spec) > ndim:
        raise ValueError(f"spec {tuple(spec)} has more entries than the "
                         f"tensor's {ndim} dims")
    placements: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {tuple(spec)} names {missing}, not an "
                             f"axis of the mesh {names}")
        idx = [names.index(a) for a in axes]
        if any(not placements[i].is_replicate() for i in idx) or \
                len(set(idx)) != len(idx):
            raise ValueError(f"spec {tuple(spec)} names a mesh axis twice")
        for i in idx:
            placements[i] = Shard(dim)
        if idx == sorted(idx):
            continue
        if len(idx) != 2:
            raise NotImplementedError(
                f"spec {tuple(spec)}: the axes {axes} of dim {dim} run "
                f"against the mesh's order {names}; the port places two "
                f"such axes as a strided shard, not {len(idx)}")
        major, minor = idx
        placements[minor] = _StridedShard(
            dim, split_factor=tuple(mesh.shape)[major])
    return tuple(placements)


def spec_for_placements(placements, mesh, ndim: int):
    """The ``PartitionSpec`` of DTensor placements (the inverse of
    :func:`placements_for`).

    Args:
        placements: one placement per mesh dim.
        mesh: the ``DeviceMesh``.
        ndim: the tensor's rank.

    Returns:
        A ``PartitionSpec`` with one entry per tensor dim.

    Raises:
        ValueError: for a ``Partial`` placement (a pending reduction has
            no spec).
        NotImplementedError: for a strided shard that
            :func:`placements_for` does not make.
    """
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    from repro_torch.core.partitioner import PartitionSpec
    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    entries: list[list[str]] = [[] for _ in range(ndim)]
    strided: dict[int, tuple[int, int]] = {}
    for i, p in enumerate(placements):
        # checked first: an older torch's strided shard is a Shard
        if isinstance(p, _StridedShard):
            strided[p.dim % ndim] = (i, p.split_factor)
        elif isinstance(p, Shard):
            entries[p.dim % ndim].append(names[i])
        elif not p.is_replicate():
            raise ValueError(f"placement {p} on mesh axis {names[i]!r} has "
                             f"no PartitionSpec")
    for dim, (i, factor) in strided.items():
        later = [names.index(a) for a in entries[dim]]
        if len(later) != 1 or later[0] < i or sizes[later[0]] != factor:
            raise NotImplementedError(
                f"strided shard {placements[i]} on mesh axis {names[i]!r} "
                f"beside {entries[dim]} has no PartitionSpec here")
        entries[dim].append(names[i])
    return PartitionSpec(*[None if not e else e[0] if len(e) == 1
                           else tuple(e) for e in entries])


# ---------------------------------------------------------------------------
# collectives a run issues
# ---------------------------------------------------------------------------


_COLLECTIVES = frozenset({
    "all_gather_into_tensor", "all_gather_into_tensor_coalesced",
    "reduce_scatter_tensor", "reduce_scatter_tensor_coalesced",
    "all_reduce", "all_reduce_coalesced", "all_to_all_single",
    "broadcast", "shard_dim_alltoall"})
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")


def collective_tally():
    """A dispatch mode that counts the collectives issued under it, by
    kind, with the bytes of their results (this rank's, as the
    reference's ``launch/hlo_analysis`` counts a compiled program's) and
    the host seconds spent in them.

    DTensor lowers every redistribution to functional collectives
    (``_c10d_functional.all_gather_into_tensor`` and the like, and its
    own ``_dtensor.shard_dim_alltoall``) on local tensors; the mode sees
    those.  On a CPU group DTensor's all-to-all runs as an all-gather and
    a chunk: it is counted as the all-to-all (``shard_dim_alltoall``, the
    block it returns), as it runs on a card's group and as GSPMD counts
    it.  A functional collective may return before it completes, so
    the seconds of ``wait_tensor`` are kept too: the two sums bound the
    time a rank spends communicating.  Use it beside DTensor's
    ``CommDebugMode``, whose counts it repeats, for the bytes::

        with CommDebugMode() as comm, collective_tally() as tally:
            applied(params, batch)
        tally.calls, tally.bytes, tally.seconds   # kind -> number

    Returns:
        The mode (a context manager), with ``calls``, ``bytes`` and
        ``seconds`` counters keyed by the collective's name
        (``seconds`` also by ``"wait_tensor"``), and ``shapes``, keyed
        by the name and the shape of each result.
    """
    import collections
    import time

    import torch
    from torch.distributed.tensor import DTensor, placement_types
    from torch.utils._python_dispatch import TorchDispatchMode

    class CollectiveTally(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = collections.Counter()
            self.bytes = collections.Counter()
            self.seconds = collections.Counter()
            self.shapes = collections.Counter()
            self._inner = 0

        def __enter__(self):
            # DTensor's all-to-all between two shards: on a CPU group it
            # runs as an all-gather and a chunk, counted here as the
            # all-to-all it stands for (the block it returns)
            inner = placement_types.shard_dim_alltoall

            def alltoall(*args, **kwargs):
                self._inner += 1
                t0 = time.perf_counter()
                try:
                    out = inner(*args, **kwargs)
                finally:
                    self._inner -= 1
                if args[0].device.type == "cpu":
                    self.seconds["shard_dim_alltoall"] += \
                        time.perf_counter() - t0
                    self._count("shard_dim_alltoall", [out])
                return out
            self._saved = inner
            placement_types.shard_dim_alltoall = alltoall
            return super().__enter__()

        def __exit__(self, *exc):
            placement_types.shard_dim_alltoall = self._saved
            return super().__exit__(*exc)

        def _count(self, name, outs):
            self.calls[name] += 1
            self.bytes[name] += sum(t.numel() * t.element_size()
                                    for t in outs)
            for t in outs:
                self.shapes[name, tuple(t.shape)] += 1

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t is DTensor for t in types):
                return NotImplemented
            name = getattr(func, "__name__", "").split(".")[0]
            if getattr(func, "namespace", "") not in _COLLECTIVE_NAMESPACES \
                    or name not in _COLLECTIVES | {"wait_tensor"}:
                return func(*args, **(kwargs or {}))
            if self._inner and args and args[0].device.type == "cpu":
                # the all-gather of a CPU all-to-all: counted as that
                return func(*args, **(kwargs or {}))
            t0 = time.perf_counter()
            out = func(*args, **(kwargs or {}))
            self.seconds[name] += time.perf_counter() - t0
            if name != "wait_tensor":
                self._count(name, [t for t in (
                    out if isinstance(out, (list, tuple)) else [out])
                    if isinstance(t, torch.Tensor)])
            return out

    return CollectiveTally()


def dtensor_ops():
    """A dispatch mode that counts the ATen ops dispatched on DTensors
    under it, by op name: each costs DTensor's sharding propagation on
    the host.  Ops on plain tensors (those ``local_map`` runs on each
    rank's blocks, the local ops DTensor issues) are not counted::

        with dtensor_ops() as ops:
            applied(params, batch)
        sum(ops.calls.values())

    Returns:
        The mode (a context manager), with a ``calls`` counter.
    """
    import collections

    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class DTensorOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                self.calls[str(func.overloadpacket)] += 1
                return NotImplemented
            return func(*args, **(kwargs or {}))

    return DTensorOps()


def gathered_shapes(shape) -> list:
    """The shapes an all-gather whose raw result is ``shape`` may hand
    back.  ``collective_tally`` sees the functional all-gather's raw
    result, the blocks stacked on dim 0; the caller gets that, or for a
    group of 2, 4 or 8 the blocks joined on another dim."""
    out = [tuple(shape)]
    for n in (2, 4, 8):
        if len(shape) > 1 and shape[0] % n == 0:
            out += [(shape[0] // n, *shape[1:k], shape[k] * n,
                     *shape[k + 1:]) for k in range(1, len(shape))]
    return out


# ---------------------------------------------------------------------------
# a group of ranks on this host
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, world_size, init_method, args, results) -> None:
    """One rank: join the group, run ``fn(rank, *args)``, report."""
    import faulthandler

    import torch
    import torch.distributed as dist
    # a rank that dies on a signal prints its Python stacks first
    faulthandler.enable(all_threads=True)
    try:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        os.environ["LOCAL_RANK"] = str(rank)
        dist.init_process_group("gloo", init_method=init_method,
                                rank=rank, world_size=world_size)
        out = fn(rank, *args)
        results.put((rank, True, pickle.dumps(out)))
    except Exception:  # noqa: BLE001 — reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *args,
              timeout: float = 300.0) -> list[Any]:
    """Run ``fn(rank, *args)`` in ``world_size`` new processes, one gloo
    process group (CPU tensors, and CUDA tensors through host copies).

    Each rank is a process started with the ``spawn`` method; the group
    meets through a file in a temporary directory (no TCP port, so any
    number of groups may run at once on one host) and ``LOCAL_RANK`` is
    the rank.  ``fn`` must be importable by name (a module-level
    function), and its arguments and results picklable.

    Args:
        fn: the rank's work; its result is returned to the caller.
        world_size: the number of ranks.
        *args: passed to every rank after its rank.
        timeout: wall-clock seconds for the whole group.

    Returns:
        Each rank's result, in rank order.

    Raises:
        RuntimeError: carrying the traceback of the first rank that
            failed, or naming a rank that died without a result.
        TimeoutError: when the group outlives ``timeout``.
        Every rank still running is stopped before this returns or raises.
    """
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, init, args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        done: dict[int, Any] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(done) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{world_size} ranks of {getattr(fn, '__name__', fn)} "
                        f"outlived {timeout:.0f} s; ranks "
                        f"{sorted(set(range(world_size)) - set(done))} had "
                        f"not finished")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode is not None]
                    if dead:
                        # its report may still be in the pipe
                        try:
                            rank, ok, payload = results.get(timeout=5.0)
                        except queue.Empty:
                            raise RuntimeError(
                                f"rank {dead[0]} exited with code "
                                f"{procs[dead[0]].exitcode} without a "
                                f"result") from None
                    else:
                        continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} "
                                       f"failed:\n{payload}")
                done[rank] = pickle.loads(payload)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [done[r] for r in range(world_size)]
