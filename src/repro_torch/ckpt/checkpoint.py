"""Atomic, async checkpointing in the reference's layout.

Layout (the reference's ``ckpt/checkpoint.py``, file for file)::

    <dir>/step_00000042.tmp/...      (in-flight)
    <dir>/step_00000042/             (committed via atomic rename)
        manifest.json              (step; per leaf: key path, file, shape,
                                    dtype)
        leaf_00000.npy ...         (one file per pytree leaf)

Leaves are keyed by ``pytree.flatten_with_paths``, which spells paths as
the reference's ``jax.tree_util.keystr`` (``.params['embed']``), so the
two packages read each other's checkpoints.  The files are the
reference's byte for byte: the same manifest and the same ``.npy``
files.  A bfloat16 leaf is stored as the reference stores it, two bytes
per element under the ``.npy`` descr ``<V2`` (what numpy writes for
``ml_dtypes.bfloat16``), with ``"dtype": "bfloat16"`` in the manifest;
the port reads it back through an ``int16`` view as ``torch.bfloat16``,
with no ``ml_dtypes``.  (The reference's own ``restore`` cannot read it:
``np.load`` returns a ``|V2`` array, which ``jax.device_put`` refuses.)

- **Atomic commit** — a checkpoint is visible only after the tmp-dir
  rename; a crash mid-write never corrupts the latest checkpoint.
- **Async save** — ``CheckpointManager.save_async`` copies every leaf to
  host memory before it returns (a donated train state is overwritten
  in place by the next step, so the copy cannot trail it) and writes the
  files on a background thread, overlapping the next steps.
- **Retention** — keeps the last ``keep`` checkpoints, deleting older ones
  only after a newer commit succeeds.
- **Shards in, shards out** — a tree of DTensors (a state placed on a
  mesh of ranks) is saved as whole arrays: every rank makes each leaf
  whole on the host, leaf by leaf in flattening order (a collective:
  every rank saves the same tree at the same step), and rank 0 alone
  writes and commits, the same files a one-device save of the same
  values writes; ``wait()`` ends with a barrier on the group, so no rank
  looks for the checkpoint before it is committed.  ``restore(...,
  shardings=)`` places each leaf as a :class:`NamedSharding` says: every
  rank reads each file and keeps its own block, with no collective, so
  a checkpoint of N ranks restores on M ranks or on one device (the
  reference's elastic re-shard).
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.launch.mesh import (NamedSharding, distribute, group_rank,
                                    group_size)
from repro_torch.models.sharding import is_dtensor

# the reference's .npy descr for a bfloat16 leaf, and the int16 one the
# port writes in its place before patching the header (same length)
_BF16_DESCR = b"'<V2'"
_INT16_DESCR = b"'<i2'"


def _to_host(x):
    """A leaf copied to the host: a tensor (a DTensor made whole, see
    :func:`_gather_host`) or a numpy array."""
    if not isinstance(x, torch.Tensor):
        return np.array(x)
    if is_dtensor(x):
        return _gather_host(x)
    return x.detach().to("cpu", copy=True)


def _host(leaf) -> tuple[np.ndarray, str]:
    """``leaf`` as a host numpy array (bfloat16 as its int16 bits) and
    the manifest's dtype name."""
    if isinstance(leaf, torch.Tensor):
        x = _gather_host(leaf) if is_dtensor(leaf) else leaf.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy(), "bfloat16"
        arr = x.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _gather_host(x) -> torch.Tensor:
    """A DTensor made whole on the host.

    Each mesh dim that shards the tensor evenly is gathered over its own
    group with the local shards on the host, the last mesh dim first (a
    dim sharded over several mesh dims is split by them left to right);
    the rank's shard is copied off the card once and nothing whole is
    made there.  A strided shard, a pending sum or an uneven shard is
    made whole by DTensor instead, on the device, and then copied.
    Every rank of the mesh must call this for the same leaf.
    """
    import torch.distributed as dist
    from torch.distributed.tensor.placement_types import _StridedShard
    mesh, placements = x.device_mesh, tuple(x.placements)
    local = x.to_local().detach()
    shape = list(x.shape)
    ways = {}
    for i, p in enumerate(placements):
        if isinstance(p, _StridedShard) or p.is_partial():
            return x.full_tensor().cpu()
        if p.is_shard():
            ways[p.dim] = ways.get(p.dim, 1) * mesh.size(i)
    if any(shape[d] % n for d, n in ways.items()):
        return x.full_tensor().cpu()
    local = local.cpu()
    for i in reversed(range(len(placements))):
        p = placements[i]
        if not p.is_shard():
            continue
        n = mesh.size(i)
        part = local.movedim(p.dim, 0).contiguous()
        out = part.new_empty((n * part.shape[0], *part.shape[1:]))
        dist.all_gather_into_tensor(out, part, group=mesh.get_group(i))
        local = out.movedim(0, p.dim)
    return local.contiguous()


def _block(t: torch.Tensor, sharding: NamedSharding, device):
    """Rank's block of the whole host tensor ``t`` as a DTensor placed
    as ``sharding`` says, its local tensor on ``device`` (no collective).

    Each mesh dim that shards ``t`` splits what is left of its dim, left
    to right, as DTensor's ``Shard`` does; only the block is copied to
    the device.  A strided or uneven shard is split by
    ``distribute_tensor`` (``launch.mesh.distribute``), which moves the
    whole leaf to the device first.
    """
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import _StridedShard
    mesh = sharding.mesh
    placements = sharding.placements(t.ndim)
    coord = mesh.get_coordinate()
    block = t
    for i, p in enumerate(placements):
        # torch 2.13's strided shard is no Shard (2.11's is): tested first
        if isinstance(p, _StridedShard):
            return distribute(t.to(device), sharding)
        if not p.is_shard():
            continue
        n = mesh.size(i)
        if block.shape[p.dim] % n:
            return distribute(t.to(device), sharding)
        block = block.chunk(n, p.dim)[coord[i]]
    local = torch.empty(block.shape, dtype=block.dtype, device=device)
    local.copy_(block)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return np.asarray(leaf).nbytes


def _write_leaf(path: pathlib.Path, arr: np.ndarray, dtype: str) -> None:
    np.save(path, arr)
    if dtype == "bfloat16":
        with open(path, "r+b") as f:
            head = f.read(128)
            at = head.find(_INT16_DESCR)
            if at < 0:
                raise RuntimeError(f"{path}: no int16 descr in the header")
            f.seek(at)
            f.write(_BF16_DESCR)


def _read_leaf(path: pathlib.Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(directory: str | pathlib.Path, step: int, tree: Any) -> pathlib.Path:
    """Write ``tree`` as ``<directory>/step_<step>``, committed by an
    atomic rename.

    A tree with DTensor leaves is made whole leaf by leaf on every rank
    of the group (a collective) and written by rank 0 alone.

    Args:
        directory: the checkpoint directory (created if missing).
        step: the step the tree belongs to.
        tree: a pytree of tensors (DTensors too) or numpy arrays.

    Returns:
        The committed directory (on ranks other than 0: where rank 0
        commits it).
    """
    if group_rank() != 0:
        for leaf in pytree.tree_leaves(tree):
            _to_host(leaf)
        return pathlib.Path(directory) / f"step_{step:08d}"
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves, paths = pytree.flatten_with_paths(tree)
    manifest = {"step": step, "leaves": []}
    for i, (leaf, path) in enumerate(zip(leaves, paths)):
        arr, dtype = _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        _write_leaf(tmp / fname, arr, dtype)
        manifest["leaves"].append(
            {"path": path, "file": fname, "shape": list(arr.shape),
             "dtype": dtype})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic commit
    return final


def latest_step(directory: str | pathlib.Path) -> int | None:
    """The newest committed step in ``directory``, or ``None``."""
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.iterdir()
             if p.is_dir() and p.name.startswith("step_")
             and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def restore(directory: str | pathlib.Path, step: int, like: Any,
            shardings: Any = None, device=None) -> Any:
    """Restore step ``step`` into the structure of ``like``.

    Args:
        directory: the checkpoint directory.
        step: the committed step to read.
        like: a tree with the target structure; each leaf's shape (and
            a tensor leaf's dtype) must match the stored one (``meta``
            tensors suffice).
        shardings: ``None``, or a tree of :class:`NamedSharding` shaped
            like ``like``: each rank keeps its block of each leaf, a
            DTensor on the sharding's mesh (no collective; the whole leaf
            is read on the host).
        device: where to place every leaf (``None``: the mesh's device
            with ``shardings``, else each ``like`` tensor's own device,
            the CPU for other leaves and for ``meta`` ones).

    Returns:
        A tree shaped like ``like`` holding tensors (DTensors with
        ``shardings``).

    Raises:
        KeyError: for a leaf path the checkpoint lacks.
        ValueError: for a shape or dtype that differs from ``like``'s, or
            a ``shardings`` tree of another length.
    """
    directory = pathlib.Path(directory) / f"step_{step:08d}"
    manifest = json.loads((directory / "manifest.json").read_text())
    by_path = {e["path"]: e for e in manifest["leaves"]}
    leaves, paths = pytree.flatten_with_paths(like)
    if shardings is None:
        placed = [None] * len(leaves)
    else:
        placed = pytree.tree_leaves(shardings)
        if len(placed) != len(leaves):
            raise ValueError(f"{len(placed)} shardings for {len(leaves)} "
                             f"leaves")
    out = []
    for leaf, path, sharding in zip(leaves, paths, placed):
        entry = by_path.get(path)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {path}")
        t = _read_leaf(directory / entry["file"], entry["dtype"])
        if tuple(t.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"shape mismatch at {path}: "
                             f"{tuple(t.shape)} vs {tuple(np.shape(leaf))}")
        is_tensor = isinstance(leaf, torch.Tensor)
        if is_tensor and t.dtype != leaf.dtype:
            raise ValueError(f"dtype mismatch at {path}: {t.dtype} vs "
                             f"{leaf.dtype}")
        if sharding is not None:
            dev = device if device is not None else _mesh_device(
                sharding.mesh)
            out.append(_block(t, sharding, dev))
            continue
        dev = device if device is not None else (
            leaf.device if is_tensor and leaf.device.type != "meta"
            else "cpu")
        out.append(t.to(dev))
    return pytree.unflatten(like, out)


def _mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh`` (its current card on CUDA)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class CheckpointManager:
    """Saves, async saves, retention and restore in one directory.

    In a process group of two or more ranks every rank calls the same
    saves at the same steps (each is a collective when the tree holds
    DTensors), rank 0 alone writes, and :meth:`wait` ends with a barrier
    on the group.

    Attributes:
        directory: the checkpoint directory.
        keep: how many committed checkpoints to keep.
        saves: one record per finished save: ``step``, ``bytes`` (the
            whole tree), ``local_bytes`` (what this rank copied off its
            device: its shards of DTensor leaves, other leaves whole),
            ``snapshot_s`` (the host copy of an async save, else
            ``None``) and ``write_s`` (writing and committing the files;
            ``None`` on ranks other than 0, which write nothing).
    """

    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self.saves: list[dict] = []
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    @staticmethod
    def _sizes(tree: Any) -> dict:
        leaves = pytree.tree_leaves(tree)
        return {"bytes": sum(map(_nbytes, leaves)),
                "local_bytes": sum(
                    _nbytes(x.to_local() if is_dtensor(x) else x)
                    for x in leaves)}

    def _write(self, step: int, tree: Any) -> float | None:
        """Write ``tree`` and apply retention (rank 0); the seconds it
        took, ``None`` on other ranks."""
        t0 = time.perf_counter()
        save(self.directory, step, tree)
        if group_rank() != 0:
            return None
        self._gc()
        return time.perf_counter() - t0

    def save(self, step: int, tree: Any) -> None:
        """Write ``tree`` as ``step`` now, then apply retention."""
        sizes = self._sizes(tree)
        self.saves.append({"step": step, "snapshot_s": None,
                           "write_s": self._write(step, tree), **sizes})

    def save_async(self, step: int, tree: Any) -> None:
        """Copy ``tree`` to host memory now (DTensor leaves made whole,
        a collective); rank 0 writes it on a background thread (waiting
        first for the previous write)."""
        self.wait(sync=False)
        t0 = time.perf_counter()
        host_tree = pytree.tree_map(_to_host, tree)
        snapshot_s = time.perf_counter() - t0
        sizes = self._sizes(tree)
        if group_rank() != 0:
            self.saves.append({"step": step, "snapshot_s": snapshot_s,
                               "write_s": None, **sizes})
            return

        def work():
            try:
                write_s = self._write(step, host_tree)
                self.saves.append({"step": step, "snapshot_s": snapshot_s,
                                   "write_s": write_s, **sizes})
            except BaseException as e:        # noqa: BLE001
                self._error = e               # raised by wait()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self, *, sync: bool = True) -> None:
        """Wait for the background write; raise its error, if any.

        Args:
            sync: in a group of two or more ranks, end with a barrier on
                the group, so that every rank finds the write committed
                (every rank must call it then).
        """
        try:
            if self._thread is not None:
                self._thread.join()
                self._thread = None
            if self._error is not None:
                err, self._error = self._error, None
                raise err
        finally:
            if sync and group_size() > 1:
                import torch.distributed as dist
                dist.barrier()

    def latest_step(self) -> int | None:
        """The newest committed step, or ``None``."""
        return latest_step(self.directory)

    def restore(self, like: Any, step: int | None = None,
                shardings: Any = None, device=None) -> tuple[int, Any]:
        """Restore ``step`` (default: the latest) into ``like``'s
        structure; see :func:`restore`.

        Returns:
            ``(step, tree)``.

        Raises:
            FileNotFoundError: when the directory holds no checkpoint.
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return step, restore(self.directory, step, like, shardings, device)

    def _gc(self) -> None:
        steps = sorted(p for p in self.directory.iterdir()
                       if p.is_dir() and p.name.startswith("step_")
                       and not p.name.endswith(".tmp"))
        for p in steps[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)
