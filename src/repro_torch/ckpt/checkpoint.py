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

Leaves are restored onto one device; restoring onto shardings (the
reference's elastic re-shard) is ROADMAP queue 1, item 8b.
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

# the reference's .npy descr for a bfloat16 leaf, and the int16 one the
# port writes in its place before patching the header (same length)
_BF16_DESCR = b"'<V2'"
_INT16_DESCR = b"'<i2'"


def _host(leaf) -> tuple[np.ndarray, str]:
    """``leaf`` as a host numpy array (bfloat16 as its int16 bits) and
    the manifest's dtype name."""
    if isinstance(leaf, torch.Tensor):
        x = leaf.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy(), "bfloat16"
        arr = x.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


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

    Args:
        directory: the checkpoint directory (created if missing).
        step: the step the tree belongs to.
        tree: a pytree of tensors or numpy arrays.

    Returns:
        The committed directory.
    """
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
            a tensor leaf's dtype) must match the stored one.
        shardings: not supported yet (ROADMAP queue 1, item 8b).
        device: where to place every leaf (``None``: each ``like``
            tensor's own device; the CPU for other leaves).

    Returns:
        A tree shaped like ``like`` holding tensors.

    Raises:
        KeyError: for a leaf path the checkpoint lacks.
        ValueError: for a shape or dtype that differs from ``like``'s.
        NotImplementedError: when ``shardings`` is given.
    """
    if shardings is not None:
        raise NotImplementedError(
            "restoring onto shardings is not ported yet (ROADMAP queue 1, "
            "item 8b)")
    directory = pathlib.Path(directory) / f"step_{step:08d}"
    manifest = json.loads((directory / "manifest.json").read_text())
    by_path = {e["path"]: e for e in manifest["leaves"]}
    leaves, paths = pytree.flatten_with_paths(like)
    out = []
    for leaf, path in zip(leaves, paths):
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
        dev = device if device is not None else (
            leaf.device if is_tensor else "cpu")
        out.append(t.to(dev))
    return pytree.unflatten(like, out)


class CheckpointManager:
    """Saves, async saves, retention and restore in one directory.

    Attributes:
        directory: the checkpoint directory.
        keep: how many committed checkpoints to keep.
        saves: one record per finished save: ``step``, ``bytes``,
            ``snapshot_s`` (the host copy of an async save, else
            ``None``) and ``write_s`` (writing and committing the files).
    """

    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self.saves: list[dict] = []
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def _write(self, step: int, tree: Any, snapshot_s) -> None:
        t0 = time.perf_counter()
        save(self.directory, step, tree)
        self._gc()
        self.saves.append({
            "step": step, "snapshot_s": snapshot_s,
            "write_s": time.perf_counter() - t0,
            "bytes": sum(map(_nbytes, pytree.tree_leaves(tree)))})

    def save(self, step: int, tree: Any) -> None:
        """Write ``tree`` as ``step`` now, then apply retention."""
        self._write(step, tree, None)

    def save_async(self, step: int, tree: Any) -> None:
        """Copy ``tree`` to host memory now; write it on a background
        thread (waiting first for the previous write)."""
        self.wait()
        t0 = time.perf_counter()
        host_tree = pytree.tree_map(
            lambda x: x.detach().to("cpu", copy=True)
            if isinstance(x, torch.Tensor) else np.array(x), tree)
        snapshot_s = time.perf_counter() - t0

        def work():
            try:
                self._write(step, host_tree, snapshot_s)
            except BaseException as e:        # noqa: BLE001
                self._error = e               # raised by wait()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Wait for the background write; raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

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
