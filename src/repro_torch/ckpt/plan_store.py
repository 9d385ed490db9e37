"""Persistent ``ShardingPlan`` cache keyed by (program, mesh, hardware).

Searching a sharding plan costs seconds to minutes; the plan itself is a
few KiB of JSON.  ``PlanStore`` therefore memoizes ``auto_partition``
results on disk so that repeated partitioning of an unchanged program on
an unchanged mesh is a file read, not a re-search — the portfolio-style
reuse that makes zoo-wide driving practical.  A copy of the reference's
``ckpt/plan_store.py``: for the same fingerprint string, mesh, hardware
fields and params its keys are the reference's, bit for bit.  The
port's program fingerprints are its own (``torch.export`` programs
differ from the reference's in a few no-op ops), and its
``HardwareSpec`` defaults describe an H100, so a store is not shared
between the two packages.

Keying (schema v2):

- the **program fingerprint** — a deterministic SHA-256 over the
  extracted tensor program (``repro_torch.core.ir.program_fingerprint``); no
  ``id()``-based components, so keys are stable across processes;
- the **mesh** (axis names, sizes, DCN axes);
- the **hardware spec** (all roofline constants, including the memory
  budget — a plan feasible on 80 GB cards may be infeasible on 40 GB);
- the **canonical request parameters** that change the search outcome:
  ``min_dims`` action-space pruning, declared ``logical_axes``
  (canonicalized — list vs tuple spellings and all-``None``
  declarations collapse to one key), and the user **constraints**
  (canonical tuple forms) — the search *backend* is deliberately not
  part of the key, so any backend can reuse any backend's plan.

The schema is versioned and backward-readable: reads try the v2 key
first and, for constraint-free requests, fall back to the legacy v1
key (``repr``-based params), so stores written by older code stay
warm.  Writes always use v2.

Layout: one ``<key>.json`` file per entry under the store directory,
containing the metadata triple plus the full plan
(``ShardingPlan.as_dict``); calibrated ``HardwareSpec``s live under
``hardware/<name>.json`` (:meth:`PlanStore.save_hardware`).  Writes are
atomic (per-process temp file + rename), so a crashed writer never
leaves a truncated entry behind and concurrent workers cannot tear
each other's entries; temp files orphaned by a killed process are swept
on store open once they age past ``PlanStore.STALE_TMP_SECONDS``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import tempfile
import time

from repro_torch.core.actions import DEFAULT_MIN_DIMS
from repro_torch.core.constraints import (canonical_constraints,
                                          canonical_logical_axes)
from repro_torch.core.cost_model import HardwareSpec, MeshSpec
from repro_torch.core.partitioner import ShardingPlan

PLAN_KEY_SCHEMA = 2


def canonical_request_params(params: dict | None) -> dict:
    """Canonicalize request parameters for keying.

    Spellings that describe the same request — ``logical_axes`` as
    lists vs tuples (or declared but all-``None``), constraints as
    objects vs canonical tuples, absent vs default ``min_dims`` — all
    map to one canonical dict, hence one cache key (the v1 scheme
    keyed on raw ``repr`` and split them).

    Args:
        params: raw params dict (``min_dims``, ``logical_axes``,
            ``constraints``) or ``None``.

    Returns:
        ``{"min_dims": int, "logical_axes": tuple | None,
        "constraints": tuple}``.
    """
    p = dict(params or {})
    min_dims = p.get("min_dims")
    return {
        "min_dims": DEFAULT_MIN_DIMS if min_dims is None else int(min_dims),
        "logical_axes": canonical_logical_axes(p.get("logical_axes")),
        "constraints": canonical_constraints(p.get("constraints") or ()),
    }


def _jsonify(x):
    if isinstance(x, (tuple, list)):
        return [_jsonify(e) for e in x]
    if isinstance(x, dict):
        return {k: _jsonify(v) for k, v in x.items()}
    return x


# HardwareSpec fields added after the v2 key schema shipped.  At their
# defaults they are dropped from cache keys so every pre-existing store
# entry keyed under the six original fields stays warm; a *calibrated*
# spec (non-default values) keys distinctly, as it must — plans searched
# under different rooflines are different plans.
_HW_LATER_FIELD_DEFAULTS = (("coll_latency", 0.0), ("axis_bw", ()))


def _hw_key_fields(hw: HardwareSpec) -> list[tuple[str, object]]:
    out = []
    for f in dataclasses.fields(hw):
        v = getattr(hw, f.name)
        if (f.name, v) in _HW_LATER_FIELD_DEFAULTS:
            continue
        out.append((f.name, v))
    return out


def plan_key(fingerprint: str, mesh: MeshSpec,
             hw: HardwareSpec | None = None,
             params: dict | None = None) -> str:
    """Legacy (schema v1) cache key, kept for backward reads.

    Raw ``repr`` of the params values, no constraints, no
    canonicalization.  New entries are written under
    :func:`plan_key_v2`; this form is only computed as a read fallback
    so stores written by older code stay warm.

    Args:
        fingerprint: program fingerprint from
            ``repro_torch.core.ir.program_fingerprint``.
        mesh: the mesh the plan targets.
        hw: hardware spec (defaults used when ``None``).
        params: request parameters affecting the plan (sorted into the
            key via ``repr``; values must have deterministic reprs).

    Returns:
        A 64-char hex SHA-256 key.
    """
    hw = hw or HardwareSpec()
    parts = [
        f"prog:{fingerprint}",
        f"mesh:{mesh.as_dict()}",
        "hw:" + ":".join(f"{name}={value!r}"
                         for name, value in _hw_key_fields(hw)),
        "params:" + ":".join(f"{k}={params[k]!r}"
                             for k in sorted(params or {})),
    ]
    return hashlib.sha256("\x00".join(parts).encode()).hexdigest()


def plan_key_v2(fingerprint: str, mesh: MeshSpec,
                hw: HardwareSpec | None = None,
                params: dict | None = None) -> str:
    """Schema-v2 cache key: canonical request params, constraints included.

    The key covers everything that changes the *search outcome*: the
    program, the mesh, the hardware constants, and the canonical request
    parameters (``min_dims``, ``logical_axes``, ``constraints``).  The
    search *backend* is deliberately excluded — reusing a plan found by
    a different backend is the point of the cache (Automap-style result
    reuse).

    Args:
        fingerprint: program fingerprint from
            ``repro_torch.core.ir.program_fingerprint``.
        mesh: the mesh the plan targets.
        hw: hardware spec (defaults used when ``None``).
        params: raw request params; canonicalized via
            :func:`canonical_request_params` before hashing, so
            equivalent spellings share one key.

    Returns:
        A 64-char hex SHA-256 key.
    """
    hw = hw or HardwareSpec()
    payload = {
        "schema": PLAN_KEY_SCHEMA,
        "prog": fingerprint,
        "mesh": mesh.as_dict(),
        "hw": {name: _jsonify(value)
               for name, value in _hw_key_fields(hw)},
        "params": _jsonify(canonical_request_params(params)),
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def _legacy_candidate_params(params: dict | None) -> list[dict]:
    """v1 params spellings an old writer may have used for this request."""
    canon = canonical_request_params(params)
    if canon["constraints"]:
        return []                   # constraints never existed under v1
    la = canon["logical_axes"]
    legacy_la = None if la is None else \
        [tuple(e) if e is not None else None for e in la]
    out = [{"min_dims": canon["min_dims"], "logical_axes": legacy_la}]
    raw = dict(params or {})
    raw.pop("constraints", None)
    if raw and raw not in out:
        out.append(raw)             # the caller's exact v1 spelling
    return out


@dataclasses.dataclass
class StoreStats:
    """Hit/miss/write counters for one ``PlanStore`` instance."""

    hits: int = 0
    misses: int = 0
    puts: int = 0

    def as_dict(self) -> dict:
        """Plain-dict view (JSON-serializable)."""
        return dataclasses.asdict(self)


class PlanStore:
    """Directory-backed cache of ``ShardingPlan``s.

    Use it through ``auto_partition``, which consults :meth:`get` before
    searching, :meth:`put`s fresh plans, and keys entries with its own
    request params (``min_dims``, ``logical_axes``)::

        store = PlanStore("results/plan_store")
        plan  = auto_partition(fn, args, mesh, plan_store=store)  # search
        plan2 = auto_partition(fn, args, mesh, plan_store=store)  # hit

    Direct :meth:`get`/:meth:`put` calls work too, but reader and writer
    must agree on the ``params`` dict (and a plan stored via :meth:`put`
    must carry a fingerprint — plain ``auto_partition`` calls without
    ``plan_store=`` leave ``plan.fingerprint`` empty and such plans are
    skipped).
    """

    #: temp files older than this are considered crash leftovers and are
    #: removed when a store is opened (a *live* concurrent writer's temp
    #: is seconds old and survives; see ``put``).
    STALE_TMP_SECONDS = 3600.0

    def __init__(self, directory: str | os.PathLike, *,
                 stale_tmp_seconds: float | None = None) -> None:
        """Open (or lazily create) a store rooted at ``directory``.

        Args:
            directory: store root; created on first write.
            stale_tmp_seconds: age threshold for crash-leftover temp
                cleanup on open (default ``STALE_TMP_SECONDS``).
        """
        self.directory = pathlib.Path(directory)
        self.stats = StoreStats()
        self.stale_tmp_seconds = (self.STALE_TMP_SECONDS
                                  if stale_tmp_seconds is None
                                  else stale_tmp_seconds)
        self._cleanup_stale_tmps()

    def _cleanup_stale_tmps(self) -> int:
        """Remove crash-leftover ``*.tmp`` files older than the threshold.

        Returns:
            How many stale temp files were removed.
        """
        if not self.directory.is_dir():
            return 0
        cutoff = time.time() - self.stale_tmp_seconds
        n = 0
        tmps = list(self.directory.glob("*.tmp")) + \
            list(self.directory.glob("hardware/*.tmp"))
        for p in tmps:
            try:
                if p.stat().st_mtime <= cutoff:
                    p.unlink()
                    n += 1
            except OSError:
                # racing another store's cleanup (or a writer committing)
                # is fine — someone removed it first
                pass
        return n

    def _path(self, key: str) -> pathlib.Path:
        return self.directory / f"{key}.json"

    def get(self, fingerprint: str, mesh: MeshSpec,
            hw: HardwareSpec | None = None,
            params: dict | None = None) -> ShardingPlan | None:
        """Look up a cached plan.

        Args:
            fingerprint: program fingerprint.
            mesh: target mesh.
            hw: hardware spec the plan must have been searched under.
            params: request parameters (see :func:`plan_key`); must match
                the ``put`` that stored the plan.

        Returns:
            The cached :class:`ShardingPlan` with ``cached=True`` and
            ``search_seconds=0``, or ``None`` on a miss (including
            unreadable/corrupt entries, which count as misses).  The v2
            key is tried first; constraint-free requests fall back to
            the legacy v1 key so pre-v2 stores stay readable.
        """
        keys = [plan_key_v2(fingerprint, mesh, hw, params)]
        keys += [plan_key(fingerprint, mesh, hw, p)
                 for p in _legacy_candidate_params(params)]
        seen: set[str] = set()
        for key in keys:
            if key in seen:
                continue
            seen.add(key)
            path = self._path(key)
            if not path.exists():
                continue
            try:
                entry = json.loads(path.read_text())
                plan = ShardingPlan.from_dict(entry["plan"])
            except Exception:   # noqa: BLE001 — a malformed entry is a miss
                continue
            plan.cached = True
            plan.search_seconds = 0.0
            self.stats.hits += 1
            return plan
        self.stats.misses += 1
        return None

    def put(self, plan: ShardingPlan,
            hw: HardwareSpec | None = None,
            params: dict | None = None) -> pathlib.Path | None:
        """Persist ``plan`` under its fingerprint/mesh/hardware key.

        Args:
            plan: the plan to store; must carry a non-empty
                ``plan.fingerprint`` (plans from ``auto_partition(...,
                plan_store=...)`` always do).  Plans without a
                fingerprint are skipped.
            hw: hardware spec the plan was searched under.
            params: request parameters (see :func:`plan_key`).

        Returns:
            The path written, or ``None`` when the plan was skipped.
        """
        if not plan.fingerprint:
            return None
        self.directory.mkdir(parents=True, exist_ok=True)
        path = self._path(plan_key_v2(plan.fingerprint, plan.mesh, hw,
                                      params))
        entry = {
            "schema": PLAN_KEY_SCHEMA,
            "fingerprint": plan.fingerprint,
            "params": _jsonify(canonical_request_params(params)),
            "mesh": plan.mesh.as_dict(),
            "hardware": dataclasses.asdict(hw or HardwareSpec()),
            "plan": plan.as_dict(),
        }
        # per-process temp names: concurrent workers each write their
        # own temp and the os.replace commit is atomic, so two writers on
        # one key cannot interleave into a truncated entry
        fd, tmp = tempfile.mkstemp(dir=self.directory,
                                   prefix=f"put-{os.getpid()}-",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(entry, f, indent=2)
            os.replace(tmp, path)              # atomic commit
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.stats.puts += 1
        return path

    # -- calibrated-hardware round-trip --------------------------------------

    def _hw_path(self, name: str) -> pathlib.Path:
        return self.directory / "hardware" / f"{name}.json"

    def save_hardware(self, hw: HardwareSpec,
                      name: str = "calibrated") -> pathlib.Path:
        """Persist a (calibrated) ``HardwareSpec`` alongside the plans.

        A fitted roofline saved here lets later searches price plans
        with coefficients that track the measured device instead of the
        data-sheet defaults (the reference's measured execution does so;
        in the port it is ROADMAP queue 1, item 14).  Written
        atomically, like plan entries.

        Args:
            hw: the spec to save.
            name: spec name (one store can hold several).

        Returns:
            The path written.
        """
        path = self._hw_path(name)
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent,
                                   prefix=f"put-{os.getpid()}-",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(hw.as_dict(), f, indent=2)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    def load_hardware(self, name: str = "calibrated"
                      ) -> HardwareSpec | None:
        """Load a previously saved ``HardwareSpec``.

        Args:
            name: spec name used at :meth:`save_hardware` time.

        Returns:
            The spec, or ``None`` when absent/unreadable.
        """
        path = self._hw_path(name)
        try:
            return HardwareSpec.from_dict(json.loads(path.read_text()))
        except (OSError, ValueError, TypeError, KeyError):
            return None

    def __len__(self) -> int:
        """Number of committed entries in the store directory."""
        if not self.directory.exists():
            return 0
        return sum(1 for p in self.directory.glob("*.json"))

    def clear(self) -> int:
        """Delete every entry.

        Returns:
            How many entries were removed.
        """
        n = 0
        if self.directory.exists():
            for p in self.directory.glob("*.json"):
                p.unlink()
                n += 1
        return n
