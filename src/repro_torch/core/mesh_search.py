"""Mesh-shape co-search: enumerate candidate device-mesh factorizations.

TOAST's search chooses *how to shard a program over a given mesh*; this
module supplies the outer loop's decision space — *which mesh to build
from a device budget*.  Given ``N`` devices (and optionally a set of pod
counts whose links cross DCN instead of ICI), it enumerates every
factorization ``N = pod × a₁ × … × aₖ`` as a :class:`MeshSpec`
candidate:

- **divisor-based**: ICI axis sizes are the non-increasing integer
  factorizations of ``N / pod`` with every factor ≥ 2 (a size-1 axis
  shards nothing), at most :data:`MAX_ICI_AXES` axes — e.g. for 16
  single-pod devices: ``(16,)``, ``(8, 2)``, ``(4, 4)``, ``(4, 2, 2)``;
- **deduped up to axis renaming**: the cost model treats mesh axes as
  interchangeable labels except for their bandwidth class, so two meshes
  with equal (DCN sizes, sorted ICI sizes) are the same candidate and
  only one is emitted — ``8x2`` and ``2x8`` are one mesh, and ``16x1``
  collapses to the 1-axis ``16``;
- **pruned by a replicated-state memory lower bound** before any search:
  for a candidate mesh, no plan's per-device peak can fall below the
  unsharded peak divided by the product of *usable* axis sizes (an axis
  is usable only when some program dim size is divisible by it), so
  candidates whose bound already exceeds the memory budget are marked
  ``pruned`` and never searched.

The per-candidate searches themselves run through
``repro_torch.api.Session.co_search`` (one mesh-independent analysis
shared by every candidate via ``CostModel.with_mesh``).  A copy of the
reference's ``core/mesh_search.py`` over the port's ``MeshSpec``.

Cross-mesh cost comparability: the paper cost ``C(s) = RT(s) + MP(s)``
normalizes by the *unsharded* runtime and peak, both of which are
mesh-independent (the unsharded program does no collectives), so plans
searched on different candidate meshes under one ``HardwareSpec`` are
directly comparable by ``plan.cost``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

from repro_torch.core.cost_model import MeshSpec

#: ICI axis names by axis count, matching the reference's launch-side
#: conventions (its zoo driver's ``parse_mesh``): the outermost axis is
#: ``data``.
ICI_AXIS_NAMES = {
    1: ("model",),
    2: ("data", "model"),
    3: ("data", "seq", "model"),
}

#: Name of the cross-pod (DCN) mesh axis.
POD_AXIS = "pod"

#: Most ICI axes a candidate mesh may have (4D total with a pod axis).
MAX_ICI_AXES = 3


@dataclasses.dataclass(frozen=True)
class MeshCandidate:
    """One candidate mesh factorization of a device budget.

    Attributes:
        mesh: the candidate ``MeshSpec`` (``dcn_axes`` set for multi-pod
            candidates).
        peak_lower_bound: lower bound on any plan's per-device peak
            memory on this mesh, bytes (see :func:`peak_lower_bound`);
            ``None`` when no program information was supplied.
        pruned: True when the bound already exceeds the memory budget —
            no feasible plan exists, so the candidate is never searched.
    """

    mesh: MeshSpec
    peak_lower_bound: float | None = None
    pruned: bool = False

    @property
    def mesh_str(self) -> str:
        """The ``"4x2"``-style size string of the candidate mesh."""
        return "x".join(str(s) for s in self.mesh.sizes)


def factorizations(n: int, max_factors: int = MAX_ICI_AXES
                   ) -> list[tuple[int, ...]]:
    """All multiplicative factorizations of ``n`` into factors ≥ 2.

    Factor tuples are non-increasing, so each multiset of factors is
    produced exactly once — the dedup-up-to-renaming the mesh enumerator
    relies on.  ``n == 1`` yields the single empty factorization.

    Args:
        n: the product to factorize (≥ 1).
        max_factors: maximum number of factors per tuple.

    Returns:
        Every non-increasing tuple of integers ≥ 2 with product ``n``
        and length ≤ ``max_factors``, largest-first ordering.
    """
    if n < 1:
        raise ValueError(f"cannot factorize non-positive n={n}")
    out: list[tuple[int, ...]] = []

    def rec(rem: int, cap: int, prefix: list[int]) -> None:
        if rem == 1:
            out.append(tuple(prefix))
            return
        if len(prefix) >= max_factors:
            return
        for f in range(min(cap, rem), 1, -1):
            if rem % f == 0:
                prefix.append(f)
                rec(rem // f, f, prefix)
                prefix.pop()

    rec(n, n, [])
    return out


def mesh_for_factors(ici_sizes: tuple[int, ...], pod: int = 1) -> MeshSpec:
    """Build the canonical ``MeshSpec`` for one factorization.

    Args:
        ici_sizes: non-increasing ICI axis sizes (each ≥ 2, possibly
            empty); named per :data:`ICI_AXIS_NAMES`.
        pod: pod count; ``> 1`` prepends a ``pod`` axis marked as DCN.

    Returns:
        The candidate ``MeshSpec``.  A degenerate single-device budget
        (no ICI factors, one pod) maps to the 1-axis mesh ``model=1``.
    """
    if not ici_sizes and pod <= 1:
        return MeshSpec(("model",), (1,))
    names = ICI_AXIS_NAMES[len(ici_sizes)] if ici_sizes else ()
    if pod > 1:
        return MeshSpec((POD_AXIS,) + names, (pod,) + tuple(ici_sizes),
                        dcn_axes=(POD_AXIS,))
    return MeshSpec(names, tuple(ici_sizes))


def enumerate_meshes(devices: int, *, pods: Iterable[int] = (1,),
                     max_ici_axes: int = MAX_ICI_AXES) -> list[MeshSpec]:
    """Enumerate candidate meshes for a device budget.

    Args:
        devices: total device count every candidate must multiply to.
        pods: pod counts to consider; counts that do not divide
            ``devices`` (or are < 1) are skipped.  ``1`` means a
            single-pod, all-ICI mesh.
        max_ici_axes: most ICI axes per candidate (≤ 3 — names run out
            past ``data``/``seq``/``model``).

    Returns:
        Deduplicated candidate ``MeshSpec``s: for each admissible pod
        count, one mesh per factorization of ``devices // pod``
        (dedup up to axis renaming is inherent — factor tuples are
        canonical non-increasing).

    Raises:
        ValueError: on a non-positive device budget or
            ``max_ici_axes`` outside 1..3.
    """
    if devices < 1:
        raise ValueError(f"device budget must be >= 1, got {devices}")
    if not 1 <= max_ici_axes <= MAX_ICI_AXES:
        raise ValueError(f"max_ici_axes must be in 1..{MAX_ICI_AXES}, "
                         f"got {max_ici_axes}")
    out: list[MeshSpec] = []
    for pod in sorted({int(p) for p in pods}):
        if pod < 1 or devices % pod:
            continue
        for fac in factorizations(devices // pod, max_ici_axes):
            out.append(mesh_for_factors(fac, pod))
    return out


def usable_shard_factor(mesh: MeshSpec, dim_sizes: Iterable[int]) -> int:
    """Product of mesh-axis sizes that could shard *some* program dim.

    An axis of size ``s`` can only ever shard a dim whose size is
    divisible by ``s`` (the cost model's divisibility rule), so an axis
    dividing no program dim contributes nothing to any plan.  The
    product over usable axes is therefore an upper bound on the total
    sharding factor any single value can reach.

    Args:
        mesh: candidate mesh.
        dim_sizes: the program's tensor dimension sizes (a set works).

    Returns:
        The product of usable axis sizes (≥ 1).
    """
    dims = {int(d) for d in dim_sizes if d}
    f = 1
    for s in mesh.sizes:
        if s > 1 and any(d % s == 0 for d in dims):
            f *= s
    return f


def peak_lower_bound(mesh: MeshSpec, dim_sizes: Iterable[int],
                     base_peak: float) -> float:
    """Lower bound on any plan's per-device peak memory on ``mesh``.

    The replicated (unsharded) state's peak divided by
    :func:`usable_shard_factor` — no sharding state can spread a value
    over more than the usable axes, so no plan's peak can fall below
    this.  Used to prune candidate meshes before any search.

    Args:
        mesh: candidate mesh.
        dim_sizes: the program's tensor dimension sizes.
        base_peak: the unsharded state's peak live bytes (mesh-
            independent; ``CostModel._base_peak``).

    Returns:
        The bound in bytes.
    """
    return float(base_peak) / usable_shard_factor(mesh, dim_sizes)


def candidate_meshes(devices: int, *, pods: Iterable[int] = (1,),
                     max_ici_axes: int = MAX_ICI_AXES,
                     dim_sizes: Iterable[int] | None = None,
                     base_peak: float | None = None,
                     memory_budget: float | None = None
                     ) -> list[MeshCandidate]:
    """Enumerate and (optionally) prune candidate meshes for a budget.

    Args:
        devices: total device count.
        pods: pod counts to consider (see :func:`enumerate_meshes`).
        max_ici_axes: most ICI axes per candidate.
        dim_sizes: program tensor dim sizes, for the memory bound.
        base_peak: unsharded peak live bytes, for the memory bound.
        memory_budget: per-device memory budget in bytes
            (``HardwareSpec.hbm_per_chip``); candidates whose bound
            exceeds it are marked ``pruned``.

    Returns:
        One :class:`MeshCandidate` per deduplicated factorization, in
        enumeration order; bounds are ``None`` unless both ``dim_sizes``
        and ``base_peak`` were supplied.
    """
    dims = None if dim_sizes is None else list(dim_sizes)
    cands = []
    for mesh in enumerate_meshes(devices, pods=pods,
                                 max_ici_axes=max_ici_axes):
        bound = None
        if dims is not None and base_peak is not None:
            bound = peak_lower_bound(mesh, dims, base_peak)
        pruned = bool(bound is not None and memory_budget is not None
                      and bound > memory_budget)
        cands.append(MeshCandidate(mesh, bound, pruned))
    return cands
