"""User sharding constraints over the TOAST decision space (paper §3).

TOAST searches over *colors* — equivalence classes of tensor dimensions
that must shard identically — which makes user constraints cheap to
enforce: pinning one input dimension pins its whole color, and the
pruned action space keeps every backend inside the constrained subspace
for free.  Three constraint kinds cover the scenarios real users of an
auto-partitioner ask for (Automap / PartIR frame auto-partitioning as an
interactive, constraint-aware dialogue rather than a one-shot call):

- :class:`Pin` — fix the sharding of an input (by path or by declared
  logical dimension name): "the batch dim lives on the data axis".
- :class:`Replicate` — force matching inputs to be fully replicated:
  "never shard the KV cache".
- :class:`Forbid` — ban one mesh axis from a target: "the embedding
  table must not be sharded over ``model``".

``compile_constraints`` lowers a constraint list onto the analyzed
program: every targeted input dimension resolves to its NDA color, and
the result is a :class:`ConstraintSet` of pinned and forbidden
color→axes maps.  The set then

1. **seeds** the search root (`root_state`) with the pinned assignment,
2. **prunes** the action space (`prune`) so no backend can leave the
   constrained subspace, and
3. marks any violating state **infeasible** (`penalty_for`) — the
   belt-and-braces layer for custom backends that synthesize states
   outside the pruned action space.

Because a color spans every dimension that must shard identically,
constraints propagate: replicating an MLP's first weight matrix also
forbids sharding the hidden activation that shares its color.  That is
not a limitation but the decision space itself (paper §3.2).
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import TYPE_CHECKING, Iterable, Sequence

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.core.cost_model import MeshSpec, ShardingState
    from repro_torch.core.ir import Program
    from repro_torch.core.nda import NDAResult


class ConstraintError(ValueError):
    """A constraint is malformed, unsatisfiable, or violated by a plan."""


def match_paths(pattern: str, paths: Sequence[str]) -> list[int]:
    """Indices of ``paths`` matching ``pattern``.

    Matching tries three strategies in order and returns the first
    non-empty result: exact string equality, plain substring containment
    (``"['x']"`` finds ``[0]['x']``), and ``fnmatch`` glob (``"*cache*"``
    — note ``[...]`` is a glob character *class*, so bracketed pytree
    paths are best targeted by substring, keeping ``*`` out of the
    pattern).

    Args:
        pattern: exact path, substring, or glob.
        paths: candidate path strings (``ShardingPlan.input_paths``).

    Returns:
        All matching indices (possibly empty), in path order.
    """
    exact = [i for i, p in enumerate(paths) if p == pattern]
    if exact:
        return exact
    sub = [i for i, p in enumerate(paths) if pattern in p]
    if sub:
        return sub
    return [i for i, p in enumerate(paths)
            if fnmatch.fnmatchcase(p, pattern)]


def _norm_entry(entry) -> tuple[str, ...]:
    """One PartitionSpec entry -> canonical tuple of mesh axis names."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _norm_spec(spec) -> tuple[tuple[str, ...], ...]:
    """A full per-dim spec (PartitionSpec / sequence) -> tuple of tuples."""
    if isinstance(spec, str):
        raise ConstraintError(
            f"per-input Pin spec must be a sequence with one entry per "
            f"dim, got the bare string {spec!r}")
    return tuple(_norm_entry(e) for e in spec)


class Constraint:
    """Base class for user sharding constraints (see module docstring)."""

    def canonical(self) -> tuple:
        """Deterministic tuple form, used in plan-store cache keys."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Pin(Constraint):
    """Fix the sharding of an input (or of one logical dimension).

    Args:
        target: either a declared logical dimension name (when the
            request carries ``logical_axes`` naming it) or an input path
            pattern (exact / glob / substring, see :func:`match_paths`).
        spec: for a logical-dim target, the mesh axes that dimension must
            be sharded on (``"data"`` or ``("data", "model")``); for a
            path target, a full per-dim spec — a ``PartitionSpec`` or a
            sequence with one ``None`` / axis / axes-tuple entry per dim
            (``None`` pins the dim unsharded).
    """

    target: str
    spec: object

    def canonical(self) -> tuple:
        """Deterministic tuple form, used in plan-store cache keys.

        Equivalent spellings collapse: a bare axis string and its
        1-tuple (``"data"`` vs ``("data",)``) canonicalize identically,
        so a warm plan store hits under either.
        """
        spec = self.spec
        if isinstance(spec, str):
            spec = (spec,)
        try:
            norm = tuple(_norm_entry(e) for e in spec)
        except TypeError:
            norm = (_norm_entry(spec),)
        return ("pin", self.target, norm)


@dataclasses.dataclass(frozen=True)
class Replicate(Constraint):
    """Force every input matching ``target`` to be fully replicated.

    Args:
        target: input path pattern (exact / glob / substring) or a
            declared logical dimension name (replicates that dim only).
    """

    target: str

    def canonical(self) -> tuple:
        """Deterministic tuple form, used in plan-store cache keys."""
        return ("replicate", self.target)


@dataclasses.dataclass(frozen=True)
class Forbid(Constraint):
    """Ban one mesh axis from sharding the targeted dimensions.

    Args:
        target: input path pattern (all dims of matching inputs) or a
            declared logical dimension name (that dim's color only).
        axis: the mesh axis that must not shard the target.
    """

    target: str
    axis: str

    def canonical(self) -> tuple:
        """Deterministic tuple form, used in plan-store cache keys."""
        return ("forbid", self.target, self.axis)


def canonical_constraints(constraints: Iterable) -> tuple:
    """Canonical tuple forms of a constraint list (plan-store keying).

    Args:
        constraints: ``Constraint`` objects or already-canonical tuples
            (as round-tripped through JSON: nested lists accepted).

    Returns:
        A tuple of deterministic, JSON-friendly canonical tuples.
    """
    out = []
    for c in constraints or ():
        if isinstance(c, Constraint):
            out.append(c.canonical())
        else:
            out.append(_deep_tuple(c))
    return tuple(out)


def _deep_tuple(x):
    if isinstance(x, (list, tuple)):
        return tuple(_deep_tuple(e) for e in x)
    return x


def canonical_logical_axes(logical_axes):
    """Canonicalize a flattened ``logical_axes`` list for cache keying.

    Lists and tuples (and their nestings) spell the same request, and a
    declaration that names nothing is the same as no declaration; both
    must map to one cache key (regression: an earlier version hashed ``[("b",)]`` and
    ``(("b",),)`` to different plan-store entries).

    Args:
        logical_axes: ``None`` or a flat sequence of per-input name
            tuples (``None`` entries for unnamed inputs).

    Returns:
        ``None`` when nothing is named, else a tuple of tuples/``None``.
    """
    if logical_axes is None:
        return None
    out = tuple(None if e is None else tuple(e) for e in logical_axes)
    if all(e is None for e in out):
        return None
    return out


@dataclasses.dataclass(frozen=True)
class ConstraintSet:
    """Constraints lowered onto NDA colors (see :func:`compile_constraints`).

    Attributes:
        pinned: ``(color, exact axes tuple)`` pairs — the color's final
            assignment is fixed (the empty tuple pins it unsharded).
        forbidden: ``(color, banned axes tuple)`` pairs.
        source: the user constraints this set was compiled from.
        penalty: cost added per violation by
            :meth:`penalty_for` — large enough that any violating state
            is strictly worse than every feasible one.
    """

    pinned: tuple[tuple[int, tuple[str, ...]], ...] = ()
    forbidden: tuple[tuple[int, tuple[str, ...]], ...] = ()
    source: tuple = ()
    penalty: float = 1e6

    def root_state(self) -> "ShardingState":
        """The seeded search root carrying every pinned assignment."""
        from repro_torch.core.cost_model import ShardingState
        state = ShardingState()
        for color, axes in self.pinned:
            for axis in axes:
                state = state.with_action(color, axis, ())
        return state

    def prune(self, actions: list) -> list:
        """Filter an action space down to the constrained subspace.

        Pinned colors admit no further actions (their assignment is
        final); forbidden ``(color, axis)`` pairs are dropped.

        Args:
            actions: action list from ``build_action_space``.

        Returns:
            The actions every backend may still take.
        """
        pinned_colors = {c for c, _ in self.pinned}
        banned = dict(self.forbidden)
        return [a for a in actions
                if a.color not in pinned_colors
                and a.axis not in banned.get(a.color, ())]

    def violations(self, state: "ShardingState") -> list[str]:
        """Human-readable violations of ``state`` against this set.

        Args:
            state: canonical sharding state to check.

        Returns:
            One message per violated pin / forbid (empty when satisfied).
        """
        ca = dict(state.color_axes)
        out = []
        for color, axes in self.pinned:
            got = tuple(ca.get(color, ()))
            if got != axes:
                out.append(f"color {color} pinned to {axes or 'replicated'}"
                           f", state has {got or 'replicated'}")
        for color, banned in self.forbidden:
            used = ca.get(color, ())
            for axis in banned:
                if axis in used:
                    out.append(f"axis {axis!r} forbidden on color {color} "
                               f"but present in state")
        return out

    def penalty_for(self, state: "ShardingState") -> float:
        """Infeasibility penalty of ``state``: ``penalty`` per violation.

        Args:
            state: canonical sharding state to check.

        Returns:
            0.0 for satisfying states; a cost large enough to dominate
            any feasible alternative otherwise.
        """
        if not self.pinned and not self.forbidden:
            return 0.0
        return self.penalty * len(self.violations(state))


def _resolve_logical_dims(name: str, prog: "Program",
                          logical_axes) -> list[tuple[int, int]]:
    """All ``(vid, dim)`` input dims declared with logical name ``name``."""
    out = []
    for vid, names in zip(prog.inputs, logical_axes):
        if names is None:
            continue
        for d, nm in enumerate(names):
            if nm == name:
                out.append((vid, d))
    return out


def _logical_names(logical_axes) -> set[str]:
    if logical_axes is None:
        return set()
    return {nm for names in logical_axes if names is not None
            for nm in names if nm}


def compile_constraints(constraints: Sequence[Constraint],
                        nda: "NDAResult", prog: "Program",
                        logical_axes, mesh: "MeshSpec") -> ConstraintSet:
    """Lower user constraints onto NDA colors for one mesh.

    Every targeted input dimension resolves to its color; pins are
    checked for mesh-axis existence, per-dim divisibility, and mutual
    consistency (two pins disagreeing on one color is an error, as is
    forbidding an axis a pin requires).

    Args:
        constraints: the user constraint list.
        nda: NDA result of the analyzed program.
        prog: the extracted program (for input paths / shapes).
        logical_axes: flattened per-input logical name tuples (or
            ``None``); required for logical-name targets.
        mesh: the mesh the request shards over.

    Returns:
        The compiled :class:`ConstraintSet`.

    Raises:
        ConstraintError: on unknown targets, unknown mesh axes,
            non-dividing pins, or conflicting constraints.
    """
    axis_size = dict(zip(mesh.axes, mesh.sizes))
    names = _logical_names(logical_axes)
    pinned: dict[int, tuple[str, ...]] = {}
    pin_src: dict[int, str] = {}
    forbidden: dict[int, set[str]] = {}

    def check_axes(axes: tuple[str, ...], what: str) -> None:
        for a in axes:
            if a not in axis_size:
                raise ConstraintError(
                    f"{what}: unknown mesh axis {a!r} "
                    f"(mesh axes: {mesh.axes})")

    def check_divides(vid: int, dim: int, axes: tuple[str, ...],
                      what: str) -> None:
        size = prog.types[vid].shape[dim]
        for a in axes:
            f = axis_size[a]
            if size % f != 0 or size < f:
                raise ConstraintError(
                    f"{what}: dim of size {prog.types[vid].shape[dim]} "
                    f"is not divisible by axis {a!r} (size {f})")
            size //= f

    def pin_color(color: int, axes: tuple[str, ...], what: str) -> None:
        prev = pinned.get(color)
        if prev is not None and prev != axes:
            raise ConstraintError(
                f"conflicting pins on one dimension class: {pin_src[color]} "
                f"wants {prev or 'replicated'}, {what} wants "
                f"{axes or 'replicated'}")
        pinned[color] = axes
        pin_src[color] = what

    def target_dims(target: str, what: str) -> list[tuple[int, int]]:
        """All (vid, dim) a target names: logical dim or all dims of
        matching input paths."""
        if target in names:
            return _resolve_logical_dims(target, prog, logical_axes)
        idxs = match_paths(target, prog.input_paths)
        if not idxs:
            raise ConstraintError(
                f"{what}: target {target!r} matches no input path and "
                f"is not a declared logical dimension name")
        return [(prog.inputs[i], d) for i in idxs
                for d in range(prog.types[prog.inputs[i]].rank)]

    for c in constraints:
        if isinstance(c, Pin):
            what = f"Pin({c.target!r})"
            if c.target in names:
                axes = _norm_entry(c.spec)
                check_axes(axes, what)
                dims = _resolve_logical_dims(c.target, prog, logical_axes)
                if not dims:
                    raise ConstraintError(
                        f"{what}: logical dim named by no input")
                for vid, d in dims:
                    check_divides(vid, d, axes, what)
                    pin_color(nda.color(nda.def_site[vid].dims[d]), axes,
                              what)
            else:
                idxs = match_paths(c.target, prog.input_paths)
                if not idxs:
                    raise ConstraintError(
                        f"{what}: target matches no input path and is "
                        f"not a declared logical dimension name")
                spec = _norm_spec(c.spec)
                for i in idxs:
                    vid = prog.inputs[i]
                    rank = prog.types[vid].rank
                    if len(spec) != rank:
                        raise ConstraintError(
                            f"{what}: spec has {len(spec)} entries but "
                            f"input {prog.input_paths[i]!r} has rank "
                            f"{rank}")
                    used: set[str] = set()
                    for d, axes in enumerate(spec):
                        check_axes(axes, what)
                        dup = used & set(axes)
                        if dup:
                            raise ConstraintError(
                                f"{what}: axis {sorted(dup)[0]!r} pinned "
                                f"to two dims of one input")
                        used |= set(axes)
                        check_divides(vid, d, axes, what)
                        pin_color(nda.color(nda.def_site[vid].dims[d]),
                                  axes, what)
        elif isinstance(c, Replicate):
            what = f"Replicate({c.target!r})"
            for vid, d in target_dims(c.target, what):
                pin_color(nda.color(nda.def_site[vid].dims[d]), (), what)
        elif isinstance(c, Forbid):
            what = f"Forbid({c.target!r}, {c.axis!r})"
            check_axes((c.axis,), what)
            for vid, d in target_dims(c.target, what):
                color = nda.color(nda.def_site[vid].dims[d])
                forbidden.setdefault(color, set()).add(c.axis)
        else:
            raise ConstraintError(f"unknown constraint type "
                                  f"{type(c).__name__}")

    for color, axes in pinned.items():
        clash = set(axes) & forbidden.get(color, set())
        if clash:
            raise ConstraintError(
                f"axis {sorted(clash)[0]!r} is both pinned and forbidden "
                f"on one dimension class ({pin_src[color]})")
    return ConstraintSet(
        pinned=tuple(sorted(pinned.items())),
        forbidden=tuple(sorted((c, tuple(sorted(a)))
                               for c, a in forbidden.items())),
        source=tuple(constraints))


def check_plan(plan, constraints: Sequence[Constraint]) -> list[str]:
    """Verify a finished plan against user constraints, spec-level.

    Message-only wrapper around :func:`check_plan_detailed` (the
    historical interface — callers that need to know *which* constraint
    failed use the detailed variant or ``ShardingPlan.check``).

    Args:
        plan: a ``ShardingPlan``.
        constraints: the constraints the plan must satisfy.

    Returns:
        One message per violation (empty when the plan satisfies all).

    Raises:
        ConstraintError: when a target resolves to nothing.
    """
    return [msg for _, msg in check_plan_detailed(plan, constraints)]


def check_plan_detailed(plan, constraints: Sequence[Constraint]
                        ) -> list[tuple[Constraint, str]]:
    """Verify a finished plan against user constraints, spec-level.

    Unlike :func:`compile_constraints` this needs no analysis artifacts:
    it checks the plan's ``in_specs`` directly, so it works on plans
    loaded from JSON / the plan store.  Logical-name targets require the
    plan to carry ``plan.logical_axes`` (plans produced by
    ``Session.partition`` always do when the request declared them).

    Args:
        plan: a ``ShardingPlan``.
        constraints: the constraints the plan must satisfy.

    Returns:
        ``(violated constraint, message)`` per violation, empty when the
        plan satisfies all.

    Raises:
        ConstraintError: when a target resolves to nothing.
    """
    paths = plan.input_paths
    specs = [tuple(_norm_entry(e) for e in s) for s in plan.in_specs]
    la = plan.logical_axes
    names = _logical_names(la)
    errs: list[tuple[Constraint, str]] = []

    def logical_entries(name: str) -> list[tuple[int, int]]:
        return [(i, d) for i, nt in enumerate(la or []) if nt is not None
                for d, nm in enumerate(nt) if nm == name]

    def entries_for(target: str, what: str) -> list[tuple[int, int]]:
        if target in names:
            return logical_entries(target)
        idxs = match_paths(target, paths)
        if not idxs:
            raise ConstraintError(
                f"{what}: target {target!r} matches no input path and "
                f"is not a logical dimension name recorded in the plan")
        return [(i, d) for i in idxs for d in range(len(specs[i]))]

    for c in constraints:
        if isinstance(c, Pin):
            what = f"Pin({c.target!r})"
            if c.target in names:
                axes = _norm_entry(c.spec)
                for i, d in logical_entries(c.target):
                    if specs[i][d] != axes:
                        errs.append((c,
                                     f"{what}: {paths[i]} dim {d} is "
                                     f"{specs[i][d] or 'replicated'}, "
                                     f"pinned to "
                                     f"{axes or 'replicated'}"))
            else:
                idxs = match_paths(c.target, paths)
                if not idxs:
                    raise ConstraintError(
                        f"{what}: target matches no input path")
                want = _norm_spec(c.spec)
                for i in idxs:
                    if specs[i] != want:
                        errs.append((c, f"{what}: {paths[i]} has "
                                     f"{specs[i]}, pinned to {want}"))
        elif isinstance(c, Replicate):
            what = f"Replicate({c.target!r})"
            for i, d in entries_for(c.target, what):
                if specs[i][d]:
                    errs.append((c, f"{what}: {paths[i]} dim {d} is "
                                 f"sharded on {specs[i][d]}"))
        elif isinstance(c, Forbid):
            what = f"Forbid({c.target!r}, {c.axis!r})"
            for i, d in entries_for(c.target, what):
                if c.axis in specs[i][d]:
                    errs.append((c, f"{what}: {paths[i]} dim {d} is "
                                 f"sharded on forbidden axis "
                                 f"{c.axis!r}"))
        else:
            errs.append((c, f"unknown constraint type "
                         f"{type(c).__name__}"))
    return errs
