"""Staged public API: ``Session`` / ``Request`` / ``Constraint``.

TOAST's pipeline has two very different halves: the **analysis**
(trace → NDA → conflicts) is a property of the function alone and is
expensive enough to do exactly once, while the **search** is cheap,
mesh-dependent, and worth re-running per mesh / hardware / constraint
set::

    from repro_torch.api import Session, Request

    sess = Session(prefill_step, (param_specs, batch))   # analyze once
    plan = sess.partition(Request(mesh=MeshSpec(("data", "model"), (2, 4))))
    plan1 = sess.partition(Request(mesh=MeshSpec(("data", "model"), (1, 1))))
    applied = plan1.apply(prefill_step)   # a CUDA graph per signature
    logits = applied(params, batch)       # captured, then replayed

- :class:`Session` traces (``torch.export`` on ``meta`` tensors) and
  analyzes the function **once**; every ``partition`` call reuses the
  artifacts and per-mesh cost-model / action-space caches.
- :class:`Request` is a frozen description of one partitioning problem:
  mesh, hardware, backend + config, ``min_dims`` pruning, logical dim
  names, and user constraints, which seed the search root and prune the
  action space so every backend inherits them.
- ``plan.apply(fn)`` binds a plan to ``fn``.  For a one-device plan on
  the card it captures each argument signature's step as a CUDA graph
  and replays it, as the reference jits the step per signature;
  ``plan.apply(fn, capture=False)`` runs it eagerly, op by op (the train
  steps, and the eager side of a parity check); on the CPU it runs
  eagerly.  A plan of two or more devices runs eagerly over a
  ``DeviceMesh`` of as many ranks, its inputs and outputs DTensors
  placed as the plan's specs and its kernel sites under ``local_map``
  (``core.partitioner.AppliedPlan``).

:meth:`Session.plan_for_state` materializes a plan for a given sharding
state without a search, and ``core.partitioner.auto_partition`` is the
one-shot wrapper over ``Session`` and ``Request``.  Not ported yet: the
plan store, mesh co-search, the static verifier and learned guidance
(ROADMAP queue 1, items 13-16).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.core.actions import DEFAULT_MIN_DIMS, build_action_space
from repro_torch.core.constraints import (Constraint, ConstraintError,  # noqa: F401
                                          ConstraintSet, Forbid, Pin,
                                          Replicate, compile_constraints)
from repro_torch.core.cost_model import (CostModel, HardwareSpec, MeshSpec,
                                         ShardingState)
from repro_torch.core.evaluator import IncrementalEvaluator
from repro_torch.core.ir import program_fingerprint
from repro_torch.core.partitioner import (ShardingPlan, ToastArtifacts,  # noqa: F401
                                          _constraint_specs, _logical_rules,
                                          _state_specs, analyze,
                                          flatten_logical_axes,
                                          kernel_site_records)
from repro_torch.core.search import SearchBackend, get_backend

__all__ = [
    "Constraint", "ConstraintError", "Forbid", "MeshSpec", "Pin",
    "Replicate", "Request", "Session", "ShardingPlan",
]


@dataclasses.dataclass(frozen=True)
class Request:
    """A declarative description of one partitioning problem.

    Attributes:
        mesh: logical device mesh to shard over.
        hw: hardware roofline constants (per-card FLOP/s, HBM, link
            bandwidth, memory budget); H100 data-sheet defaults.
        backend: search strategy — "mcts" (default), "beam", "greedy",
            or a ``SearchBackend`` instance.
        search_config: backend-specific config (``MCTSConfig``,
            ``BeamConfig``, ...); ``None`` means backend defaults.
        min_dims: action-space pruning threshold — colors occurring on
            fewer dims are not sharded directly (paper uses 10).
        logical_axes: per-input logical dim names — a pytree mirroring
            the session's arguments with name tuples at the leaves, or
            the already-flat list ``flatten_logical_axes`` produces.
        constraints: ``Pin`` / ``Replicate`` / ``Forbid`` constraints
            the plan must satisfy.
    """

    mesh: MeshSpec
    hw: HardwareSpec = HardwareSpec()
    backend: str | SearchBackend = "mcts"
    search_config: Any = None
    min_dims: int = DEFAULT_MIN_DIMS
    logical_axes: Any = None
    constraints: tuple[Constraint, ...] = ()

    def __post_init__(self) -> None:
        """Normalize mutable spellings (constraint lists) to tuples."""
        if not isinstance(self.constraints, tuple):
            object.__setattr__(self, "constraints",
                               tuple(self.constraints))

    def flat_logical_axes(self) -> list[tuple[str, ...] | None] | None:
        """The request's ``logical_axes`` flattened to program-input order.

        Returns:
            One names-tuple (or ``None``) per input leaf, or ``None``
            when the request declares no logical axes.
        """
        if self.logical_axes is None:
            return None
        return flatten_logical_axes(self.logical_axes)


class Session:
    """One traced-and-analyzed function, ready for staged partitioning.

    Construction runs the expensive, mesh-independent half of the
    pipeline exactly once: export ``fn`` to the flat tensor IR, run the
    NDA, and build the conflict analysis.  Every :meth:`partition` call
    then only pays for the search.
    """

    def __init__(self, fn: Callable, args: tuple = (), *,
                 kwargs: dict | None = None,
                 artifacts: ToastArtifacts | None = None) -> None:
        """Trace and analyze ``fn`` once.

        Args:
            fn: the function to partition (a serve/train step).  Only
                traced on ``meta`` tensors, never run on data.
            args: example positional arguments (``meta`` tensors
                suffice, e.g. ``transformer.param_specs``).
            kwargs: example keyword arguments.
            artifacts: pre-computed
                :func:`repro_torch.core.partitioner.analyze` artifacts
                to adopt instead of re-analyzing.
        """
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        t0 = time.perf_counter()
        self.artifacts = artifacts or analyze(fn, args, kwargs)
        self.analysis_seconds = time.perf_counter() - t0
        self._fingerprint: str | None = None
        self._cost_models: dict[tuple[MeshSpec, HardwareSpec],
                                CostModel] = {}
        # first model built per HardwareSpec: later meshes clone it via
        # CostModel.with_mesh, sharing every static analysis table
        self._hw_base_models: dict[HardwareSpec, CostModel] = {}

    @property
    def fingerprint(self) -> str:
        """Deterministic program fingerprint (computed once, memoized)."""
        if self._fingerprint is None:
            self._fingerprint = program_fingerprint(self.artifacts.prog)
        return self._fingerprint

    def _cost_model(self, mesh: MeshSpec, hw: HardwareSpec) -> CostModel:
        key = (mesh, hw)
        cm = self._cost_models.get(key)
        if cm is None:
            base = self._hw_base_models.get(hw)
            if base is not None:
                cm = base.with_mesh(mesh)
            else:
                art = self.artifacts
                cm = CostModel(art.prog, art.nda, art.analysis, mesh, hw)
                self._hw_base_models[hw] = cm
            self._cost_models[key] = cm
        return cm

    def _actions(self, mesh: MeshSpec, min_dims: int) -> list:
        art = self.artifacts
        key = (mesh, min_dims)
        actions = art.actions_by_mesh.get(key)
        if actions is None:
            actions = build_action_space(art.nda, art.analysis, mesh,
                                         min_dims=min_dims)
            art.actions_by_mesh[key] = actions
        return actions

    def compile_constraints(self, request: Request) -> ConstraintSet | None:
        """Lower the request's constraints onto this program's colors.

        Args:
            request: the request whose constraints to compile.

        Returns:
            The compiled ``ConstraintSet``, or ``None`` when the request
            carries no constraints.

        Raises:
            ConstraintError: on malformed or unsatisfiable constraints.
        """
        if not request.constraints:
            return None
        art = self.artifacts
        return compile_constraints(request.constraints, art.nda, art.prog,
                                   request.flat_logical_axes(),
                                   request.mesh)

    def partition(self, request: Request) -> ShardingPlan:
        """Solve one partitioning request against this session's program.

        Args:
            request: the partitioning problem to solve.

        Returns:
            A :class:`ShardingPlan` satisfying ``request.constraints``.

        Raises:
            ConstraintError: when the constraints are unsatisfiable or
                the searched plan fails the final spec-level check.
        """
        t0 = time.perf_counter()
        art = self.artifacts
        flat_names = request.flat_logical_axes()
        if flat_names is not None and \
                len(flat_names) != len(art.prog.inputs):
            raise ValueError(
                f"logical_axes names {len(flat_names)} inputs but the "
                f"program has {len(art.prog.inputs)}")
        cs = self.compile_constraints(request)
        cm = self._cost_model(request.mesh, request.hw)
        actions = self._actions(request.mesh, request.min_dims)
        root = ShardingState()
        if cs is not None:
            actions = cs.prune(actions)
            root = cs.root_state()
        engine = get_backend(request.backend)
        evaluator = IncrementalEvaluator(cm, constraints=cs)
        result = engine.search(evaluator, actions, request.search_config,
                               root=root)
        elapsed = time.perf_counter() - t0
        plan = self._build_plan(
            request, result.best_state, cm,
            cost=result.best_cost,
            breakdown=evaluator.evaluate(result.best_state).as_dict(),
            backend=engine.name, search_seconds=elapsed,
            evaluations=result.evaluations,
            eval_stats=evaluator.stats.as_dict())
        if request.constraints:
            plan.check(request.constraints)
        return plan

    def plan_for_state(self, request: Request, state: ShardingState, *,
                       label: str = "manual") -> ShardingPlan:
        """Materialize a :class:`ShardingPlan` for an explicit state.

        No search runs: the state is projected onto input and output
        specs and costed under the request's mesh and hardware, as the
        reference's ``Session.plan_for_state`` does (the measured
        execution builds its plan variants so, and a state read from a
        JSON plan can be replayed against a fresh session).

        Args:
            request: supplies the mesh, hardware and logical axes the
                plan is priced and labelled with (its constraints are
                not enforced: the state is taken as it is).
            state: the canonical sharding state to materialize.
            label: recorded as the plan's ``backend`` name.

        Returns:
            A fully populated ``ShardingPlan`` for ``state``.
        """
        cm = self._cost_model(request.mesh, request.hw)
        return self._build_plan(
            request, state, cm,
            cost=cm.paper_cost(state),
            breakdown=cm.evaluate(state).as_dict(),
            backend=label, search_seconds=0.0, evaluations=0,
            eval_stats={})

    def _build_plan(self, request: Request, state: ShardingState, cm,
                    *, cost: float, breakdown: dict, backend: str,
                    search_seconds: float, evaluations: int,
                    eval_stats: dict) -> ShardingPlan:
        art = self.artifacts
        flat_names = request.flat_logical_axes()
        summary = art.nda.color_summary()
        return ShardingPlan(
            mesh=request.mesh,
            in_specs=_state_specs(cm, state, art.prog.inputs),
            input_paths=art.prog.input_paths,
            state=state,
            cost=cost,
            breakdown=breakdown,
            baseline_breakdown=cm.baseline().as_dict(),
            constraint_specs=_constraint_specs(cm, state, art.analysis),
            logical_rules=_logical_rules(art.nda, art.prog, state,
                                         flat_names),
            search_seconds=search_seconds,
            evaluations=evaluations,
            num_colors=len(summary),
            num_conflicts=len(art.analysis.conflicts),
            num_compat_sets=len(art.analysis.compat_sets),
            num_resolution_bits=art.analysis.num_resolution_bits,
            backend=backend,
            eval_stats=eval_stats,
            fingerprint=self.fingerprint,
            out_specs=_state_specs(cm, state, art.prog.outputs),
            logical_axes=flat_names,
            kernel_sites=kernel_site_records(cm, state),
        )
