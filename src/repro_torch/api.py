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
  action space so every backend (mcts, beam, greedy, portfolio, custom)
  inherits them.  Requests hash into the plan store's key (constraints
  included), so identical requests on an unchanged program are file
  reads: ``Session(fn, args, plan_store=dir)`` or
  ``partition(request, plan_store=dir)`` (``repro_torch.ckpt.plan_store``).
- :meth:`Session.co_search` chooses the mesh factorization of a device
  budget together with the plan (``repro_torch.core.mesh_search``), all
  candidates over the session's one analysis.
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
one-shot wrapper over ``Session`` and ``Request``.  Not ported yet:
measured execution, the static verifier (``Session.verify``), learned
guidance (``Request.guidance``) and the zoo drivers (ROADMAP queue 1,
items 14-18).
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
from repro_torch.core.mesh_search import MeshCandidate, candidate_meshes
from repro_torch.core.partitioner import (ShardingPlan, ToastArtifacts,  # noqa: F401
                                          _constraint_specs, _logical_rules,
                                          _state_specs, analyze,
                                          flatten_logical_axes,
                                          kernel_site_records)
from repro_torch.core.search import SearchBackend, get_backend

__all__ = [
    "Constraint", "ConstraintError", "CoSearchResult", "Forbid",
    "MeshSpec", "Pin", "Replicate", "Request", "Session", "ShardingPlan",
]


@dataclasses.dataclass(frozen=True)
class Request:
    """A declarative description of one partitioning problem.

    Frozen and value-like: the request's canonical parameters —
    ``min_dims``, ``logical_axes`` and the ``constraints`` — key the
    persistent plan store.  The search *backend* is deliberately not
    part of the key: reusing a plan another backend found is the point
    of the store.

    Attributes:
        mesh: logical device mesh to shard over.
        hw: hardware roofline constants (per-card FLOP/s, HBM, link
            bandwidth, memory budget); H100 data-sheet defaults.
        backend: search strategy — "mcts" (default), "beam", "greedy",
            "portfolio", or a ``SearchBackend`` instance.
        search_config: backend-specific config (``MCTSConfig``,
            ``BeamConfig``, ``PortfolioConfig``, ...); ``None`` means
            backend defaults.
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

    def store_params(self) -> dict:
        """The request parameters that key the plan store.

        Everything that changes the search *outcome* beyond the
        program x mesh x hardware triple: ``min_dims``, the canonical
        ``logical_axes``, and the canonical ``constraints``.  See
        ``repro_torch.ckpt.plan_store.canonical_request_params``.

        Returns:
            A params dict for ``PlanStore.get`` / ``PlanStore.put``.
        """
        return {"min_dims": self.min_dims,
                "logical_axes": self.flat_logical_axes(),
                "constraints": self.constraints}


@dataclasses.dataclass
class CoSearchResult:
    """Outcome of one mesh-shape co-search (:meth:`Session.co_search`).

    Attributes:
        devices: the device budget the candidates factorize.
        best_mesh: mesh of the jointly best ``(mesh, plan)`` pair, or
            ``None`` when no candidate searched successfully.
        best_plan: the winning plan (``None`` alongside ``best_mesh``).
        rows: one JSON-friendly record per candidate — mesh, status
            ("ok" / "pruned" / "error"), cost, feasibility, peak bound,
            search seconds, cache provenance.
        plans: searched plans keyed by candidate ``MeshSpec``.
        candidates: the enumerated (and possibly pruned)
            ``MeshCandidate`` list, enumeration order.
        seconds: total co-search wall time.
    """

    devices: int
    best_mesh: MeshSpec | None
    best_plan: ShardingPlan | None
    rows: list[dict]
    plans: dict[MeshSpec, ShardingPlan]
    candidates: list[MeshCandidate]
    seconds: float

    def best_multi_pod(self) -> tuple[MeshSpec, ShardingPlan] | None:
        """The best searched candidate whose mesh crosses DCN.

        Returns:
            The ``(mesh, plan)`` pair with the lowest (feasible-first)
            cost among candidates with a non-empty ``dcn_axes``, or
            ``None`` when no multi-pod candidate was searched.
        """
        best: tuple | None = None
        for row in self.rows:
            if row.get("status") != "ok" or not row["mesh"]["dcn_axes"]:
                continue
            mesh = MeshSpec(tuple(row["mesh"]["axes"]),
                            tuple(row["mesh"]["sizes"]),
                            tuple(row["mesh"]["dcn_axes"]))
            key = (not row["feasible"], row["cost"])
            if best is None or key < best[0]:
                best = (key, mesh, self.plans[mesh])
        return None if best is None else (best[1], best[2])


class Session:
    """One traced-and-analyzed function, ready for staged partitioning.

    Construction runs the expensive, mesh-independent half of the
    pipeline exactly once: export ``fn`` to the flat tensor IR, run the
    NDA, and build the conflict analysis.  Every :meth:`partition` call
    then only pays for the search (or, with a plan store, a file read).
    """

    def __init__(self, fn: Callable, args: tuple = (), *,
                 kwargs: dict | None = None,
                 artifacts: ToastArtifacts | None = None,
                 plan_store=None) -> None:
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
            plan_store: default ``repro_torch.ckpt.plan_store.PlanStore``
                (or directory path) consulted by every :meth:`partition`
                call; per-call override available.
        """
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        t0 = time.perf_counter()
        self.artifacts = artifacts or analyze(fn, args, kwargs)
        self.analysis_seconds = time.perf_counter() - t0
        self.plan_store = plan_store
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

    def partition(self, request: Request, *, plan_store=None
                  ) -> ShardingPlan:
        """Solve one partitioning request against this session's program.

        Args:
            request: the partitioning problem to solve.
            plan_store: per-call plan store override (a ``PlanStore`` or
                directory path); defaults to the session's.

        Returns:
            A :class:`ShardingPlan` satisfying ``request.constraints``;
            ``plan.cached`` is True when it came from the plan store.

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

        store = plan_store if plan_store is not None else self.plan_store
        store_params = None
        if store is not None:
            if not hasattr(store, "get"):
                from repro_torch.ckpt.plan_store import PlanStore
                store = PlanStore(store)
            store_params = request.store_params()
            hit = store.get(self.fingerprint, request.mesh, request.hw,
                            store_params)
            if hit is not None:
                if request.constraints:
                    hit.check(request.constraints)
                return hit

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

        eval_stats = evaluator.stats.as_dict()
        if getattr(result, "members", None) is not None:
            eval_stats["portfolio"] = {
                "winner": result.winner,
                "early_stopped": result.early_stopped,
                "members": [m.as_dict() for m in result.members],
            }
        plan = self._build_plan(
            request, result.best_state, cm,
            cost=result.best_cost,
            breakdown=evaluator.evaluate(result.best_state).as_dict(),
            backend=engine.name, search_seconds=elapsed,
            evaluations=result.evaluations, eval_stats=eval_stats)
        if request.constraints:
            plan.check(request.constraints)
        if store is not None:
            store.put(plan, request.hw, store_params)
        return plan

    def co_search(self, request_template: Request, devices: int, *,
                  pods: tuple[int, ...] = (1, 2),
                  max_ici_axes: int = 3,
                  plan_store=None, verbose: bool = False
                  ) -> CoSearchResult:
        """Jointly choose the mesh factorization *and* the plan.

        Enumerates every candidate mesh for the device budget
        (``repro_torch.core.mesh_search``: divisor factorizations,
        deduped up to axis renaming, pruned by the replicated-state
        memory lower bound), searches a plan per surviving candidate
        with this session's single program analysis — cost models for
        new meshes are ``CostModel.with_mesh`` clones sharing every
        static table — and returns the jointly best ``(mesh, plan)``
        pair.  Costs are comparable across meshes because the paper
        cost normalizes by the mesh-independent unsharded baseline.

        Args:
            request_template: request whose ``mesh`` field is replaced
                by each candidate (backend, hardware, constraints and
                ``min_dims`` apply to every per-mesh search).
                Constraints naming axes absent from a candidate mesh
                fail that candidate only (row status "error").
            devices: total device budget ``N`` to factorize.
            pods: pod counts to consider; non-divisors of ``N`` are
                skipped, ``1`` is the single-pod mesh, counts > 1 add a
                ``pod`` axis crossing DCN.
            max_ici_axes: most ICI axes per candidate (≤ 3).
            plan_store: per-call plan store override (every per-mesh
                search keys separately — mesh, including ``dcn_axes``,
                is part of the plan key).
            verbose: print one line per candidate as searches finish.

        Returns:
            A :class:`CoSearchResult`; ``best_mesh``/``best_plan`` are
            ``None`` only when every candidate was pruned or errored.
        """
        t0 = time.perf_counter()
        hw = request_template.hw
        prog = self.artifacts.prog
        dim_sizes = {d for t in prog.types.values() for d in t.shape}
        raw = candidate_meshes(devices, pods=pods,
                               max_ici_axes=max_ici_axes)
        if not raw:
            raise ValueError(
                f"no candidate meshes for devices={devices} with "
                f"pods={tuple(pods)} (no pod count divides the budget)")
        # the unsharded peak is mesh-independent: any candidate's model
        # (or a fresh one) supplies it for the pruning bound
        base_peak = self._cost_model(raw[0].mesh, hw)._base_peak
        cands = candidate_meshes(
            devices, pods=pods, max_ici_axes=max_ici_axes,
            dim_sizes=dim_sizes, base_peak=base_peak,
            memory_budget=hw.hbm_per_chip)

        rows: list[dict] = []
        plans: dict[MeshSpec, ShardingPlan] = {}
        best: tuple | None = None
        for cand in cands:
            row = {"mesh": cand.mesh.as_dict(),
                   "mesh_str": cand.mesh_str,
                   "devices": cand.mesh.num_devices,
                   "multi_pod": bool(cand.mesh.dcn_axes),
                   "peak_lower_bound_gb":
                       round(cand.peak_lower_bound / 2**30, 6),
                   "pruned": cand.pruned}
            if cand.pruned:
                row["status"] = "pruned"
                rows.append(row)
                continue
            request = dataclasses.replace(request_template,
                                          mesh=cand.mesh)
            try:
                plan = self.partition(request, plan_store=plan_store)
            except Exception as e:                  # noqa: BLE001
                row.update(status="error", error=repr(e))
                rows.append(row)
                continue
            feasible = bool(plan.breakdown["peak_bytes"]
                            <= hw.hbm_per_chip)
            row.update(
                status="ok", cost=round(plan.cost, 6), feasible=feasible,
                runtime_est=plan.breakdown["runtime"],
                peak_gb=round(plan.breakdown["peak_bytes"] / 2**30, 6),
                search_s=round(plan.search_seconds, 3),
                cached=plan.cached, backend=plan.backend)
            rows.append(row)
            plans[cand.mesh] = plan
            key = (not feasible, plan.cost)
            if best is None or key < best[0]:
                best = (key, cand.mesh, plan)
            if verbose:
                print(f"[co-search {cand.mesh_str:>10}"
                      f"{' dcn' if cand.mesh.dcn_axes else '    '}] "
                      f"cost={plan.cost:.4f} "
                      f"feasible={'Y' if feasible else 'N'} "
                      f"{plan.search_seconds:6.2f}s", flush=True)
        return CoSearchResult(
            devices=devices,
            best_mesh=None if best is None else best[1],
            best_plan=None if best is None else best[2],
            rows=rows, plans=plans, candidates=cands,
            seconds=time.perf_counter() - t0)

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
