"""TOAST front-end: the ``ShardingPlan`` type and its execution.

The staged public API lives in ``repro_torch.api`` (``Session`` /
``Request``)::

    plan = Session(step, (params, batch)).partition(
        Request(mesh=MeshSpec(("data", "model"), (1, 1))))
    applied = plan.apply(step)           # per-site kernel decisions
    logits = applied(params, batch)      # captured as a CUDA graph

Specs are framework-neutral tuples (:class:`PartitionSpec`) and the
plan's JSON stays compatible with the reference package's
``ShardingPlan.to_json``; a reference plan's ``"pallas"`` kernel
decisions read as ``"cuda"``.  On one device each argument signature
runs as a captured CUDA graph on the card, the port's counterpart of the
reference's ``jax.jit`` (:class:`AppliedPlan`, built on
``repro_torch.jit``), with ``donate_argnums`` as the reference's
``jit_kwargs``.  On a mesh of two or more devices the plan runs eagerly
over a ``DeviceMesh``, one process per device: the inputs become
DTensors placed as ``in_specs``, DTensor's sharding propagation plays
GSPMD's part in between (steered to GSPMD's choices where they differ:
``models.sharding.gather_for``), the fused kernel sites run on local shards
under ``local_map`` (``kernels.ops``) and the outputs are redistributed
to ``out_specs``::

    # in each of the 4 ranks of a process group (launch.mesh.run_ranks)
    applied = plan.apply(step, device="cpu")    # plan.mesh: 2x2
    logits = applied(params, batch)             # a DTensor
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import Counter, defaultdict
from typing import Callable

from repro_torch import pytree
from repro_torch.core.conflicts import ConflictAnalysis, analyze_conflicts
from repro_torch.core.constraints import (Constraint, ConstraintError,
                                          check_plan_detailed, match_paths)
from repro_torch.core.cost_model import CostModel, MeshSpec, ShardingState
from repro_torch.core.ir import Program, extract_program
from repro_torch.core.nda import NDAResult, run_nda
from repro_torch.jit import Compiled
from repro_torch.kernels import registry as kernel_registry


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis, a tuple of axes, or None."""

    def __new__(cls, *entries):
        """Build a spec from its per-dim entries."""
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        """The entries, for pickle (``__new__`` takes them one by one)."""
        return tuple(self)

    def __repr__(self) -> str:
        """``PartitionSpec('data', None)``."""
        return f"PartitionSpec{tuple.__repr__(self)}" if len(self) != 1 \
            else f"PartitionSpec({self[0]!r})"


@dataclasses.dataclass(frozen=True)
class Violation:
    """One constraint violation found by :meth:`ShardingPlan.check`.

    Attributes:
        constraint: the violated constraint object.
        message: human-readable description of the violation.
    """

    constraint: Constraint
    message: str

    def __str__(self) -> str:
        """The violation message."""
        return self.message


class CheckResult(list):
    """The violations :meth:`ShardingPlan.check` found.

    A ``list`` of :class:`Violation` that is truthy when the plan
    **satisfies** every constraint and falsy when violations exist —
    iterate it to see which constraints failed.
    """

    def __bool__(self) -> bool:
        """True when no violation was found."""
        return len(self) == 0

    @property
    def messages(self) -> list[str]:
        """The violation messages alone."""
        return [v.message for v in self]


@dataclasses.dataclass
class ShardingPlan:
    """A complete sharding decision for one traced function.

    Attributes:
        mesh: the logical device mesh the plan was searched for.
        in_specs: one ``PartitionSpec`` per flattened program input, in
            ``input_paths`` order.
        input_paths: pytree key paths of the flattened inputs.
        state: the canonical search state (color→axes + resolution bits
            + kernel impls) the specs were projected from.
        cost: the paper cost ``C(s) = RT(s) + MP(s)`` of ``state``.
        breakdown: cost-breakdown dict of the plan.
        baseline_breakdown: same breakdown for the unsharded program.
        constraint_specs: specs for conflict-resolved *intermediate*
            values, keyed by value id.
        logical_rules: ``{logical dim name -> mesh axes}`` projection of
            the plan, when the caller declared ``logical_axes``.
        search_seconds: wall-clock the search took.
        evaluations: cost queries the search backend made.
        num_colors: NDA colors in the analyzed program.
        num_conflicts: sharding conflicts found (paper §3.3).
        num_compat_sets: box-compatibility sets (paper §3.5).
        num_resolution_bits: supergroup resolution bits (paper §3.6).
        backend: name of the search backend that produced the plan.
        eval_stats: evaluator work counters.
        fingerprint: deterministic program fingerprint.
        cached: True when the plan came from a plan store
            (``repro_torch.ckpt.plan_store``).
        out_specs: one ``PartitionSpec`` per flattened program output.
        logical_axes: the flattened per-input logical dim names the plan
            was searched with (``None`` when the request declared none).
        kernel_sites: one record per fused kernel site in the traced
            program, in call order: ``{"site": "<kernel>:<ordinal>",
            "op": op_idx, "kernel": name, "impl": decided impl,
            "sharded": bool, "in_specs": [...], "out_specs": [...]}``.
            :meth:`apply` installs the impls through the models' kernel
            dispatch.
    """

    mesh: MeshSpec
    in_specs: list[PartitionSpec]
    input_paths: list[str]
    state: ShardingState
    cost: float
    breakdown: dict
    baseline_breakdown: dict
    constraint_specs: dict[int, PartitionSpec]
    logical_rules: dict[str, tuple[str, ...]]
    search_seconds: float
    evaluations: int
    num_colors: int
    num_conflicts: int
    num_compat_sets: int
    num_resolution_bits: int
    backend: str = "mcts"
    eval_stats: dict = dataclasses.field(default_factory=dict)
    fingerprint: str = ""
    cached: bool = False
    out_specs: list[PartitionSpec] = dataclasses.field(default_factory=list)
    logical_axes: list[tuple[str, ...] | None] | None = None
    kernel_sites: list[dict] = dataclasses.field(default_factory=list)

    def torch_in_placements(self, mesh) -> list[tuple]:
        """``in_specs`` as DTensor placements on ``mesh``.

        Args:
            mesh: a ``DeviceMesh`` whose dim names are the plan's axes.

        Returns:
            One tuple of placements per input leaf, in ``input_paths``
            order.
        """
        from repro_torch.launch.mesh import placements_for
        return [placements_for(s, mesh, len(s)) for s in self.in_specs]

    def torch_out_placements(self, mesh) -> list[tuple] | None:
        """``out_specs`` as DTensor placements on ``mesh``.

        Args:
            mesh: a ``DeviceMesh`` whose dim names are the plan's axes.

        Returns:
            One tuple of placements per output leaf; ``None`` when the
            plan carries no output specs (pre-output-sharding JSON).
        """
        if not self.out_specs:
            return None
        from repro_torch.launch.mesh import placements_for
        return [placements_for(s, mesh, len(s)) for s in self.out_specs]

    def spec_for(self, pattern: str) -> PartitionSpec | None:
        """Return the spec of the input matching ``pattern``.

        Matching tries exact path equality first, then substring
        containment, then ``fnmatch`` globs.  When several inputs match
        they must all carry the same spec.

        Args:
            pattern: exact path, glob, or substring matched against
                ``input_paths``.

        Returns:
            The matching ``PartitionSpec``, or ``None`` when nothing
            matches.

        Raises:
            ValueError: when the pattern matches several inputs whose
                specs differ (ambiguous).
        """
        idxs = match_paths(pattern, self.input_paths)
        if not idxs:
            return None
        specs = {self.in_specs[i] for i in idxs}
        if len(specs) > 1:
            hits = ", ".join(f"{self.input_paths[i]}={self.in_specs[i]}"
                             for i in idxs)
            raise ValueError(f"spec_for({pattern!r}) is ambiguous: {hits}")
        return self.in_specs[idxs[0]]

    def check(self, constraints, *,
              raise_on_violation: bool = True) -> CheckResult:
        """Check the plan against user constraints.

        Args:
            constraints: iterable of ``repro_torch.core.constraints``
                constraints (``Pin`` / ``Replicate`` / ``Forbid``).
            raise_on_violation: raise ``ConstraintError`` when any
                constraint is violated; pass ``False`` to inspect the
                violations instead.

        Returns:
            A :class:`CheckResult`, truthy when the plan satisfies every
            constraint.

        Raises:
            ConstraintError: listing every violated constraint (unless
                ``raise_on_violation=False``).
        """
        result = CheckResult(
            Violation(c, msg)
            for c, msg in check_plan_detailed(self, tuple(constraints)))
        if result or not raise_on_violation:
            return result
        raise ConstraintError("plan violates constraints: " +
                              "; ".join(result.messages))

    def apply(self, fn: Callable, device=None, *, mesh=None,
              capture: bool | None = None,
              donate_argnums=()) -> "AppliedPlan":
        """Bind the plan to ``fn`` for execution on its mesh.

        Args:
            fn: the function the plan was searched for (same signature).
            device: the device to run on (``None``: the CUDA card, on a
                mesh each rank's; ``"cpu"`` runs the plain path on the
                CPU, on a mesh over a gloo group).
            mesh: for a plan of two or more devices, the ``DeviceMesh``
                to run on (``None``: built from the plan's ``MeshSpec``
                by ``launch.mesh.compat_make_mesh`` over the process
                group); a one-device plan takes none.
            capture: run each argument signature as a captured CUDA
                graph, the port's ``jax.jit`` (see :class:`AppliedPlan`).
                ``None`` captures on one CUDA device and runs eagerly on
                the CPU and on a mesh, where no graph is taken;
                ``False`` runs eagerly (the eager side of a parity
                check).
            donate_argnums: an index or a tuple of indices of the
                arguments whose leaves are donated, as the reference's
                ``jit_kwargs`` pass them to ``jax.jit``: each output
                takes a donated buffer of its shape and dtype, in
                flattening order (``repro_torch.jit``).

        Returns:
            An :class:`AppliedPlan`; call it like ``fn``.

        Raises:
            RuntimeError: when no CUDA device is available and
                ``device`` is not given; for a plan of two or more
                devices, when no process group of the mesh's size is
                initialised.
            ValueError: for ``capture=True`` on a device other than CUDA
                or on a mesh of two or more devices; for a ``mesh`` that
                is not the plan's.
        """
        return AppliedPlan(self, fn, device, capture, donate_argnums, mesh)

    def as_dict(self) -> dict:
        """JSON-serializable dict capturing the full plan (the inverse of
        :meth:`from_dict`)."""
        return {
            "mesh": self.mesh.as_dict(),
            "in_specs": [list(map(_spec_entry, s)) for s in self.in_specs],
            "input_paths": self.input_paths,
            "state": {"color_axes": [[c, list(axes)] for c, axes in
                                     self.state.color_axes],
                      "bits": [list(b) for b in self.state.bits],
                      "kernel_impls": [[i, impl] for i, impl in
                                       self.state.kernel_impls]},
            "cost": self.cost,
            "breakdown": self.breakdown,
            "baseline_breakdown": self.baseline_breakdown,
            "constraint_specs": {str(vid): list(map(_spec_entry, s))
                                 for vid, s in self.constraint_specs.items()},
            "logical_rules": {k: list(v) for k, v in
                              self.logical_rules.items()},
            "search_seconds": self.search_seconds,
            "evaluations": self.evaluations,
            "num_colors": self.num_colors,
            "num_conflicts": self.num_conflicts,
            "num_compat_sets": self.num_compat_sets,
            "num_resolution_bits": self.num_resolution_bits,
            "backend": self.backend,
            "eval_stats": self.eval_stats,
            "fingerprint": self.fingerprint,
            "out_specs": [list(map(_spec_entry, s)) for s in self.out_specs],
            "logical_axes": (None if self.logical_axes is None else
                             [list(t) if t is not None else None
                              for t in self.logical_axes]),
            "kernel_sites": [
                {"site": r["site"], "op": r["op"], "kernel": r["kernel"],
                 "impl": r["impl"], "sharded": r["sharded"],
                 "in_specs": [list(map(_spec_entry, s))
                              for s in r["in_specs"]],
                 "out_specs": [list(map(_spec_entry, s))
                               for s in r["out_specs"]]}
                for r in self.kernel_sites],
            "schema": 2,
        }

    def to_json(self) -> str:
        """Serialize the plan to a JSON string (see :meth:`as_dict`)."""
        return json.dumps(self.as_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "ShardingPlan":
        """Rebuild a plan from :meth:`as_dict` output.

        Also reads the reference package's plan JSON; its ``"pallas"``
        kernel decisions become ``"cuda"``.

        Args:
            d: a dict produced by :meth:`as_dict` / parsed plan JSON.

        Returns:
            An equivalent ``ShardingPlan``.
        """
        m = d["mesh"]
        state_d = d.get("state", {"color_axes": [], "bits": []})
        port = kernel_registry.port_impl
        return cls(
            mesh=MeshSpec(tuple(m["axes"]), tuple(m["sizes"]),
                          tuple(m.get("dcn_axes", ()))),
            in_specs=[_spec_from_entries(s) for s in d["in_specs"]],
            input_paths=list(d["input_paths"]),
            state=ShardingState(
                tuple((int(c), tuple(axes))
                      for c, axes in state_d["color_axes"]),
                tuple((int(sg), int(b)) for sg, b in state_d["bits"]),
                tuple((int(i), port(str(impl))) for i, impl in
                      state_d.get("kernel_impls", []))),
            cost=d["cost"],
            breakdown=dict(d["breakdown"]),
            baseline_breakdown=dict(d["baseline_breakdown"]),
            constraint_specs={int(vid): _spec_from_entries(s)
                              for vid, s in
                              d.get("constraint_specs", {}).items()},
            logical_rules={k: tuple(v) for k, v in
                           d.get("logical_rules", {}).items()},
            search_seconds=d["search_seconds"],
            evaluations=d["evaluations"],
            num_colors=d["num_colors"],
            num_conflicts=d["num_conflicts"],
            num_compat_sets=d["num_compat_sets"],
            num_resolution_bits=d["num_resolution_bits"],
            backend=d.get("backend", "mcts"),
            eval_stats=dict(d.get("eval_stats", {})),
            fingerprint=d.get("fingerprint", ""),
            out_specs=[_spec_from_entries(s)
                       for s in d.get("out_specs", [])],
            logical_axes=(None if d.get("logical_axes") is None else
                          [tuple(t) if t is not None else None
                           for t in d["logical_axes"]]),
            kernel_sites=[
                {"site": r["site"], "op": int(r["op"]),
                 "kernel": r["kernel"], "impl": port(r["impl"]),
                 "sharded": bool(r["sharded"]),
                 "in_specs": [_spec_from_entries(s)
                              for s in r["in_specs"]],
                 "out_specs": [_spec_from_entries(s)
                               for s in r["out_specs"]]}
                for r in d.get("kernel_sites", [])],
        )

    @classmethod
    def from_json(cls, s: str) -> "ShardingPlan":
        """Rebuild a plan from a :meth:`to_json` string.

        Args:
            s: JSON produced by :meth:`to_json`.

        Returns:
            The reconstructed ``ShardingPlan``.
        """
        return cls.from_dict(json.loads(s))


class AppliedPlan(Compiled):
    """The result of :meth:`ShardingPlan.apply`: ``fn`` bound to a plan.

    Each run of ``fn`` happens under a kernel-dispatch context carrying
    the plan's per-site kernel decisions, so every fused site executes
    the implementation the plan chose.

    As the reference's jitted ``AppliedPlan``, it keeps one entry per
    argument signature: the arguments' treedef and each leaf's shape,
    dtype and, for a DTensor, placements.  The first call of a signature
    checks ``fn``'s output leaves against the plan's ``out_specs``.

    *One device.*  Arguments must already lie on the plan's device.
    Each entry is captured as a CUDA graph on a CUDA device, with
    donation as ``jax.jit``'s ``donate_argnums`` (see
    :class:`repro_torch.jit.Compiled`).

    *A mesh of two or more devices.*  Each process of the group holds one
    ``AppliedPlan`` and calls it on the same arguments, as any SPMD
    program does.  A call places every input leaf as its ``in_specs``
    entry (each rank keeps its block of a full tensor, which moves no
    data; a DTensor is redistributed; :meth:`place` does it ahead of the
    calls), runs ``fn`` eagerly under a dispatch that
    also carries the mesh and each sharded site's specs (``kernels.ops``
    runs the sites under ``local_map``), and redistributes every output
    leaf to its ``out_specs`` entry.  Donation works as on the CPU, on
    the placed leaves: a donated DTensor that arrives placed as its
    ``in_specs`` entry takes the value of the output placed as it is
    after ``fn`` returns, and is returned for it; one whose output's
    ``out_specs`` entry differs raises ``ValueError``.  A leaf that the
    call places itself (a full tensor, a DTensor placed otherwise) is a
    new tensor, so the caller's buffer is donated only when the leaf
    arrives placed (:meth:`place`).  Nothing is captured: the card's
    host has one card, so no multi-card graph can be checked (ROADMAP
    queue 1, item 8).

    Attributes:
        mesh: the ``DeviceMesh`` (``None`` for a one-device plan).
    """

    def __init__(self, plan: "ShardingPlan", fn: Callable, device,
                 capture: bool | None = None, donate_argnums=(),
                 mesh=None) -> None:
        """Bind a plan to a function and a device or mesh.

        Args:
            plan: the sharding plan to install.
            fn: the function the plan was searched for.
            device: where it runs (``None``: the CUDA card).
            capture: capture CUDA graphs (``None``: on one CUDA device).
            donate_argnums: the indices of the donated arguments.
            mesh: the ``DeviceMesh`` of a plan of two or more devices
                (``None``: built from the plan's ``MeshSpec``).

        Raises:
            RuntimeError: for a plan of two or more devices, when no
                process group of the mesh's size is initialised.
            ValueError: for ``capture=True`` on a device other than CUDA
                or on a mesh; for a ``mesh`` that is not the plan's.
        """
        self.plan = plan
        self.impls = {r["site"]: r["impl"] for r in plan.kernel_sites}
        spec = plan.mesh
        if spec.num_devices == 1:
            if mesh is not None:
                raise ValueError("a one-device plan runs without a mesh")
        else:
            if capture:
                raise ValueError(
                    f"capture=True: a plan of {spec.num_devices} devices "
                    f"runs eagerly (no multi-card graph can be checked on "
                    f"a host with one card; ROADMAP queue 1, item 8)")
            capture = False
            if mesh is None:
                from repro_torch.launch.mesh import compat_make_mesh
                mesh = compat_make_mesh(spec.sizes, spec.axes, device)
            if tuple(mesh.shape) != tuple(spec.sizes) or \
                    tuple(mesh.mesh_dim_names) != tuple(spec.axes):
                raise ValueError(
                    f"the mesh {tuple(mesh.mesh_dim_names)} "
                    f"{tuple(mesh.shape)} is not the plan's "
                    f"{tuple(spec.axes)} {tuple(spec.sizes)}")
            device = mesh.device_type if device is None else device
        self.mesh = mesh
        super().__init__(fn, device, capture, donate_argnums)

    def _flatten(self, args):
        return pytree.tree_leaves(args), self.plan.input_paths

    def _check_call(self, kwargs, leaves, paths) -> None:
        if kwargs:
            raise ValueError("plan.apply() functions take positional "
                             "arguments only")
        if len(leaves) != len(self.plan.in_specs):
            raise ValueError(
                f"plan has {len(self.plan.in_specs)} input specs but the "
                f"call provides {len(leaves)} argument leaves")
        super()._check_call(kwargs, leaves, paths)

    def _dispatch(self):
        from repro_torch.models.sharding import (KernelDispatch,
                                                 kernel_dispatch)
        specs = {}
        if self.mesh is not None:
            specs = {r["site"]: (tuple(r["in_specs"]),
                                 r["out_specs"][0]
                                 if len(r["out_specs"]) == 1
                                 else tuple(r["out_specs"]))
                     for r in self.plan.kernel_sites if r["sharded"]}
        return kernel_dispatch(KernelDispatch(
            impls=dict(self.impls), mesh=self.mesh, specs=specs))

    def _check_outputs(self, out) -> None:
        n = len(pytree.tree_leaves(out))
        if self.plan.out_specs and n != len(self.plan.out_specs):
            raise ValueError(
                f"plan has {len(self.plan.out_specs)} output specs but fn "
                f"returns {n} leaves")

    def place(self, args):
        """``args`` placed on the mesh as the plan's ``in_specs``.

        A call places its arguments itself; placing them once ahead keeps
        the split of full tensors out of every call, and lets a donating
        call write the new state into the placed leaves.  No placed leaf
        shares memory with the caller's tensors (a shard that would be a
        view of a full tensor is copied out of it), so a donated call
        writes none of them.

        Args:
            args: the positional arguments, as ``fn`` takes them.

        Returns:
            The same tree with every leaf a DTensor (the tree itself for
            a one-device plan).
        """
        if self.mesh is None:
            return args
        leaves = pytree.tree_leaves(args)
        placed = self._place(args, leaves)[1]
        return pytree.unflatten(args, [
            p.clone() if p.to_local().untyped_storage().data_ptr() ==
            x.untyped_storage().data_ptr() else p
            for p, x in zip(placed, leaves)])

    def _place(self, args, leaves):
        if self.mesh is None:
            return args, leaves
        from torch.distributed.tensor import distribute_tensor

        from repro_torch.models.sharding import is_dtensor
        placed = []
        for x, want in zip(leaves, self.plan.torch_in_placements(self.mesh)):
            if not is_dtensor(x):
                # each rank holds the same full tensor: split it locally
                x = distribute_tensor(x, self.mesh, want, src_data_rank=None)
            elif tuple(x.placements) != want:
                x = x.redistribute(self.mesh, want)
            placed.append(x)
        return pytree.unflatten(args, placed), placed

    def _finish(self, out):
        if self.mesh is None or not self.plan.out_specs:
            return out
        placed = []
        for x, want in zip(pytree.tree_leaves(out),
                           self.plan.torch_out_placements(self.mesh)):
            if tuple(x.placements) != want:
                x = x.redistribute(self.mesh, want)
            placed.append(x)
        return pytree.unflatten(out, placed)


def _spec_entry(e):
    if e is None:
        return None
    if isinstance(e, tuple):
        return list(e)
    return e


def _spec_from_entries(entries) -> PartitionSpec:
    return PartitionSpec(*[tuple(e) if isinstance(e, list) else e
                           for e in entries])


@dataclasses.dataclass
class ToastArtifacts:
    """Analysis artifacts, reusable across searches (paper §5.3)."""
    prog: Program
    nda: NDAResult
    analysis: ConflictAnalysis
    actions_by_mesh: dict = dataclasses.field(default_factory=dict)
    # wall seconds per analysis phase ("trace" / "nda" / "conflicts")
    phase_seconds: dict = dataclasses.field(default_factory=dict)


def analyze(fn: Callable, args: tuple, kwargs: dict | None = None
            ) -> ToastArtifacts:
    """Trace ``fn`` and run the mesh-independent analysis once.

    Args:
        fn: function to trace (exported on ``meta`` tensors, never run
            on data).
        args: example positional arguments (``meta`` tensors suffice).
        kwargs: example keyword arguments.

    Returns:
        :class:`ToastArtifacts` reusable across meshes and searches,
        with per-phase wall times in ``phase_seconds``.
    """
    t0 = time.perf_counter()
    prog = extract_program(fn, *args, **(kwargs or {}))
    t1 = time.perf_counter()
    nda = run_nda(prog)
    t2 = time.perf_counter()
    analysis = analyze_conflicts(nda)
    t3 = time.perf_counter()
    phases = {"trace": t1 - t0, "nda": t2 - t1, "conflicts": t3 - t2}
    return ToastArtifacts(prog, nda, analysis, phase_seconds=phases)


def _state_specs(cm: CostModel, state: ShardingState,
                 vids: list[int]) -> list[PartitionSpec]:
    """Project a search state onto one ``PartitionSpec`` per value id
    (program inputs or outputs)."""
    color_axes, bits = state.as_dicts()
    _, suppressed = cm._chosen_suppressed(bits)
    specs = []
    for vid in vids:
        site = cm.nda.def_site[vid]
        axes = cm.site_axes(site, color_axes, suppressed)
        specs.append(PartitionSpec(*[
            (a[0] if len(a) == 1 else tuple(a)) if a else None
            for a in axes]))
    return specs


def kernel_site_records(cm: CostModel,
                        state: ShardingState) -> list[dict]:
    """Project a search state onto per-site fused-kernel records.

    One record per dispatch-site kernel op, in program order — which is
    call order, so the ``"<kernel>:<ordinal>"`` site keys line up with
    the execution-time dispatch counters.  Specs cover **mappable**
    roles only: blocked roles are never sharded inside the kernel.

    Args:
        cm: the cost model built for the plan's mesh.
        state: the final search state.

    Returns:
        ``ShardingPlan.kernel_sites``-shaped records (see its docstring).
    """
    color_axes, bits = state.as_dicts()
    _, suppressed = cm._chosen_suppressed(bits)
    impls = dict(state.kernel_impls)
    counters: Counter = Counter()
    records: list[dict] = []

    def _project(roles, vid, mappable):
        axes = cm.site_axes(cm.nda.def_site[vid], color_axes, suppressed)
        entries, sharded = [], False
        for role, a in zip(roles, axes):
            if role in mappable and a:
                entries.append(a[0] if len(a) == 1 else tuple(a))
                sharded = True
            else:
                entries.append(None)
        return PartitionSpec(*entries), sharded

    for op_idx, op in enumerate(cm.prog.ops):
        spec = kernel_registry.spec_for_prim(op.prim)
        if spec is None or not spec.dispatch_site:
            continue
        ordinal = counters[spec.name]
        counters[spec.name] += 1
        in_specs, out_specs, sharded = [], [], False
        for roles, vid in zip(spec.operand_roles, op.operands):
            ps, sh = _project(roles, vid, spec.mappable)
            in_specs.append(ps)
            sharded = sharded or sh
        for roles, vid in zip(spec.result_roles, op.results):
            ps, sh = _project(roles, vid, spec.mappable)
            out_specs.append(ps)
            sharded = sharded or sh
        records.append({
            "site": f"{spec.name}:{ordinal}", "op": op_idx,
            "kernel": spec.name,
            "impl": impls.get(op_idx, spec.default_impl),
            "sharded": sharded,
            "in_specs": in_specs, "out_specs": out_specs})
    return records


def _constraint_specs(cm: CostModel, state: ShardingState,
                      analysis: ConflictAnalysis) -> dict[int, PartitionSpec]:
    color_axes, bits = state.as_dicts()
    _, suppressed = cm._chosen_suppressed(bits)
    out: dict[int, PartitionSpec] = {}
    for c in analysis.conflicts:
        if c.color not in color_axes:
            continue
        for w in c.witnesses:
            if w.site.kind != "def":
                continue
            axes = cm.site_axes(w.site, color_axes, suppressed)
            out[w.site.value] = PartitionSpec(*[
                (a[0] if len(a) == 1 else tuple(a)) if a else None
                for a in axes])
    return out


def _is_name_tuple(x) -> bool:
    # NB: the empty tuple is a *container* (matches empty containers in the
    # args tree), never a name leaf — else flatten order desynchronises.
    return x is None or (isinstance(x, tuple) and type(x) is tuple and
                         len(x) > 0 and
                         all(isinstance(e, (str, type(None))) for e in x))


def flatten_logical_axes(names_tree) -> list[tuple[str, ...] | None]:
    """Flatten a logical-names pytree into program-input order.

    Args:
        names_tree: pytree mirroring the function arguments with tuples
            of logical dim names (or ``None``) at leaf positions.

    Returns:
        One names-tuple (or ``None``) per flattened input leaf, in the
        order used by ``extract_program``.
    """
    out: list = []

    def walk(node):
        if _is_name_tuple(node):
            out.append(node)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (tuple, list)):
            for c in node:
                walk(c)
        else:
            out.append(None)

    walk(names_tree)
    return out


def _logical_rules(nda: NDAResult, prog: Program, state: ShardingState,
                   logical_axes: list[tuple[str, ...]] | None
                   ) -> dict[str, tuple[str, ...]]:
    """Project the color→axes assignment onto caller-declared logical
    dimension names (majority vote per color)."""
    if logical_axes is None:
        return {}
    color_axes, _ = state.as_dicts()
    votes: dict[int, Counter] = defaultdict(Counter)
    for vid, names in zip(prog.inputs, logical_axes):
        if names is None:
            continue
        cols = nda.colors_of_value(vid)
        for col, name in zip(cols, names):
            if name:
                votes[col][name] += 1
    rules: dict[str, tuple[str, ...]] = {}
    for col, axes in color_axes.items():
        if col in votes and axes:
            name = votes[col].most_common(1)[0][0]
            rules[name] = tuple(axes)
    return rules


def auto_partition(fn: Callable, args: tuple, mesh: MeshSpec, *,
                   kwargs: dict | None = None,
                   hw=None,
                   mcts=None,
                   backend="mcts",
                   search_config=None,
                   portfolio=None,
                   plan_store=None,
                   min_dims: int | None = None,
                   logical_axes=None,
                   constraints=(),
                   artifacts: ToastArtifacts | None = None) -> "ShardingPlan":
    """Run the full TOAST pipeline on ``fn(*args, **kwargs)``.

    The one-shot wrapper over the staged API, as the reference's: it
    builds a ``repro_torch.api.Session`` (trace, NDA, conflicts) and a
    ``Request``, and returns ``session.partition(request)``.  Several
    partitions of one function are cheaper through an explicit
    ``Session``.

    Args:
        fn: the function to partition (traced on ``meta`` tensors, never
            run).
        args: example arguments (``meta`` tensors suffice).
        mesh: the logical device mesh to shard over.
        kwargs: keyword arguments of ``fn``.
        hw: hardware constants (``None``: the H100 defaults).
        mcts: an ``MCTSConfig`` used when the backend is MCTS and no
            ``search_config`` is given.
        backend: "mcts" (default), "beam", "greedy", "portfolio", or a
            ``SearchBackend``.
        search_config: the backend's config (``BeamConfig``,
            ``PortfolioConfig``, ...).
        portfolio: convenience switch for the portfolio runner: a
            ``repro_torch.core.portfolio.PortfolioConfig`` (or ``True``
            for the default portfolio) instead of setting ``backend``
            and ``search_config`` separately.
        plan_store: a ``repro_torch.ckpt.plan_store.PlanStore`` (or a
            directory path for one).  A plan cached under this
            program's fingerprint x ``mesh`` x ``hw`` x request key is
            returned without searching, and fresh plans are stored on
            the way out.
        min_dims: action-space pruning threshold (``None``: the
            default).
        logical_axes: per-input logical dim names; enables
            ``plan.logical_rules``.
        constraints: ``Pin`` / ``Replicate`` / ``Forbid`` constraints.
        artifacts: analysis artifacts to reuse (:func:`analyze`).

    Returns:
        The :class:`ShardingPlan`; ``plan.cached`` is True when it came
        from the plan store.
    """
    from repro_torch.api import Request, Session
    from repro_torch.core.actions import DEFAULT_MIN_DIMS
    from repro_torch.core.cost_model import HardwareSpec
    from repro_torch.core.search import get_backend
    if portfolio is not None and portfolio is not False:
        backend = "portfolio"
        if search_config is None and not isinstance(portfolio, bool):
            search_config = portfolio
    if search_config is None and mcts is not None:
        engine = get_backend(backend)
        if engine.name == "mcts":
            search_config = mcts
        backend = engine        # resolved once; reused by the session
    request = Request(mesh=mesh, hw=HardwareSpec() if hw is None else hw,
                      backend=backend, search_config=search_config,
                      min_dims=DEFAULT_MIN_DIMS if min_dims is None
                      else min_dims,
                      logical_axes=logical_axes,
                      constraints=tuple(constraints))
    return Session(fn, args, kwargs=kwargs, artifacts=artifacts,
                   plan_store=plan_store).partition(request)
