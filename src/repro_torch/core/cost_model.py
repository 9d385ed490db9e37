"""Analytical cost model (paper §4.5) with precomputed static tables.

An abstract interpreter over the extracted Program that, given a sharding
state (color→axes assignment + conflict resolution bits), estimates:

- per-op compute time via a roofline (matmul-class FLOPs vs HBM bytes),
- collective communication time for the resharding implied between value
  defs and uses (all_gather / all_to_all), for contracting-dim sharding
  (all_reduce), and for sharded reductions,
- peak per-device memory via live-range analysis.

The MCTS consumes *relative* cost: C(s) = RT(s) + MP(s), with
RT = runtime(s)/runtime(unsharded) and MP a penalty only above the
per-device memory budget — exactly the paper's formulation.

Fast and scalable (paper §5.3): ``__init__`` builds, once per
``(Program, MeshSpec)``, a static op-cost table — per-op site color/group/
size tuples, operand/result byte counts, base (unsharded) cost rows, and
color→op / group→op dependency sets — plus vectorized numpy live-range
tables.  ``evaluate`` then only re-costs the ops and values whose sites are
touched by the state's colors and resolution bits (diff-from-base); peak
memory is a scatter-add + cumsum over precomputed live intervals instead of
a per-op python live-set walk.  The original exhaustive interpreter is kept
verbatim as ``evaluate_dense`` — the exactness oracle and the "seed path"
baseline of ``benchmarks/search_throughput.py``.  Single-action deltas on
top of a parent state live in ``repro_torch.core.evaluator``.

Hardware constants default to one NVIDIA H100 SXM from its data sheet
(989 TFLOP/s dense bf16, 3.35 TB/s HBM, 450 GB/s NVLink each way).
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict

import numpy as np

from repro_torch.core.conflicts import ConflictAnalysis
from repro_torch.core.ir import Program
from repro_torch.core.nda import NDAResult
from repro_torch.kernels import registry as kernel_registry


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Roofline constants the cost model prices sharding states with.

    The defaults describe one NVIDIA H100 SXM card, taken from NVIDIA's
    data sheet (not measured); the spec round-trips through JSON
    (:meth:`as_dict` / :meth:`from_dict`).

    Attributes:
        flops_per_chip: peak per-chip FLOP/s (bf16).
        hbm_bw: HBM bandwidth, bytes/s.
        ici_bw: per-link inter-chip bandwidth, bytes/s (per mesh axis).
        dcn_bw: cross-pod bandwidth for ``MeshSpec.dcn_axes``.
        hbm_per_chip: per-device memory budget in bytes.
        mem_penalty_scale: the paper's memory-penalty constant C.
        coll_latency: fixed cost per collective per mesh axis, seconds
            (0.0 keeps the pre-calibration pure-bandwidth model).
        axis_bw: per-mesh-axis bandwidth overrides as sorted
            ``((axis, bytes/s), ...)`` pairs; axes absent here fall back
            to ``ici_bw`` / ``dcn_bw``.
        kernel_rates: calibrated effective FLOP/s per fused kernel
            implementation, as sorted ``(("<kernel>:<impl>", rate), ...)``
            pairs.  Kernel sites absent here are priced at
            ``flops_per_chip``.
    """

    flops_per_chip: float = 989e12      # H100 SXM data sheet: dense bf16
    hbm_bw: float = 3.35e12             # H100 SXM data sheet: HBM3 bytes/s
    ici_bw: float = 450e9               # H100 SXM data sheet: NVLink, each way
    dcn_bw: float = 6.25e9              # bytes/s cross-node (50 Gbit)
    hbm_per_chip: float = 80e9          # H100 SXM data sheet: 80 GB
    mem_penalty_scale: float = 10.0     # paper's constant C
    coll_latency: float = 0.0           # s per collective per axis
    axis_bw: tuple[tuple[str, float], ...] = ()
    kernel_rates: tuple[tuple[str, float], ...] = ()

    def __post_init__(self) -> None:
        """Normalize ``axis_bw`` / ``kernel_rates`` spellings to tuples."""
        for field in ("axis_bw", "kernel_rates"):
            val = getattr(self, field)
            if isinstance(val, dict):
                val = val.items()
            norm = tuple(sorted((str(a), float(b)) for a, b in val))
            object.__setattr__(self, field, norm)

    def as_dict(self) -> dict:
        """JSON-serializable dict (inverse of :meth:`from_dict`)."""
        d = dataclasses.asdict(self)
        d["axis_bw"] = [[a, b] for a, b in self.axis_bw]
        d["kernel_rates"] = [[k, r] for k, r in self.kernel_rates]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "HardwareSpec":
        """Rebuild a spec from :meth:`as_dict` output.

        Args:
            d: dict with any subset of the spec's fields (unknown keys
                are ignored; missing ones keep their defaults).

        Returns:
            The reconstructed ``HardwareSpec``.
        """
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        for field in ("axis_bw", "kernel_rates"):
            if kw.get(field) is not None:
                kw[field] = tuple((a, float(b)) for a, b in kw[field])
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    axes: tuple[str, ...]
    sizes: tuple[int, ...]
    # axes whose links traverse DCN rather than ICI (e.g. "pod")
    dcn_axes: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        """Validate the mesh shape eagerly, with actionable errors."""
        if len(self.axes) != len(self.sizes):
            raise ValueError(
                f"mesh has {len(self.axes)} axes {tuple(self.axes)} but "
                f"{len(self.sizes)} sizes {tuple(self.sizes)}")
        if len(set(self.axes)) != len(self.axes):
            raise ValueError(f"duplicate mesh axis names: {tuple(self.axes)}")
        for a, s in zip(self.axes, self.sizes):
            if int(s) != s or s < 1:
                raise ValueError(
                    f"mesh axis {a!r} has invalid size {s!r} "
                    f"(sizes must be positive integers)")
        unknown = [a for a in self.dcn_axes if a not in self.axes]
        if unknown:
            raise ValueError(
                f"dcn_axes {unknown} are not mesh axes {tuple(self.axes)}")

    def size(self, axis: str) -> int:
        """Size of one mesh axis.

        Args:
            axis: mesh axis name.

        Returns:
            The axis size.

        Raises:
            ValueError: when ``axis`` is not one of the mesh's axes (the
                message lists the valid names — a bare ``tuple.index``
                ``ValueError`` here used to hide the typo).
        """
        try:
            i = self.axes.index(axis)
        except ValueError:
            raise ValueError(
                f"unknown mesh axis {axis!r}; valid axes: "
                f"{tuple(self.axes)}") from None
        return self.sizes[i]

    @property
    def num_devices(self) -> int:
        return int(np.prod(self.sizes))

    def as_dict(self) -> dict:
        """JSON-serializable dict (the plan/store/zoo wire format)."""
        return {"axes": list(self.axes), "sizes": list(self.sizes),
                "dcn_axes": list(self.dcn_axes)}


@dataclasses.dataclass(frozen=True)
class ShardingState:
    """Canonical, order-independent search state (paper §4.3).

    ``kernel_impls`` records the per-site fused-kernel implementation
    decisions (op index -> impl name) — the extra decision dimension the
    kernel-aware search explores jointly with sharding.  Sites without
    an entry are priced and executed at their registry default impl.
    """
    color_axes: tuple[tuple[int, tuple[str, ...]], ...] = ()
    bits: tuple[tuple[int, int], ...] = ()           # (supergroup, bit)
    kernel_impls: tuple[tuple[int, str], ...] = ()   # (op index, impl)

    def as_dicts(self):
        return dict(self.color_axes), dict(self.bits)

    def with_action(self, color: int, axis: str,
                    bit_choices: tuple[tuple[int, int], ...]) -> "ShardingState":
        ca, bits = self.as_dicts()
        ca[color] = tuple(list(ca.get(color, ())) + [axis])
        for sg, b in bit_choices:
            bits.setdefault(sg, b)
        return ShardingState(tuple(sorted(ca.items())),
                             tuple(sorted(bits.items())),
                             self.kernel_impls)

    def with_kernel_impl(self, op_idx: int, impl: str) -> "ShardingState":
        """This state plus one fused-site implementation decision."""
        ki = dict(self.kernel_impls)
        ki[op_idx] = impl
        return ShardingState(self.color_axes, self.bits,
                             tuple(sorted(ki.items())))

    @property
    def used_axes(self) -> set[str]:
        return {a for _, axes in self.color_axes for a in axes}


@dataclasses.dataclass
class CostBreakdown:
    compute_time: float = 0.0
    memory_time: float = 0.0
    collective_time: float = 0.0
    peak_bytes: float = 0.0
    flops: float = 0.0
    comm_bytes: float = 0.0

    @property
    def runtime(self) -> float:
        # sequential program: per-op max(compute, hbm) summed, plus comms
        return self.compute_time + self.collective_time

    def as_dict(self):
        return dataclasses.asdict(self) | {"runtime": self.runtime}


_MATMUL_PRIMS = {"dot_general", "conv_general_dilated"}

# static tables built by _build_static_tables: functions of (Program, NDA)
# only — independent of both the mesh shape and the hardware constants,
# so with_hardware / with_mesh share them read-only instead of rebuilding
_STATIC_TABLE_ATTRS = (
    "_op_specs", "_color_ops", "_group_ops", "_sg_groups",
    "_live_vids", "_vid_slot", "_live_start", "_live_end",
    "_val_info", "_color_vals", "_group_vals",
    "_base_val_bytes", "_base_delta", "_base_peak", "_kernel_specs")

# a cost row is (compute_time, memory_time, collective_time, flops,
# comm_bytes) — the per-op contribution to the breakdown totals.
_ROW_FIELDS = 5
_EMPTY = frozenset()


class CostModel:
    def __init__(self, prog: Program, nda: NDAResult,
                 analysis: ConflictAnalysis, mesh: MeshSpec,
                 hw: HardwareSpec = HardwareSpec()) -> None:
        self.prog = prog
        self.nda = nda
        self.analysis = analysis
        self.mesh = mesh
        self.hw = hw
        # index use sites by (op_index, slot)
        self.use_site = {}
        for s in nda.use_sites:
            self.use_site[(s.op_index, s.slot)] = s
        # last use per value for live-range analysis
        self.last_use: dict[int, int] = {}
        for i, op in enumerate(prog.ops):
            for vid in op.operands:
                self.last_use[vid] = i
        self._baseline: CostBreakdown | None = None
        # cache: state -> cost breakdown
        self._cache: dict[ShardingState, CostBreakdown] = {}
        # cache: bits tuple -> frozenset of suppressed groups
        self._suppressed_cache: dict[tuple, frozenset] = {}
        self._axis_size = dict(zip(mesh.axes, mesh.sizes))
        self._axis_bw_map = dict(hw.axis_bw)
        self._kernel_rates_map = dict(hw.kernel_rates)
        # optional per-axis collective recorder (see state_features)
        self._tally: dict | None = None
        # site -> (colors, groups, sizes) memo: def sites are looked up
        # once per *use* plus once per value, and sharing the tuple object
        # lets the batched recost memoize resolutions by id(info)
        self._info_cache: dict[int, tuple] = {}
        self._build_static_tables()
        self._build_base_rows()

    def with_hardware(self, hw: HardwareSpec) -> "CostModel":
        """A cost model for the same analysis under different hardware.

        Re-costing a program under a calibrated ``HardwareSpec`` must not
        pay for re-analysis: the static tables built by ``__init__`` —
        per-op site infos, dirty-set indices, live-range intervals — are
        all hardware-independent and are *shared* with the new model;
        only the unsharded base cost rows (a function of the roofline
        constants) are recomputed.

        Args:
            hw: the hardware spec the new model prices with.

        Returns:
            A fresh ``CostModel`` over the same (program, mesh) with
            empty evaluation caches.
        """
        cm = object.__new__(CostModel)
        cm.prog, cm.nda, cm.analysis = self.prog, self.nda, self.analysis
        cm.mesh, cm.hw = self.mesh, hw
        cm.use_site = self.use_site
        cm.last_use = self.last_use
        cm._baseline = None
        cm._cache = {}
        cm._suppressed_cache = self._suppressed_cache   # analysis-only
        cm._info_cache = self._info_cache               # analysis-only
        cm._axis_size = self._axis_size
        cm._axis_bw_map = dict(hw.axis_bw)
        cm._kernel_rates_map = dict(hw.kernel_rates)
        cm._tally = None
        # hardware-independent static tables, shared read-only
        for name in _STATIC_TABLE_ATTRS:
            setattr(cm, name, getattr(self, name))
        cm._build_base_rows()
        return cm

    def with_mesh(self, mesh: MeshSpec) -> "CostModel":
        """A cost model for the same analysis over a different mesh.

        The dual of :meth:`with_hardware`, and what makes mesh-shape
        co-search cheap: every static table built by ``__init__`` —
        per-op site infos, color/group dirty indices, live-range
        intervals — depends only on the *program analysis*, and even the
        unsharded base cost rows are mesh-independent (the replicated
        state does no collectives).  All of them are shared read-only;
        the new model only gets fresh axis-size/bandwidth lookup maps
        and empty evaluation caches.

        Args:
            mesh: the mesh the new model resolves sharding states
                against (its ``dcn_axes`` select the DCN bandwidth for
                collectives that cross pods).

        Returns:
            A fresh ``CostModel`` over the same (program, hardware) on
            ``mesh``.
        """
        cm = object.__new__(CostModel)
        cm.prog, cm.nda, cm.analysis = self.prog, self.nda, self.analysis
        cm.mesh, cm.hw = mesh, self.hw
        cm.use_site = self.use_site
        cm.last_use = self.last_use
        cm._baseline = None
        cm._cache = {}
        cm._suppressed_cache = self._suppressed_cache   # analysis-only
        cm._info_cache = self._info_cache               # analysis-only
        cm._axis_size = dict(zip(mesh.axes, mesh.sizes))
        cm._axis_bw_map = dict(self.hw.axis_bw)
        cm._kernel_rates_map = dict(self.hw.kernel_rates)
        cm._tally = None
        for name in _STATIC_TABLE_ATTRS:
            setattr(cm, name, getattr(self, name))
        # base rows are a function of hardware only: the unsharded state
        # resolves every site to no axes, so no mesh lookup ever happens
        cm.base_rows = self.base_rows
        cm._base_totals = self._base_totals
        return cm

    # -- static tables (built once per Program × MeshSpec) -------------------

    def _site_info(self, site):
        """Precompute (colors, groups, sizes) per dim of a site, so the hot
        path never touches the union-find.

        Memoized per site object: a def site is looked up once per *use*
        plus once per live value, and handing back the same tuple object
        every time lets the batched recost (:meth:`recost`) memoize axis
        resolutions by ``id(info)`` across all dirty ops of one action.
        The cache entry keeps the site alive so its ``id`` stays valid.
        """
        key = id(site)
        hit = self._info_cache.get(key)
        if hit is not None and hit[0] is site:
            return hit[1]
        colors = self.nda.colors_arr
        groups = self.nda.groups_arr
        sizes = self.nda.node_sizes
        info = (tuple(int(colors[n]) for n in site.dims),
                tuple(int(groups[n]) for n in site.dims),
                tuple(sizes.get(n, 0) for n in site.dims))
        self._info_cache[key] = (site, info)
        return info

    def _build_static_tables(self) -> None:
        prog = self.prog
        n_ops = len(prog.ops)
        # per-op cost spec: (op, trip, use_infos, reshard_def_infos,
        #                    out_infos, operand_nbytes, result_nbytes)
        self._op_specs = []
        color_ops: dict[int, set[int]] = defaultdict(set)
        group_ops: dict[int, set[int]] = defaultdict(set)
        for op_idx, op in enumerate(prog.ops):
            uses, reshard = [], []
            infos = []
            for slot, vid in enumerate(op.operands):
                usite = self.use_site.get((op_idx, slot))
                if usite is None:
                    uses.append(None)
                    reshard.append(None)
                    continue
                uinfo = self._site_info(usite)
                uses.append(uinfo)
                infos.append(uinfo)
                dsite = self.nda.def_site.get(vid)
                if dsite is None or len(dsite.dims) != len(usite.dims):
                    reshard.append(None)
                else:
                    dinfo = self._site_info(dsite)
                    reshard.append(dinfo)
                    infos.append(dinfo)
            outs = []
            for r in op.results:
                oinfo = self._site_info(self.nda.def_site[r])
                outs.append(oinfo)
                infos.append(oinfo)
            self._op_specs.append((
                op, prog.trip_counts.get(op_idx, 1), uses, reshard, outs,
                tuple(prog.types[v].nbytes for v in op.operands),
                tuple(prog.types[r].nbytes for r in op.results)))
            for colors, groups, _ in infos:
                for c in colors:
                    color_ops[c].add(op_idx)
                for g in groups:
                    group_ops[g].add(op_idx)
        self._color_ops = {c: frozenset(s) for c, s in color_ops.items()}
        self._group_ops = {g: frozenset(s) for g, s in group_ops.items()}

        # fused kernel sites: op index -> registry spec (priced by the
        # per-kernel roofline in _kernel_row instead of the generic one)
        self._kernel_specs = {
            i: spec for i, op in enumerate(prog.ops)
            if (spec := kernel_registry.spec_for_prim(op.prim)) is not None}

        # supergroup index -> groups whose suppression its bit can flip
        self._sg_groups: list[frozenset[int]] = []
        for sg in self.analysis.supergroups:
            gs: set[int] = set()
            for sid in sg:
                cs = self.analysis.compat_sets[sid]
                for c in cs.conflicts:
                    s0, s1 = cs.sides[c.cid]
                    gs.add(s0)
                    gs.add(s1)
            self._sg_groups.append(frozenset(gs))

        # live-range tables over inputs + op results (position p=0 is the
        # initial input set; p=i+1 is "after op i, before dead-operand
        # frees" — exactly where the dense interpreter samples the peak).
        outputs = set(prog.outputs)
        vids: list[int] = list(prog.inputs)
        starts: list[int] = [0] * len(prog.inputs)
        for i, op in enumerate(prog.ops):
            for r in op.results:
                vids.append(r)
                starts.append(i + 1)
        ends = [n_ops if (v in outputs or v not in self.last_use)
                else self.last_use[v] + 1 for v in vids]
        self._live_vids = vids
        self._vid_slot = {v: k for k, v in enumerate(vids)}
        self._live_start = np.asarray(starts, dtype=np.int64)
        self._live_end = np.asarray(ends, dtype=np.int64)
        self._val_info = {v: self._site_info(self.nda.def_site[v])
                          for v in vids}
        color_vals: dict[int, set[int]] = defaultdict(set)
        group_vals: dict[int, set[int]] = defaultdict(set)
        for v, (colors, groups, _) in self._val_info.items():
            for c in colors:
                color_vals[c].add(v)
            for g in groups:
                group_vals[g].add(v)
        self._color_vals = {c: frozenset(s) for c, s in color_vals.items()}
        self._group_vals = {g: frozenset(s) for g, s in group_vals.items()}

        self._base_val_bytes = np.asarray(
            [float(prog.types[v].nbytes) for v in vids])
        self._base_delta = np.zeros(n_ops + 2)
        np.add.at(self._base_delta, self._live_start, self._base_val_bytes)
        np.add.at(self._base_delta, self._live_end + 1,
                  -self._base_val_bytes)
        self._base_peak = float(
            self._base_delta.cumsum()[:n_ops + 1].max()) if vids else 0.0

    def _build_base_rows(self) -> None:
        """Unsharded per-op cost rows and their totals (hardware-dependent
        — rebuilt by ``with_hardware``; everything else is shared)."""
        self.base_rows = [self.op_cost_row(i, {}, _EMPTY)
                          for i in range(len(self.prog.ops))]
        totals = [0.0] * _ROW_FIELDS
        for row in self.base_rows:
            for k in range(_ROW_FIELDS):
                totals[k] += row[k]
        self._base_totals = tuple(totals)

    # -- sharding resolution ------------------------------------------------

    def _chosen_suppressed(self, bits: dict[int, int]):
        chosen: set[int] = set()
        suppressed: set[int] = set()
        for gi, sg in enumerate(self.analysis.supergroups):
            bit = bits.get(gi, 0)
            for sid in sg:
                cs = self.analysis.compat_sets[sid]
                for c in cs.conflicts:
                    s0, s1 = cs.sides[c.cid]
                    chosen.add(s1 if bit else s0)
                    suppressed.add(s0 if bit else s1)
        return chosen, suppressed - chosen

    def suppressed_for(self, bits) -> frozenset:
        """Memoized suppressed-group set for a bits assignment (dict or the
        canonical ``ShardingState.bits`` tuple)."""
        key = tuple(sorted(bits.items())) if isinstance(bits, dict) \
            else tuple(bits)
        hit = self._suppressed_cache.get(key)
        if hit is None:
            _, sup = self._chosen_suppressed(dict(key))
            hit = frozenset(sup)
            self._suppressed_cache[key] = hit
        return hit

    def site_axes(self, site, color_axes: dict, suppressed: set[int]
                  ) -> list[tuple[str, ...]]:
        """Mesh axes sharding each dim of a site, conflict-resolved and
        validated (an axis shards at most one dim; divisibility holds)."""
        return self._site_axes_info(self._site_info(site), color_axes,
                                    suppressed)

    def _site_axes_info(self, info, color_axes: dict, suppressed
                        ) -> list[tuple[str, ...]]:
        colors, groups, sizes = info
        out: list[tuple[str, ...]] = []
        seen_axes: set[str] = set()
        for color, grp, size in zip(colors, groups, sizes):
            axes = color_axes.get(color, ())
            if not axes or grp in suppressed:
                out.append(())
                continue
            ok: list[str] = []
            for a in axes:
                f = self._axis_size.get(a)
                if f is None:
                    # a hand-built state / ConstraintSet can carry a typo'd
                    # axis that compile_constraints never saw — fail with
                    # the valid names instead of a bare KeyError
                    raise ValueError(
                        f"sharding state uses unknown mesh axis {a!r}; "
                        f"valid axes: {tuple(self.mesh.axes)}")
                if a in seen_axes or size % f != 0 or size < f:
                    continue
                ok.append(a)
                seen_axes.add(a)
                size //= f
            out.append(tuple(ok))
        return out

    def _factor(self, axes_per_dim) -> int:
        f = 1
        for axes in axes_per_dim:
            for a in axes:
                f *= self._axis_size[a]
        return f

    def _axis_bw(self, axis: str) -> float:
        bw = self._axis_bw_map.get(axis)
        if bw is not None:
            return bw
        return (self.hw.dcn_bw if axis in self.mesh.dcn_axes
                else self.hw.ici_bw)

    def _collective(self, kind: str, full_bytes: float, axes,
                    trip: int = 1) -> float:
        """Time for a collective over the given mesh axes (``trip`` times).

        Each axis contributes a bandwidth term (the standard ring
        coefficients on the *effective* bytes) plus ``hw.coll_latency``
        per collective launch.  When a feature tally is installed
        (``state_features``) the per-axis effective bytes and launch
        counts are recorded — the linear features calibration fits
        bandwidths and latency against.
        """
        t = 0.0
        for a in axes:
            n = self._axis_size[a]
            if n <= 1:
                continue
            if kind == "all_reduce":
                eff = 2.0 * (n - 1) / n * full_bytes
            elif kind in ("all_gather", "reduce_scatter"):
                eff = (n - 1) / n * full_bytes
            elif kind == "all_to_all":
                eff = (n - 1) / (n * n) * full_bytes
            else:
                continue
            t += (eff / self._axis_bw(a) + self.hw.coll_latency) * trip
            if self._tally is not None:
                self._tally["coll_bytes"][a] = \
                    self._tally["coll_bytes"].get(a, 0.0) + eff * trip
                self._tally["coll_count"] += trip
        return t

    # -- per-op / per-value costing ------------------------------------------

    def _resolve(self, info, color_axes: dict, suppressed, memo: dict):
        """Memoized :meth:`_site_axes_info`: ``memo`` maps ``id(info)`` to
        the resolved axes, valid for one ``(color_axes, suppressed)``
        pair (sites are interned by :meth:`_site_info`, so every op that
        touches the same def site shares one resolution per batch)."""
        key = id(info)
        hit = memo.get(key)
        if hit is None:
            for c in info[0]:
                if c in color_axes:
                    hit = self._site_axes_info(info, color_axes, suppressed)
                    break
            else:
                # no dim of this site carries an assigned color: the
                # resolution is trivially all-replicated
                hit = [()] * len(info[0])
            memo[key] = hit
        return hit

    def op_cost_row(self, op_idx: int, color_axes: dict, suppressed,
                    kernel_impls: dict | None = None
                    ) -> tuple[float, float, float, float, float]:
        """Contribution of one op to the breakdown totals under a sharding:
        (compute_time, memory_time, collective_time, flops, comm_bytes)."""
        return self._op_row(op_idx, color_axes, suppressed, {}, kernel_impls)

    def _op_row(self, op_idx: int, color_axes: dict, suppressed,
                memo: dict, kernel_impls: dict | None = None
                ) -> tuple[float, float, float, float, float]:
        kspec = self._kernel_specs.get(op_idx)
        if kspec is not None:
            return self._kernel_row(op_idx, kspec, color_axes, suppressed,
                                    memo, kernel_impls)
        op, trip, uses, reshard, outs, opnb, resnb = self._op_specs[op_idx]
        # resolve every site first (shared memo); ops all of whose sites
        # resolve to no axes cost exactly their unsharded base row
        sharded = False
        use_axes = []
        def_axes = []
        for slot in range(len(op.operands)):
            uinfo = uses[slot]
            if uinfo is None:
                use_axes.append(())
                def_axes.append(None)
                continue
            ua = self._resolve(uinfo, color_axes, suppressed, memo)
            use_axes.append(ua)
            sharded = sharded or any(ua)
            dinfo = reshard[slot]
            if dinfo is None:
                def_axes.append(None)
            else:
                da = self._resolve(dinfo, color_axes, suppressed, memo)
                def_axes.append(da)
                sharded = sharded or any(da)
        out_axes = []
        for oinfo in outs:
            oa = self._resolve(oinfo, color_axes, suppressed, memo)
            out_axes.append(oa)
            sharded = sharded or any(oa)
        base = getattr(self, "base_rows", None)
        if not sharded and base is not None:
            return base[op_idx]
        coll = 0.0
        comm = 0.0
        for slot, vid in enumerate(op.operands):
            da = def_axes[slot]
            if da is None:
                continue
            t, b = self._reshard_cost(vid, da, use_axes[slot], trip)
            coll += t
            comm += b
        flops, contract_axes = self._op_flops(op, use_axes, out_axes)
        bytes_moved = sum(nb / self._factor(a)
                          for nb, a in zip(opnb, use_axes)) + \
            sum(nb / self._factor(a) for nb, a in zip(resnb, out_axes))
        t_comp = flops / self.hw.flops_per_chip
        t_mem = bytes_moved / self.hw.hbm_bw
        if contract_axes:
            out_local = sum(nb / self._factor(a)
                            for nb, a in zip(resnb, out_axes))
            coll += self._collective("all_reduce", out_local,
                                     contract_axes, trip)
            comm += out_local * 2 * trip
        return (max(t_comp, t_mem) * trip, t_mem * trip, coll,
                flops * trip, comm)

    def _kernel_rate(self, kernel: str, impl: str) -> float:
        """Effective FLOP/s for one fused kernel implementation.

        Calibrated rates (``HardwareSpec.kernel_rates``) take
        precedence; uncalibrated sites price at the card's peak like
        every other op.
        """
        return self._kernel_rates_map.get(f"{kernel}:{impl}",
                                          self.hw.flops_per_chip)

    def _kernel_row(self, op_idx: int, spec, color_axes: dict, suppressed,
                    memo: dict, kernel_impls: dict | None
                    ) -> tuple[float, float, float, float, float]:
        """Cost row of one fused kernel site (per-kernel roofline).

        FLOPs and HBM bytes come from the registry's per-impl formulas
        over the *local* role sizes: mesh axes on mappable roles divide
        the role (the site lowers to a ``shard_map`` over them); axes on
        blocked roles cannot enter the kernel, so the executor gathers
        those operands first — priced here as an all_gather and a
        full-size role.  A CUDA choice the kernel cannot take on the
        local shapes (``registry.KernelSpec.feasible``) is priced as the
        reference impl.
        """
        op, trip, uses, reshard, outs, opnb, resnb = self._op_specs[op_idx]
        impl = (kernel_impls or {}).get(op_idx, spec.default_impl)
        sharded = False
        use_axes: list = []
        def_axes: list = []
        for slot in range(len(op.operands)):
            uinfo = uses[slot]
            if uinfo is None:
                use_axes.append(())
                def_axes.append(None)
                continue
            ua = self._resolve(uinfo, color_axes, suppressed, memo)
            use_axes.append(ua)
            sharded = sharded or any(ua)
            dinfo = reshard[slot]
            if dinfo is None:
                def_axes.append(None)
            else:
                da = self._resolve(dinfo, color_axes, suppressed, memo)
                def_axes.append(da)
                sharded = sharded or any(da)
        base = getattr(self, "base_rows", None)
        if not sharded and impl == spec.default_impl and base is not None:
            return base[op_idx]
        coll = 0.0
        comm = 0.0
        for slot, vid in enumerate(op.operands):
            da = def_axes[slot]
            if da is None:
                continue
            t, b = self._reshard_cost(vid, da, use_axes[slot], trip)
            coll += t
            comm += b
        # local role sizes + blocked-role gathers
        dims: dict = {}
        for slot, (roles, vid) in enumerate(zip(spec.operand_roles,
                                                op.operands)):
            shape = self.prog.types[vid].shape
            ua = use_axes[slot]
            blocked_axes: list[str] = []
            map_factor = 1
            for d, role in enumerate(roles):
                axes = ua[d] if d < len(ua) else ()
                f = 1
                for a in axes:
                    f *= self._axis_size[a]
                if role in spec.blocked and axes:
                    blocked_axes.extend(axes)
                    dims.setdefault(role, int(shape[d]))
                else:
                    map_factor *= f
                    dims.setdefault(role, int(shape[d]) // f)
            if blocked_axes:
                within = opnb[slot] / map_factor
                coll += self._collective("all_gather", within,
                                         blocked_axes, trip)
                comm += within * trip
        if impl == "cuda" and not spec.feasible("cuda", dims):
            impl = "ref"
        t0 = self.prog.types[op.operands[0]]
        db = t0.nbytes // max(t0.size, 1)
        flops = spec.flops(dims, op.params)
        bytes_moved = spec.bytes_moved(impl, dims, op.params, db)
        t_comp = flops / self._kernel_rate(spec.name, impl)
        t_mem = bytes_moved / self.hw.hbm_bw
        return (max(t_comp, t_mem) * trip, t_mem * trip, coll,
                flops * trip, comm)

    def value_local_bytes(self, vid: int, color_axes: dict,
                          suppressed) -> float:
        return self._value_bytes(vid, color_axes, suppressed, {})

    def _value_bytes(self, vid: int, color_axes: dict, suppressed,
                     memo: dict) -> float:
        info = self._val_info.get(vid)
        if info is None:
            info = self._site_info(self.nda.def_site[vid])
        axes = self._resolve(info, color_axes, suppressed, memo)
        return self.prog.types[vid].nbytes / self._factor(axes)

    def recost(self, op_indices, vids, color_axes: dict, suppressed,
               kernel_impls: dict | None = None
               ) -> tuple[dict[int, tuple], dict[int, float]]:
        """Batched re-costing of dirty ops and values under one sharding.

        One site-axes resolution memo is shared across the whole batch:
        every def/use site is conflict-resolved at most once per call
        instead of once per op that touches it, which is where the
        incremental evaluator spent most of its time on thousand-op
        programs (a single action dirties ~80 rows that share a handful
        of colors).

        Args:
            op_indices: op indices to re-cost (the dirty-op set).
            vids: value ids to re-measure local bytes for.
            color_axes: color -> mesh-axes assignment of the state.
            suppressed: suppressed group set (``suppressed_for``).
            kernel_impls: op index -> fused-kernel impl decisions of the
                state (``None`` = registry defaults everywhere).

        Returns:
            ``({op_idx: cost row}, {vid: local bytes})`` over exactly the
            requested indices (rows equal to base are *not* filtered).
        """
        memo: dict = {}
        rows = {i: self._op_row(i, color_axes, suppressed, memo,
                                kernel_impls)
                for i in op_indices}
        vbytes = {v: self._value_bytes(v, color_axes, suppressed, memo)
                  for v in vids}
        return rows, vbytes

    def peak_with_overrides(self, vbytes: dict[int, float]) -> float:
        """Peak live bytes for a state given only the values whose local
        bytes differ from the unsharded base (vectorized live ranges)."""
        if not vbytes:
            return self._base_peak
        delta = self._base_delta.copy()
        start, end = self._live_start, self._live_end
        slot = self._vid_slot
        base = self._base_val_bytes
        for vid, nb in vbytes.items():
            k = slot[vid]
            db = nb - base[k]
            delta[start[k]] += db
            delta[end[k] + 1] -= db
        return float(delta.cumsum()[:len(self.prog.ops) + 1].max())

    # -- dirty-set computation ----------------------------------------------

    def dirty_sets(self, colors, supergroups
                   ) -> tuple[frozenset[int], frozenset[int]]:
        """(op indices, value ids) whose cost can change when the given
        colors gain an axis / the given supergroup bits flip from default."""
        ops: set[int] = set()
        vals: set[int] = set()
        for c in colors:
            ops |= self._color_ops.get(c, _EMPTY)
            vals |= self._color_vals.get(c, _EMPTY)
        for gi in supergroups:
            for g in self._sg_groups[gi]:
                ops |= self._group_ops.get(g, _EMPTY)
                vals |= self._group_vals.get(g, _EMPTY)
        return frozenset(ops), frozenset(vals)

    def state_dirty_sets(self, state: ShardingState):
        """Dirty sets of a whole state relative to the unsharded base.
        Bits still at their default (0) change nothing vs. base."""
        ops, vals = self.dirty_sets((c for c, _ in state.color_axes),
                                    (sg for sg, b in state.bits if b))
        if state.kernel_impls:
            ops = frozenset(ops | {i for i, _ in state.kernel_impls})
        return ops, vals

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, state: ShardingState) -> CostBreakdown:
        bd = self._cache.get(state)
        if bd is None:
            bd, _, _, _ = self.evaluate_with_diff(state)
            self._cache[state] = bd
        return bd

    def evaluate_with_diff(self, state: ShardingState
                           ) -> tuple[CostBreakdown, dict, dict, int]:
        """Diff-from-base evaluation: re-cost only ops/values touched by the
        state.  Returns (breakdown, {op: row != base}, {vid: bytes != base},
        number of rows re-costed) — the record the incremental evaluator
        chains from."""
        color_axes, _ = state.as_dicts()
        suppressed = self.suppressed_for(state.bits)
        dirty_ops, dirty_vals = self.state_dirty_sets(state)
        totals = list(self._base_totals)
        new_rows, new_vbytes = self.recost(dirty_ops, dirty_vals,
                                           color_axes, suppressed,
                                           dict(state.kernel_impls))
        rows: dict[int, tuple] = {}
        for i, new in new_rows.items():
            old = self.base_rows[i]
            if new is not old and new != old:
                rows[i] = new
                for k in range(_ROW_FIELDS):
                    totals[k] += new[k] - old[k]
        vbytes: dict[int, float] = {}
        base = self._base_val_bytes
        slot = self._vid_slot
        for vid, nb in new_vbytes.items():
            if nb != base[slot[vid]]:
                vbytes[vid] = nb
        peak = self.peak_with_overrides(vbytes)
        bd = CostBreakdown(totals[0], totals[1], totals[2], peak,
                           totals[3], totals[4])
        return bd, rows, vbytes, len(dirty_ops)

    def evaluate_dense(self, state: ShardingState) -> CostBreakdown:
        """The original exhaustive abstract interpretation — every op
        re-costed, python live-set walk.  Kept as the exactness oracle for
        the incremental engine and as the seed-path benchmark baseline.
        Deliberately uncached."""
        color_axes, bits = state.as_dicts()
        _, suppressed = self._chosen_suppressed(bits)
        kernel_impls = dict(state.kernel_impls)
        bd = CostBreakdown()
        live: dict[int, float] = {}

        def local_bytes(vid: int, axes_per_dim) -> float:
            return self.prog.types[vid].nbytes / self._factor(axes_per_dim)

        # program inputs live from the start
        for vid in self.prog.inputs:
            site = self.nda.def_site[vid]
            axes = self.site_axes(site, color_axes, suppressed)
            live[vid] = local_bytes(vid, axes)
        peak = sum(live.values())

        for op_idx, op in enumerate(self.prog.ops):
            trip = self.prog.trip_counts.get(op_idx, 1)
            if op_idx in self._kernel_specs:
                # fused kernel site: per-kernel roofline (shared with the
                # sparse path), then the generic live-range update
                row = self._kernel_row(op_idx, self._kernel_specs[op_idx],
                                       color_axes, suppressed, {},
                                       kernel_impls)
                bd.compute_time += row[0]
                bd.memory_time += row[1]
                bd.collective_time += row[2]
                bd.flops += row[3]
                bd.comm_bytes += row[4]
                for r in op.results:
                    rsite = self.nda.def_site[r]
                    live[r] = local_bytes(
                        r, self.site_axes(rsite, color_axes, suppressed))
                peak = max(peak, sum(live.values()))
                for vid in op.operands:
                    if self.last_use.get(vid) == op_idx and \
                            vid not in self.prog.outputs:
                        live.pop(vid, None)
                continue
            use_axes = []
            # 1. resharding between def and use
            for slot, vid in enumerate(op.operands):
                usite = self.use_site.get((op_idx, slot))
                if usite is None:
                    use_axes.append(())
                    continue
                ua = self.site_axes(usite, color_axes, suppressed)
                use_axes.append(ua)
                dsite = self.nda.def_site.get(vid)
                if dsite is None or len(dsite.dims) != len(usite.dims):
                    continue
                da = self.site_axes(dsite, color_axes, suppressed)
                t, b = self._reshard_cost(vid, da, ua, trip)
                bd.collective_time += t
                bd.comm_bytes += b

            # 2. compute + memory roofline
            out_axes = []
            for r in op.results:
                rsite = self.nda.def_site[r]
                out_axes.append(self.site_axes(rsite, color_axes, suppressed))
            flops, contract_axes = self._op_flops(op, use_axes, out_axes)
            bytes_moved = sum(local_bytes(v, a)
                              for v, a in zip(op.operands, use_axes)) + \
                sum(local_bytes(r, a) for r, a in zip(op.results, out_axes))
            t_comp = flops / self.hw.flops_per_chip
            t_mem = bytes_moved / self.hw.hbm_bw
            bd.compute_time += max(t_comp, t_mem) * trip
            bd.memory_time += t_mem * trip
            bd.flops += flops * trip

            # 3. partial-reduction all_reduce (contracting dim sharded)
            if contract_axes:
                out_local = sum(local_bytes(r, a)
                                for r, a in zip(op.results, out_axes))
                t = self._collective("all_reduce", out_local, contract_axes,
                                     trip)
                bd.collective_time += t
                bd.comm_bytes += out_local * 2 * trip

            # 4. live-range memory
            for r, a in zip(op.results, out_axes):
                live[r] = local_bytes(r, a)
            peak = max(peak, sum(live.values()))
            for slot, vid in enumerate(op.operands):
                if self.last_use.get(vid) == op_idx and \
                        vid not in self.prog.outputs:
                    live.pop(vid, None)

        bd.peak_bytes = peak
        return bd

    def _reshard_cost(self, vid: int, da, ua, trip: int):
        """Cost of converting def-sharding to use-sharding."""
        t = 0.0
        b = 0.0
        nbytes = self.prog.types[vid].nbytes
        gathered, scattered = [], []
        for i, (d_ax, u_ax) in enumerate(zip(da, ua)):
            for a in d_ax:
                if a not in u_ax:
                    gathered.append(a)
            for a in u_ax:
                if a not in d_ax:
                    scattered.append(a)
        if not gathered:
            return 0.0, 0.0    # refining replication to sharding is local
        moved = set(gathered) & set(scattered)
        for a in moved:        # axis moved between dims -> all_to_all
            local = nbytes / self._factor(da)
            t += self._collective("all_to_all", local, [a], trip)
            b += local / self._axis_size[a]
            gathered.remove(a)
        if gathered:           # remaining: all_gather
            within = nbytes / self._factor(
                [tuple(a for a in ax if a not in gathered) for ax in da])
            t += self._collective("all_gather", within, gathered, trip)
            b += within
        return t, b * trip

    def _op_flops(self, op, use_axes, out_axes):
        """Local FLOPs of the op and the axes sharding contracting dims."""
        if op.prim == "dot_general":
            (lc, rc), (lb, rb) = op.params["dimension_numbers"]
            lhs_t = self.prog.types[op.operands[0]]
            out_sz = self.prog.types[op.results[0]].size
            k = 1
            for i in lc:
                k *= lhs_t.shape[i]
            full = 2.0 * out_sz * k
            factor = self._factor(out_axes[0]) if out_axes else 1
            contract_axes = []
            if use_axes and use_axes[0]:
                for i in lc:
                    if i < len(use_axes[0]):
                        for a in use_axes[0][i]:
                            contract_axes.append(a)
                            factor *= self._axis_size[a]
            return full / factor, contract_axes
        if op.prim == "conv_general_dilated":
            out_t = self.prog.types[op.results[0]]
            rhs_t = self.prog.types[op.operands[1]]
            full = 2.0 * out_t.size * rhs_t.size / max(
                1, rhs_t.shape[0] if rhs_t.shape else 1)
            factor = self._factor(out_axes[0]) if out_axes else 1
            return full / factor, []
        # reductions with sharded reduced dims need an all_reduce
        contract_axes = []
        if op.prim.startswith("reduce_") or op.prim in ("argmax", "argmin"):
            axes_param = op.params.get("axes", ())
            if use_axes and use_axes[0]:
                for i in axes_param:
                    if i < len(use_axes[0]):
                        contract_axes.extend(use_axes[0][i])
        out_sz = sum(self.prog.types[r].size for r in op.results)
        factor = self._factor(out_axes[0]) if out_axes else 1
        return out_sz / factor, contract_axes

    # -- paper cost ----------------------------------------------------------

    def baseline(self) -> CostBreakdown:
        if self._baseline is None:
            self._baseline = self.evaluate(ShardingState())
        return self._baseline

    def cost_from_breakdown(self, bd: CostBreakdown) -> float:
        """C(s) = RT(s) + MP(s) — paper §4.5 — from a breakdown."""
        base = self.baseline()
        rt = bd.runtime / max(base.runtime, 1e-12)
        dm = self.hw.hbm_per_chip
        if bd.peak_bytes > dm:
            mp = self.hw.mem_penalty_scale * \
                (bd.peak_bytes - dm) / max(base.peak_bytes, 1e-12)
        else:
            mp = 0.0
        return rt + mp

    def paper_cost(self, state: ShardingState) -> float:
        """C(s) = RT(s) + MP(s) — paper §4.5."""
        return self.cost_from_breakdown(self.evaluate(state))

    def ops_touching_color(self, color: int) -> int:
        """How many program ops carry a cost-row dependency on ``color``.

        A static (mesh- and hardware-independent) quantity from the
        ``_color_ops`` table: the ops whose cost rows must be re-priced
        when the color's sharding changes.  The guidance featurizer uses
        it as a program-scale-free "how much of the program does this
        color span" action feature (``repro_torch.guidance.features``).

        Args:
            color: NDA color id.

        Returns:
            The op count (0 for unknown colors).
        """
        return len(self._color_ops.get(color, _EMPTY))

    # -- calibration features ------------------------------------------------

    def state_features(self, state: ShardingState) -> dict:
        """Linear calibration features of one sharding state.

        One dense evaluation with the per-axis collective tally
        installed.  The returned terms are *hardware-independent work
        quantities* — ``repro_torch.core.measure.calibrate_hardware`` fits the
        roofline coefficients so that::

            t ≈ flops/F + hbm_bytes/B + Σ_axis coll_bytes[a]/bw[a]
                + coll_count · latency

        matches measured wall time in the least-squares sense.

        Args:
            state: canonical sharding state to featurize.

        Returns:
            ``{"flops", "hbm_bytes", "coll_bytes": {axis: effective
            bytes}, "coll_count", "runtime", "peak_bytes"}`` — the last
            two priced under this model's current hardware.
        """
        tally = {"coll_bytes": {}, "coll_count": 0.0}
        self._tally = tally
        try:
            bd = self.evaluate_dense(state)
        finally:
            self._tally = None
        return {
            "flops": bd.flops,
            "hbm_bytes": bd.memory_time * self.hw.hbm_bw,
            "coll_bytes": tally["coll_bytes"],
            "coll_count": tally["coll_count"],
            "runtime": bd.runtime,
            "peak_bytes": bd.peak_bytes,
        }
