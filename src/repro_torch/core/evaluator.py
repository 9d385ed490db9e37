"""Incremental cost-evaluation engine (paper §5.3 "fast and scalable").

The search evaluates thousands of sharding states, but consecutive states
differ by exactly one action: one color gains one mesh axis, and at most a
couple of resolution bits get fixed.  ``IncrementalEvaluator`` exploits
that: for a child state it re-costs only the ops whose operand/result
sites carry the action's color (or a group whose suppression a newly-set
bit can flip), re-uses the parent's per-op cost rows for everything else,
and recomputes peak memory from vectorized live-interval tables.

Three layers of reuse, cheapest first:

1. **Transposition cache** — canonical ``ShardingState`` → ``CostBreakdown``
   (MCTS revisits tree prefixes constantly; these become dict hits).
2. **Parent-diff** — re-cost only the action's dirty op/value sets on top
   of the parent's record.
3. **From-base fallback** — when no parent record exists, evaluate as a
   diff from the unsharded base (still prunes clean ops); exact by
   construction because both paths call the same ``CostModel.op_cost_row``.

``CostModel.evaluate_dense`` remains the exhaustive oracle; the property
tests in ``tests/test_evaluator.py`` assert the incremental path matches it
to 1e-9 relative on random action sequences.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

from repro_torch.core.actions import Action
from repro_torch.core.cost_model import (_ROW_FIELDS, CostBreakdown, CostModel,
                                   ShardingState)


@dataclasses.dataclass
class EvalStats:
    """Where evaluation work actually went (see module docstring layers)."""
    queries: int = 0             # paper_cost / evaluate calls
    cache_hits: int = 0          # answered from the transposition cache
    incremental_evals: int = 0   # parent-diff evaluations
    base_evals: int = 0          # from-base (no parent record) evaluations
    rows_recosted: int = 0       # op cost rows recomputed, all evals

    def as_dict(self) -> dict:
        """Plain-dict view (JSON-serializable)."""
        return dataclasses.asdict(self)


class _Record:
    """Per-state evaluation record: breakdown + diffs from the unsharded
    base (only ops/values whose cost differs are stored)."""
    __slots__ = ("rows", "vbytes", "breakdown")

    def __init__(self, rows: dict, vbytes: dict,
                 breakdown: CostBreakdown) -> None:
        self.rows = rows
        self.vbytes = vbytes
        self.breakdown = breakdown


class IncrementalEvaluator:
    """Evaluation façade the search backends run against.

    ``max_records`` bounds the LRU store of diff records (each holds the
    per-op rows of one state); ``max_cache`` bounds the breakdown
    transposition cache the same way, so thousand-op searches that visit
    millions of states cannot grow memory without limit.  Eviction only
    costs a re-evaluation on a later revisit — exactness is unaffected
    (``tests/test_fullscale.py`` pins this against ``evaluate_dense``).

    ``constraints`` (a compiled ``repro_torch.core.constraints.ConstraintSet``)
    marks violating states infeasible: ``paper_cost`` /
    ``paper_cost_child`` add the set's penalty per violated pin/forbid,
    so even a backend that synthesizes states outside the pruned action
    space can never prefer a constraint-violating plan.  Breakdowns
    (``evaluate``) stay exact — the penalty is a search-cost concern.
    """

    def __init__(self, cost_model: CostModel, *,
                 max_records: int = 4096, max_cache: int = 262144,
                 constraints=None) -> None:
        self.cm = cost_model
        self.stats = EvalStats()
        self.constraints = constraints
        self._records: OrderedDict[ShardingState, _Record] = OrderedDict()
        self._bd: OrderedDict[ShardingState, CostBreakdown] = OrderedDict()
        self._max_records = max_records
        self._max_cache = max_cache

    # -- public API ----------------------------------------------------------

    def baseline(self) -> CostBreakdown:
        """Breakdown of the unsharded program (memoized in the model).

        Returns:
            The base :class:`CostBreakdown` every cost is relative to.
        """
        return self.cm.baseline()

    def evaluate(self, state: ShardingState) -> CostBreakdown:
        """Cost breakdown of an arbitrary state.

        Args:
            state: canonical sharding state to cost.

        Returns:
            The exact :class:`CostBreakdown` — from the transposition
            cache when seen before, else evaluated as a diff from the
            unsharded base.
        """
        self.stats.queries += 1
        bd = self._bd.get(state)
        if bd is not None:
            self.stats.cache_hits += 1
            self._bd.move_to_end(state)
            return bd
        return self._record_from_base(state).breakdown

    def child(self, parent: ShardingState, action: Action
              ) -> tuple[ShardingState, CostBreakdown]:
        """Apply ``action`` to ``parent`` and cost the child incrementally.

        This is the hot path of every search backend: only the action's
        dirty op/value sets are re-costed on top of the parent's record.

        Args:
            parent: the state the search is expanding.
            action: the single action to apply.

        Returns:
            ``(child_state, breakdown)`` — the canonical child state and
            its exact cost breakdown.
        """
        state = action.apply(parent)
        self.stats.queries += 1
        bd = self._bd.get(state)
        if bd is not None:
            self.stats.cache_hits += 1
            self._bd.move_to_end(state)
            return state, bd
        prec = self._records.get(parent)
        if prec is None:
            prec = self._record_from_base(parent)
            self.stats.queries += 1      # the implicit parent evaluation
        else:
            self._records.move_to_end(parent)
        return state, self._record_from_parent(prec, parent, action,
                                               state).breakdown

    def paper_cost(self, state: ShardingState) -> float:
        """Scalar paper cost ``C(s) = RT(s) + MP(s)`` of a state.

        Args:
            state: canonical sharding state to cost.

        Returns:
            Relative runtime plus memory penalty (1.0 == unsharded),
            plus the constraint-violation penalty when the evaluator
            carries a constraint set and ``state`` violates it.
        """
        cost = self.cm.cost_from_breakdown(self.evaluate(state))
        if self.constraints is not None:
            cost += self.constraints.penalty_for(state)
        return cost

    def paper_cost_child(self, parent: ShardingState, action: Action
                         ) -> tuple[ShardingState, float]:
        """:meth:`child` reduced to the scalar paper cost.

        Args:
            parent: the state the search is expanding.
            action: the single action to apply.

        Returns:
            ``(child_state, paper_cost)`` — the cost includes the
            constraint-violation penalty when one applies.
        """
        state, bd = self.child(parent, action)
        cost = self.cm.cost_from_breakdown(bd)
        if self.constraints is not None:
            cost += self.constraints.penalty_for(state)
        return state, cost

    # -- internals -----------------------------------------------------------

    def _store(self, state: ShardingState, rec: _Record) -> _Record:
        self._bd[state] = rec.breakdown
        self._bd.move_to_end(state)
        if len(self._bd) > self._max_cache:
            self._bd.popitem(last=False)
        self._records[state] = rec
        if len(self._records) > self._max_records:
            self._records.popitem(last=False)
        return rec

    def _record_from_base(self, state: ShardingState) -> _Record:
        bd, rows, vbytes, n_recosted = self.cm.evaluate_with_diff(state)
        self.stats.base_evals += 1
        self.stats.rows_recosted += n_recosted
        return self._store(state, _Record(rows, vbytes, bd))

    def _record_from_parent(self, prec: _Record, parent: ShardingState,
                            action: Action, state: ShardingState) -> _Record:
        cm = self.cm
        # dirty sets: the action's color, plus supergroups whose bit this
        # action newly sets to 1 (a bit still at the default 0 — or one the
        # parent already fixed — changes nothing).  A kernel-impl action
        # dirties exactly its one fused site (no value bytes change).
        if action.kernel_op >= 0:
            dirty_ops = frozenset((action.kernel_op,))
            dirty_vals: frozenset = frozenset()
        else:
            parent_bits = dict(parent.bits)
            new_sgs = [sg for sg, b in action.bit_choices
                       if b and sg not in parent_bits]
            dirty_ops, dirty_vals = cm.dirty_sets((action.color,), new_sgs)
        color_axes, _ = state.as_dicts()
        suppressed = cm.suppressed_for(state.bits)

        pbd = prec.breakdown
        totals = [pbd.compute_time, pbd.memory_time, pbd.collective_time,
                  pbd.flops, pbd.comm_bytes]
        new_rows, new_vbytes = cm.recost(dirty_ops, dirty_vals,
                                         color_axes, suppressed,
                                         dict(state.kernel_impls))
        rows = dict(prec.rows)
        base_rows = cm.base_rows
        for i, new in new_rows.items():
            old = rows.get(i, base_rows[i])
            if new is not old and new != old:
                for k in range(_ROW_FIELDS):
                    totals[k] += new[k] - old[k]
                if new == base_rows[i]:
                    rows.pop(i, None)
                else:
                    rows[i] = new
        self.stats.rows_recosted += len(dirty_ops)

        vbytes = dict(prec.vbytes)
        bytes_changed = False
        base_val = cm._base_val_bytes
        slot = cm._vid_slot
        for vid, nb in new_vbytes.items():
            old = vbytes.get(vid, base_val[slot[vid]])
            if nb != old:
                bytes_changed = True
                if nb == base_val[slot[vid]]:
                    vbytes.pop(vid, None)
                else:
                    vbytes[vid] = nb
        peak = pbd.peak_bytes if not bytes_changed \
            else cm.peak_with_overrides(vbytes)

        bd = CostBreakdown(totals[0], totals[1], totals[2], peak,
                           totals[3], totals[4])
        self.stats.incremental_evals += 1
        return self._store(state, _Record(rows, vbytes, bd))
