"""Action space construction (paper §4.2).

Actions are tuples ``dim_name × resolution_order × axis`` — here
``(color, axis, bit_choices)`` where ``bit_choices`` fixes the resolution
bit of each conflict supergroup the color touches.  The space is built once
ahead of search; trivial actions (fewer than ``min_dims`` unique dims, the
paper uses 10) are pruned; actions invalidated by the current sharding
state (axis already consumed, color already sharded on that axis) are
filtered during search.

Programs traced with fused kernel sites (``kernel:*`` ops) extend the
space in two ways:

- colors touching a kernel's *blocked* roles (the softmax contraction,
  the recurrence axis, the head_dim — consumed inside the kernel)
  get no sharding actions, so search never proposes a partitioning the
  fused kernel cannot execute;
- each kernel site with more than one implementation contributes
  **kernel-impl actions** (``kernel_op``/``kernel_impl`` set, color
  ``-1``) — the joint sharding + kernel-implementation search the cost
  model prices via ``ShardingState.kernel_impls``.
"""

from __future__ import annotations

import dataclasses
import itertools

from repro_torch.core.conflicts import ConflictAnalysis
from repro_torch.core.cost_model import MeshSpec, ShardingState
from repro_torch.core.nda import NDAResult
from repro_torch.kernels import registry as kernel_registry

# the paper's action-space pruning default; shared by the API layer
# (Request / auto_partition) and the plan-store key canonicalization so
# the cache key's default can never drift from the search's
DEFAULT_MIN_DIMS = 10


@dataclasses.dataclass(frozen=True)
class Action:
    color: int
    axis: str
    bit_choices: tuple[tuple[int, int], ...] = ()
    # fused-kernel implementation decision (kernel_op >= 0): pick
    # ``kernel_impl`` for the kernel site at program op ``kernel_op``
    kernel_op: int = -1
    kernel_impl: str = ""

    def apply(self, state: ShardingState) -> ShardingState:
        if self.kernel_op >= 0:
            return state.with_kernel_impl(self.kernel_op, self.kernel_impl)
        return state.with_action(self.color, self.axis, self.bit_choices)

    @property
    def is_stop(self) -> bool:
        return self.color < 0 and self.kernel_op < 0


STOP = Action(color=-1, axis="", bit_choices=())


def kernel_blocked_colors(nda: NDAResult) -> frozenset[int]:
    """Colors carrying a blocked role of any fused kernel site.

    These dims are consumed *inside* the kernel (contractions, the scan
    axis); sharding their color would make the fused site unexecutable,
    so the action space excludes them entirely.
    """
    blocked: set[int] = set()
    for op in nda.prog.ops:
        spec = kernel_registry.spec_for_prim(op.prim)
        if spec is None:
            continue
        for roles, vid in zip(spec.operand_roles, op.operands):
            dims = nda.def_site[vid].dims
            for d, role in enumerate(roles):
                if role in spec.blocked and d < len(dims):
                    blocked.add(int(nda.colors_arr[dims[d]]))
    return frozenset(blocked)


def kernel_impl_actions(nda: NDAResult) -> list[Action]:
    """One action per (multi-impl kernel site, non-default impl).

    Applying one records the implementation decision for that site in
    ``ShardingState.kernel_impls``; sites left undecided price and
    execute at the registry's preferred impl.
    """
    actions: list[Action] = []
    for op_idx, op in enumerate(nda.prog.ops):
        spec = kernel_registry.spec_for_prim(op.prim)
        if spec is None or len(spec.impls) < 2:
            continue
        for impl in spec.impls[1:]:
            actions.append(Action(color=-1, axis="", bit_choices=(),
                                  kernel_op=op_idx, kernel_impl=impl))
    return actions


def build_action_space(nda: NDAResult, analysis: ConflictAnalysis,
                       mesh: MeshSpec, *, min_dims: int = DEFAULT_MIN_DIMS,
                       max_bits_per_action: int = 2) -> list[Action]:
    summary = nda.color_summary()
    blocked_colors = kernel_blocked_colors(nda)
    actions: list[Action] = kernel_impl_actions(nda)
    for color, occ in summary.items():
        if len(occ) < min_dims or color in blocked_colors:
            continue
        sgs = analysis.color_supergroups.get(color, [])[:max_bits_per_action]
        bit_sets: list[tuple[tuple[int, int], ...]]
        if sgs:
            bit_sets = [tuple(zip(sgs, combo))
                        for combo in itertools.product((0, 1), repeat=len(sgs))]
        else:
            bit_sets = [()]
        for axis, size in zip(mesh.axes, mesh.sizes):
            if size <= 1:
                continue
            # at least one occurrence must be divisible by the axis size
            if not any(_dim_size(nda, vid, d) % size == 0 and
                       _dim_size(nda, vid, d) >= size for vid, d in occ):
                continue
            for bits in bit_sets:
                actions.append(Action(color, axis, bits))
    return actions


def _dim_size(nda: NDAResult, vid: int, dim: int) -> int:
    return nda.prog.types[vid].shape[dim]


def valid_actions(actions: list[Action], state: ShardingState) -> list[Action]:
    """Filter actions invalidated by the current sharding state (§4.2
    step 2).  An axis may shard *different* colors — they usually live in
    different tensors (Megatron puts hidden/heads/vocab all on one axis);
    per-tensor clashes are rejected by the cost model's site validation."""
    ca, bits = state.as_dicts()
    decided = dict(state.kernel_impls)
    out = []
    bits_get = bits.get
    for a in actions:
        if a.kernel_op >= 0:
            if a.kernel_op not in decided:   # one decision per site
                out.append(a)
            continue
        if a.axis in ca.get(a.color, ()):
            continue                      # duplicate (color, axis)
        # resolution bits already fixed differently -> invalid duplicate
        if a.bit_choices and any(bits_get(sg, b) != b
                                 for sg, b in a.bit_choices):
            continue
        out.append(a)
    return out
