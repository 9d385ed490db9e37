"""Pluggable search core.

Search strategies are backends behind one interface::

    backend.search(evaluator, actions, config) -> SearchResult

where ``evaluator`` is an ``IncrementalEvaluator`` (transposition cache +
single-action child costing) and ``actions`` the pruned action space of
``repro_torch.core.actions``.  Backends never touch the cost model directly —
everything goes through ``evaluator.paper_cost`` / ``paper_cost_child`` so
every strategy benefits from incremental evaluation for free.

Built-in backends:

- ``"mcts"``   — the paper's Monte-Carlo Tree Search (§4.1–4.3), in
  ``repro_torch.core.mcts`` (imported lazily to avoid a module cycle).
- ``"beam"``   — deterministic beam search over the action DAG; a strong,
  cheap baseline and a regression anchor for MCTS.
- ``"greedy"`` — beam with width 1 (steepest-descent hill climb).
- ``"portfolio"`` — a concurrent portfolio of the above over several
  seeds/budgets with early stopping (``repro_torch.core.portfolio``).

Select with ``auto_partition(..., backend="beam")`` or register custom
backends via ``register_backend``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.actions import Action, valid_actions
from repro_torch.core.cost_model import ShardingState


@dataclasses.dataclass
class SearchResult:
    """What a search backend returns: the best state found and how.

    Attributes:
        best_state: cheapest canonical sharding state found.
        best_cost: its paper cost ``C(s) = RT(s) + MP(s)``.
        best_actions: one action sequence reaching ``best_state``.
        rounds_run: backend-defined progress unit (MCTS rounds, beam
            depths, portfolio members completed).
        evaluations: cost queries made, transposition-cache hits
            included.
        history: best-known cost after each round.
        curve: eval-indexed improvement curve — ``(evaluations,
            best_cost)`` appended every time the best-known cost drops
            (empty for backends that do not record it).  This is what
            "evals-to-match" guidance comparisons are computed from.
    """

    best_state: ShardingState
    best_cost: float
    best_actions: list[Action]
    rounds_run: int
    # cost queries the backend made, transposition-cache hits included
    # (uniform across backends; actual cost-model work — incremental vs
    # from-base evaluations — is in the evaluator's EvalStats).
    evaluations: int
    history: list[float]
    curve: list[tuple[int, float]] = dataclasses.field(
        default_factory=list)


class SearchBackend:
    """Interface every search strategy implements.

    A backend never touches the cost model directly: all costing goes
    through the evaluator so every strategy benefits from incremental
    evaluation and the transposition cache for free.  Instances must be
    safe to reuse across searches (hold no per-search state).
    """

    name = "backend"

    def search(self, evaluator, actions: list[Action], config=None,
               root: ShardingState = ShardingState()) -> SearchResult:
        """Search for a low-cost sharding state.

        Args:
            evaluator: ``repro_torch.core.evaluator.IncrementalEvaluator`` to
                cost states with (``paper_cost`` / ``paper_cost_child``).
            actions: the pruned action space from
                ``repro_torch.core.actions.build_action_space``.
            config: backend-specific configuration object; ``None`` means
                backend defaults.  Backends must raise ``TypeError`` on a
                config of the wrong type rather than ignore it.
            root: state the search starts from (default: unsharded).

        Returns:
            A :class:`SearchResult` for the best state found; the root
            itself when nothing improves on it.
        """
        raise NotImplementedError


def recover_actions(state: ShardingState) -> list[Action]:
    """Reconstruct one action sequence reaching a canonical state.

    Args:
        state: the canonical sharding state to explain.

    Returns:
        Actions whose in-order application to the empty state yields
        ``state`` (resolution bits attached to the first action).
    """
    ca, bits = state.as_dicts()
    out = []
    bit_items = tuple(sorted(bits.items()))
    first = True
    for color, axes in sorted(ca.items()):
        for axis in axes:
            out.append(Action(color, axis, bit_items if first else ()))
            first = False
    for op_idx, impl in state.kernel_impls:
        out.append(Action(color=-1, axis="", bit_choices=(),
                          kernel_op=op_idx, kernel_impl=impl))
    return out


@dataclasses.dataclass
class BeamConfig:
    """Beam-search knobs: frontier ``width``, ``max_depth`` action levels,
    and ``patience`` depth levels without improvement before stopping."""

    width: int = 8
    max_depth: int = 30
    patience: int = 2          # depth levels without improvement -> stop


class BeamSearchBackend(SearchBackend):
    """Deterministic beam search: expand every frontier state by every valid
    action, keep the ``width`` cheapest distinct states, stop after
    ``patience`` levels without improving the best-known cost."""

    def __init__(self, width: int | None = None, name: str = "beam") -> None:
        self._width = width
        self.name = name

    def search(self, evaluator, actions: list[Action], config=None,
               root: ShardingState = ShardingState()) -> SearchResult:
        """Run beam search.

        Args:
            evaluator: ``IncrementalEvaluator`` to cost states with.
            actions: pruned action space to expand over.
            config: a :class:`BeamConfig` or ``None`` for defaults.
            root: state the beam starts from.

        Returns:
            The :class:`SearchResult` of the cheapest state reached.
        """
        if config is not None and not isinstance(config, BeamConfig):
            raise TypeError(f"{self.name} backend expects BeamConfig, "
                            f"got {type(config).__name__}")
        cfg = config if config is not None else BeamConfig()
        if self._width is not None:
            cfg = dataclasses.replace(cfg, width=self._width)
        best_cost = evaluator.paper_cost(root)
        best_state = root
        evals = 1
        history = [best_cost]
        beam: list[tuple[float, ShardingState]] = [(best_cost, root)]
        stale = 0
        depth_run = 0
        for _ in range(cfg.max_depth):
            depth_run += 1
            candidates: dict[ShardingState, float] = {}
            for _, s in beam:
                for a in valid_actions(actions, s):
                    child, cost = evaluator.paper_cost_child(s, a)
                    evals += 1
                    prev = candidates.get(child)
                    if prev is None or cost < prev:
                        candidates[child] = cost
            if not candidates:
                break
            ranked = sorted(candidates.items(), key=lambda kv: kv[1])
            ranked = ranked[:cfg.width]
            beam = [(c, s) for s, c in ranked]
            improved = False
            for s, c in ranked:
                if c < best_cost - 1e-12:
                    best_cost, best_state, improved = c, s, True
            history.append(best_cost)
            if improved:
                stale = 0
            else:
                stale += 1
                if stale >= cfg.patience:
                    break
        return SearchResult(best_state, best_cost,
                            recover_actions(best_state), depth_run, evals,
                            history)


_REGISTRY: dict[str, Callable[[], SearchBackend]] = {}


def register_backend(name: str,
                     factory: Callable[[], SearchBackend]) -> None:
    """Register a search backend for name-based resolution.

    Args:
        name: backend name (matched case-insensitively by
            :func:`get_backend` / ``auto_partition(backend=...)``).
        factory: zero-arg callable producing a fresh backend instance.
    """
    _REGISTRY[name.lower()] = factory


def registered_backends() -> list[str]:
    """Sorted names of all registered search backends."""
    return sorted(_REGISTRY)


def _make_mcts() -> SearchBackend:
    from repro_torch.core.mcts import MCTSBackend    # lazy: avoids module cycle
    return MCTSBackend()


def _make_portfolio() -> SearchBackend:
    from repro_torch.core.portfolio import PortfolioBackend   # lazy: cycle
    return PortfolioBackend()


register_backend("mcts", _make_mcts)
register_backend("beam", BeamSearchBackend)
register_backend("greedy", lambda: BeamSearchBackend(width=1, name="greedy"))
register_backend("portfolio", _make_portfolio)


def get_backend(backend) -> SearchBackend:
    """Resolve a backend instance from a name, factory, or instance.

    Args:
        backend: a ``SearchBackend`` instance (returned as-is), a
            zero-arg factory, or a registered name.

    Returns:
        A ready-to-use ``SearchBackend``.

    Raises:
        ValueError: when ``backend`` names no registered backend.
    """
    if isinstance(backend, SearchBackend):
        return backend
    if callable(backend):
        return backend()
    factory = _REGISTRY.get(str(backend).lower())
    if factory is None:
        raise ValueError(f"unknown search backend {backend!r}; "
                         f"registered: {sorted(_REGISTRY)}")
    return factory()
