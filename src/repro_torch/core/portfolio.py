"""Portfolio search: many configurations of the pluggable backends at once.

Automap (Schaarschmidt et al., 2021) and the PartIR strategy-discovery
work (Alabed et al., 2022) both observe that no single search
configuration wins across model architectures: MCTS with one seed may
stall where another seed — or plain beam search — finds the good basin
immediately.  ``PortfolioBackend`` therefore runs a *portfolio* of
``(backend × seed × budget)`` members concurrently via
``concurrent.futures`` over the existing ``SearchBackend`` interface and
returns the best plan any member found.

Design points:

- Every member gets its **own** ``IncrementalEvaluator`` over the shared
  ``CostModel`` — the cost model's static tables are read-only after
  construction, so sharing them across threads is safe, while evaluator
  caches are per-member mutable state.
- **Early stopping**: results are consumed as they complete; once a
  *feasible* plan (peak memory within budget) exists and ``patience``
  consecutive completions fail to improve its cost by ``rel_tol``
  relative, the not-yet-started members are cancelled.  Members already
  running finish (threads cannot be interrupted mid-search) but no new
  work starts.
- Ties are broken deterministically: feasible beats infeasible, then
  lower cost, then fewer evaluations, then portfolio order.

Select with ``auto_partition(..., backend="portfolio")`` or the
``portfolio=`` convenience argument.  A copy of the reference's
``core/portfolio.py`` over the port's own ``actions``, ``cost_model``,
``evaluator`` and ``search``: on the same program and members, at
``max_workers=1``, it returns the reference's result exactly (see
``PortfolioConfig.max_workers`` for the one race early stopping keeps).
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any

from repro_torch.core.actions import Action
from repro_torch.core.cost_model import ShardingState
from repro_torch.core.evaluator import IncrementalEvaluator
from repro_torch.core.search import SearchBackend, SearchResult, get_backend


@dataclasses.dataclass(frozen=True)
class PortfolioMember:
    """One search configuration inside a portfolio.

    Args:
        backend: registered backend name ("mcts", "beam", "greedy", ...).
        seed: RNG seed, injected into seedable configs (MCTS).
        config: backend-specific config object; built from defaults (with
            ``seed`` applied) when ``None``.
        label: display name; auto-derived as ``"<backend>#<seed>"`` when
            empty.
    """

    backend: str = "mcts"
    seed: int = 0
    config: Any = None
    label: str = ""

    @property
    def name(self) -> str:
        """The member's display label."""
        return self.label or f"{self.backend}#{self.seed}"


@dataclasses.dataclass
class PortfolioConfig:
    """Configuration for :class:`PortfolioBackend`.

    Args:
        members: the search configurations to run; when empty,
            :func:`default_portfolio` is used.
        max_workers: thread-pool size (default: ``min(len(members),
            os.cpu_count())``).  ``max_workers=1`` runs the portfolio
            sequentially.  Early stopping is then deterministic but at
            member boundaries: the thread may start the next member
            before a plateau's cancel reaches it, so which member runs
            last can depend on timing when members take microseconds.
        patience: consecutive completed members that fail to improve the
            best feasible cost before the remaining members are cancelled.
        rel_tol: relative cost decrease that counts as an improvement for
            the plateau detector.
        guidance: optional guidance spec injected into every MCTS
            member whose own config carries none (explicitly guided
            member configs are left alone); non-MCTS members ignore it.
            ``None`` (default) leaves every member exactly as before.
            The guidance models themselves are not ported yet (ROADMAP
            queue 1, item 16); the field is carried as the reference
            carries it.
    """

    members: tuple[PortfolioMember, ...] = ()
    max_workers: int | None = None
    patience: int = 2
    rel_tol: float = 0.01
    guidance: Any = None


@dataclasses.dataclass
class MemberOutcome:
    """Per-member record in a :class:`PortfolioResult`.

    ``status`` is one of ``"done"``, ``"error"``, or ``"cancelled"``
    (member never started because early stopping fired first).
    """

    label: str
    backend: str
    seed: int
    status: str = "done"
    seconds: float = 0.0
    evaluations: int = 0
    best_cost: float = float("inf")
    feasible: bool = False
    error: str = ""

    def as_dict(self) -> dict:
        """Plain-dict view (JSON-serializable)."""
        return dataclasses.asdict(self)


@dataclasses.dataclass
class PortfolioResult(SearchResult):
    """A :class:`SearchResult` plus per-member outcomes.

    ``rounds_run`` counts completed members; ``evaluations`` sums cost
    queries across all completed members; ``history`` is the winning
    member's cost history.
    """

    members: list[MemberOutcome] = dataclasses.field(default_factory=list)
    early_stopped: bool = False
    winner: str = ""


def default_portfolio(seeds: tuple[int, ...] = (0, 1, 2)
                      ) -> tuple[PortfolioMember, ...]:
    """The stock portfolio: MCTS over ``seeds`` plus beam and greedy.

    Args:
        seeds: MCTS seeds; each becomes one member.

    Returns:
        Members tuple suitable for ``PortfolioConfig(members=...)``.
    """
    from repro_torch.core.mcts import MCTSConfig
    members = [PortfolioMember("mcts", seed=s,
                               config=MCTSConfig(seed=s, rounds=8,
                                                 trajectories_per_round=32))
               for s in seeds]
    members.append(PortfolioMember("beam", seed=0))
    members.append(PortfolioMember("greedy", seed=0))
    return tuple(members)


def _member_config(member: PortfolioMember, engine: SearchBackend,
                   guidance: Any = None):
    """Resolve the member's backend config, injecting the seed for MCTS.

    A portfolio-level ``guidance`` spec is attached to MCTS members that
    do not already carry their own (``dataclasses.replace``, so shared
    member configs are never mutated).
    """
    if member.config is not None:
        cfg = member.config
        if guidance is not None and engine.name == "mcts" and \
                getattr(cfg, "guidance", None) is None:
            cfg = dataclasses.replace(cfg, guidance=guidance)
        return cfg
    if engine.name == "mcts":
        from repro_torch.core.mcts import MCTSConfig
        return MCTSConfig(seed=member.seed, guidance=guidance)
    return None


class PortfolioBackend(SearchBackend):
    """Concurrent portfolio of search backends (see module docstring)."""

    name = "portfolio"

    def __init__(self, config: PortfolioConfig | None = None) -> None:
        """Create the backend.

        Args:
            config: default config used when ``search`` receives none.
        """
        self._default_config = config

    def search(self, evaluator, actions: list[Action], config=None,
               root: ShardingState = ShardingState()) -> PortfolioResult:
        """Run every portfolio member and return the best result.

        Args:
            evaluator: an ``IncrementalEvaluator``; its cost model is
                shared (read-only) across members, and its caches are
                primed with the winning state afterwards.
            actions: pruned action space shared by all members.
            config: a :class:`PortfolioConfig` (or ``None`` for defaults).
            root: sharding state every member starts from.

        Returns:
            A :class:`PortfolioResult` with the winning member's state and
            per-member outcomes.

        Raises:
            TypeError: if ``config`` is not a ``PortfolioConfig``.
        """
        if config is not None and not isinstance(config, PortfolioConfig):
            raise TypeError(f"portfolio backend expects PortfolioConfig, "
                            f"got {type(config).__name__}")
        cfg = config or self._default_config or PortfolioConfig()
        members = tuple(cfg.members) or default_portfolio()
        cm = evaluator.cm
        budget = cm.hw.hbm_per_chip

        def run_member(member: PortfolioMember
                       ) -> tuple[SearchResult, float]:
            engine = get_backend(member.backend)
            # each member gets its own evaluator (mutable caches), but
            # inherits the driving evaluator's constraint set so user
            # pins/forbids stay infeasible inside every member too
            ev = IncrementalEvaluator(
                cm, constraints=getattr(evaluator, "constraints", None))
            t0 = time.perf_counter()
            res = engine.search(ev, actions,
                                _member_config(member, engine, cfg.guidance),
                                root)
            return res, time.perf_counter() - t0

        workers = cfg.max_workers or min(len(members),
                                         max(os.cpu_count() or 1, 1))
        outcomes: dict[int, MemberOutcome] = {}
        results: dict[int, SearchResult] = {}
        best_idx: int | None = None
        best_key: tuple | None = None
        best_feasible_cost = float("inf")
        stale = 0
        stop_issued = False

        ex = ThreadPoolExecutor(max_workers=workers)
        try:
            futs = {ex.submit(run_member, m): i
                    for i, m in enumerate(members)}
            pending = set(futs)
            while pending:
                finished, pending = wait(pending,
                                         return_when=FIRST_COMPLETED)
                # drain in portfolio order for deterministic tie-breaks
                for fut in sorted(finished, key=futs.get):
                    i = futs[fut]
                    m = members[i]
                    out = MemberOutcome(m.name, m.backend, m.seed)
                    try:
                        res, secs = fut.result()
                    except Exception as e:          # noqa: BLE001
                        out.status = "error"
                        out.error = repr(e)
                        outcomes[i] = out
                        continue
                    bd = evaluator.evaluate(res.best_state)
                    out.seconds = secs
                    out.evaluations = res.evaluations
                    out.best_cost = res.best_cost
                    out.feasible = bd.peak_bytes <= budget
                    outcomes[i] = out
                    results[i] = res

                    key = (not out.feasible, res.best_cost,
                           res.evaluations, i)
                    if best_key is None or key < best_key:
                        best_key, best_idx = key, i
                    if out.feasible:
                        if res.best_cost < best_feasible_cost * \
                                (1.0 - cfg.rel_tol):
                            stale = 0
                        else:
                            stale += 1
                        best_feasible_cost = min(best_feasible_cost,
                                                 res.best_cost)
                if not stop_issued and pending and \
                        best_feasible_cost < float("inf") and \
                        stale >= cfg.patience:
                    # plateau: cancel members that have not started yet;
                    # already-running ones finish (threads cannot be
                    # interrupted) but count toward the same outcome list
                    stop_issued = True
                    for p in list(pending):
                        if p.cancel():
                            i = futs[p]
                            m = members[i]
                            outcomes[i] = MemberOutcome(
                                m.name, m.backend, m.seed,
                                status="cancelled")
                            pending.discard(p)
        finally:
            ex.shutdown(wait=True)

        if best_idx is None:
            errs = "; ".join(o.error for o in outcomes.values() if o.error)
            raise RuntimeError(f"every portfolio member failed: {errs}")
        win = results[best_idx]
        ordered = [outcomes[i] for i in sorted(outcomes)]
        total_evals = sum(o.evaluations for o in ordered)
        completed = sum(o.status == "done" for o in ordered)
        return PortfolioResult(
            best_state=win.best_state, best_cost=win.best_cost,
            best_actions=win.best_actions, rounds_run=completed,
            evaluations=total_evals, history=win.history,
            curve=win.curve, members=ordered, early_stopped=stop_issued,
            winner=members[best_idx].name)
