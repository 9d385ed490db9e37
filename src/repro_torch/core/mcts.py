"""Monte-Carlo Tree Search partitioning agent (paper §4.1–4.3).

Faithful to the paper's adaptations of standard UCT:

- **State** is the canonical sharding map (``ShardingState``), not the
  action sequence — any action ordering reaching the same sharded model
  hits the same node (transposition-free by construction, §4.3).
- **Early round termination**: the search runs in rounds of trajectories;
  if a round fails to improve the best-known cost, the whole search stops
  (§4.1).
- **Short-trajectory incentive**: rewards are discounted in trajectory
  length so shorter action sequences with equal cost are preferred (§4.1).
- Trajectories end on a explicit *stop* action or at ``max_depth`` (30 in
  the paper).

Evaluation runs through ``IncrementalEvaluator``: every action application
during tree walk and playout costs the child *incrementally* from its
parent's record, and repeated prefix states hit the transposition cache —
the full abstract interpretation never re-runs per state (paper §5.3).
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Any

from repro_torch.core.actions import Action, STOP, valid_actions
from repro_torch.core.cost_model import CostModel, ShardingState
from repro_torch.core.evaluator import IncrementalEvaluator
from repro_torch.core.search import SearchBackend, SearchResult, recover_actions

__all__ = ["MCTS", "MCTSBackend", "MCTSConfig", "SearchResult"]


@dataclasses.dataclass
class MCTSConfig:
    rounds: int = 12
    trajectories_per_round: int = 48
    max_depth: int = 30
    exploration: float = 0.7
    length_penalty: float = 0.01       # short-trajectory incentive
    seed: int = 0
    patience: int = 1                  # rounds without improvement -> stop
    # hard evaluation budget: no new trajectory starts once `evaluations`
    # reaches it (None = unbounded).  Used for equal-budget guided-vs-
    # unguided comparisons (benchmarks/guidance.py).
    max_evaluations: int | None = None
    # learned guidance (repro.guidance.GuidanceSpec | None).  None — and,
    # provably, a uniform-prior spec without value bootstrap — leaves the
    # search bit-identical to vanilla UCT: same RNG stream, same visited
    # states, same best plan (tests/test_guidance.py pins this).
    guidance: Any = None


class _Node:
    __slots__ = ("visits", "value", "children", "untried", "priors")

    def __init__(self, untried: list[Action]) -> None:
        self.visits = 0
        self.value = 0.0
        self.children: dict[Action, ShardingState] = {}
        self.untried = untried
        # action -> policy prior, or None when the search is unguided
        self.priors: dict[Action, float] | None = None


class MCTS:
    def __init__(self, cost_model: CostModel | IncrementalEvaluator,
                 actions: list[Action],
                 config: MCTSConfig | None = None) -> None:
        if isinstance(cost_model, IncrementalEvaluator):
            self.ev = cost_model
        else:
            self.ev = IncrementalEvaluator(cost_model)
        self.cm = self.ev.cm
        self.actions = actions
        self.cfg = config if config is not None else MCTSConfig()
        self.rng = random.Random(self.cfg.seed)
        self.nodes: dict[ShardingState, _Node] = {}
        self.evaluations = 0
        self.guide = None
        if self.cfg.guidance is not None:
            self.guide = self.cfg.guidance.bind(self.ev, actions)
        self._prior_scale = getattr(self.guide, "prior_scale", 0.0)

    def _node(self, state: ShardingState) -> _Node:
        n = self.nodes.get(state)
        if n is None:
            n = _Node(valid_actions(self.actions, state) + [STOP])
            self.rng.shuffle(n.untried)
            if self.guide is not None and self.guide.has_policy:
                pri = self.guide.priors(state, n.untried)
                n.priors = dict(zip(n.untried, pri))
                # best-prior-last so pop() expands best-first; the sort is
                # stable, so exactly-uniform priors preserve the shuffled
                # order (the bit-identity contract)
                n.untried.sort(key=n.priors.__getitem__)
            self.nodes[state] = n
        return n

    def _cost(self, state: ShardingState) -> float:
        self.evaluations += 1
        return self.ev.paper_cost(state)

    def _cost_child(self, state: ShardingState,
                    action: Action) -> tuple[ShardingState, float]:
        self.evaluations += 1
        return self.ev.paper_cost_child(state, action)

    def _reward(self, cost: float, depth: int) -> float:
        return 1.0 - cost - self.cfg.length_penalty * depth

    def _uct(self, parent: _Node, child_state: ShardingState,
             action: Action | None = None) -> float:
        child = self._node(child_state)
        if child.visits == 0:
            return float("inf")
        exploit = child.value / child.visits
        explore = self.cfg.exploration * math.sqrt(
            math.log(max(parent.visits, 1)) / child.visits)
        if action is not None and parent.priors is not None:
            # PUCT-style prior reweighting of the exploration term.  The
            # factor is 1 + scale * n * (p - 1/n): exactly 1.0 under a
            # uniform prior (p == 1/n bit-for-bit, see
            # PolicyValueModel.uniform), so uniform-guided == vanilla UCT.
            n = len(parent.priors)
            p = parent.priors.get(action, 1.0 / n)
            factor = 1.0 + self._prior_scale * n * (p - 1.0 / n)
            explore *= max(factor, 0.05)
        return exploit + explore

    def _trajectory(self, root: ShardingState):
        """One rollout; returns (path states, final state, depth, leaf
        value bootstrap or ``None``)."""
        path = [root]
        state = root
        depth = 0
        while depth < self.cfg.max_depth:
            node = self._node(state)
            if node.untried:
                action = node.untried.pop()
            else:
                if not node.children:
                    break
                action = max(node.children,
                             key=lambda a: self._uct(node, node.children[a],
                                                     a))
            if action.is_stop:
                break
            # incremental child costing primes the transposition cache for
            # the prefix-candidate sweep in search()
            nxt, _ = self._cost_child(state, action)
            node.children[action] = nxt
            if nxt == state:
                break
            path.append(nxt)
            state = nxt
            depth += 1
            # random playout extension: after expansion, follow random
            # actions without tree bookkeeping
            node2 = self._node(state)
            if node2.visits == 0:
                if self.guide is not None and self.guide.has_value:
                    # value bootstrap: the learned estimate replaces the
                    # playout — and its several real evaluations
                    return path, state, depth, self.guide.leaf_value(state)
                # playout — policy-directed when guided: the choice set
                # shrinks to the policy's plausible actions, but the RNG
                # draws are the same either way (and under a uniform
                # prior the set never shrinks: bit-identical to vanilla)
                s = state
                d = depth
                guided = self.guide is not None and self.guide.has_policy
                while d < self.cfg.max_depth:
                    av = valid_actions(self.actions, s)
                    if not av or self.rng.random() < 0.35:
                        break
                    if guided:
                        av = self.guide.playout_actions(s, av)
                    s, _ = self._cost_child(s, self.rng.choice(av))
                    d += 1
                return path, s, d, None
        return path, state, depth, None

    def search(self, root: ShardingState = ShardingState()) -> SearchResult:
        best_state = root
        best_cost = self._cost(root)
        best_path: list[ShardingState] = [root]
        history = [best_cost]
        curve = [(self.evaluations, best_cost)]
        stale = 0
        rounds_run = 0
        budget = self.cfg.max_evaluations
        for rnd in range(self.cfg.rounds):
            rounds_run += 1
            improved = False
            for _ in range(self.cfg.trajectories_per_round):
                if budget is not None and self.evaluations >= budget:
                    break
                path, final, depth, leaf_v = self._trajectory(root)
                cost = self._cost(final)
                if leaf_v is None:
                    reward = self._reward(cost, depth)
                else:
                    # blend the real leaf cost with the value head's
                    # subtree estimate for the backed-up reward only —
                    # best_state/best_cost always use real costs
                    w = self.guide.value_weight
                    reward = self._reward((1.0 - w) * cost + w * leaf_v,
                                          depth)
                for s in path:
                    n = self._node(s)
                    n.visits += 1
                    n.value += reward
                # every prefix state of the trajectory is itself a candidate
                for s in path:
                    c = self._cost(s)
                    if c < best_cost - 1e-12:
                        best_cost, best_state, improved = c, s, True
                        best_path = list(path[:path.index(s) + 1])
                        curve.append((self.evaluations, best_cost))
                if cost < best_cost - 1e-12:
                    best_cost, best_state, improved = cost, final, True
                    best_path = path + [final]
                    curve.append((self.evaluations, best_cost))
            history.append(best_cost)
            if budget is not None and self.evaluations >= budget:
                break
            if not improved:
                stale += 1
                if stale >= self.cfg.patience:
                    break           # paper: stop when a round fails to improve
            else:
                stale = 0
        if self.guide is not None:
            self.guide.finish(self.nodes, root, seed=self.cfg.seed,
                              best_cost=best_cost)
        actions = recover_actions(best_state)
        return SearchResult(best_state, best_cost, actions, rounds_run,
                            self.evaluations, history, curve)


class MCTSBackend(SearchBackend):
    """``SearchBackend`` adapter for :class:`MCTS`."""

    name = "mcts"

    def search(self, evaluator, actions: list[Action], config=None,
               root: ShardingState = ShardingState()) -> SearchResult:
        if config is not None and not isinstance(config, MCTSConfig):
            raise TypeError(f"mcts backend expects MCTSConfig, "
                            f"got {type(config).__name__}")
        return MCTS(evaluator, actions, config).search(root)


# backwards-compatible alias (pre-refactor location)
_recover_actions = recover_actions
