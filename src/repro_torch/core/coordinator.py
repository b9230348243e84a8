"""The cloud-server coordinator (§III): budgets, bandits, decisions.

Owns one bandit (sync) or one bandit per edge (async), the per-edge budget
accounting, the per-edge heterogeneous cost model, and the strategy switch
(OL4EL policies vs. Fixed-I vs. AC-sync).  Control plane only — numpy on
the host, a copy of the reference coordinator draw for draw; the data
plane runs in torch on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.config import OL4ELConfig
from repro_torch.core.bandit import BanditState, arm_costs


def edge_speed_factors(n_edges: int, heterogeneity: float) -> np.ndarray:
    """Per-edge compute-time multipliers in [1, H] (paper's H = ratio of
    fastest to slowest processing speed). Edge 0 is fastest."""
    if n_edges == 1:
        return np.ones(1)
    return 1.0 + (heterogeneity - 1.0) * np.arange(n_edges) / (n_edges - 1)


@dataclasses.dataclass
class EdgeAccount:
    budget: float
    consumed: float = 0.0

    @property
    def residual(self) -> float:
        return self.budget - self.consumed


class CloudCoordinator:
    """Decides per-edge global-update intervals under budget constraints."""

    def __init__(self, cfg: OL4ELConfig, n_edges: Optional[int] = None,
                 lr: float = 0.1, policy=None):
        # imported here: repro_torch.el imports this module through session
        from repro_torch.el import policies as el_policies
        self.cfg = cfg
        self.n_edges = n_edges or cfg.n_edges
        self.rng = np.random.default_rng(cfg.seed)
        self.speed = edge_speed_factors(self.n_edges, cfg.heterogeneity)
        self.comp_cost = cfg.comp_cost * self.speed          # [E]
        self.comm_cost = np.full(self.n_edges, cfg.comm_cost)
        self.accounts = [EdgeAccount(cfg.budget) for _ in range(self.n_edges)]
        k = cfg.max_interval
        if cfg.mode == "sync":
            self.bandits = [BanditState.create(k)]
        else:
            self.bandits = [BanditState.create(k)
                            for _ in range(self.n_edges)]
        self.policy = policy if policy is not None else el_policies.get(
            cfg.policy, ucb_c=cfg.ucb_c, eps=cfg.eps,
            fixed_arm=cfg.fixed_interval - 1, eta=lr, max_interval=k)
        self.ac = getattr(self.policy, "ac", None)
        self.history: List[Dict] = []

    # -- cost model ----------------------------------------------------------

    def expected_cost(self, edge: int, interval: int) -> float:
        return interval * self.comp_cost[edge] + self.comm_cost[edge]

    def realized_cost(self, edge: int, interval: int) -> float:
        """Draw the actual cost (variable-cost mode adds i.i.d. noise).

        AC-sync pays an extra estimation overhead: its tau-control needs
        per-round gradient/divergence statistics computed AT THE EDGES
        (Wang et al. Algorithm 2) — the paper's §V.B.1 explanation for why
        OL4EL-sync (all control computed on the cloud) beats AC-sync.
        """
        c = self.expected_cost(edge, interval)
        if self.cfg.policy == "ac_sync":
            c += self.comp_cost[edge]          # one extra local computation
        if self.cfg.cost_model == "variable" and self.cfg.cost_noise > 0:
            c *= max(0.1, 1.0 + self.cfg.cost_noise * self.rng.standard_normal())
        return c

    def _bandit_for(self, edge: int) -> BanditState:
        return self.bandits[0] if self.cfg.mode == "sync" \
            else self.bandits[edge]

    def _costs_for(self, edge: int) -> np.ndarray:
        if self.cfg.mode == "sync":
            # sync: one shared arm; a round costs every edge its own amount —
            # feasibility must respect the *tightest* account.
            worst = int(np.argmax(self.comp_cost))
            return arm_costs(self.cfg.max_interval,
                             float(self.comp_cost[worst]),
                             float(self.comm_cost[worst]))
        return arm_costs(self.cfg.max_interval, float(self.comp_cost[edge]),
                         float(self.comm_cost[edge]))

    def _residual_for(self, edge: int) -> float:
        if self.cfg.mode == "sync":
            return min(a.residual for a in self.accounts)
        return self.accounts[edge].residual

    # -- decisions -------------------------------------------------------------

    def decide(self, edge: int = 0) -> int:
        """Pick the global-update interval for ``edge`` (1-based interval).
        Returns -1 when the edge's budget affords no arm (terminate)."""
        arm = self.policy.select(self._bandit_for(edge),
                                 self._residual_for(edge),
                                 self._costs_for(edge), self.rng)
        return -1 if arm < 0 else arm + 1

    def observe(self, edge: int, interval: int, utility: float,
                cost: float) -> None:
        """Report the realized (utility, cost) of a finished interval."""
        self._bandit_for(edge).update(interval - 1, utility, cost)

    def charge(self, edge: int, cost: float) -> None:
        self.accounts[edge].consumed += cost

    # -- termination -------------------------------------------------------------

    def exhausted(self, edge: int) -> bool:
        min_cost = float(self.comp_cost[edge] + self.comm_cost[edge])
        return self.accounts[edge].residual < min_cost

    def all_exhausted(self) -> bool:
        if self.cfg.mode == "sync":
            return any(self.exhausted(e) for e in range(self.n_edges))
        return all(self.exhausted(e) for e in range(self.n_edges))

    def total_consumed(self) -> float:
        return sum(a.consumed for a in self.accounts)
