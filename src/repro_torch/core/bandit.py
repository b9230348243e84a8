"""Budget-limited multi-armed bandits — the paper's §IV core (host half).

Arms are *global update intervals* I in {1..K}.  Pulling arm I costs
``I * c_comp + c_comm`` resource units and yields the learning utility
observed at the next global aggregation.  The bandit must maximize average
utility before the per-edge budget runs out.

A numpy copy of the reference's host bandit: the sufficient statistics
(``BanditState``), arm costs, the UCB, the ``select_arm`` shim over
``repro_torch.el.policies`` and the regret oracle.  The bandit is the
cloud control plane and stays on the host; the in-graph (device) bandit
comes with the compiled-program slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class BanditState:
    """Sufficient statistics for one bandit over K arms."""

    counts: np.ndarray        # [K] pulls
    utility_sum: np.ndarray   # [K]
    cost_sum: np.ndarray      # [K] observed costs (variable-cost mode)
    t: int                    # total pulls

    @classmethod
    def create(cls, n_arms: int) -> "BanditState":
        return cls(np.zeros(n_arms, np.int64), np.zeros(n_arms),
                   np.zeros(n_arms), 0)

    def copy(self) -> "BanditState":
        return BanditState(self.counts.copy(), self.utility_sum.copy(),
                           self.cost_sum.copy(), self.t)

    @property
    def n_arms(self) -> int:
        return len(self.counts)

    def mean_utility(self) -> np.ndarray:
        return self.utility_sum / np.maximum(self.counts, 1)

    def mean_cost(self, fallback: Optional[np.ndarray] = None) -> np.ndarray:
        m = self.cost_sum / np.maximum(self.counts, 1)
        if fallback is not None:
            m = np.where(self.counts > 0, m, fallback)
        return m

    def update(self, arm: int, utility: float, cost: float) -> None:
        self.counts[arm] += 1
        self.utility_sum[arm] += utility
        self.cost_sum[arm] += cost
        self.t += 1


def arm_costs(n_arms: int, comp_cost: float, comm_cost: float) -> np.ndarray:
    """Expected cost of interval-arm I (1-based): I*comp + comm."""
    intervals = np.arange(1, n_arms + 1, dtype=np.float64)
    return intervals * comp_cost + comm_cost


def _ucb(state: BanditState, ucb_c: float) -> np.ndarray:
    """Upper confidence bound of mean utility (unplayed arms -> +inf)."""
    n = np.maximum(state.counts, 1)
    bonus = np.sqrt(ucb_c * np.log(max(state.t, 2)) / n)
    ucb = state.mean_utility() + bonus
    return np.where(state.counts > 0, ucb, np.inf)


def select_arm(state: BanditState, residual_budget: float,
               costs: np.ndarray, policy: str = "ol4el",
               rng: Optional[np.random.Generator] = None,
               ucb_c: float = 2.0, eps: float = 0.1,
               fixed_arm: int = 3) -> int:
    """Choose an arm. Returns -1 when no arm is affordable (terminate).

    Shim over the policy objects in ``repro_torch.el.policies``.
    """
    from repro_torch.el import policies as el_policies
    rng = rng or np.random.default_rng(0)
    pol = el_policies.get(policy, ucb_c=ucb_c, eps=eps, fixed_arm=fixed_arm)
    return pol.select(state, residual_budget, costs, rng)


def regret_oracle(mean_utility: np.ndarray, costs: np.ndarray,
                  budget: float) -> float:
    """Best fixed-arm average-utility benchmark: play the best
    utility-per-cost arm until the budget runs out (the budget-limited MAB
    oracle for i.i.d. rewards)."""
    density = mean_utility / costs
    best = int(np.argmax(density))
    pulls = int(budget // costs[best])
    return pulls * float(mean_utility[best])
