"""Budget-limited multi-armed bandits — the paper's §IV core (host half).

Arms are *global update intervals* I in {1..K}.  Pulling arm I costs
``I * c_comp + c_comm`` resource units and yields the learning utility
observed at the next global aggregation.  The bandit must maximize average
utility before the per-edge budget runs out.

A numpy copy of the reference's host bandit: the sufficient statistics
(``BanditState``), arm costs, the UCB, the ``select_arm`` shim over
``repro_torch.el.policies`` and the regret oracle.

Beside it, the device bandit (``device_bandit_*``, the reference's
``jax_bandit_*``): the same ``ol4el`` rule as tensor ops on the run's
device, with no host sync, so the compiled sync round
(``repro_torch.el.ingraph``) keeps arm selection on the card.  Its state
is a dict of tensors (counts i32, utility_sum and cost_sum f32, t i32)
and its arithmetic is the reference's f32, op for op.  The logarithms are
taken in f64 and rounded to f32, so the CPU and the card compute the
same weights (their f32 ``log``s differ in the last bit now and then, as
XLA's does from both).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


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


# ---------------------------------------------------------------------------
# Device (in-graph) bandit: the reference's jax_bandit_*, as torch ops
# ---------------------------------------------------------------------------


def _log32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``log`` rounded from f64: the same bits on every device."""
    return torch.log(x.double()).float()


def device_bandit_init(n_arms: int, device=None) -> dict:
    return {
        "counts": torch.zeros(n_arms, dtype=torch.int32, device=device),
        "utility_sum": torch.zeros(n_arms, dtype=torch.float32,
                                   device=device),
        "cost_sum": torch.zeros(n_arms, dtype=torch.float32, device=device),
        "t": torch.zeros((), dtype=torch.int32, device=device),
    }


def device_selection_weights(state: dict, residual_budget: torch.Tensor,
                             costs: torch.Tensor,
                             ucb_c: torch.Tensor) -> torch.Tensor:
    """OL4EL 3-step selection weights (density x frequency), in f32.

    Unplayed feasible arms get all the mass (initialization phase).
    Returns [K] nonnegative weights; all-zero means no arm affordable.
    """
    counts = state["counts"]
    feasible = costs <= residual_budget + 1e-12
    untried = feasible & (counts == 0)
    n = counts.clamp(min=1)
    t = state["t"].clamp(min=2).float()
    mean_u = state["utility_sum"] / n
    bonus = torch.sqrt(ucb_c * _log32(t) / n)
    ucb = mean_u + bonus
    density = ucb / costs.clamp(min=1e-9)
    d = density - torch.where(feasible, density, torch.inf).amin() + 1e-9
    freq = torch.where(feasible, torch.floor(residual_budget / costs), 0.0)
    w = torch.where(feasible, torch.clamp(d * freq, min=1e-12), 0.0)
    # initialization phase: uniform over untried feasible arms
    return torch.where(untried.any(), untried.float(), w)


def device_arm_logits(w: torch.Tensor) -> torch.Tensor:
    """log-weights of a categorical draw, -inf where the weight is 0."""
    return torch.where(w > 0, _log32(torch.clamp(w, min=1e-30)), -torch.inf)


def device_select_arm(gumbel: torch.Tensor, state: dict,
                      residual_budget: torch.Tensor, costs: torch.Tensor,
                      ucb_c: torch.Tensor) -> torch.Tensor:
    """Sample an arm on the device by Gumbel-max, ``argmax(logits + g)``
    for a standard Gumbel vector ``gumbel`` [K] (what
    ``jax.random.categorical`` draws from its key; ``argmax`` takes the
    first maximal index, as ``jnp.argmax`` does).  Returns -1 when
    nothing is affordable."""
    w = device_selection_weights(state, residual_budget, costs, ucb_c)
    arm = torch.argmax(device_arm_logits(w) + gumbel)
    return torch.where(w.sum() > 0, arm, -1)


def device_bandit_update(state: dict, arm: torch.Tensor,
                         utility: torch.Tensor, cost: torch.Tensor) -> dict:
    """Record one pull of ``arm`` (a no-op for -1)."""
    valid = arm >= 0
    hit = (torch.arange(state["counts"].shape[0], device=arm.device)
           == arm.clamp(min=0)) & valid
    return {
        "counts": state["counts"] + hit.int(),
        "utility_sum": torch.where(hit, state["utility_sum"] + utility,
                                   state["utility_sum"]),
        "cost_sum": torch.where(hit, state["cost_sum"] + cost,
                                state["cost_sum"]),
        "t": state["t"] + valid.int(),
    }


def regret_oracle(mean_utility: np.ndarray, costs: np.ndarray,
                  budget: float) -> float:
    """Best fixed-arm average-utility benchmark: play the best
    utility-per-cost arm until the budget runs out (the budget-limited MAB
    oracle for i.i.d. rewards)."""
    density = mean_utility / costs
    best = int(np.argmax(density))
    pulls = int(budget // costs[best])
    return pulls * float(mean_utility[best])
