"""First-class collaboration-strategy policies behind a registry.

Each policy is the paper's arm-selection rule as an object::

    policy = repro_torch.el.policies.get("ol4el", ucb_c=2.0)
    arm = policy.select(state, residual_budget, costs, rng)   # -1 = broke

A numpy copy of the reference registry.  The numerical behaviour,
including the order of RNG draws, is the reference's, so a seeded run of
the port makes the reference's decisions.

Bandit policies (``ol4el``, ``ucb_bv``, ``greedy``, ``freq_only``,
``eps_greedy``) share the paper's initialization phase: every feasible arm
is tried once before the scoring rule kicks in (§IV.B).  ``fixed_i`` and
``uniform`` are the non-learning baselines; ``ac_sync`` wraps the adaptive
tau-control of Wang et al. [12] (stateful — it owns an ``ACSync``
estimator the runtime refreshes every aggregation).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

import numpy as np

from repro_torch.core.bandit import BanditState, _ucb
from repro_torch.core.strategies import ACSync


class Policy:
    """Arm-selection strategy over a budget-limited bandit.

    ``select`` returns a 0-based arm index (arm *i* = global-update
    interval *i+1*) or -1 when no arm is affordable.
    """

    name: str = ""
    init_phase: bool = True        # paper §IV.B: try every feasible arm once
    #: Modes the compiled device programs implement for this policy
    #: (``repro_torch.el.ingraph``'s sync round; the async event engine
    #: is a later slice).  Empty = host paths only.
    ingraph_modes: Tuple[str, ...] = ()

    def __init__(self, ucb_c: float = 2.0, eps: float = 0.1,
                 fixed_arm: int = 3, **_: object):
        self.ucb_c = ucb_c
        self.eps = eps
        self.fixed_arm = fixed_arm

    # -- public API ---------------------------------------------------------

    def select(self, state: BanditState, residual_budget: float,
               costs: np.ndarray,
               rng: Optional[np.random.Generator] = None) -> int:
        rng = rng or np.random.default_rng(0)
        feasible = costs <= residual_budget + 1e-12
        if not feasible.any():
            return -1
        if self.init_phase:
            untried = feasible & (state.counts == 0)
            if untried.any():
                return int(np.argmax(untried))
        return self._select(state, residual_budget, costs, feasible, rng)

    # -- per-policy scoring rule -------------------------------------------

    def _select(self, state: BanditState, residual_budget: float,
                costs: np.ndarray, feasible: np.ndarray,
                rng: np.random.Generator) -> int:
        raise NotImplementedError

    # -- shared helpers -----------------------------------------------------

    def _density(self, state: BanditState, costs: np.ndarray,
                 feasible: np.ndarray) -> np.ndarray:
        ucb = _ucb(state, self.ucb_c)
        return np.where(feasible, ucb / np.maximum(costs, 1e-9), -np.inf)

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"


_REGISTRY: Dict[str, Type[Policy]] = {}


def register(cls: Type[Policy]) -> Type[Policy]:
    if not cls.name:
        raise ValueError(f"{cls} must set a registry name")
    _REGISTRY[cls.name] = cls
    return cls


def get(name: str, **kwargs) -> Policy:
    """Instantiate a registered policy; unknown kwargs are ignored so one
    call site can configure every policy family."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown policy {name!r}; available: {available()}") from None
    return cls(**kwargs)


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def ingraph_modes(name: str) -> Tuple[str, ...]:
    """Modes (``sync``/``async``) the compiled programs support for the
    named policy; ``()`` for host-only or unknown policies (the
    reference's registry, mode for mode)."""
    cls = _REGISTRY.get(name)
    return getattr(cls, "ingraph_modes", ()) if cls is not None else ()


# ---------------------------------------------------------------------------
# The paper's procedure and its ablations
# ---------------------------------------------------------------------------


@register
class OL4ELPolicy(Policy):
    """§IV.B.1 3-step procedure: P(i) ∝ UCB-density_i × frequency_i."""

    name = "ol4el"
    ingraph_modes = ("sync", "async")   # shared / per-edge bandits

    def _select(self, state, residual_budget, costs, feasible, rng):
        density = self._density(state, costs, feasible)
        freq = np.where(feasible, np.floor(residual_budget / costs), 0.0)
        d = np.where(np.isfinite(density), density, np.nanmax(
            np.where(np.isfinite(density), density, -np.inf)) + 1.0)
        d = d - d.min() + 1e-9                   # shift to positive
        w = np.where(feasible, np.maximum(d * freq, 0.0), 0.0)
        if w.sum() <= 0:
            return int(rng.choice(np.flatnonzero(feasible)))
        p = w / w.sum()
        return int(rng.choice(len(costs), p=p))


@register
class FreqOnlyPolicy(Policy):
    """Literal reading of §IV.B.1 step 3: P(i) ∝ frequency_i."""

    name = "freq_only"

    def _select(self, state, residual_budget, costs, feasible, rng):
        w = np.where(feasible, np.floor(residual_budget / costs), 0.0)
        w = np.where(feasible, np.maximum(w, 0.0), 0.0)
        if w.sum() <= 0:
            return int(rng.choice(np.flatnonzero(feasible)))
        p = w / w.sum()
        return int(rng.choice(len(costs), p=p))


@register
class GreedyPolicy(Policy):
    """argmax UCB density — the pure fractional-KUBE solution."""

    name = "greedy"

    def _select(self, state, residual_budget, costs, feasible, rng):
        return int(np.argmax(self._density(state, costs, feasible)))


@register
class EpsGreedyPolicy(Policy):
    """ε-greedy on UCB density (ablation)."""

    name = "eps_greedy"

    def _select(self, state, residual_budget, costs, feasible, rng):
        density = self._density(state, costs, feasible)
        if rng.random() < self.eps:
            return int(rng.choice(np.flatnonzero(feasible)))
        return int(np.argmax(density))


@register
class UCBBVPolicy(Policy):
    """Variable-cost UCB-BV1 [Ding et al., AAAI'13] (§IV.B.2)."""

    name = "ucb_bv"

    def _select(self, state, residual_budget, costs, feasible, rng):
        n = np.maximum(state.counts, 1)
        eps_i = np.sqrt(np.log(max(state.t - 1, 2)) / n)
        mean_c = state.mean_cost(fallback=costs)
        lam = max(float(np.min(mean_c)), 1e-6)
        denom = lam - eps_i
        density = state.mean_utility() / np.maximum(mean_c, 1e-9)
        d = np.where(denom > 1e-9,
                     density + (1.0 + 1.0 / lam) * eps_i / np.maximum(denom,
                                                                      1e-9),
                     np.inf)
        d = np.where(feasible, d, -np.inf)
        return int(np.argmax(d))


@register
class UniformPolicy(Policy):
    """Uniform over feasible arms (ablation floor)."""

    name = "uniform"
    init_phase = False

    def _select(self, state, residual_budget, costs, feasible, rng):
        return int(rng.choice(np.flatnonzero(feasible)))


@register
class FixedIPolicy(Policy):
    """The paper's Fixed-I baseline: a constant interval."""

    name = "fixed_i"
    init_phase = False

    def _select(self, state, residual_budget, costs, feasible, rng):
        arm = min(self.fixed_arm, state.n_arms - 1)
        return arm if feasible[arm] else int(np.argmax(feasible))


@register
class TaskAllocPolicy(Policy):
    """Adaptive task-allocation baseline (arXiv 1811.03748, "Adaptive task
    allocation for mobile edge learning"): allocate the largest
    locally-feasible workload every round — the max number of local
    updates per global sync the residual budget still covers."""

    name = "task_alloc"
    init_phase = False
    ingraph_modes = ("sync",)          # via the scenario policy switch

    def _select(self, state, residual_budget, costs, feasible, rng):
        arms = np.arange(len(costs))
        return int(np.max(np.where(feasible, arms, -1)))


@register
class DelayEnergyPolicy(Policy):
    """Budget-pacing baseline (arXiv 2012.00143, delay/energy-constrained
    task allocation for asynchronous edge learning): pick the arm whose
    cost best matches a geometric pace ``sqrt(residual * min_cost)``, so
    consumption is smoothed over the run instead of front-loaded."""

    name = "delay_energy"
    init_phase = False
    ingraph_modes = ("sync",)          # via the scenario policy switch

    def _select(self, state, residual_budget, costs, feasible, rng):
        min_c = max(float(np.min(costs)), 1e-9)
        pace = np.sqrt(max(residual_budget, min_c) * min_c)
        score = np.where(feasible, np.abs(costs - pace), np.inf)
        return int(np.argmin(score))


@register
class ACSyncPolicy(Policy):
    """AC-sync baseline [12]: adaptive tau from online (beta, delta, rho)
    estimates.  Stateful — the runtime must call
    ``policy.ac.update_estimates(...)`` after every aggregation."""

    name = "ac_sync"
    init_phase = False

    def __init__(self, eta: float = 0.1, max_interval: int = 10, **kw):
        super().__init__(**kw)
        self.ac = ACSync(eta=eta, max_interval=max_interval)

    def select(self, state, residual_budget, costs, rng=None):
        # Arm costs are linear in the interval (cost_i = i*comp + comm), so
        # the per-component costs ACSync scores with are recoverable.
        if len(costs) >= 2:
            comp = float(costs[1] - costs[0])
            comm = float(costs[0] - comp)
        else:
            comp, comm = float(costs[0]), 0.0
        tau = self.ac.select_tau(residual_budget, comp, comm)
        return -1 if tau < 0 else tau - 1
