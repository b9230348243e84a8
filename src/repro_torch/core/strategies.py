"""Coordination strategies: OL4EL policies + the paper's baselines (numpy).

``ACSync`` implements the AC-sync baseline — the adaptive-communication
control of Wang et al., INFOCOM'18 [12] ("When edge meets learning") which
the paper compares against.  It picks the aggregation interval tau* that
maximizes estimated progress per resource unit, using online estimates of
smoothness (beta), gradient divergence (delta) and gradient scale (rho)
derived from parameter movements:

    h(tau)     = delta/beta * ((eta*beta + 1)^tau - 1) - eta*delta*tau
    score(tau) = [eta*(1 - beta*eta/2) - rho*h(tau)/tau] * tau
                 / (tau*c_comp + c_comm)
    tau*       = argmax_{1<=tau<=K, affordable} score(tau)
"""

from __future__ import annotations

import dataclasses

import numpy as np

POLICIES = ("ol4el", "ucb_bv", "greedy", "freq_only", "eps_greedy",
            "uniform", "fixed_i", "ac_sync",
            # task-allocation competitors: greedy max-interval assignment
            # and delay/energy-balanced pacing (repro_torch.el.policies)
            "task_alloc", "delay_energy")


@dataclasses.dataclass
class ACSync:
    """Adaptive-tau controller (baseline [12])."""

    eta: float                      # local learning rate
    max_interval: int
    beta: float = 1.0               # smoothness estimate
    delta: float = 0.1              # gradient-divergence estimate
    rho: float = 1.0                # loss-Lipschitz estimate
    ema: float = 0.5

    def update_estimates(self, local_deltas: np.ndarray,
                         global_delta: float, tau: int) -> None:
        """Refresh (beta, delta, rho) from parameter movements.

        local_deltas: per-edge ||theta_e - theta_global|| after tau local
        steps; global_delta: ||theta_new_global - theta_old_global||.
        Gradient proxies: g_e ~ local_delta / (eta * tau).
        """
        tau = max(tau, 1)
        g_local = local_deltas / (self.eta * tau)
        g_global = global_delta / (self.eta * tau)
        div = float(np.mean(np.abs(g_local - g_global)))
        self.delta = (1 - self.ema) * self.delta + self.ema * max(div, 1e-6)
        self.rho = (1 - self.ema) * self.rho + self.ema * max(
            float(g_global), 1e-6)
        # smoothness proxy: relative change of gradient magnitude
        beta_hat = max(float(np.std(g_local) /
                             (np.mean(np.abs(g_local)) + 1e-9)), 1e-3)
        self.beta = (1 - self.ema) * self.beta + self.ema * beta_hat

    def h(self, tau: np.ndarray) -> np.ndarray:
        eb = self.eta * self.beta + 1.0
        return (self.delta / self.beta * (eb ** tau - 1.0)
                - self.eta * self.delta * tau)

    def select_tau(self, residual_budget: float, comp_cost: float,
                   comm_cost: float) -> int:
        taus = np.arange(1, self.max_interval + 1, dtype=np.float64)
        cost = taus * comp_cost + comm_cost
        feasible = cost <= residual_budget + 1e-12
        if not feasible.any():
            return -1
        progress = (self.eta * (1.0 - self.beta * self.eta / 2.0)
                    - self.rho * self.h(taus) / taus)
        score = np.where(feasible, progress * taus / cost, -np.inf)
        return int(np.argmax(score)) + 1
