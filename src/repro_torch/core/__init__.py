"""The paper's primary contribution: OL4EL — budget-limited-MAB scheduling
of edge-cloud collaborative learning (bandits, utilities, coordinator,
strategy zoo).  The control plane is numpy on the host."""

from repro_torch.core.bandit import BanditState, arm_costs, select_arm
from repro_torch.core.coordinator import CloudCoordinator, edge_speed_factors
from repro_torch.core.strategies import ACSync, POLICIES
from repro_torch.core.utility import UtilityEstimator, param_l2_delta

__all__ = [
    "BanditState", "arm_costs", "select_arm", "CloudCoordinator",
    "edge_speed_factors", "ACSync", "POLICIES", "UtilityEstimator",
    "param_l2_delta",
]
