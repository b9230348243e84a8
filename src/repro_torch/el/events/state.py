"""The per-edge bandit fleet of the async event engine: the device bandit
(``repro_torch.core.bandit.device_*``) with a leading ``[E]`` edge
dimension, so one carry entry holds every edge's statistics.

The event edge is a device index tensor, never a host int: selecting it
is a gather and placing it back a ``where`` over the edge dimension, so
the event body needs no host sync.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.bandit import device_bandit_init

BanditFleet = Dict[str, torch.Tensor]


def bandit_fleet_init(n_edges: int, n_arms: int, device=None) -> BanditFleet:
    """One fresh bandit per edge, stacked along a leading [E] dim."""
    one = device_bandit_init(n_arms, device)
    return {k: v.unsqueeze(0).repeat((n_edges,) + (1,) * v.dim())
            for k, v in one.items()}


def bandit_slice(fleet: BanditFleet, edge: torch.Tensor) -> BanditFleet:
    """Edge ``edge``'s bandit (the unstacked ``device_bandit_*`` shape);
    ``edge`` a 0-dim index tensor, gathered as a 1-element index (torch
    reads a 0-dim index back to the host)."""
    rows = edge.reshape(1)
    return {k: v[rows][0] for k, v in fleet.items()}


def bandit_place(fleet: BanditFleet, edge: torch.Tensor,
                 state: BanditFleet) -> BanditFleet:
    """The fleet with edge ``edge``'s bandit replaced by ``state``."""
    rows = torch.arange(fleet["t"].shape[0], device=edge.device) == edge
    return {k: torch.where(rows.reshape((-1,) + (1,) * (v.dim() - 1)),
                           state[k], v)
            for k, v in fleet.items()}
