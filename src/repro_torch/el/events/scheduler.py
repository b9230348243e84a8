"""The event-horizon scheduling arithmetic, shared by the compiled async
program (``repro_torch.el.events.program``) and its host twin
(``repro_torch.el.events.reference``).

Sharing these functions is what makes the two paths bit-comparable: the
twin calls them in the order the program's event body runs them, on the
same draws, so at fixed cost every selection, charged cost and merge
coefficient agrees bit for bit.  All of it is tensor ops on the run's
device with no host sync.

The reference draws per event from ``fold_in(k_*, e)`` keys of the event
edge ``e``; here the draws come through the RNG seam
(``repro_torch.el.rng``, ``ROUND_DRAWS`` / ``INIT_DRAWS``): a Gumbel
vector ``[K]`` for the arm and a normal for the cost noise of each
scheduled block.  Its f32 arithmetic is the reference's as XLA compiles
it: ``interval * comp + comm`` and ``1 + noise * eps`` are fused
multiply-adds (``_fma32``), and the outer ``max(cost, 0)`` pins the
charged cost to its own rounding so ``wall + cost`` is a plain add.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.bandit import device_select_arm
from repro_torch.el.ingraph import _fma32
from repro_torch.interop import tree_map

Params = Any


def schedule_block(bstate_e: Dict[str, torch.Tensor], resid: torch.Tensor,
                   costs_e: torch.Tensor, ucb_c: torch.Tensor,
                   min_cost_e: torch.Tensor, cost_noise: torch.Tensor,
                   comp_e: torch.Tensor, comm_e: torch.Tensor,
                   wall: torch.Tensor, gumbel_e: torch.Tensor,
                   normal_e: torch.Tensor):
    """Select an edge's next interval and realize its block's cost.

    The arm is the device ol4el draw (``argmax(logits + gumbel_e)``, -1
    when nothing is affordable); the cost is ``interval * comp_e +
    comm_e`` times ``max(0.1, 1 + noise * normal_e)`` (a 0 noise knob
    multiplies by exactly 1); the block is scheduled only when an arm was
    affordable and the residual still covers the cheapest block.

    Returns ``(active, interval, cost, finish)``, ``finish = wall + cost``
    for a scheduled block and ``+inf`` for a stopped edge.
    """
    arm = device_select_arm(gumbel_e, bstate_e, resid, costs_e, ucb_c)
    interval = arm + 1
    mult = torch.clamp(_fma32(cost_noise, normal_e, 1.0), min=0.1)
    cost = torch.clamp(_fma32(interval.float(), comp_e, comm_e) * mult,
                       min=0.0)
    active = (arm >= 0) & (resid >= min_cost_e)
    finish = torch.where(active, wall + cost, torch.inf)
    return active, interval, cost, finish


def wave_safe_gap(min_edge_cost: torch.Tensor,
                  cost_noise: torch.Tensor) -> torch.Tensor:
    """A lower bound (f32) on any rescheduled block's realized cost: the
    K-event wave's safety margin.  ``schedule_block`` charges at least
    ``fl(min(min_edge_cost) * floor)`` (floor 0.1 under cost noise, else
    exactly 1), so a wave may take every lane ``j`` with ``f_(j) <
    fl(f_(0) + gap)``: no block an earlier lane reschedules can finish
    before it, and the processed order is the single-event program's."""
    floor = torch.where(cost_noise > 0, 0.1, 1.0).float()
    return min_edge_cost.amin() * floor


def staleness_alpha(base: torch.Tensor, version: torch.Tensor,
                    fetch_version: torch.Tensor,
                    n_edges: torch.Tensor) -> torch.Tensor:
    """The staleness-discounted mixing rate in f32: version staleness in
    epochs (``(version - fetch_version) / n_edges``, ``n_edges`` an f32
    tensor on the run's device, never a host scalar: CUDA divides by a
    host scalar through its reciprocal), then ``base / (1 + s)``."""
    s = (version - fetch_version).float() / n_edges
    return base / (1.0 + s)


def staleness_merge(global_params: Params, edge_params: Params,
                    alpha: torch.Tensor) -> Params:
    """The asynchronous global update ``G <- (1 - a) * G + a * theta_e``,
    f32 accumulation, cast back to the leaf dtype.  XLA fuses the first
    product into the sum (``fma(1 - a, G, a * theta_e)``); so does this."""
    def mix(g, e):
        return _fma32(1.0 - alpha, g.float(), alpha * e.float()).to(g.dtype)
    return tree_map(mix, global_params, edge_params)
