"""The device selection-policy switch: OL4EL vs task-allocation baselines.

The port of the reference's ``repro.el.scenarios.baselines``.  The
scenario sync round routes arm selection through this switch, selected
by the ``policy_id`` knob — so "OL4EL vs baselines under churn" is ONE
device loop with ``policy`` as an ordinary sweep axis, every cell sharing
the program and its captured graph.

Branch 0 is the OL4EL budget-limited UCB bandit, written with exactly
the ops the scenario-less round uses (``device_selection_weights`` →
log-weights → Gumbel-max).  Branches 1–2 are the task-allocation
baselines:

- ``task_alloc`` — modeled on "Adaptive task allocation for mobile edge
  learning" (arXiv 1811.03748): allocate the largest locally-feasible
  workload each round (max updates per global sync the budget still
  covers), adapting to the residual instead of learning utilities.
- ``delay_energy`` — modeled on the delay/energy-constrained task
  allocation of arXiv 2012.00143: pace consumption so the budget lasts,
  picking the arm whose cost best matches a geometric pace
  ``sqrt(residual * min_cost)`` between spending-it-all-now and the
  cheapest sustainable rate.

The reference dispatches with ``lax.switch``, which under ``vmap`` (a
sweep whose cells differ in ``policy_id``) evaluates every branch and
selects.  Here that is the only form: ``policy_id`` is a device tensor
that may differ per cell, so :func:`select_arm_switch` computes all three
arms and picks one with ``torch.where`` — no Python branch on a tensor,
which a CUDA graph capture and ``torch.func.vmap`` could not take.
Feasibility is guaranteed by the loop condition (the round only runs
while the binding edge can afford the cheapest arm), as in the bandit.

``INGRAPH_POLICY_ORDER`` is the switch's branch order and the single
source of truth for which policies the scenario round implements; the
host-loop counterparts are registered in ``repro_torch.el.policies``
under the same names.
"""

from __future__ import annotations

import torch

from repro_torch.core.bandit import device_arm_logits, device_selection_weights

#: branch order; index == the ``policy_id`` knob value.
INGRAPH_POLICY_ORDER = ("ol4el", "task_alloc", "delay_energy")


def ingraph_policy_id(name: str) -> int:
    """The ``policy_id`` knob value for a registry policy name."""
    if name not in INGRAPH_POLICY_ORDER:
        raise ValueError(
            f"policy {name!r} has no in-graph scenario branch; the "
            f"compiled policy switch implements {INGRAPH_POLICY_ORDER} "
            f"(other registry policies run host-side only)")
    return INGRAPH_POLICY_ORDER.index(name)


def _ol4el_arm(bstate, resid, costs, ucb_c, gumbel) -> torch.Tensor:
    # the exact selection ops of the scenario-less sync round
    w = device_selection_weights(bstate, resid, costs, ucb_c)
    return torch.argmax(gumbel + device_arm_logits(w))


def _task_alloc_arm(resid, costs) -> torch.Tensor:
    # largest feasible workload: arm order == interval order, so the max
    # feasible index is the max updates-per-sync the budget covers
    feasible = costs <= resid + 1e-12
    arms = torch.arange(costs.shape[0], device=costs.device)
    return torch.where(feasible, arms, -1).amax()


def _delay_energy_arm(resid, costs) -> torch.Tensor:
    # budget pacing: target cost = geometric mean of "spend the whole
    # residual now" and "spend the cheapest sustainable amount"
    min_c = costs.amin()
    pace = torch.sqrt(torch.maximum(resid, min_c) * min_c)
    feasible = costs <= resid + 1e-12
    score = torch.where(feasible, (costs - pace).abs(), torch.inf)
    return torch.argmin(score)


def select_arm_switch(policy_id: torch.Tensor, bstate, resid: torch.Tensor,
                      costs: torch.Tensor, ucb_c: torch.Tensor,
                      gumbel: torch.Tensor) -> torch.Tensor:
    """Device arm selection: every branch's arm, the one ``policy_id``
    names selected (int64 0-dim; ``gumbel`` [K] is the OL4EL draw, the
    baselines ignore it).  An id past the last branch takes the last, as
    ``lax.switch`` clamps it."""
    arms = (_ol4el_arm(bstate, resid, costs, ucb_c, gumbel),
            _task_alloc_arm(resid, costs),
            _delay_energy_arm(resid, costs))
    return torch.where(policy_id <= 0, arms[0],
                       torch.where(policy_id == 1, arms[1], arms[2]))
