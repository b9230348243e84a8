"""Host-side materialization of ``ScenarioSpec`` into knob arrays.

A copy of the reference's ``repro.el.scenarios.schedule``: numpy only, so
the seeded ``default_rng`` schedules are the reference's bit for bit.

The scenario engine's whole contract with the device loops is three
extra knob arrays (plus, in sync mode, the policy selector):

- ``scn_active`` ``[period, n_edges]`` float32 0/1 — the activity
  schedule.  Round/event ``t`` reads row ``t % period``; a 0 means the
  edge is dropped out for that slot (zero masked work, zero aggregation
  weight, zero budget charge).
- ``scn_mult`` ``[period, n_edges]`` float32 > 0 — per-edge cost
  multipliers (heavy-tailed straggler spikes or replayed traces),
  composing with the base ``cost_noise`` model.
- ``scn_drift`` scalar float32 — non-stationary data drift rate for the
  minibatch sampler's rotating index window.
- ``policy_id`` scalar int32 (sync only) — selects the selection policy
  of the device policy switch (OL4EL bandit vs the task-allocation
  baselines, ``repro_torch.el.scenarios.baselines``), so one program
  benchmarks all of them.

Because these are ordinary knobs, everything downstream — sweep
stacking, the knob buffers a captured graph reads — works unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.config import OL4ELConfig
from repro_torch.el.scenarios.spec import ChurnSpec, CostSpec, ScenarioSpec

#: Extra traced inputs the scenario path appends to ``KNOB_NAMES`` /
#: ``ASYNC_KNOB_NAMES``.  ``policy_id`` rides only in sync mode (the
#: async program keeps the paper's per-edge OL4EL bandit).
SCENARIO_KNOB_NAMES = ("scn_active", "scn_mult", "scn_drift")


def scenario_knob_names(mode: str) -> tuple:
    """The knob names the scenario path appends for ``mode``."""
    if mode == "sync":
        return SCENARIO_KNOB_NAMES + ("policy_id",)
    return SCENARIO_KNOB_NAMES


def activity_schedule(churn: Optional[ChurnSpec], n_edges: int,
                      period: int) -> np.ndarray:
    """The ``[period, n_edges]`` 0/1 activity schedule for ``churn``.

    ``None`` means always-on.  Dropout schedules are seeded and
    deterministic (the host reference replay re-derives the same rows);
    every row keeps at least ``min_active`` edges alive — the
    lowest-index dropped edges are revived, so sync rounds always have a
    straggler to pace on and the aggregation weights never normalize
    over an empty set.
    """
    if churn is None:
        return np.ones((period, n_edges), np.float32)
    if churn.kind == "trace":
        rows = np.asarray(churn.trace, np.float32)
        if rows.shape[1] != n_edges:
            raise ValueError(
                f"churn trace rows have {rows.shape[1]} edges, config "
                f"has {n_edges}")
        act = (rows > 0).astype(np.float32)
    else:  # "dropout"
        rng = np.random.default_rng(churn.seed)
        act = (rng.random((churn.period, n_edges))
               >= churn.rate).astype(np.float32)
    min_active = max(1, min(int(churn.min_active), n_edges))
    for row in act:
        short = min_active - int(row.sum())
        if short > 0:
            row[np.flatnonzero(row == 0)[:short]] = 1.0
    reps = period // act.shape[0]
    return np.tile(act, (reps, 1)) if reps > 1 else act


def cost_schedule(cost: Optional[CostSpec], n_edges: int,
                  period: int) -> np.ndarray:
    """The ``[period, n_edges]`` cost-multiplier schedule for ``cost``.

    ``None`` means all-ones.  Heavy-tailed kinds draw once, seeded, and
    the compiled program replays the schedule cyclically — "trace-
    replayed" in the generated case too, which keeps the in-graph side a
    single gather and the reference replay exact.
    """
    if cost is None:
        return np.ones((period, n_edges), np.float32)
    if cost.kind == "trace":
        mult = np.asarray(cost.trace, np.float32)
        if mult.shape[1] != n_edges:
            raise ValueError(
                f"cost trace rows have {mult.shape[1]} edges, config "
                f"has {n_edges}")
    else:
        rng = np.random.default_rng(cost.seed)
        if cost.kind == "pareto":
            # inverse-CDF Pareto(alpha): multipliers >= 1, mean
            # alpha/(alpha-1) — pure straggler spikes
            u = rng.random((cost.period, n_edges))
            mult = (1.0 - u) ** (-1.0 / cost.alpha)
        else:  # "lognormal"
            mult = np.exp(cost.sigma * rng.standard_normal(
                (cost.period, n_edges)))
        mult = mult.astype(np.float32)
    reps = period // mult.shape[0]
    return np.tile(mult, (reps, 1)) if reps > 1 else mult


def scenario_knobs(cfg: OL4ELConfig) -> Dict[str, np.ndarray]:
    """Materialize ``cfg.scenario`` into its traced knob arrays.

    Called by ``sync_knobs`` / ``async_knobs`` when a scenario is set;
    the sweep engine therefore stacks scenario knobs along the cell axis
    automatically, and the fleet's knob dispatch picks them up through
    the same functions.  Sync mode appends ``policy_id`` (resolved from
    ``cfg.policy`` against the in-graph policy switch).
    """
    scn = cfg.scenario
    if not isinstance(scn, ScenarioSpec):
        raise TypeError(
            f"cfg.scenario must be a ScenarioSpec (or None), got "
            f"{type(scn).__name__}")
    period = scn.period
    knobs: Dict[str, np.ndarray] = {
        "scn_active": activity_schedule(scn.churn, cfg.n_edges, period),
        "scn_mult": cost_schedule(scn.cost, cfg.n_edges, period),
        "scn_drift": np.float32(scn.drift),
    }
    if cfg.mode == "sync":
        from repro_torch.el.scenarios.baselines import ingraph_policy_id
        knobs["policy_id"] = np.int32(ingraph_policy_id(cfg.policy))
    return knobs
