"""Shared argparse glue for the fleet-dynamics scenario flags.

A copy of the reference's ``repro.el.scenarios.cli``.  Both launchers
(``repro_torch.launch.train`` / ``repro_torch.launch.sweep``) speak the
same scenario dialect:

    --churn 0.2                      # Bernoulli dropout schedule
    --churn-period 64                # schedule length before repeat
    --cost-model pareto              # straggler spikes (heavy-tailed)
    --cost-model trace:times.txt     # replay measured multipliers
    --drift 0.01                     # non-stationary data drift

``--cost-model`` keeps its classic values (``fixed`` / ``variable`` —
the base i.i.d. noise model) and gains the scenario cost KINDS: a
scenario kind leaves the base model ``fixed`` and rides in as a
``CostSpec`` multiplier schedule instead (the two compose — see
``repro_torch.el.ingraph.support_matrix``).  A trace file is whitespace-
separated rows (``numpy.loadtxt``): one column broadcasts one
multiplier per slot to every edge, ``n_edges`` columns give per-edge
rows.
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple

import numpy as np

from repro_torch.el.scenarios.spec import (ChurnSpec, CostSpec, DEFAULT_PERIOD,
                                     ScenarioSpec)

__all__ = ["add_scenario_args", "scenario_from_args",
           "BASE_COST_MODELS", "SCENARIO_COST_KINDS"]

#: the classic cfg.cost_model values (no scenario involved)
BASE_COST_MODELS = ("fixed", "variable")
#: --cost-model values routed into a CostSpec multiplier schedule
SCENARIO_COST_KINDS = ("pareto", "lognormal")


def _cost_model_value(value: str) -> str:
    v = str(value)
    if (v in BASE_COST_MODELS or v in SCENARIO_COST_KINDS
            or v.startswith("trace:")):
        return v
    raise argparse.ArgumentTypeError(
        f"--cost-model must be one of {BASE_COST_MODELS} (base noise "
        f"models), {SCENARIO_COST_KINDS} (scenario straggler schedules) "
        f"or trace:<path>, got {value!r}")


def add_scenario_args(ap: argparse.ArgumentParser, *,
                      cost_model_default: str = "fixed") -> None:
    """Install the scenario flag group (idempotent per parser)."""
    g = ap.add_argument_group(
        "fleet dynamics (repro_torch.el.scenarios; any flag set compiles the "
        "scenario-path program — omit all for today's bit-identical one)")
    g.add_argument("--churn", type=float, default=None, metavar="RATE",
                   help="per-slot edge dropout probability in [0, 1): "
                        "draws a seeded Bernoulli activity schedule; "
                        "dropped edges run zero work, are not charged, "
                        "and rejoin per the schedule")
    g.add_argument("--churn-period", type=int, default=DEFAULT_PERIOD,
                   help="churn/cost schedule length in rounds (sync) or "
                        f"events (async) before it repeats (default "
                        f"{DEFAULT_PERIOD}; structural — it sizes the "
                        "traced schedule arrays)")
    g.add_argument("--cost-model", type=_cost_model_value,
                   default=cost_model_default,
                   help="fixed|variable (base noise model) or a scenario "
                        "straggler schedule: pareto|lognormal|"
                        "trace:<path> (whitespace rows of per-slot cost "
                        "multipliers; 1 or n_edges columns)")
    g.add_argument("--drift", type=float, default=None, metavar="RATE",
                   help="non-stationary data drift: each round t rotates "
                        "every edge's minibatch window by "
                        "drift*t*n_samples positions (0 = i.i.d.)")


def _cost_spec_from(value: str, period: int) -> Optional[CostSpec]:
    if value in BASE_COST_MODELS:
        return None
    if value.startswith("trace:"):
        path = value[len("trace:"):]
        rows = np.atleast_1d(np.loadtxt(path, dtype=np.float64))
        if rows.ndim == 1:
            rows = rows[:, None]
        return CostSpec(kind="trace",
                        trace=tuple(tuple(r) for r in rows))
    return CostSpec(kind=value, period=period)


def scenario_from_args(args) -> Tuple[Optional[ScenarioSpec], str]:
    """Resolve the flag group → ``(scenario_or_none, base_cost_model)``.

    ``base_cost_model`` is what ``cfg.cost_model`` should carry
    (``fixed``/``variable``); a scenario ``--cost-model`` kind maps to
    ``fixed`` there and to a ``CostSpec`` here.  Returns ``(None,
    base)`` when no scenario flag was touched, so default invocations
    build exactly today's programs.
    """
    period = int(args.churn_period)
    if period < 1:
        raise SystemExit(f"--churn-period must be >= 1, got {period}")
    churn = (None if args.churn is None
             else ChurnSpec(rate=float(args.churn), period=period))
    cost = _cost_spec_from(args.cost_model, period)
    base = args.cost_model if args.cost_model in BASE_COST_MODELS \
        else "fixed"
    drift = 0.0 if args.drift is None else float(args.drift)
    if churn is None and cost is None and drift == 0.0:
        return None, base
    return ScenarioSpec(churn=churn, cost=cost, drift=drift), base
