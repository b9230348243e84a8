"""``ScenarioSpec`` — frozen, hashable fleet-dynamics configuration.

A copy of the reference's ``repro.el.scenarios.spec`` on the port's
``OL4ELConfig``, every validation message included.

Real edge fleets are not the fixed, always-on fleet the base simulator
assumes: devices drop out and reconnect (churn), per-block costs spike
heavy-tailed (stragglers), and local data distributions drift.  A
``ScenarioSpec`` describes those dynamics declaratively; the scenario
engine (``repro_torch.el.scenarios.schedule``) materializes it host-side
into ``[period, n_edges]`` schedule knobs that enter the device loops
exactly like every other control-plane input — so one program (and one
captured CUDA graph) serves any churn rate / cost trace, and
``repro_torch.el.sweep`` can stack scenario points along the cell axis.

The spec is frozen + hashable on purpose: it lives on
``OL4ELConfig.scenario`` and therefore joins the session's program-cache
keys via ``ELSession._structural_cfg`` — but only its *structural*
residue (the schedule ``period``, which sizes the knob arrays, and
whether the scenario is on at all).  Rates, seeds and trace values are
knob VALUES: :meth:`ScenarioSpec.structural` normalizes them away so
nearby scenario points share one program.

``scenario=None`` (the default everywhere) builds the scenario-less
programs op for op — the scenario branch is absent.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

#: default schedule period (rounds sync / events async) before the
#: pattern repeats; structural (it sizes the [period, n_edges] knobs).
DEFAULT_PERIOD = 64

#: churn schedule generators
CHURN_KINDS = ("dropout", "trace")
#: per-edge cost-multiplier models (heavy-tailed draws are materialized
#: host-side into a replayed [period, n_edges] schedule)
COST_KINDS = ("pareto", "lognormal", "trace")


@dataclasses.dataclass(frozen=True)
class ChurnSpec:
    """Per-edge activity schedule: who is in the fleet each round/event.

    ``kind="dropout"`` draws an i.i.d. Bernoulli schedule — each edge is
    *inactive* with probability ``rate`` in each of the ``period`` slots
    (seeded, so the schedule is reproducible and sweepable); at least
    ``min_active`` edges stay active in every slot (the lowest-index
    dropped edges are revived).  ``kind="trace"`` replays an explicit
    0/1 schedule (``trace`` holds ``period`` rows of ``n_edges``
    flags — join/leave/reconnect patterns from real fleet logs).
    """

    kind: str = "dropout"
    rate: float = 0.1
    period: int = DEFAULT_PERIOD
    min_active: int = 1
    seed: int = 0
    trace: Tuple[Tuple[int, ...], ...] = ()

    def __post_init__(self):
        if self.kind not in CHURN_KINDS:
            raise ValueError(
                f"ChurnSpec.kind must be one of {CHURN_KINDS}, got "
                f"{self.kind!r}")
        if not 0.0 <= self.rate < 1.0:
            raise ValueError(
                f"ChurnSpec.rate is a per-slot dropout probability and "
                f"must be in [0, 1), got {self.rate}")
        if self.trace:
            object.__setattr__(self, "trace",
                               tuple(tuple(int(v) for v in row)
                                     for row in self.trace))
            object.__setattr__(self, "period", len(self.trace))
        if self.period < 1:
            raise ValueError(
                f"ChurnSpec.period must be >= 1, got {self.period}")
        if self.kind == "trace" and not self.trace:
            raise ValueError("ChurnSpec(kind='trace') needs trace= rows")


@dataclasses.dataclass(frozen=True)
class CostSpec:
    """Per-edge cost-multiplier schedule: stragglers and trace replay.

    Heavy-tailed kinds draw a seeded ``[period, n_edges]`` multiplier
    schedule host-side — ``"pareto"`` via inverse-CDF
    ``(1-u)^(-1/alpha)`` (multipliers >= 1: pure straggler spikes),
    ``"lognormal"`` via ``exp(sigma * N(0,1))`` — which the compiled
    program replays cyclically; ``"trace"`` replays explicit multiplier
    rows (e.g. measured per-device round times normalized to their
    mean).  Multipliers compose with the base ``cost_noise`` knob.
    """

    kind: str = "pareto"
    alpha: float = 2.0
    sigma: float = 0.5
    period: int = DEFAULT_PERIOD
    seed: int = 0
    trace: Tuple[Tuple[float, ...], ...] = ()

    def __post_init__(self):
        if self.kind not in COST_KINDS:
            raise ValueError(
                f"CostSpec.kind must be one of {COST_KINDS}, got "
                f"{self.kind!r}")
        if self.alpha <= 1.0:
            raise ValueError(
                f"CostSpec.alpha is a Pareto tail index and must be > 1 "
                f"(finite mean), got {self.alpha}")
        if self.sigma < 0.0:
            raise ValueError(
                f"CostSpec.sigma must be >= 0, got {self.sigma}")
        if self.trace:
            object.__setattr__(self, "trace",
                               tuple(tuple(float(v) for v in row)
                                     for row in self.trace))
            object.__setattr__(self, "period", len(self.trace))
        if self.period < 1:
            raise ValueError(
                f"CostSpec.period must be >= 1, got {self.period}")
        if self.kind == "trace":
            if not self.trace:
                raise ValueError("CostSpec(kind='trace') needs trace= rows")
            if any(v <= 0 for row in self.trace for v in row):
                raise ValueError(
                    "CostSpec trace multipliers must be positive")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One fleet-dynamics scenario: churn x cost spikes x data drift.

    All three parts default off — ``ScenarioSpec()`` is the *identity*
    scenario (every edge active, all multipliers 1, no drift): it runs
    the scenario-path program (mask-aware aggregation, the policy
    switch), which is numerically equivalent to — but a different
    compiled program from — ``scenario=None``.  Only ``scenario=None``
    is bit-identical to the pre-scenario programs.

    ``drift`` is non-stationary data drift: each round/event ``t`` the
    minibatch sampler's index window rotates by
    ``floor(drift * t * n_samples_e)`` positions, so the effective
    local distribution moves over the edge's shard (``0.0`` = i.i.d.
    sampling, today's behavior).
    """

    churn: Optional[ChurnSpec] = None
    cost: Optional[CostSpec] = None
    drift: float = 0.0

    def __post_init__(self):
        if self.drift < 0.0:
            raise ValueError(
                f"ScenarioSpec.drift must be >= 0, got {self.drift}")

    @property
    def period(self) -> int:
        """The combined schedule length (the lcm of the parts' periods):
        the static leading dim of the materialized ``[period, n_edges]``
        scenario knobs — structural, like a telemetry ring size."""
        parts = [p.period for p in (self.churn, self.cost)
                 if p is not None]
        if not parts:
            return 1
        return math.lcm(*parts)

    def structural(self) -> "ScenarioSpec":
        """The compile-relevant residue: rates/seeds/trace values are
        knob VALUES (they only change the materialized schedule arrays),
        so they normalize away — only the schedule period (it sizes the
        traced arrays) and which parts are present survive into compile
        cache / cohort keys."""
        return ScenarioSpec(
            churn=(None if self.churn is None
                   else ChurnSpec(period=self.churn.period)),
            cost=(None if self.cost is None
                  else CostSpec(period=self.cost.period)),
            drift=0.0)


def as_scenario(scenario) -> Optional[ScenarioSpec]:
    """Normalize a user-facing scenario value: ``None``/``False`` → off
    (the programs compile bit-identical to the scenario-less ones), a
    ``ScenarioSpec`` passes through, ``True`` → the identity scenario.
    Anything else is a ``TypeError`` naming the accepted spellings."""
    if scenario is None or scenario is False:
        return None
    if scenario is True:
        return ScenarioSpec()
    if isinstance(scenario, ScenarioSpec):
        return scenario
    raise TypeError(
        f"scenario= expects None/bool/ScenarioSpec, got "
        f"{type(scenario).__name__}")
