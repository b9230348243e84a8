"""Run artifacts of the EL runtime: per-round records + the final report,
plus the builders that turn a compiled program's ``out`` dict (its history
arrays, read back to the host once) into them."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class RoundRecord:
    """One global aggregation (sync round or async merge event)."""

    wall_time: float
    total_consumed: float
    metric: float
    utility: float
    interval: float            # mean interval this event/round
    edge: int                  # -1 for sync rounds
    n_aggregations: int


@dataclasses.dataclass
class ELReport:
    """What an ``ELSession`` run returns: the records, the final metric,
    consumption, provenance (policy/mode), the bandit's arm-pull histogram
    and the host wall-clock the run took."""

    records: List[RoundRecord]
    final_metric: float
    n_aggregations: int
    total_consumed: float
    wall_time: float
    terminated_reason: str
    policy: str = ""
    mode: str = ""
    arm_pulls: Optional[List[int]] = None
    elapsed_s: float = 0.0
    final_params: Any = None           # the trained global model
    #: observability payload: ``"cache"`` holds the session's
    #: ``ProgramCache.stats()`` snapshot on compiled runs, ``"device_loop"``
    #: the compiled run's chunks (host syncs), graphs and replays.
    telemetry: Optional[Dict[str, Any]] = None
    #: a compiled run's ``out`` dict (numpy history arrays: per-round
    #: ``interval``, ``consumed``, ``wall``, a scenario's
    #: ``active_edges``, ...), what ``repro_torch.el.scenarios.
    #: verify_sync_replay`` checks; None on the host loops.
    raw: Optional[Dict[str, Any]] = None

    def metric_at_consumption(self, budget_frac: float,
                              total_budget: float) -> float:
        """Metric achieved by the time a consumption level is reached."""
        target = budget_frac * total_budget
        best = 0.0
        for r in self.records:
            if r.total_consumed <= target:
                best = r.metric
        return best

    def to_dict(self) -> Dict:
        return {
            "policy": self.policy,
            "mode": self.mode,
            "final_metric": self.final_metric,
            "n_aggregations": self.n_aggregations,
            "total_consumed": self.total_consumed,
            "wall_time": self.wall_time,
            "terminated_reason": self.terminated_reason,
            "arm_pulls": self.arm_pulls,
            "elapsed_s": self.elapsed_s,
        }

    def summary(self) -> str:
        return (f"{self.policy or '?'}-{self.mode or '?'}: "
                f"metric={self.final_metric:.4f} "
                f"aggs={self.n_aggregations} "
                f"consumed={self.total_consumed:.0f} "
                f"({self.terminated_reason})")


def records_from_out(out: Dict[str, Any], lo: int, hi: int, *,
                     base: int = 0) -> List[RoundRecord]:
    """``RoundRecord``s for rounds or events ``[lo, hi)`` of a compiled
    program's history arrays (sync histories have no ``edge`` array:
    their records get ``-1``); ``base`` is the round the arrays' first
    row holds (a fleet wave reads only the rows it added)."""
    edge = out.get("edge")
    return [
        RoundRecord(float(out["wall"][t - base]),
                    float(out["consumed"][t - base]),
                    float(out["metric"][t - base]),
                    float(out["utility"][t - base]),
                    float(out["interval"][t - base]),
                    int(edge[t - base]) if edge is not None else -1, t + 1)
        for t in range(lo, hi)
    ]


def report_from_out(out: Dict[str, Any], *, mode: str, policy: str,
                    horizon: int, final_metric: float, final_params: Any,
                    elapsed_s: float,
                    records: Optional[List[RoundRecord]] = None
                    ) -> ELReport:
    """Assemble an :class:`ELReport` from a compiled program's ``out``.

    The termination reason comes from ``n_active`` when present (the
    async blocks in flight at exit), else from the round count against
    ``horizon``; async ``[E, K]`` arm pulls are summed to the sync ``[K]``
    histogram shape.  A run with rings on carries ``out["telemetry"]`` to
    ``report.telemetry["rings"]`` as numpy."""
    from repro_torch.interop import tree_map
    n = int(out["n_rounds"])
    if records is None:
        records = records_from_out(out, 0, n)
    pulls = np.asarray(out["arm_pulls"])
    if pulls.ndim == 2:                                # async [E, K] -> [K]
        pulls = pulls.sum(axis=0)
    if "n_active" in out:
        reason = ("budget_exhausted" if int(out["n_active"]) == 0
                  else "max_events")
    else:
        reason = "max_rounds" if n >= horizon else "budget_exhausted"
    telemetry = None
    if "telemetry" in out:                 # the device rings, on the host
        telemetry = {"rings": tree_map(np.asarray, dict(out["telemetry"]))}
    return ELReport(
        records=records,
        final_metric=float(final_metric),
        n_aggregations=n,
        total_consumed=float(out["consumed"][n - 1]) if n else 0.0,
        wall_time=float(out["wall_time"]),
        terminated_reason=reason,
        policy=policy,
        mode=mode,
        arm_pulls=[int(c) for c in pulls],
        elapsed_s=elapsed_s,
        final_params=final_params,
        telemetry=telemetry,
    )
