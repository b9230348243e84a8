"""Run artifacts of the EL runtime: per-round records + the final report.

The functions that turn a compiled program's history arrays into these
(``records_from_out`` / ``report_from_out`` in the reference) come with
the compiled-program slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


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
