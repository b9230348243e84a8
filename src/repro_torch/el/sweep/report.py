"""``SweepReport`` — reductions over a sweep's per-cell round records.

A copy of the reference's ``repro.el.sweep.report`` (numpy), with the
port's tree helpers for the stacked final params and the device loop's
counters in ``telemetry``.

The raw engine output is a dict of ``[n_cells, ...]`` arrays (metric /
consumed / interval per round, plus per-cell terminal scalars).  The
report reduces those into the artifacts the paper's figures are made of:

  * **learning curves** — mean ± 95% CI over the seed axis for every
    hyperparameter point (Fig. 3/4-style accuracy-vs-consumption);
  * **Pareto frontier** — the non-dominated (resource consumed, final
    accuracy) cells (the Fig. 5 trade-off view);
  * flat rows for the benchmark CSV contract.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.el.sweep.spec import AXIS_ORDER, SweepSpec

_GROUP_AXES = tuple(a for a in AXIS_ORDER if a != "seed")


def _nan_reduce(fn, rows: np.ndarray) -> np.ndarray:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # all-NaN columns
        return fn(rows, axis=0)


@dataclasses.dataclass
class SweepReport:
    """Results of one compiled ablation sweep.

    ``cells`` is the flattened row-major grid (seed fastest); ``out``
    holds the stacked per-cell device outputs pulled to numpy:
    ``metric`` / ``utility`` / ``interval`` / ``consumed`` / ``wall``
    ``[n_cells, max_rounds]`` and ``n_rounds`` ``[n_cells]``,
    ``budgets_left`` ``[n_cells, E]``, ``arm_pulls`` ``[n_cells, K]``,
    ``wall_time`` ``[n_cells]``.  Async grids add per-event ``edge`` /
    ``cost`` histories and per-edge ``arm_pulls`` ``[n_cells, E, K]``
    ("rounds" are merge events there).  Rounds past a cell's termination
    hold NaN metrics (never observed), which the reductions respect.
    """

    spec: SweepSpec
    axes: Dict[str, Tuple]
    cells: List[Dict[str, float]]
    out: Dict[str, np.ndarray]
    policy: str = "ol4el"
    elapsed_s: float = 0.0
    final_params: Any = None
    #: ``"cache"``: the session's ``ProgramCache.stats()``;
    #: ``"device_loops"``: each sub-sweep's ``ChunkRunner.last_run``
    #: (chunks, graphs captured, replays, batched launches a graph)
    telemetry: Optional[Dict[str, Any]] = None

    @property
    def n_cells(self) -> int:
        return len(self.cells)

    # -- per-cell terminals --------------------------------------------------

    def n_rounds(self) -> np.ndarray:
        return np.asarray(self.out["n_rounds"], np.int64)

    def _at_last_round(self, name: str) -> np.ndarray:
        vals = np.asarray(self.out[name], np.float64)
        n = self.n_rounds()
        idx = np.maximum(n - 1, 0)
        picked = vals[np.arange(self.n_cells), idx]
        return np.where(n > 0, picked, np.nan)

    def final_metrics(self) -> np.ndarray:
        """Metric after each cell's last aggregation, [n_cells].  Falls
        back to the host-side final-params scores
        (``score_final_params``) when the workload had no device
        in-graph metric."""
        vals = self._at_last_round("metric")
        if np.isnan(vals).all() and "final_metric_host" in self.out:
            return np.asarray(self.out["final_metric_host"], np.float64)
        return vals

    def score_final_params(self, eval_fn) -> bool:
        """Host-side scoring fallback: when the compiled program had no
        in-graph metric (all-NaN history), score each cell's final params
        with ``eval_fn(params) -> float`` and record the results.  No-op
        (returns False) when the in-graph metric exists."""
        if self.final_params is None:
            return False
        if not np.isnan(self._at_last_round("metric")).all():
            return False
        from repro_torch.interop import tree_map
        self.out["final_metric_host"] = np.asarray(
            [eval_fn(tree_map(lambda x: x[i], self.final_params))
             for i in range(self.n_cells)], np.float64)
        return True

    def total_consumed(self) -> np.ndarray:
        """Total resource consumed (summed over edges), [n_cells]."""
        cons = self._at_last_round("consumed")
        return np.where(np.isnan(cons), 0.0, cons)

    def truncated(self) -> np.ndarray:
        """Per-cell flag: the history cap (``spec.max_rounds``) cut the
        run short of budget exhaustion, so that cell's final metric /
        consumption are mid-run values.  Async cells report this exactly
        (the program's ``n_active`` counts blocks still in flight at
        exit); sync cells fall back to the round-cap heuristic.  Raise
        ``max_rounds`` (async: toward
        ``repro_torch.el.events.padded_event_horizon``) for full runs."""
        if "n_active" in self.out:
            return np.asarray(self.out["n_active"]) > 0
        return self.n_rounds() >= self.spec.max_rounds

    # -- seed-axis reductions ------------------------------------------------

    def _seed_groups(self) -> List[Tuple[Dict[str, float], List[int]]]:
        groups: Dict[Tuple, List[int]] = {}
        keys: Dict[Tuple, Dict[str, float]] = {}
        for i, cell in enumerate(self.cells):
            k = tuple(cell[a] for a in _GROUP_AXES)
            groups.setdefault(k, []).append(i)
            keys[k] = {a: cell[a] for a in _GROUP_AXES}
        return [(keys[k], idx) for k, idx in groups.items()]

    def learning_curves(self) -> List[Dict[str, Any]]:
        """Mean ± 95% CI learning curves over the seed axis, one entry per
        (ucb_c, budget, heterogeneity) point.  Round *t* aggregates only
        the seeds still alive at *t* — alive means ``t < n_rounds[cell]``,
        so the consumed curve stays meaningful even for workloads whose
        in-graph metric history is all-NaN (no device metric)."""
        metric = np.asarray(self.out["metric"], np.float64)
        consumed = np.asarray(self.out["consumed"], np.float64)
        n_rounds = self.n_rounds()
        n_cols = metric.shape[1]
        curves = []
        for key, idx in self._seed_groups():
            alive = (np.arange(n_cols)[None, :]
                     < n_rounds[idx][:, None])       # [S, R]
            rows = np.where(alive, metric[idx], np.nan)
            n_alive = alive.sum(0)
            mean = _nan_reduce(np.nanmean, rows)
            std = _nan_reduce(np.nanstd, rows)
            ci95 = np.where(n_alive > 1,
                            1.96 * std / np.sqrt(np.maximum(n_alive, 1)),
                            0.0)
            r_max = int(n_rounds[idx].max())
            curves.append({
                **key,
                "n_seeds": len(idx),
                "rounds": r_max,
                "mean": mean[:r_max],
                "ci95": ci95[:r_max],
                "consumed": _nan_reduce(np.nanmean,
                                        np.where(alive, consumed[idx],
                                                 np.nan))[:r_max],
            })
        return curves

    def grouped_rows(self) -> List[Dict[str, float]]:
        """Seed-mean summary per (ucb_c, budget, heterogeneity) point."""
        finals = self.final_metrics()
        consumed = self.total_consumed()
        rows = []
        for key, idx in self._seed_groups():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                m = float(np.nanmean(finals[idx]))
                s = float(np.nanstd(finals[idx]))
            rows.append({**key, "n_seeds": len(idx), "final_metric": m,
                         "final_metric_std": s,
                         "total_consumed": float(np.mean(consumed[idx]))})
        return rows

    # -- the accuracy-vs-resource trade-off ----------------------------------

    def pareto_frontier(self, group_seeds: bool = True
                        ) -> List[Dict[str, float]]:
        """Non-dominated (total consumed ↓, final metric ↑) points.

        With ``group_seeds`` (default) each hyperparameter point enters as
        its seed-mean before domination is applied, so the frontier is
        over configurations, not lucky seeds."""
        if group_seeds:
            points = self.grouped_rows()
        else:
            finals = self.final_metrics()
            consumed = self.total_consumed()
            points = [{**cell, "final_metric": float(finals[i]),
                       "total_consumed": float(consumed[i])}
                      for i, cell in enumerate(self.cells)]
        points = [p for p in points if np.isfinite(p["final_metric"])]
        points.sort(key=lambda p: (p["total_consumed"],
                                   -p["final_metric"]))
        frontier, best = [], -np.inf
        for p in points:
            if p["final_metric"] > best:
                frontier.append(p)
                best = p["final_metric"]
        return frontier

    # -- export --------------------------------------------------------------

    def to_rows(self) -> List[Dict[str, float]]:
        """One flat dict per cell (the benchmark CSV contract)."""
        finals = self.final_metrics()
        consumed = self.total_consumed()
        n_rounds = self.n_rounds()
        return [{**cell,
                 "final_metric": float(finals[i]),
                 "total_consumed": float(consumed[i]),
                 "n_rounds": int(n_rounds[i]),
                 "wall_time": float(self.out["wall_time"][i])}
                for i, cell in enumerate(self.cells)]

    def best_cell(self) -> Optional[Dict[str, float]]:
        finals = self.final_metrics()
        if not np.isfinite(finals).any():
            return None
        return self.to_rows()[int(np.nanargmax(finals))]

    def summary(self) -> str:
        finals = self.final_metrics()
        ok = np.isfinite(finals)
        lo = float(np.nanmin(finals)) if ok.any() else float("nan")
        hi = float(np.nanmax(finals)) if ok.any() else float("nan")
        trunc = int(self.truncated().sum())
        return (f"sweep[{self.policy}] {self.n_cells} cells "
                f"({', '.join(f'{k}×{len(v)}' for k, v in self.axes.items())}"
                f"): metric {lo:.4f}..{hi:.4f}, "
                f"{len(self.pareto_frontier())} Pareto points, "
                f"{self.elapsed_s:.1f}s"
                + (f" [{trunc} cells truncated at max_rounds="
                   f"{self.spec.max_rounds}]" if trunc else ""))
