"""Fig. 4 replication: model accuracy vs edge resource consumption (H=6).

The paper plots the metric as resource consumption accumulates: all
algorithms improve with more resource, OL4EL dominating AC-sync at every
consumption level and OL4EL-async reaching the highest final accuracy.

Each row takes the reference's route.  The SVM (ol4el, sync) rows run
through the compiled sweep (``repro_torch.el.sweep``), one one-cell
sweep per seed (a fig4 seed resamples the dataset/partition/init, which
are program constants), with the consumption curves reduced from the
cell's round records.  The SVM (ol4el, async) rows run through the
compiled event engine (``run_async_ingraph``).  The other algorithms
(non-ol4el policies) stay on the host loops, and so does the K-means
workload (its F1 metric is host-side).  ``draws_for`` feeds the two
compiled rows' RNG seam.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.bench.common import (WORKLOADS, DrawsFor, InitFor, run_el,
                                      run_el_sweep)
from repro_torch.device import DeviceLike
from repro_torch.el.sweep import SweepSpec

ALGOS = [("ol4el", "sync"), ("ol4el", "async"), ("ac_sync", "sync"),
         ("fixed_i", "sync")]
FRACTIONS = [0.2, 0.4, 0.6, 0.8, 1.0]


def _best_at_fractions(metrics: Sequence[float],
                       consumed: Sequence[float]) -> List[float]:
    """Best metric achieved by each consumption fraction (the host and
    sweep rows share this reduction)."""
    total = consumed[-1] if len(consumed) else 0.0
    curve, best = [], 0.0
    for frac in FRACTIONS:
        target = frac * total
        vals = [m for m, c in zip(metrics, consumed)
                if c <= target and np.isfinite(m)]
        best = max(vals) if vals else best
        curve.append(best)
    return curve


def run(budget: float = 5000.0, n_data: int = 20000,
        heterogeneity: float = 6.0, seeds=(0, 1, 2), quiet: bool = False,
        init_for: Optional[InitFor] = None,
        draws_for: Optional[DrawsFor] = None,
        device: DeviceLike = None) -> List[Dict]:
    rows = []
    for workload in WORKLOADS:
        for policy, mode in ALGOS:
            curves = []
            for seed in seeds:
                init = init_for and init_for(workload, seed)
                if (policy, mode) == ("ol4el", "sync") and workload == "svm":
                    rep = run_el_sweep(
                        workload, SweepSpec(seeds=(seed,), max_rounds=256),
                        heterogeneity, budget=budget, seed=seed,
                        n_data=n_data, init_params=init,
                        draws_for=draws_for, device=device)
                    n = int(rep.out["n_rounds"][0])
                    curves.append(_best_at_fractions(
                        rep.out["metric"][0][:n],
                        rep.out["consumed"][0][:n]))
                    continue
                # the (ol4el, async) SVM rows get the compiled event
                # engine; everything else is host-driven
                fast = ((policy, mode) == ("ol4el", "async")
                        and workload == "svm")
                r = run_el(workload, policy, mode, heterogeneity,
                           budget=budget, n_data=n_data, seed=seed,
                           ingraph=fast, init_params=init,
                           draws_for=draws_for, device=device)
                curves.append(_best_at_fractions(
                    [rec.metric for rec in r.records],
                    [rec.total_consumed for rec in r.records]))
            mean_curve = np.mean(np.asarray(curves), axis=0)
            for frac, v in zip(FRACTIONS, mean_curve):
                rows.append(dict(figure="fig4", workload=workload,
                                 algo=f"{policy}-{mode}",
                                 consumption_frac=frac, metric=float(v)))
            if not quiet:
                curve_s = " ".join(f"{v:.3f}" for v in mean_curve)
                print(f"fig4 {workload:6s} {policy}-{mode:5s} "
                      f"metric@{FRACTIONS}: {curve_s}", flush=True)
    return rows


if __name__ == "__main__":
    run()
