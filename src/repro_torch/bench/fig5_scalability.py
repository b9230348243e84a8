"""Fig. 5 replication: model accuracy vs number of edge servers (3..100).

Paper claims: OL4EL-async improves with more edges; accuracy drops with
heterogeneity; OL4EL-sync is best at H=1 but degrades dramatically at
H=15 (worse than async) because sync waits for the slowest edge.

Every run is a host loop (``ELSession.run``); ``on_run`` sees each
run's :class:`~repro_torch.bench.common.ELRun` as it ends.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.bench.common import (WORKLOADS, ELRun, InitFor,
                                      mean_over_seeds, run_el)
from repro_torch.device import DeviceLike

EDGE_COUNTS = [3, 10, 30, 100]
H_VALUES = [1.0, 5.0, 15.0]


def run(budget: float = 600.0, n_data: int = 20000, seeds=(0, 1),
        edge_counts=None, h_values=None, quiet: bool = False,
        init_for: Optional[InitFor] = None,
        on_run: Optional[Callable[[ELRun], None]] = None,
        device: DeviceLike = None) -> List[Dict]:
    # Slow-convergence regime (small lr/batch): convergence stays
    # budget-bound so the paper's edge-count scaling is visible instead of
    # every configuration saturating.
    def one(workload, mode, n_edges, h, seed):
        r = run_el(workload, "ol4el", mode, h, n_edges=n_edges,
                   budget=budget, n_data=n_data, seed=seed,
                   lr=0.008 if workload == "svm" else 0.5, batch=32,
                   device=device,
                   init_params=init_for and init_for(workload, seed))
        if on_run is not None:
            on_run(r)
        return r

    rows = []
    for workload in WORKLOADS:
        for n_edges in (edge_counts or EDGE_COUNTS):
            for h in (h_values or H_VALUES):
                for mode in ("async", "sync"):
                    agg = mean_over_seeds(
                        lambda seed: one(workload, mode, n_edges, h, seed),
                        seeds)
                    rows.append(dict(figure="fig5", workload=workload,
                                     n_edges=n_edges, H=h,
                                     algo=f"ol4el-{mode}", **agg))
                    if not quiet:
                        print(f"fig5 {workload:6s} E={n_edges:3d} H={h:4.0f} "
                              f"ol4el-{mode:5s} metric={agg['metric']:.4f}",
                              flush=True)
    return rows


if __name__ == "__main__":
    run()
