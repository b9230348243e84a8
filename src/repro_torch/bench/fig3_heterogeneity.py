"""Fig. 3 replication: model accuracy vs edge heterogeneity (H = 1..15).

Paper setup: 3 heterogeneous edges, fixed per-edge budget (5000 ms ~ 5000
cost units), SVM (accuracy) and K-means (F1).  Algorithms: OL4EL-sync,
OL4EL-async, AC-sync [12], Fixed-I.

Paper claims (the reference's ``benchmarks/fig3_heterogeneity.py``):
  * accuracy degrades as H grows, for every algorithm;
  * OL4EL outperforms AC-sync and Fixed-I throughout;
  * OL4EL-sync wins at low H (<=5); OL4EL-async wins at high H;
  * peak OL4EL-async advantage over baselines ~ 12%.

Every run is a host loop (``ELSession.run``); ``on_run`` sees each
run's :class:`~repro_torch.bench.common.ELRun` as it ends.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.bench.common import (WORKLOADS, ELRun, InitFor,
                                      mean_over_seeds, run_el)
from repro_torch.device import DeviceLike

ALGOS = [("ol4el", "sync"), ("ol4el", "async"), ("ac_sync", "sync"),
         ("fixed_i", "sync")]
H_VALUES = [1.0, 3.0, 5.0, 6.0, 9.0, 12.0, 15.0]


def run(budget: float = 5000.0, n_data: int = 20000, seeds=(0, 1, 2),
        h_values=None, quiet: bool = False,
        init_for: Optional[InitFor] = None,
        on_run: Optional[Callable[[ELRun], None]] = None,
        device: DeviceLike = None) -> List[Dict]:
    def one(workload, policy, mode, h, seed):
        r = run_el(workload, policy, mode, h, budget=budget, n_data=n_data,
                   seed=seed, device=device,
                   init_params=init_for and init_for(workload, seed))
        if on_run is not None:
            on_run(r)
        return r

    rows = []
    for workload in WORKLOADS:
        for h in (h_values or H_VALUES):
            for policy, mode in ALGOS:
                agg = mean_over_seeds(
                    lambda seed: one(workload, policy, mode, h, seed),
                    seeds)
                row = dict(figure="fig3", workload=workload, H=h,
                           algo=f"{policy}-{mode}", **agg)
                rows.append(row)
                if not quiet:
                    print(f"fig3 {workload:6s} H={h:4.0f} "
                          f"{policy}-{mode:5s} metric={agg['metric']:.4f} "
                          f"(±{agg['metric_std']:.4f}) aggs={agg['aggs']:.0f}",
                          flush=True)
    return rows


if __name__ == "__main__":
    run()
