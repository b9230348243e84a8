"""The paper's testbed experiment (§V) end to end: heterogeneous edges
collaboratively train an SVM on wafer data under resource budgets,
comparing OL4EL-sync / OL4EL-async / AC-sync / Fixed-I, and UCB-BV1
under variable costs (noise 0.2).

    python -m repro_torch.bench.testbed [--heterogeneity 6] [--ingraph]
        [--device cpu]

The port of the reference's ``examples/el_svm_testbed.py``: the same
data (seed 0, Dirichlet split at alpha 1), recipe (lr 0.05, batch 64,
eval-gain utility) and rows.  ``--ingraph`` runs the ol4el-sync row
through the compiled sync round.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional

from repro_torch.bench.common import InitFor
from repro_torch.device import DeviceLike
from repro_torch.el import ELSession
from repro_torch.interop import params_from_numpy
from repro_torch.launch.classic import classic_fixture

ALGOS = [("ol4el", "sync"), ("ol4el", "async"), ("ac_sync", "sync"),
         ("fixed_i", "sync"), ("ucb_bv", "async")]


def run(heterogeneity: float = 6.0, n_edges: int = 3,
        budget: float = 5000.0, n_data: int = 8000, ingraph: bool = False,
        quiet: bool = False, init_for: Optional[InitFor] = None,
        device: DeviceLike = None) -> List[Dict]:
    """One row per algorithm: final accuracy, aggregations, consumption
    and the run's decisions (``(interval, edge)`` a record) and arm
    pulls.  The data is built once and every row's session shares it."""
    fx = classic_fixture("svm-wafer", samples=n_data, n_edges=n_edges,
                         alpha=1.0, data_seed=0, batch=64, lr=0.05,
                         device=device)
    init = (fx["init_params"] if init_for is None else
            params_from_numpy(init_for("svm", 0), fx["executor"].device))
    if not quiet:
        print(f"edges={n_edges} H={heterogeneity} budget={budget}/edge  "
              f"data={fx['n_samples']}")
        print(f"{'algorithm':16s} {'accuracy':>9s} {'aggregations':>13s} "
              f"{'consumed':>9s}")
    rows = []
    for policy, mode in ALGOS:
        variable = policy == "ucb_bv"
        ol = dataclasses.replace(
            fx["exp"].ol4el, mode=mode, policy=policy, n_edges=n_edges,
            budget=budget, heterogeneity=heterogeneity,
            utility="eval_gain",
            cost_model="variable" if variable else "fixed",
            cost_noise=0.2 if variable else 0.0)
        session = (ELSession(ol, metric_name="accuracy", lr=0.05)
                   .with_executor(fx["executor"], init_params=init,
                                  n_samples=fx["n_samples"]))
        try:
            res = (session.run_sync_ingraph()
                   if ingraph and (policy, mode) == ("ol4el", "sync")
                   else session.run())
        finally:
            session.close()
        rows.append(dict(figure="testbed", algo=f"{policy}-{mode}",
                         metric=res.final_metric,
                         n_aggregations=res.n_aggregations,
                         total_consumed=res.total_consumed,
                         decisions=[(r.interval, r.edge)
                                    for r in res.records],
                         arm_pulls=res.arm_pulls))
        if not quiet:
            print(f"{policy + '-' + mode:16s} {res.final_metric:9.4f} "
                  f"{res.n_aggregations:13d} {res.total_consumed:9.0f}",
                  flush=True)
    return rows


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--heterogeneity", type=float, default=6.0)
    ap.add_argument("--edges", type=int, default=3)
    ap.add_argument("--budget", type=float, default=5000.0)
    ap.add_argument("--samples", type=int, default=8000)
    ap.add_argument("--ingraph", action="store_true",
                    help="run the ol4el-sync row through the compiled "
                         "sync round")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    return run(args.heterogeneity, args.edges, args.budget, args.samples,
               ingraph=args.ingraph, device=args.device)


if __name__ == "__main__":
    main()
