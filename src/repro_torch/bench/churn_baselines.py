"""OL4EL vs task-allocation baselines under fleet churn.

The paper's comparison (§V) runs against static task-allocation
schemes; this benchmark replays it under the fleet dynamics a real edge
deployment has — edges dropping out and rejoining on a seeded Bernoulli
schedule — using the scenario engine (``repro_torch.el.scenarios``).
The whole (policy × churn_rate × seed) grid runs as ONE device loop:
``policy`` rides the ``policy_id`` knob through the device policy switch
(``repro_torch.el.scenarios.baselines``) and ``churn_rate`` re-draws the
``scn_active`` schedule per cell, so every cell shares the program.

Policies (the device policy switch, branch order fixed):
  * ol4el        — the paper's budget-limited UCB bandit
  * task_alloc   — greedy max-feasible workload (arXiv 1811.03748 style)
  * delay_energy — delay/energy budget pacing (arXiv 2012.00143 style)

Output: one row per (policy, churn_rate) with the seed-mean final
accuracy and consumption.  ``--smoke`` shrinks the grid to a proof that
the multi-policy scenario sweep runs and every cell finishes.

    python -m repro_torch.bench.churn_baselines [--smoke] [--out PATH]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.bench.common import DrawsFor, InitFor, run_el_sweep
from repro_torch.device import DeviceLike
from repro_torch.el.scenarios import (INGRAPH_POLICY_ORDER, ChurnSpec,
                                      ScenarioSpec)
from repro_torch.el.sweep import SweepSpec

DEFAULT_RATES = (0.0, 0.2, 0.4)
#: the port's own record; the JAX package's is BENCH_churn_baselines.json
DEFAULT_OUT = os.path.join("results", "torch_churn_baselines.json")


def run(seeds: Sequence[int] = (0, 1, 2),
        rates: Sequence[float] = DEFAULT_RATES,
        budget: float = 1200.0, n_data: int = 4000,
        heterogeneity: float = 6.0, churn_period: int = 32,
        max_rounds: int = 256, quiet: bool = False,
        init_for: Optional[InitFor] = None,
        draws_for: Optional[DrawsFor] = None,
        device: DeviceLike = None) -> List[Dict]:
    """The churn curve: seed-mean accuracy per (policy, churn_rate)."""
    scenario = ScenarioSpec(churn=ChurnSpec(rate=float(rates[0]),
                                            period=churn_period))
    spec = SweepSpec(policy=INGRAPH_POLICY_ORDER,
                     churn_rate=tuple(float(r) for r in rates),
                     seeds=tuple(int(s) for s in seeds),
                     max_rounds=max_rounds)
    rep = run_el_sweep("svm", spec, heterogeneity, budget=budget,
                       n_data=n_data, lr=0.01, batch=32,
                       scenario=scenario,
                       init_params=init_for and init_for("svm", 0),
                       draws_for=draws_for, device=device)
    rows = []
    for g in rep.grouped_rows():
        rows.append(dict(figure="churn_baselines",
                         policy=str(g["policy"]),
                         churn_rate=float(g["churn_rate"]),
                         n_seeds=int(g["n_seeds"]),
                         metric=round(g["final_metric"], 4),
                         metric_std=round(g["final_metric_std"], 4),
                         consumed=round(g["total_consumed"], 1)))
        if not quiet:
            print(f"policy {g['policy']:12s} churn={g['churn_rate']:.2f} "
                  f"acc={g['final_metric']:.4f}"
                  f"±{g['final_metric_std']:.4f} "
                  f"({g['n_seeds']} seeds)", flush=True)
    if not quiet:
        print(f"churn sweep: {rep.summary()}", flush=True)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="3 policies × 2 rates × 1 seed grid — the proof "
                         "that the multi-policy scenario sweep runs as one "
                         "device loop")
    ap.add_argument("--out", default=None,
                    help=f"JSON output path (default: {DEFAULT_OUT}; smoke "
                         "runs do not write)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.smoke:
        rows = run(seeds=(0,), rates=(0.0, 0.4), budget=800.0,
                   n_data=1000, max_rounds=64, device=args.device)
        assert len(rows) == 6, rows
        ok = all(np.isfinite(r["metric"]) and r["metric"] > 0.5
                 for r in rows)
        if not ok:
            print("SMOKE FAILED:", rows, file=sys.stderr)
            sys.exit(1)
        print("churn baselines smoke OK")
        return
    rows = run(device=args.device)
    out = args.out or DEFAULT_OUT
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"figure": "churn_baselines",
                   "policies": list(INGRAPH_POLICY_ORDER),
                   "rows": rows}, f, indent=1)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
