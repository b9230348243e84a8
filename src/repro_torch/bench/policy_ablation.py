"""Policy ablation: resolving the paper's under-specified §IV.B procedure.

The paper's text ("probabilistic selection ∝ frequency") taken literally
never uses utility in the selection step.  This benchmark compares:
  * ol4el      — our interpretation: P ∝ UCB-density × frequency
  * freq_only  — the literal reading: P ∝ frequency
  * greedy     — argmax UCB density (pure fractional-KUBE)
  * eps_greedy — ε-greedy on density
  * ucb_bv     — variable-cost UCB-BV1
  * uniform    — uniform over affordable arms (floor)
  * fixed_i    — the Fixed-I baseline

on (a) a controlled bandit instance with a known best arm (numpy only,
over ``repro_torch.core.bandit``), and (b) the paper's SVM testbed.

The ol4el hyperparameter frontier (``ucb_sweep``) runs through the
compiled sweep: the whole ucb_c × seed grid is ONE device loop
(``repro_torch.el.sweep``) instead of a sequential host loop.
``--smoke`` runs a tiny 2×2 grid.

    python -m repro_torch.bench.policy_ablation [--smoke] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.bench.common import (DrawsFor, InitFor, run_el,
                                      run_el_sweep)
from repro_torch.core.bandit import (BanditState, arm_costs, regret_oracle,
                                     select_arm)
from repro_torch.device import DeviceLike
from repro_torch.el.sweep import SweepSpec

POLICIES = ("ol4el", "freq_only", "greedy", "eps_greedy", "ucb_bv",
            "uniform", "fixed_i")


def synthetic_bandit(policy: str, seed: int, budget: float = 60000.0,
                     noise: float = 0.05) -> float:
    """Earned utility / oracle on a skewed instance (arm 6 best density)."""
    rng = np.random.default_rng(seed)
    means = np.array([0.10, 0.12, 0.15, 0.20, 0.30, 0.45, 0.70, 0.55,
                      0.40, 0.30])
    costs = arm_costs(10, comp_cost=8.0, comm_cost=40.0)
    st = BanditState.create(10)
    residual, earned = budget, 0.0
    while True:
        arm = select_arm(st, residual, costs, policy=policy, rng=rng)
        if arm < 0:
            break
        u = means[arm] + noise * rng.standard_normal()
        st.update(arm, u, costs[arm])
        residual -= costs[arm]
        earned += means[arm]
    return earned / regret_oracle(means, costs, budget)


def el_testbed(policy: str, seed: int,
               init_for: Optional[InitFor] = None,
               device: DeviceLike = None) -> float:
    mode = "async" if policy not in ("ac_sync",) else "sync"
    return run_el("svm", policy, mode, heterogeneity=6.0, budget=1200.0,
                  n_data=4000, seed=seed, lr=0.01, batch=32,
                  init_params=init_for and init_for("svm", seed),
                  device=device).final_metric


def ucb_sweep(seeds: Sequence[int] = (0, 1),
              ucb_grid: Sequence[float] = (0.5, 2.0, 8.0),
              budget: float = 1200.0, n_data: int = 4000,
              heterogeneity: float = 6.0, max_rounds: int = 256,
              quiet: bool = False,
              init_for: Optional[InitFor] = None,
              draws_for: Optional[DrawsFor] = None,
              device: DeviceLike = None) -> List[Dict]:
    """The ol4el exploration-constant frontier: every (ucb_c, seed) cell
    of the grid runs inside ONE device loop.

    Seeds here vary only the in-program bandit/minibatch RNG streams —
    the dataset/partition/init are fixed at the base seed (program
    constants), which isolates selection-rule stochasticity per ucb_c
    point.  The ``el_testbed`` rows above resample data per seed, so the
    two sections measure deliberately different randomness sources."""
    spec = SweepSpec(ucb_c=tuple(float(c) for c in ucb_grid),
                     seeds=tuple(int(s) for s in seeds),
                     max_rounds=max_rounds)
    rep = run_el_sweep("svm", spec, heterogeneity, budget=budget,
                       n_data=n_data, lr=0.01, batch=32,
                       init_params=init_for and init_for("svm", 0),
                       draws_for=draws_for, device=device)
    rows = []
    for g in rep.grouped_rows():
        rows.append(dict(figure="policy_ablation",
                         policy=f"ol4el[c={g['ucb_c']:g}]",
                         svm_acc=round(g["final_metric"], 4),
                         consumed=round(g["total_consumed"], 1)))
        if not quiet:
            print(f"policy ol4el[c={g['ucb_c']:g}] "
                  f"svm_acc={g['final_metric']:.4f} "
                  f"(sweep, {g['n_seeds']} seeds)", flush=True)
    if not quiet:
        print(f"ucb sweep: {rep.summary()}", flush=True)
    return rows


def run(seeds=(0, 1, 2, 3, 4), with_testbed: bool = True,
        quiet: bool = False, init_for: Optional[InitFor] = None,
        draws_for: Optional[DrawsFor] = None,
        device: DeviceLike = None) -> List[Dict]:
    rows = []
    for policy in POLICIES:
        frac = float(np.mean([synthetic_bandit(policy, s) for s in seeds]))
        row = dict(figure="policy_ablation", policy=policy,
                   oracle_frac=round(frac, 4))
        if with_testbed:
            accs = [el_testbed(policy, s, init_for=init_for, device=device)
                    for s in seeds[:2]]
            row["svm_acc"] = round(float(np.mean(accs)), 4)
        rows.append(row)
        if not quiet:
            msg = (f"policy {policy:10s} oracle_frac={row['oracle_frac']:.3f}"
                   + (f" svm_acc={row['svm_acc']:.4f}"
                      if with_testbed else ""))
            print(msg, flush=True)
    if with_testbed:
        rows += ucb_sweep(seeds=seeds[:2], quiet=quiet, init_for=init_for,
                          draws_for=draws_for, device=device)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny 2×2 (ucb_c × seed) compiled-sweep grid "
                         "only")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.smoke:
        rows = ucb_sweep(seeds=(0, 1), ucb_grid=(1.0, 4.0), budget=800.0,
                         n_data=1000, max_rounds=64, device=args.device)
        assert len(rows) == 2, rows
        if not all(np.isfinite(r["svm_acc"]) and r["svm_acc"] > 0.5
                   for r in rows):
            print("SMOKE FAILED:", rows, file=sys.stderr)
            sys.exit(1)
        print("sweep smoke OK")
        return
    run(device=args.device)


if __name__ == "__main__":
    main()
