"""Ablation-sweep launcher: a whole hyperparameter grid as one device loop.

    PYTHONPATH=src python -m repro_torch.launch.sweep --arch svm-wafer \
        --ucb-c 1.0 2.0 --budget 2000 4000 --seeds 0 1 2

    PYTHONPATH=src python -m repro_torch.launch.sweep --arch svm-wafer \
        --policy ol4el task_alloc delay_energy --churn 0.2 \
        --churn-rate 0.0 0.2 0.4 --seeds 0 1 2

Flattens the grid (policy × ucb_c × budget × heterogeneity × cost_noise ×
async_alpha × churn_rate × seeds, and async wave widths) into
``[n_cells]``, runs the compiled EL program with a leading cell dimension
(``repro_torch.el.sweep``) — the sync round or, with ``--el-mode async``,
the async event engine (``repro_torch.el.events``) — and prints per-cell
rows, seed-mean curves and the accuracy-vs-resource Pareto frontier.  It
runs on CUDA unless ``--device`` names another device.

The scenario flags (``--churn``, ``--churn-period``, ``--cost-model``,
``--drift``; ``repro_torch.el.scenarios.cli``) run the scenario programs;
``--policy`` implies the identity scenario when none is set, and
``--churn-rate`` needs a base ``--churn``.  ``--metrics-out`` writes the
grid's metrics (``repro_torch.obs.cli``: Prometheus text, JSON and the
tracer's spans) and ``--trace-dir`` a ``torch.profiler`` trace.
``--telemetry [N]`` records every cell's device rings
(``repro_torch.obs.rings``, ring length N, default 128) into the report's
``out["telemetry"]``.  ``--mesh`` (sharded sweeps, ROADMAP Queue 1 item
14) raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.config import CLASSIC_IDS
from repro_torch.device import resolve_device
from repro_torch.el import ELSession
from repro_torch.el.scenarios import ScenarioSpec
from repro_torch.el.scenarios.cli import add_scenario_args, scenario_from_args
from repro_torch.el.sweep import spec_from_sequences
from repro_torch.launch.classic import classic_fixture
from repro_torch.obs.cli import (add_metrics_args, begin_observability,
                                 finish_observability, telemetry_arg)


def build_session(args, scenario=None,
                  base_cost_model=None) -> ELSession:
    fx = classic_fixture(args.arch, samples=args.samples,
                         n_edges=args.edges, alpha=args.alpha,
                         data_seed=args.data_seed,
                         kmeans_impl=args.kmeans_impl, device=args.device)
    ol = dataclasses.replace(
        fx["exp"].ol4el, mode=args.el_mode, policy="ol4el",
        n_edges=args.edges, utility=fx["utility"],
        cost_model=(base_cost_model if base_cost_model is not None
                    else args.cost_model),
        scenario=scenario, max_interval=args.max_interval)
    return (ELSession(ol, metric_name=fx["metric"], lr=fx["lr"])
            .with_executor(fx["executor"],
                           init_params=fx["init_params"],
                           n_samples=fx["n_samples"]))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="run an OL4EL ablation grid as one device loop")
    ap.add_argument("--arch", default="svm-wafer", choices=CLASSIC_IDS)
    ap.add_argument("--ucb-c", type=float, nargs="*", default=[],
                    help="ol4el exploration-constant grid")
    ap.add_argument("--budget", type=float, nargs="*", default=[],
                    help="per-edge budget grid")
    ap.add_argument("--heterogeneity", type=float, nargs="*", default=[],
                    help="fleet heterogeneity (H) grid")
    ap.add_argument("--cost-noise", type=float, nargs="*", default=[],
                    help="variable-cost noise-scale grid (>0 implies "
                         "cost_model=variable for that cell)")
    ap.add_argument("--async-alpha", type=float, nargs="*", default=[],
                    help="async staleness-mix base-rate grid "
                         "(a no-op axis for sync grids)")
    ap.add_argument("--async-batch-k", type=int, nargs="*", default=[],
                    help="async K-event wave-width grid (one sub-sweep per "
                         "K; 0 = auto — a throughput axis, every K "
                         "computes identical results)")
    ap.add_argument("--policy", nargs="*", default=[],
                    help="competitor-policy grid (ol4el task_alloc "
                         "delay_energy) — through the scenario engine's "
                         "policy switch, one program for all (sync; "
                         "implies an identity scenario)")
    ap.add_argument("--churn-rate", type=float, nargs="*", default=[],
                    help="churn-rate grid: re-draws each cell's dropout "
                         "schedule (needs a base --churn RATE)")
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1])
    ap.add_argument("--el-mode", default="sync", choices=["sync", "async"],
                    help="'async': every cell runs the compiled async "
                         "event engine; max-rounds then bounds merge "
                         "EVENTS")
    ap.add_argument("--max-rounds", type=int, default=256)
    ap.add_argument("--edges", type=int, default=3)
    ap.add_argument("--samples", type=int, default=4000)
    ap.add_argument("--alpha", type=float, default=100.0,
                    help="Dirichlet concentration of the edge data split")
    ap.add_argument("--max-interval", type=int, default=10)
    ap.add_argument("--kmeans-impl", default=None, choices=["torch", "cuda"],
                    help="K-means E-step inside the local blocks (default: "
                         "the CUDA kernel on a CUDA device, the plain "
                         "torch version on the CPU)")
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    ap.add_argument("--mesh", default="none", choices=["none", "debug"],
                    help="sharded sweeps: ROADMAP Queue 1 item 14; "
                         "'debug' raises")
    add_scenario_args(ap)
    add_metrics_args(ap, trace_dir=True)
    telemetry_arg(ap)
    return ap


def main(argv=None) -> None:
    ap = parser()
    args = ap.parse_args(argv)
    if args.mesh != "none":
        raise NotImplementedError(
            "--mesh: sharded sweeps arrive with ROADMAP Queue 1 item 14 "
            "(multiple GPUs)")
    scenario, base_cost_model = scenario_from_args(args)
    if args.policy and scenario is None:
        # the policy switch lives on the scenario program path; an
        # identity scenario (all edges up, multipliers 1) is enough
        scenario = ScenarioSpec()
    if args.churn_rate and (scenario is None or scenario.churn is None):
        ap.error("--churn-rate re-draws the dropout schedule per cell "
                 "and needs a base --churn RATE")
    begin_observability(args)
    spec = spec_from_sequences(
        ucb_c=args.ucb_c, budget=args.budget,
        heterogeneity=args.heterogeneity, cost_noise=args.cost_noise,
        async_alpha=args.async_alpha, async_batch_k=args.async_batch_k,
        policy=args.policy, churn_rate=args.churn_rate,
        seeds=args.seeds, max_rounds=args.max_rounds)
    session = build_session(args, scenario, base_cost_model)
    print(f"sweep {args.arch}: {spec.describe(session.cfg)} on "
          f"{resolve_device(args.device)}", flush=True)

    report = session.sweep(spec, telemetry=args.telemetry)

    scn_cols = bool(args.policy or args.churn_rate)
    print(f"\n{'ucb_c':>6s} {'budget':>8s} {'H':>5s} {'noise':>6s} "
          f"{'alpha':>6s} {'seed':>5s} "
          + (f"{'policy':>12s} {'churn':>6s} " if scn_cols else "")
          + f"{'rounds':>6s} {'metric':>8s} {'consumed':>9s}")
    for row in report.to_rows():
        print(f"{row['ucb_c']:6.2f} {row['budget']:8.0f} "
              f"{row['heterogeneity']:5.1f} {row['cost_noise']:6.2f} "
              f"{row['async_alpha']:6.2f} {row['seed']:5.0f} "
              + (f"{row['policy']:>12s} {row['churn_rate']:6.2f} "
                 if scn_cols else "")
              + f"{row['n_rounds']:6d} {row['final_metric']:8.4f} "
              f"{row['total_consumed']:9.0f}")

    trunc = report.truncated()
    if trunc.any():
        print(f"\nWARNING: {int(trunc.sum())}/{report.n_cells} cells hit "
              f"the max-rounds cap ({spec.max_rounds}) before budget "
              "exhaustion — metrics are mid-run; raise --max-rounds for "
              "full runs")

    print("\nseed-mean learning curves (final point):")
    for c in report.learning_curves():
        last = c["mean"][-1] if len(c["mean"]) else float("nan")
        print(f"  ucb_c={c['ucb_c']:.2f} budget={c['budget']:.0f} "
              f"H={c['heterogeneity']:.1f}: {c['n_seeds']} seeds, "
              f"{c['rounds']} rounds, metric {last:.4f}")

    print("\nPareto frontier (consumed ↑ ⇒ metric ↑, seed-means):")
    for p in report.pareto_frontier():
        print(f"  ucb_c={p['ucb_c']:.2f} budget={p['budget']:.0f} "
              f"H={p['heterogeneity']:.1f}: metric={p['final_metric']:.4f} "
              f"@ consumed={p['total_consumed']:.0f}")
    print("\n" + report.summary())
    loops = report.telemetry["device_loops"]
    print(f"device loops: {sum(lp['chunks'] for lp in loops)} chunks, "
          f"{sum(lp['graphs_captured'] for lp in loops)} graphs captured, "
          f"{sum(lp['replays'] for lp in loops)} replays")
    cache = session.compile_cache.stats()
    print(f"compile cache: {cache['entries']} programs "
          f"({cache['hits']} hits, {cache['misses']} misses, "
          f"{cache['evictions']} evictions)", flush=True)

    registry = None
    if args.metrics_out:
        from repro_torch.obs.metrics import MetricsRegistry
        registry = MetricsRegistry()
        registry.gauge("sweep_cells", "grid cells in the compiled sweep"
                       ).set(report.n_cells)
        registry.gauge("sweep_truncated_cells",
                       "cells that hit the max-rounds cap"
                       ).set(int(trunc.sum()))
        hist = registry.histogram(
            "sweep_final_metric", "per-cell final metric",
            buckets=(0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 1.0))
        hist.observe_many([row["final_metric"]
                           for row in report.to_rows()])
    finish_observability(args, registry)


if __name__ == "__main__":
    main()
