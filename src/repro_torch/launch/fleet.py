"""Multi-tenant EL-as-a-service launcher.

    PYTHONPATH=src python -m repro_torch.launch.fleet --demo
    PYTHONPATH=src python -m repro_torch.launch.fleet --manifest tenants.json \
        --slots 4 --device cpu

Feeds a manifest of tenant runs (JSON, or YAML where ``yaml`` imports;
see ``--demo`` for the shape) into a
:class:`repro_torch.el.fleet.FleetServer`: tenants bucket into cohorts by
structural config — one slot-batch program per cohort — and are served
in slot waves with mid-flight refill, their reports streamed as they
complete.  It runs on CUDA unless ``--device`` names another device.

``--assert-compiles`` exits non-zero unless the server built exactly
that many cohort programs ("one compile per cohort"), and the run exits
non-zero when the wave-batched dispatch invariant breaks (more place or
gather dispatches than waves).  ``--telemetry [N]`` records every
tenant's device rings (``repro_torch.obs.rings``) into its report and
``--metrics-out`` folds them into the registry.  ``--mesh debug``
(sharded cohorts, ROADMAP Queue 1 item 14) raises
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Dict, List

from repro_torch.config import CLASSIC_IDS
from repro_torch.el.fleet import (FleetServer, ReportReady, RoundDelta,
                                  TenantRun)
from repro_torch.launch.classic import classic_fixture
from repro_torch.obs.cli import (add_metrics_args, begin_observability,
                                 finish_observability, telemetry_arg)

#: the --demo manifest: 8 tenants across TWO structural cohorts — a sync
#: SVM cohort and an async K-means cohort (the async budgets all pad to
#: one event horizon, so they share a program).
DEMO_MANIFEST: Dict[str, Any] = {
    "tenants": [
        {"arch": "svm-wafer", "mode": "sync", "budget": 900.0,
         "ucb_c": 1.0, "seed": 0},
        {"arch": "svm-wafer", "mode": "sync", "budget": 1500.0,
         "ucb_c": 0.5, "seed": 1, "priority": 2},
        {"arch": "svm-wafer", "mode": "sync", "budget": 600.0,
         "ucb_c": 2.0, "seed": 2},
        {"arch": "svm-wafer", "mode": "sync", "budget": 1200.0,
         "ucb_c": 1.0, "seed": 3},
        {"arch": "kmeans-traffic", "mode": "async", "budget": 700.0,
         "ucb_c": 1.0, "seed": 4},
        {"arch": "kmeans-traffic", "mode": "async", "budget": 800.0,
         "ucb_c": 0.7, "seed": 5, "priority": 1},
        {"arch": "kmeans-traffic", "mode": "async", "budget": 850.0,
         "ucb_c": 1.5, "seed": 6},
        {"arch": "kmeans-traffic", "mode": "async", "budget": 900.0,
         "ucb_c": 1.0, "seed": 7},
    ],
}


def load_manifest(path: str) -> Dict[str, Any]:
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        import yaml
        return yaml.safe_load(text)
    return json.loads(text)


def tenant_runs(manifest: Dict[str, Any], args) -> List[TenantRun]:
    """Materialize the manifest: one data-plane fixture per (arch,
    dataset) — tenants of a cohort must SHARE an executor, that is what
    buckets them onto one compiled program."""
    fixtures: Dict[tuple, Dict[str, Any]] = {}
    runs: List[TenantRun] = []
    for t in manifest["tenants"]:
        arch = t["arch"]
        if arch not in CLASSIC_IDS:
            raise SystemExit(f"unknown arch {arch!r} (choices: "
                             f"{sorted(CLASSIC_IDS)})")
        fkey = (arch, t.get("samples", args.samples),
                t.get("edges", args.edges), t.get("alpha", args.alpha),
                t.get("data_seed", args.data_seed))
        fx = fixtures.get(fkey)
        if fx is None:
            fx = fixtures[fkey] = classic_fixture(
                arch, samples=fkey[1], n_edges=fkey[2], alpha=fkey[3],
                data_seed=fkey[4], device=args.device)
        mode = t.get("mode", "sync")
        ol = dataclasses.replace(
            fx["exp"].ol4el, mode=mode, policy="ol4el",
            n_edges=fkey[2], utility=fx["utility"],
            budget=float(t.get("budget", fx["exp"].ol4el.budget)),
            ucb_c=float(t.get("ucb_c", fx["exp"].ol4el.ucb_c)),
            async_batch_k=int(t.get("async_batch_k",
                                    args.async_batch_k)),
            seed=int(t.get("seed", 0)))
        runs.append(TenantRun(
            cfg=ol, executor=fx["executor"],
            tenant_id=t.get("tenant_id"),
            priority=int(t.get("priority", 0)),
            metric_name=fx["metric"],
            n_samples=fx["n_samples"] if mode == "sync" else None,
            init_params=fx["init_params"]))
    return runs


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="serve a manifest of EL tenants as slot-batched "
                    "cohorts")
    ap.add_argument("--manifest", default=None,
                    help="JSON/YAML tenant manifest (see --demo)")
    ap.add_argument("--demo", action="store_true",
                    help="run the built-in 8-tenant / 2-cohort demo "
                         "manifest")
    ap.add_argument("--slots", type=int, default=4,
                    help="cohort batch width (tenants beyond it queue)")
    ap.add_argument("--rounds-per-wave", type=int, default=8,
                    help="device iterations between host harvest points")
    ap.add_argument("--samples", type=int, default=512,
                    help="default dataset size per arch fixture")
    ap.add_argument("--edges", type=int, default=4)
    ap.add_argument("--alpha", type=float, default=100.0)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    ap.add_argument("--mesh", default="none", choices=["none", "debug"],
                    help="sharded cohorts: ROADMAP Queue 1 item 14; "
                         "'debug' raises")
    ap.add_argument("--async-batch-k", type=int, default=0,
                    help="default async K-event wave width for tenants "
                         "that don't set async_batch_k themselves "
                         "(cfg.async_batch_k; 0 resolves to 1)")
    ap.add_argument("--assert-compiles", type=int, default=None,
                    metavar="N",
                    help="exit non-zero unless exactly N cohort programs "
                         "were built (one per cohort)")
    ap.add_argument("--verbose", action="store_true",
                    help="print every streamed round delta")
    add_metrics_args(ap, trace_dir=True)
    telemetry_arg(ap)
    return ap


def main(argv=None) -> Dict[str, Any]:
    """Serve the manifest; returns the delivered reports (tenant id →
    ``ELReport``) or exits non-zero on a failed check."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.demo == (args.manifest is not None):
        ap.error("pass exactly one of --demo / --manifest")
    if args.mesh != "none":
        raise NotImplementedError(
            "--mesh: sharded cohorts arrive with ROADMAP Queue 1 item 14 "
            "(multiple GPUs)")
    manifest = DEMO_MANIFEST if args.demo else load_manifest(args.manifest)

    server = FleetServer(n_slots=args.slots,
                         rounds_per_wave=args.rounds_per_wave,
                         telemetry=args.telemetry, device=args.device)
    begin_observability(args)

    def on_event(ev):
        if isinstance(ev, RoundDelta) and args.verbose:
            r = ev.record
            print(f"  [{ev.tenant_id}] agg {r.n_aggregations}: "
                  f"consumed={r.total_consumed:.0f} "
                  f"utility={r.utility:.4f}", flush=True)
        elif isinstance(ev, ReportReady):
            print(f"done {ev.tenant_id}: {ev.report.summary()}",
                  flush=True)

    server.subscribe(on_event)
    runs = tenant_runs(manifest, args)
    t0 = time.perf_counter()
    ids = [server.submit(run) for run in runs]
    print(f"fleet: {len(ids)} tenants, slots={args.slots}, "
          f"wave={args.rounds_per_wave} on {server.device}", flush=True)
    reports = server.drain()
    elapsed = time.perf_counter() - t0

    st = server.stats()
    print(f"\n{'tenant':>12s} {'mode':>6s} {'rounds':>6s} "
          f"{'consumed':>9s} {'metric':>8s}  reason")
    for tid in ids:
        r = reports[tid]
        print(f"{tid:>12s} {r.mode:>6s} {r.n_aggregations:6d} "
              f"{r.total_consumed:9.0f} {r.final_metric:8.4f}  "
              f"{r.terminated_reason}")
    print(f"\n{len(reports)}/{len(ids)} reports in {elapsed:.2f}s — "
          f"{st['cohorts']} cohorts, {st['compiles']} compiles "
          f"({st['cache_hits']} cache hits, {st['cache_misses']} misses, "
          f"{st['cache_evictions']} evictions), {st['waves']} waves, "
          f"{st['place_dispatches']} place / {st['gather_dispatches']} "
          f"gather dispatches")

    # wave batching invariant: admits scatter as ONE place_many per
    # admitting wave and finalizes gather as ONE take_many per
    # finalizing wave — never per tenant.  A per-tenant regression shows
    # up as dispatch counts above the wave count.
    if reports and not (1 <= st["place_dispatches"] <= st["waves"]
                        and 1 <= st["gather_dispatches"] <= st["waves"]):
        print(f"ERROR: per-wave dispatch invariant broken — "
              f"{st['place_dispatches']} place / "
              f"{st['gather_dispatches']} gather dispatches over "
              f"{st['waves']} waves", file=sys.stderr)
        raise SystemExit(1)

    registry = None
    if args.metrics_out:
        from repro_torch.obs import registry_from_fleet
        registry = registry_from_fleet(st)
    finish_observability(args, registry)

    if len(reports) != len(ids):
        print("ERROR: missing tenant reports", file=sys.stderr)
        raise SystemExit(1)
    if (args.assert_compiles is not None
            and st["compiles"] != args.assert_compiles):
        print(f"ERROR: expected {args.assert_compiles} cohort compiles, "
              f"got {st['compiles']} (cohorts={st['cohorts']})",
              file=sys.stderr)
        raise SystemExit(1)
    return reports


if __name__ == "__main__":
    main()
