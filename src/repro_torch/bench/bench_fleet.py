"""Benchmark multi-tenant EL serving → ``BENCH_torch_fleet.json``.

The reference's ``scripts/bench_fleet.py`` over the port.  Times three
ways to serve N independent EL tenants (same structural config,
per-tenant knobs/seeds — i.e. one cohort):

  * ``sequential_host``    — one ``ELSession.run`` per tenant: the
    host-driven loop, back-to-back (the baseline the acceptance speedup
    is judged against);
  * ``sequential_ingraph`` — one ``ELSession.run_sync_ingraph`` per
    tenant, all sessions sharing ONE ``ProgramCache`` (the strongest
    sequential baseline: compiled data plane, one build, one captured
    graph);
  * ``fleet``              — a :class:`repro_torch.el.fleet.FleetServer`
    with ``--slots`` batch width serving the same tenants as slot waves
    of one vmapped program (one CUDA graph replay a wave on a card), free
    slots refilled mid-flight.

Every tenant draws from the RNG seam as the fleet's ``TenantRun``
resolves it (``draws=None``: a ``TorchDraws`` seeded ``cfg.seed + 17``),
which is what a session's ``run_sync_ingraph`` draws from; so ``fleet_N``
and ``sequential_ingraph_N`` make the same decisions and total the same
``n_aggregations``.  That is the fleet contract, and the script raises
when it fails.  Every timed call ends in ``torch.cuda.synchronize()`` on
a card; ``wall_s`` is min-of-repeats, ``wall_s_stats`` the spread.

    PYTHONPATH=src python -m repro_torch.bench.bench_fleet
    PYTHONPATH=src python -m repro_torch.bench.bench_fleet --device cpu \\
        --tenants 4 --slots 2 --repeats 1 --out /tmp/f.json --no-history
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, List

import torch

from repro_torch.bench.common import card_meta, synchronize
from repro_torch.device import resolve_device
from repro_torch.el import ELSession, TenantRun
from repro_torch.el.cache import ProgramCache
from repro_torch.el.fleet import FleetServer
from repro_torch.interop import tree_from_numpy
from repro_torch.launch.classic import classic_fixture
from repro_torch.obs.regress import append_history
from repro_torch.obs.timing import repeat_s, summarize_ns

#: per-tenant knob grids — every combination is the SAME structural
#: config, so the whole population is one cohort / one build
UCB_GRID = (0.5, 1.0, 1.5, 2.0)
BUDGET_GRID = (600.0, 900.0, 1200.0, 1500.0)


class FleetContractError(AssertionError):
    """``fleet_N`` and ``sequential_ingraph_N`` disagree."""


def _fixture(args, device=None):
    fx = classic_fixture("svm-wafer", samples=args.samples,
                         n_edges=args.edges, alpha=args.alpha,
                         data_seed=0, device=device)
    base = dataclasses.replace(
        fx["exp"].ol4el, mode="sync", policy="ol4el", n_edges=args.edges,
        utility=fx["utility"])
    return fx, base


def _tenant_cfgs(base, n: int):
    return [dataclasses.replace(base, ucb_c=UCB_GRID[i % len(UCB_GRID)],
                                budget=BUDGET_GRID[i % len(BUDGET_GRID)],
                                seed=i)
            for i in range(n)]


def bench_sequential(fx, base, n: int, args, ingraph: bool
                     ) -> Dict[str, Any]:
    """N back-to-back single-tenant runs: the host loop
    (``ELSession.run``) or the compiled fast path (``run_sync_ingraph``,
    one shared program cache so the timed loop measures steady-state
    throughput, not N - 1 builds)."""
    pool = ProgramCache(8)
    device = fx["executor"].device

    def run_all(count: int) -> int:
        total = 0
        for cfg in _tenant_cfgs(base, count):
            s = ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
            s._programs = pool              # shared pool: no per-tenant build
            s.with_executor(fx["executor"],
                            init_params=fx["init_params"],
                            n_samples=fx["n_samples"])
            rep = (s.run_sync_ingraph(max_rounds=args.max_rounds)
                   if ingraph else s.run())
            total += rep.n_aggregations
        synchronize(device)
        return total

    run_all(1)                              # warm / build + capture once
    last = {}
    reps = repeat_s(lambda: last.update(n_agg=run_all(n)), args.repeats)
    n_agg = last["n_agg"]
    wall = min(reps)
    return {"tenants": n, "wall_s": wall,
            "wall_s_stats": summarize_ns(reps),
            "tenants_per_sec": n / wall,
            "n_aggregations": n_agg,
            "us_per_aggregation": wall * 1e6 / max(n_agg, 1)}


def bench_fleet(fx, base, n: int, args) -> Dict[str, Any]:
    """The same tenants through a FleetServer (one cohort, slot waves
    with mid-flight refill); the shared cache keeps the program and its
    graph warm across repeats."""
    cache = ProgramCache(8)
    device = fx["executor"].device

    def runs(count: int) -> List[TenantRun]:
        return [TenantRun(cfg=cfg, executor=fx["executor"],
                          tenant_id=f"t{i:04d}",
                          metric_name=fx["metric"],
                          n_samples=fx["n_samples"],
                          init_params=fx["init_params"],
                          max_rounds=args.max_rounds)
                for i, cfg in enumerate(_tenant_cfgs(base, count))]

    def serve(count: int):
        srv = FleetServer(n_slots=args.slots,
                          rounds_per_wave=args.rounds_per_wave,
                          cache=cache, device=device)
        for run in runs(count):
            srv.submit(run)
        reports = srv.drain()
        synchronize(device)
        st = srv.stats()
        srv.close()
        return reports, st

    serve(args.slots)                       # build + capture the cohort
    last = {}
    reps = repeat_s(lambda: last.update(zip(("reports", "stats"),
                                            serve(n))), args.repeats)
    stats = last["stats"]
    n_agg = sum(r.n_aggregations for r in last["reports"].values())
    wall = min(reps)
    return {"tenants": n, "wall_s": wall,
            "wall_s_stats": summarize_ns(reps),
            "tenants_per_sec": n / wall,
            "n_aggregations": n_agg,
            "us_per_aggregation": wall * 1e6 / max(n_agg, 1),
            "waves": stats["waves"], "compiles": stats["compiles"]}


def bench(args, init_params=None) -> Dict[str, Any]:
    """Every tier at every tenant count → the report (``meta`` and
    ``rows``).  ``init_params`` (a numpy tree) replaces the port's init
    (the parity tests hand in the reference's)."""
    device = resolve_device(args.device)
    counts = [int(c) for c in args.tenants.split(",") if c]
    fx, base = _fixture(args, device)
    if init_params is not None:
        fx["init_params"] = tree_from_numpy(init_params, device)
    rows: Dict[str, Dict[str, Any]] = {}
    for n in counts:
        host = None
        if not args.skip_host:
            host = bench_sequential(fx, base, n, args, ingraph=False)
            rows[f"sequential_host_{n}"] = host
        seq = bench_sequential(fx, base, n, args, ingraph=True)
        flt = bench_fleet(fx, base, n, args)
        if flt["n_aggregations"] != seq["n_aggregations"]:
            raise FleetContractError(
                f"fleet_{n} made {flt['n_aggregations']} aggregations, "
                f"sequential_ingraph_{n} {seq['n_aggregations']}: the same "
                "tenants on the same draws must make the same decisions")
        flt["speedup_vs_sequential_ingraph"] = (flt["tenants_per_sec"]
                                               / seq["tenants_per_sec"])
        if host is not None:
            flt["speedup_vs_sequential_host"] = (flt["tenants_per_sec"]
                                                 / host["tenants_per_sec"])
        rows[f"sequential_ingraph_{n}"] = seq
        rows[f"fleet_{n}"] = flt
        hosttxt = ("" if host is None else
                   f"host {host['tenants_per_sec']:6.2f} t/s | ")
        print(f"n={n:4d}: {hosttxt}ingraph "
              f"{seq['tenants_per_sec']:7.2f} t/s "
              f"({seq['us_per_aggregation']:.0f} us/agg) | fleet "
              f"{flt['tenants_per_sec']:7.2f} t/s "
              f"({flt['us_per_aggregation']:.0f} us/agg, "
              f"{flt['waves']} waves) -> "
              f"{flt['speedup_vs_sequential_ingraph']:.2f}x vs ingraph"
              + ("" if host is None else
                 f", {flt['speedup_vs_sequential_host']:.2f}x vs host"),
              flush=True)

    meta = {
        "workload": "svm-wafer sync, one cohort (knobs/seed vary "
                    "per tenant)",
        "slots": args.slots, "rounds_per_wave": args.rounds_per_wave,
        "edges": args.edges, "samples": args.samples,
        "max_rounds": args.max_rounds, "repeats": args.repeats,
        "backend": device.type, "torch": torch.__version__,
        **card_meta(device),
        "note": (f"wall clock on the {device.type} device's host, every "
                 "timed call ending in a synchronize: wall_s is "
                 "min-of-repeats (wall_s_stats carries the spread); every "
                 "tier built and captured before timing; fleet_N and "
                 "sequential_ingraph_N make the same decisions on the "
                 "same draws (checked: equal n_aggregations)"),
    }
    return {"meta": meta, "rows": rows}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="multi-tenant EL serving benchmark -> "
                    "BENCH_torch_fleet.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--devices", type=int, default=4,
                    help="the reference's flag: its forced host-device "
                         "count, which no row of this bench reads (every "
                         "row runs on one device)")
    ap.add_argument("--tenants", default="16,64,256",
                    help="comma-separated tenant counts to benchmark")
    ap.add_argument("--slots", type=int, default=8,
                    help="fleet cohort batch width")
    ap.add_argument("--rounds-per-wave", type=int, default=4,
                    help="device rounds between host harvest/refill "
                         "points (small waves refill freed slots "
                         "sooner)")
    ap.add_argument("--edges", type=int, default=4)
    ap.add_argument("--samples", type=int, default=512)
    ap.add_argument("--alpha", type=float, default=100.0)
    ap.add_argument("--max-rounds", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--skip-host", action="store_true",
                    help="omit the slow host-loop sequential baseline")
    ap.add_argument("--out", default="BENCH_torch_fleet.json")
    ap.add_argument("--history", default="BENCH_torch_history.jsonl",
                    help="append a schema-versioned entry here "
                         "(repro_torch.bench.bench_check reads it)")
    ap.add_argument("--no-history", action="store_true",
                    help="skip the history append")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    report = bench(args)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {args.out}")
    if not args.no_history:
        append_history(args.history, "fleet", report["meta"],
                       report["rows"])
        print(f"appended to {args.history}")


if __name__ == "__main__":
    main()
