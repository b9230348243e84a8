"""Benchmark the single-run EL data plane → ``BENCH_torch_el.json``.

The reference's ``scripts/bench_el.py`` over the port.  Measures, for one
sync run and one async run of the paper's SVM workload, the
per-aggregation wall-clock and the program profile of every execution
tier the port runs:

  * ``host``              — the host-driven loop (numpy control plane,
                            the executor's steps on the device);
  * ``ingraph``           — the compiled program (``make_sync_program`` /
                            ``make_async_program``: chunks of masked
                            steps, each a CUDA graph replay on a card);
  * ``ingraph_donate``    — the same program run ``donate=True``: the
                            run takes the initial params' tensors as its
                            carry (``alias_bytes`` = their bytes);
  * ``ingraph_telemetry`` — the program with the device telemetry rings
                            (``repro_torch.obs.rings``) recording every
                            round; against the bare ``ingraph`` row this
                            bounds the observability overhead
                            (acceptance: <10%);
  * ``ingraph_batched``   — (async only) the K-event wave program with an
                            explicit ``--async-batch-k`` wave width;
  * ``ingraph_churn``     — (sync only) the scenario-path program
                            (``repro_torch.el.scenarios``) under a
                            ``--churn-rate`` dropout schedule; against the
                            bare ``ingraph`` row this bounds the scenario
                            engine's overhead (acceptance: <10%);
  * ``sharded``           — the program over the reference's debug mesh
                            of ``--devices`` ranks, ``(devices//2, 2)``
                            (data, model), 2 x 2 by default (``mesh=``:
                            the edge dim split over ``data``, the edge stack
                            all-gathered before each aggregation, chunks
                            run eagerly; the async tier at the wave width
                            the mesh resolves, ``meta["async_batch_k"]
                            ["sharded_auto"]``);
  * ``sharded_donate``    — the sharded program run ``donate=True``.

The sharded tiers run in ``--devices`` ranks (default 4, the reference's)
that ``repro_torch.launch.hostdev.spawn_ranks`` starts once for all four
tiers (``python -m repro_torch.bench.bench_el --rank-spec FILE``): gloo
ranks, with CUDA tensors on the one card they share (or CPU tensors on
the CPU), each timing the same calls; rank 0's rows are kept.  ``meta``
records the devices, the mesh, the ranks, their backend and the card.

Every compiled row carries the tier's ``repro_torch.obs.prof``
``ProgramProfile`` under the reference's keys (``profile_jit``: static
buffer bytes, the allocator's chunk peak on a card, the matmul flops of
one step, the collective census: empty on one rank, a sharded tier's
gathers), and ``profile_errors`` where a field could not be measured.

Timing convention (shared with ``bench_fleet``): every timed call ends in
``torch.cuda.synchronize()`` on a card; the scalar ``wall_us`` is the MIN
over ``--repeats``, the full spread is kept alongside as
``wall_us_stats`` (``repro_torch.obs.timing.summarize_ns`` shape).  A
compiled tier runs on a fresh copy of the initial params each call, its
build and graph capture in an untimed first call, and its draws from
``draws_for`` (default: a ``TorchDraws`` over a generator on the device
seeded with ``cfg.seed + 17``, as the session seeds it; a fresh provider
each call, so every repeat replays the same draws).  Each run appends a
schema-versioned entry to ``BENCH_torch_history.jsonl``
(``--no-history`` to skip) for ``repro_torch.bench.bench_check``.

    PYTHONPATH=src python -m repro_torch.bench.bench_el --repeats 7
    PYTHONPATH=src python -m repro_torch.bench.bench_el --device cpu \\
        --edges 4 --samples 512 --batch 64 --budget 300 --max-rounds 16 \\
        --max-events 64 --out /tmp/x.json --no-history
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import pickle
import sys
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.bench.common import DrawsFor, card_meta, synchronize
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.el import ELSession
from repro_torch.el.events import (async_knobs, make_async_program,
                                   resolve_async_batch_k)
from repro_torch.el.ingraph import make_sync_program, sync_knobs
from repro_torch.el.rng import TorchDraws
from repro_torch.el.scenarios import ChurnSpec, ScenarioSpec
from repro_torch.interop import tree_from_numpy, tree_map
from repro_torch.launch.classic import classic_fixture
from repro_torch.launch.hostdev import spawn_ranks
from repro_torch.obs.prof import profile_jit
from repro_torch.obs.regress import append_history
from repro_torch.obs.timing import repeat_s, summarize_ns, time_block

#: the sharded tiers' world: ``--devices`` gloo ranks on the reference's
#: ``make_debug_mesh_for(devices)``, by default 4 (a 2 x 2 (data, model)
#: mesh)
SHARDED_RANKS = 4
SHARDED_BACKEND = "gloo"
#: (row suffix, donate) of the tiers the ranks run, for each mode
SHARDED_TIERS = (("sharded", False), ("sharded_donate", True))


def _fixture(args, device: DeviceLike = None):
    fx = classic_fixture("svm-wafer", samples=args.samples,
                         n_edges=args.edges, alpha=1.0,
                         batch=args.batch, device=device)
    ol = dataclasses.replace(
        fx["exp"].ol4el, mode="sync", policy="ol4el", n_edges=args.edges,
        budget=args.budget, heterogeneity=4.0, utility=fx["utility"],
        seed=0)
    return fx["model"], fx["executor"], ol, fx["n_samples"]


def _init(model, ex, init_params):
    """The runs' initial params on the executor's device: ``init_params``
    (a numpy tree) or the port's ``model.init`` seeded with 0."""
    if init_params is not None:
        return tree_from_numpy(init_params, ex.device)
    return model.init(torch.Generator().manual_seed(0))


def _profile_row(program, example_args, donate: bool = False
                 ) -> Dict[str, Any]:
    """The tier's ``ProgramProfile`` flattened into BENCH-row fields (the
    reference's keys)."""
    prof = profile_jit(program, *example_args, donated=donate)
    row = {
        "peak_live_bytes": prof.peak_live_bytes,
        "argument_bytes": prof.argument_bytes,
        "output_bytes": prof.output_bytes,
        "temp_bytes": prof.temp_bytes,
        "alias_bytes": prof.alias_bytes,
        "flops": prof.flops,
        "collectives": prof.collectives,
        "collective_bytes": prof.collective_bytes,
        "hlo_lines": prof.hlo_lines,
    }
    if prof.errors:
        row["profile_errors"] = list(prof.errors)
    return row


def bench_compiled(model, ex, ol, ns, mode, args, telemetry=None,
                   batch_k=None, scenario=None, init_params=None,
                   draws_for: Optional[DrawsFor] = None, mesh=None,
                   donate: bool = False) -> Dict[str, Any]:
    """Time one compiled-program tier and read its profile; ``mesh``:
    the program over it (every rank of the mesh calls this alike),
    ``donate``: every call donates its fresh copy of the params."""
    cfg = dataclasses.replace(ol, mode=mode, scenario=scenario)
    if batch_k is not None:
        cfg = dataclasses.replace(cfg, async_batch_k=int(batch_k))
    if mode == "sync":
        horizon = args.max_rounds
        program = make_sync_program(
            model, ex.edge_data, ex.eval_set, cfg, lr=ex.lr, batch=ex.batch,
            n_samples=np.asarray(ns, np.float64), max_rounds=horizon,
            mesh=mesh, telemetry=telemetry, device=ex.device)
        knobs = sync_knobs(cfg)
    else:
        horizon = args.max_events
        program = make_async_program(
            model, ex.edge_data, ex.eval_set, cfg, lr=ex.lr, batch=ex.batch,
            max_events=horizon, mesh=mesh, telemetry=telemetry,
            batch_k=resolve_async_batch_k(cfg, mesh), device=ex.device)
        knobs = async_knobs(cfg)
    params0 = _init(model, ex, init_params)

    def fresh():
        return tree_map(torch.clone, params0)

    def draws():
        if draws_for is not None:
            return draws_for(cfg, ex.batch, horizon)
        return TorchDraws(torch.Generator(device=program.device)
                          .manual_seed(cfg.seed + 17))

    def call():
        out = program(fresh(), knobs, draws(), donate=donate)[1]
        synchronize(program.device)
        return out

    out = call()                                # build + capture
    n_agg = int(out["n_rounds"])
    reps = [s * 1e6 for s in repeat_s(call, args.repeats)]
    # min-of-repeats: the floor is the honest per-program cost (the mean
    # rides host scheduler noise)
    dt_us = min(reps)
    row = {
        "n_aggregations": n_agg,
        "us_per_aggregation": dt_us / max(n_agg, 1),
        "wall_us": dt_us,
        "wall_us_stats": summarize_ns(reps),
    }
    row.update(_profile_row(program, (params0, knobs), donate))
    return row


def bench_host(model, ex, ol, ns, mode, init_params=None) -> Dict[str, Any]:
    cfg = dataclasses.replace(ol, mode=mode)

    def run():
        s = (ELSession(cfg, metric_name="accuracy", lr=0.05)
             .with_executor(ex, init_params=_init(model, ex, init_params),
                            n_samples=ns))
        rep = s.run_sync() if mode == "sync" else s.run_async()
        synchronize(ex.device)
        return rep

    run()                                       # warm the executor
    with time_block() as tb:
        rep = run()
    dt_us = tb.us
    return {"n_aggregations": rep.n_aggregations,
            "us_per_aggregation": dt_us / max(rep.n_aggregations, 1),
            "wall_us": dt_us, "peak_live_bytes": None}


def bench(args, init_params=None,
          draws_for: Optional[DrawsFor] = None) -> Dict[str, Any]:
    """Every tier of ``args`` → the report (``meta`` and ``rows``).
    ``init_params`` (a numpy tree) replaces the port's init and
    ``draws_for`` the compiled tiers' draws (the parity tests hand in the
    reference's)."""
    device = resolve_device(args.device)
    model, ex, ol, ns = _fixture(args, device)
    churn_scn = ScenarioSpec(churn=ChurnSpec(rate=args.churn_rate))

    rows: Dict[str, Dict[str, Any]] = {}
    # (name, donate, telemetry, batch_k, scenario) — batch_k is
    # async-only: the batched tier pins an explicit K-event wave width;
    # the churn tier is sync-only (the scenario-path program with a
    # dropout schedule, gated <10% per-round over the bare one)
    tiers = [("ingraph", False, None, None, None),
             ("ingraph_donate", True, None, None, None),
             ("ingraph_telemetry", False, args.telemetry_ring, None, None),
             ("ingraph_batched", False, None, args.async_batch_k, None),
             ("ingraph_churn", False, None, None, churn_scn)]
    for mode in ("sync", "async"):
        if not args.skip_host:
            rows[f"el_{mode}_host"] = bench_host(model, ex, ol, ns, mode,
                                                 init_params)
            print(f"el_{mode}_host: "
                  f"{rows[f'el_{mode}_host']['us_per_aggregation']:.0f} "
                  "us/agg", flush=True)
        for name, donate, telem, batch_k, scn in tiers:
            if batch_k is not None and mode != "async":
                continue
            if scn is not None and mode != "sync":
                continue
            row = bench_compiled(model, ex, ol, ns, mode, args,
                                 telemetry=telem, batch_k=batch_k,
                                 scenario=scn, init_params=init_params,
                                 draws_for=draws_for, donate=donate)
            rows[f"el_{mode}_{name}"] = row
            _print_row(f"el_{mode}_{name}", row)
        # instrumented/scenario per-round cost vs the bare program — the
        # acceptance bound for both is <10% (bench_check gates any row
        # carrying overhead_vs_ingraph_pct)
        base = rows[f"el_{mode}_ingraph"]["us_per_aggregation"]
        over = [f"el_{mode}_ingraph_telemetry"]
        if mode == "sync":
            over.append("el_sync_ingraph_churn")
        for tier_name in over:
            trow = rows[tier_name]
            trow["overhead_vs_ingraph_pct"] = (
                (trow["us_per_aggregation"] - base) / max(base, 1e-9)
                * 100)
            print(f"{tier_name} overhead: "
                  f"{trow['overhead_vs_ingraph_pct']:+.1f}%", flush=True)

    draws = None
    if draws_for is not None:
        draws = {mode: draws_for(dataclasses.replace(ol, mode=mode),
                                 ex.batch, horizon)
                 for mode, horizon in (("sync", args.max_rounds),
                                       ("async", args.max_events))}
    sharded = sharded_rows(args, device, init_params, draws)
    rows.update(sharded["rows"])
    for name, row in sharded["rows"].items():
        _print_row(name, row)

    meta = {
        "workload": "svm-wafer",
        "edges": args.edges, "samples": args.samples,
        "batch": args.batch, "budget": args.budget,
        "max_rounds": args.max_rounds, "max_events": args.max_events,
        "devices": args.devices, "mesh": sharded["mesh"],
        "ranks": {"count": args.devices, "backend": SHARDED_BACKEND,
                  "device": device.type,
                  "cards": 1 if device.type == "cuda" else 0,
                  "rows": sorted(sharded["rows"])},
        "repeats": args.repeats,
        "async_batch_k": {
            "batched_tier": int(args.async_batch_k),
            "sharded_auto": sharded["sharded_auto"],
        },
        "churn": {"rate": float(args.churn_rate),
                  "period": churn_scn.period},
        "backend": device.type, "torch": torch.__version__,
        **card_meta(device),
        "note": (f"wall-clock on the {device.type} device's host, every "
                 "timed call ending in a synchronize; wall_us is "
                 "min-of-repeats (wall_us_stats carries the spread); "
                 "profile fields are repro_torch.obs.prof.profile_jit's: "
                 "static buffer bytes, the allocator's chunk peak (CUDA "
                 "only), the matmul flops of one step, the collective "
                 "census (empty on one device); the *_sharded* rows are "
                 f"rank 0's of {args.devices} {SHARDED_BACKEND} ranks on "
                 "a {} x {} (data, model) mesh".format(
                     *sharded["mesh"].values())
                 + (" sharing the one card: their gathers go through host "
                    "memory and their chunks run eagerly"
                    if device.type == "cuda" else "")),
    }
    return {"meta": meta, "rows": rows}


def _print_row(name: str, row: Dict[str, Any]) -> None:
    peak = row.get("peak_live_bytes")
    print(f"{name}: {row['us_per_aggregation']:.0f} us/agg, peak "
          f"{peak if peak is None else f'{peak / 1e6:.2f}MB'}", flush=True)


def sharded_rows(args, device: torch.device, init_params=None,
                 draws: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The four sharded tiers, from one world of ``args.devices`` ranks
    (:func:`rank_main`): ``{"rows", "mesh", "sharded_auto"}``, rank 0's.
    ``draws``: per mode a provider every call of that mode's tiers
    replays (default: the session's generator, as in-process)."""
    spec = {"args": vars(args), "device": str(device),
            "init_params": init_params, "draws": draws}
    with tempfile.TemporaryDirectory(prefix="bench_el_ranks_") as td:
        path = os.path.join(td, "spec.pkl")
        with open(path, "wb") as f:
            pickle.dump(spec, f)
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [src, os.environ.get("PYTHONPATH", "")]))
        procs = spawn_ranks(args.devices, [
            sys.executable, "-m", "repro_torch.bench.bench_el",
            "--rank-spec", path], env=env, capture=True, timeout=1800)
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"bench_el: sharded rank {r} exited "
                                   f"{p.returncode}:\n{p.stderr[-4000:]}")
        with open(os.path.join(td, "rows.pkl"), "rb") as f:
            return pickle.load(f)


def rank_main(spec_path: str) -> None:
    """One rank of :func:`sharded_rows`' world: every sharded tier of both
    modes over the debug mesh of ``--devices`` ranks; rank 0 writes its
    rows beside the spec."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh_for
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    args = argparse.Namespace(**spec["args"])
    device = resolve_device(spec["device"])
    mesh = make_debug_mesh_for(args.devices, device=device,
                               backend=SHARDED_BACKEND)
    model, ex, ol, ns = _fixture(args, device)
    draws = spec["draws"]
    draws_for = None if draws is None else (
        lambda cfg, batch, horizon: copy.deepcopy(draws[cfg.mode]))
    rows = {}
    for mode in ("sync", "async"):
        for name, donate in SHARDED_TIERS:
            rows[f"el_{mode}_{name}"] = bench_compiled(
                model, ex, ol, ns, mode, args,
                init_params=spec["init_params"], draws_for=draws_for,
                mesh=mesh, donate=donate)
    if mesh.rank == 0:
        out = {"rows": rows, "mesh": dict(mesh.shape),
               "sharded_auto": resolve_async_batch_k(
                   dataclasses.replace(ol, mode="async"), mesh)}
        with open(os.path.join(os.path.dirname(spec_path), "rows.pkl"),
                  "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="single-run EL data-plane benchmark -> "
                    "BENCH_torch_el.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--devices", type=int, default=SHARDED_RANKS,
                    help="ranks of the sharded tiers' world (the debug "
                         "mesh is (devices//2, 2))")
    ap.add_argument("--edges", type=int, default=8)
    ap.add_argument("--samples", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--budget", type=float, default=4000.0)
    ap.add_argument("--max-rounds", type=int, default=64)
    ap.add_argument("--max-events", type=int, default=256)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--async-batch-k", type=int, default=4,
                    help="explicit K of the el_async_ingraph_batched "
                         "tier (the K-event wave program)")
    ap.add_argument("--telemetry-ring", type=int, default=64,
                    help="ring length of the el_*_ingraph_telemetry "
                         "tiers (repro_torch.obs.rings)")
    ap.add_argument("--churn-rate", type=float, default=0.25,
                    help="dropout rate of the el_sync_ingraph_churn "
                         "tier's scenario (repro_torch.el.scenarios)")
    ap.add_argument("--skip-host", action="store_true",
                    help="omit the slow host-loop baselines")
    ap.add_argument("--out", default="BENCH_torch_el.json")
    ap.add_argument("--history", default="BENCH_torch_history.jsonl",
                    help="append a schema-versioned entry here "
                         "(repro_torch.bench.bench_check reads it)")
    ap.add_argument("--no-history", action="store_true",
                    help="skip the history append")
    return ap


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--rank-spec"]:
        rank_main(argv[1])
        return
    args = parser().parse_args(argv)
    report = bench(args)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {args.out}")
    if not args.no_history:
        append_history(args.history, "el", report["meta"], report["rows"])
        print(f"appended to {args.history}")


if __name__ == "__main__":
    main()
