#!/usr/bin/env python3
"""Where the card's time goes when the PyTorch port runs an EL session.

    PYTHONPATH=src python scripts/profile_torch_el.py

Builds the full-width kmeans-traffic and svm-wafer fixtures on the card as
``chip_smoke.py`` does (``repro_torch.launch.classic.classic_fixture``:
20,000 samples, 4 edges, budget 5000 per edge), warms each path up once
(the compiled programs capture their CUDA graphs there), then profiles one
run of each path under ``torch.profiler`` with the card synchronised
around it:

  host_sync          ``ELSession.run_sync`` (kmeans-traffic only), the
                     host loop: one eager launch per op, a sync per round;
  compiled_sync      ``ELSession.run_sync_ingraph``: chunks of masked
                     rounds, each a CUDA graph replay, one sync per chunk;
  host_async         ``ELSession.run_async`` (numpy streams), the host
                     event-queue loop;
  compiled_async     ``ELSession.run_async_ingraph``: chunks of masked
                     event steps, single events;
  compiled_async_k4  the same with K-event waves of 4 (``async_batch_k``);
  sweep_sync_24      ``ELSession.sweep`` of the 24-cell sync grid of
                     ``chip_smoke.py`` phase 4d (ucb_c 0.5 / 1 / 2 x budget
                     2500 / 5000 x heterogeneity 1 / 6 x seeds 0 / 1): the
                     compiled round's masked step vmapped over the cells,
                     one graph replay a chunk for the whole grid.

Prints one JSON line per (arch, path):

  wall_ms        host clock around the profiled run;
  device_ms      union of the intervals in which a kernel ran (CUPTI);
  idle_share     1 - device_ms / wall_ms (the profiler's overhead counts
                 as idle);
  kernels        kernel launches the profiler saw, and per round or event;
  top            the kernels with the most device time, with their count;
  rounds         rounds or events of the run;
  (compiled)     replay_ms, one chunk's graph replay timed by CUDA events,
                 the card's time for one chunk with no host in the way;
                 chunks, replays; plain_wall_ms, the fastest of three
                 unprofiled runs by the host clock; idle_share_events, 1 - replays x replay_ms /
                 plain_wall_ms (every chunk replays the whole graph);
                 fill_ms and launch_ms, the host's time to refill a
                 chunk's draws (a sweep: every cell's, from its own
                 generator) and to launch its graph; a sweep also gives
                 cells and kernels_per_graph_round, the kernels a replay
                 runs over its rounds (masked or not);

then the card's name and power limit (nvidia-smi).  Fails when there is no
card or the profiler reports no device time for a path.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SAMPLES, EDGES = 20000, 4


def device_events(prof):
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda]


def busy_ms(events) -> float:
    """Length of the union of the events' [start, end) intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3                        # profiler times are in us


def profile_run(name: str, fn):
    """Run ``fn`` under the profiler, the card synchronised around it;
    returns the run's summary and ``fn``'s result."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    if not events:
        raise SystemExit(f"{name}: the profiler saw no device time")
    per_name = defaultdict(lambda: [0, 0.0])
    for e in events:
        per_name[e.name][0] += 1
        per_name[e.name][1] += (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:10]
    dev = busy_ms(events)
    return {"path": name, "wall_ms": wall, "device_ms": dev,
            "idle_share": 1.0 - dev / wall, "kernels": len(events),
            "top": [{"name": n[:100], "count": c, "ms": ms}
                    for n, (c, ms) in top]}, out


def replay_ms(program, iters: int = 20) -> float:
    """One chunk's graph replay, timed by CUDA events (every round of a
    chunk runs its kernels, masked or not)."""
    import torch
    program.graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        program.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(program, iters: int = 5) -> dict:
    """The host's share of one chunk, the card kept busy by a queued
    sleep so that no call waits for it: the refill of the draw buffers
    from a ``TorchDraws`` (fresh blocks each time; a sweep: one per
    cell) and the graph's launch (``replay()`` returning), each by the
    host clock.  Each chunk starts from an empty launch queue (a sweep's
    refill enqueues ~10 small kernels a cell, and a full queue would
    make the host wait for the sleep)."""
    import torch
    from repro_torch.el.rng import CellDraws, TorchDraws

    def torch_draws(seed):
        return TorchDraws(torch.Generator(device="cuda").manual_seed(seed))
    cells = program.n_cells
    draws = torch_draws(0) if cells is None else CellDraws(
        [torch_draws(c) for c in range(cells)])
    if program.init_bufs:
        draws.fill_init(program.init_bufs)
    items = program.rounds_per_chunk * program.cell.items_per_step
    fill, launch = [], []
    for i in range(iters):
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)        # ~0.1 s of queued card work
        t0 = time.perf_counter()
        draws.fill(program.draw_bufs,
                   i * items if cells is None else [i * items] * cells)
        t1 = time.perf_counter()
        program.graph.replay()
        t2 = time.perf_counter()
        fill.append((t1 - t0) * 1e3)
        launch.append((t2 - t1) * 1e3)
    torch.cuda.synchronize()
    return {"fill_ms": sum(fill) / iters, "launch_ms": sum(launch) / iters}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from repro_torch.el import ELSession
    from repro_torch.el.sweep import SweepSpec
    from repro_torch.launch.classic import classic_fixture
    grid = SweepSpec(ucb_c=(0.5, 1.0, 2.0), budget=(2500.0, 5000.0),
                     heterogeneity=(1.0, 6.0), seeds=(0, 1), max_rounds=256)

    for arch in ("kmeans-traffic", "svm-wafer"):
        fx = classic_fixture(arch, samples=SAMPLES, n_edges=EDGES,
                             device="cuda")

        def session(mode, batch_k=0):
            cfg = dataclasses.replace(fx["exp"].ol4el, mode=mode,
                                      n_edges=EDGES, utility=fx["utility"],
                                      async_batch_k=batch_k)
            return (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
                    .with_executor(fx["executor"],
                                   init_params=fx["init_params"],
                                   n_samples=fx["n_samples"]))

        paths = [("compiled_sync", session("sync"), "run_sync_ingraph"),
                 ("host_async", session("async"), "run_async"),
                 ("compiled_async", session("async"), "run_async_ingraph"),
                 ("compiled_async_k4", session("async", 4),
                  "run_async_ingraph"),
                 ("sweep_sync_24", session("sync"), "sweep")]
        if arch == "kmeans-traffic":
            paths.insert(0, ("host_sync", session("sync"), "run_sync"))
        for name, sess, method in paths:
            run = getattr(sess, method)
            if method == "sweep":
                run = functools.partial(run, grid)
            run()                              # warm-up (graph capture)
            out, rep = profile_run(name, run)
            out.update(arch=arch, card=torch.cuda.get_device_name(0))
            if method == "sweep":
                loop = rep.telemetry["device_loops"][0]
                rounds = int(rep.out["n_rounds"].max())
                out.update(cells=rep.n_cells, rounds=rounds,
                           kernels_per_round=out["kernels"] / rounds,
                           kernels_per_graph_round=out["kernels"] / (
                               loop["replays"] * loop["rounds_per_chunk"]),
                           truncated=int(rep.truncated().sum()))
            else:
                out.update(rounds=rep.n_aggregations,
                           kernels_per_round=out["kernels"]
                           / rep.n_aggregations,
                           reason=rep.terminated_reason)
                loop = (rep.telemetry or {}).get("device_loop")
            if loop:
                program = list(sess.compile_cache.values())[-1]
                one = replay_ms(program)
                out.update(host_ms(program))
                plain = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    plain.append((time.perf_counter() - t0) * 1e3)
                plain = min(plain)
                out.update(chunks=loop["chunks"], replays=loop["replays"],
                           rounds_per_chunk=loop["rounds_per_chunk"],
                           batch_k=loop.get("batch_k"), replay_ms=one,
                           plain_wall_ms=plain,
                           idle_share_events=1.0 - loop["replays"] * one
                           / plain)
            print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
