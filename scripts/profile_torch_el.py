#!/usr/bin/env python3
"""Where the card's time goes when the PyTorch port runs an EL session.

    PYTHONPATH=src python scripts/profile_torch_el.py

Builds the full-width kmeans-traffic and svm-wafer fixtures on the card as
``chip_smoke.py`` does (``repro_torch.launch.classic.classic_fixture``:
20,000 samples, 4 edges, budget 5000 per edge), warms each path up once
(the compiled round captures its CUDA graph there), then profiles one run
of each path under ``torch.profiler`` with the card synchronised around
it:

  host_sync      ``ELSession.run_sync`` (kmeans-traffic only), the host
                 loop: one eager launch per op, a sync per round;
  compiled_sync  ``ELSession.run_sync_ingraph``: chunks of masked rounds,
                 each a CUDA graph replay, one sync per chunk.

Prints one JSON line per (arch, path):

  wall_ms        host clock around the run;
  device_ms      union of the intervals in which a kernel ran (CUPTI);
  idle_share     1 - device_ms / wall_ms;
  kernels        kernel launches the profiler saw;
  top            the kernels with the most device time, with their count;
  replay_ms      (compiled) one chunk's graph replay timed by CUDA events,
                 the card's time for R rounds with no host in the way;
  rounds, chunks, replays  from the report's ``device_loop``;

then the card's name and power limit (nvidia-smi).  Fails when there is no
card or the profiler reports no device time for a path.
"""

from __future__ import annotations

import dataclasses
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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from repro_torch.el import ELSession
    from repro_torch.launch.classic import classic_fixture

    for arch in ("kmeans-traffic", "svm-wafer"):
        fx = classic_fixture(arch, samples=SAMPLES, n_edges=EDGES,
                             device="cuda")
        cfg = dataclasses.replace(fx["exp"].ol4el, mode="sync",
                                  n_edges=EDGES, utility=fx["utility"])

        def session():
            return (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
                    .with_executor(fx["executor"],
                                   init_params=fx["init_params"],
                                   n_samples=fx["n_samples"]))

        paths = [("compiled_sync", session(), "run_sync_ingraph")]
        if arch == "kmeans-traffic":
            paths.insert(0, ("host_sync", session(), "run_sync"))
        for name, sess, method in paths:
            run = getattr(sess, method)
            run()                              # warm-up (graph capture)
            out, rep = profile_run(name, run)
            out.update(arch=arch, rounds=rep.n_aggregations,
                       reason=rep.terminated_reason,
                       card=torch.cuda.get_device_name(0))
            if rep.telemetry:
                loop = rep.telemetry["device_loop"]
                out.update(chunks=loop["chunks"], replays=loop["replays"],
                           rounds_per_chunk=loop["rounds_per_chunk"],
                           replay_ms=replay_ms(
                               list(sess.compile_cache.values())[-1]))
            print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
