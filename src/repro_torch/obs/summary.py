"""Summarize (and CI-assert) a ``--metrics-out`` artifact set.

Reads the three files the launchers write — ``PATH`` (Prometheus text),
``PATH.json`` (the same registry as JSON) and ``PATH.spans.jsonl`` (the
streamed tracer spans/events) — and prints a human summary: every
metric with its samples, plus per-span-name duration stats aggregated
from the JSONL.  The reference's ``scripts/obs_summary.py`` over
``repro_torch.obs.{metrics,timing,trace}``.

CI assertion flags (exit non-zero on violation):

  * ``--check NAME[,NAME...]``         — these metric names must appear
    in the Prometheus exposition (and it must parse strictly);
  * ``--require-spans NAME[,NAME...]`` — the spans JSONL must contain at
    least one span/event per name.

    PYTHONPATH=src python -m repro_torch.obs.summary /tmp/fleet.prom \\
        --check fleet_waves_total,fleet_compiles_total \\
        --require-spans fleet.compile,cohort.wave,cohort.refill
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.obs.metrics import parse_prometheus
from repro_torch.obs.timing import summarize_ns
from repro_torch.obs.trace import read_jsonl


def summarize_spans(events):
    """Per-name span duration stats (+ plain event counts)."""
    spans, counts = {}, {}
    for ev in events:
        name = ev.get("name", "?")
        if ev.get("ev") == "span":
            spans.setdefault(name, []).append(
                int(float(ev.get("dur_us", 0.0)) * 1e3))   # us -> ns
        else:
            counts[name] = counts.get(name, 0) + 1
    return ({n: summarize_ns(s) for n, s in sorted(spans.items())},
            dict(sorted(counts.items())))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="summarize a launcher --metrics-out artifact set")
    ap.add_argument("path", help="the Prometheus text file (PATH); "
                                 "PATH.spans.jsonl is read when present")
    ap.add_argument("--check", default=None, metavar="NAMES",
                    help="comma-separated metric names that must appear "
                         "in the exposition (CI assertion)")
    ap.add_argument("--require-spans", default=None, metavar="NAMES",
                    help="comma-separated span/event names that must "
                         "appear in PATH.spans.jsonl (CI assertion)")
    args = ap.parse_args(argv)

    with open(args.path) as f:
        text = f.read()
    metrics = parse_prometheus(text)
    print(f"{args.path}: {len(metrics)} metrics")
    for name, samples in sorted(metrics.items()):
        vals = ", ".join(
            f"{s['labels'] or ''}{'=' if s['labels'] else ''}"
            f"{s['value']:g}" for s in samples[:4])
        more = f" (+{len(samples) - 4} more)" if len(samples) > 4 else ""
        print(f"  {name}: {vals}{more}")

    prof_names = [n for n in metrics if n.startswith("el_profile_")]
    if prof_names:
        print("\nprogram profile (repro_torch.obs.prof):")
        for scalar in ("el_profile_flops", "el_profile_peak_live_bytes",
                       "el_profile_alias_bytes",
                       "el_profile_collective_bytes"):
            if scalar in metrics:
                v = metrics[scalar][0]["value"]
                print(f"  {scalar.removeprefix('el_profile_')}: {v:g}")
        for s in metrics.get("el_profile_collectives", []):
            op = s["labels"].get("op", "?")
            print(f"  collective {op}: x{s['value']:g}")

    scn_names = [n for n in metrics if n.startswith("el_scenario_")]
    if scn_names:
        print("\nfleet dynamics (repro_torch.el.scenarios):")
        for name in ("el_scenario_active_edges",
                     "el_scenario_dropouts_total",
                     "el_scenario_rejoins_total"):
            if name in metrics:
                v = metrics[name][0]["value"]
                print(f"  {name.removeprefix('el_scenario_')}: {v:g}")

    spans_path = args.path + ".spans.jsonl"
    span_names = set()
    if os.path.exists(spans_path):
        events = read_jsonl(spans_path)
        span_names = {e.get("name") for e in events}
        stats, counts = summarize_spans(events)
        print(f"\n{spans_path}: {len(events)} records")
        for name, st in stats.items():
            print(f"  span {name}: n={st['count']} "
                  f"p50={st['p50'] / 1e3:.0f}us "
                  f"p90={st['p90'] / 1e3:.0f}us "
                  f"max={st['max'] / 1e3:.0f}us")
        for name, n in counts.items():
            print(f"  event {name}: n={n}")

    failures = []
    if args.check:
        for name in args.check.split(","):
            if name and name not in metrics:
                failures.append(f"metric {name!r} missing from "
                                f"{args.path}")
    if args.require_spans:
        if not os.path.exists(spans_path):
            failures.append(f"{spans_path} not found")
        else:
            for name in args.require_spans.split(","):
                if name and name not in span_names:
                    failures.append(f"span/event {name!r} missing from "
                                    f"{spans_path}")
    if failures:
        for f_ in failures:
            print(f"ERROR: {f_}", file=sys.stderr)
        raise SystemExit(1)
    if args.check or args.require_spans:
        print("\nall checks passed")


if __name__ == "__main__":
    main()
