"""The bench-regression gate → exit codes CI can act on.

The reference's ``scripts/bench_check.py`` over ``repro_torch.obs.prof``
and ``repro_torch.obs.regress``.  Three modes over the port's committed
bench artifacts (``BENCH_torch_el.json``, ``BENCH_torch_fleet.json``) and
its known-regression ledger (``BENCH_torch_ledger.json``):

  * **default** (no flags) — validate the committed baselines
    themselves: every ledgered row is checked against its in-run
    reference (within-run ratios are host-speed independent), and every
    compiled EL row's recorded collective census / alias bytes is
    checked against the declarative contracts (sharded rows
    gather-before-reduce: ``all-reduce == 0``; donated rows alias the
    param tree, non-donated rows alias nothing), and every telemetry
    tier's recorded within-run overhead must sit under the
    ``repro_torch.obs`` acceptance bound (<10%/aggregation);
  * ``--fresh FILE [--baseline FILE] --bench el|fleet`` — row-by-row
    comparison of a fresh same-config run against a baseline with the
    per-metric relative tolerances (``repro_torch.obs.regress.
    DEFAULT_TOLERANCES``), plus the ledger/contract checks on the
    fresh rows;
  * ``--smoke`` — the CI gate: run a small ``repro_torch.bench.bench_el``
    on ``--device`` (default CUDA), check contracts + ledger on the fresh
    rows, and compare WITHIN-RUN tier ratios (``SMOKE_PAIRS``) against
    the committed baseline — sizes differ between a smoke and the
    committed run, but a tier suddenly costing 3x its reference when the
    baseline says 1.2x is structural.  The smoke run is appended to
    ``BENCH_torch_history.jsonl`` (``--no-history`` to skip).

Exit codes: ``0`` ok · ``1`` regression (gate fails) · ``2`` usage/IO
error · ``3`` failing-better (a ledgered regression is FIXED — remove
the stale ``BENCH_torch_ledger.json`` entry and keep the win).

    PYTHONPATH=src python -m repro_torch.bench.bench_check          # baselines
    PYTHONPATH=src python -m repro_torch.bench.bench_check --smoke  # CI gate
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.obs.prof import (DEFAULT_GATHER_RANGE, CollectiveContract,
                                  ProgramProfile)
from repro_torch.obs.regress import (Finding, append_history, check_ledger,
                                     compare_ratios, compare_to_baseline,
                                     load_ledger, worst_exit_code)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

#: within-run tier ratios the smoke gate tracks (row, reference); the
#: us_per_aggregation ratio between these pairs is scale-robust (the
#: sharded rows come from bench_el's 4 gloo ranks)
SMOKE_PAIRS = (
    ("el_sync_sharded", "el_sync_ingraph"),
    ("el_sync_sharded_donate", "el_sync_ingraph"),
    ("el_async_sharded", "el_async_ingraph"),
    ("el_async_sharded_donate", "el_async_ingraph"),
    ("el_sync_ingraph_telemetry", "el_sync_ingraph"),
    ("el_async_ingraph_telemetry", "el_async_ingraph"),
    ("el_async_ingraph_batched", "el_async_ingraph"),
    ("el_sync_ingraph_churn", "el_sync_ingraph"),
)

#: the instrumentation acceptance bound: an in-graph add-on tier (the
#: telemetry rings, the scenario engine's churn path) may cost at most
#: this much per aggregation over the bare program (a within-run
#: percentage, so host-speed independent)
TELEMETRY_OVERHEAD_PCT = 10.0


def telemetry_findings(rows: Mapping[str, Mapping[str, Any]],
                       *, bench: str = "el") -> List[Finding]:
    """The per-round overhead tolerance rows: every tier that recorded a
    within-run ``overhead_vs_ingraph_pct`` (the ``*_telemetry`` rings,
    the ``*_churn`` scenario path) must sit under
    :data:`TELEMETRY_OVERHEAD_PCT`."""
    findings: List[Finding] = []
    for name in sorted(rows):
        pct = rows[name].get("overhead_vs_ingraph_pct")
        if pct is None:
            continue
        if pct > TELEMETRY_OVERHEAD_PCT:
            findings.append(Finding(
                "regression", bench, name, "telemetry_overhead",
                f"in-graph add-on costs {pct:+.2f}%/agg over the bare "
                f"program (bound: +{TELEMETRY_OVERHEAD_PCT:.0f}%)"))
        else:
            findings.append(Finding(
                "ok", bench, name, "telemetry_overhead",
                f"{pct:+.2f}% <= +{TELEMETRY_OVERHEAD_PCT:.0f}%"))
    return findings


def _row_profile(row: Mapping[str, Any]) -> ProgramProfile:
    """Rehydrate the profile-shaped fields of a BENCH row (enough for a
    :class:`CollectiveContract` check)."""
    return ProgramProfile(
        alias_bytes=row.get("alias_bytes"),
        collectives=row.get("collectives") or {},
    )


def contract_findings(rows: Mapping[str, Mapping[str, Any]],
                      *, bench: str = "el") -> List[Finding]:
    """The declarative contracts over recorded BENCH rows.

    * ``*_sharded*`` rows: gather-before-reduce — at least one
      all-gather, zero all-reduce / reduce-scatter / all-to-all;
    * other compiled rows: no collectives at all;
    * ``*_donate`` rows: ``alias_bytes > 0`` and identical across every
      donated row of the bench (one param tree — one alias size);
    * non-donated rows: ``alias_bytes == 0``.

    Host rows (no census recorded) are skipped.
    """
    findings: List[Finding] = []
    donate_alias: Dict[str, int] = {}
    for name in sorted(rows):
        row = rows[name]
        if "collectives" not in row:
            continue                      # host rows carry no profile
        donated = name.endswith("_donate")
        if "sharded" in name:
            counts = {"all-gather": DEFAULT_GATHER_RANGE,
                      "all-reduce": 0, "reduce-scatter": 0,
                      "all-to-all": 0}
        else:
            counts = {"all-gather": 0, "all-reduce": 0,
                      "reduce-scatter": 0, "all-to-all": 0,
                      "collective-permute": 0}
        contract = CollectiveContract(
            name=name, counts=counts,
            alias_bytes=None if donated else 0)
        for bad in contract.check(_row_profile(row)):
            findings.append(Finding("regression", bench, name,
                                    "contract", bad))
        alias = row.get("alias_bytes")
        if donated:
            if not isinstance(alias, int) or alias <= 0:
                findings.append(Finding(
                    "regression", bench, name, "contract",
                    f"donated row aliased {alias!r} bytes (expected the "
                    "param tree > 0 — donation fell off)"))
            else:
                donate_alias[name] = alias
    if len(set(donate_alias.values())) > 1:
        findings.append(Finding(
            "regression", bench, "/".join(sorted(donate_alias)),
            "contract",
            f"donated rows alias different byte counts: {donate_alias} "
            "(one param tree must alias one size)"))
    if not findings:
        findings.append(Finding("ok", bench, "*", "contract",
                                "census + alias contracts hold"))
    return findings


def _load_rows(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)["rows"]


def _report(findings: Sequence[Finding]) -> int:
    for f in findings:
        if f.kind != "ok":
            print(f)
    code = worst_exit_code(findings)
    n_reg = sum(f.kind == "regression" for f in findings)
    n_fix = sum(f.kind == "fixed" for f in findings)
    n_known = sum(f.kind == "known" for f in findings)
    verdict = {0: "OK", 1: "REGRESSION", 3: "FAILING-BETTER"}[code]
    print(f"bench_check: {verdict} ({len(findings)} checks, "
          f"{n_reg} regressions, {n_known} known, {n_fix} fixed)")
    return code


class MissingArtifact(Exception):
    """A bench artifact the mode reads is missing (exit code 2)."""


def _require(*paths: str) -> None:
    for p in paths:
        if not os.path.exists(p):
            raise MissingArtifact(p)


#: a finding with the gate that made it: ``ledger``, ``contract``,
#: ``telemetry``, ``baseline`` or ``ratio``
Gated = Tuple[str, Finding]


def _gated(gate: str, found: Sequence[Finding]) -> List[Gated]:
    return [(gate, f) for f in found]


def baseline_findings(args) -> List[Gated]:
    """Default mode: the committed artifacts must satisfy their own
    ledger and contracts."""
    ledger = load_ledger(args.ledger)
    found: List[Gated] = []
    for bench, path in (("el", args.el), ("fleet", args.fleet)):
        _require(path)
        rows = _load_rows(path)
        found += _gated("ledger", check_ledger(rows, ledger, bench=bench))
        if bench == "el":
            found += _gated("contract", contract_findings(rows, bench=bench))
            found += _gated("telemetry",
                            telemetry_findings(rows, bench=bench))
    return found


def fresh_findings(args) -> List[Gated]:
    """``--fresh``: a fresh same-config run against a baseline."""
    baseline = args.baseline or (args.el if args.bench == "el"
                                 else args.fleet)
    _require(args.fresh, baseline)
    ledger = load_ledger(args.ledger)
    fresh = _load_rows(args.fresh)
    found = _gated("baseline", compare_to_baseline(
        _load_rows(baseline), fresh, bench=args.bench, ledger=ledger))
    found += _gated("ledger", check_ledger(fresh, ledger, bench=args.bench))
    if args.bench == "el":
        found += _gated("contract", contract_findings(fresh,
                                                      bench=args.bench))
        found += _gated("telemetry", telemetry_findings(fresh,
                                                        bench=args.bench))
    return found


def smoke_findings(args) -> List[Gated]:
    """``--smoke``: a small fresh ``bench_el`` run on ``--device``, its
    sharded tiers over ``--devices`` ranks, contract-checked and
    ratio-compared against the committed baseline.
    A failed smoke bench raises ``RuntimeError`` (exit code 2)."""
    _require(args.el)
    cmd = [sys.executable, "-m", "repro_torch.bench.bench_el",
           "--edges", "4", "--samples", "512", "--batch", "64",
           "--budget", "300", "--max-rounds", "16", "--max-events", "64",
           "--repeats", "2", "--skip-host", "--no-history",
           "--devices", str(args.devices)]
    if args.device is not None:
        cmd += ["--device", args.device]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), env.get("PYTHONPATH", "")])
    with tempfile.TemporaryDirectory(prefix="bench_smoke_") as td:
        out = os.path.join(td, "BENCH_torch_el_smoke.json")
        cmd += ["--out", out]
        print("bench_check: smoke run:", " ".join(cmd), flush=True)
        if subprocess.run(cmd, env=env).returncode != 0:
            raise RuntimeError("bench_check: smoke bench failed")
        with open(out) as f:
            smoke = json.load(f)
    ledger = load_ledger(args.ledger)
    found = _gated("contract", contract_findings(smoke["rows"], bench="el"))
    found += _gated("ratio", compare_ratios(
        _load_rows(args.el), smoke["rows"], bench="el",
        metric="us_per_aggregation", pairs=SMOKE_PAIRS, ledger=ledger,
        slack=args.slack))
    found += _gated("ledger", check_ledger(smoke["rows"], ledger,
                                           bench="el"))
    if not args.no_history:
        append_history(args.history, "el-smoke", smoke["meta"],
                       smoke["rows"])
        print(f"bench_check: appended smoke run to {args.history}")
    return found


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="bench regression gate over BENCH_torch_*.json")
    ap.add_argument("--el",
                    default=os.path.join(ROOT, "BENCH_torch_el.json"))
    ap.add_argument("--fleet",
                    default=os.path.join(ROOT, "BENCH_torch_fleet.json"))
    ap.add_argument("--ledger",
                    default=os.path.join(ROOT, "BENCH_torch_ledger.json"))
    ap.add_argument("--history",
                    default=os.path.join(ROOT, "BENCH_torch_history.jsonl"))
    ap.add_argument("--fresh", help="fresh BENCH json to compare")
    ap.add_argument("--baseline",
                    help="baseline for --fresh (default: the committed "
                         "artifact of --bench)")
    ap.add_argument("--bench", choices=("el", "fleet"), default="el",
                    help="which bench --fresh came from")
    ap.add_argument("--smoke", action="store_true",
                    help="run a small bench_el and gate on within-run "
                         "tier ratios + contracts (the CI step)")
    ap.add_argument("--device", default=None,
                    help="torch device of the --smoke run (default: cuda)")
    ap.add_argument("--devices", type=int, default=4,
                    help="ranks of the --smoke run's sharded tiers "
                         "(bench_el --devices)")
    ap.add_argument("--slack", type=float, default=1.5,
                    help="allowed relative worsening of within-run "
                         "ratios in --smoke (1.5 = 150%%)")
    ap.add_argument("--no-history", action="store_true",
                    help="skip the history append in --smoke")
    return ap


def findings(args) -> List[Gated]:
    """The findings of the mode ``args`` select, each with its gate, in
    the reference's order."""
    if args.smoke:
        return smoke_findings(args)
    if args.fresh:
        return fresh_findings(args)
    return baseline_findings(args)


def main(argv: Optional[List[str]] = None) -> int:
    args = parser().parse_args(argv)
    try:
        found = findings(args)
    except MissingArtifact as e:
        print(f"bench_check: missing {e}", file=sys.stderr)
        return 2
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2
    return _report([f for _, f in found])


if __name__ == "__main__":
    raise SystemExit(main())
