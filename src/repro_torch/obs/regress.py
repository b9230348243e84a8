"""Bench-regression bookkeeping: history, baselines, tolerances, ledger.

A copy of the reference's ``repro.obs.regress`` (json, ``git`` and the
standard library only), so the port's bench gate (ROADMAP Queue 1 item
15) reads and writes the same history and ledger files.

The reference's bench scripts (``scripts/bench_el.py`` /
``scripts/bench_fleet.py``) append every run as one schema-versioned JSONL entry to
``BENCH_history.jsonl`` — commit, timestamp, meta, rows — so the perf
trajectory across PRs is a file, not archaeology.  ``scripts/
bench_check.py`` then compares a fresh run against the committed
baselines with per-metric tolerances and a *ledger* of known
regressions (``BENCH_ledger.json``): rows declared expected-slow
relative to a reference row are exempt from the gate, and when a PR
actually fixes one the gate flips to "failing better" so the stale
ledger entry gets removed instead of silently masking the win.

Metric direction matters: ``us_per_aggregation`` regressing means
going UP, ``tenants_per_sec`` regressing means going DOWN.  All
comparisons are relative (ratios), so the within-run ratio checks are
robust to host speed; absolute fresh-vs-baseline comparisons are for
same-config runs on the same class of host.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

#: history/ledger schema version (bump on breaking row changes)
SCHEMA_VERSION = 1

#: metrics where larger is BETTER (everything else: smaller is better)
HIGHER_IS_BETTER = frozenset({"tenants_per_sec"})

#: default relative tolerances for fresh-vs-baseline comparison —
#: wall-clock on a shared CPU host is noisy, byte counts are exact
DEFAULT_TOLERANCES: Dict[str, float] = {
    "us_per_aggregation": 0.25,
    "wall_us": 0.25,
    "wall_s": 0.25,
    "tenants_per_sec": 0.25,
    "peak_live_bytes": 0.05,
}


def git_commit(cwd: Optional[str] = None) -> Optional[str]:
    """Best-effort ``git rev-parse HEAD`` (None outside a checkout)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=cwd,
            capture_output=True, text=True, timeout=10)
        return out.stdout.strip() or None if out.returncode == 0 else None
    except Exception:                                       # pragma: no cover
        return None


def history_entry(kind: str, meta: Mapping[str, Any],
                  rows: Mapping[str, Any], *,
                  commit: Optional[str] = None,
                  timestamp: Optional[float] = None) -> Dict[str, Any]:
    """One schema-versioned history record (not yet written)."""
    return {
        "schema": SCHEMA_VERSION,
        "kind": kind,
        "commit": commit if commit is not None else git_commit(),
        "timestamp": float(timestamp if timestamp is not None
                           else time.time()),
        "meta": dict(meta),
        "rows": dict(rows),
    }


def append_history(path: str, kind: str, meta: Mapping[str, Any],
                   rows: Mapping[str, Any], *,
                   commit: Optional[str] = None) -> Dict[str, Any]:
    """Append one bench run to the JSONL history; returns the entry."""
    entry = history_entry(kind, meta, rows, commit=commit)
    with open(path, "a") as f:
        f.write(json.dumps(entry, sort_keys=True) + "\n")
    return entry


def load_history(path: str, kind: Optional[str] = None
                 ) -> List[Dict[str, Any]]:
    """All (optionally kind-filtered) history entries, oldest first.
    Unknown schemas load anyway — readers filter on ``schema``."""
    out: List[Dict[str, Any]] = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            entry = json.loads(line)
            if kind is None or entry.get("kind") == kind:
                out.append(entry)
    return out


# ---------------------------------------------------------------------------
# Ledger of known regressions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LedgerEntry:
    """One known, accepted regression: ``row`` is expected slower than
    ``reference`` on ``metric`` by up to ``max_ratio``; when a fix
    brings the ratio under ``fixed_below_ratio`` the gate flips to
    "failing better" — remove the entry and commit the win."""

    bench: str                    # "el" | "fleet"
    row: str
    metric: str
    reference: str
    max_ratio: float
    fixed_below_ratio: float = 1.5
    reason: str = ""

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def load_ledger(path: str) -> List[LedgerEntry]:
    """Parse ``BENCH_ledger.json`` (missing file = empty ledger)."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        doc = json.load(f)
    fields = {f.name for f in dataclasses.fields(LedgerEntry)}
    return [LedgerEntry(**{k: v for k, v in e.items() if k in fields})
            for e in doc.get("known", [])]


def ledgered(entries: Sequence[LedgerEntry], bench: str, row: str,
             metric: str) -> Optional[LedgerEntry]:
    for e in entries:
        if e.bench == bench and e.row == row and e.metric == metric:
            return e
    return None


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Finding:
    """One gate finding; ``kind`` is ``regression`` (fail),
    ``fixed`` (failing-better: stale ledger entry), ``known``
    (ledgered, within bounds) or ``ok``."""

    kind: str
    bench: str
    row: str
    metric: str
    detail: str

    def __str__(self) -> str:
        return (f"[{self.kind}] {self.bench}:{self.row}.{self.metric} "
                f"— {self.detail}")


def _rel_change(metric: str, base: float, fresh: float) -> float:
    """Signed relative regression: positive = worse, direction-aware."""
    if base == 0:
        return 0.0 if fresh == 0 else float("inf")
    change = (fresh - base) / abs(base)
    return -change if metric in HIGHER_IS_BETTER else change


def compare_to_baseline(baseline_rows: Mapping[str, Mapping[str, Any]],
                        fresh_rows: Mapping[str, Mapping[str, Any]],
                        *, bench: str,
                        ledger: Sequence[LedgerEntry] = (),
                        tolerances: Optional[Mapping[str, float]] = None
                        ) -> List[Finding]:
    """Row-by-row fresh-vs-baseline comparison (same-config runs).

    Every metric named in ``tolerances`` and present (as a number) in
    both copies of a row is compared; a direction-aware relative change
    past the tolerance is a ``regression`` finding unless that
    (row, metric) is ledgered — ledgered pairs are checked by
    :func:`check_ledger` against their reference instead."""
    tol = dict(DEFAULT_TOLERANCES if tolerances is None else tolerances)
    findings: List[Finding] = []
    for row_name in sorted(set(baseline_rows) & set(fresh_rows)):
        base_row, fresh_row = baseline_rows[row_name], fresh_rows[row_name]
        for metric, t in sorted(tol.items()):
            b, f = base_row.get(metric), fresh_row.get(metric)
            if not isinstance(b, (int, float)) \
                    or not isinstance(f, (int, float)):
                continue
            rel = _rel_change(metric, float(b), float(f))
            if rel <= t:
                continue
            if ledgered(ledger, bench, row_name, metric):
                findings.append(Finding(
                    "known", bench, row_name, metric,
                    f"{b:g} -> {f:g} ({rel:+.0%}), ledgered"))
            else:
                findings.append(Finding(
                    "regression", bench, row_name, metric,
                    f"{b:g} -> {f:g} ({rel:+.0%} > {t:.0%} tolerance)"))
    return findings


def check_ledger(rows: Mapping[str, Mapping[str, Any]],
                 ledger: Sequence[LedgerEntry], *, bench: str
                 ) -> List[Finding]:
    """Validate each ledgered row against its in-run reference row.

    Within-run ratios are host-speed independent, so this check works on
    the committed baselines AND on smoke-scale fresh runs.  Outcomes:
    ratio > ``max_ratio`` → the known regression got *worse*
    (``regression``); ratio < ``fixed_below_ratio`` → it is FIXED
    (``fixed`` — the gate fails "better" until the entry is removed);
    otherwise ``known``."""
    findings: List[Finding] = []
    for e in ledger:
        if e.bench != bench:
            continue
        row, ref = rows.get(e.row), rows.get(e.reference)
        if row is None or ref is None:
            findings.append(Finding(
                "regression", bench, e.row, e.metric,
                f"ledger references missing row(s): "
                f"{e.row if row is None else e.reference}"))
            continue
        rv, fv = row.get(e.metric), ref.get(e.metric)
        if not isinstance(rv, (int, float)) \
                or not isinstance(fv, (int, float)) or fv == 0:
            findings.append(Finding(
                "regression", bench, e.row, e.metric,
                "ledgered metric missing or zero in rows"))
            continue
        ratio = float(rv) / float(fv)
        if e.metric in HIGHER_IS_BETTER:
            ratio = 1.0 / ratio if ratio else float("inf")
        if ratio > e.max_ratio:
            findings.append(Finding(
                "regression", bench, e.row, e.metric,
                f"known regression got worse: {ratio:.2f}x "
                f"{e.reference} (ledger allows {e.max_ratio:.2f}x)"))
        elif ratio < e.fixed_below_ratio:
            findings.append(Finding(
                "fixed", bench, e.row, e.metric,
                f"now {ratio:.2f}x {e.reference} (< "
                f"{e.fixed_below_ratio:.2f}x) — remove the stale "
                f"ledger entry and keep the win"))
        else:
            findings.append(Finding(
                "known", bench, e.row, e.metric,
                f"{ratio:.2f}x {e.reference} (ledgered, allowed up to "
                f"{e.max_ratio:.2f}x): {e.reason or 'known'}"))
    return findings


def compare_ratios(baseline_rows: Mapping[str, Mapping[str, Any]],
                   fresh_rows: Mapping[str, Mapping[str, Any]], *,
                   bench: str, metric: str,
                   pairs: Sequence[tuple],
                   ledger: Sequence[LedgerEntry] = (),
                   slack: float = 1.0) -> List[Finding]:
    """Compare WITHIN-RUN ratios (row/reference) between a fresh run and
    the baseline — the smoke gate: sizes and host speed differ between a
    CI smoke and the committed baseline, but a sharded tier suddenly
    costing 3x its replicated reference when the baseline says 1.9x is a
    structural regression regardless of scale.  ``pairs`` is
    ``[(row, reference), ...]``; a fresh ratio worse than baseline_ratio
    * (1 + slack) on a non-ledgered row is a regression."""
    findings: List[Finding] = []
    for row_name, ref_name in pairs:
        vals = []
        for rows in (baseline_rows, fresh_rows):
            row, ref = rows.get(row_name), rows.get(ref_name)
            if row is None or ref is None:
                vals.append(None)
                continue
            rv, fv = row.get(metric), ref.get(metric)
            if not isinstance(rv, (int, float)) \
                    or not isinstance(fv, (int, float)) or not fv:
                vals.append(None)
            else:
                vals.append(float(rv) / float(fv))
        base_ratio, fresh_ratio = vals
        if base_ratio is None or fresh_ratio is None:
            continue
        if fresh_ratio > base_ratio * (1.0 + slack):
            kind = ("known"
                    if ledgered(ledger, bench, row_name, metric)
                    else "regression")
            findings.append(Finding(
                kind, bench, row_name, metric,
                f"ratio vs {ref_name}: {base_ratio:.2f}x -> "
                f"{fresh_ratio:.2f}x (slack {slack:.0%})"))
        else:
            findings.append(Finding(
                "ok", bench, row_name, metric,
                f"ratio vs {ref_name}: {base_ratio:.2f}x -> "
                f"{fresh_ratio:.2f}x"))
    return findings


def worst_exit_code(findings: Sequence[Finding]) -> int:
    """The gate's verdict: 1 on any ``regression``, else 3 on any
    ``fixed`` (failing better — update the ledger), else 0."""
    kinds = {f.kind for f in findings}
    if "regression" in kinds:
        return 1
    if "fixed" in kinds:
        return 3
    return 0
