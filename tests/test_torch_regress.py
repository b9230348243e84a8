"""The port's bench-regression bookkeeping (``repro_torch.obs.regress``)
vs the reference's (``repro.obs.regress``), on the CPU.

Tier: exact.  The six pure cases of the reference's
``tests/test_regress.py`` run through both packages on the same rows, and
every finding (kind, bench, row, metric, detail) and every history entry
must be the reference's.
"""

import dataclasses
import json

import pytest

from repro.obs import regress as jax_regress
from repro_torch.obs import regress

PKGS = (regress, jax_regress)


def _findings(fs):
    return [dataclasses.astuple(f) for f in fs]


def _both(fn):
    """``fn(pkg)`` for the port and the reference, compared."""
    got, want = fn(regress), fn(jax_regress)
    assert got == want
    return got


def test_history_append_load_roundtrip(tmp_path):
    assert regress.SCHEMA_VERSION == jax_regress.SCHEMA_VERSION
    entries = []
    for pkg in PKGS:
        path = str(tmp_path / f"{pkg.__name__}.jsonl")
        assert pkg.load_history(path) == []          # missing file: empty
        e1 = pkg.append_history(path, "el", {"edges": 8},
                                {"r": {"wall_us": 10.0}}, commit="abc123")
        pkg.append_history(path, "fleet", {"n": 64},
                           {"f": {"tenants_per_sec": 5.0}}, commit="abc123")
        assert e1["schema"] == pkg.SCHEMA_VERSION
        assert e1["commit"] == "abc123" and e1["timestamp"] > 0
        loaded = pkg.load_history(path)
        assert [e["kind"] for e in loaded] == ["el", "fleet"]
        assert pkg.load_history(path, kind="el")[0]["rows"]["r"] == \
            {"wall_us": 10.0}
        entries.append([{k: v for k, v in e.items() if k != "timestamp"}
                        for e in loaded])
    assert entries[0] == entries[1]
    # one package reads the other's file
    mine = regress.load_history(str(tmp_path / f"{jax_regress.__name__}"
                                    ".jsonl"))
    assert [e["rows"] for e in mine] == [e["rows"] for e in entries[1]]
    fixed = dict(commit="c", timestamp=1.0)
    assert regress.history_entry("el", {"a": 1}, {"r": {}}, **fixed) == \
        jax_regress.history_entry("el", {"a": 1}, {"r": {}}, **fixed)


def _ledger_entry(pkg, **kw):
    base = dict(bench="el", row="slow", metric="us_per_aggregation",
                reference="fast", max_ratio=6.0, fixed_below_ratio=1.5)
    base.update(kw)
    return pkg.LedgerEntry(**base)


def test_load_ledger_and_lookup(tmp_path):
    path = str(tmp_path / "ledger.json")
    with open(path, "w") as f:
        json.dump({"schema": 1, "known": [
            {"bench": "el", "row": "slow", "metric": "us_per_aggregation",
             "reference": "fast", "max_ratio": 6.0, "reason": "known-slow",
             "unknown_future_field": True}]}, f)
    for pkg in PKGS:
        assert pkg.load_ledger(str(tmp_path / "nope.json")) == []
    got, want = regress.load_ledger(path), jax_regress.load_ledger(path)
    assert [e.to_json() for e in got] == [e.to_json() for e in want]
    assert len(got) == 1 and got[0].max_ratio == 6.0
    assert regress.ledgered(got, "el", "slow",
                            "us_per_aggregation") is got[0]
    assert regress.ledgered(got, "fleet", "slow",
                            "us_per_aggregation") is None


def test_check_ledger_known_worse_fixed_missing():
    fast = {"fast": {"us_per_aggregation": 100.0}}
    for rows in ({**fast, "slow": {"us_per_aggregation": 400.0}},
                 {**fast, "slow": {"us_per_aggregation": 700.0}},
                 {**fast, "slow": {"us_per_aggregation": 120.0}},
                 fast,
                 {**fast, "slow": {}}):
        kinds = _both(lambda pkg: _findings(pkg.check_ledger(
            rows, [_ledger_entry(pkg)], bench="el")))
        assert len(kinds) == 1
    assert [k[0] for k in _both(lambda pkg: _findings(pkg.check_ledger(
        {**fast, "slow": {"us_per_aggregation": 120.0}},
        [_ledger_entry(pkg)], bench="el")))] == ["fixed"]
    # direction-aware: for higher-is-better metrics the ratio inverts
    f, = _both(lambda pkg: _findings(pkg.check_ledger(
        {"fast": {"tenants_per_sec": 100.0},
         "slow": {"tenants_per_sec": 25.0}},
        [_ledger_entry(pkg, metric="tenants_per_sec")], bench="el")))
    assert f[0] == "known" and "4.00x" in f[4]


@pytest.mark.parametrize("fresh,ledger,kinds", [
    ({"us_per_aggregation": 120.0}, False, []),             # within 25%
    ({"us_per_aggregation": 130.0}, False, ["regression"]),
    ({"tenants_per_sec": 130.0}, False, []),
    ({"tenants_per_sec": 70.0}, False, ["regression"]),     # higher-better
    ({"us_per_aggregation": 200.0}, True, ["known"])])      # ledgered
def test_compare_to_baseline_direction_aware_tolerances(fresh, ledger,
                                                        kinds):
    base = {"r": {"us_per_aggregation": 100.0, "tenants_per_sec": 100.0,
                  "note": "strings are skipped"}}
    got = _both(lambda pkg: _findings(pkg.compare_to_baseline(
        base, {"r": fresh}, bench="el",
        ledger=[_ledger_entry(pkg, row="r")] if ledger else ())))
    assert [f[0] for f in got] == kinds


@pytest.mark.parametrize("fresh_a,slack,ledger", [
    (300.0, 1.5, False), (600.0, 1.5, False), (600.0, 1.5, True),
    (300.0, 1.0, False)])
def test_compare_ratios_within_run_drift(fresh_a, slack, ledger):
    base = {"a": {"us_per_aggregation": 200.0},
            "ref": {"us_per_aggregation": 100.0}}
    fresh = {"a": {"us_per_aggregation": fresh_a},
             "ref": {"us_per_aggregation": 100.0}}
    _both(lambda pkg: _findings(pkg.compare_ratios(
        base, fresh, bench="el", metric="us_per_aggregation",
        pairs=[("a", "ref")], slack=slack,
        ledger=[_ledger_entry(pkg, row="a", reference="ref")]
        if ledger else ())))
    # rows missing on either side are skipped, not failed
    assert _both(lambda pkg: pkg.compare_ratios(
        base, {"ref": {"us_per_aggregation": 1.0}}, bench="el",
        metric="us_per_aggregation", pairs=[("a", "ref")])) == []


def test_worst_exit_code():
    for kinds in ([], ["ok", "known"], ["ok", "fixed"],
                  ["fixed", "regression"]):
        _both(lambda pkg: pkg.worst_exit_code(
            [pkg.Finding(k, "el", "r", "m", "") for k in kinds]))
    f = regress.Finding("known", "el", "r", "m", "detail")
    assert str(f) == str(jax_regress.Finding("known", "el", "r", "m",
                                             "detail"))
