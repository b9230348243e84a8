"""The port's bench gate (``repro_torch.bench.bench_check``) vs the
reference's (``scripts/bench_check.py``), and the port's ``--metrics-out``
summary (``repro_torch.obs.summary``) vs ``scripts/obs_summary.py``, on the
CPU.

The gates' findings must be the reference's on the same rows: the
reference's committed ``BENCH_el.json`` and every mutated case of
``tests/test_regress.py``'s contract tests.  The modes run end to end on
the port's own files: the committed ``BENCH_torch_*.json`` (the card
baselines), a ``--fresh`` run with an injected regression, a fixed ledger
entry, and ``--smoke`` on the CPU against a CPU baseline.
"""

import copy
import importlib.util
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.bench import bench_check, bench_el  # noqa: E402
from repro_torch.obs import regress  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module, restored after: its runs are
    many small ops, and beside the other test workers torch's OpenMP pool
    spin-waits between them (the same loaded test ran 4x faster so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


@pytest.fixture(scope="module")
def ref_check():
    spec = importlib.util.spec_from_file_location(
        "ref_bench_check", os.path.join(ROOT, "scripts", "bench_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load(name):
    with open(os.path.join(ROOT, name)) as f:
        return json.load(f)


def _good_rows():
    """``tests/test_regress.py:163``'s clean rows."""
    return {
        "host_loop": {"us_per_aggregation": 900.0},
        "el_sync_ingraph": {"alias_bytes": 0, "collectives": {}},
        "el_sync_sharded": {
            "alias_bytes": 0,
            "collectives": {"all-gather": {"count": 2, "bytes": 15360}}},
        "el_sync_sharded_donate": {
            "alias_bytes": 1920,
            "collectives": {"all-gather": {"count": 2, "bytes": 15360}}},
        "el_async_sharded_donate": {
            "alias_bytes": 1920,
            "collectives": {"all-gather": {"count": 2, "bytes": 15360}}},
    }


def _mutated(case):
    """Each mutation of ``tests/test_regress.py:184-226``."""
    rows = _good_rows()
    if case == "sharded_all_reduce":
        rows["el_sync_sharded"]["collectives"]["all-reduce"] = \
            {"count": 1, "bytes": 40}
    elif case == "replicated_gather":
        rows["el_sync_ingraph"]["collectives"] = \
            {"all-gather": {"count": 1, "bytes": 8}}
    elif case == "donation_fell_off":
        rows["el_sync_sharded_donate"]["alias_bytes"] = 0
    elif case == "donated_sizes_differ":
        rows["el_async_sharded_donate"]["alias_bytes"] = 64
    elif case == "non_donated_aliases":
        rows["el_sync_sharded"]["alias_bytes"] = 1920
    elif case == "committed_reference_rows":
        rows = _load("BENCH_el.json")["rows"]
    elif case == "committed_port_rows":
        rows = _load("BENCH_torch_el.json")["rows"]
    elif case == "telemetry_over_bound":
        rows = copy.deepcopy(_load("BENCH_el.json")["rows"])
        rows["el_sync_ingraph_telemetry"]["overhead_vs_ingraph_pct"] = 10.5
        rows["el_async_ingraph_telemetry"]["overhead_vs_ingraph_pct"] = 10.0
    return rows


def _triples(findings):
    return [(f.kind, f.bench, f.row, f.metric, f.detail) for f in findings]


CASES = ["clean", "sharded_all_reduce", "replicated_gather",
         "donation_fell_off", "donated_sizes_differ", "non_donated_aliases",
         "committed_reference_rows", "committed_port_rows",
         "telemetry_over_bound"]


@pytest.mark.parametrize("case", CASES)
def test_findings_are_the_references(case, ref_check):
    rows = _mutated(case)
    for fn in ("contract_findings", "telemetry_findings"):
        got = getattr(bench_check, fn)(rows, bench="el")
        want = getattr(ref_check, fn)(rows, bench="el")
        assert _triples(got) == _triples(want), (case, fn)
    if case not in ("clean", "committed_reference_rows",
                    "committed_port_rows", "telemetry_over_bound"):
        assert any(f.kind == "regression"
                   for f in bench_check.contract_findings(rows))


def test_gate_constants_are_the_references(ref_check):
    assert bench_check.SMOKE_PAIRS == ref_check.SMOKE_PAIRS
    assert bench_check.TELEMETRY_OVERHEAD_PCT == \
        ref_check.TELEMETRY_OVERHEAD_PCT == 10.0


def test_defaults_are_the_ports_files():
    args = bench_check.parser().parse_args([])
    for path, name in ((args.el, "BENCH_torch_el.json"),
                       (args.fleet, "BENCH_torch_fleet.json"),
                       (args.ledger, "BENCH_torch_ledger.json"),
                       (args.history, "BENCH_torch_history.jsonl")):
        assert os.path.abspath(path) == os.path.join(ROOT, name)
    assert args.device is None and args.devices == 4


def test_committed_baselines_hold_contracts_and_ledger():
    """The card baselines: every one of the reference's rows, a sharded
    tier's gathers and no other collective, a donated tier's aliased
    params, an empty ledger, the card named beside them and the sharded
    tiers' mesh, ranks and card in the meta."""
    args = bench_check.parser().parse_args([])
    found = bench_check.findings(args)
    gates = {gate for gate, _ in found}
    assert {"contract", "telemetry"} <= gates
    for gate, f in found:
        if gate in ("contract", "ledger"):
            assert f.kind == "ok", f
    assert regress.load_ledger(args.ledger) == []
    el, fleet = _load("BENCH_torch_el.json"), _load("BENCH_torch_fleet.json")
    for meta in (el["meta"], fleet["meta"]):
        assert meta["backend"] == "cuda"
        assert meta["device_name"] and meta["power_limit"].endswith("W")
    assert sorted(el["rows"]) == sorted(_load("BENCH_el.json")["rows"])
    assert "not_ported" not in el["meta"]
    assert el["meta"]["mesh"] == {"data": 2, "model": 2}
    assert el["meta"]["ranks"] == {
        "count": 4, "backend": "gloo", "device": "cuda", "cards": 1,
        "rows": sorted(n for n in el["rows"] if "sharded" in n)}
    hist = regress.load_history(args.history)
    assert sorted(h["kind"] for h in hist) == ["el", "fleet"]


def _gate(*argv):
    # one intra-op thread: on a CPU that other test processes load,
    # torch's OpenMP pool spin-waits between the device loops' small ops
    # and skews one tier's time against another's
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.bench_check", *argv],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"))


def test_fresh_with_injected_regression_exits_1(tmp_path):
    doc = copy.deepcopy(_load("BENCH_torch_el.json"))
    row = doc["rows"]["el_sync_ingraph"]
    row["us_per_aggregation"] *= 2
    row["wall_us"] *= 2
    fresh = tmp_path / "fresh.json"
    fresh.write_text(json.dumps(doc))
    r = _gate("--fresh", str(fresh), "--bench", "el")
    assert r.returncode == 1, r.stdout + r.stderr
    assert "[regression] el:el_sync_ingraph.us_per_aggregation" in r.stdout
    # the unchanged copy passes the row-by-row comparison
    same = tmp_path / "same.json"
    same.write_text(json.dumps(_load("BENCH_torch_el.json")))
    r = _gate("--fresh", str(same), "--bench", "el")
    assert ".us_per_aggregation" not in r.stdout, r.stdout


def test_fixed_ledger_entry_exits_3(tmp_path):
    """A ledger entry whose row now sits under ``fixed_below_ratio`` makes
    the default mode fail better.  Only the ledger decides here: the copy
    of the committed rows drops the recorded overheads, whose gate
    ``test_committed_baselines_hold_contracts_and_ledger`` and the
    findings tests cover."""
    doc = copy.deepcopy(_load("BENCH_torch_el.json"))
    for row in doc["rows"].values():
        row.pop("overhead_vs_ingraph_pct", None)
    el = tmp_path / "el.json"
    el.write_text(json.dumps(doc))
    ledger = tmp_path / "ledger.json"
    ledger.write_text(json.dumps({"schema": 1, "known": [{
        "bench": "el", "row": "el_async_ingraph_batched",
        "metric": "us_per_aggregation", "reference": "el_async_ingraph",
        "max_ratio": 100.0, "fixed_below_ratio": 50.0,
        "reason": "a regression this test pretends was fixed"}]}))
    r = _gate("--el", str(el), "--ledger", str(ledger))
    assert r.returncode == 3, r.stdout + r.stderr
    assert "[fixed] el:el_async_ingraph_batched" in r.stdout
    assert "bench_check: FAILING-BETTER" in r.stdout


def test_smoke_passes_devices_on_to_bench_el(monkeypatch, capsys):
    """``--smoke --devices N`` hands ``--devices N`` to its ``bench_el``
    run (the reference's ``scripts/bench_check.py:231``; default 4, as
    there); a failed run exits 2."""
    import re
    import types
    with open(os.path.join(ROOT, "scripts", "bench_check.py")) as f:
        ref = re.search(r'"--devices", type=int, default=(\d+)', f.read())
    assert int(ref.group(1)) == bench_check.parser().parse_args(
        []).devices == 4
    commands = []

    def failed_run(cmd, env):
        commands.append(cmd)
        return subprocess.CompletedProcess(cmd, 1)
    monkeypatch.setattr(bench_check, "subprocess",
                        types.SimpleNamespace(run=failed_run))
    assert bench_check.main(["--smoke", "--devices", "2", "--device",
                             "cpu"]) == 2
    (cmd,) = commands
    assert cmd[1:3] == ["-m", "repro_torch.bench.bench_el"]
    assert cmd[cmd.index("--devices") + 1] == "2"
    assert "smoke bench failed" in capsys.readouterr().err


def test_missing_artifact_exits_2(tmp_path):
    r = _gate("--el", str(tmp_path / "nothere.json"))
    assert r.returncode == 2
    assert "missing" in r.stderr


def test_smoke_on_the_cpu_against_a_cpu_baseline_exits_0(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """A baseline at the smoke's sizes on the CPU, then ``--smoke
    --device cpu`` against it: contracts, ratios and ledger pass, and the
    smoke run joins the history.

    The host clock is a counter here (each reading 1 ms after the last),
    so every timed call takes 1 ms and the within-run ratios the gate
    compares depend on the runs' aggregation counts, not on how loaded
    the CPU is: on a CPU that other test workers load, two min-of-2
    timings of one tier differ by 2x and a ratio swung from 0.54x to
    3.95x, past the 150 % slack.  For the same reason the smoke's
    ``bench_el`` runs in this process, on the command line the gate
    builds (on the card, ``bench_el`` at the gate's sizes runs in the
    ``cuda`` tests' ``test_bench_el_smoke_on_the_card``).  Its sharded
    tiers' ranks are real processes: each starts
    with the same counter clock (``rank_clock``), so their ratios are as
    fixed as the in-process tiers'."""
    import itertools
    import types
    from repro_torch.obs import timing
    clock = itertools.count(0, 1_000_000)
    monkeypatch.setattr(timing.time, "perf_counter_ns", lambda: next(clock))
    real_spawn = bench_el.spawn_ranks
    rank_clock = ("import itertools, runpy, sys, time\n"
                  "c = itertools.count(0, 1_000_000)\n"
                  "time.perf_counter_ns = lambda: next(c)\n"
                  "sys.argv = ['bench_el'] + sys.argv[1:]\n"
                  "runpy.run_module('repro_torch.bench.bench_el', "
                  "run_name='__main__')\n")

    def spawn_with_counter_clocks(n, cmd, **kw):
        assert cmd[1:3] == ["-m", "repro_torch.bench.bench_el"]
        return real_spawn(n, [cmd[0], "-c", rank_clock, *cmd[3:]], **kw)
    monkeypatch.setattr(bench_el, "spawn_ranks", spawn_with_counter_clocks)
    commands = []

    def run_in_process(cmd, env):
        commands.append(cmd)
        assert cmd[1:3] == ["-m", "repro_torch.bench.bench_el"]
        assert env["PYTHONPATH"].split(os.pathsep)[0] == \
            os.path.join(bench_check.ROOT, "src")
        bench_el.main(cmd[3:])
        return subprocess.CompletedProcess(cmd, 0)
    monkeypatch.setattr(bench_check, "subprocess",
                        types.SimpleNamespace(run=run_in_process))
    base = tmp_path / "base.json"
    bench_el.main(["--device", "cpu", "--edges", "4", "--samples", "512",
                   "--batch", "64", "--budget", "300", "--max-rounds", "16",
                   "--max-events", "64", "--repeats", "2", "--skip-host",
                   "--no-history", "--out", str(base)])
    hist = tmp_path / "hist.jsonl"
    code = bench_check.main(["--smoke", "--device", "cpu", "--el", str(base),
                             "--ledger", str(tmp_path / "no_ledger.json"),
                             "--history", str(hist)])
    out = capsys.readouterr().out
    assert code == 0, out
    # the contracts, then each of the eight SMOKE_PAIRS, the four sharded
    # pairs among them
    assert "bench_check: OK (9 checks, 0 regressions" in out
    assert len(commands) == 1 and "--skip-host" in commands[0]
    assert commands[0][commands[0].index("--device") + 1] == "cpu"
    assert commands[0][commands[0].index("--devices") + 1] == "4"
    assert [e["kind"] for e in regress.load_history(str(hist))] == \
        ["el-smoke"]


# -- obs.summary --------------------------------------------------------------


@pytest.fixture(scope="module")
def fleet_artifacts(tmp_path_factory):
    out = tmp_path_factory.mktemp("obs") / "fleet.prom"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fleet", "--demo",
         "--device", "cpu", "--metrics-out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert r.returncode == 0, r.stdout + r.stderr
    return str(out)


def _summaries(path, *flags):
    env = dict(os.environ, PYTHONPATH=SRC)
    port = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.summary", path, *flags],
        capture_output=True, text=True, timeout=120, env=env)
    ref = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "obs_summary.py"),
         path, *flags],
        capture_output=True, text=True, timeout=120, env=env)
    return port, ref


@pytest.mark.parametrize("flags", [
    (),
    ("--check", "fleet_waves_total,fleet_compiles_total",
     "--require-spans", "fleet.compile,cohort.wave,cohort.refill"),
    ("--check", "fleet_waves_total,no_such_metric"),
    ("--require-spans", "cohort.wave,no.such.span"),
], ids=["plain", "checks_pass", "check_fails", "spans_fail"])
def test_summary_is_the_references(fleet_artifacts, flags):
    port, ref = _summaries(fleet_artifacts, *flags)
    assert port.returncode == ref.returncode, (port.stderr, ref.stderr)
    # the headings name each package's own modules
    assert port.stdout.replace("repro_torch.", "repro.") == ref.stdout
    assert port.stderr == ref.stderr
    assert "span cohort.wave" in port.stdout
    assert port.returncode == (1 if "no" in " ".join(flags) else 0)


def test_summarize_spans_is_the_references():
    from repro_torch.obs.summary import summarize_spans
    spec = importlib.util.spec_from_file_location(
        "ref_obs_summary", os.path.join(ROOT, "scripts", "obs_summary.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    events = [{"ev": "span", "name": "a", "dur_us": 3.5},
              {"ev": "span", "name": "a", "dur_us": 1.25},
              {"ev": "span", "name": "b", "dur_us": 0.0},
              {"ev": "event", "name": "c"}, {"name": "c"}, {}]
    assert summarize_spans(events) == ref.summarize_spans(events)
