"""The port's host observability layer (``repro_torch.obs``) against the
reference's ``repro.obs`` on the same inputs: the timing helpers, the
metrics registry (the same Prometheus text and JSON), the registry
builders over fleet stats and run reports, the span tracer, the
session's and the cache's trace records, the launchers'
``--metrics-out`` / ``--trace-dir``; and the load-bearing contract that
tracing changes no result: runs and a fleet drain with a JSONL tracer
configured equal the same runs without one, bit for bit."""

import dataclasses
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_fleet import assert_same_report  # noqa: E402
from test_torch_ingraph import jax_round_draws  # noqa: E402

from repro.el import ELSession as JaxSession  # noqa: E402
from repro.launch.classic import classic_fixture as jax_fixture  # noqa: E402
from repro.obs import metrics as jax_metrics  # noqa: E402
from repro.obs import timing as jax_timing  # noqa: E402
from repro.obs import trace as jax_trace  # noqa: E402
from repro_torch.el import ELSession, FleetServer, TenantRun  # noqa: E402
from repro_torch.el.rng import ReplayDraws  # noqa: E402
from repro_torch.el.sweep import SweepSpec  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.classic import classic_fixture  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import timing as obs_timing  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

EDGES, ROUNDS = 3, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def private_tracer():
    """A fresh process tracer for one test, the previous one restored."""
    prev = obs_trace.use_tracer(obs_trace.Tracer())
    yield obs_trace.get_tracer()
    obs_trace.use_tracer(prev).close()


@pytest.fixture(scope="module")
def svm():
    return (jax_fixture("svm-wafer", samples=300, n_edges=EDGES),
            classic_fixture("svm-wafer", samples=300, n_edges=EDGES,
                            device="cpu"))


def _cfg(fx, mode, budget=900.0, seed=0):
    return dataclasses.replace(fx["exp"].ol4el, mode=mode, n_edges=EDGES,
                               utility=fx["utility"], budget=budget,
                               seed=seed)


def _session(fx, cfg, init=None):
    return (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
            .with_executor(fx["executor"], init_params=init,
                           n_samples=fx["n_samples"]
                           if cfg.mode == "sync" else None))


# -- timing ------------------------------------------------------------------


def test_time_block_units():
    with obs_timing.time_block() as tb:
        x = sum(range(1000))
    assert x == 499500 and tb.ns > 0
    assert (tb.us, tb.ms, tb.s) == (tb.ns / 1e3, tb.ns / 1e6, tb.ns / 1e9)


def test_timeit_us_and_repeat_s_call_counts():
    for pkg in (obs_timing, jax_timing):
        calls = []
        assert pkg.timeit_us(lambda: calls.append(1), n=10, warmup=2) >= 0
        assert len(calls) == 12                    # warmup + timed
        reps = pkg.repeat_s(lambda: None, 3)
        assert len(reps) == 3 and all(r >= 0.0 for r in reps)


@pytest.mark.parametrize("samples", [[], [7.0], [4.0, 1.0, 3.0, 2.0],
                                     list(np.random.default_rng(0)
                                          .exponential(size=101))])
def test_summarize_ns_is_the_reference(samples):
    assert obs_timing.summarize_ns(samples) == \
        jax_timing.summarize_ns(samples)


# -- metrics registry + Prometheus exposition --------------------------------


def _registry(pkg):
    """One registry built by the same calls in either package: labels
    that need escaping, infinities, histograms with and without
    labels."""
    reg = pkg.MetricsRegistry()
    reg.counter("req_total", "requests").inc(3, {"code": "200"})
    reg.counter("req_total").inc(1, {"code": "500"})
    reg.counter("esc_total", "escaping").inc(
        2, {"path": 'a\\b"c\nd', "plain": "ok"})
    reg.gauge("depth", "queue depth").set(7)
    reg.gauge("ratio", "a float").set(0.1 + 0.2)
    reg.gauge("peak", "infinite").set(float("inf"), {"k": "up"})
    reg.gauge("peak").set(float("-inf"), {"k": "down"})
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe_many([0.05, 0.5, 5.0])
    h.observe(0.7, {"route": "/x"})
    reg.histogram("plain_seconds", "default buckets").observe(0.003)
    return reg


def test_registry_renders_the_reference_text_and_json():
    mine, ref = _registry(obs_metrics), _registry(jax_metrics)
    text = mine.render_prometheus()
    assert text == ref.render_prometheus()
    assert mine.to_json() == ref.to_json()
    assert json.dumps(mine.to_json(), sort_keys=True)
    assert mine.names() == ref.names()
    # either parser reads either text the same way
    parsed = obs_metrics.parse_prometheus(text)
    assert parsed == jax_metrics.parse_prometheus(text)
    by_code = {s["labels"]["code"]: s["value"] for s in parsed["req_total"]}
    assert by_code == {"200": 3.0, "500": 1.0}
    s, = parsed["esc_total"]
    assert s["labels"] == {"path": 'a\\b"c\nd', "plain": "ok"}
    assert "c\nd" not in text              # the newline itself never leaks
    buckets = {(s["labels"].get("route"), s["labels"]["le"]): s["value"]
               for s in parsed["lat_seconds_bucket"]}
    assert buckets[None, "0.1"] == 1.0 and buckets[None, "1"] == 2.0
    assert buckets[None, "+Inf"] == 3.0 and buckets["/x", "+Inf"] == 1.0
    assert {s["labels"]["k"]: s["value"] for s in parsed["peak"]} == \
        {"up": float("inf"), "down": float("-inf")}


def test_parser_and_registry_errors_are_the_reference():
    texts = ["this is not { prometheus\n", "x 1 2 3\n", "9bad 1\n"]
    for text in texts:
        with pytest.raises(ValueError) as mine:
            obs_metrics.parse_prometheus(text)
        with pytest.raises(ValueError) as ref:
            jax_metrics.parse_prometheus(text)
        assert str(mine.value) == str(ref.value)
    assert obs_metrics.parse_prometheus("") == {}
    assert obs_metrics.parse_prometheus(
        obs_metrics.MetricsRegistry().render_prometheus()) == {}
    cases = [(lambda r: (r.counter("x_total"), r.gauge("x_total")),
              TypeError),
             (lambda r: r.counter("bad name"), ValueError),
             (lambda r: r.counter("c_total").inc(-1), ValueError)]
    for build, exc in cases:
        msgs = []
        for pkg in (obs_metrics, jax_metrics):
            with pytest.raises(exc) as err:
                build(pkg.MetricsRegistry())
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def test_registry_from_fleet_and_spans_are_the_reference():
    stats = {"tenants_submitted": 8, "tenants_done": 8,
             "tenants_pending": 0, "tenants_active": 0, "cohorts": 2,
             "compiles": 2, "cache_hits": 1, "cache_misses": 2,
             "cache_evictions": 0, "waves": 7, "place_dispatches": 2,
             "gather_dispatches": 4}
    mine = obs_metrics.registry_from_fleet(stats)
    assert mine.render_prometheus() == \
        jax_metrics.registry_from_fleet(stats).render_prometheus()
    parsed = obs_metrics.parse_prometheus(mine.render_prometheus())
    assert parsed["fleet_tenants_done_total"][0]["value"] == 8
    assert parsed["fleet_cohorts"][0]["value"] == 2
    evs = [{"ev": "span", "name": "cohort.wave", "dur_us": 1500.0},
           {"ev": "span", "name": "cohort.wave", "dur_us": 500.0},
           {"ev": "event", "name": "cohort.refill"}]
    mine = obs_metrics.spans_into_registry(evs)
    assert mine.render_prometheus() == \
        jax_metrics.spans_into_registry(evs).render_prometheus()
    parsed = obs_metrics.parse_prometheus(mine.render_prometheus())
    assert parsed["obs_span_cohort_wave_seconds_count"][0]["value"] == 2
    assert parsed["obs_event_cohort_refill_total"][0]["value"] == 1


def _series(text):
    return {(name, tuple(sorted(s["labels"].items())))
            for name, ss in jax_metrics.parse_prometheus(text).items()
            for s in ss}


def test_registry_from_report_is_the_references(svm):
    """A port run and the reference's run on the same replayed draws fold
    into the same series; every value but the host seconds agrees."""
    jf, tf = svm
    cfg = _cfg(tf, "sync")
    draws = ReplayDraws(*jax_round_draws(
        cfg.seed + 17, ROUNDS, cfg.max_interval, EDGES, cfg.max_interval,
        tf["executor"].batch))
    init = params_from_numpy(jax.tree.map(np.asarray, jf["init_params"]),
                             "cpu")
    mine = _session(tf, cfg, init).run_sync_ingraph(max_rounds=ROUNDS,
                                                    draws=draws)
    ref = (JaxSession(_cfg(jf, "sync"), metric_name=jf["metric"],
                      lr=jf["lr"])
           .with_executor(jf["executor"], init_params=jf["init_params"],
                          n_samples=jf["n_samples"])
           .run_sync_ingraph(max_rounds=ROUNDS))
    assert "rings" not in mine.telemetry and "rings" not in ref.telemetry
    labels = {"arch": "svm"}
    a = obs_metrics.registry_from_report(mine, labels=labels)
    b = jax_metrics.registry_from_report(ref, labels=labels)
    assert a.names() == b.names()
    ta, tb = a.render_prometheus(), b.render_prometheus()
    assert _series(ta) == _series(tb)
    pa, pb = jax_metrics.parse_prometheus(ta), \
        jax_metrics.parse_prometheus(tb)
    for name in pa:
        if name not in ("el_elapsed_seconds", "el_final_metric"):
            assert pa[name] == pb[name], name
    assert pa["el_final_metric"][0]["value"] == pytest.approx(
        pb["el_final_metric"][0]["value"], abs=1.0 / 150)
    assert pa["el_rounds_total"][0]["value"] == mine.n_aggregations > 3
    # a profile snapshot folds the same way in both packages
    prof = {"flops": 1e9, "peak_live_bytes": 4096,
            "collectives": {"all-gather": {"count": 2, "bytes": 64}}}
    mine.telemetry = dict(mine.telemetry, profile=prof)
    ref.telemetry = dict(ref.telemetry, profile=prof)
    ref.elapsed_s = mine.elapsed_s
    ref.final_metric = mine.final_metric
    assert obs_metrics.registry_from_report(mine).render_prometheus() == \
        jax_metrics.registry_from_report(ref).render_prometheus()


# -- tracer ------------------------------------------------------------------


def test_tracer_span_event_and_jsonl_are_the_reference_records(tmp_path):
    recs = {}
    for name, pkg in (("port", obs_trace), ("ref", jax_trace)):
        path = str(tmp_path / f"{name}.jsonl")
        tr = pkg.Tracer(jsonl_path=path)
        with tr.span("unit.scope", tag="a", n=np.int64(2)) as sp:
            sp["inner"] = 42
            sp["arr"] = np.arange(3)
        tr.event("unit.tick", n=np.int32(3), t=torch.tensor(1.5))
        tr.close()
        evs = tr.events()
        assert pkg.read_jsonl(path) == evs
        assert json.dumps(evs)                      # JSON-safe end to end
        recs[name] = [{k: v for k, v in e.items()
                       if k not in ("ts", "dur_us")} for e in evs]
        assert evs[0]["dur_us"] >= 0.0 and evs[1]["ts"] >= evs[0]["ts"]
    assert recs["port"] == recs["ref"]
    assert recs["port"][0] == {"ev": "span", "name": "unit.scope",
                               "tag": "a", "n": 2, "inner": 42,
                               "arr": [0, 1, 2]}
    assert recs["port"][1] == {"ev": "event", "name": "unit.tick", "n": 3,
                               "t": 1.5}


def test_tracer_jsonl_flushes_span_on_exception(tmp_path):
    path = str(tmp_path / "boom.jsonl")
    tr = obs_trace.Tracer(jsonl_path=path)
    with pytest.raises(RuntimeError, match="boom"):
        with tr.span("unit.crash", tag="x"):
            raise RuntimeError("boom")
    disk = obs_trace.read_jsonl(path)              # flushed before close()
    assert [e["name"] for e in disk] == ["unit.crash"]
    assert disk[0]["ev"] == "span" and disk[0]["tag"] == "x"
    tr.close()
    tr.close()                                     # idempotent


def test_tracer_reentrant_spans_nest_and_order(tmp_path):
    path = str(tmp_path / "nest.jsonl")
    tr = obs_trace.Tracer(jsonl_path=path, buffer=2)
    with tr.span("outer"):
        with tr.span("inner", depth=2):
            pass
        with tr.span("inner", depth=2):
            pass
    tr.close()
    disk = obs_trace.read_jsonl(path)
    # inner scopes finish (and emit) before the enclosing outer span
    assert [e["name"] for e in disk] == ["inner", "inner", "outer"]
    assert all(e["dur_us"] <= disk[-1]["dur_us"] for e in disk[:-1])
    assert tr.events() == disk[1:]                 # the bounded buffer
    assert tr.events("outer") == disk[2:]


def test_configure_swaps_the_process_tracer(tmp_path):
    prev = obs_trace.get_tracer()
    try:
        tr = obs_trace.configure(jsonl_path=str(tmp_path / "t.jsonl"))
        assert obs_trace.get_tracer() is tr and tr is not prev
        obs_trace.event("cfg.check", k=1)
        with obs_trace.span("cfg.span"):
            pass
        assert [e["name"] for e in tr.events()] == ["cfg.check",
                                                    "cfg.span"]
        assert not prev.events("cfg.check")
    finally:
        obs_trace.use_tracer(prev).close()
    assert obs_trace.read_jsonl(str(tmp_path / "t.jsonl"))[0]["k"] == 1


def test_span_is_a_profiler_range(private_tracer):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs_trace.span("unit.profiled"):
            torch.ones(4).sum()
    assert "unit.profiled" in {e.key for e in prof.key_averages()}


# -- the session's and the cache's records; tracing changes nothing ---------


def test_session_spans_and_cache_events(svm, private_tracer):
    _, tf = svm
    sess = _session(tf, _cfg(tf, "sync"))
    rep = sess.run_sync_ingraph(max_rounds=ROUNDS)
    sess.run_sync_ingraph(max_rounds=ROUNDS)
    sess.cfg = _cfg(tf, "async")
    arep = sess.run_async_ingraph()
    sess.cfg = _cfg(tf, "sync")
    sess.sweep(SweepSpec(ucb_c=(1.0, 2.0), seeds=(0,), max_rounds=ROUNDS))
    evs = [{k: v for k, v in e.items() if k not in ("ts", "dur_us")}
           for e in private_tracer.events()]
    assert evs == [
        {"ev": "event", "name": "cache.miss", "misses": 1},
        {"ev": "span", "name": "session.compile", "mode": "sync",
         "telemetry": False},
        {"ev": "span", "name": "session.dispatch", "mode": "sync",
         "n_rounds": rep.n_aggregations},
        {"ev": "event", "name": "cache.hit", "hits": 1},
        {"ev": "span", "name": "session.dispatch", "mode": "sync",
         "n_rounds": rep.n_aggregations},
        {"ev": "event", "name": "cache.miss", "misses": 2},
        {"ev": "span", "name": "session.compile", "mode": "async",
         "telemetry": False},
        {"ev": "span", "name": "session.dispatch", "mode": "async",
         "n_events": arep.n_aggregations},
        {"ev": "event", "name": "cache.miss", "misses": 3},
        {"ev": "span", "name": "session.compile", "mode": "sweep",
         "n_cells": 2},
        {"ev": "span", "name": "session.dispatch", "mode": "sweep",
         "n_cells": 2}]
    sess.compile_cache.max_entries = 1
    sess.run_sync_ingraph(max_rounds=ROUNDS // 2)      # a fourth program
    assert [e["evictions"] for e in private_tracer.events("cache.evict")] \
        == [1, 2, 3]


def test_tracing_changes_no_result(svm, tmp_path):
    """A sync run, an async run and a fleet drain with a JSONL tracer
    configured equal the same runs without one, bit for bit."""
    _, tf = svm

    def runs():
        out = [_session(tf, _cfg(tf, "sync")).run_sync_ingraph(
                   max_rounds=ROUNDS),
               _session(tf, _cfg(tf, "async")).run_async_ingraph()]
        server = FleetServer(n_slots=2, rounds_per_wave=4, device="cpu")
        for seed, mode in enumerate(("sync", "async", "sync")):
            server.submit(TenantRun(
                cfg=_cfg(tf, mode, budget=700.0 + 100 * seed, seed=seed),
                executor=tf["executor"], tenant_id=f"t{seed}",
                metric_name=tf["metric"], n_samples=tf["n_samples"],
                max_rounds=ROUNDS))
        reports = server.drain()
        return out + [reports[f"t{i}"] for i in range(3)]

    plain = runs()
    path = str(tmp_path / "spans.jsonl")
    prev = obs_trace.get_tracer()
    try:
        obs_trace.configure(jsonl_path=path)
        traced = runs()
    finally:
        obs_trace.use_tracer(prev).close()
    names = {e["name"] for e in obs_trace.read_jsonl(path)}
    assert {"session.dispatch", "cohort.wave", "cohort.refill",
            "fleet.compile", "cache.miss"} <= names
    for a, b in zip(plain, traced):
        assert_same_report(b, a)


# -- the launchers' --metrics-out / --trace-dir -------------------------------


def _read_metrics(path):
    text = open(path).read()
    return (jax_metrics.parse_prometheus(text),
            json.load(open(path + ".json")),
            obs_trace.read_jsonl(path + ".spans.jsonl"))


def test_sweep_launcher_writes_metrics(tmp_path, capsys):
    from repro_torch.launch import sweep as launch_sweep
    path = str(tmp_path / "sweep.prom")
    prev = obs_trace.get_tracer()
    try:
        launch_sweep.main(["--arch", "svm-wafer", "--ucb-c", "1", "2",
                           "--seeds", "0", "--samples", "300",
                           "--max-rounds", "32", "--edges", "3",
                           "--device", "cpu", "--metrics-out", path])
    finally:
        obs_trace.use_tracer(prev).close()
    parsed, as_json, spans = _read_metrics(path)
    assert parsed["sweep_cells"][0]["value"] == 2
    assert parsed["sweep_final_metric_count"][0]["value"] == 2
    assert parsed["obs_span_session_dispatch_seconds_count"][0]["value"] == 1
    assert as_json["sweep_cells"]["series"][0]["value"] == 2
    assert {"session.compile", "session.dispatch"} <= \
        {e["name"] for e in spans}
    assert "metrics written" in capsys.readouterr().out
    # --telemetry records the cells' rings (the launcher prints the grid)
    launch_sweep.main(["--arch", "svm-wafer", "--seeds", "0",
                       "--samples", "200", "--device", "cpu",
                       "--max-rounds", "16", "--telemetry"])
    assert "pareto" in capsys.readouterr().out.lower()


@pytest.mark.parametrize("el_mode", ["sync", "async"])
def test_train_launcher_writes_metrics_and_a_trace(tmp_path, el_mode):
    from repro_torch.launch import train as launch_train
    path = str(tmp_path / "train.prom")
    prev = obs_trace.get_tracer()
    try:
        rep = launch_train.main(
            ["--arch", "svm-wafer", "--mode", "ol4el", "--el-mode", el_mode,
             "--device", "cpu", "--samples", "300", "--edges", "2",
             "--budget", "900", "--metrics-out", path,
             "--trace-dir", str(tmp_path / "trace")])
    finally:
        obs_trace.use_tracer(prev).close()
    parsed, _, spans = _read_metrics(path)
    assert parsed["el_rounds_total"][0]["value"] == rep.n_aggregations > 0
    assert parsed["el_rounds_total"][0]["labels"] == {
        "arch": "svm-wafer", "mode": el_mode, "policy": "ol4el"}
    assert parsed["el_program_cache_misses_total"][0]["value"] == 1
    assert sum(s["value"] for s in parsed["el_arm_pulls_total"]) == \
        sum(rep.arm_pulls)
    assert "session.dispatch" in {e["name"] for e in spans}
    chrome = json.load(open(tmp_path / "trace" / "trace.json"))
    assert "session.dispatch" in {e.get("name")
                                  for e in chrome["traceEvents"]}
    # --telemetry 8 records the run's rings, the same run otherwise
    ringed = launch_train.main(["--arch", "svm-wafer", "--mode", "ol4el",
                                "--el-mode", el_mode, "--device", "cpu",
                                "--samples", "300", "--edges", "2",
                                "--budget", "900", "--telemetry", "8"])
    assert int(ringed.telemetry["rings"]["ring_size"]) == 8
    assert int(ringed.telemetry["rings"]["head"]) == ringed.n_aggregations
    assert ringed.records == rep.records
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "qwen3-1.7b", "--smoke",
                           "--device", "cpu", "--telemetry"])
