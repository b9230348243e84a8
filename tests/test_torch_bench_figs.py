"""The port's figure harness (``repro_torch.bench``) vs the reference's
(``benchmarks/``), on the CPU: Fig. 3/4/5, the session build they share
and ``run.py``'s figure half.

Both packages run the same rows on the same numpy data.  The port is
handed the reference's init (``model.init(jax.random.key(seed))``, as
numpy) and, on the compiled rows, each run's or cell's ``jax.random``
draws replayed through the RNG seam (``jax_round_draws`` /
``jax_event_draws``, the solo parity tests' helpers).  Every run of a
figure is captured on both sides (each session's ``run`` / ``sweep``
report): the host runs must make the reference's decisions —
``(interval, edge)`` records, arm pulls, aggregations, termination —
with ``total_consumed`` within rtol 1e-9 and metrics within what one
flipped evaluation point can move (``tests/test_torch_session.py``'s
bound); the compiled rows the reference's decisions on the replayed
draws, ``consumed`` bit-equal at fixed cost.  The figures' rows agree
within the same bound.
"""

import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
if ROOT not in sys.path:               # the reference's benchmarks package
    sys.path.insert(0, ROOT)

from test_torch_events import jax_event_draws  # noqa: E402
from test_torch_ingraph import jax_round_draws  # noqa: E402
from test_torch_session import _flip_bound  # noqa: E402

from benchmarks import common as ref_common  # noqa: E402
from benchmarks import fig3_heterogeneity as ref_fig3  # noqa: E402
from benchmarks import fig4_tradeoff as ref_fig4  # noqa: E402
from benchmarks import run as ref_run  # noqa: E402
from repro.config import get_config as jax_get_config  # noqa: E402
from repro.el import ELSession as JaxSession  # noqa: E402
from repro.el.scenarios import ChurnSpec as JaxChurn  # noqa: E402
from repro.el.scenarios import ScenarioSpec as JaxScenario  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.bench import common  # noqa: E402
from repro_torch.bench import fig3_heterogeneity, fig4_tradeoff  # noqa: E402
from repro_torch.bench import run as port_run  # noqa: E402
from repro_torch.el import ELSession  # noqa: E402
from repro_torch.el.rng import ReplayDraws  # noqa: E402
from repro_torch.el.scenarios import ChurnSpec, ScenarioSpec  # noqa: E402
from repro_torch.interop import params_to_numpy  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The device loops are hundreds of small ops a step; on a loaded CPU
    torch's OpenMP pool spin-waits between them.  One intra-op thread for
    this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- what the port is handed: the reference's init and draws ------------------


def ref_init(workload, seed):
    """The reference's init for ``seed`` (``benchmarks/common.py:76``), as
    numpy."""
    model = jax_build_model(jax_get_config(common.ARCHS[workload]).model)
    return jax.tree.map(np.asarray, model.init(jax.random.key(seed)))


def ref_draws(cfg, batch, horizon):
    """The reference's ``jax.random.key(seed + 17)`` draws of one compiled
    run or sweep cell, every round or event of its horizon."""
    k = cfg.max_interval
    if cfg.mode == "sync":
        return ReplayDraws(*jax_round_draws(cfg.seed + 17, horizon, k,
                                            cfg.n_edges, k, batch))
    return jax_event_draws(cfg.seed + 17, horizon, cfg.n_edges, k, k, batch)


# -- what is compared: every report, on both sides ----------------------------


def capture(monkeypatch, session_cls, names=("run", "run_sync_ingraph",
                                             "run_async_ingraph", "sweep")):
    """Record ``(kind, metric_name, eval labels, report)`` for every call of
    the session class's run methods, in call order."""
    seen = []
    for name in names:
        orig = getattr(session_cls, name)

        def wrap(self, *a, _orig=orig, _name=name, **kw):
            y = np.asarray(self._executor.eval_set["y"])
            rep = _orig(self, *a, **kw)
            seen.append((_name, self.metric_name, y, rep))
            return rep
        monkeypatch.setattr(session_cls, name, wrap)
    return seen


def flip_bound(metric_name, y):
    """``tests/test_torch_session.py``'s bound, by the run's metric."""
    return _flip_bound("svm-wafer" if metric_name == "accuracy"
                       else "kmeans-traffic", y)


def decisions(rep):
    return [(r.interval, r.edge) for r in rep.records]


def assert_same_runs(port, ref):
    """Run by run: the reference's decisions; metrics within the flip
    bound; the compiled rows' decisions on replayed draws.  Returns the
    largest bound seen."""
    assert len(port) == len(ref) > 0
    worst = 0.0
    for (kind, metric, y, p), (rkind, rmetric, ry, r) in zip(port, ref):
        assert (kind, metric) == (rkind, rmetric)
        np.testing.assert_array_equal(y, ry)
        bound = flip_bound(metric, y)
        worst = max(worst, bound)
        if kind == "sweep":
            out, want = p.out, r.out
            assert p.cells == r.cells
            for k in ("n_rounds", "interval", "arm_pulls", "consumed",
                      "wall"):
                np.testing.assert_array_equal(out[k], np.asarray(want[k]),
                                              err_msg=k)
            assert (out["n_rounds"] > 0).all()
            np.testing.assert_allclose(out["metric"], want["metric"],
                                       atol=1e-5)
            np.testing.assert_allclose(p.final_metrics(), r.final_metrics(),
                                       atol=bound)
            continue
        assert len(p.records) > 0
        assert decisions(p) == decisions(r)
        assert p.arm_pulls == r.arm_pulls
        assert p.n_aggregations == r.n_aggregations
        assert p.terminated_reason == r.terminated_reason
        np.testing.assert_allclose(p.total_consumed, r.total_consumed,
                                   rtol=1e-9)
        for a, b in zip(p.records, r.records):
            np.testing.assert_allclose(a.total_consumed, b.total_consumed,
                                       rtol=1e-9)
            assert (np.isnan(a.metric) and np.isnan(b.metric)) or \
                abs(a.metric - b.metric) <= bound
        assert abs(p.final_metric - r.final_metric) <= bound
    return worst


def assert_same_rows(port_rows, ref_rows, bound):
    assert len(port_rows) == len(ref_rows) > 0
    for p, r in zip(port_rows, ref_rows):
        assert p.keys() == r.keys()
        for k, v in r.items():
            if k in ("metric", "metric_std"):
                assert abs(p[k] - v) <= bound + 1e-12, (k, p, r)
            else:
                assert p[k] == v, (k, p, r)


# -- the session build --------------------------------------------------------


SESSION_CASES = [
    ("svm", "ol4el", "sync", 6.0, {}),
    ("kmeans", "ac_sync", "async", 3.0,
     dict(n_edges=10, lr=0.5, batch=32, alpha=1.0, seed=2,
          cost_model="variable", cost_noise=0.2, max_interval=6,
          async_alpha=0.3, budget=900.0)),
    ("svm", "task_alloc", "sync", 15.0, dict(scenario="churn", seed=1)),
]


@pytest.mark.parametrize("workload,policy,mode,h,kw", SESSION_CASES)
def test_make_el_session_builds_the_references_session(workload, policy,
                                                       mode, h, kw):
    kw = dict(kw, n_data=1500)
    scn = kw.pop("scenario", None)
    ref = ref_common.make_el_session(
        workload, policy, mode, h,
        scenario=scn and JaxScenario(churn=JaxChurn(rate=0.2, period=8)),
        **kw)
    init = ref_init(workload, kw.get("seed", 0))
    port = common.make_el_session(
        workload, policy, mode, h, init_params=init, device=CPU,
        scenario=scn and ScenarioSpec(churn=ChurnSpec(rate=0.2, period=8)),
        **kw)
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(ref.cfg)
    assert (port.metric_name, port.lr, port.async_alpha) == \
        (ref.metric_name, ref.lr, ref.async_alpha)
    np.testing.assert_array_equal(port._n_samples, ref._n_samples)
    pe, re = port._executor, ref._executor
    assert (pe.batch, pe.lr) == (re.batch, re.lr)
    assert len(pe.edge_data) == len(re.edge_data) == port.cfg.n_edges
    for a, b in zip(pe.edge_data, re.edge_data):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    for k in re.eval_set:
        np.testing.assert_array_equal(pe.eval_set[k].numpy(),
                                      np.asarray(re.eval_set[k]))
    for k, v in params_to_numpy(port._init_params).items():
        np.testing.assert_array_equal(v, init[k])


def test_default_init_is_the_generators_and_device_free():
    for workload in common.WORKLOADS:
        sess = common.make_el_session(workload, "ol4el", "sync", 1.0,
                                      n_data=600, seed=3, device=CPU)
        want = common.default_init(workload, 3)
        for k, v in params_to_numpy(sess._init_params).items():
            np.testing.assert_array_equal(v, want[k])
    assert not np.array_equal(common.default_init("kmeans", 3)["centers"],
                              common.default_init("kmeans", 4)["centers"])


@pytest.mark.parametrize("metrics,consumed", [
    ([0.5, 0.7, 0.6, 0.9], [100.0, 220.0, 390.0, 500.0]),
    ([float("nan"), 0.4, float("nan"), 0.8, 0.3],
     [10.0, 30.0, 60.0, 80.0, 100.0]),
    ([0.2], [0.0]),
    ([], []),
])
def test_best_at_fractions_is_the_references(metrics, consumed):
    assert fig4_tradeoff._best_at_fractions(metrics, consumed) == \
        ref_fig4._best_at_fractions(metrics, consumed)
    assert fig4_tradeoff.FRACTIONS == ref_fig4.FRACTIONS
    assert fig4_tradeoff.ALGOS == ref_fig4.ALGOS


# -- the figures --------------------------------------------------------------


def test_fig3_matches_reference(monkeypatch):
    kw = dict(h_values=[1.0, 15.0], seeds=(0,), budget=1200.0, n_data=2000,
              quiet=True)
    ref_seen = capture(monkeypatch, JaxSession)
    port_seen = capture(monkeypatch, ELSession)
    runs = []
    ref_rows = ref_fig3.run(**kw)
    port_rows = fig3_heterogeneity.run(**kw, init_for=ref_init,
                                       on_run=runs.append, device=CPU)
    assert len(port_seen) == 2 * 2 * 4
    bound = assert_same_runs(port_seen, ref_seen)
    assert_same_rows(port_rows, ref_rows, bound)
    # ``on_run`` saw each run as it ended
    assert [decisions(r) for r in runs] == \
        [decisions(rep) for *_, rep in port_seen]
    assert [r.arm_pulls for r in runs] == \
        [rep.arm_pulls for *_, rep in port_seen]
    assert [(r.workload, r.policy, r.mode, r.heterogeneity, r.seed)
            for r in runs][:4] == [("svm", p, m, 1.0, 0)
                                   for p, m in fig3_heterogeneity.ALGOS]
    assert fig3_heterogeneity.H_VALUES == ref_fig3.H_VALUES
    assert fig3_heterogeneity.ALGOS == ref_fig3.ALGOS


def test_fig4_matches_reference_on_replayed_draws(monkeypatch):
    """The host rows on numpy streams, the svm ``ol4el-sync`` one-cell
    sweep and ``ol4el-async`` event engine on the reference's draws."""
    kw = dict(budget=1200.0, n_data=2000, seeds=(0,), quiet=True)
    ref_seen = capture(monkeypatch, JaxSession)
    port_seen = capture(monkeypatch, ELSession)
    ref_rows = ref_fig4.run(**kw)
    port_rows = fig4_tradeoff.run(**kw, init_for=ref_init,
                                  draws_for=ref_draws, device=CPU)
    kinds = [k for k, *_ in port_seen]
    assert kinds == ["sweep", "run_async_ingraph"] + ["run"] * 6
    bound = assert_same_runs(port_seen, ref_seen)
    assert_same_rows(port_rows, ref_rows, bound + 1e-5)


def test_run_el_ingraph_sync_matches_reference_on_replayed_draws(
        monkeypatch):
    """``run_el(ingraph=True)`` in sync mode: the compiled sync round at
    the session's default horizon, on the reference's draws."""
    kw = dict(budget=1200.0, n_data=2000, seed=0, ingraph=True)
    ref_seen = capture(monkeypatch, JaxSession)
    port_seen = capture(monkeypatch, ELSession)
    ref = ref_common.run_el("svm", "ol4el", "sync", 6.0, **kw)
    port = common.run_el("svm", "ol4el", "sync", 6.0, **kw,
                         init_params=ref_init("svm", 0),
                         draws_for=ref_draws, device=CPU)
    assert [k for k, *_ in port_seen] == ["run_sync_ingraph"]
    bound = assert_same_runs(port_seen, ref_seen)
    assert decisions(port) == decisions(ref)
    assert port.n_aggregations == ref.n_aggregations
    assert abs(port.final_metric - ref.final_metric) <= bound


def _csv(text):
    lines = text.splitlines()
    head = lines.index("name,us_per_call,derived")
    return [ln.rsplit(",", 2) for ln in lines[head + 1:]
            if not ln.startswith("#")]


def test_run_fast_fig5_matches_reference(monkeypatch, tmp_path, capsys):
    """``run.main --fast --only fig5`` (edges 3 / 10, H 1 / 15, budget 400,
    2,000 samples): every run the reference's, the same JSON keys and CSV
    row names, the metrics within the flip bound."""
    ref_seen = capture(monkeypatch, JaxSession)
    port_seen = capture(monkeypatch, ELSession)
    ref_out, port_out = tmp_path / "ref.json", tmp_path / "port.json"
    ref_run.main(["--fast", "--only", "fig5", "--out", str(ref_out)])
    ref_csv = _csv(capsys.readouterr().out)
    # the port is handed the reference's init as its figure runs ask
    real_run_el = common.run_el
    monkeypatch.setattr(
        "repro_torch.bench.fig5_scalability.run_el",
        lambda *a, **kw: real_run_el(
            *a, **dict(kw, init_params=ref_init(a[0], kw["seed"]))))
    port_run.main(["--fast", "--only", "fig5", "--device", "cpu", "--out",
                   str(port_out)])
    port_csv = _csv(capsys.readouterr().out)
    assert len(port_seen) == 2 * 2 * 2 * 2
    bound = assert_same_runs(port_seen, ref_seen)
    ref_json, port_json = (json.loads(p.read_text())
                           for p in (ref_out, port_out))
    assert port_json.keys() == ref_json.keys()
    # no planner rows under this working directory's results/ (the
    # checkout's, which .gitignore lists): the roofline half writes none
    assert port_json["roofline"] == port_json["micro"] == []
    assert_same_rows(port_json["figures"], ref_json["figures"], bound)
    assert [r[:2] for r in port_csv] == [r[:2] for r in ref_csv]
    assert len(port_csv) == 16
    for p, r in zip(port_csv, ref_csv):
        assert abs(float(p[2]) - float(r[2])) <= bound + 1e-4


def test_presets_are_the_references(monkeypatch):
    """Each preset hands every figure the reference's keyword sets."""
    figures = ("fig3_heterogeneity", "fig4_tradeoff", "fig5_scalability",
               "policy_ablation")
    got, want = {}, {}

    def record(into, name):
        def fake(**kw):
            into[name] = kw
            return []
        return fake
    for name in figures:
        monkeypatch.setattr(f"repro_torch.bench.{name}.run",
                            record(got, name))
        monkeypatch.setattr(f"benchmarks.{name}.run", record(want, name))
    monkeypatch.setattr("benchmarks.roofline.run", lambda: [])
    monkeypatch.setattr("benchmarks.microbench.run", lambda: [])
    monkeypatch.setattr("repro_torch.bench.microbench.run",
                        lambda **kw: [])
    for flags in ([], ["--fast"], ["--full"]):
        got.clear()
        want.clear()
        out = ["--out", os.devnull]
        ref_run.main(flags + out)
        port_run.main(flags + out + ["--device", "cpu"])
        assert set(got) == set(want) == set(figures)
        for name, kw in want.items():
            assert got[name] == dict(kw, device="cpu"), (flags, name)


@pytest.mark.parametrize("only", ["roofline"])
def test_run_refuses_the_unported_half_by_name(only, tmp_path, capsys,
                                               monkeypatch):
    """The roofline half, once refused naming ROADMAP item 15, is ported:
    ``--only roofline`` analyzes the planner's rows
    (``results/torch_dryrun*.jsonl``, here under ``tmp_path``) with H100
    constants and writes them to the JSON's ``"roofline"`` and the CSV's
    ``roofline:arch:shape:mesh:step`` lines (``benchmarks/run.py:68-94``)."""
    from repro_torch.launch import dryrun
    monkeypatch.chdir(tmp_path)
    assert dryrun.main(["--arch", "qwen3-1.7b", "--shape", "long_500k"]) == 0
    assert os.path.exists("results/torch_dryrun.jsonl")
    port_run.main(["--only", only, "--device", "cpu", "--out", "x.json"])
    doc = json.loads((tmp_path / "x.json").read_text())
    assert [(r["arch"], r["shape"], r["mesh"], r["step"])
            for r in doc["roofline"]] == [("qwen3-1.7b", "long_500k", "1x1",
                                           "decode_step")]
    row = doc["roofline"][0]
    assert row["t_collective_s"] == 0.0 and row["chips"] == 1
    assert doc["figures"] == doc["micro"] == []
    csv = capsys.readouterr().out.split("name,us_per_call,derived\n")[1]
    assert f"roofline:qwen3-1.7b:long_500k:1x1:decode_step," \
        f"{row['bound_s'] * 1e6:.2f},{row['dominant']}" in csv


def test_run_only_micro_writes_and_prints_the_micro_rows(tmp_path, capsys):
    """``--only micro``: the reference's micro row names in the JSON's
    ``"micro"`` and first in the CSV (``benchmarks/run.py:72-89``)."""
    from test_torch_microbench import reference_row_names
    out = tmp_path / "x.json"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port_run.main(["--only", "micro", "--device", "cpu",
                       "--out", str(out)])
    finally:
        torch.set_num_threads(n)
    doc = json.loads(out.read_text())
    names = reference_row_names()
    assert [r["name"] for r in doc["micro"]] == names
    assert doc["figures"] == [] and doc["roofline"] == []
    csv = capsys.readouterr().out.split("name,us_per_call,derived\n")[1]
    assert [line.split(",")[0] for line in csv.splitlines()
            if not line.startswith("#")] == names
