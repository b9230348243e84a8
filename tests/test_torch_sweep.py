"""The port's ablation sweep (``repro_torch.el.sweep``) vs the reference's
(``repro.el.sweep``), on the CPU.

The reference vmaps its compiled programs over cells, each cell drawing
from ``jax.random.key(seed + 17)``; the port runs the same cells as one
device loop with a leading cell dimension, each cell drawing through its
own RNG-seam provider.  Handed ``ReplayDraws`` of each cell's
``jax.random`` draws (``jax_round_draws`` / ``jax_event_draws``, the solo
parity tests' helpers), every port cell must make the reference cell's
decisions (intervals, event edges, arm pulls, rounds, termination),
``consumed`` and ``wall`` bit-equal at fixed cost; and every port cell
must equal, field for field and bit for bit, the port's own solo program
on the same draws.  functorch's per-cell fallback warning ("performance
drop") is an error throughout: an op without a batching rule would run
once per cell on the card.
"""

import dataclasses
import math
import warnings

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_events import jax_event_draws  # noqa: E402
from test_torch_ingraph import jax_round_draws  # noqa: E402

from repro.config import OL4ELConfig as JaxCfg  # noqa: E402
from repro.el import ELSession as JaxSession  # noqa: E402
from repro.el.sweep import SweepReport as JaxReport  # noqa: E402
from repro.el.sweep import SweepSpec as JaxSpec  # noqa: E402
from repro.launch.classic import classic_fixture as jax_fixture  # noqa: E402
from repro_torch.config import OL4ELConfig  # noqa: E402
from repro_torch.el import ELSession  # noqa: E402
from repro_torch.el import events, ingraph  # noqa: E402
from repro_torch.el.sweep import (AXIS_ORDER, SweepReport,  # noqa: E402
                                  SweepSpec, knob_names, make_sweep_program,
                                  spec_from_sequences, stack_knobs)
from repro_torch.interop import params_from_numpy  # noqa: E402

SAMPLES, EDGES = 1500, 3
GRID = dict(ucb_c=(1.0, 2.0), budget=(900.0, 1300.0), seeds=(0, 3))
PERF_DROP = ".*performance drop.*"

pytestmark = pytest.mark.filterwarnings(f"error:{PERF_DROP}")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The device loops are hundreds of small ops a step; on a CPU that
    other test processes load, torch's OpenMP pool spin-waits between them
    (a case took 112 s under load with the default pool, 19 s with one
    thread).  One intra-op thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- SweepSpec --------------------------------------------------------------


SPECS = [
    dict(ucb_c=(1.0, 2.0), seeds=(0, 7)),
    dict(ucb_c=(1.0, 2.0), budget=(900.0, 1300.0), seeds=(0, 3),
         max_rounds=64),
    dict(cost_noise=(0.0, 0.3), heterogeneity=(1.0, 4.0), seeds=(1,)),
    dict(async_batch_k=(1, 2), async_alpha=(0.3, 0.6), seeds=(0, 3),
         max_rounds=48),
    dict(),
]


@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("mode,cost_model", [("sync", "fixed"),
                                             ("async", "variable")])
def test_spec_flattens_as_the_reference(kw, mode, cost_model):
    cfg_kw = dict(mode=mode, cost_model=cost_model, cost_noise=0.2,
                  ucb_c=1.5, budget=777.0, heterogeneity=3.0)
    jcfg, cfg = JaxCfg(**cfg_kw), OL4ELConfig(**cfg_kw)
    want, got = JaxSpec(**kw), SweepSpec(**kw)
    assert AXIS_ORDER == tuple(want.axes(jcfg))
    assert got.n_cells == want.n_cells
    assert got.axes(cfg) == want.axes(jcfg)
    assert got.cells(cfg) == want.cells(jcfg)
    assert got.describe(cfg) == want.describe(jcfg)
    fields = [f.name for f in dataclasses.fields(OL4ELConfig)]
    for g, w in zip(got.cell_cfgs(cfg), want.cell_cfgs(jcfg)):
        assert {f: getattr(g, f) for f in fields} == \
            {f: getattr(w, f) for f in fields}
    assert [(k, s.async_batch_k, s.n_cells) for k, s in got.per_batch_k()] \
        == [(k, s.async_batch_k, s.n_cells) for k, s in want.per_batch_k()]
    assert stack_knobs(got.cell_cfgs(cfg)).keys() == set(knob_names(mode))
    assert spec_from_sequences(**{k: list(v) if isinstance(v, tuple) else v
                                  for k, v in kw.items()}) == got


@pytest.mark.parametrize("kw", [dict(seeds=()), dict(max_rounds=0),
                                dict(budget=(0.0,)),
                                dict(heterogeneity=(0.5,)),
                                dict(cost_noise=(-0.1,)),
                                dict(async_alpha=(0.0,)),
                                dict(async_alpha=(1.5,)),
                                dict(async_batch_k=(-1,))])
def test_spec_validation_messages_are_the_reference(kw):
    with pytest.raises(ValueError) as want:
        JaxSpec(**kw)
    with pytest.raises(ValueError) as got:
        SweepSpec(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(policy=("ol4el",)),
                                dict(churn_rate=(0.1,))])
def test_scenario_axes_name_their_item(kw):
    """The scenario engine's axes build the reference's cells on a config
    with a scenario (the churn axis rewrites the churn rate)."""
    from repro.el.scenarios import ChurnSpec as JaxChurn
    from repro.el.scenarios import ScenarioSpec as JaxScn
    from repro_torch.el.scenarios import ChurnSpec, ScenarioSpec
    spec, ref = SweepSpec(**kw), JaxSpec(**kw)
    cfg = OL4ELConfig(mode="sync", scenario=ScenarioSpec(
        churn=ChurnSpec(rate=0.3, period=8)))
    want_cfg = JaxCfg(mode="sync", scenario=JaxScn(
        churn=JaxChurn(rate=0.3, period=8)))
    assert spec.n_cells == ref.n_cells and spec.axes(cfg) == \
        ref.axes(want_cfg)
    assert [dataclasses.asdict(c) for c in spec.cell_cfgs(cfg)] == \
        [dataclasses.asdict(c) for c in ref.cell_cfgs(want_cfg)]


def test_stack_knobs_match_the_reference():
    from repro.el.sweep import stack_knobs as jax_stack_knobs
    for mode in ("sync", "async"):
        kw = dict(mode=mode, cost_model="variable", cost_noise=0.3,
                  n_edges=5)
        cells = SweepSpec(ucb_c=(0.5, 2.0), budget=(900.0, 4000.0),
                          heterogeneity=(1.0, 6.0))
        want = jax_stack_knobs(JaxSpec(
            ucb_c=(0.5, 2.0), budget=(900.0, 4000.0),
            heterogeneity=(1.0, 6.0)).cell_cfgs(JaxCfg(**kw)))
        got = stack_knobs(cells.cell_cfgs(OL4ELConfig(**kw)))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


# -- SweepReport ------------------------------------------------------------


def _toy_out():
    """2 ucb_c × 2 seeds, hand-built histories (R = 4), as the reference's
    ``tests/test_el_sweep.py::_toy_report``."""
    nan = np.nan
    metric = np.array([[0.5, 0.6, 0.7, nan], [0.4, 0.6, nan, nan],
                       [0.5, 0.8, 0.9, 0.9], [0.5, 0.7, 0.8, nan]])
    consumed = np.cumsum(np.where(np.isnan(metric), 0.0, 60.0), axis=1)
    return {"metric": metric, "consumed": consumed,
            "utility": np.zeros_like(metric),
            "interval": np.ones_like(metric, np.int32),
            "wall": consumed / 3.0, "n_rounds": np.array([3, 2, 4, 3]),
            "budgets_left": np.zeros((4, 3), np.float32),
            "arm_pulls": np.zeros((4, 10), np.int32),
            "wall_time": consumed[:, -1] / 3.0}


def _reports(out, kw, n_active=None):
    cfg_kw = dict(budget=100.0, heterogeneity=1.0)
    reps = []
    for spec_cls, cfg_cls, rep_cls in ((JaxSpec, JaxCfg, JaxReport),
                                       (SweepSpec, OL4ELConfig,
                                        SweepReport)):
        spec, cfg = spec_cls(**kw), cfg_cls(**cfg_kw)
        o = {k: np.array(v) for k, v in out.items()}
        if n_active is not None:
            o["n_active"] = np.asarray(n_active)
        reps.append(rep_cls(spec=spec, axes=spec.axes(cfg),
                            cells=spec.cells(cfg), out=o))
    return reps


def _same_rows(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], np.ndarray):
                np.testing.assert_array_equal(x[k], y[k])
            elif isinstance(x[k], float) and math.isnan(x[k]):
                assert math.isnan(y[k]), k
            else:
                assert x[k] == y[k], k


def assert_reports_agree(want, got):
    """Every reduction of the port's ``SweepReport`` equals the
    reference's on the same ``out``."""
    np.testing.assert_array_equal(got.final_metrics(), want.final_metrics())
    np.testing.assert_array_equal(got.total_consumed(),
                                  want.total_consumed())
    np.testing.assert_array_equal(got.truncated(), want.truncated())
    _same_rows(got.learning_curves(), want.learning_curves())
    _same_rows(got.grouped_rows(), want.grouped_rows())
    for group in (True, False):
        _same_rows(got.pareto_frontier(group), want.pareto_frontier(group))
    _same_rows(got.to_rows(), want.to_rows())
    assert got.best_cell() == want.best_cell()
    assert got.summary() == want.summary()


@pytest.mark.parametrize("case", ["toy", "no_metric", "async_in_flight",
                                  "dominated"])
def test_report_reductions_match_the_reference(case):
    out, n_active = _toy_out(), None
    if case == "no_metric":
        out["metric"][:] = np.nan
    elif case == "async_in_flight":
        n_active = [0, 2, 0, 1]
    elif case == "dominated":
        out["metric"][2:] = np.array([[0.3, 0.4, 0.5, 0.5],
                                      [0.3, 0.4, 0.5, np.nan]])
    want, got = _reports(out, dict(ucb_c=(1.0, 2.0), seeds=(0, 1),
                                   max_rounds=4), n_active)
    assert_reports_agree(want, got)


def test_report_scores_final_params_through_the_port_tree():
    _, got = _reports(dict(_toy_out(), metric=np.full((4, 4), np.nan)),
                      dict(ucb_c=(1.0, 2.0), seeds=(0, 1), max_rounds=4))
    got.final_params = {"w": torch.arange(4.0)[:, None].repeat(1, 3)}
    assert got.score_final_params(lambda p: float(p["w"].sum()))
    np.testing.assert_array_equal(got.final_metrics(), [0.0, 3.0, 6.0, 9.0])
    _, with_metric = _reports(_toy_out(), dict(ucb_c=(1.0, 2.0),
                                               seeds=(0, 1), max_rounds=4))
    with_metric.final_params = got.final_params
    assert not with_metric.score_final_params(lambda p: 0.0)


# -- the sweep against the reference's, cell by cell ------------------------


@pytest.fixture(scope="module")
def fixtures():
    return {(arch, impl): (
        jax_fixture(arch, samples=SAMPLES, n_edges=EDGES, kmeans_impl=impl),
        classic_fixture_cpu(arch))
        for arch, impl in (("svm-wafer", "jnp"), ("kmeans-traffic", "jnp"),
                           ("kmeans-traffic", "pallas"))}


def classic_fixture_cpu(arch):
    from repro_torch.launch.classic import classic_fixture
    return classic_fixture(arch, samples=SAMPLES, n_edges=EDGES,
                           device="cpu")


def _cfg(fx, mode, cost_model):
    return dataclasses.replace(fx["exp"].ol4el, mode=mode, n_edges=EDGES,
                               utility=fx["utility"], heterogeneity=2.0,
                               cost_model=cost_model, cost_noise=0.2)


def _cell_draws(cells, cfg, batch, horizon):
    """Each cell's reference draws, ``jax.random.key(seed + 17)``'s, as a
    ``ReplayDraws`` (cells with one seed share the arrays)."""
    by_seed = {}
    for c in cells:
        if c.seed not in by_seed:
            if cfg.mode == "sync":
                by_seed[c.seed] = ingraph_replay(jax_round_draws(
                    c.seed + 17, horizon, cfg.max_interval, EDGES,
                    cfg.max_interval, batch))
            else:
                by_seed[c.seed] = jax_event_draws(
                    c.seed + 17, horizon, EDGES, cfg.max_interval,
                    cfg.max_interval, batch)
    return [by_seed[c.seed] for c in cells]


def ingraph_replay(arrays):
    from repro_torch.el.rng import ReplayDraws
    return ReplayDraws(*arrays)


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def _solo_program(tf, ccfg, horizon, init):
    ex = tf["executor"]
    if ccfg.mode == "sync":
        prog = ingraph.make_sync_program(
            ex.model, ex.edge_data, ex.eval_set, ccfg, lr=ex.lr,
            batch=ex.batch, n_samples=tf["n_samples"], max_rounds=horizon,
            device="cpu")
        return lambda d: prog(init, ingraph.sync_knobs(ccfg), d)
    prog = events.make_async_program(
        ex.model, ex.edge_data, ex.eval_set, ccfg, lr=ex.lr, batch=ex.batch,
        max_events=horizon, device="cpu")
    return lambda d: prog(init, events.async_knobs(ccfg), d)


CASES = [("svm-wafer", "jnp", "sync", "fixed"),
         ("svm-wafer", "jnp", "sync", "variable"),
         ("kmeans-traffic", "jnp", "sync", "fixed"),
         ("kmeans-traffic", "pallas", "sync", "variable"),
         ("svm-wafer", "jnp", "async", "fixed"),
         ("kmeans-traffic", "jnp", "async", "fixed")]


@pytest.mark.parametrize("arch,impl,mode,cost_model", CASES)
def test_sweep_matches_reference_cell_by_cell(fixtures, arch, impl, mode,
                                              cost_model):
    jf, tf = fixtures[arch, impl]
    cfg = _cfg(tf, mode, cost_model)
    if mode == "sync":
        horizon, extra = 64, {}
    else:
        top = dataclasses.replace(cfg, budget=max(GRID["budget"]))
        horizon, extra = events.padded_event_horizon(top), \
            {"async_batch_k": (1, 2)}
    kw = dict(GRID, max_rounds=horizon, **extra)
    ref = (JaxSession(_cfg(jf, mode, cost_model), metric_name=jf["metric"],
                      lr=jf["lr"])
           .with_executor(jf["executor"], init_params=jf["init_params"],
                          n_samples=jf["n_samples"])
           .sweep(JaxSpec(**kw)))
    spec = SweepSpec(**kw)
    cells = spec.cell_cfgs(cfg)
    draws = _cell_draws(cells, cfg, tf["executor"].batch, horizon)
    init = params_from_numpy(jax.tree.map(np.asarray, jf["init_params"]),
                             "cpu")
    sess = (ELSession(cfg, metric_name=tf["metric"], lr=tf["lr"])
            .with_executor(tf["executor"], init_params=init,
                           n_samples=tf["n_samples"]))
    port = sess.sweep(spec, draws=draws)
    out, want = port.out, ref.out
    fixed = cost_model == "fixed"
    assert port.n_cells == ref.n_cells == len(cells)
    assert port.cells == ref.cells
    # decisions, cell by cell
    np.testing.assert_array_equal(out["n_rounds"], want["n_rounds"])
    assert (out["n_rounds"] > 3).all()
    np.testing.assert_array_equal(out["arm_pulls"], want["arm_pulls"])
    np.testing.assert_array_equal(out["interval"], want["interval"])
    np.testing.assert_array_equal(port.truncated(), ref.truncated())
    assert not port.truncated().any()
    if mode == "async":
        np.testing.assert_array_equal(out["edge"], want["edge"])
        np.testing.assert_array_equal(out["n_active"], want["n_active"])
    check = (np.testing.assert_array_equal if fixed else
             lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6))
    for name in ("consumed", "wall", "wall_time"):
        check(out[name], np.asarray(want[name]))
    # values: the solo parity tests' tiers
    tol = 1e-5 if mode == "sync" else 1e-6
    if arch == "svm-wafer" and mode == "sync" and fixed:
        np.testing.assert_array_equal(out["utility"], want["utility"])
    np.testing.assert_allclose(out["utility"], want["utility"], atol=tol)
    np.testing.assert_allclose(out["metric"], want["metric"], atol=tol)
    np.testing.assert_allclose(port.final_metrics(), ref.final_metrics(),
                               atol=tol)
    # the reports' reductions over the port's own out agree
    assert_reports_agree(
        JaxReport(spec=JaxSpec(**kw), axes=ref.axes, cells=ref.cells,
                  out=dict(out)), SweepReport(
            spec=spec, axes=port.axes, cells=port.cells, out=dict(out)))
    # each cell is its solo program on the same draws, every field
    for i, ccfg in enumerate(cells):
        params, solo = _solo_program(tf, ccfg, horizon, init)(draws[i])
        assert solo.keys() == {k for k in out if k != "final_metric_host"}
        for k, v in solo.items():
            assert _same_bits(out[k][i], v), (i, k)
        for k, v in params.items():
            assert torch.equal(port.final_params[k][i], v), (i, k)


def test_sweep_reruns_reuse_the_program(fixtures):
    _, tf = fixtures["svm-wafer", "jnp"]
    cfg = _cfg(tf, "sync", "fixed")
    sess = (ELSession(cfg, metric_name=tf["metric"], lr=tf["lr"])
            .with_executor(tf["executor"], init_params=tf["init_params"],
                           n_samples=tf["n_samples"]))
    r1 = sess.sweep(SweepSpec(ucb_c=(1.0, 2.0), seeds=(0,), max_rounds=32))
    prog = sess._sweep_programs[0]
    r2 = sess.sweep(SweepSpec(ucb_c=(1.0, 2.0), seeds=(0,), max_rounds=32))
    assert sess._sweep_programs[0] is prog
    assert np.array_equal(r1.out["metric"], r2.out["metric"],
                          equal_nan=True)
    # new knob values on the same grid shape: the same program
    r3 = sess.sweep(SweepSpec(ucb_c=(0.5, 3.0), seeds=(4,), max_rounds=32))
    assert sess._sweep_programs[0] is prog
    stats = r3.telemetry["cache"]
    assert (stats["entries"], stats["hits"], stats["misses"]) == (1, 2, 1)
    assert r3.telemetry["device_loops"][0]["n_cells"] == 2
    # a different grid shape builds another
    sess.sweep(SweepSpec(ucb_c=(1.0, 2.0, 3.0), seeds=(0,), max_rounds=32))
    assert sess._sweep_programs[0] is not prog


def test_sweep_draws_default_to_each_cells_solo_stream(fixtures):
    """Without ``draws`` each cell draws from its own ``TorchDraws``
    seeded with ``seed + 17``: the solo ``run_sync_ingraph``'s stream."""
    _, tf = fixtures["kmeans-traffic", "jnp"]
    cfg = _cfg(tf, "sync", "fixed")

    def session(c):
        return (ELSession(c, metric_name=tf["metric"], lr=tf["lr"])
                .with_executor(tf["executor"],
                               init_params=tf["init_params"],
                               n_samples=tf["n_samples"]))

    spec = SweepSpec(ucb_c=(1.0, 2.0), seeds=(0, 5), max_rounds=64)
    rep = session(cfg).sweep(spec)
    assert "final_metric_host" in rep.out            # F1: host-scored
    for i, ccfg in enumerate(spec.cell_cfgs(cfg)):
        solo = session(ccfg).run_sync_ingraph(max_rounds=64)
        n = int(rep.out["n_rounds"][i])
        assert n == solo.n_aggregations > 0
        assert rep.out["interval"][i][:n].tolist() == \
            [r.interval for r in solo.records]
        assert rep.out["consumed"][i][:n].tolist() == \
            [r.total_consumed for r in solo.records]
        assert rep.final_metrics()[i] == solo.final_metric


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_sweep_path_has_no_per_cell_fallback(fixtures, mode):
    """Every op of the vmapped step has a batching rule: functorch's
    "performance drop" warning (an op run once per cell) is an error."""
    _, tf = fixtures["kmeans-traffic", "jnp"]
    cfg = dataclasses.replace(_cfg(tf, mode, "variable"), async_batch_k=2)
    sess = (ELSession(cfg, metric_name=tf["metric"], lr=tf["lr"])
            .with_executor(tf["executor"], init_params=tf["init_params"],
                           n_samples=tf["n_samples"]))
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=PERF_DROP)
        rep = sess.sweep(SweepSpec(ucb_c=(1.0, 2.0), seeds=(0,),
                                   max_rounds=64))
    assert (rep.out["n_rounds"] > 0).all()


def test_sweep_rejects_what_it_does_not_port(fixtures):
    _, tf = fixtures["svm-wafer", "jnp"]

    def session(**kw):
        cfg = dataclasses.replace(_cfg(tf, "sync", "fixed"), **kw)
        return ELSession(cfg).with_executor(tf["executor"],
                                            init_params=tf["init_params"])

    spec = SweepSpec(seeds=(0,), max_rounds=8)
    with pytest.raises(NotImplementedError, match="item 14"):
        session().sweep(spec, mesh=object())
    # the per-cell rings are ported: each cell's come back stacked
    rep = session().sweep(spec, telemetry=True)
    np.testing.assert_array_equal(rep.out["telemetry"]["head"],
                                  rep.out["n_rounds"])
    with pytest.raises(ValueError, match="policy='greedy'"):
        session(policy="greedy").sweep(spec)
    with pytest.raises(ValueError, match="2 draw providers for 1 cells"):
        session().sweep(spec, draws=[None, None])
    ex = tf["executor"]
    with pytest.raises(ValueError, match="per_batch_k"):
        make_sweep_program(ex.model, ex.edge_data, ex.eval_set,
                           _cfg(tf, "async", "fixed"),
                           SweepSpec(async_batch_k=(1, 2)), lr=ex.lr,
                           batch=ex.batch, device="cpu")


def test_launch_sweep_runs_on_the_cpu(capsys):
    from repro_torch.launch import sweep as launch_sweep
    launch_sweep.main(["--arch", "svm-wafer", "--ucb-c", "1", "2",
                       "--seeds", "0", "1", "--samples", "600",
                       "--max-rounds", "64", "--edges", "2",
                       "--device", "cpu"])
    text = capsys.readouterr().out
    assert "4 cells" in text and "Pareto frontier" in text
    assert "seed-mean learning curves" in text
    assert "compile cache: 1 programs" in text
    launch_sweep.main(["--arch", "kmeans-traffic", "--el-mode", "async",
                       "--async-batch-k", "1", "2", "--seeds", "0",
                       "--samples", "600", "--max-rounds", "128",
                       "--edges", "2", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "2 cells" in text and "Pareto frontier" in text
    with pytest.raises(NotImplementedError, match="item 14"):
        launch_sweep.main(["--device", "cpu", "--samples", "200", "--mesh",
                           "debug"])
    # the scenario engine's axes run, as the reference's launcher runs them:
    # --policy implies the identity scenario, --churn-rate a base --churn
    for flags in (["--policy", "ol4el"], ["--churn", "0.2", "--churn-rate",
                                          "0.1"]):
        launch_sweep.main(["--device", "cpu", "--samples", "200",
                           "--seeds", "0", "--edges", "2", "--max-rounds",
                           "32"] + flags)
        text = capsys.readouterr().out
        assert "1 cells" in text and "policy" in text and "churn" in text
    with pytest.raises(SystemExit):
        launch_sweep.main(["--device", "cpu", "--samples", "200",
                           "--churn-rate", "0.1"])
