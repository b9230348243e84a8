"""Several ranks on the CPU, part 2: the async engine, sweeps and the
fleet over a mesh (``run_async_ingraph(mesh=, donate=)``,
``ELSession.sweep(mesh=)``, ``FleetServer(mesh=)``), their placement
policy against the reference's, and the three launchers' ``--mesh``.

Two gloo worlds are spawned once for the whole file, concurrently with
the unsharded runs here: one of 2 ranks (a 2 x 1 (data, model) mesh) and
one of 4 (the 2 x 2 debug mesh; its ``model`` axis replicates).  Every
rank runs every case (``tests/torch_mesh_events_worker.py``, which
imports the port only); this process runs the same cases with
``mesh=None``.  The tolerances:

  * every rank's async run, scenario run, sweep cell, tenant report and
    subscriber event equals the unsharded port run's **bit for bit**
    (NaN metrics equal), its final params too;
  * the unsharded runs make the reference's decisions on its replayed
    ``jax.random`` draws: event edges, intervals, arm pulls, events and
    termination identical, ``consumed`` / ``wall`` bit-equal at fixed
    cost (metric and utility within 1e-6, as ``tests/test_torch_events.
    py`` holds them; final params within 1e-5);
  * the census of a sharded run shows all-gathers only (16 a chunk, each
    of one edge's parameters a lane), no all-reduce; a run on one rank
    shows none.

The reference's own mesh tests fail under this JAX (``with_sharding_
constraint ... Auto axes``), so the sharded runs are held to the
unsharded reference runs; the reference's fleet is held through its
solo runs in ``tests/test_torch_fleet.py``.
"""

import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_events_worker as worker  # noqa: E402
from test_torch_events import jax_event_draws  # noqa: E402
from test_torch_ingraph import jax_round_draws  # noqa: E402

from repro import sharding as ref_sharding  # noqa: E402
from repro.config import OL4ELConfig as JaxCfg  # noqa: E402
from repro.el import ELSession as JaxSession  # noqa: E402
from repro.el import scenarios as jscn  # noqa: E402
from repro.el import sweep as ref_sweep  # noqa: E402
from repro.el.events import knobs as ref_knobs  # noqa: E402
from repro.launch.classic import classic_fixture as jax_fixture  # noqa: E402
from repro_torch.config import OL4ELConfig  # noqa: E402
from repro_torch.el import sweep as port_sweep  # noqa: E402
from repro_torch.el.events import knobs as port_knobs  # noqa: E402
from repro_torch.el.events import padded_event_horizon  # noqa: E402
from repro_torch.launch import hostdev  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_mesh_events_worker.py"
SAMPLES, EDGES, BUDGET = 600, 4, 2500.0
ARCHS = ("svm-wafer", "kmeans-traffic")
WORLDS = {2: ((2, 1), ("data", "model")), 4: ((2, 2), ("data", "model"))}
SCN_ROUNDS, SCN_BUDGET = 48, 2000.0
FIXED = dict(n_edges=EDGES, heterogeneity=2.0, cost_model="fixed")
#: the wave width a mesh of several devices resolves (min(4, EDGES))
AUTO_K = 4
PARAM_TOL = 1e-5
METRIC_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw_arrays(draws):
    return {k: v.numpy() for k, v in draws.arrays.items() if v is not None}


def _spec():
    """The worker's cases: the reference's init params and draws (numpy)
    for the async runs and the churn scenario, a small grid of each mode,
    a fleet of 4 slots whose later tenants arrive mid-flight."""
    spec = {"samples": SAMPLES, "edges": EDGES, "async": [],
            "auto_k": AUTO_K}
    for arch in ARCHS:
        jf = jax_fixture(arch, samples=SAMPLES, n_edges=EDGES,
                         kmeans_impl="jnp")
        cfg_kw = dict(FIXED, mode="async", budget=BUDGET,
                      utility=jf["utility"])
        cfg = OL4ELConfig(**cfg_kw)
        draws = jax_event_draws(cfg.seed + 17, padded_event_horizon(cfg),
                                EDGES, cfg.max_interval, cfg.max_interval,
                                jf["executor"].batch)
        spec["async"].append({
            "arch": arch, "cfg": cfg_kw, "draws": _draw_arrays(draws),
            "init": jax.tree.map(np.asarray, jf["init_params"]),
            "batch": jf["executor"].batch})
    svm = spec["async"][0]
    # the scenario's draws: the scenario-less program's keys (the event
    # horizon depends on the budget and costs only)
    scn = OL4ELConfig(**dict(FIXED, budget=SCN_BUDGET))
    g, u, n = jax_round_draws(scn.seed + 17, SCN_ROUNDS, scn.max_interval,
                              EDGES, scn.max_interval, svm["batch"])
    spec["scenario"] = {
        "arch": "svm-wafer", "init": svm["init"], "rounds": SCN_ROUNDS,
        "cfg": dict(FIXED, budget=SCN_BUDGET, utility=svm["cfg"]["utility"]),
        "draws": {
            "sync": {"gumbel": g, "uniform": u, "normal": n},
            "async": _draw_arrays(jax_event_draws(
                scn.seed + 17, padded_event_horizon(scn), EDGES,
                scn.max_interval, scn.max_interval, svm["batch"]))}}
    spec["sweep"] = {
        "arch": "svm-wafer", "cfg": dict(FIXED, budget=1200.0,
                                         utility=svm["cfg"]["utility"]),
        "grids": {"sync": {"ucb_c": (1.0, 2.0), "seeds": (0, 1),
                           "max_rounds": 64},
                  "async": {"async_batch_k": (1, 2), "ucb_c": (1.0, 2.0),
                            "max_rounds": 256}},
        "untiled": {"seeds": (0, 1, 2), "max_rounds": 16}}
    sync = [{"mode": "sync", "budget": b, "seed": i, "ucb_c": c}
            for i, (b, c) in enumerate([(600.0, 1.0), (900.0, 0.5),
                                        (500.0, 2.0), (800.0, 1.0),
                                        (700.0, 1.5), (650.0, 1.0)])]
    spec["fleet"] = {
        "arch": "svm-wafer", "cfg": dict(FIXED, utility=svm["cfg"]["utility"]),
        "rounds": 64, "slots": 4, "rounds_per_wave": 8, "first": 4,
        "waves_before_more": 2,
        "tenants": sync[:4] + [sync[4], {"mode": "async", "budget": 700.0,
                                         "seed": 6}, sync[5],
                               {"mode": "async", "budget": 800.0,
                                "seed": 7}]}
    return spec


def _spawn(world, spec, d, results):
    spec = dict(spec, mesh=WORLDS[world])
    if world == 4:             # and a (4, 1) mesh of it: one edge a rank
        spec["one_edge_mesh"] = ((4, 1), ("data", "model"))
    with open(d / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}"
               f"{ROOT / 'tests'}")
    results[world] = (d, hostdev.spawn_ranks(
        world, [sys.executable, str(WORKER), str(d / "spec.pkl"), str(d)],
        env=env, capture=True, timeout=600))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(spec, unsharded port results, each world's per-rank results,
    the reference's runs)``: both worlds spawned at once, the unsharded
    and reference runs made here meanwhile."""
    spec = _spec()
    results, threads = {}, []
    for world in WORLDS:
        threads.append(threading.Thread(target=_spawn, args=(
            world, spec, tmp_path_factory.mktemp(f"world{world}"), results)))
        threads[-1].start()
    try:
        plain = worker.run_all(spec, None)
        ref = _reference_runs(spec)
    finally:
        for t in threads:
            t.join()
    out = {}
    for world, (d, procs) in results.items():
        for p in procs:
            assert p.returncode == 0, p.stderr[-4000:]
        out[world] = [pickle.load(open(d / f"rank{r}.pkl", "rb"))
                      for r in range(world)]
    return spec, plain, out, ref


@pytest.fixture(scope="module")
def refs(runs):
    return runs[3]


def _reference_runs(spec):
    """The reference's unsharded runs: the async program per arch, the
    churn scenario's sync round and async events (its programs on its
    own keys, whose draws the cases replay)."""
    from test_torch_scenarios import jax_async_knobs, jax_ingraph_knobs

    from repro.el.events import make_async_program as jax_async_program
    from repro.el.ingraph import make_sync_program as jax_sync_program
    out = {}
    for case in spec["async"]:
        jf = jax_fixture(case["arch"], samples=SAMPLES, n_edges=EDGES,
                         kmeans_impl="jnp")
        cfg = dataclasses.replace(jf["exp"].ol4el, **case["cfg"])
        out[case["arch"]] = (JaxSession(cfg, metric_name=jf["metric"],
                                        lr=jf["lr"])
                             .with_executor(jf["executor"],
                                            init_params=jf["init_params"])
                             .run_async_ingraph())
    jf = jax_fixture("svm-wafer", samples=SAMPLES, n_edges=EDGES,
                     kmeans_impl="jnp")
    ex = jf["executor"]
    scn = jscn.ScenarioSpec(churn=jscn.ChurnSpec(rate=0.3, period=16))
    for mode in ("sync", "async"):
        cfg = dataclasses.replace(jf["exp"].ol4el, **dict(
            spec["scenario"]["cfg"], mode=mode, scenario=scn))
        if mode == "sync":
            prog = jax_sync_program(
                ex.model, ex.edge_data, ex.eval_set, cfg, lr=ex.lr,
                batch=ex.batch, n_samples=np.asarray(jf["n_samples"],
                                                     np.float64),
                max_rounds=SCN_ROUNDS, metric_name=jf["metric"])
            knobs = jax_ingraph_knobs(cfg)
        else:
            prog = jax_async_program(
                ex.model, ex.edge_data, ex.eval_set, cfg, lr=ex.lr,
                batch=ex.batch, max_events=padded_event_horizon(cfg),
                metric_name=jf["metric"])
            knobs = jax_async_knobs(cfg)
        _, got = jax.jit(prog)(jf["init_params"],
                               jax.random.key(cfg.seed + 17), knobs)
        out["scenario", mode] = jax.tree.map(np.asarray, got)
    return out


def _ranks(runs, world):
    return runs[2][world]


# -- the placement policy (pure) ------------------------------------------------------


class DuckMesh:
    """What both packages' placement reads of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names, self.devices = axes, np.empty(shape)


MESHES = {"2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "model-only": ((4,), ("model",))}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("scenario", [False, True])
def test_sweep_partition_specs_are_the_references(mesh, mode, scenario):
    """Spec for spec, on grids that tile the edge axes or not; a grid
    that does not tile raises the reference's ``ValueError``."""
    m = DuckMesh(*MESHES[mesh])
    sizes = dict(zip(m.axis_names, m.devices.shape))
    for n_cells in (1, 3, 4, 8, 64, 512):
        for n_edges in (3, 4, 32):
            args = (m.axis_names, sizes, n_cells, n_edges, mode, scenario)
            try:
                want = ref_sweep.sweep_partition_specs(*args)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    port_sweep.sweep_partition_specs(*args)
                assert str(got.value) == str(e)
                continue
            got = port_sweep.sweep_partition_specs(*args)
            assert tuple(got[0]) == tuple(want[0])
            assert {k: tuple(v) for k, v in got[1].items()} == \
                {k: tuple(v) for k, v in want[1].items()}
            placements = port_sweep.sweep_input_shardings(
                m, n_cells, n_edges, mode, scenario)
            assert placements[0].replicated
            assert tuple(placements[1].spec) == tuple(want[0])
            assert {k: tuple(p.spec) for k, p in placements[2].items()} \
                == {k: tuple(v) for k, v in want[1].items()}


@pytest.mark.parametrize("mesh", [None] + list(MESHES))
def test_resolve_async_batch_k_is_the_references(mesh):
    m = None if mesh is None else DuckMesh(*MESHES[mesh])
    for n_edges in (1, 2, 3, 4, 8):
        for k in (0, 1, 2, 5):
            for scenario in (False, True):
                kw = dict(n_edges=n_edges, async_batch_k=k)
                got = port_knobs.resolve_async_batch_k(OL4ELConfig(
                    **kw, scenario=object() if scenario else None), m)
                want = ref_knobs.resolve_async_batch_k(JaxCfg(
                    **kw, scenario=object() if scenario else None), m)
                assert got == want, (kw, scenario)
    assert ref_sharding.EL_EDGE_KNOBS == port_sweep.engine.EL_EDGE_KNOBS


# -- the async engine over ranks ------------------------------------------------------

GRID = [(w, a, k) for w in WORLDS for a in ARCHS for k in ("one", "auto")]


@pytest.mark.parametrize("world,arch,k", GRID)
def test_sharded_async_run_is_the_unsharded_run_on_every_rank(
        runs, world, arch, k):
    """One event a step, and the wave width resolved on the mesh (every
    edge a wave), each against the unsharded run at the same width, and
    both with the single events' events."""
    plain = runs[1]
    want = plain["async"][arch]
    for rank, res in enumerate(_ranks(runs, world)):
        got = res["async"][arch][k]
        assert res["rank"] == rank
        assert got["device_loop"]["batch_k"] == (1 if k == "one" else AUTO_K)
        assert want[k]["device_loop"]["batch_k"] == \
            got["device_loop"]["batch_k"]
        assert worker.same(got["events"], want[k]["events"])
        assert worker.same(got["params"], want[k]["params"])
        assert worker.same(got["events"], want["one"]["events"])
        assert (got["n"], got["arm_pulls"], got["terminated"]) == \
            (want["one"]["n"], want["one"]["arm_pulls"],
             want["one"]["terminated"])
        loop = got["device_loop"]
        assert loop["graphs_captured"] == 0 and loop["replays"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_async_runs_make_the_references_decisions(runs, refs, arch):
    """The unsharded port runs (which every rank's equal) on the
    reference's replayed draws: its decisions, ``consumed`` / ``wall``
    bit-equal at fixed cost."""
    plain = runs[1]
    ref = refs[arch]
    assert len(ref.records) > EDGES * 10
    for k in ("one", "auto"):
        got = plain["async"][arch][k]
        ev = got["events"]
        assert [e[0] for e in ev] == [r.edge for r in ref.records]
        assert [e[1] for e in ev] == [r.interval for r in ref.records]
        assert got["arm_pulls"] == list(ref.arm_pulls)
        assert (got["n"], got["terminated"]) == (ref.n_aggregations,
                                                 ref.terminated_reason)
        np.testing.assert_array_equal(
            np.float32([e[2] for e in ev]),
            np.float32([r.total_consumed for r in ref.records]))
        np.testing.assert_array_equal(
            np.float32([e[3] for e in ev]),
            np.float32([r.wall_time for r in ref.records]))
        np.testing.assert_allclose([e[5] for e in ev],
                                   [r.utility for r in ref.records],
                                   atol=METRIC_TOL)
        for key, v in ref.final_params.items():
            np.testing.assert_allclose(got["params"][key], np.asarray(v),
                                       rtol=PARAM_TOL, atol=PARAM_TOL)


@pytest.mark.parametrize("world,arch", [(w, a) for w in WORLDS
                                        for a in ARCHS])
def test_donated_sharded_async_run_aliases_the_params(runs, world, arch):
    spec, plain = runs[:2]
    case = next(c for c in spec["async"] if c["arch"] == arch)
    param_bytes = sum(v.nbytes for v in case["init"].values())
    for res in _ranks(runs, world):
        got = res["async"][arch]
        d = got["donated"]
        assert worker.same(d["events"], got["auto"]["events"])
        assert worker.same(d["params"], got["auto"]["params"])
        assert d["shares_storage"] and "donated" in d["reuse"]
        assert d["alias_bytes"] == param_bytes > 0
        assert got["auto"]["alias_bytes"] == 0
    assert plain["async"][arch]["donated"]["alias_bytes"] == param_bytes


@pytest.mark.parametrize("world,arch,k", GRID)
def test_async_census_gathers_one_edge_a_lane(runs, world, arch, k):
    """One chunk of 16 masked steps: one all-gather a step, of one edge's
    parameters a lane (the event's one lane, or the wave's 4), nothing
    reduced across ranks; the unsharded run issues none."""
    spec, plain = runs[:2]
    case = next(c for c in spec["async"] if c["arch"] == arch)
    lanes = 1 if k == "one" else AUTO_K
    edge_bytes = sum(v.nbytes for v in case["init"].values())
    for res in _ranks(runs, world):
        got = res["async"][arch][k]
        assert set(got["collectives"]) == {"all-gather"}
        assert got["collectives"]["all-gather"]["count"] == 16
        assert got["collectives"]["all-gather"]["bytes"] == \
            16 * lanes * edge_bytes == got["collective_bytes"]
    assert plain["async"][arch][k]["collectives"] == {}


# -- the scenario path over ranks -------------------------------------------------------


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_sharded_scenario_runs_are_the_unsharded_runs(runs, world, mode):
    plain = runs[1]
    want = plain["scenario"][mode]
    for res in _ranks(runs, world):
        got = res["scenario"][mode]
        assert worker.same(got["raw"], want["raw"])
        assert worker.same(got["params"], want["params"])
        assert set(got["collectives"]) == {"all-gather"}
    assert want["collectives"] == {}


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("kind", ["one", "auto", "sync", "async"])
def test_gloo_cells_gather_and_run_eagerly(runs, world, kind):
    """Over gloo an async cell (one event, or the mesh's wave) and the
    churn scenario's sync and async cells gather, and no CUDA graph can
    hold the gathers: no capture, no replay, every chunk eager; the
    unsharded cells gather nothing and may be captured (on a card)."""
    plain = runs[1]
    for res in _ranks(runs, world):
        got = (res["async"][arch][kind] for arch in ARCHS) \
            if kind in ("one", "auto") else [res["scenario"][kind]]
        for g in got:
            assert g["cell"] == (True, False)
            loop = g["device_loop"]
            assert loop["graphs_captured"] == 0 and loop["replays"] == 0
            assert loop["chunks"] > 0
    want = [plain["async"][a][kind] for a in ARCHS] \
        if kind in ("one", "auto") else [plain["scenario"][kind]]
    assert all(w["cell"] == (False, True) for w in want)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_one_edge_a_rank_scenario_runs_are_the_unsharded_runs(runs, mode):
    """The 4 ranks as a (4, 1) mesh, one edge a rank: the churn
    scenario's sync round (a rank's lone lane run beside a copy) and
    async events, bit for bit the unsharded runs."""
    want = runs[1]["scenario"][mode]
    for res in _ranks(runs, 4):
        got = res["scenario_one_edge"][mode]
        assert worker.same(got["raw"], want["raw"])
        assert worker.same(got["params"], want["params"])
        assert set(got["collectives"]) == {"all-gather"}
        assert got["cell"] == (True, False)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_scenario_runs_make_the_references_decisions(runs, refs, mode):
    got, want = runs[1]["scenario"][mode]["raw"], refs["scenario", mode]
    n = int(want["n_rounds"])
    assert int(got["n_rounds"]) == n > 8
    keys = ("interval", "active_edges", "arm_pulls", "consumed", "wall",
            "wall_time", "budgets_left")
    if mode == "async":
        keys += ("edge", "cost", "n_active")
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # churn bit: an edge was out for a round or an event
    assert want["active_edges"][:n].min() < EDGES
    np.testing.assert_allclose(got["utility"], want["utility"],
                               atol=METRIC_TOL)


# -- sweeps and the fleet over ranks ------------------------------------------------------


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_sharded_sweep_is_the_unsharded_sweep(runs, world, mode):
    """Every cell, ``out`` and final params, on every rank; a rank ran
    its block of the cells (2 of 4; the async grid's two wave widths 1 of
    2 each)."""
    plain = runs[1]
    want = plain["sweep"][mode]
    for res in _ranks(runs, world):
        got = res["sweep"][mode]
        assert worker.same(got["out"], want["out"])
        assert worker.same(got["params"], want["params"])
        assert worker.same(got["finals"], want["finals"])
        per_rank = 2 if mode == "sync" else 1
        assert [lp["n_cells"] for lp in got["loops"]] == \
            [per_rank] * len(want["loops"])


@pytest.mark.parametrize("world", list(WORLDS))
def test_a_grid_that_does_not_tile_raises(runs, world):
    """A 3-cell grid on the 2-wide ``data`` axis: every rank raises the
    reference's ``ValueError``; without a mesh the grid runs."""
    with pytest.raises(ValueError) as want:
        ref_sweep.sweep_partition_specs(("data", "model"),
                                        {"data": 2, "model": world // 2}, 3,
                                        EDGES)
    assert "does not tile" in str(want.value)
    assert runs[1]["sweep"]["untiled"] is None
    for res in _ranks(runs, world):
        assert res["sweep"]["untiled"] == str(want.value)


@pytest.mark.parametrize("world", list(WORLDS))
def test_sharded_fleet_is_the_unsharded_server(runs, world):
    """Reports, the subscriber stream (every delta and report, in order)
    and ``stats()`` on every rank; every cohort's slots split over the
    ranks; tenants admitted mid-flight."""
    plain = runs[1]
    want = plain["fleet"]
    assert want["stats"]["tenants_done"] == 8
    assert want["stats"]["cohorts"] == 2
    assert want["sharded"] == [False, False]
    for res in _ranks(runs, world):
        got = res["fleet"]
        assert worker.same(got["reports"], want["reports"])
        assert worker.same(got["stream"], want["stream"])
        assert got["stats"] == want["stats"]
        assert got["sharded"] == [True, True]


@pytest.mark.parametrize("world", list(WORLDS))
def test_a_rank_imports_no_jax_or_reference(runs, world):
    assert all(res["modules"] == [] for res in _ranks(runs, world))


# -- the launchers --------------------------------------------------------------------

LAUNCHERS = {
    "train": ["--arch", "svm-wafer", "--mode", "ol4el", "--el-mode",
              "async", "--edges", "4", "--samples", "400", "--budget",
              "1500", "--donate"],
    "sweep": ["--arch", "svm-wafer", "--el-mode", "async", "--ucb-c", "1",
              "2", "--seeds", "0", "--samples", "400", "--edges", "4",
              "--max-rounds", "256"],
    "fleet": ["--demo", "--samples", "256", "--assert-compiles", "2"],
}


@pytest.fixture(scope="module")
def launched():
    """Each launcher's ``--mesh debug --device cpu`` run, all three at
    once: each spawns the default world of 4 ranks (the 2 x 2 debug
    mesh)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for name in ("WORLD_SIZE", "RANK", "REPRO_SWEEP_DEVICES"):
        env.pop(name, None)
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.launch.{name}", "--device",
         "cpu", "--mesh", "debug"] + argv, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name, argv in LAUNCHERS.items()}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        out[name] = (p.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("name", list(LAUNCHERS))
def test_launcher_runs_over_a_debug_mesh(launched, name):
    """The world exits 0 and only rank 0 prints."""
    code, out, err = launched[name]
    assert code == 0, err[-3000:]
    assert "spawning a world of 4 ranks" in out
    assert out.count("mesh {'data': 2, 'model': 2} (gloo, 4 ranks)") == 1
