"""The port's EL benches (``repro_torch.bench.bench_el`` /
``bench_fleet``) vs the reference's (``scripts/bench_el.py`` /
``bench_fleet.py``), on the CPU at the reference's smoke sizes
(``scripts/bench_check.py:228-233``: 4 edges, 512 samples, batch 64,
budget 300, 16 rounds, 64 events).

The reference's scripts force host devices when imported, so its side is
built here from ``repro.launch.classic.classic_fixture`` and ``repro.el``
as the scripts build it.  The port is handed the reference's init
(``model.init(jax.random.key(0))`` as numpy) and, on the compiled tiers,
each program's ``jax.random.key(cfg.seed + 17)`` draws replayed through
the RNG seam; its host tiers must then make the reference's
aggregations, and each compiled tier the reference program's.  The
sharded tiers run in one world of 4 gloo ranks (the reference's 2 x 2
debug mesh), handed the same init and draws; the reference's sharded
programs fail on this tree's JAX (ROADMAP Queue 3), so those rows are
held to its unsharded programs, which a sharded run equals bit for bit.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_events import jax_event_draws  # noqa: E402
from test_torch_ingraph import jax_round_draws  # noqa: E402

from repro.el import ELSession as JaxSession  # noqa: E402
from repro.el.events import async_knobs as jax_async_knobs  # noqa: E402
from repro.el.events import make_async_program as jax_async_program  # noqa: E402,E501
from repro.el.ingraph import make_sync_program as jax_sync_program  # noqa: E402,E501
from repro.el.ingraph import sync_knobs as jax_sync_knobs  # noqa: E402
from repro.el.scenarios import ChurnSpec as JaxChurn  # noqa: E402
from repro.el.scenarios import ScenarioSpec as JaxScenario  # noqa: E402
from repro.launch.classic import classic_fixture as jax_fixture  # noqa: E402
from repro_torch.bench import bench_el, bench_fleet  # noqa: E402
from repro_torch.el.rng import ReplayDraws  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

SMOKE = ["--device", "cpu", "--edges", "4", "--samples", "512",
         "--batch", "64", "--budget", "300", "--max-rounds", "16",
         "--max-events", "64", "--repeats", "2", "--no-history"]

#: the reference's committed run: its row names and each row's keys
REF_ROWS = json.load(open(os.path.join(ROOT, "BENCH_el.json")))["rows"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The device loops are hundreds of small ops a step; on a loaded CPU
    torch's OpenMP pool spin-waits between them.  One intra-op thread for
    this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_draws(cfg, batch, horizon):
    """The reference program's ``jax.random.key(cfg.seed + 17)`` draws,
    every round or event of its horizon."""
    k = cfg.max_interval
    if cfg.mode == "sync":
        return ReplayDraws(*jax_round_draws(cfg.seed + 17, horizon, k,
                                            cfg.n_edges, k, batch))
    return jax_event_draws(cfg.seed + 17, horizon, cfg.n_edges, k, k, batch)


def ref_el_fixture(args):
    """``scripts/bench_el.py:96``'s ``_fixture`` and init."""
    fx = jax_fixture("svm-wafer", samples=args.samples, n_edges=args.edges,
                     alpha=1.0, batch=args.batch)
    ol = dataclasses.replace(
        fx["exp"].ol4el, mode="sync", policy="ol4el", n_edges=args.edges,
        budget=args.budget, heterogeneity=4.0, utility=fx["utility"],
        seed=0)
    return fx["model"], fx["executor"], ol, fx["n_samples"], \
        fx["model"].init(jax.random.key(0))


def ref_el_aggregations(args):
    """Each tier's ``n_aggregations`` as the reference's script counts
    them (its host loops and ``bench_compiled``'s programs on
    ``jax.random.key(cfg.seed + 17)``)."""
    model, ex, ol, ns, init = ref_el_fixture(args)
    out = {}
    for mode in ("sync", "async"):
        s = JaxSession(dataclasses.replace(ol, mode=mode),
                       metric_name="accuracy", lr=0.05).with_executor(
            ex, init_params=init, n_samples=ns)
        rep = s.run_sync() if mode == "sync" else s.run_async()
        out[f"el_{mode}_host"] = rep.n_aggregations
    churn = JaxScenario(churn=JaxChurn(rate=args.churn_rate))
    tiers = [("el_sync_ingraph", "sync", None, None, None),
             ("el_sync_ingraph_telemetry", "sync", args.telemetry_ring,
              None, None),
             ("el_sync_ingraph_churn", "sync", None, None, churn),
             ("el_async_ingraph", "async", None, None, None),
             ("el_async_ingraph_telemetry", "async", args.telemetry_ring,
              None, None),
             ("el_async_ingraph_batched", "async", None,
              args.async_batch_k, None)]
    for name, mode, telem, batch_k, scn in tiers:
        cfg = dataclasses.replace(ol, mode=mode, scenario=scn)
        if batch_k is not None:
            cfg = dataclasses.replace(cfg, async_batch_k=batch_k)
        if mode == "sync":
            core = jax_sync_program(
                model, ex.edge_data, ex.eval_set, cfg, lr=ex.lr,
                batch=ex.batch, n_samples=np.asarray(ns, np.float64),
                max_rounds=args.max_rounds, telemetry=telem)
            knobs = jax_sync_knobs(cfg)
        else:
            core = jax_async_program(
                model, ex.edge_data, ex.eval_set, cfg, lr=ex.lr,
                batch=ex.batch, max_events=args.max_events,
                telemetry=telem)
            knobs = jax_async_knobs(cfg)
        res = jax.jit(core)(init, jax.random.key(cfg.seed + 17), knobs)
        out[name] = int(res[1]["n_rounds"])
    return out


@pytest.fixture(scope="module")
def el_run():
    args = bench_el.parser().parse_args(SMOKE)
    _, _, _, _, init = ref_el_fixture(args)
    port = bench_el.bench(args, init_params=jax.tree.map(np.asarray, init),
                          draws_for=ref_draws)
    return args, port


def test_rows_are_the_references_less_the_unported_tiers(el_run):
    """Every one of the reference's 14 rows; no tier is left unported."""
    _, port = el_run
    assert len(REF_ROWS) == 14
    assert sorted(port["rows"]) == sorted(REF_ROWS)
    assert "not_ported" not in port["meta"]


def test_rows_have_the_references_keys(el_run):
    """The reference's keys on every row; a donated tier aliases the
    param tree (the reference's 1,920 bytes), every other tier nothing;
    a sharded tier's census is 16 all-gathers a chunk (one a round or
    wave) of rank 0's half of the edge stack, and no all-reduce."""
    _, port = el_run
    param_bytes = REF_ROWS["el_sync_ingraph_donate"]["alias_bytes"]
    for name, row in port["rows"].items():
        keys = set(row) - {"profile_errors"}
        assert keys == set(REF_ROWS[name]), name
        if "collectives" not in row:      # a host tier
            continue
        assert row["alias_bytes"] == (param_bytes if name.endswith(
            "_donate") else 0), name
        if "sharded" in name:
            assert set(row["collectives"]) == {"all-gather"}, name
            gathers = row["collectives"]["all-gather"]
            assert gathers["count"] == 16, name
            assert gathers["bytes"] == row["collective_bytes"] > 0
        else:
            assert row["collectives"] == {}, name
        assert row["argument_bytes"] > 0 and row["flops"] > 0
        # the CPU allocator keeps no peak: said, not faked
        assert row["peak_live_bytes"] is None
        assert any("memory" in e for e in row["profile_errors"])


def test_meta_keeps_the_references_keys(el_run):
    _, port = el_run
    meta = port["meta"]
    ref_meta = json.load(open(os.path.join(ROOT, "BENCH_el.json")))["meta"]
    assert set(ref_meta) - {"jax"} <= set(meta)
    assert meta["backend"] == "cpu" and meta["torch"] == torch.__version__
    assert "device_name" not in meta and "power_limit" not in meta
    assert "CPU-host" not in meta["note"]
    # the sharded tiers' world: the reference's mesh, 4 gloo ranks
    assert meta["mesh"] == ref_meta["mesh"] == {"data": 2, "model": 2}
    assert meta["devices"] == ref_meta["devices"] == 4
    assert meta["ranks"] == {"count": 4, "backend": "gloo", "device": "cpu",
                             "cards": 0, "rows": sorted(
                                 n for n in REF_ROWS if "sharded" in n)}
    assert meta["async_batch_k"] == ref_meta["async_batch_k"] == {
        "batched_tier": 4, "sharded_auto": 4}
    for name in ("el_sync_ingraph_telemetry", "el_sync_ingraph_churn",
                 "el_async_ingraph_telemetry"):
        row = port["rows"][name]
        base = port["rows"][name.rsplit("_", 1)[0]]
        assert row["overhead_vs_ingraph_pct"] == pytest.approx(
            (row["us_per_aggregation"] - base["us_per_aggregation"])
            / base["us_per_aggregation"] * 100)


def test_aggregations_are_the_references(el_run):
    """Host tiers from the reference's init, compiled tiers on the
    reference program's draws: the reference's aggregation counts (a
    donated or sharded tier its unsharded program's)."""
    args, port = el_run
    want = ref_el_aggregations(args)
    for mode in ("sync", "async"):
        for tier in ("ingraph_donate", "sharded", "sharded_donate"):
            want[f"el_{mode}_{tier}"] = want[f"el_{mode}_ingraph"]
    got = {name: row["n_aggregations"] for name, row in port["rows"].items()}
    assert got == want
    assert all(n > 0 for n in got.values())


def test_compiled_tiers_default_to_the_sessions_draws():
    """Without ``draws_for`` a compiled tier draws as
    ``run_sync_ingraph`` does (``TorchDraws`` seeded ``cfg.seed + 17``),
    and every repeat replays the same run."""
    from repro_torch.el import ELSession
    args = bench_el.parser().parse_args(SMOKE)
    model, ex, ol, ns = bench_el._fixture(args, "cpu")
    row = bench_el.bench_compiled(model, ex, ol, ns, "sync", args)
    init = model.init(torch.Generator().manual_seed(0))
    rep = ELSession(ol, metric_name="accuracy", lr=0.05).with_executor(
        ex, init_params=init, n_samples=ns).run_sync_ingraph(
        max_rounds=args.max_rounds)
    assert row["n_aggregations"] == rep.n_aggregations
    assert row["wall_us_stats"]["count"] == args.repeats


# -- bench_fleet --------------------------------------------------------------


FLEET = ["--device", "cpu", "--tenants", "4", "--slots", "2",
         "--repeats", "1", "--no-history"]


@pytest.fixture(scope="module")
def fleet_run():
    args = bench_fleet.parser().parse_args(FLEET)
    fx = jax_fixture("svm-wafer", samples=args.samples, n_edges=args.edges,
                     alpha=args.alpha, data_seed=0)
    port = bench_fleet.bench(
        args, init_params=jax.tree.map(np.asarray, fx["init_params"]))
    return args, fx, port


def test_fleet_rows_and_keys_are_the_references(fleet_run):
    _, _, port = fleet_run
    ref = json.load(open(os.path.join(ROOT, "BENCH_fleet.json")))["rows"]
    assert sorted(port["rows"]) == ["fleet_4", "sequential_host_4",
                                    "sequential_ingraph_4"]
    for name, row in port["rows"].items():
        assert set(row) == set(ref[name.rsplit("_", 1)[0] + "_16"]), name
    assert port["rows"]["fleet_4"]["compiles"] == 0    # the cache was warm


def test_fleet_host_sum_is_the_references(fleet_run):
    """``sequential_host_4`` from the reference's init makes the reference
    script's host loops' aggregations (``bench_fleet.py:87-104``)."""
    args, fx, port = fleet_run
    base = dataclasses.replace(
        fx["exp"].ol4el, mode="sync", policy="ol4el", n_edges=args.edges,
        utility=fx["utility"])
    want = 0
    for cfg in bench_fleet._tenant_cfgs(base, 4):
        want += JaxSession(cfg, metric_name=fx["metric"],
                           lr=fx["lr"]).with_executor(
            fx["executor"], init_params=fx["init_params"],
            n_samples=fx["n_samples"]).run().n_aggregations
    assert port["rows"]["sequential_host_4"]["n_aggregations"] == want


def test_fleet_equals_sequential_ingraph(fleet_run):
    _, _, port = fleet_run
    rows = port["rows"]
    assert rows["fleet_4"]["n_aggregations"] == \
        rows["sequential_ingraph_4"]["n_aggregations"] > 0
    assert rows["fleet_4"]["speedup_vs_sequential_ingraph"] == \
        pytest.approx(rows["fleet_4"]["tenants_per_sec"]
                      / rows["sequential_ingraph_4"]["tenants_per_sec"])


def test_fleet_contract_is_checked(monkeypatch):
    real = bench_fleet.bench_fleet

    def off_by_one(*a, **kw):
        row = real(*a, **kw)
        row["n_aggregations"] += 1
        return row
    monkeypatch.setattr(bench_fleet, "bench_fleet", off_by_one)
    args = bench_fleet.parser().parse_args(FLEET + ["--skip-host"])
    with pytest.raises(bench_fleet.FleetContractError, match="fleet_4"):
        bench_fleet.bench(args)


def test_mains_write_the_ports_files(tmp_path, monkeypatch):
    """The defaults are the port's files, never the reference's; ``main``
    writes the report and appends its history entry."""
    el_args = bench_el.parser().parse_args([])
    fleet_args = bench_fleet.parser().parse_args([])
    assert (el_args.out, el_args.history, el_args.device) == (
        "BENCH_torch_el.json", "BENCH_torch_history.jsonl", None)
    assert (fleet_args.out, fleet_args.history) == (
        "BENCH_torch_fleet.json", "BENCH_torch_history.jsonl")
    assert el_args.devices == fleet_args.devices == 4
    monkeypatch.chdir(tmp_path)
    bench_fleet.main(FLEET[:-1] + ["--skip-host"])
    hist = [json.loads(line)
            for line in open(tmp_path / "BENCH_torch_history.jsonl")]
    assert [h["kind"] for h in hist] == ["fleet"]
    assert sorted(json.load(open(tmp_path / "BENCH_torch_fleet.json"))
                  ["rows"]) == ["fleet_4", "sequential_ingraph_4"]
    assert not (tmp_path / "BENCH_fleet.json").exists()


def _reference_default(script, flag="--devices"):
    """``flag``'s default in one of the reference's ``scripts/`` (read from
    its source: importing it would force host devices)."""
    import re
    with open(os.path.join(ROOT, "scripts", script)) as f:
        found = re.search(r'"%s", type=int, default=(\d+)' % flag, f.read())
    return int(found.group(1))


def test_devices_sizes_the_sharded_world(monkeypatch):
    """``--devices``, the reference's flag with its default (4): the
    sharded tiers' world has that many gloo ranks on ``make_debug_mesh_for
    (devices)``, ``(devices // 2, 2)``; at 2 a (1, 2) (data, model) mesh,
    and ``meta`` records 2 devices and 2 ranks.  One real world of 2 ranks
    builds the mesh; the tiers, in the ranks and here, are stubbed (the
    full run at 4 ranks is ``el_run``'s)."""
    for script in ("bench_el.py", "bench_fleet.py"):
        assert _reference_default(script) == 4
    assert bench_el.parser().parse_args([]).devices == 4
    assert bench_fleet.parser().parse_args(["--devices", "2"]).devices == 2
    args = bench_el.parser().parse_args(SMOKE + ["--devices", "2"])
    stub = ("def bench_compiled(*a, mesh=None, **kw):\n"
            "    return {'n_aggregations': 1, 'us_per_aggregation': 1.0,\n"
            "            'wall_us': 1.0, 'peak_live_bytes': None,\n"
            "            'mesh': None if mesh is None else dict(mesh.shape)}\n")
    namespace = {}
    exec(stub, namespace)
    monkeypatch.setattr(bench_el, "bench_compiled",
                        namespace["bench_compiled"])
    monkeypatch.setattr(bench_el, "bench_host",
                        lambda *a, **kw: namespace["bench_compiled"]())
    worlds = []
    real_spawn = bench_el.spawn_ranks
    rank = ("import sys\nfrom repro_torch.bench import bench_el\n" + stub
            + "bench_el.bench_compiled = bench_compiled\n"
            "bench_el.main(sys.argv[1:])\n")

    def spawn(n, cmd, **kw):
        assert cmd[1:3] == ["-m", "repro_torch.bench.bench_el"]
        worlds.append(n)
        return real_spawn(n, [cmd[0], "-c", rank, *cmd[3:]], **kw)
    monkeypatch.setattr(bench_el, "spawn_ranks", spawn)
    report = bench_el.bench(args)
    meta = report["meta"]
    assert worlds == [2]
    assert meta["devices"] == meta["ranks"]["count"] == 2
    assert meta["mesh"] == {"data": 1, "model": 2}
    assert "2 gloo ranks on a 1 x 2 (data, model) mesh" in meta["note"]
    sharded = sorted(n for n in REF_ROWS if "sharded" in n)
    assert meta["ranks"]["rows"] == sharded
    for name in sharded:
        assert report["rows"][name]["mesh"] == {"data": 1, "model": 2}
