"""The port's fleet server (``repro_torch.el.fleet``, ``launch/fleet.py``)
on the CPU.

Tenants go through a ``FleetServer`` of three slots, five of them, so two
are admitted mid-flight as slots free up.  Each tenant draws from a
``ReplayDraws`` of the reference's ``jax.random.key(seed + 17)`` stream
(the solo parity tests' helpers), so every tenant must make the decisions
of the reference's solo ``run_sync_ingraph`` / ``run_async_ingraph`` —
intervals, event edges, arm pulls, rounds, termination, ``consumed`` /
``wall`` bit-equal at fixed cost — and equal the port's own solo run on
the same draws field for field and bit for bit.  The reference's own
fleet is not the yardstick: its refill tests fail on this tree (ROADMAP
Queue 3).
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_events import jax_event_draws  # noqa: E402
from test_torch_ingraph import jax_round_draws  # noqa: E402

from repro.el import ELSession as JaxSession  # noqa: E402
from repro.el import scenarios as jscn  # noqa: E402
from repro.launch.classic import classic_fixture as jax_fixture  # noqa: E402
from repro_torch.el import (ELSession, FleetServer, ReportReady,  # noqa: E402
                            RoundDelta, TenantRun)
from repro_torch.el import scenarios as tscn  # noqa: E402
from repro_torch.el.events import padded_event_horizon  # noqa: E402
from repro_torch.el.rng import ReplayDraws  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.classic import classic_fixture  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

SAMPLES, EDGES, SLOTS, HORIZON = 1000, 3, 3, 64
# five tenants through three slots: two wait for a slot to free up
TENANTS = [dict(ucb_c=1.0, budget=900.0, seed=0),
           dict(ucb_c=2.0, budget=1300.0, seed=3),
           dict(ucb_c=0.5, budget=700.0, seed=1),
           dict(ucb_c=2.0, budget=1100.0, seed=2),
           dict(ucb_c=1.0, budget=1000.0, seed=4)]

pytestmark = pytest.mark.filterwarnings("error:.*performance drop")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The device loops are hundreds of small ops a step; on a CPU that
    other test processes load, torch's OpenMP pool spin-waits between
    them.  One intra-op thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixtures():
    out = {}
    for arch, impl in (("svm-wafer", "jnp"), ("kmeans-traffic", "jnp"),
                       ("kmeans-traffic", "pallas")):
        out[arch, impl] = (
            jax_fixture(arch, samples=SAMPLES, n_edges=EDGES,
                        kmeans_impl=impl),
            classic_fixture(arch, samples=SAMPLES, n_edges=EDGES,
                            device="cpu"))
    return out


def _scenario(pkg):
    """Churn and Pareto straggler spikes (periods 16 and 8)."""
    return pkg.ScenarioSpec(churn=pkg.ChurnSpec(rate=0.3, period=16),
                            cost=pkg.CostSpec(kind="pareto", alpha=2.0,
                                              period=8))


def _base(fx, mode, scenario=None):
    return dataclasses.replace(fx["exp"].ol4el, mode=mode, n_edges=EDGES,
                               utility=fx["utility"], heterogeneity=2.0,
                               scenario=scenario)


def _draws(cfg, batch):
    """The reference's draws for ``cfg``'s run key over its horizon,
    replayed."""
    if cfg.mode == "sync":
        return ReplayDraws(*jax_round_draws(
            cfg.seed + 17, HORIZON, cfg.max_interval, EDGES,
            cfg.max_interval, batch))
    return jax_event_draws(cfg.seed + 17, padded_event_horizon(cfg), EDGES,
                           cfg.max_interval, cfg.max_interval, batch)


def _init(jf):
    return params_from_numpy(jax.tree.map(np.asarray, jf["init_params"]),
                             "cpu")


def _run(tf, cfg, init, tenant_id=None, draws=None, priority=0):
    return TenantRun(cfg=cfg, executor=tf["executor"], tenant_id=tenant_id,
                     priority=priority, metric_name=tf["metric"],
                     n_samples=tf["n_samples"], init_params=init,
                     max_rounds=HORIZON, draws=draws)


def _session(tf, cfg, init):
    return (ELSession(cfg, metric_name=tf["metric"], lr=tf["lr"])
            .with_executor(tf["executor"], init_params=init,
                           n_samples=tf["n_samples"]
                           if cfg.mode == "sync" else None))


def _solo(sess, cfg, draws=None):
    """A solo run of ``cfg`` on ``sess`` (either package's session; the
    reference's draws from its own key, ``seed + 17``)."""
    sess.cfg = cfg
    kw = {} if draws is None else {"draws": draws}
    if cfg.mode == "sync":
        return sess.run_sync_ingraph(max_rounds=HORIZON, **kw)
    return sess.run_async_ingraph(**kw)


def _records(rep):
    return np.array([dataclasses.astuple(r) for r in rep.records])


def assert_same_report(got, want):
    """Field for field, bit for bit (NaN metrics included)."""
    assert got.n_aggregations == want.n_aggregations
    assert got.total_consumed == want.total_consumed
    assert got.wall_time == want.wall_time
    assert got.terminated_reason == want.terminated_reason
    assert got.arm_pulls == want.arm_pulls
    assert got.policy == want.policy and got.mode == want.mode
    assert np.array_equal(_records(got), _records(want), equal_nan=True)
    assert got.final_metric == want.final_metric or (
        np.isnan(got.final_metric) and np.isnan(want.final_metric))
    assert got.raw.keys() == want.raw.keys()
    for k, v in want.raw.items():
        a, b = np.asarray(got.raw[k]), np.asarray(v)
        assert a.dtype == b.dtype and np.array_equal(
            a, b, equal_nan=a.dtype.kind == "f"), k
    for k, v in want.final_params.items():
        assert torch.equal(got.final_params[k], v), k


def assert_reference_decisions(got, ref):
    """The reference solo run's decisions; ``consumed`` / ``wall``
    bit-equal at fixed cost."""
    assert got.n_aggregations == ref.n_aggregations > 3
    for f in ("interval", "edge", "total_consumed", "wall_time"):
        assert [getattr(r, f) for r in got.records] == \
            [getattr(r, f) for r in ref.records], f
    assert got.arm_pulls == ref.arm_pulls
    assert got.terminated_reason == ref.terminated_reason
    assert got.total_consumed == ref.total_consumed


def _drain(server, runs):
    """Submit and drain under a private tracer: the tenant ids, the
    reports, the streamed events and the trace records."""
    events = []
    server.subscribe(events.append)
    prev = trace.use_tracer(trace.Tracer())
    try:
        ids = [server.submit(r) for r in runs]
        reports = server.drain()
        spans = trace.get_tracer().events()
    finally:
        trace.use_tracer(prev)
    return ids, reports, events, spans


def assert_streams(ids, reports, events):
    """Every tenant's deltas accumulate to its report's records, and its
    ``ReportReady`` follows its last delta."""
    for tid in ids:
        mine = [e for e in events if e.tenant_id == tid]
        assert isinstance(mine[-1], ReportReady)
        assert mine[-1].report is reports[tid]
        deltas = [e.record for e in mine[:-1]]
        assert all(isinstance(e, RoundDelta) for e in mine[:-1])
        assert np.array_equal(
            np.array([dataclasses.astuple(r) for r in deltas]),
            _records(reports[tid]), equal_nan=True)


def assert_waves(server, spans, n_tenants):
    """Admits and finalizes batched a wave, every tenant refilled once,
    some of them mid-flight."""
    st = server.stats()
    assert 1 <= st["place_dispatches"] <= st["waves"]
    assert 1 <= st["gather_dispatches"] <= st["waves"]
    waves = [e for e in spans if e["name"] == "cohort.wave"]
    assert len(waves) == st["waves"]
    assert len([e for e in spans if e["name"] == "cohort.refill"]) == \
        sum(e["refilled"] for e in waves) == n_tenants
    assert sum(e["completed"] for e in waves) == n_tenants
    assert sum(e["refilled"] for e in waves[1:]) >= n_tenants - SLOTS


CASES = [("svm-wafer", "jnp", "sync"), ("kmeans-traffic", "jnp", "async"),
         ("kmeans-traffic", "pallas", "async")]


@pytest.mark.parametrize("arch,impl,mode", CASES)
def test_fleet_tenants_make_the_reference_solo_decisions(fixtures, arch,
                                                         impl, mode):
    jf, tf = fixtures[arch, impl]
    base = _base(tf, mode)
    cfgs = [dataclasses.replace(base, **t) for t in TENANTS]
    batch = tf["executor"].batch
    draws = [_draws(c, batch) for c in cfgs]
    init = _init(jf)
    server = FleetServer(n_slots=SLOTS, rounds_per_wave=4, device="cpu")
    ids, reports, events, spans = _drain(
        server, [_run(tf, c, init, draws=d) for c, d in zip(cfgs, draws)])
    # the async budgets all pad to one event horizon: one program
    assert server.stats()["compiles"] == 1 and len(reports) == 5
    assert_streams(ids, reports, events)
    assert_waves(server, spans, len(cfgs))
    sess = _session(tf, base, init)
    jsess = (JaxSession(_base(jf, mode), metric_name=jf["metric"],
                        lr=jf["lr"])
             .with_executor(jf["executor"], init_params=jf["init_params"],
                            n_samples=jf["n_samples"]
                            if mode == "sync" else None))
    for tid, cfg, d, t in zip(ids, cfgs, draws, TENANTS):
        got = reports[tid]
        # the port's solo run on the same draws, bit for bit
        assert_same_report(got, _solo(sess, cfg, d))
        # the reference's solo run on the same jax.random stream
        ref = _solo(jsess, dataclasses.replace(_base(jf, mode), **t))
        assert_reference_decisions(got, ref)
        if mode == "async":
            assert int(got.raw["n_active"]) == 0
    server.close()


def test_fleet_scenario_tenants_make_the_reference_solo_decisions(fixtures):
    jf, tf = fixtures["svm-wafer", "jnp"]
    policies = ("ol4el", "task_alloc", "ol4el", "task_alloc", "ol4el")
    base = _base(tf, "sync", _scenario(tscn))
    # twice the budgets: the baselines pick long intervals
    tenants = [dict(t, budget=2 * t["budget"]) for t in TENANTS]
    cfgs = [dataclasses.replace(base, policy=p, **t)
            for p, t in zip(policies, tenants)]
    batch = tf["executor"].batch
    draws = [_draws(c, batch) for c in cfgs]
    init = _init(jf)
    server = FleetServer(n_slots=SLOTS, rounds_per_wave=4, device="cpu")
    ids, reports, events, spans = _drain(
        server, [_run(tf, c, init, draws=d) for c, d in zip(cfgs, draws)])
    # the policy and the churn draws are knobs: one program
    assert server.stats()["compiles"] == 1
    assert_streams(ids, reports, events)
    assert_waves(server, spans, len(cfgs))
    sess = _session(tf, base, init)
    jbase = _base(jf, "sync", _scenario(jscn))
    jsess = (JaxSession(jbase, metric_name=jf["metric"], lr=jf["lr"])
             .with_executor(jf["executor"], init_params=jf["init_params"],
                            n_samples=jf["n_samples"]))
    churned = False
    for tid, cfg, d, p, t in zip(ids, cfgs, draws, policies, tenants):
        got = reports[tid]
        assert got.policy == p
        assert_same_report(got, _solo(sess, cfg, d))
        ref = _solo(jsess, dataclasses.replace(jbase, policy=p, **t))
        assert_reference_decisions(got, ref)
        churned |= int(got.raw["active_edges"][:got.n_aggregations].min()) \
            < EDGES
    assert churned
    server.close()


def test_default_draws_equal_the_solo_session_and_a_shared_cache(fixtures):
    """``draws=None`` is the session's default stream (``seed + 17``);
    a server sharing a session's cache builds one program per structure,
    and a second server on that cache reuses it (the cohort's static
    buffers re-adopted) with the same reports, bit for bit."""
    jf, tf = fixtures["kmeans-traffic", "jnp"]
    init = _init(jf)
    cfgs = [dataclasses.replace(_base(tf, mode), **t)
            for mode in ("sync", "async") for t in TENANTS[:4]]
    sess = _session(tf, cfgs[0], init)
    runs = [_run(tf, c, init, tenant_id=f"t{i}")
            for i, c in enumerate(cfgs)]
    first = FleetServer(n_slots=SLOTS, rounds_per_wave=8, device="cpu",
                        cache=sess.compile_cache)
    _, reports, _, spans = _drain(first, runs)
    st = first.stats()
    assert st["compiles"] == st["cohorts"] == 2
    assert st["cache_misses"] == 2 and st["cache_hits"] == 0
    assert len([e for e in spans if e["name"] == "fleet.compile"]) == 2
    for i, cfg in enumerate(cfgs):
        assert_same_report(reports[f"t{i}"], _solo(sess, cfg))
    # the session's solo programs joined the same cache
    assert len(sess.compile_cache) == 4
    first.close()                       # the session owns the cache
    assert len(sess.compile_cache) == 4
    hits = sess.compile_cache.hits
    second = FleetServer(n_slots=SLOTS, rounds_per_wave=8, device="cpu",
                         cache=sess.compile_cache)
    _, again, _, spans = _drain(second, runs)
    assert second.stats()["compiles"] == 0
    assert sess.compile_cache.hits == hits + 2
    assert not [e for e in spans if e["name"] == "fleet.compile"]
    assert len([e for e in spans if e["name"] == "cache.hit"]) == 2
    assert_waves(second, spans, len(runs))
    for tid, rep in reports.items():
        assert_same_report(again[tid], rep)


def test_a_batch_serves_one_live_cohort_at_a_time(fixtures):
    _, tf = fixtures["svm-wafer", "jnp"]
    cfg = dataclasses.replace(_base(tf, "sync"), **TENANTS[1])
    sess = _session(tf, cfg, None)
    a = FleetServer(n_slots=2, rounds_per_wave=4, device="cpu",
                    cache=sess.compile_cache)
    b = FleetServer(n_slots=2, rounds_per_wave=4, device="cpu",
                    cache=sess.compile_cache)
    a.submit(_run(tf, cfg, None))
    b.submit(_run(tf, cfg, None))
    a.step()                                  # a's tenant is mid-run
    with pytest.raises(RuntimeError, match="another server"):
        b.step()
    a.drain()
    assert len(b.drain()) == 1                # a is idle: b takes over


def test_priority_admits_first_fifo_within(fixtures):
    _, tf = fixtures["svm-wafer", "jnp"]
    base = _base(tf, "sync")
    server = FleetServer(n_slots=1, rounds_per_wave=16, device="cpu")
    order = []
    server.subscribe(lambda e: isinstance(e, ReportReady)
                     and order.append(e.tenant_id))
    for name, prio in (("low-a", 0), ("high", 2), ("low-b", 0),
                       ("mid", 1)):
        server.submit(_run(tf, dataclasses.replace(base, **TENANTS[0]),
                           None, tenant_id=name, priority=prio))
    server.drain()
    assert order == ["high", "mid", "low-a", "low-b"]


def test_close_refuses_new_work_and_keeps_reports(fixtures):
    _, tf = fixtures["svm-wafer", "jnp"]
    cfg = dataclasses.replace(_base(tf, "sync"), **TENANTS[2])
    server = FleetServer(n_slots=2, rounds_per_wave=16, device="cpu")
    tid = server.submit(_run(tf, cfg, None, tenant_id="keep"))
    with pytest.raises(ValueError, match="duplicate tenant_id"):
        server.submit(_run(tf, cfg, None, tenant_id="keep"))
    rep = server.drain()[tid]
    with pytest.raises(ValueError, match="duplicate tenant_id"):
        server.submit(_run(tf, cfg, None, tenant_id="keep"))
    server.close()
    server.close()                             # idempotent
    assert server.report(tid) is rep and rep.n_aggregations > 0
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(_run(tf, cfg, None, tenant_id="late"))
    with pytest.raises(RuntimeError, match="closed"):
        server.step()


def test_unported_options_and_devices_raise(fixtures, monkeypatch):
    _, tf = fixtures["svm-wafer", "jnp"]
    from repro_torch.obs.rings import TelemetrySpec
    for kw, item in (({"mesh": "a world of one"}, "item 14"),
                     ({"telemetry": True}, "item 12"),
                     ({"telemetry": 16}, "item 12"),
                     ({"profile": True}, "item 12")):
        if item == "item 14":
            # a server over a mesh of one rank (this process) delivers the
            # unsharded server's report (the 2- and 4-rank cohorts are
            # tests/test_torch_mesh_events.py's)
            import torch.distributed as dist
            from repro_torch.launch.mesh import make_mesh
            cfg = dataclasses.replace(_base(tf, "sync"), budget=600.0)
            reps = []
            for mesh in ("one", None):
                if mesh:
                    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
                try:
                    server = FleetServer(device="cpu", n_slots=2, mesh=mesh)
                    tid = server.submit(_run(tf, cfg, None))
                    reps.append(server.drain()[tid])
                    assert server.mesh is mesh
                finally:
                    if mesh:
                        dist.destroy_process_group()
            assert [r.interval for r in reps[0].records] == \
                [r.interval for r in reps[1].records]
            assert all(torch.equal(reps[0].final_params[k], v)
                       for k, v in reps[1].final_params.items())
            continue
        # the rings and profiles are ported: the gates arm, as the
        # reference's server arms them
        server = FleetServer(device="cpu", **kw)
        if "telemetry" in kw:
            assert server.telemetry == TelemetrySpec(
                16 if kw["telemetry"] == 16 else 128)
        else:
            assert server.profile and server.telemetry is None
    assert FleetServer(device="cpu", telemetry=False).telemetry is None
    monkeypatch.setenv("REPRO_EL_PROFILE", "1")
    assert FleetServer(device="cpu").profile
    monkeypatch.delenv("REPRO_EL_PROFILE")
    with pytest.raises(ValueError, match="n_slots"):
        FleetServer(n_slots=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FleetServer()
    from repro_torch.launch import fleet as launch_fleet
    with pytest.raises(RuntimeError, match='device="cpu"'):
        launch_fleet.main(["--demo"])
    # the tenant's executor must live on the server's device
    server = FleetServer(device="meta")
    with pytest.raises(ValueError, match="lives on cpu"):
        server.submit(_run(tf, _base(tf, "sync"), None))


def test_launcher_demo_serves_eight_tenants(capsys, tmp_path):
    from repro_torch.launch import fleet as launch_fleet
    reports = launch_fleet.main(["--demo", "--device", "cpu",
                                 "--assert-compiles", "2"])
    assert len(reports) == 8
    assert {r.mode for r in reports.values()} == {"sync", "async"}
    assert all(r.terminated_reason == "budget_exhausted"
               for r in reports.values())
    out = capsys.readouterr().out
    assert "8/8 reports" in out and "2 compiles" in out
    with pytest.raises(SystemExit):
        launch_fleet.main(["--demo", "--device", "cpu",
                           "--assert-compiles", "3", "--samples", "256"])
    # --mesh debug in a rank of a launched world of one (this process):
    # served over its mesh, nothing spawned
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WORLD_SIZE", "1")
        mp.setenv("RANK", "0")
        got = launch_fleet.main(["--demo", "--device", "cpu", "--samples",
                                 "256", "--mesh", "debug",
                                 "--assert-compiles", "2"])
    assert len(got) == 8
    assert "(gloo, 1 ranks)" in capsys.readouterr().out
    manifest = tmp_path / "m.json"
    manifest.write_text('{"tenants": [{"arch": "svm-wafer", "budget": 600,'
                        ' "tenant_id": "only"}]}')
    got = launch_fleet.main(["--manifest", str(manifest), "--device", "cpu",
                             "--samples", "256", "--verbose"])
    assert list(got) == ["only"]
    assert "[only] agg 1" in capsys.readouterr().out
    # --telemetry records the tenant's rings; its decisions are unchanged
    ringed = launch_fleet.main(["--manifest", str(manifest), "--device",
                                "cpu", "--samples", "256", "--telemetry"])
    rings = ringed["only"].telemetry["rings"]
    assert int(rings["head"]) == ringed["only"].n_aggregations
    assert ringed["only"].records == got["only"].records
