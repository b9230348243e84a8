"""The port's device telemetry rings (``repro_torch.obs.rings``) vs the
reference's (``repro.obs.rings``), on the CPU.

Tier: the rings are held to the reference's bit for bit.  The port runs
each compiled path on the reference's ``jax.random`` draws, replayed
through the RNG seam (``jax_round_draws`` / ``jax_event_draws``), and its
unrolled rings must equal the reference's field for field, wraparound
included (rings of 4 and 8 slots, runs of tens of rounds): the sync
round, the sync scenario round, the async engine at K = 1 and in waves of
K = 4, the async scenario body, a sweep's cells and ``CellBatch`` slots.
On svm-wafer (eval-gain utility) every field is bit-equal; on
kmeans-traffic the param-delta utility is the reference's to 1e-5 only
(``test_torch_ingraph.py``'s tier), so its ``arm_utility`` sums are held
to that and every other field bit for bit.  At fixed cost the rings also
equal the port's numpy replay oracle bit for bit, and the port's oracle
equals the reference's on the same history.  With telemetry off every
run is the one it was: records, ``consumed`` / ``wall`` and params
bit-equal to the same run with the rings on.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_events import jax_event_draws  # noqa: E402
from test_torch_ingraph import jax_round_draws  # noqa: E402

from repro.el import ELSession as JaxSession  # noqa: E402
from repro.el import SweepSpec as JaxSpec  # noqa: E402
from repro.el import scenarios as jscn  # noqa: E402
from repro.el.events import make_async_program as jax_async_program  # noqa
from repro.launch.classic import classic_fixture as jax_fixture  # noqa: E402
from repro.obs import rings as jax_rings  # noqa: E402
from repro_torch.el import ELSession, FleetServer, TenantRun  # noqa: E402
from repro_torch.el import events, ingraph  # noqa: E402
from repro_torch.el import scenarios as tscn  # noqa: E402
from repro_torch.el.rng import ReplayDraws  # noqa: E402
from repro_torch.el.sweep import SweepSpec, make_cell_batch  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.classic import classic_fixture  # noqa: E402
from repro_torch.obs import rings  # noqa: E402

SAMPLES, EDGES, ROUNDS = 1200, 4, 64

pytestmark = pytest.mark.filterwarnings("error:.*performance drop")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The device loops are hundreds of small ops a step; one intra-op
    thread keeps torch's OpenMP pool from spin-waiting between them on a
    loaded CPU.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixtures():
    return {arch: (jax_fixture(arch, samples=SAMPLES, n_edges=EDGES),
                   classic_fixture(arch, samples=SAMPLES, n_edges=EDGES,
                                   device="cpu"))
            for arch in ("svm-wafer", "kmeans-traffic")}


def _cfg(fx, mode, pkg=None, **kw):
    kw = {"budget": 1500.0 if mode == "sync" else 900.0, **kw}
    if pkg is not None:
        kw["scenario"] = pkg.ScenarioSpec(
            churn=pkg.ChurnSpec(rate=0.3, period=16),
            cost=pkg.CostSpec(kind="pareto", alpha=2.0, period=8),
            drift=0.05)
    return dataclasses.replace(fx["exp"].ol4el, mode=mode, n_edges=EDGES,
                               utility=fx["utility"], heterogeneity=2.0,
                               **kw)


def _init(jf):
    return params_from_numpy(jax.tree.map(np.asarray, jf["init_params"]),
                             "cpu")


def _jax_session(jf, cfg):
    return (JaxSession(cfg, metric_name=jf["metric"], lr=jf["lr"])
            .with_executor(jf["executor"], init_params=jf["init_params"],
                           n_samples=jf["n_samples"]
                           if cfg.mode == "sync" else None))


def _session(tf, cfg, init):
    return (ELSession(cfg, metric_name=tf["metric"], lr=tf["lr"])
            .with_executor(tf["executor"], init_params=init,
                           n_samples=tf["n_samples"]
                           if cfg.mode == "sync" else None))


def _draws(cfg, batch, horizon):
    """The reference's draws of ``cfg``'s solo run (``seed + 17``)."""
    if cfg.mode == "sync":
        return ReplayDraws(*jax_round_draws(
            cfg.seed + 17, horizon, cfg.max_interval, EDGES,
            cfg.max_interval, batch))
    return jax_event_draws(cfg.seed + 17, horizon, EDGES, cfg.max_interval,
                           cfg.max_interval, batch)


def _assert_rings_equal(got, want, arch, msg=""):
    """``got`` / ``want``: ``out["telemetry"]`` dicts (one run's).  Every
    unrolled field bit for bit; kmeans-traffic's ``arm_utility`` sums of
    the param-delta utility to the utilities' 1e-5."""
    assert int(got["head"]) == int(want["head"]) > 0, msg
    assert int(got["ring_size"]) == int(want["ring_size"]), msg
    g, w = rings.unroll_ring(got), jax_rings.unroll_ring(want)
    assert g.keys() == w.keys(), msg
    for k in w:
        assert g[k].dtype == w[k].dtype, (msg, k)
        if arch == "kmeans-traffic" and k == "arm_utility":
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-5,
                                       err_msg=f"{msg} {k}")
        else:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{msg} {k}")


def _assert_same_run(a, b):
    """Two reports of one run: records (NaN metrics equal), scalars and
    params bit for bit."""
    rows_a = np.array([dataclasses.astuple(r) for r in a.records])
    rows_b = np.array([dataclasses.astuple(r) for r in b.records])
    np.testing.assert_array_equal(rows_a, rows_b)
    assert (a.n_aggregations, a.arm_pulls, a.terminated_reason) == \
        (b.n_aggregations, b.arm_pulls, b.terminated_reason)
    assert np.float32(a.total_consumed) == np.float32(b.total_consumed)
    assert np.float32(a.wall_time) == np.float32(b.wall_time)
    for k, v in a.final_params.items():
        assert torch.equal(v, b.final_params[k]), k


def _assert_oracle(out, cfg):
    """At fixed cost the rings equal the port's numpy replay oracle bit
    for bit."""
    knobs = (ingraph.sync_knobs(cfg) if cfg.mode == "sync"
             else events.async_knobs(cfg))
    dev = rings.unroll_ring(out["telemetry"])
    if cfg.mode == "sync":
        ref = rings.sync_reference_telemetry(out, knobs, cfg.max_interval)
    else:
        ref = rings.async_reference_telemetry(out, knobs, cfg.n_edges,
                                              cfg.max_interval)
    for k in ref:
        np.testing.assert_array_equal(dev[k], ref[k], err_msg=k)


# -- the host half ---------------------------------------------------------------


@pytest.mark.parametrize("value", [None, False, True, 16, 1, "spec"])
def test_as_spec_matches_reference(value):
    mine = rings.TelemetrySpec(4) if value == "spec" else value
    ref = jax_rings.TelemetrySpec(4) if value == "spec" else value
    got, want = rings.as_spec(mine), jax_rings.as_spec(ref)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.ring_size == want.ring_size
        assert hash(got) == hash(rings.TelemetrySpec(got.ring_size))
    if value == "spec":
        assert got is mine
    assert rings.DEFAULT_RING == jax_rings.DEFAULT_RING


def test_as_spec_refusals_are_the_references():
    for pkg in (rings, jax_rings):
        with pytest.raises(ValueError, match="ring_size must be >= 1"):
            pkg.TelemetrySpec(ring_size=0)
    with pytest.raises(TypeError) as got:
        rings.as_spec("on")
    with pytest.raises(TypeError) as want:
        jax_rings.as_spec("on")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("head,size", [(3, 8), (5, 3), (0, 4), (12, 4),
                                       (8, 8), (9, 1)])
def test_ring_order_and_unroll_match_reference(head, size):
    assert rings.ring_order(head, size) == jax_rings.ring_order(head, size)
    rng = np.random.default_rng(head * 10 + size)
    tele = {"arm": rng.integers(-1, 5, size).astype(np.int32),
            "cost": rng.standard_normal(size).astype(np.float32),
            "arm_counts": rng.integers(0, 9, (size, 3)).astype(np.int32),
            "head": np.int32(head), "ring_size": np.int32(size)}
    got, want = rings.unroll_ring(tele), jax_rings.unroll_ring(tele)
    assert got.keys() == want.keys() == {"arm", "cost", "arm_counts"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert len(got[k]) == min(head, size)


def test_oracles_match_reference(fixtures):
    """The port's replay oracles equal the reference's on one history."""
    _, tf = fixtures["svm-wafer"]
    for mode in ("sync", "async"):
        cfg = _cfg(tf, mode)
        rep = _session(tf, cfg, tf["init_params"])
        rep = (rep.run_sync_ingraph(max_rounds=ROUNDS, telemetry=4)
               if mode == "sync" else rep.run_async_ingraph(telemetry=8))
        out = rep.raw
        if mode == "sync":
            knobs = ingraph.sync_knobs(cfg)
            got = rings.sync_reference_telemetry(out, knobs, 10)
            want = jax_rings.sync_reference_telemetry(out, knobs, 10)
        else:
            knobs = events.async_knobs(cfg)
            got = rings.async_reference_telemetry(out, knobs, EDGES, 10)
            want = jax_rings.async_reference_telemetry(out, knobs, EDGES, 10)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- the device half: every compiled path vs the reference ------------------------


@pytest.mark.parametrize("arch", ["svm-wafer", "kmeans-traffic"])
def test_sync_rings_match_reference(fixtures, arch):
    """Ring 4 < rounds: the ring wraps."""
    jf, tf = fixtures[arch]
    ref = _jax_session(jf, _cfg(jf, "sync")).run_sync_ingraph(
        max_rounds=ROUNDS, telemetry=4)
    cfg = _cfg(tf, "sync")
    sess = _session(tf, cfg, _init(jf))
    batch = tf["executor"].batch
    on = sess.run_sync_ingraph(max_rounds=ROUNDS, telemetry=4,
                               draws=_draws(cfg, batch, ROUNDS))
    off = sess.run_sync_ingraph(max_rounds=ROUNDS,
                                draws=_draws(cfg, batch, ROUNDS))
    assert on.n_aggregations > 4
    _assert_rings_equal(on.telemetry["rings"], ref.telemetry["rings"], arch)
    _assert_oracle(on.raw, cfg)
    _assert_same_run(on, off)
    assert "rings" not in off.telemetry and "telemetry" not in off.raw


@pytest.mark.parametrize("batch_k", [1, 4])
@pytest.mark.parametrize("arch", ["svm-wafer", "kmeans-traffic"])
def test_async_rings_match_reference(fixtures, arch, batch_k):
    """Ring 8 < events (the ring wraps); K = 4 waves land up to four rows
    a step, in their events' slots."""
    jf, tf = fixtures[arch]
    ref = _jax_session(jf, _cfg(jf, "async", async_batch_k=batch_k)) \
        .run_async_ingraph(telemetry=8)
    cfg = _cfg(tf, "async", async_batch_k=batch_k)
    horizon = events.padded_event_horizon(cfg)
    sess = _session(tf, cfg, _init(jf))
    batch = tf["executor"].batch
    on = sess.run_async_ingraph(telemetry=8,
                                draws=_draws(cfg, batch, horizon))
    off = sess.run_async_ingraph(draws=_draws(cfg, batch, horizon))
    assert on.telemetry["device_loop"]["batch_k"] == batch_k
    assert on.n_aggregations > 8
    _assert_rings_equal(on.telemetry["rings"], ref.telemetry["rings"], arch)
    _assert_oracle(on.raw, cfg)
    _assert_same_run(on, off)


def test_sync_scenario_rings_match_reference(fixtures):
    """The scenario round adds active edges, dropouts and rejoins."""
    jf, tf = fixtures["svm-wafer"]
    ref = _jax_session(jf, _cfg(jf, "sync", jscn)).run_sync_ingraph(
        max_rounds=ROUNDS, telemetry=8)
    cfg = _cfg(tf, "sync", tscn)
    sess = _session(tf, cfg, _init(jf))
    batch = tf["executor"].batch
    on = sess.run_sync_ingraph(max_rounds=ROUNDS, telemetry=8,
                               draws=_draws(cfg, batch, ROUNDS))
    off = sess.run_sync_ingraph(max_rounds=ROUNDS,
                                draws=_draws(cfg, batch, ROUNDS))
    got = on.telemetry["rings"]
    assert {"active_edges", "dropouts", "rejoins"} <= set(got)
    _assert_rings_equal(got, ref.telemetry["rings"], "svm-wafer")
    assert rings.unroll_ring(got)["dropouts"].sum() > 0       # churn bit
    _assert_same_run(on, off)


def test_async_scenario_rings_match_reference(fixtures):
    jf, tf = fixtures["svm-wafer"]
    ref = _jax_session(jf, _cfg(jf, "async", jscn)).run_async_ingraph(
        telemetry=8)
    cfg = _cfg(tf, "async", tscn)
    horizon = events.padded_event_horizon(cfg)
    sess = _session(tf, cfg, _init(jf))
    batch = tf["executor"].batch
    on = sess.run_async_ingraph(telemetry=8,
                                draws=_draws(cfg, batch, horizon))
    off = sess.run_async_ingraph(draws=_draws(cfg, batch, horizon))
    got = on.telemetry["rings"]
    _assert_rings_equal(got, ref.telemetry["rings"], "svm-wafer")
    probes = rings.unroll_ring(got)["dropouts"]
    assert probes.any() and (rings.unroll_ring(got)["cost"][probes > 0]
                             == 0).all()
    _assert_same_run(on, off)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_sweep_cell_rings_match_reference(fixtures, mode):
    """Each cell's rings, stacked under ``out["telemetry"]``, equal the
    reference sweep's and the cell's solo run's; the rest of the sweep
    is the telemetry-off sweep's."""
    jf, tf = fixtures["svm-wafer"]
    grid = dict(ucb_c=(1.0, 2.0), seeds=(0, 1))
    cfg = _cfg(tf, mode)
    if mode == "async":
        grid["async_batch_k"] = (1, 4)
        horizon = events.padded_event_horizon(cfg)
    else:
        horizon = ROUNDS
    ref = _jax_session(jf, _cfg(jf, mode)).sweep(
        JaxSpec(max_rounds=horizon, **grid), telemetry=8)
    spec = SweepSpec(max_rounds=horizon, **grid)
    cells = spec.cell_cfgs(cfg)
    batch = tf["executor"].batch
    sess = _session(tf, cfg, _init(jf))
    on = sess.sweep(spec, telemetry=8,
                    draws=[_draws(c, batch, horizon) for c in cells])
    off = sess.sweep(spec, draws=[_draws(c, batch, horizon) for c in cells])
    assert on.out.keys() == off.out.keys() | {"telemetry"}
    for k in off.out:
        np.testing.assert_array_equal(on.out[k], off.out[k], err_msg=k)
    for k, v in off.final_params.items():
        assert torch.equal(on.final_params[k], v), k
    for i, c in enumerate(cells):
        got = {k: v[i] for k, v in on.out["telemetry"].items()}
        want = {k: np.asarray(v)[i] for k, v in ref.out["telemetry"].items()}
        _assert_rings_equal(got, want, "svm-wafer", msg=f"cell {i}")
        solo = _session(tf, c, _init(jf))
        solo = (solo.run_sync_ingraph(max_rounds=horizon, telemetry=8,
                                      draws=_draws(c, batch, horizon))
                if mode == "sync" else
                solo.run_async_ingraph(telemetry=8,
                                       draws=_draws(c, batch, horizon)))
        for k, v in solo.telemetry["rings"].items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{i} {k}")


def _run_slots(cb, tenants, init, batch, horizon):
    """Five tenants through two slots (admitted into freed rows); each
    tenant's ``out`` and the rings its admitted row held before its
    first wave."""
    knobs_of = (ingraph.sync_knobs if tenants[0].mode == "sync"
                else events.async_knobs)
    queue, occupant = list(range(len(tenants))), [None] * cb.n_slots
    rows = [knobs_of(tenants[0])] * cb.n_slots
    stacked, done, fresh = None, {}, {}
    while queue or any(o is not None for o in occupant):
        for slot in range(cb.n_slots):
            if occupant[slot] is None and queue:
                i = queue.pop(0)
                d = _draws(tenants[i], batch, horizon)
                carry = cb.init_slot(init, knobs_of(tenants[i]), d)
                if stacked is None:
                    stacked = cb.broadcast(carry)
                stacked = cb.place(stacked, carry, slot, d)
                fresh[i] = cb.take_slot(stacked, slot).get("telem")
                occupant[slot], rows[slot] = i, knobs_of(tenants[i])
        active = torch.tensor([o is not None for o in occupant])
        stacked, running = cb.step(
            stacked, {k: np.stack([r[k] for r in rows]) for k in rows[0]},
            active)
        for slot, i in enumerate(occupant):
            if i is not None and not bool(running[slot]):
                done[i] = cb.finalize_slot(cb.take_slot(stacked, slot),
                                           rows[slot])[1]
                occupant[slot] = None
    return done, fresh


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_cell_batch_slot_rings_match_reference(fixtures, mode):
    """Tenants admitted into freed slots start with empty rings (never
    the previous tenant's rows) and finish with their solo runs' rings:
    the reference's on the same draws and the port's own solo run's."""
    jf, tf = fixtures["svm-wafer"]
    base = _cfg(tf, mode, async_batch_k=4 if mode == "async" else 0)
    tenants = [dataclasses.replace(base, ucb_c=u, budget=b, seed=s)
               for u, b, s in ((1.0, 900.0, 0), (2.0, 1300.0, 3),
                               (0.5, 700.0, 1), (2.0, 1100.0, 2),
                               (1.0, 1000.0, 4))]
    horizon = ROUNDS if mode == "sync" else events.padded_event_horizon(
        max(tenants, key=lambda c: c.budget))
    ex = tf["executor"]
    cb = make_cell_batch(ex.model, ex.edge_data, ex.eval_set, base,
                         n_slots=2, rounds_per_wave=4, lr=ex.lr,
                         batch=ex.batch, n_samples=tf["n_samples"],
                         horizon=horizon, telemetry=8, device="cpu")
    done, fresh = _run_slots(cb, tenants, _init(jf), ex.batch, horizon)
    assert sorted(done) == list(range(len(tenants)))
    # the same tenants through an unringed batch: the same runs
    plain = make_cell_batch(ex.model, ex.edge_data, ex.eval_set, base,
                            n_slots=2, rounds_per_wave=4, lr=ex.lr,
                            batch=ex.batch, n_samples=tf["n_samples"],
                            horizon=horizon, device="cpu")
    done_off, _ = _run_slots(plain, tenants, _init(jf), ex.batch, horizon)
    for i in done:
        assert done[i].keys() == done_off[i].keys() | {"telemetry"}
        for k, v in done_off[i].items():
            np.testing.assert_array_equal(done[i][k], v, err_msg=k)
    jsess = _jax_session(jf, _cfg(jf, mode))
    for i, c in enumerate(tenants):
        assert (fresh[i]["arm_counts"] == 0).all()
        assert (fresh[i]["ints" if mode == "async" else "arm"] == -1).all()
        jsess.cfg = dataclasses.replace(
            jsess.cfg, ucb_c=c.ucb_c, budget=c.budget, seed=c.seed,
            async_batch_k=c.async_batch_k)
        ref = (jsess.run_sync_ingraph(max_rounds=horizon, telemetry=8)
               if mode == "sync" else
               jsess.run_async_ingraph(telemetry=8))
        _assert_rings_equal(done[i]["telemetry"], ref.telemetry["rings"],
                            "svm-wafer", msg=f"tenant {i}")


def test_fleet_tenant_rings_equal_solo_runs(fixtures):
    """A ringed ``FleetServer``: every tenant's report carries its own
    rings, equal to its solo run's; the tenants' runs are the unringed
    server's."""
    _, tf = fixtures["svm-wafer"]
    runs = [TenantRun(cfg=_cfg(tf, "sync", budget=b, seed=s),
                      executor=tf["executor"], tenant_id=f"t{s}",
                      metric_name=tf["metric"], n_samples=tf["n_samples"],
                      init_params=tf["init_params"], max_rounds=ROUNDS)
            for s, b in enumerate((600.0, 900.0, 1200.0))]
    plain = FleetServer(n_slots=2, rounds_per_wave=4, device="cpu")
    ringed = FleetServer(n_slots=2, rounds_per_wave=4, telemetry=8,
                         device="cpu")
    for r in runs:
        plain.submit(dataclasses.replace(r))
        ringed.submit(dataclasses.replace(r))
    a, b = plain.drain(), ringed.drain()
    assert a.keys() == b.keys()
    for r in runs:
        _assert_same_run(a[r.tenant_id], b[r.tenant_id])
        solo = _session(tf, r.cfg, tf["init_params"]).run_sync_ingraph(
            max_rounds=ROUNDS, telemetry=8)
        got = b[r.tenant_id].telemetry["rings"]
        for k, v in solo.telemetry["rings"].items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    plain.close(), ringed.close()


def test_wave_wider_than_the_ring_raises_as_reference(fixtures):
    jf, tf = fixtures["svm-wafer"]
    cfg = _cfg(tf, "async")
    ex, jex = tf["executor"], jf["executor"]
    with pytest.raises(ValueError) as got:
        events.make_async_program(ex.model, ex.edge_data, ex.eval_set, cfg,
                                  lr=ex.lr, batch=ex.batch, telemetry=2,
                                  batch_k=3, device="cpu")
    with pytest.raises(ValueError) as want:
        jax_async_program(jex.model, jex.edge_data, jex.eval_set,
                          _cfg(jf, "async"), lr=jex.lr, batch=jex.batch,
                          telemetry=2, batch_k=3)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="exceeds the telemetry ring"):
        _session(tf, dataclasses.replace(cfg, async_batch_k=4),
                 tf["init_params"]).run_async_ingraph(telemetry=3)


def test_registry_ring_series_match_reference(fixtures):
    """``registry_from_report`` folds a ringed report's series (budget
    remaining, cost / alpha / inter-arrival histograms, the scenario
    counts) as the reference's does: the same Prometheus text."""
    from repro.obs import metrics as jax_metrics
    from repro_torch.obs import metrics
    _, tf = fixtures["svm-wafer"]
    for cfg in (_cfg(tf, "sync"), _cfg(tf, "async", tscn)):
        sess = _session(tf, cfg, tf["init_params"])
        rep = (sess.run_sync_ingraph(max_rounds=ROUNDS, telemetry=16)
               if cfg.mode == "sync" else sess.run_async_ingraph(
                   telemetry=16))
        got = metrics.registry_from_report(rep, labels={"arch": "svm"})
        want = jax_metrics.registry_from_report(rep, labels={"arch": "svm"})
        text = got.render_prometheus()
        assert text == want.render_prometheus()
        parsed = metrics.parse_prometheus(text)
        assert parsed["el_round_cost_count"][0]["value"] == \
            min(rep.n_aggregations, 16)
