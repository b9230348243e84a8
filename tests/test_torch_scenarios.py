"""The port's scenario engine (``repro_torch.el.scenarios`` and its hooks
in the compiled sync round, the async engine and the sweep) vs the
reference's (``repro.el.scenarios``), on the CPU.

The numpy parts (specs, schedules, knobs, the replay oracle, the CLI)
must equal the reference's bit for bit, their error messages word for
word.  The device parts are fed the reference's ``jax.random`` draws
(``jax_round_draws`` / ``jax_event_draws``, the solo parity tests'
helpers: a scenario round takes the same keys as a scenario-less one) as
``ReplayDraws``; at fixed cost the port must then make the reference's
decisions — intervals, event edges and probes, arm pulls,
``active_edges``, rounds, termination — with ``consumed`` and ``wall``
bit-equal, under every policy of the switch, with churn, Pareto
straggler spikes and drift all on.  functorch's per-cell fallback
warning ("performance drop") is an error throughout.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_events import jax_event_draws  # noqa: E402
from test_torch_ingraph import jax_round_draws  # noqa: E402

from repro.config import OL4ELConfig as JaxCfg  # noqa: E402
from repro.core import bandit as jax_bandit  # noqa: E402
from repro.el import ELSession as JaxSession  # noqa: E402
from repro.el import SweepSpec as JaxSpec  # noqa: E402
from repro.el import scenarios as jscn  # noqa: E402
from repro.el.events import make_async_program as jax_async_program  # noqa
from repro.el.ingraph import check_ingraph_support as jax_check  # noqa: E402
from repro.el.ingraph import make_sync_program as jax_sync_program  # noqa
from repro.el.scenarios import baselines as jax_baselines  # noqa: E402
from repro.el.scenarios import cli as jax_cli  # noqa: E402
from repro.launch.classic import classic_fixture as jax_fixture  # noqa: E402
from repro_torch.config import OL4ELConfig  # noqa: E402
from repro_torch.el import ELSession  # noqa: E402
from repro_torch.el import events, ingraph  # noqa: E402
from repro_torch.el import scenarios as tscn  # noqa: E402
from repro_torch.el.rng import ReplayDraws  # noqa: E402
from repro_torch.el.scenarios import baselines as t_baselines  # noqa: E402
from repro_torch.el.scenarios import cli as t_cli  # noqa: E402
from repro_torch.el.sweep import SweepSpec  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.classic import classic_fixture  # noqa: E402

SAMPLES, EDGES, BUDGET, ROUNDS = 128, 4, 2500.0, 48
PERF_DROP = ".*performance drop.*"
POLICIES = ("ol4el", "task_alloc", "delay_energy")

pytestmark = pytest.mark.filterwarnings(f"error:{PERF_DROP}")


def _scenario(pkg):
    """Churn, Pareto straggler spikes and drift, all on (periods 16 and 8:
    the schedules repeat inside a run)."""
    return pkg.ScenarioSpec(churn=pkg.ChurnSpec(rate=0.3, period=16),
                            cost=pkg.CostSpec(kind="pareto", alpha=2.0,
                                              period=8),
                            drift=0.05)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module (the device loops are hundreds
    of small ops a step; a loaded CPU's OpenMP pool spin-waits between
    them), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- specs, schedules, knobs --------------------------------------------------


BAD_SPECS = [("ChurnSpec", dict(rate=1.0)), ("ChurnSpec", dict(rate=-0.1)),
             ("ChurnSpec", dict(kind="bogus")), ("ChurnSpec", dict(period=0)),
             ("ChurnSpec", dict(kind="trace")), ("CostSpec", dict(alpha=1.0)),
             ("CostSpec", dict(kind="bogus")), ("CostSpec", dict(sigma=-1.0)),
             ("CostSpec", dict(period=0)), ("CostSpec", dict(kind="trace")),
             ("CostSpec", dict(kind="trace", trace=((1.0, -1.0),))),
             ("ScenarioSpec", dict(drift=-0.1))]


@pytest.mark.parametrize("cls,kw", BAD_SPECS)
def test_spec_validation_messages_are_the_reference(cls, kw):
    with pytest.raises(ValueError) as want:
        getattr(jscn, cls)(**kw)
    with pytest.raises(ValueError) as got:
        getattr(tscn, cls)(**kw)
    assert str(got.value) == str(want.value)


def _specs(pkg):
    return [pkg.ScenarioSpec(),
            _scenario(pkg),
            pkg.ScenarioSpec(churn=pkg.ChurnSpec(period=6),
                             cost=pkg.CostSpec(period=4)),
            pkg.ScenarioSpec(churn=pkg.ChurnSpec(
                kind="trace", trace=((1, 1), (1, 0), (0, 1)))),
            pkg.ScenarioSpec(cost=pkg.CostSpec(kind="lognormal", sigma=0.9,
                                               seed=5), drift=0.02)]


def test_spec_period_structural_and_normalization_are_the_reference():
    for got, want in zip(_specs(tscn), _specs(jscn)):
        assert got.period == want.period
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert dataclasses.asdict(got.structural()) == \
            dataclasses.asdict(want.structural())
    assert tscn.as_scenario(None) is None and tscn.as_scenario(False) is None
    assert tscn.as_scenario(True) == tscn.ScenarioSpec()
    with pytest.raises(TypeError) as want:
        jscn.as_scenario("churn")
    with pytest.raises(TypeError) as got:
        tscn.as_scenario("churn")
    assert str(got.value) == str(want.value)


def _schedule_cases(pkg):
    return {
        "dropout": (pkg.ChurnSpec(rate=0.4, period=12, min_active=2,
                                  seed=3), None),
        "churn-trace": (pkg.ChurnSpec(kind="trace", trace=(
            (1, 0, 1, 0), (0, 0, 0, 0), (1, 1, 1, 1))), None),
        "pareto": (None, pkg.CostSpec(kind="pareto", alpha=1.7, period=8,
                                      seed=2)),
        "lognormal": (None, pkg.CostSpec(kind="lognormal", sigma=0.6,
                                         period=6, seed=4)),
        "cost-trace": (None, pkg.CostSpec(kind="trace", trace=(
            (2.0, 1.0, 1.5, 1.0), (1.0, 3.0, 1.0, 0.5)))),
        "none": (None, None),
    }


@pytest.mark.parametrize("case", list(_schedule_cases(jscn)))
def test_schedules_and_knobs_are_the_reference_bit_for_bit(case):
    churn_t, cost_t = _schedule_cases(tscn)[case]
    churn_j, cost_j = _schedule_cases(jscn)[case]
    for period in (12, 24):
        for got, want in ((tscn.activity_schedule(churn_t, EDGES, period),
                           jscn.activity_schedule(churn_j, EDGES, period)),
                          (tscn.cost_schedule(cost_t, EDGES, period),
                           jscn.cost_schedule(cost_j, EDGES, period))):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    kw = dict(n_edges=EDGES, heterogeneity=3.0, budget=900.0)
    for mode in ("sync", "async"):
        for policy in (POLICIES if mode == "sync" else ("ol4el",)):
            t_cfg = OL4ELConfig(mode=mode, policy=policy, **kw,
                                scenario=tscn.ScenarioSpec(
                                    churn=churn_t, cost=cost_t, drift=0.01))
            j_cfg = JaxCfg(mode=mode, policy=policy, **kw,
                           scenario=jscn.ScenarioSpec(
                               churn=churn_j, cost=cost_j, drift=0.01))
            got = (ingraph.sync_knobs(t_cfg) if mode == "sync"
                   else events.async_knobs(t_cfg))
            want = (jax_ingraph_knobs(j_cfg) if mode == "sync"
                    else jax_async_knobs(j_cfg))
            names = (ingraph.sync_knob_names(t_cfg) if mode == "sync"
                     else events.async_knob_names(t_cfg))
            assert set(got) == set(names) and got.keys() == want.keys()
            for n in want:
                assert np.asarray(got[n]).dtype == np.asarray(want[n]).dtype
                np.testing.assert_array_equal(got[n], want[n])
            assert tscn.scenario_knobs(t_cfg).keys() == \
                jscn.scenario_knobs(j_cfg).keys()


def jax_ingraph_knobs(cfg):
    from repro.el.ingraph import sync_knobs
    return sync_knobs(cfg)


def jax_async_knobs(cfg):
    from repro.el.events.knobs import async_knobs
    return async_knobs(cfg)


def test_knob_names_and_policy_order_are_the_reference():
    from repro.el.events import async_knob_names as jax_async_names
    from repro.el.ingraph import sync_knob_names as jax_sync_names
    from repro_torch.el.sweep import knob_names
    from repro.el.sweep.engine import knob_names as jax_knob_names
    assert tscn.SCENARIO_KNOB_NAMES == jscn.SCENARIO_KNOB_NAMES
    assert t_baselines.INGRAPH_POLICY_ORDER == \
        jax_baselines.INGRAPH_POLICY_ORDER
    for mode in ("sync", "async"):
        assert tscn.scenario_knob_names(mode) == \
            jscn.scenario_knob_names(mode)
        for scn in (False, True):
            assert knob_names(mode, scn) == jax_knob_names(mode, scn)
    for name in POLICIES:
        assert t_baselines.ingraph_policy_id(name) == \
            jax_baselines.ingraph_policy_id(name)
    with pytest.raises(ValueError) as want:
        jax_baselines.ingraph_policy_id("greedy")
    with pytest.raises(ValueError) as got:
        t_baselines.ingraph_policy_id("greedy")
    assert str(got.value) == str(want.value)
    scn_t, scn_j = _scenario(tscn), _scenario(jscn)
    assert ingraph.sync_knob_names(OL4ELConfig(mode="sync", scenario=scn_t)) \
        == jax_sync_names(JaxCfg(mode="sync", scenario=scn_j))
    assert events.async_knob_names(OL4ELConfig(scenario=scn_t)) == \
        jax_async_names(JaxCfg(scenario=scn_j))


# -- the policy switch ------------------------------------------------------------


def _switch_cases():
    """Seeded bandit states over K = 10 arms, residuals from broke to
    rich, and a Gumbel key each."""
    rng = np.random.default_rng(11)
    costs = np.arange(1, 11, dtype=np.float32) * np.float32(17.5) + 50.0
    for i in range(60):
        counts = (rng.integers(0, 2, 10) if i % 4 == 0
                  else rng.integers(1, 7, 10)).astype(np.int32)
        state = {"counts": counts,
                 "utility_sum": (rng.uniform(-0.1, 0.9, 10) * counts
                                 ).astype(np.float32),
                 "cost_sum": (costs * counts).astype(np.float32),
                 "t": np.int32(counts.sum())}
        resid = np.float32(rng.choice([rng.uniform(67.5, 300.0),
                                       rng.uniform(300.0, 5000.0),
                                       costs[int(rng.integers(0, 10))]]))
        yield state, resid, costs, np.float32(rng.choice([0.5, 2.0])), i


@pytest.mark.parametrize("policy", POLICIES)
def test_select_arm_switch_matches_reference(policy):
    pid = t_baselines.ingraph_policy_id(policy)
    switch = jax.jit(jax_baselines.select_arm_switch)
    for state, resid, costs, ucb_c, i in _switch_cases():
        key = jax.random.key(i)
        want = int(switch(jnp.int32(pid),
                          {k: jnp.asarray(v) for k, v in state.items()},
                          jnp.float32(resid), jnp.asarray(costs),
                          jnp.float32(ucb_c), key))
        gumbel = torch.from_numpy(np.array(
            jax.random.gumbel(key, (10,), jnp.float32)))
        got = t_baselines.select_arm_switch(
            torch.tensor(pid, dtype=torch.int32),
            {k: torch.as_tensor(v) for k, v in state.items()},
            torch.tensor(resid), torch.from_numpy(costs),
            torch.tensor(ucb_c), gumbel)
        assert got.shape == () and int(got) == want, (i, resid)
    # under vmap over cells, one policy each: every branch runs, each
    # cell takes its own
    states = [s for s, *_ in list(_switch_cases())[:3]]
    stacked = {k: torch.stack([torch.as_tensor(s[k]) for s in states])
               for k in states[0]}
    costs = torch.from_numpy(np.arange(1, 11, dtype=np.float32) * 17.5 + 50)
    pids = torch.tensor([0, 1, 2], dtype=torch.int32)
    g = torch.zeros(3, 10)
    got = torch.func.vmap(t_baselines.select_arm_switch,
                          in_dims=(0, 0, None, None, None, 0))(
        pids, stacked, torch.tensor(900.0), costs, torch.tensor(2.0), g)
    for c in range(3):
        one = t_baselines.select_arm_switch(
            pids[c], {k: v[c] for k, v in stacked.items()},
            torch.tensor(900.0), costs, torch.tensor(2.0), g[c])
        assert int(got[c]) == int(one)


# -- whole programs against the reference -------------------------------------------


@pytest.fixture(scope="module")
def fixtures():
    out = {}
    for arch, impl in (("svm-wafer", "jnp"), ("kmeans-traffic", "jnp"),
                       ("kmeans-traffic", "pallas")):
        out[arch, impl] = (
            jax_fixture(arch, samples=SAMPLES, n_edges=EDGES, alpha=100.0,
                        data_seed=0, kmeans_impl=impl),
            classic_fixture(arch, samples=SAMPLES, n_edges=EDGES,
                            alpha=100.0, data_seed=0, device="cpu"))
    return out


def _cfg(fx, pkg, mode="sync", policy="ol4el", **kw):
    kw.setdefault("scenario", _scenario(pkg))
    kw.setdefault("budget", BUDGET)
    return dataclasses.replace(fx["exp"].ol4el, mode=mode, n_edges=EDGES,
                               utility=fx["utility"], heterogeneity=2.0,
                               policy=policy, **kw)


def _init(jf):
    return params_from_numpy(jax.tree.map(np.asarray, jf["init_params"]),
                             "cpu")


def _session(tf, cfg, init):
    return (ELSession(cfg, metric_name=tf["metric"], lr=tf["lr"])
            .with_executor(tf["executor"], init_params=init,
                           n_samples=tf["n_samples"]
                           if cfg.mode == "sync" else None))


@pytest.fixture(scope="module")
def sync_refs(fixtures):
    """The reference's sync scenario outs, one jitted program per fixture
    (the policy is a knob) run under each policy."""
    refs = {}
    for key, (jf, _) in fixtures.items():
        ex = jf["executor"]
        cfg = _cfg(jf, jscn)
        prog = jax.jit(jax_sync_program(
            ex.model, ex.edge_data, ex.eval_set, cfg, lr=ex.lr,
            batch=ex.batch, n_samples=np.asarray(jf["n_samples"],
                                                 np.float64),
            max_rounds=ROUNDS, metric_name=jf["metric"]))
        for policy in POLICIES:
            pcfg = dataclasses.replace(cfg, policy=policy)
            _, out = prog(jf["init_params"], jax.random.key(cfg.seed + 17),
                          jax_ingraph_knobs(pcfg))
            refs[key, policy] = (pcfg, jax.tree.map(np.asarray, out))
    return refs


SYNC_CASES = [(a, i, p) for a, i in (("svm-wafer", "jnp"),
                                      ("kmeans-traffic", "jnp"),
                                      ("kmeans-traffic", "pallas"))
              for p in POLICIES]


@pytest.mark.parametrize("arch,impl,policy", SYNC_CASES)
def test_sync_scenario_run_matches_reference(fixtures, sync_refs, arch, impl,
                                             policy):
    jf, tf = fixtures[arch, impl]
    jcfg, want = sync_refs[(arch, impl), policy]
    cfg = _cfg(tf, tscn, policy=policy)
    draws = ReplayDraws(*jax_round_draws(
        cfg.seed + 17, ROUNDS, cfg.max_interval, EDGES, cfg.max_interval,
        tf["executor"].batch))
    rep = _session(tf, cfg, _init(jf)).run_sync_ingraph(max_rounds=ROUNDS,
                                                        draws=draws)
    got, n = rep.raw, int(want["n_rounds"])
    assert int(got["n_rounds"]) == n > 3
    assert got.keys() == want.keys()
    for k in ("interval", "active_edges", "arm_pulls", "consumed", "wall",
              "wall_time", "budgets_left"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # churn bit, and the dead edges kept their budget for those rounds
    assert want["active_edges"][:n].min() < EDGES
    np.testing.assert_allclose(got["utility"], want["utility"], atol=1e-5)
    np.testing.assert_allclose(got["metric"], want["metric"], atol=1e-5)
    assert rep.terminated_reason == ("max_rounds" if n >= ROUNDS
                                     else "budget_exhausted")
    assert rep.policy == policy
    # the port's replay oracle holds the port's own output
    ref = tscn.verify_sync_replay(cfg, got, ROUNDS)
    assert int(ref["n_rounds"]) == n
    for k, v in jscn.replay_sync_scenario(jcfg, want["interval"],
                                          ROUNDS).items():
        np.testing.assert_array_equal(ref[k], v, err_msg=k)


def test_replay_oracle_rejects_noisy_costs_and_a_bad_run():
    cfg = OL4ELConfig(mode="sync", scenario=tscn.ScenarioSpec(
        churn=tscn.ChurnSpec(rate=0.2)), cost_model="variable",
        cost_noise=0.2)
    with pytest.raises(ValueError, match="cost_noise"):
        tscn.verify_sync_replay(cfg, {"interval": np.zeros(4)}, 4)
    cfg = dataclasses.replace(cfg, cost_model="fixed", cost_noise=0.0)
    out = {"interval": np.full(8, 2, np.int32), "n_rounds": np.int32(3)}
    with pytest.raises(AssertionError, match="termination"):
        tscn.verify_sync_replay(cfg, out, 8)
    with pytest.raises(TypeError, match="ScenarioSpec"):
        tscn.replay_sync_scenario(dataclasses.replace(cfg, scenario="x"),
                                  out["interval"], 8)


def _async_out(jf, cfg, horizon):
    ex = jf["executor"]
    prog = jax.jit(jax_async_program(
        ex.model, ex.edge_data, ex.eval_set, cfg, lr=ex.lr, batch=ex.batch,
        max_events=horizon, metric_name=jf["metric"]))
    _, out = prog(jf["init_params"], jax.random.key(cfg.seed + 17),
                  jax_async_knobs(cfg))
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("arch,impl", [("svm-wafer", "jnp"),
                                       ("kmeans-traffic", "pallas")])
def test_async_scenario_run_matches_reference(fixtures, arch, impl):
    jf, tf = fixtures[arch, impl]
    jcfg = _cfg(jf, jscn, mode="async", budget=1200.0)
    cfg = _cfg(tf, tscn, mode="async", budget=1200.0)
    horizon = events.padded_event_horizon(cfg)
    want = _async_out(jf, jcfg, horizon)
    draws = jax_event_draws(cfg.seed + 17, horizon, EDGES, cfg.max_interval,
                            cfg.max_interval, tf["executor"].batch)
    rep = _session(tf, cfg, _init(jf)).run_async_ingraph(draws=draws)
    got, n = rep.raw, int(want["n_rounds"])
    assert int(got["n_rounds"]) == n > 8
    assert got.keys() == want.keys()
    for k in ("edge", "interval", "cost", "active_edges", "arm_pulls",
              "consumed", "wall", "wall_time", "budgets_left", "n_active"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # probes happened: dropped edges popped, charged nothing, pulled nothing
    probes = (want["interval"][:n] == 0)
    assert probes.any() and (want["cost"][:n][probes] == 0).all()
    assert int(want["arm_pulls"].sum()) == n - int(probes.sum())
    np.testing.assert_allclose(got["utility"], want["utility"], atol=1e-6)
    np.testing.assert_allclose(got["metric"], want["metric"], atol=1e-6)
    assert rep.terminated_reason == "budget_exhausted"


def test_host_twin_with_a_scenario_is_the_references(fixtures):
    """The reference's host twin has no scenario branch: with a scenario
    it runs the scenario-less event loop, and so does the port's."""
    jf, tf = fixtures["svm-wafer", "jnp"]
    jcfg = _cfg(jf, jscn, mode="async", budget=800.0)
    cfg = _cfg(tf, tscn, mode="async", budget=800.0)
    horizon = events.default_event_horizon(cfg)
    ref = (JaxSession(jcfg, metric_name=jf["metric"], lr=jf["lr"])
           .with_executor(jf["executor"], init_params=jf["init_params"])
           .run_async(rng_streams="jax"))
    draws = jax_event_draws(cfg.seed + 17, horizon, EDGES, cfg.max_interval,
                            cfg.max_interval, tf["executor"].batch)
    port = _session(tf, cfg, _init(jf)).run_async(rng_streams="jax",
                                                   draws=draws)
    assert port.n_aggregations == ref.n_aggregations > 0
    assert [(r.edge, r.interval, np.float32(r.total_consumed),
             np.float32(r.wall_time)) for r in port.records] == \
        [(r.edge, r.interval, np.float32(r.total_consumed),
          np.float32(r.wall_time)) for r in ref.records]
    assert port.arm_pulls == ref.arm_pulls
    assert port.terminated_reason == ref.terminated_reason


def test_async_scenario_requires_single_event_waves(fixtures):
    jf, tf = fixtures["svm-wafer", "jnp"]
    cfg = _cfg(tf, tscn, mode="async")
    assert events.resolve_async_batch_k(cfg) == 1
    bad = dataclasses.replace(cfg, async_batch_k=4)
    with pytest.raises(ValueError) as got:
        _session(tf, bad, tf["init_params"]).run_async_ingraph()
    with pytest.raises(ValueError) as want:
        (JaxSession(_cfg(jf, jscn, mode="async", async_batch_k=4))
         .with_executor(jf["executor"], init_params=jf["init_params"])
         .run_async_ingraph())
    assert str(got.value) == str(want.value)


def test_dead_edges_run_zero_work_and_are_not_charged(fixtures):
    """An edge the churn trace drops for the whole run keeps its full
    budget and its parameters never enter the aggregate; every round's
    active count is the schedule's."""
    _, tf = fixtures["kmeans-traffic", "jnp"]
    trace = ((1, 1, 1, 0),) * 4                   # edge 3 always out
    cfg = _cfg(tf, tscn, scenario=tscn.ScenarioSpec(
        churn=tscn.ChurnSpec(kind="trace", trace=trace)), budget=600.0)
    rep = _session(tf, cfg, tf["init_params"]).run_sync_ingraph(
        max_rounds=ROUNDS)
    out, n = rep.raw, rep.n_aggregations
    assert n > 0
    np.testing.assert_array_equal(out["active_edges"][:n],
                                  np.full(n, 3, np.int32))
    assert float(out["budgets_left"][3]) == 600.0
    assert (out["budgets_left"][:3] < 600.0).all()
    # an edge with zero weight: the same run with edge 3's data replaced
    ex = tf["executor"]
    swapped = [dict(d) for d in ex.edge_data]
    swapped[3] = {"x": np.zeros_like(swapped[3]["x"]) + 9.0,
                  "y": swapped[3]["y"]}
    ex2 = type(ex)(ex.model, swapped, ex.eval_set, batch=ex.batch,
                   lr=ex.lr, device="cpu")
    rep2 = (ELSession(cfg, metric_name=tf["metric"], lr=tf["lr"])
            .with_executor(ex2, init_params=tf["init_params"],
                           n_samples=tf["n_samples"])
            .run_sync_ingraph(max_rounds=ROUNDS))
    for k in rep.final_params:
        assert torch.equal(rep.final_params[k], rep2.final_params[k])


def test_identity_scenario_keeps_every_edge_active(fixtures, sync_refs):
    jf, tf = fixtures["svm-wafer", "jnp"]
    cfg = _cfg(tf, tscn, scenario=tscn.ScenarioSpec(), budget=600.0)
    rep = _session(tf, cfg, _init(jf)).run_sync_ingraph(max_rounds=ROUNDS)
    n = rep.n_aggregations
    assert n > 0
    np.testing.assert_array_equal(rep.raw["active_edges"][:n],
                                  np.full(n, EDGES, np.int32))
    assert (rep.raw["budgets_left"] < 600.0).all()


# -- the sweep's scenario axes ---------------------------------------------------


SWEEP = dict(policy=POLICIES, churn_rate=(0.0, 0.4), seeds=(0, 2),
             max_rounds=ROUNDS)


@pytest.mark.parametrize("arch,impl", [("svm-wafer", "jnp"),
                                       ("kmeans-traffic", "jnp")])
def test_policy_churn_sweep_matches_reference_and_solo(fixtures, arch, impl):
    jf, tf = fixtures[arch, impl]
    ref = (JaxSession(_cfg(jf, jscn), metric_name=jf["metric"], lr=jf["lr"])
           .with_executor(jf["executor"], init_params=jf["init_params"],
                          n_samples=jf["n_samples"])
           .sweep(JaxSpec(**SWEEP)))
    cfg = _cfg(tf, tscn)
    spec = SweepSpec(**SWEEP)
    cells = spec.cell_cfgs(cfg)
    assert [dataclasses.asdict(c) for c in cells] == \
        [dataclasses.asdict(c) for c in JaxSpec(**SWEEP).cell_cfgs(
            _cfg(jf, jscn))]
    by_seed = {s: ReplayDraws(*jax_round_draws(
        s + 17, ROUNDS, cfg.max_interval, EDGES, cfg.max_interval,
        tf["executor"].batch)) for s in SWEEP["seeds"]}
    draws = [by_seed[c.seed] for c in cells]
    init = _init(jf)
    sess = _session(tf, cfg, init)
    port = sess.sweep(spec, draws=draws)
    assert len(sess._sweep_programs) == 1 and port.n_cells == 12
    assert port.cells == ref.cells
    out, want = port.out, ref.out
    for k in ("n_rounds", "interval", "active_edges", "arm_pulls",
              "consumed", "wall", "wall_time", "budgets_left"):
        np.testing.assert_array_equal(out[k], want[k], err_msg=k)
    np.testing.assert_allclose(out["utility"], want["utility"], atol=1e-5)
    # churn rate 0 keeps the fleet whole; 0.4 drops edges
    for i, c in enumerate(ref.cells):
        act = out["active_edges"][i][:int(out["n_rounds"][i])]
        assert (act == EDGES).all() == (c["churn_rate"] == 0.0)
    # the policies took different allocations
    assert len({tuple(out["interval"][i]) for i in range(0, 12, 4)}) >= 2
    # every cell is its solo program on the same draws, every field
    ex = tf["executor"]
    prog = ingraph.make_sync_program(
        ex.model, ex.edge_data, ex.eval_set, cfg, lr=ex.lr, batch=ex.batch,
        n_samples=tf["n_samples"], max_rounds=ROUNDS, device="cpu")
    for i, ccfg in enumerate(cells):
        params, solo = prog(init, ingraph.sync_knobs(ccfg), draws[i])
        assert solo.keys() == {k for k in out if k != "final_metric_host"}
        for k, v in solo.items():
            assert np.array_equal(out[k][i], v, equal_nan=True), (i, k)
        for k, v in params.items():
            assert torch.equal(port.final_params[k][i], v), (i, k)


def test_async_churn_rate_sweep_equals_solo_runs(fixtures):
    _, tf = fixtures["svm-wafer", "jnp"]
    cfg = _cfg(tf, tscn, mode="async", budget=900.0)
    horizon = events.padded_event_horizon(cfg)
    spec = SweepSpec(churn_rate=(0.1, 0.5), seeds=(0, 1), max_rounds=horizon)
    rep = _session(tf, cfg, tf["init_params"]).sweep(spec)
    assert not rep.truncated().any()
    for i, ccfg in enumerate(spec.cell_cfgs(cfg)):
        solo = _session(tf, ccfg, tf["init_params"]).run_async_ingraph()
        n = solo.n_aggregations
        assert int(rep.out["n_rounds"][i]) == n > 0
        for k in ("edge", "interval", "active_edges", "consumed", "wall"):
            np.testing.assert_array_equal(rep.out[k][i], solo.raw[k])


@pytest.mark.parametrize("kw,cfg_kw", [
    (dict(policy=("ol4el", "task_alloc")), dict(scenario=None)),
    (dict(churn_rate=(0.1,)), dict(scenario="identity")),
])
def test_scenario_axes_need_a_scenario_as_the_reference(kw, cfg_kw):
    def cfg(pkg, base):
        scn = cfg_kw["scenario"]
        return base(mode="sync", scenario=None if scn is None
                    else pkg.ScenarioSpec())
    with pytest.raises(ValueError) as want:
        JaxSpec(**kw).cell_cfgs(cfg(jscn, JaxCfg))
    with pytest.raises(ValueError) as got:
        SweepSpec(**kw).cell_cfgs(cfg(tscn, OL4ELConfig))
    assert str(got.value) == str(want.value)
    for bad in (dict(policy=("bogus",)), dict(churn_rate=(1.0,))):
        with pytest.raises(ValueError) as want:
            JaxSpec(**bad)
        with pytest.raises(ValueError) as got:
            SweepSpec(**bad)
        assert str(got.value) == str(want.value)


# -- the support check, the cache, the CLI and the launchers ---------------------


def _first_line(exc) -> str:
    return str(exc.value).split("\n")[0].replace("repro_torch.", "repro.")


@pytest.mark.parametrize("kw,exc", [
    (dict(scenario="churn"), TypeError),
    (dict(policy="task_alloc", scenario=None), ValueError),
    (dict(mode="async", policy="delay_energy"), ValueError),
    (dict(cost_model="pareto"), ValueError),
    (dict(policy="greedy"), ValueError),
])
def test_support_check_messages_are_the_reference(fixtures, kw, exc):
    jf, tf = fixtures["svm-wafer", "jnp"]

    def cfg(fx, pkg):
        return _cfg(fx, pkg, **kw)
    with pytest.raises(exc) as want:
        jax_check(cfg(jf, jscn), jf["executor"])
    with pytest.raises(exc) as got:
        ingraph.check_ingraph_support(cfg(tf, tscn), tf["executor"])
    assert _first_line(got) == _first_line(want)
    assert "supported in-graph matrix" in str(got.value)
    menu = ingraph.support_matrix()
    for token in ("scenario", "ScenarioSpec", "pareto", "lognormal",
                  "trace:<path>", "task_alloc", "delay_energy",
                  "'fixed', 'variable'"):
        assert token in menu, token


def test_nearby_scenario_points_share_one_program(fixtures):
    _, tf = fixtures["svm-wafer", "jnp"]
    key = ELSession._structural_cfg
    a = _cfg(tf, tscn)
    b = _cfg(tf, tscn, policy="task_alloc", seed=4, scenario=tscn.ScenarioSpec(
        churn=tscn.ChurnSpec(rate=0.05, period=16, seed=9),
        cost=tscn.CostSpec(kind="lognormal", sigma=0.3, period=8),
        drift=0.2))
    assert key(a) == key(b)
    assert key(a) != key(_cfg(tf, tscn, scenario=None))
    assert key(a) != key(_cfg(tf, tscn, scenario=tscn.ScenarioSpec(
        churn=tscn.ChurnSpec(period=32))))
    off = _cfg(tf, tscn, scenario=None)
    assert key(off) != key(dataclasses.replace(off, policy="greedy"))
    sess = _session(tf, a, tf["init_params"])
    r1 = sess.run_sync_ingraph(max_rounds=32)
    prog = sess._fastpath
    sess.cfg = b
    r2 = sess.run_sync_ingraph(max_rounds=32)
    assert sess._fastpath is prog
    stats = r2.telemetry["cache"]
    assert (stats["entries"], stats["hits"], stats["misses"]) == (1, 1, 1)
    assert r2.policy == "task_alloc"
    assert r1.raw["interval"].tolist() != r2.raw["interval"].tolist()


def _parse(pkg, argv):
    ap = argparse.ArgumentParser()
    pkg.add_scenario_args(ap)
    return ap.parse_args(argv)


@pytest.mark.parametrize("argv", [
    [], ["--cost-model", "variable"],
    ["--churn", "0.2", "--churn-period", "8", "--cost-model", "pareto",
     "--drift", "0.01"],
    ["--cost-model", "lognormal"], ["--drift", "0.3"],
    ["--churn", "0.1", "--cost-model", "TRACE"],
])
def test_cli_flags_round_trip_to_the_references_spec(tmp_path, argv):
    if "TRACE" in argv:
        p = tmp_path / "times.txt"
        p.write_text("1.0 2.0 1.0 1.5\n2.5 1.0 1.0 1.0\n1.5 1.0 3.0 1.0\n")
        argv = [a.replace("TRACE", f"trace:{p}") for a in argv]
    got_scn, got_base = t_cli.scenario_from_args(_parse(t_cli, argv))
    want_scn, want_base = jax_cli.scenario_from_args(_parse(jax_cli, argv))
    assert got_base == want_base
    assert (got_scn is None) == (want_scn is None)
    if got_scn is not None:
        assert dataclasses.asdict(got_scn) == dataclasses.asdict(want_scn)
    with pytest.raises(SystemExit):
        _parse(t_cli, ["--cost-model", "bogus"])


def test_launchers_take_the_scenario_flags(capsys):
    from repro_torch.launch import sweep as launch_sweep
    from repro_torch.launch import train as launch_train
    launch_sweep.main(["--arch", "svm-wafer", "--policy", "ol4el",
                       "task_alloc", "--churn", "0.2", "--churn-rate", "0.0",
                       "0.3", "--seeds", "0", "--samples", "400",
                       "--max-rounds", "48", "--edges", "3",
                       "--device", "cpu"])
    text = capsys.readouterr().out
    assert "4 cells" in text and "policy" in text and "churn" in text
    assert "task_alloc" in text and "compile cache: 1 programs" in text
    with pytest.raises(SystemExit):
        launch_sweep.main(["--churn-rate", "0.1", "--device", "cpu",
                           "--samples", "200"])
    rep = launch_train.main(["--arch", "kmeans-traffic", "--mode", "ol4el",
                             "--el-mode", "sync", "--device", "cpu",
                             "--samples", "400", "--edges", "3",
                             "--budget", "900", "--churn", "0.3",
                             "--cost-model", "pareto", "--drift", "0.02"])
    assert "scenario ScenarioSpec" in capsys.readouterr().out
    assert rep.n_aggregations > 0 and "active_edges" in rep.raw
    rep = launch_train.main(["--arch", "svm-wafer", "--mode", "ol4el",
                             "--el-mode", "async", "--device", "cpu",
                             "--samples", "400", "--edges", "3",
                             "--budget", "900", "--churn", "0.3"])
    assert rep.n_aggregations > 0 and "active_edges" in rep.raw
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "qwen3-1.7b", "--smoke", "--churn",
                           "0.2", "--device", "cpu"])
