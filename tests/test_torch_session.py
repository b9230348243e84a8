"""The slice as a whole: the port's ELSession host loops vs the reference's.

Both packages run the same config on the same data from the same initial
params (the reference's, carried over as numpy).  The random streams are
numpy on both sides, so the decisions must be identical; the training
arithmetic is f32 in different libraries, so metrics may differ only by
what one flipped evaluation point can change, and params by a tolerance.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import bandit as jax_bandit  # noqa: E402
from repro.core import coordinator as jax_coord  # noqa: E402
from repro.el import ELSession as JaxSession  # noqa: E402
from repro.el import policies as jax_policies  # noqa: E402
from repro.el.events.knobs import \
    default_event_horizon as jax_horizon  # noqa: E402
from repro.launch.classic import classic_fixture as jax_fixture  # noqa: E402
from repro_torch.core import bandit as t_bandit  # noqa: E402
from repro_torch.core import coordinator as t_coord  # noqa: E402
from repro_torch.core.strategies import POLICIES  # noqa: E402
from repro_torch.el import ELSession  # noqa: E402
from repro_torch.el import policies as t_policies  # noqa: E402
from repro_torch.el.events.knobs import default_event_horizon  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.classic import classic_fixture  # noqa: E402

SAMPLES, EDGES, BUDGET = 2000, 3, 1200.0


def _flip_bound(arch, y):
    """The most a metric can move when one evaluation point's prediction
    flips: 1/len for accuracy; for macro F1 the flip moves one unit of
    tp/fp/fn in two classes, each class's F1 by at most 2/support."""
    if arch == "svm-wafer":
        return 1.0 / len(y)
    support = np.bincount(y)
    return 4.0 / (len(support) * support.min())


def _cfg(fx, mode, policy):
    return dataclasses.replace(fx["exp"].ol4el, mode=mode, policy=policy,
                               n_edges=EDGES, budget=BUDGET,
                               utility=fx["utility"], heterogeneity=2.0)


@pytest.fixture(scope="module")
def fixtures():
    out = {}
    for arch in ("svm-wafer", "kmeans-traffic"):
        out[arch] = (jax_fixture(arch, samples=SAMPLES, n_edges=EDGES),
                     classic_fixture(arch, samples=SAMPLES, n_edges=EDGES,
                                     device="cpu"))
    return out


@pytest.mark.parametrize("arch,mode,policy", [
    ("kmeans-traffic", "sync", "ol4el"),
    ("kmeans-traffic", "async", "ol4el"),
    ("svm-wafer", "sync", "ol4el"),
    ("svm-wafer", "async", "ol4el"),
    ("svm-wafer", "sync", "ac_sync"),
    ("svm-wafer", "sync", "fixed_i"),
])
def test_session_matches_reference(fixtures, arch, mode, policy):
    jf, tf = fixtures[arch]
    init = jax.tree.map(np.asarray, jf["init_params"])
    ref = (JaxSession(_cfg(jf, mode, policy), metric_name=jf["metric"],
                      lr=jf["lr"])
           .with_executor(jf["executor"], init_params=jf["init_params"],
                          n_samples=jf["n_samples"]).run())
    seen = []
    port = (ELSession(_cfg(tf, mode, policy), metric_name=tf["metric"],
                      lr=tf["lr"])
            .with_executor(tf["executor"],
                           init_params=params_from_numpy(init, "cpu"),
                           n_samples=tf["n_samples"])
            .on_round(seen.append).run())
    assert len(ref.records) > 3
    assert [(r.interval, r.edge) for r in port.records] == \
        [(r.interval, r.edge) for r in ref.records]
    assert seen == port.records
    assert port.arm_pulls == ref.arm_pulls
    assert port.terminated_reason == ref.terminated_reason
    assert (port.policy, port.mode) == (ref.policy, ref.mode)
    assert port.n_aggregations == ref.n_aggregations
    np.testing.assert_allclose(port.total_consumed, ref.total_consumed,
                               rtol=1e-9)
    np.testing.assert_allclose(port.wall_time, ref.wall_time, rtol=1e-9)
    bound = _flip_bound(arch, tf["executor"].eval_set["y"].numpy())
    for p, r in zip(port.records, ref.records):
        assert abs(p.metric - r.metric) <= bound
        np.testing.assert_allclose(p.total_consumed, r.total_consumed,
                                   rtol=1e-9)
    assert abs(port.final_metric - ref.final_metric) <= bound
    for k, v in ref.final_params.items():
        np.testing.assert_allclose(port.final_params[k].numpy(),
                                   np.asarray(v), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_policy_decisions_match_reference(name):
    """Identical numpy streams -> identical arms, policy by policy."""
    kw = dict(ucb_c=2.0, eps=0.2, fixed_arm=3, eta=0.05, max_interval=6)
    ref_pol, port_pol = jax_policies.get(name, **kw), t_policies.get(name, **kw)
    st_ref, st_port = jax_bandit.BanditState.create(6), \
        t_bandit.BanditState.create(6)
    r_ref, r_port = np.random.default_rng(7), np.random.default_rng(7)
    costs = t_bandit.arm_costs(6, 8.0, 40.0)
    residual = 900.0
    for step in range(40):
        a_ref = ref_pol.select(st_ref, residual, costs, r_ref)
        a_port = port_pol.select(st_port, residual, costs, r_port)
        assert a_port == a_ref, step
        if a_ref < 0:
            break
        u = 0.3 + 0.1 * a_ref + 0.01 * step
        st_ref.update(a_ref, u, costs[a_ref])
        st_port.update(a_port, u, costs[a_port])
        residual -= costs[a_ref] / 4
    assert t_policies.available() == jax_policies.available()


@pytest.mark.parametrize("mode,cost_model", [("sync", "fixed"),
                                             ("async", "variable")])
def test_coordinator_and_horizon_match_reference(mode, cost_model):
    cfg_ref = jax_coord.OL4ELConfig(mode=mode, cost_model=cost_model,
                                    cost_noise=0.3, heterogeneity=3.0,
                                    n_edges=4, seed=5)
    from repro_torch.config import OL4ELConfig
    cfg_port = OL4ELConfig(**dataclasses.asdict(cfg_ref))
    assert default_event_horizon(cfg_port) == jax_horizon(cfg_ref)
    ref, port = jax_coord.CloudCoordinator(cfg_ref), \
        t_coord.CloudCoordinator(cfg_port)
    for step in range(30):
        e = step % 4
        i_ref, i_port = ref.decide(e), port.decide(e)
        assert i_port == i_ref
        if i_ref < 0:
            break
        c_ref, c_port = ref.realized_cost(e, i_ref), \
            port.realized_cost(e, i_port)
        assert c_port == c_ref
        for co, c in ((ref, c_ref), (port, c_port)):
            co.charge(e, c)
            co.observe(e, i_ref, 0.1 * i_ref, c)
        assert port.exhausted(e) == ref.exhausted(e)
    assert port.total_consumed() == ref.total_consumed()
    assert port.all_exhausted() == ref.all_exhausted()


def test_later_slices_raise_not_implemented(fixtures):
    """The sweep engine's and the async engine's entry points
    (``sweep``, ``run_async_ingraph``, ``run_async(rng_streams="jax")``)
    run, and raise only for their unported option, sharded runs; the
    scenario engine's sweep axes are taken as the reference takes them
    (they need ``cfg.scenario`` set)."""
    from repro.el.sweep import SweepSpec as JaxSpec
    from repro_torch.el.scenarios import ScenarioSpec
    from repro_torch.el.sweep import SweepSpec
    jf, tf = fixtures["svm-wafer"]
    sess = ELSession(_cfg(tf, "sync", "ol4el")).with_executor(tf["executor"])
    with pytest.raises(NotImplementedError, match="item 14"):
        sess.sweep(SweepSpec(seeds=(0,)), mesh=object())
    spec = SweepSpec(policy=("ol4el",))
    with pytest.raises(ValueError) as want:
        JaxSpec(policy=("ol4el",)).cell_cfgs(_cfg(jf, "sync", "ol4el"))
    with pytest.raises(ValueError) as got:
        spec.cell_cfgs(sess.cfg)
    assert str(got.value) == str(want.value)
    cells = spec.cell_cfgs(dataclasses.replace(sess.cfg,
                                               scenario=ScenarioSpec()))
    assert [c.policy for c in cells] == ["ol4el"]
    assert cells[0].scenario == ScenarioSpec()
    with pytest.raises(NotImplementedError, match="item 14"):
        sess.run_async_ingraph(mesh=object())
    assert sess.run_async_ingraph(max_events=4).n_aggregations == 4
    assert sess.run_async(rng_streams="jax",
                          max_events=4).n_aggregations == 4
    with pytest.raises(ValueError):
        sess.run_async(rng_streams="philox")


def test_session_without_executor_raises():
    from repro_torch.config import OL4ELConfig
    with pytest.raises(RuntimeError, match="with_executor"):
        ELSession(OL4ELConfig()).run()
