"""The port's compiled async event engine (``repro_torch.el.events``) vs
the reference's (``repro.el.events``), on the CPU.

The reference draws per event from ``jax.random`` keys; the port takes
its draws through the RNG seam.  ``jax_event_draws`` makes the
reference's draws key for key (``split(rng, 3)`` for the initial round,
``split(rng, 4)`` per event, the event edge's ``fold_in(k, e)`` keys:
a Gumbel vector per categorical draw, ``uniform(fold_in(fold_in(k_data,
e), step))`` for the minibatches, ``normal(fold_in(k_cost, e))`` for the
cost noise), for every edge of every event, and hands them to the port as
a ``ReplayDraws``.  The decisions (event order, intervals, arm pulls,
events, termination) must then be identical, ``consumed`` and ``wall``
bit-equal at fixed cost, metric and utility within 1e-6, final params
within 1e-5.  A flip can only happen at a near-tie of ``argmax(logits +
g)``, so each whole-program case records the smallest top-2 margin.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

torch = pytest.importorskip("torch")

from test_el_events import _svm_fixture as jax_svm_fixture  # noqa: E402

from repro.config import OL4ELConfig as JaxCfg  # noqa: E402
from repro.el import ELSession as JaxSession  # noqa: E402
from repro.el.events import knobs as jax_knobs  # noqa: E402
from repro.el.events import program as jax_program  # noqa: E402
from repro.el.events import scheduler as jax_sched  # noqa: E402
from repro.el.events import state as jax_state  # noqa: E402
from repro.launch.classic import classic_fixture as jax_fixture  # noqa: E402
from repro_torch.config import OL4ELConfig, get_config  # noqa: E402
from repro_torch.core import bandit as t_bandit  # noqa: E402
from repro_torch.data import make_wafer_dataset, partition_edges  # noqa: E402
from repro_torch.el import ELSession  # noqa: E402
from repro_torch.el import events  # noqa: E402
from repro_torch.el.events import program as t_program  # noqa: E402
from repro_torch.el.report import report_from_out  # noqa: E402
from repro_torch.el.rng import ReplayDraws, TorchDraws  # noqa: E402
from repro_torch.federated import ClassicExecutor  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.classic import classic_fixture  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

EDGES = 3


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


def jax_event_draws(seed, n_events, n_edges, n_arms, steps, batch):
    """The reference async program's draws from ``jax.random.key(seed)``
    (``events/scheduler.py:18-48``, ``program.py:189-195, :252, :264,
    :291``, ``ingraph.py:320``), every edge's for every event: a
    ``ReplayDraws`` of Gumbel [T, E, K], uniforms [T, E, k, batch],
    normals [T, E] and the initial round's [E, K] / [E]."""
    edges = jnp.arange(n_edges)

    def per_edge_gumbel(k_sel):
        return jax.vmap(lambda e: jax.random.gumbel(
            jax.random.fold_in(k_sel, e), (n_arms,), jnp.float32))(edges)

    def per_edge_normal(k_cost):
        return jax.vmap(lambda e: jax.random.normal(
            jax.random.fold_in(k_cost, e), ()))(edges)

    @jax.jit
    def draw(rng):
        rng, k_sel0, k_cost0 = jax.random.split(rng, 3)

        def one(rng, _):
            rng, k_sel, k_data, k_cost = jax.random.split(rng, 4)
            u = jax.vmap(lambda e: jax.vmap(
                lambda s: jax.random.uniform(jax.random.fold_in(
                    jax.random.fold_in(k_data, e), s), (batch,)))(
                jnp.arange(steps)))(edges)
            return rng, (per_edge_gumbel(k_sel), u, per_edge_normal(k_cost))
        g, u, n = lax.scan(one, rng, None, length=n_events)[1]
        return g, u, n, per_edge_gumbel(k_sel0), per_edge_normal(k_cost0)

    g, u, n, g0, n0 = [np.array(a) for a in draw(jax.random.key(seed))]
    return ReplayDraws(g, u, n, init_gumbel=g0, init_normal=n0)


def _numpy_draws(seed, n_events, n_edges, n_arms, steps, batch):
    rng = np.random.default_rng(seed)
    return ReplayDraws(rng.gumbel(size=(n_events, n_edges, n_arms)),
                       rng.uniform(size=(n_events, n_edges, steps, batch)),
                       rng.standard_normal((n_events, n_edges)),
                       init_gumbel=rng.gumbel(size=(n_edges, n_arms)),
                       init_normal=rng.standard_normal(n_edges))


# -- the scheduling arithmetic ---------------------------------------------------


def _bandit_state(rng, k, tried):
    counts = (rng.integers(1, 6, k) if tried else
              rng.integers(0, 2, k)).astype(np.int32)
    return {"counts": counts,
            "utility_sum": (rng.uniform(-0.1, 0.9, k) * counts
                            ).astype(np.float32),
            "cost_sum": (rng.uniform(50, 200, k) * counts).astype(np.float32),
            "t": np.int32(counts.sum())}


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_schedule_block_matches_reference(noise):
    """Arm, interval, charged cost and finish time bit for bit against the
    reference's jitted ``schedule_block`` on its own keys' draws: the arm
    through Gumbel-max, the cost through XLA's two fused multiply-adds."""
    k = 10
    f = jax.jit(jax_sched.schedule_block)
    rng = np.random.default_rng(int(noise * 10))
    for i in range(120):
        comp = np.float32(rng.uniform(5, 45))
        comm = np.float32(rng.uniform(20, 80))
        costs = (np.arange(1, k + 1, dtype=np.float32) * comp + comm)
        state = _bandit_state(rng, k, tried=i % 3 != 0)
        resid = np.float32(rng.choice([5000.0, rng.uniform(0, 400)]))
        wall = np.float32(rng.uniform(0, 5000))
        key = jax.random.key(i)
        k_sel, k_cost = jax.random.fold_in(key, 1), jax.random.fold_in(key, 2)
        args = (np.float32(2.0), comp + comm, np.float32(noise), comp, comm,
                wall)
        want = f({n: jnp.asarray(v) for n, v in state.items()},
                 jnp.float32(resid), jnp.asarray(costs), *map(jnp.asarray,
                                                              args),
                 k_sel, k_cost)
        got = events.schedule_block(
            {n: torch.as_tensor(v) for n, v in state.items()},
            torch.tensor(resid), torch.from_numpy(costs),
            *map(torch.tensor, args),
            torch.from_numpy(np.array(jax.random.gumbel(k_sel, (k,)))),
            torch.tensor(np.array(jax.random.normal(k_cost, ()))))
        active, interval, cost, finish = (np.asarray(w) for w in want)
        assert bool(got[0]) == bool(active), i
        assert int(got[1]) == int(interval), i
        assert np.float32(got[2]) == cost, i
        assert np.float32(got[3]) == finish, i


def test_wave_gap_alpha_and_merge_match_reference():
    rng = np.random.default_rng(5)
    for noise in (0.0, 0.25):
        mec = rng.uniform(40, 200, 4).astype(np.float32)
        want = np.asarray(jax_sched.wave_safe_gap(jnp.asarray(mec),
                                                  jnp.float32(noise)))
        got = events.wave_safe_gap(torch.from_numpy(mec),
                                   torch.tensor(np.float32(noise)))
        assert got.dtype == torch.float32 and np.float32(got) == want
    alpha = jax.jit(lambda b, v, fv: jax_sched.staleness_alpha(b, v, fv, 4))
    merge = jax.jit(jax_sched.staleness_merge)
    for i in range(60):
        base = np.float32(rng.uniform(0.1, 0.9))
        v = int(rng.integers(1, 400))
        fv = max(0, v - int(rng.integers(0, 24)))
        a_ref = np.float32(alpha(jnp.float32(base), jnp.int32(v),
                                 jnp.int32(fv)))
        a = events.staleness_alpha(torch.tensor(base), torch.tensor(v),
                                   torch.tensor(fv), torch.tensor(4.0))
        assert np.float32(a) == a_ref, i
        g = {"w": rng.standard_normal((59, 8)).astype(np.float32),
             "b": rng.standard_normal(8).astype(np.float32)}
        e = {n: rng.standard_normal(x.shape).astype(np.float32)
             for n, x in g.items()}
        want = merge(g, e, jnp.float32(a_ref))
        got = events.staleness_merge(
            {n: torch.from_numpy(x) for n, x in g.items()},
            {n: torch.from_numpy(x) for n, x in e.items()}, a)
        for n in g:
            np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


def test_bandit_fleet_matches_reference():
    want = jax_state.bandit_fleet_init(4, 6)
    got = events.bandit_fleet_init(4, 6, "cpu")
    for n in want:
        assert got[n].dtype == {"counts": torch.int32, "t": torch.int32}.get(
            n, torch.float32)
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    rng = np.random.default_rng(2)
    for e in (0, 3, 2):
        st = _bandit_state(rng, 6, tried=True)
        want = jax_state.bandit_place(want, jnp.int32(e),
                                      {n: jnp.asarray(v)
                                       for n, v in st.items()})
        got = events.bandit_place(got, torch.tensor(e),
                                  {n: torch.as_tensor(v)
                                   for n, v in st.items()})
        sl = events.bandit_slice(got, torch.tensor(e))
        for n in st:
            np.testing.assert_array_equal(sl[n].numpy(), st[n])
    for n in want:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


def test_async_knobs_and_horizons_match_reference():
    assert events.ASYNC_KNOB_NAMES == jax_knobs.ASYNC_KNOB_NAMES
    for kw in ({"mode": "async"},
               {"mode": "async", "heterogeneity": 4.0, "n_edges": 5,
                "cost_model": "variable", "cost_noise": 0.3,
                "budget": 777.0, "async_alpha": 0.3},
               {"mode": "async", "n_edges": 2, "async_batch_k": 4}):
        ref, cfg = JaxCfg(**kw), OL4ELConfig(**kw)
        want, got = jax_knobs.async_knobs(ref), events.async_knobs(cfg)
        assert got.keys() == want.keys() == set(events.async_knob_names(cfg))
        for n in want:
            assert np.asarray(got[n]).dtype == np.asarray(want[n]).dtype, n
            np.testing.assert_array_equal(got[n], want[n])
        assert events.padded_event_horizon(cfg) == \
            jax_knobs.padded_event_horizon(ref)
        assert events.resolve_async_batch_k(cfg) == \
            jax_knobs.resolve_async_batch_k(ref)
    for cap in (1, 5, 64, 65, 300, 1000):
        assert events.bucket_event_horizon(cap) == \
            jax_knobs.bucket_event_horizon(cap)
    # a scenario that is not a ScenarioSpec: the reference's TypeError
    with pytest.raises(TypeError) as want:
        jax_knobs.async_knobs(JaxCfg(mode="async", scenario=object()))
    with pytest.raises(TypeError) as got:
        events.async_knobs(OL4ELConfig(mode="async", scenario=object()))
    assert str(got.value) == str(want.value)


def test_eval_gain_is_rounded_once_as_xla_rounds_it():
    """The reference's ``eval_step`` fuses the accuracy's multiply into
    the gain's subtraction (one rounding); the port's does too, and the
    plain subtraction would differ for some values."""
    jf = jax_fixture("svm-wafer", samples=600, n_edges=EDGES)
    tf = classic_fixture("svm-wafer", samples=600, n_edges=EDGES,
                         device="cpu")
    cfg = dataclasses.replace(jf["exp"].ol4el, mode="async", n_edges=EDGES,
                              utility="eval_gain")
    jex, tex = jf["executor"], tf["executor"]
    _, _, ref_step = jax_program._build_parts(
        jex.model, jex.edge_data, jex.eval_set, cfg, lr=jex.lr,
        batch=jex.batch, metric_fn=None, metric_name="accuracy")
    ref_step = jax.jit(ref_step)
    _, _, step = t_program._build_parts(
        tex.model, tex.edge_data, tex.eval_set, cfg, lr=tex.lr,
        batch=tex.batch, metric_fn=None, metric_name="accuracy",
        device=torch.device("cpu"))
    rng = np.random.default_rng(0)
    plain_differs = 0
    for _ in range(100):
        p = {"w": rng.standard_normal((59, 8)).astype(np.float32),
             "b": rng.standard_normal(8).astype(np.float32)}
        prev = np.float32(rng.uniform(0.05, 0.95))
        m_ref, u_ref = ref_step(p, p, jnp.float32(prev))
        tp = {n: torch.from_numpy(v) for n, v in p.items()}
        m, u = step(tp, tp, torch.tensor(prev))
        assert np.float32(m) == np.float32(m_ref)
        assert np.float32(u) == np.float32(u_ref)
        plain_differs += int(np.float32(m) - prev != np.float32(u_ref))
    assert plain_differs > 0


# -- the whole program --------------------------------------------------------


def port_svm_fixture(n=600, n_edges=3, seed=0, budget=700.0, mode="async",
                     utility="eval_gain", **cfg_kw):
    """The port's twin of the reference's ``_svm_fixture``
    (``tests/test_el_events.py:22``): the same data, split, executor and
    config, on the CPU."""
    train, test = make_wafer_dataset(n=n, seed=seed)
    exp = get_config("svm-wafer")
    model = build_model(exp.model, device="cpu")
    ol = dataclasses.replace(
        exp.ol4el, mode=mode, policy="ol4el", n_edges=n_edges,
        budget=budget, heterogeneity=4.0, utility=utility, seed=seed,
        **cfg_kw)
    edges = partition_edges(train, n_edges, alpha=1.0, seed=seed)
    ex = ClassicExecutor(model, edges, test, batch=32, lr=0.05,
                         device="cpu")
    return ol, ex, model.init(torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def kmeans_fixtures():
    return {impl: (jax_fixture("kmeans-traffic", samples=1500,
                               n_edges=EDGES, kmeans_impl=impl),
                   classic_fixture("kmeans-traffic", samples=1500,
                                   n_edges=EDGES, device="cpu"))
            for impl in ("jnp", "pallas")}


def _replay_margins(records, draws, cfg):
    """Rebuild every edge's bandit from the port's records and the
    replayed draws, check each event's interval is the one its edge
    scheduled, and return the smallest top-2 margin of ``logits + g`` over
    every scheduling decision."""
    knobs = {k: torch.as_tensor(v) for k, v in
             events.async_knobs(cfg).items()}
    arrays = draws.arrays
    states = [t_bandit.device_bandit_init(cfg.max_interval, "cpu")
              for _ in range(cfg.n_edges)]
    consumed = torch.zeros(cfg.n_edges)
    pending, margins = {}, []

    def pick(e, wall, gumbel, normal):
        resid = knobs["budget"] - consumed[e]
        w = t_bandit.device_selection_weights(
            states[e], resid, knobs["costs_ek"][e], knobs["ucb_c"])
        if float(w.sum()) > 0:
            top2 = (t_bandit.device_arm_logits(w) + gumbel).topk(2).values
            margins.append(float(top2[0] - top2[1]))
        _, interval, cost, _ = events.schedule_block(
            states[e], resid, knobs["costs_ek"][e], knobs["ucb_c"],
            knobs["min_edge_cost"][e], knobs["cost_noise"], knobs["comp"][e],
            knobs["comm"][e], wall, gumbel, normal)
        pending[e] = (int(interval), cost)

    for e in range(cfg.n_edges):
        pick(e, torch.tensor(0.0), arrays["init_gumbel"][e],
             arrays["init_normal"][e])
    for t, rec in enumerate(records):
        e = rec.edge
        interval, cost = pending.pop(e)
        assert rec.interval == interval, t
        consumed[e] = consumed[e] + cost
        states[e] = t_bandit.device_bandit_update(
            states[e], torch.tensor(interval - 1),
            torch.tensor(rec.utility, dtype=torch.float32), cost)
        pick(e, torch.tensor(rec.wall_time, dtype=torch.float32),
             arrays["gumbel"][t, e], arrays["normal"][t, e])
    return min(margins)


def _assert_matches_reference(port, ref, draws, cfg, request, fixed_cost):
    margin = _replay_margins(port.records, draws, cfg)
    request.node.user_properties.append(("min_top2_margin", margin))
    print(f"smallest top-2 margin of logits + g: {margin}")
    msg = f"smallest top-2 margin of logits + g: {margin}"
    assert [r.edge for r in port.records] == \
        [r.edge for r in ref.records], msg
    assert [r.interval for r in port.records] == \
        [r.interval for r in ref.records], msg
    # past every edge's initialization phase (K untried arms each)
    assert len(ref.records) > cfg.n_edges * cfg.max_interval
    assert len({r.edge for r in ref.records}) == cfg.n_edges
    assert port.n_aggregations == ref.n_aggregations
    assert port.arm_pulls == ref.arm_pulls
    assert port.terminated_reason == ref.terminated_reason
    assert (port.mode, port.policy) == (ref.mode, ref.policy) == \
        ("async", "ol4el")
    consumed = np.float32([r.total_consumed for r in port.records])
    wall = np.float32([r.wall_time for r in port.records])
    want_c = np.float32([r.total_consumed for r in ref.records])
    want_w = np.float32([r.wall_time for r in ref.records])
    if fixed_cost:
        np.testing.assert_array_equal(consumed, want_c)
        np.testing.assert_array_equal(wall, want_w)
        assert np.float32(port.wall_time) == np.float32(ref.wall_time)
    else:
        np.testing.assert_allclose(consumed, want_c, rtol=1e-6)
        np.testing.assert_allclose(wall, want_w, rtol=1e-6)
    np.testing.assert_allclose([r.metric for r in port.records],
                               [r.metric for r in ref.records], atol=1e-6)
    np.testing.assert_allclose([r.utility for r in port.records],
                               [r.utility for r in ref.records], atol=1e-6)
    for k, v in ref.final_params.items():
        np.testing.assert_allclose(port.final_params[k].numpy(),
                                   np.asarray(v), rtol=1e-5, atol=1e-5)
    if not math.isnan(ref.final_metric):
        assert abs(port.final_metric - ref.final_metric) <= 1e-6


@pytest.mark.parametrize("utility,cost_model,batch_k", [
    ("eval_gain", "fixed", 1),
    ("eval_gain", "variable", 1),
    ("param_delta", "fixed", 1),
    ("eval_gain", "fixed", 2),
    ("eval_gain", "variable", 3),
    ("param_delta", "fixed", 3),
])
def test_svm_program_matches_reference(utility, cost_model, batch_k,
                                       request):
    """The reference's own async fixture (``_svm_fixture``: 600 samples,
    3 edges, heterogeneity 4), its budget raised from 700 to 3000 so every
    edge's bandit leaves its initialization phase and the utilities steer
    the arms."""
    kw = dict(n=600, n_edges=EDGES, budget=3000.0, utility=utility,
              cost_model=cost_model, cost_noise=0.3, async_batch_k=batch_k)
    ol, ex, init = jax_svm_fixture(**kw)
    ref = (JaxSession(ol, metric_name="accuracy", lr=0.05)
           .with_executor(ex, init_params=init).run_async_ingraph())
    cfg, tex, _ = port_svm_fixture(**kw)
    horizon = events.padded_event_horizon(cfg)
    draws = jax_event_draws(cfg.seed + 17, horizon, EDGES, cfg.max_interval,
                            cfg.max_interval, tex.batch)
    seen = []
    port = (ELSession(cfg, metric_name="accuracy", lr=0.05)
            .with_executor(tex, init_params=params_from_numpy(
                jax.tree.map(np.asarray, init), "cpu"))
            .on_round(seen.append)
            .run_async_ingraph(draws=draws))
    assert port.telemetry["device_loop"]["batch_k"] == batch_k
    assert seen == port.records
    _assert_matches_reference(port, ref, draws, cfg, request,
                              cost_model == "fixed")


@pytest.mark.parametrize("impl,cost_model,batch_k", [
    ("jnp", "fixed", 1),
    ("jnp", "variable", 2),
    ("pallas", "fixed", 1),
    ("pallas", "variable", 3),
])
def test_kmeans_program_matches_reference(kmeans_fixtures, impl,
                                          cost_model, batch_k, request):
    """kmeans-traffic (param-delta utility, no device metric) with the
    reference's jnp and Pallas-interpret E-step."""
    jf, tf = kmeans_fixtures[impl]

    def cfg_of(fx):
        return dataclasses.replace(
            fx["exp"].ol4el, mode="async", n_edges=EDGES, budget=3000.0,
            utility=fx["utility"], heterogeneity=2.0, cost_model=cost_model,
            cost_noise=0.2, async_batch_k=batch_k)

    ref = (JaxSession(cfg_of(jf), metric_name=jf["metric"], lr=jf["lr"])
           .with_executor(jf["executor"], init_params=jf["init_params"])
           .run_async_ingraph())
    cfg = cfg_of(tf)
    horizon = events.padded_event_horizon(cfg)
    draws = jax_event_draws(cfg.seed + 17, horizon, EDGES, cfg.max_interval,
                            cfg.max_interval, tf["executor"].batch)
    port = (ELSession(cfg, metric_name=tf["metric"], lr=tf["lr"])
            .with_executor(tf["executor"], init_params=params_from_numpy(
                jax.tree.map(np.asarray, jf["init_params"]), "cpu"))
            .run_async_ingraph(draws=draws))
    _assert_matches_reference(port, ref, draws, cfg, request,
                              cost_model == "fixed")


# -- inside the port ----------------------------------------------------------


def _port_session(fx, **kw):
    kw = {"budget": 1500.0, "heterogeneity": 2.0, **kw}
    cfg = dataclasses.replace(fx["exp"].ol4el, mode="async", n_edges=EDGES,
                              utility=fx["utility"], **kw)
    return (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
            .with_executor(fx["executor"], init_params=fx["init_params"],
                           n_samples=fx["n_samples"]))


def _key(rep):
    return [(r.edge, r.interval, r.wall_time, r.total_consumed, r.metric,
             r.utility) for r in rep.records]


def _same(a, b):
    """Records equal bit for bit (NaN metrics equal)."""
    return len(a) == len(b) and all(
        all(x == y or (isinstance(x, float) and math.isnan(x)
                       and math.isnan(y)) for x, y in zip(p, q))
        for p, q in zip(a, b))


@pytest.fixture(scope="module")
def port_fixtures():
    return {arch: classic_fixture(arch, samples=900, n_edges=EDGES,
                                  device="cpu")
            for arch in ("svm-wafer", "kmeans-traffic")}


@pytest.mark.parametrize("arch", ["svm-wafer", "kmeans-traffic"])
@pytest.mark.parametrize("replayed", [False, True])
def test_host_twin_equals_program_bit_for_bit(port_fixtures, arch,
                                              replayed):
    """``run_async(rng_streams="jax")`` (the heap loop on the program's
    per-event pieces) and ``run_async_ingraph`` on the same draws: the
    generator's by default (indexed by event, so chunking cannot shift
    them), or replayed ones."""
    fx = port_fixtures[arch]
    reps = []
    for run in ("run_async_ingraph", "run_async"):
        sess = _port_session(fx)
        kw = {} if run == "run_async_ingraph" else {"rng_streams": "jax"}
        if replayed:
            kw["draws"] = _numpy_draws(1, 128, EDGES, sess.cfg.max_interval,
                                       sess.cfg.max_interval,
                                       fx["executor"].batch)
        reps.append(getattr(sess, run)(**kw))
    ing, twin = reps
    assert ing.terminated_reason == twin.terminated_reason == \
        "budget_exhausted"
    assert ing.n_aggregations > EDGES * 10
    assert _same(_key(ing), _key(twin))
    assert ing.arm_pulls == twin.arm_pulls
    assert ing.total_consumed == twin.total_consumed
    for k in ing.final_params:
        assert torch.equal(ing.final_params[k], twin.final_params[k])


@pytest.mark.parametrize("arch", ["svm-wafer", "kmeans-traffic"])
def test_k_waves_equal_single_events(port_fixtures, arch):
    """batch_k 2 and 3 against 1 on the same draws, at heterogeneity 1
    (every edge's costs equal, so finish times tie often)."""
    fx = port_fixtures[arch]
    runs = {}
    for bk in (1, 2, 3):
        sess = _port_session(fx, heterogeneity=1.0, async_batch_k=bk)
        runs[bk] = sess.run_async_ingraph()
        assert runs[bk].telemetry["device_loop"]["batch_k"] == bk
    walls = [r.wall_time for r in runs[1].records]
    assert len(walls) != len(set(walls))            # the run has ties
    for bk in (2, 3):
        assert _same(_key(runs[bk]), _key(runs[1])), bk
        assert runs[bk].arm_pulls == runs[1].arm_pulls
        for k in runs[1].final_params:
            assert torch.equal(runs[bk].final_params[k],
                               runs[1].final_params[k])
    # a wave takes several events a step: fewer steps, so fewer chunks
    # of the same length are enough
    assert runs[3].telemetry["device_loop"]["chunks"] <= \
        runs[1].telemetry["device_loop"]["chunks"]


def test_k_wave_on_a_built_tie_pops_the_lower_edge_first(port_fixtures):
    """A carry whose three edges finish at the same time: one wave of
    three equals three single events, which pop edges 0, 1, 2."""
    fx = port_fixtures["svm-wafer"]
    ex = fx["executor"]
    cfg = _port_session(fx, heterogeneity=1.0).cfg
    knobs = {k: torch.as_tensor(v) for k, v in
             events.async_knobs(cfg).items()}
    draws = _numpy_draws(4, 3, EDGES, cfg.max_interval, cfg.max_interval,
                         ex.batch)
    bufs = {"gumbel": torch.zeros(3, EDGES, cfg.max_interval),
            "uniform": torch.zeros(3, EDGES, cfg.max_interval, ex.batch),
            "normal": torch.zeros(3, EDGES)}
    init_bufs = {"init_gumbel": torch.zeros(EDGES, cfg.max_interval),
                 "init_normal": torch.zeros(EDGES)}
    draws.fill(bufs, 0)
    draws.fill_init(init_bufs)
    carries = {}
    for bk in (1, 3):
        cell = events.make_async_cell(
            ex.model, ex.edge_data, ex.eval_set, cfg, lr=ex.lr,
            batch=ex.batch, max_events=64, batch_k=bk, device="cpu")
        carry = cell.init(fx["init_params"], knobs, init_bufs)
        carry["finish"] = torch.full((EDGES,), 170.0)
        carry["infl_i"] = torch.tensor([3, 7, 1])
        carry["infl_c"] = torch.full((EDGES,), 170.0)
        step_draws = dict(bufs, t_base=carry["t"].clone())
        for _ in range(3 if bk == 1 else 1):
            carry = cell.body(carry, knobs, step_draws)
        carries[bk] = carry
    one, wave = carries[1], carries[3]
    assert int(wave["t"]) == int(one["t"]) == 3
    assert wave["hist"]["edge"][:3].tolist() == [0, 1, 2]
    for k, v in one.items():
        for a, b in zip(_leaves(v), _leaves(wave[k])):
            bits = {torch.float32: torch.int32}.get(a.dtype, a.dtype)
            assert torch.equal(a.view(bits), b.view(bits)), k


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_chunk_length_does_not_change_the_run(port_fixtures):
    """Masked steps leave the carry alone and draws are indexed by event:
    chunks of 3 steps and of 16 give the same run."""
    fx = port_fixtures["kmeans-traffic"]
    ex = fx["executor"]
    cfg = _port_session(fx, async_batch_k=2).cfg
    runs = []
    for r in (3, 16):
        prog = events.make_async_program(
            ex.model, ex.edge_data, ex.eval_set, cfg, lr=ex.lr,
            batch=ex.batch, max_events=128, device="cpu",
            rounds_per_chunk=r)
        draws = TorchDraws(torch.Generator().manual_seed(9))
        runs.append(prog(fx["init_params"], events.async_knobs(cfg), draws)
                    + (prog.last_run,))
    (p3, o3, l3), (p16, o16, l16) = runs
    assert int(o3["n_rounds"]) > 16 and int(o3["n_active"]) == 0
    for k in o3:
        np.testing.assert_array_equal(o3[k], o16[k])
    for k in p3:
        assert torch.equal(p3[k], p16[k])
    assert l3["chunks"] > l16["chunks"]


def test_torch_draws_depend_on_the_item_only():
    shapes = {"gumbel": (2, 4), "uniform": (2, 3, 5), "normal": (2,)}

    def bufs(n):
        return {k: torch.zeros((n,) + s) for k, s in shapes.items()}

    a, b = TorchDraws(torch.Generator().manual_seed(3)), \
        TorchDraws(torch.Generator().manual_seed(3))
    whole = bufs(40)
    a.fill(whole, 0)
    for t0, n in ((0, 7), (7, 20), (27, 13)):
        part = bufs(n)
        b.fill(part, t0)
        for k in shapes:
            assert torch.equal(part[k], whole[k][t0:t0 + n])
    init = {"init_gumbel": torch.zeros(2, 4), "init_normal": torch.zeros(2)}
    with pytest.raises(ValueError, match="initial"):
        a.fill_init(init)
    c = TorchDraws(torch.Generator().manual_seed(3))
    c.fill_init(init)
    assert bool(torch.isfinite(init["init_gumbel"]).all())
    with pytest.raises(ValueError, match="init_normal"):
        ReplayDraws(init_gumbel=np.zeros((2, 4))).fill_init(init)


def test_max_events_caps_the_run_and_shares_the_program(port_fixtures):
    fx = port_fixtures["svm-wafer"]
    sess = _port_session(fx)
    rep = sess.run_async_ingraph(max_events=5)
    assert rep.n_aggregations == 5 and rep.terminated_reason == "max_events"
    assert rep.telemetry["device_loop"]["chunks"] == 1
    prog = sess._fastpath
    assert prog.cell.horizon == 64               # bucketed
    rep = sess.run_async_ingraph(max_events=20)
    assert rep.n_aggregations == 20 and sess._fastpath is prog
    assert rep.terminated_reason == "max_events"
    assert rep.telemetry["cache"]["hits"] == 1
    rep = sess.run_async_ingraph()                  # the padded horizon
    assert rep.terminated_reason == "budget_exhausted"
    assert sess._fastpath is not prog


def test_program_reused_across_knob_changes(port_fixtures):
    fx = port_fixtures["svm-wafer"]
    s = _port_session(fx)
    r1 = s.run_async_ingraph()
    prog = s._fastpath
    s.cfg = dataclasses.replace(s.cfg, ucb_c=0.5, budget=1400.0, seed=5,
                                async_alpha=0.3)
    r2 = s.run_async_ingraph()
    assert s._fastpath is prog
    assert r2.n_aggregations > 0 and _key(r2) != _key(r1)
    s.cfg = dataclasses.replace(s.cfg, async_batch_k=2)
    s.run_async_ingraph()
    assert s._fastpath is not prog                  # batch_k is structural


def test_async_rejects_unsupported_configs(port_fixtures):
    fx = port_fixtures["svm-wafer"]
    with pytest.raises(ValueError, match="policy='greedy'"):
        _port_session(fx, policy="greedy").run_async_ingraph()
    # a scenario that is not a ScenarioSpec: the reference's TypeError
    # (its first line; the menu below it names each package's modules)
    from repro.el.ingraph import check_ingraph_support as jax_check
    for caller, run in (("run_async_ingraph", lambda s: s.run_async_ingraph()),
                        ("run_async(rng_streams='jax')",
                         lambda s: s.run_async(rng_streams="jax"))):
        with pytest.raises(TypeError) as got:
            run(_port_session(fx, scenario=object()))
        with pytest.raises(TypeError) as want:
            jax_check(JaxCfg(mode="async", scenario=object()), caller=caller)
        assert str(got.value).split("\n")[0].replace("repro_torch.", "repro.") \
            == str(want.value).split("\n")[0]
    ex = fx["executor"]
    cfg = _port_session(fx).cfg
    with pytest.raises(NotImplementedError, match="item 14"):
        events.make_async_cell(ex.model, ex.edge_data, ex.eval_set, cfg,
                               lr=ex.lr, batch=ex.batch, mesh=object())
    # the rings are ported; a wave wider than the ring raises with the
    # reference's message
    cell = events.make_async_cell(ex.model, ex.edge_data, ex.eval_set, cfg,
                                  lr=ex.lr, batch=ex.batch, telemetry=True)
    assert cell.items_per_step == 1
    with pytest.raises(ValueError) as got:
        events.make_async_cell(ex.model, ex.edge_data, ex.eval_set, cfg,
                               lr=ex.lr, batch=ex.batch, telemetry=1,
                               batch_k=2)
    assert str(got.value) == (
        "async_batch_k=2 exceeds the telemetry ring size 1: a wave's "
        "per-event ring writes would collide within one scatter — raise "
        "telemetry= or lower the batch width")


@pytest.mark.parametrize("kw,item", [({"mesh": object()}, "item 14"),
                                     ({"donate": True}, "item 14"),
                                     ({"telemetry": True}, "item 12"),
                                     ({"profile": True}, "item 12"),
                                     ({"contract": True}, "item 12")])
def test_unported_options_name_their_items(port_fixtures, kw, item):
    """``mesh=`` / ``donate=`` (item 14) raise; the rings and the program
    profiles (item 12) run, leave the events as they were and attach the
    reference's fields."""
    from repro.obs import rings as jax_rings
    fx = port_fixtures["svm-wafer"]
    if item == "item 14":
        with pytest.raises(NotImplementedError, match=item):
            _port_session(fx).run_async_ingraph(**kw)
        return
    off = _port_session(fx).run_async_ingraph()
    rep = _port_session(fx).run_async_ingraph(**kw)
    assert _same(_key(rep), _key(off))
    if "telemetry" in kw:
        rings = rep.telemetry["rings"]
        assert set(rings) == {*jax_rings._ASYNC_INTS, *jax_rings._ASYNC_FLOATS,
                              "arm_counts", "arm_utility", "head",
                              "ring_size"}
        assert int(rings["head"]) == rep.n_aggregations
    else:
        prof = rep.telemetry["profile"]
        assert prof["collectives"] == {} and prof["alias_bytes"] == 0


def test_sync_cfg_is_coerced_to_async(port_fixtures):
    s = _port_session(port_fixtures["svm-wafer"])
    s.cfg = dataclasses.replace(s.cfg, mode="sync")
    rep = s.run_async_ingraph()
    assert rep.mode == "async" and {r.edge for r in rep.records} == \
        set(range(EDGES))


def test_report_from_out_async_branches():
    out = {"n_rounds": np.int64(2), "n_active": np.int64(1),
           "arm_pulls": np.array([[1, 0, 0], [0, 1, 0]]),
           "wall_time": np.float32(7.0), "edge": np.array([1, 0, -1]),
           "wall": np.float32([3, 7, 0]), "consumed": np.float32([3, 9, 0]),
           "metric": np.float32([0.5, 0.6, 0]),
           "utility": np.float32([0.1, 0.2, 0]),
           "interval": np.int32([2, 1, 0])}
    rep = report_from_out(out, mode="async", policy="ol4el", horizon=64,
                          final_metric=0.6, final_params=None, elapsed_s=0.0)
    assert rep.terminated_reason == "max_events" and rep.arm_pulls == [1, 1, 0]
    assert [r.edge for r in rep.records] == [1, 0]
    assert rep.total_consumed == 9.0
    out["n_active"] = np.int64(0)
    assert report_from_out(out, mode="async", policy="ol4el", horizon=2,
                           final_metric=0.6, final_params=None,
                           elapsed_s=0.0).terminated_reason == \
        "budget_exhausted"
