"""The port's compiled sync round (``repro_torch.el.ingraph``) vs the
reference's (``repro.el.ingraph``), on the CPU.

The reference draws from ``jax.random`` keys; the port takes its draws
through the RNG seam.  ``jax_round_draws`` makes the reference's draws key
for key (``split(rng, 3)`` per round, ``fold_in(k_data, e)`` then
``fold_in(key, step)`` for the minibatch uniforms, ``fold_in(k_data,
n_edges)`` for the cost noise, a Gumbel vector per categorical draw) and
hands them to the port as a ``ReplayDraws``.  The decisions (intervals,
arm pulls, rounds, termination) must then be identical, and the f32
arithmetic the reference's: ``consumed`` and ``wall`` bit-equal at fixed
cost.  A flip can only happen at a near-tie of ``argmax(logits + g)``, so
the whole-program test records the smallest top-2 margin it saw.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

torch = pytest.importorskip("torch")

from repro.core import bandit as jax_bandit  # noqa: E402
from repro.el import ELSession as JaxSession  # noqa: E402
from repro.el import ingraph as jax_ingraph  # noqa: E402
from repro.launch.classic import classic_fixture as jax_fixture  # noqa: E402
from repro_torch.config import OL4ELConfig  # noqa: E402
from repro_torch.core import bandit as t_bandit  # noqa: E402
from repro_torch.el import ELSession  # noqa: E402
from repro_torch.el import ingraph  # noqa: E402
from repro_torch.el import policies as t_policies  # noqa: E402
from repro_torch.el.cache import ProgramCache  # noqa: E402
from repro_torch.el.rng import ReplayDraws, TorchDraws  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.classic import classic_fixture  # noqa: E402

SAMPLES, EDGES, BUDGET, MAX_ROUNDS = 1500, 3, 4000.0, 96


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


def jax_round_draws(seed, rounds, n_arms, n_edges, steps, batch):
    """The reference sync body's draws for rounds 0 .. rounds - 1 from
    ``jax.random.key(seed)`` (``ingraph.py:511, :516, :520, :320,
    :547-548``): Gumbel [T, K], uniforms [T, E, k, batch], normals [T, E]."""
    @jax.jit
    def draw(rng):
        def one(rng, _):
            rng, k_sel, k_data = jax.random.split(rng, 3)
            g = jax.random.gumbel(k_sel, (n_arms,), jnp.float32)
            keys = jax.vmap(lambda e: jax.random.fold_in(k_data, e))(
                jnp.arange(n_edges))
            u = jax.vmap(lambda key: jax.vmap(
                lambda s: jax.random.uniform(jax.random.fold_in(key, s),
                                             (batch,)))(jnp.arange(steps)))(
                keys)
            eps = jax.random.normal(jax.random.fold_in(k_data, n_edges),
                                    (n_edges,))
            return rng, (g, u, eps)
        return lax.scan(one, rng, None, length=rounds)[1]
    return [np.array(a) for a in draw(jax.random.key(seed))]


def test_categorical_is_gumbel_max():
    """The seam's premise: ``jax.random.categorical(k, logits)`` is
    ``argmax(logits + gumbel(k))``, first index on ties."""
    rng = np.random.default_rng(0)
    for i in range(50):
        key = jax.random.key(i)
        logits = jnp.asarray(rng.standard_normal(7).astype(np.float32))
        logits = logits.at[i % 7].set(-jnp.inf)
        g = torch.from_numpy(np.array(
            jax.random.gumbel(key, (7,), jnp.float32)))
        want = int(jax.random.categorical(key, logits))
        got = int(torch.argmax(torch.from_numpy(np.array(logits)) + g))
        assert got == want


# -- the device bandit ----------------------------------------------------------


def _bandit_states():
    """Seeded bandit states over K = 6 arms: the initialization phase,
    all arms tried, a broke residual, an all-infeasible residual."""
    rng = np.random.default_rng(3)
    costs = (np.arange(1, 7, dtype=np.float32) * 17.5 + 50.0)
    out = []
    for counts, resid in (([0, 2, 0, 1, 0, 0], 900.0),
                          ([3, 2, 5, 1, 4, 2], 900.0),
                          ([3, 2, 5, 1, 4, 2], 130.0),
                          ([7, 1, 2, 9, 3, 1], 3000.0),
                          ([3, 2, 5, 1, 4, 2], 40.0)):
        counts = np.asarray(counts, np.int32)
        state = {"counts": counts,
                 "utility_sum": (rng.uniform(0.1, 0.9, 6) * counts
                                 ).astype(np.float32),
                 "cost_sum": (costs * counts).astype(np.float32),
                 "t": np.int32(counts.sum())}
        out.append((state, np.float32(resid), costs))
    return out


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("ucb_c", [2.0, 0.25])
def test_device_bandit_selection_matches_reference(case, ucb_c):
    state, resid, costs = _bandit_states()[case]
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: torch.as_tensor(v) for k, v in state.items()}
    want = np.asarray(jax_bandit.jax_selection_weights(
        jstate, jnp.float32(resid), jnp.asarray(costs), jnp.float32(ucb_c)))
    got = t_bandit.device_selection_weights(
        tstate, torch.tensor(resid), torch.from_numpy(costs),
        torch.tensor(ucb_c, dtype=torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    for i in range(20):
        key = jax.random.key(100 * case + i)
        g = torch.from_numpy(np.array(
            jax.random.gumbel(key, (6,), jnp.float32)))
        arm_ref = int(jax_bandit.jax_select_arm(
            key, jstate, jnp.float32(resid), jnp.asarray(costs),
            jnp.float32(ucb_c)))
        arm = int(t_bandit.device_select_arm(
            g, tstate, torch.tensor(resid), torch.from_numpy(costs),
            torch.tensor(ucb_c, dtype=torch.float32)))
        assert arm == arm_ref
    if case == 4:
        assert arm == -1                   # nothing affordable


def test_device_bandit_update_matches_reference():
    jstate = jax_bandit.jax_bandit_init(5)
    tstate = t_bandit.device_bandit_init(5, "cpu")
    rng = np.random.default_rng(1)
    for arm in (2, 0, -1, 2, 4, -1, 1, 2):
        u, c = np.float32(rng.uniform()), np.float32(rng.uniform(50, 200))
        jstate = jax_bandit.jax_bandit_update(jstate, jnp.int32(arm),
                                              jnp.float32(u), jnp.float32(c))
        tstate = t_bandit.device_bandit_update(
            tstate, torch.tensor(arm), torch.tensor(u), torch.tensor(c))
    for k in jstate:
        assert tstate[k].dtype == {"counts": torch.int32, "t": torch.int32}.get(
            k, torch.float32)
        np.testing.assert_array_equal(tstate[k].numpy(), np.asarray(jstate[k]))


# -- the local block ------------------------------------------------------------


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


@pytest.mark.parametrize("arch,impl", [("svm-wafer", "jnp"),
                                       ("kmeans-traffic", "jnp"),
                                       ("kmeans-traffic", "pallas")])
@pytest.mark.parametrize("interval", [1, 4, 10])
def test_local_block_matches_reference(fixtures, arch, impl, interval):
    """Every edge's masked block from the same params on replayed
    uniforms: the reference's vmapped ``local_block`` vs the port's
    edge-batched one."""
    jf, tf = fixtures[arch, impl]
    jex, tex = jf["executor"], tf["executor"]
    k = 10
    xs, ys, n = jax_ingraph._pad_edge_data(jex.edge_data)
    block = jax_ingraph.make_local_block(jex.model, xs, ys, n, jex.batch,
                                         jex.lr, k)
    k_data = jax.random.key(5)
    keys = jax.vmap(lambda e: jax.random.fold_in(k_data, e))(
        jnp.arange(EDGES))
    init = jax.tree.map(np.asarray, jf["init_params"])
    if arch == "svm-wafer":                # start away from zero weights
        init = {k_: v + np.float32(0.01) * np.arange(v.size, dtype=np.float32
                                                     ).reshape(v.shape) / v.size
                for k_, v in init.items()}
    bcast = jax.tree.map(lambda v: jnp.broadcast_to(v, (EDGES,) + v.shape),
                         init)
    want = jax.vmap(block, in_axes=(0, 0, None, 0))(
        bcast, jnp.arange(EDGES), jnp.int32(interval), keys)
    uniform = np.asarray(jax.vmap(lambda key: jax.vmap(
        lambda s: jax.random.uniform(jax.random.fold_in(key, s),
                                     (jex.batch,)))(jnp.arange(k)))(keys))

    txs, tys, tn = ingraph._pad_edge_data(tex.edge_data, "cpu")
    tblock = ingraph.make_local_block(tex.model, txs, tys, tn, tex.batch,
                                      tex.lr, k)
    tparams = {k_: torch.from_numpy(np.broadcast_to(
        v, (EDGES,) + v.shape).copy()) for k_, v in init.items()}
    got = tblock(tparams, torch.tensor(interval), torch.tensor(uniform))
    for k_ in want:
        np.testing.assert_allclose(got[k_].numpy(), np.asarray(want[k_]),
                                   rtol=1e-6, atol=1e-6)


def test_svm_step_and_metric_take_an_edge_dimension(fixtures):
    """A batched SVM step ([E, B, D] against per-edge [E, D, C]) equals
    each edge's own step; the device metric is the host metric."""
    jf, tf = fixtures["svm-wafer", "jnp"]
    model, ex = tf["model"], tf["executor"]
    rng = np.random.default_rng(6)
    w = torch.tensor(rng.standard_normal((EDGES, model.d, model.n_classes))
                     * 0.1, dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((EDGES, model.n_classes)) * 0.1,
                     dtype=torch.float32)
    x = torch.tensor(rng.standard_normal((EDGES, 64, model.d)),
                     dtype=torch.float32)
    y = torch.tensor(rng.integers(0, model.n_classes, (EDGES, 64)))
    new = model.step({"w": w, "b": b}, {"x": x, "y": y}, 0.05)
    for i in range(EDGES):
        one = model.step({"w": w[i], "b": b[i]}, {"x": x[i], "y": y[i]}, 0.05)
        for k in one:
            torch.testing.assert_close(new[k][i], one[k], rtol=1e-6,
                                       atol=1e-6)
    metric = ingraph.default_metric_fn(model, ex.eval_set, "accuracy")
    params = {"w": w[0], "b": b[0]}
    acc = metric(params)
    assert acc.dtype == torch.float32 and acc.shape == ()
    assert float(acc) == model.evaluate(params, ex.eval_set)["accuracy"]
    want = jax_ingraph.default_metric_fn(
        jf["model"], jf["executor"].eval_set, "accuracy")(
        {"w": jnp.asarray(w[0].numpy()), "b": jnp.asarray(b[0].numpy())})
    assert float(acc) == float(want)
    assert ingraph.default_metric_fn(model, ex.eval_set, "f1") is None


# -- the whole program ------------------------------------------------------------


def _cfg(fx, cost_model):
    return dataclasses.replace(fx["exp"].ol4el, mode="sync", n_edges=EDGES,
                               budget=BUDGET, utility=fx["utility"],
                               heterogeneity=2.0, cost_model=cost_model,
                               cost_noise=0.2)


def _replay_margins(records, draws, cfg):
    """Rebuild the port's bandit round by round from its records and the
    replayed Gumbel vectors (in sync mode every edge is charged the slot,
    so each edge's consumption is the wall clock), and return the
    smallest top-2 margin of ``logits + g`` and the arms it picks."""
    knobs = {k: torch.as_tensor(v) for k, v in
             ingraph.sync_knobs(cfg).items()}
    state = t_bandit.device_bandit_init(cfg.max_interval, "cpu")
    margins, arms, wall = [], [], torch.tensor(0.0)
    for t, rec in enumerate(records):
        w = t_bandit.device_selection_weights(
            state, knobs["budget"] - wall, knobs["costs_k"], knobs["ucb_c"])
        score = t_bandit.device_arm_logits(w) + torch.from_numpy(draws[0][t])
        top2 = score.topk(2).values
        margins.append(float(top2[0] - top2[1]))
        arms.append(int(score.argmax()))
        state = t_bandit.device_bandit_update(
            state, torch.tensor(rec.interval - 1),
            torch.tensor(rec.utility, dtype=torch.float32), torch.tensor(0.0))
        wall = torch.tensor(rec.wall_time, dtype=torch.float32)
    return min(margins), arms


@pytest.mark.parametrize("arch,impl,cost_model", [
    ("svm-wafer", "jnp", "fixed"),
    ("svm-wafer", "jnp", "variable"),
    ("kmeans-traffic", "jnp", "fixed"),
    ("kmeans-traffic", "jnp", "variable"),
    ("kmeans-traffic", "pallas", "fixed"),
    ("kmeans-traffic", "pallas", "variable"),
])
def test_program_matches_reference(fixtures, arch, impl, cost_model,
                                   request):
    jf, tf = fixtures[arch, impl]
    ref = (JaxSession(_cfg(jf, cost_model), metric_name=jf["metric"],
                      lr=jf["lr"])
           .with_executor(jf["executor"], init_params=jf["init_params"],
                          n_samples=jf["n_samples"])
           .run_sync_ingraph(max_rounds=MAX_ROUNDS))
    cfg = _cfg(tf, cost_model)
    draws = jax_round_draws(cfg.seed + 17, MAX_ROUNDS, cfg.max_interval,
                            EDGES, cfg.max_interval, tf["executor"].batch)
    init = jax.tree.map(np.asarray, jf["init_params"])
    seen = []
    port = (ELSession(cfg, metric_name=tf["metric"], lr=tf["lr"])
            .with_executor(tf["executor"],
                           init_params=params_from_numpy(init, "cpu"),
                           n_samples=tf["n_samples"])
            .on_round(seen.append)
            .run_sync_ingraph(max_rounds=MAX_ROUNDS,
                              draws=ReplayDraws(*draws)))
    margin, arms = _replay_margins(port.records, draws, cfg)
    request.node.user_properties.append(("min_top2_margin", margin))
    print(f"smallest top-2 margin of logits + g: {margin}")
    intervals = [r.interval for r in port.records]
    assert arms == [i - 1 for i in intervals]
    assert intervals == [r.interval for r in ref.records], \
        f"smallest top-2 margin of logits + g: {margin}"
    assert len(ref.records) > 12             # past the initialization phase
    assert port.n_aggregations == ref.n_aggregations
    assert port.arm_pulls == ref.arm_pulls
    assert port.terminated_reason == ref.terminated_reason
    assert (port.mode, port.policy) == (ref.mode, ref.policy)
    assert seen == port.records
    consumed = np.float32([r.total_consumed for r in port.records])
    wall = np.float32([r.wall_time for r in port.records])
    want_c = np.float32([r.total_consumed for r in ref.records])
    want_w = np.float32([r.wall_time for r in ref.records])
    if cost_model == "fixed":
        np.testing.assert_array_equal(consumed, want_c)
        np.testing.assert_array_equal(wall, want_w)
        assert np.float32(port.wall_time) == np.float32(ref.wall_time)
    else:
        np.testing.assert_allclose(consumed, want_c, rtol=1e-6)
        np.testing.assert_allclose(wall, want_w, rtol=1e-6)
    np.testing.assert_allclose([r.metric for r in port.records],
                               [r.metric for r in ref.records], atol=1e-5)
    np.testing.assert_allclose([r.utility for r in port.records],
                               [r.utility for r in ref.records], atol=1e-5)
    if arch == "svm-wafer" and cost_model == "fixed":
        # the eval gain rounded once, as XLA fuses the accuracy's
        # multiply into the subtraction: the same bits
        np.testing.assert_array_equal(
            np.float32([r.utility for r in port.records]),
            np.float32([r.utility for r in ref.records]))
    for k, v in ref.final_params.items():
        np.testing.assert_allclose(port.final_params[k].numpy(),
                                   np.asarray(v), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port.final_metric, ref.final_metric,
                               atol=1e-5)


# -- the device loop ------------------------------------------------------------


def _session(fx, **kw):
    cfg = dataclasses.replace(fx["exp"].ol4el, mode="sync", n_edges=EDGES,
                              budget=1500.0, utility=fx["utility"],
                              heterogeneity=2.0, **kw)
    return (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
            .with_executor(fx["executor"], init_params=fx["init_params"],
                           n_samples=fx["n_samples"]))


def _numpy_draws(seed, rounds, cfg, batch):
    rng = np.random.default_rng(seed)
    k = cfg.max_interval
    return ReplayDraws(rng.gumbel(size=(rounds, k)),
                       rng.uniform(size=(rounds, EDGES, k, batch)),
                       rng.standard_normal((rounds, EDGES)))


@pytest.mark.parametrize("arch", ["svm-wafer", "kmeans-traffic"])
def test_chunk_length_does_not_change_the_run(fixtures, arch):
    """Masked rounds past the end leave the carry alone, so chunks of 3
    rounds and of 16 give the same run bit for bit."""
    _, tf = fixtures[arch, "jnp"]
    cfg = _session(tf).cfg
    ex = tf["executor"]
    runs = []
    for r in (3, 16):
        prog = ingraph.make_sync_program(
            ex.model, ex.edge_data, ex.eval_set, cfg, lr=ex.lr,
            batch=ex.batch, n_samples=tf["n_samples"], max_rounds=40,
            device="cpu", rounds_per_chunk=r)
        params, out = prog(tf["init_params"], ingraph.sync_knobs(cfg),
                           _numpy_draws(0, 40, cfg, ex.batch))
        runs.append((params, out, prog.last_run))
    (p3, o3, l3), (p16, o16, l16) = runs
    assert int(o3["n_rounds"]) > 3
    for k in o3:
        np.testing.assert_array_equal(o3[k], o16[k])
    for k in p3:
        assert torch.equal(p3[k], p16[k])
    # the flag drops in the chunk that ran the last round
    assert l3["chunks"] == -(-int(o3["n_rounds"]) // 3)
    assert l16["chunks"] == -(-int(o3["n_rounds"]) // 16)


def test_masked_round_leaves_every_carry_entry_unchanged(fixtures):
    _, tf = fixtures["svm-wafer", "jnp"]
    cfg = _session(tf).cfg
    ex = tf["executor"]
    prog = ingraph.make_sync_program(
        ex.model, ex.edge_data, ex.eval_set, cfg, lr=ex.lr, batch=ex.batch,
        max_rounds=64, device="cpu", rounds_per_chunk=8)
    prog(tf["init_params"], ingraph.sync_knobs(cfg),
         _numpy_draws(1, 64, cfg, ex.batch))
    assert not bool(prog.flag)               # the run ended on its budget
    before = {k: v.clone() for k, v in _flat(prog.carry).items()}
    prog.draw_bufs["gumbel"].fill_(3.0)
    prog._step()                             # eight more, all masked
    after = _flat(prog.carry)
    for k, v in before.items():              # bits: hist["metric"] has NaN
        assert v.dtype == after[k].dtype
        bits = {torch.float32: torch.int32}.get(v.dtype, v.dtype)
        assert torch.equal(v.view(bits), after[k].view(bits)), k


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_horizon_ends_the_run_on_max_rounds(fixtures):
    _, tf = fixtures["kmeans-traffic", "jnp"]
    rep = _session(tf).run_sync_ingraph(max_rounds=5)
    assert rep.n_aggregations == 5 and rep.terminated_reason == "max_rounds"
    assert rep.telemetry["device_loop"]["chunks"] == 1


def test_torch_draws_are_seeded_by_the_config(fixtures):
    _, tf = fixtures["svm-wafer", "jnp"]
    a = _session(tf).run_sync_ingraph()
    b = _session(tf).run_sync_ingraph()
    c = _session(tf, seed=4).run_sync_ingraph()
    assert [r.interval for r in a.records] == [r.interval for r in b.records]
    assert [r.interval for r in a.records] != [r.interval for r in c.records]
    assert a.terminated_reason == "budget_exhausted"
    assert 0.5 < a.final_metric <= 1.0


def test_torch_draws_fill_every_buffer():
    bufs = {"gumbel": torch.zeros(4, 6), "uniform": torch.zeros(4, 2, 3, 5),
            "normal": torch.zeros(4, 2)}
    TorchDraws(torch.Generator().manual_seed(0)).fill(bufs, 0)
    assert bool((bufs["uniform"] >= 0).all() & (bufs["uniform"] < 1).all())
    assert float(bufs["normal"].abs().sum()) > 0
    assert bool(torch.isfinite(bufs["gumbel"]).all())
    replay = ReplayDraws(np.ones((5, 6)), np.ones((5, 2, 3, 5)),
                         np.ones((5, 2)))
    replay.fill(bufs, 4)                     # round 4, then past the end
    assert bool((bufs["gumbel"][0] == 1).all())
    assert bool((bufs["gumbel"][1:] == 0).all())
    with pytest.raises(ValueError, match="rounds are"):
        replay.fill({**bufs, "normal": torch.zeros(4, 3)}, 0)


# -- the support check and the program cache -----------------------------------


def test_ingraph_rejects_unsupported_configs(fixtures):
    _, tf = fixtures["svm-wafer", "jnp"]
    with pytest.raises(ValueError, match="policy='greedy'"):
        _session(tf, policy="greedy").run_sync_ingraph()
    with pytest.raises(ValueError, match="cost_model"):
        _session(tf, cost_model="bogus").run_sync_ingraph()
    # the reference's messages on the same configs (their first line; the
    # menu below it names each package's own modules)
    for kw, exc in (({"policy": "task_alloc"}, ValueError),
                    ({"scenario": object()}, TypeError)):
        with pytest.raises(exc) as got:
            _session(tf, **kw).run_sync_ingraph()
        with pytest.raises(exc) as want:
            jax_ingraph.check_ingraph_support(
                dataclasses.replace(_cfg(jf_of(fixtures), "fixed"),
                                    budget=1500.0, **kw),
                jf_of(fixtures)["executor"], caller="run_sync_ingraph")
        assert str(got.value).split("\n")[0].replace("repro_torch.", "repro.") \
            == str(want.value).split("\n")[0]

    class NotInGraph:
        def local_train(self, params, edge, n_iters, seed):
            return params, {}

        def evaluate(self, params):
            return {"accuracy": 0.0}

    s = ELSession(OL4ELConfig(mode="sync")).with_executor(
        NotInGraph(), init_params={})
    with pytest.raises(TypeError, match="in-graph"):
        s.run_sync_ingraph()


@pytest.mark.parametrize("kw,item", [({"mesh": object()}, "item 14"),
                                     ({"donate": True}, "item 14"),
                                     ({"telemetry": True}, "item 12"),
                                     ({"profile": True}, "item 12"),
                                     ({"contract": True}, "item 12")])
def test_unported_options_name_their_items(fixtures, kw, item):
    """``mesh=`` / ``donate=`` (item 14) raise; the rings and the program
    profiles (item 12) run and attach what the reference's attach: the
    rings under ``report.telemetry["rings"]`` with the reference's field
    names, a profile with no collectives and nothing aliased."""
    from repro.obs import prof as jax_prof
    from repro.obs import rings as jax_rings
    _, tf = fixtures["svm-wafer", "jnp"]
    if item == "item 14":
        with pytest.raises(NotImplementedError, match=item):
            _session(tf).run_sync_ingraph(**kw)
        return
    off = _session(tf).run_sync_ingraph()
    rep = _session(tf).run_sync_ingraph(**kw)
    assert [r.interval for r in rep.records] == \
        [r.interval for r in off.records]
    if "telemetry" in kw:
        rings = rep.telemetry["rings"]
        assert set(rings) == {"arm", *jax_rings._SYNC_FLOATS, "arm_counts",
                              "arm_utility", "head", "ring_size"}
        assert int(rings["head"]) == rep.n_aggregations
        assert int(rings["ring_size"]) == jax_rings.DEFAULT_RING
        assert "profile" not in rep.telemetry
    else:
        prof = rep.telemetry["profile"]
        assert set(prof) == {f.name for f in dataclasses.fields(
            jax_prof.ProgramProfile)}
        assert prof["collectives"] == {} and prof["alias_bytes"] == 0
        assert "rings" not in rep.telemetry


def jf_of(fixtures):
    return fixtures["svm-wafer", "jnp"][0]


def test_ingraph_async_cfg_is_coerced_to_sync(fixtures):
    _, tf = fixtures["svm-wafer", "jnp"]
    s = _session(tf)
    s.cfg = dataclasses.replace(s.cfg, mode="async")
    rep = s.run_sync_ingraph()
    assert rep.mode == "sync" and rep.n_aggregations > 0


def test_ingraph_modes_match_reference_registry():
    from repro.el import policies as jax_policies
    for name in t_policies.available():
        assert t_policies.ingraph_modes(name) == \
            jax_policies.ingraph_modes(name)
    assert t_policies.ingraph_modes("nope") == ()
    assert ingraph.KNOB_NAMES == jax_ingraph.KNOB_NAMES


def test_knobs_match_reference():
    from repro.config import OL4ELConfig as JaxCfg
    for kw in ({}, {"heterogeneity": 3.0, "cost_model": "variable",
                    "cost_noise": 0.3, "n_edges": 5, "budget": 777.0}):
        want = jax_ingraph.sync_knobs(JaxCfg(**kw))
        got = ingraph.sync_knobs(OL4ELConfig(**kw))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert np.asarray(got[k]).dtype == np.float32


def test_pad_edge_data_matches_reference(fixtures):
    jf, tf = fixtures["svm-wafer", "jnp"]
    want = jax_ingraph._pad_edge_data(jf["executor"].edge_data)
    got = ingraph._pad_edge_data(tf["executor"].edge_data, "cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ingraph_recompiles_when_session_reconfigured(fixtures):
    """A change of the aggregation weights needs a new program."""
    _, tf = fixtures["svm-wafer", "jnp"]
    s = _session(tf)
    s.run_sync_ingraph()
    prog1 = s._fastpath
    s._n_samples = np.asarray([10.0, 1.0, 1.0])
    s.run_sync_ingraph()
    assert s._fastpath is not prog1
    assert s.compile_cache.stats()["misses"] == 2


def test_ingraph_honors_injected_ol4el_policy_ucb_c(fixtures):
    _, tf = fixtures["svm-wafer", "jnp"]
    pol = t_policies.get("ol4el", ucb_c=0.25)
    s = _session(tf).with_policy(pol)
    assert s._ingraph_cfg("test").ucb_c == 0.25
    assert s.run_sync_ingraph().n_aggregations > 0


def test_ingraph_program_reused_across_knob_changes(fixtures):
    """ucb_c / budget / heterogeneity / seed are inputs of the program:
    changing them reuses it (and, on a card, its captured graph)."""
    _, tf = fixtures["svm-wafer", "jnp"]
    s = _session(tf)
    r1 = s.run_sync_ingraph()
    prog = s._fastpath
    s.cfg = dataclasses.replace(s.cfg, ucb_c=0.5, budget=2300.0, seed=5)
    r2 = s.run_sync_ingraph()
    assert s._fastpath is prog
    stats = r2.telemetry["cache"]
    assert (stats["entries"], stats["hits"], stats["misses"]) == (1, 1, 1)
    assert r2.n_aggregations > 0
    assert r2.total_consumed != r1.total_consumed


def test_compile_cache_clear_close_and_eviction(fixtures):
    _, tf = fixtures["svm-wafer", "jnp"]
    s = _session(tf)
    s.run_sync_ingraph()
    s.run_sync_ingraph(max_rounds=64)
    assert len(s.compile_cache) == 2 and isinstance(s.compile_cache,
                                                    ProgramCache)
    assert s.clear_compile_cache() == 2
    assert len(s.compile_cache) == 0 and s._fastpath is None
    s.run_sync_ingraph()                     # still usable: rebuilds
    assert len(s.compile_cache) == 1
    s.close()
    s.close()                                # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        s.run_sync_ingraph()
    cache = ProgramCache(max_entries=2)
    for i in range(3):
        cache.put(("k", i), i)
    assert list(cache) == [("k", 1), ("k", 2)] and cache.evictions == 1
    assert cache.get(("k", 0)) is None and cache.get(("k", 2)) == 2
    assert (cache.hits, cache.misses) == (1, 1)
