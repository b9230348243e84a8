"""The port's aggregation, utility and ClassicExecutor vs the reference."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import utility as jax_utility  # noqa: E402
from repro.federated import aggregation as jax_agg  # noqa: E402
from repro.launch.classic import classic_fixture as jax_fixture  # noqa: E402
from repro_torch.core import utility as t_utility  # noqa: E402
from repro_torch.federated import aggregation as t_agg  # noqa: E402
from repro_torch.interop import params_from_numpy, \
    params_to_numpy  # noqa: E402
from repro_torch.launch.classic import classic_fixture as t_fixture  # noqa: E402


def _trees(n, seed):
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((7, 5)).astype(np.float32),
             "b": rng.standard_normal(5).astype(np.float32)}
            for _ in range(n)]


def _to_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(port, ref, tol=1e-6):
    assert port.keys() == ref.keys()
    for k in ref:
        assert port[k].dtype == torch.float32
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("weights", [[1.0, 1.0, 1.0], [120, 37, 999],
                                     [0.2, 0.5, 0.3, 0.0]])
def test_weighted_average_matches_reference(weights):
    trees = _trees(len(weights), seed=len(weights))
    ref = jax_agg.weighted_average([_to_jax(t) for t in trees], weights)
    port = t_agg.weighted_average([params_from_numpy(t, "cpu")
                                   for t in trees], weights)
    _close(port, ref)


@pytest.mark.parametrize("alpha", [0.5, 0.5 / 1.75, 0.0, 1.0])
def test_staleness_mix_matches_reference(alpha):
    g, e = _trees(2, seed=11)
    ref = jax_agg.staleness_mix(_to_jax(g), _to_jax(e), alpha)
    port = t_agg.staleness_mix(params_from_numpy(g, "cpu"),
                               params_from_numpy(e, "cpu"), alpha)
    _close(port, ref)


@pytest.mark.parametrize("base,staleness", [(0.5, 0.0), (0.6, 0.75),
                                            (0.3, -1.0), (0.5, 12.25)])
def test_staleness_alpha_equal(base, staleness):
    assert t_agg.staleness_alpha(base, staleness) == \
        jax_agg.staleness_alpha(base, staleness)


def test_param_l2_delta_and_utility_match_reference():
    a, b = _trees(2, seed=5)
    ref = jax_utility.param_l2_delta(_to_jax(a), _to_jax(b))
    port = t_utility.param_l2_delta(params_from_numpy(a, "cpu"),
                                    params_from_numpy(b, "cpu"))
    np.testing.assert_allclose(port, ref, rtol=1e-6)
    snap = lambda p, m: {"params": p, "metric": m, "loss": -m}  # noqa: E731
    for kind in ("param_delta", "eval_gain", "loss_delta"):
        u_ref = jax_utility.UtilityEstimator(kind)(
            snap(_to_jax(a), 0.25), snap(_to_jax(b), 0.5))
        u_port = t_utility.UtilityEstimator(kind)(
            snap(params_from_numpy(a, "cpu"), 0.25),
            snap(params_from_numpy(b, "cpu"), 0.5))
        np.testing.assert_allclose(u_port, u_ref, rtol=1e-6)


def _nested(n, seed):
    """LM-shaped trees: stacked groups, nested dicts, keys out of order."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return [{"groups": {"sub0": {"mix": {"wq": leaf(2, 6, 4),
                                         "norm": leaf(2, 6)},
                                 "ffn": {"wo": leaf(2, 5, 6)}}},
             "embed": leaf(9, 6), "final_norm": leaf(6)} for _ in range(n)]


@pytest.mark.parametrize("op", ["weighted_average", "staleness_mix",
                                "param_l2_delta"])
def test_nested_trees_match_reference(op):
    """The LM executor's parameters are nested trees; the reference takes
    any pytree (``jax.tree.map`` / ``jax.tree.leaves``, keys sorted)."""
    trees = _nested(3, seed=21)
    jt = [jax.tree.map(jnp.asarray, t) for t in trees]
    tt = [params_from_numpy(t, "cpu") for t in trees]
    if op == "param_l2_delta":
        np.testing.assert_allclose(t_utility.param_l2_delta(tt[0], tt[1]),
                                   jax_utility.param_l2_delta(jt[0], jt[1]),
                                   rtol=1e-6)
        return
    if op == "weighted_average":
        want = jax_agg.weighted_average(jt, [3.0, 1.0, 0.5])
        got = t_agg.weighted_average(tt, [3.0, 1.0, 0.5])
    else:
        want = jax_agg.staleness_mix(jt[0], jt[1], 0.3)
        got = t_agg.staleness_mix(tt[0], tt[1], 0.3)
    got_np = params_to_numpy(got)
    assert jax.tree.structure(got_np) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got_np), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.fixture(scope="module", params=["svm-wafer", "kmeans-traffic"])
def fixtures(request):
    arch = request.param
    jf = jax_fixture(arch, samples=1200, n_edges=3)
    tf = t_fixture(arch, samples=1200, n_edges=3, device="cpu")
    return arch, jf, tf


def test_fixture_recipe_matches_reference(fixtures):
    arch, jf, tf = fixtures
    for key in ("metric", "lr", "utility", "n_samples"):
        assert tf[key] == jf[key], key
    assert tf["executor"].batch == jf["executor"].batch
    if arch == "kmeans-traffic":               # the CPU picks the plain E-step
        assert tf["model"].impl == "torch"


@pytest.mark.parametrize("edge,n_iters,seed", [(0, 3, 123), (2, 7, 2 ** 30)])
def test_sample_batches_select_same_rows(fixtures, edge, n_iters, seed):
    _, jf, tf = fixtures
    xs_ref, ys_ref = jf["executor"].sample_batches(edge, n_iters, seed)
    xs, ys = tf["executor"].sample_batches(edge, n_iters, seed)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(xs_ref))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(ys_ref))


def test_local_train_matches_reference(fixtures):
    arch, jf, tf = fixtures
    init = jax.tree.map(np.asarray, jf["init_params"])
    if arch == "svm-wafer":                    # start off the zero model
        init = {k: v + 0.05 for k, v in init.items()}
    p_ref, _ = jf["executor"].local_train(
        {k: jnp.asarray(v) for k, v in init.items()}, 1, 5, 77)
    p_port, info = tf["executor"].local_train(
        params_from_numpy(init, "cpu"), 1, 5, 77)
    assert info == {}
    for k in p_ref:
        np.testing.assert_allclose(p_port[k].numpy(), np.asarray(p_ref[k]),
                                   rtol=1e-5, atol=1e-6)
    assert tf["executor"].evaluate(p_port) == pytest.approx(
        jf["executor"].evaluate(p_ref), rel=1e-5)
