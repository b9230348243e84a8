"""The port's classic workloads vs the JAX reference: configs, data
generators, LinearSVM / KMeans steps and evaluation, cluster F1."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jax_config  # noqa: E402
from repro.data import classic_data as jax_data  # noqa: E402
from repro.models import classic as jax_classic  # noqa: E402
from repro_torch import config as t_config  # noqa: E402
from repro_torch.data import classic_data as t_data  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import classic as t_classic  # noqa: E402

ARCHS = ["svm-wafer", "kmeans-traffic"]


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    ref, port = jax_config.get_config(arch), t_config.get_config(arch)
    assert dataclasses.asdict(port.train) == dataclasses.asdict(ref.train)
    assert dataclasses.asdict(port.ol4el) == dataclasses.asdict(ref.ol4el)
    for f in dataclasses.fields(port.model):
        got, want = getattr(port.model, f.name), getattr(ref.model, f.name)
        if dataclasses.is_dataclass(got):   # MoEConfig / MambaConfig: the
            got, want = (dataclasses.asdict(got),   # packages' own classes
                         dataclasses.asdict(want))
        assert got == want, f.name
    assert port.notes == ref.notes


def test_an_arch_neither_package_has_raises():
    assert "gpt-5" not in jax_config.ARCH_IDS
    with pytest.raises(KeyError, match="unknown arch"):
        t_config.get_config("gpt-5")


def _assert_same_split(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("maker", ["make_wafer_dataset",
                                   "make_traffic_dataset"])
@pytest.mark.parametrize("seed", [0, 5])
def test_datasets_bit_equal(maker, seed):
    ref = getattr(jax_data, maker)(n=1500, seed=seed)
    port = getattr(t_data, maker)(n=1500, seed=seed)
    for r, p in zip(ref, port):
        _assert_same_split(r, p)


@pytest.mark.parametrize("n_edges,alpha", [(3, 100.0), (4, 0.3)])
def test_partition_edges_bit_equal(n_edges, alpha):
    train, _ = jax_data.make_wafer_dataset(n=1200, seed=1)
    ref = jax_data.partition_edges(train, n_edges, alpha=alpha, seed=2)
    port = t_data.partition_edges(train, n_edges, alpha=alpha, seed=2)
    assert len(ref) == len(port) == n_edges
    for r, p in zip(ref, port):
        _assert_same_split(r, p)


def _models(arch):
    ref_model = jax_classic.LinearSVM(jax_config.get_config(arch).model) \
        if arch == "svm-wafer" else \
        jax_classic.KMeans(jax_config.get_config(arch).model)
    port_model = build_model(t_config.get_config(arch).model, device="cpu")
    return ref_model, port_model


def _start_params(arch, rng):
    """Non-trivial starting params, made in numpy for both sides."""
    if arch == "svm-wafer":
        return {"w": (0.1 * rng.standard_normal((59, 8))).astype(np.float32),
                "b": (0.1 * rng.standard_normal(8)).astype(np.float32)}
    return {"centers": rng.standard_normal((3, 64)).astype(np.float32)}


def _data(arch):
    maker = (jax_data.make_wafer_dataset if arch == "svm-wafer"
             else jax_data.make_traffic_dataset)
    return maker(n=1000, seed=3)


@pytest.mark.parametrize("arch,lr", [("svm-wafer", 0.05),
                                     ("kmeans-traffic", 1.0),
                                     ("kmeans-traffic", 0.3)])
def test_local_step_matches_reference(arch, lr):
    ref_model, port_model = _models(arch)
    rng = np.random.default_rng(0)
    start = _start_params(arch, rng)
    train, _ = _data(arch)
    p_ref = {k: jnp.asarray(v) for k, v in start.items()}
    p_port = params_from_numpy(start, "cpu")
    step_ref = jax.jit(lambda p, b: ref_model.local_step(p, b, lr))
    for _ in range(4):
        idx = rng.integers(0, len(train["y"]), size=64)
        x, y = train["x"][idx], train["y"][idx]
        p_ref, m_ref = step_ref(p_ref, {"x": jnp.asarray(x),
                                        "y": jnp.asarray(y)})
        p_port, m_port = port_model.local_step(
            p_port, {"x": torch.tensor(x), "y": torch.tensor(y)}, lr)
        for k in p_ref:
            np.testing.assert_allclose(p_port[k].numpy(),
                                       np.asarray(p_ref[k]),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(m_port["loss"]),
                                   float(m_ref["loss"]), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_is_local_step_without_metrics(arch):
    _, model = _models(arch)
    start = params_from_numpy(_start_params(arch, np.random.default_rng(1)),
                              "cpu")
    train, _ = _data(arch)
    batch = {k: torch.tensor(v[:64]) for k, v in train.items()}
    stepped = model.step(start, batch, 0.5)
    full, metrics = model.local_step(start, batch, 0.5)
    assert stepped.keys() == full.keys() and "loss" in metrics
    for k in full:
        assert torch.equal(stepped[k], full[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_evaluate_matches_reference(arch):
    ref_model, port_model = _models(arch)
    start = _start_params(arch, np.random.default_rng(4))
    _, test = _data(arch)
    m_ref = ref_model.evaluate({k: jnp.asarray(v) for k, v in start.items()},
                               {k: jnp.asarray(v) for k, v in test.items()})
    m_port = port_model.evaluate(params_from_numpy(start, "cpu"),
                                 {k: torch.tensor(v) for k, v in test.items()})
    assert m_port.keys() == m_ref.keys()
    if arch == "svm-wafer":
        assert m_port["accuracy"] == m_ref["accuracy"]
    else:
        assert m_port["f1"] == m_ref["f1"]
        np.testing.assert_allclose(m_port["inertia"], m_ref["inertia"],
                                   rtol=1e-5)


@pytest.mark.parametrize("k,n_classes", [(3, 3), (5, 3), (3, 8)])
def test_cluster_f1_equal(k, n_classes):
    rng = np.random.default_rng(k * 10 + n_classes)
    labels = rng.integers(0, n_classes, size=700)
    assign = np.where(rng.random(700) < 0.7, labels % k,
                      rng.integers(0, k, size=700))
    assert t_classic.cluster_f1(assign, labels, k) == \
        jax_classic.cluster_f1(assign, labels, k)


def test_kmeans_init_is_seeded_and_device_independent():
    _, model = _models("kmeans-traffic")
    a = model.init(torch.Generator().manual_seed(7))["centers"]
    b = model.init(torch.Generator().manual_seed(7))["centers"]
    c = model.init(torch.Generator().manual_seed(8))["centers"]
    assert a.shape == (3, 64) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_params_round_trip_through_numpy():
    start = _start_params("svm-wafer", np.random.default_rng(2))
    back = params_to_numpy(params_from_numpy(start, "cpu"))
    for k in start:
        np.testing.assert_array_equal(back[k], start[k])
