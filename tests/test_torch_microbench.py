"""The port's microbenchmarks (``repro_torch.bench.microbench``) vs the
reference's (``benchmarks/microbench.py``), and the deprecated
``ELSimulator`` shim (``repro_torch.federated.simulator``), on the CPU.

A timing says nothing here; what must hold is the row contract (the
reference's names in its order, finite numbers) and that each row times
the reference's computation: the same aggregation, blocked attention and
E-step on the same numpy inputs, and the reference's EL fixture, whose
host runs from the reference's init make the reference's decisions.
"""

import ast
import dataclasses
import math
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro.config import get_config as jax_get_config  # noqa: E402
from repro.data import make_wafer_dataset as jax_wafer  # noqa: E402
from repro.data import partition_edges as jax_partition  # noqa: E402
from repro.el import ELSession as JaxSession  # noqa: E402
from repro.federated import ClassicExecutor as JaxExecutor  # noqa: E402
from repro.federated import weighted_average as jax_weighted_average  # noqa: E402,E501
from repro.kernels.kmeans_assign.ref import assign_ref as jax_assign_ref  # noqa: E402,E501
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_L  # noqa: E402
from repro_torch.bench import microbench  # noqa: E402
from repro_torch.config import ModelConfig  # noqa: E402
from repro_torch.el import ELSession  # noqa: E402
from repro_torch.federated import ELSimulator, SimResult  # noqa: E402
from repro_torch.federated import weighted_average  # noqa: E402
from repro_torch.interop import tree_from_numpy  # noqa: E402
from repro_torch.kernels.kmeans_assign import ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def reference_row_names():
    """The ``name=`` of every row ``benchmarks/microbench.py``'s ``run``
    appends, in source order."""
    with open(os.path.join(ROOT, "benchmarks", "microbench.py")) as f:
        tree = ast.parse(f.read())
    run = next(n for n in tree.body
               if isinstance(n, ast.FunctionDef) and n.name == "run")
    names = []
    for node in ast.walk(run):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") \
                == "dict":
            for kw in node.keywords:
                if kw.arg == "name" and isinstance(kw.value, ast.Constant):
                    names.append((kw.value.lineno, kw.value.value))
    return [name for _, name in sorted(names)]


@pytest.fixture(scope="module")
def cpu_rows():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return microbench.run(quiet=True, device="cpu")
    finally:
        torch.set_num_threads(n)


def test_rows_are_the_references_in_order(cpu_rows):
    want = reference_row_names()
    assert len(want) == 11
    # the kernel row joins on a CUDA device only
    assert [r["name"] for r in cpu_rows] == want
    for r in cpu_rows:
        assert set(r) == {"name", "us_per_call", "derived"}, r["name"]
        assert math.isfinite(r["us_per_call"]) and r["us_per_call"] >= 0
    derived = {r["name"]: r["derived"] for r in cpu_rows}
    assert derived["el_sync_ingraph_per_round"].startswith("acc=")
    assert "x_vs_seq_host" in derived["el_sweep_vmapped_4cells"]


def test_sharded_rows_name_item_14(monkeypatch):
    """``--sharded``, once item 14's refusal: the reference's four donated
    and mesh-sharded rows after the sweep's, from one ``bench_el`` run
    (here at ``bench_check --smoke``'s sizes, on the CPU)."""
    monkeypatch.setattr(microbench, "SHARDED_BENCH", [
        "--skip-host", "--repeats", "1", "--edges", "4", "--samples", "512",
        "--batch", "64", "--budget", "300", "--max-rounds", "16",
        "--max-events", "64"])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rows = microbench.run(quiet=True, sharded=True, device="cpu")
    finally:
        torch.set_num_threads(n)
    names = [r["name"] for r in rows]
    sharded = ["el_sync_ingraph_donate_per_round",
               "el_sync_sharded_per_round",
               "el_sync_sharded_donate_per_round",
               "el_async_sharded_per_event"]
    want = reference_row_names()
    at = want.index("el_sweep_vmapped_4cells") + 1
    assert names == want[:at] + sharded + want[at:]
    derived = {r["name"]: r["derived"] for r in rows}
    assert derived["el_sync_ingraph_donate_per_round"].startswith("donated,")
    assert derived["el_sync_sharded_per_round"].startswith("sharded_2x2,")
    assert "alias=1920B" in derived["el_sync_sharded_donate_per_round"]
    assert "alias=0B" in derived["el_sync_sharded_per_round"]
    assert "x_vs_replicated" in derived["el_async_sharded_per_event"]
    for r in rows:      # the rings' overhead row is clamped at 0
        assert math.isfinite(r["us_per_call"]) and r["us_per_call"] >= 0
        assert r["name"] not in sharded or r["us_per_call"] > 0


def test_kernel_row_needs_a_card():
    """On the CPU there is no kernel row, and the row's helper refuses
    rather than timing the plain version."""
    x, c = microbench.kmeans_inputs("cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        microbench.kmeans_kernel_row(x, c)


def test_device_none_means_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        microbench.run(quiet=True)


def test_aggregation_is_the_references():
    rng = np.random.default_rng(0)
    trees = [{"w": rng.standard_normal((1024, 256)).astype(np.float32)}
             for _ in range(4)]
    w = [1.0, 2.0, 3.0, 4.0]
    got = weighted_average([tree_from_numpy(t, "cpu") for t in trees], w)
    want = jax_weighted_average([jax.tree.map(jnp.asarray, t)
                                 for t in trees], w)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-6, atol=1e-6)


def test_blocked_attention_row_is_the_references():
    """The ``xla_blocked_attention_b1_s512_d256`` row's computation at its
    shape, from the reference's init."""
    kw = dict(d_model=256, n_heads=4, n_kv_heads=4, dtype="float32")
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jp = jax_L.init_attention(jax.random.key(0), jcfg)
    x = np.random.default_rng(1).standard_normal((1, 512, 256)).astype(
        np.float32)
    want = jax_L.attention(jp, jcfg, jnp.asarray(x), jnp.arange(512),
                           impl="blocked")
    with torch.inference_mode():
        got = L.attention(tree_from_numpy(jax.tree.map(np.asarray, jp),
                                          "cpu"),
                          cfg, torch.from_numpy(x), torch.arange(512),
                          impl="blocked")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_estep_row_is_the_references():
    x, c = microbench.kmeans_inputs("cpu")
    assert tuple(x.shape) == (4096, 64) and tuple(c.shape) == (3, 64)
    a, d2 = ref.assign_ref(x, c)
    ja, jd2 = jax_assign_ref(jnp.asarray(x.numpy()), jnp.asarray(c.numpy()))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-5,
                               atol=1e-4)
    want, allowed = ref.allowed_error(x, c)
    assert torch.equal(want, d2)
    assert bool((allowed >= 1e-3).all())


def _ref_el_fixture():
    """``benchmarks/microbench.py:94-108``."""
    train_d, test_d = jax_wafer(n=2000, seed=0)
    exp = jax_get_config("svm-wafer")
    svm = jax_build_model(exp.model)
    ol = dataclasses.replace(exp.ol4el, mode="sync", policy="ol4el",
                             n_edges=3, budget=6000.0, heterogeneity=6.0,
                             utility="eval_gain", seed=0)
    edges = jax_partition(train_d, 3, alpha=1.0, seed=0)
    ex = JaxExecutor(svm, edges, test_d, batch=64, lr=0.05)
    return ol, ex, [len(e["y"]) for e in edges], svm.init(jax.random.key(0))


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_el_fixture_runs_are_the_references(mode):
    """The EL rows' fixture: from the reference's init, the port's host
    loop makes the reference's decisions."""
    jol, jex, jns, jinit = _ref_el_fixture()
    ol, ex, ns = microbench.el_fixture("cpu")
    assert dataclasses.asdict(ol) == dataclasses.asdict(jol)
    assert ns == jns
    init = tree_from_numpy(jax.tree.map(np.asarray, jinit), "cpu")
    jrep = JaxSession(dataclasses.replace(jol, mode=mode),
                      metric_name="accuracy", lr=0.05).with_executor(
        jex, init_params=jinit, n_samples=jns).run()
    rep = ELSession(dataclasses.replace(ol, mode=mode),
                    metric_name="accuracy", lr=0.05).with_executor(
        ex, init_params=init, n_samples=ns).run()
    assert [(r.interval, r.edge) for r in rep.records] == \
        [(r.interval, r.edge) for r in jrep.records]
    assert rep.arm_pulls == jrep.arm_pulls
    assert rep.n_aggregations == jrep.n_aggregations > 0


# -- ELSimulator --------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_simulator_warns_and_runs_the_session(mode):
    ol, ex, ns = microbench.el_fixture("cpu")
    ol = dataclasses.replace(ol, mode=mode, budget=1500.0)
    init = ex.init_params(0)
    with pytest.warns(DeprecationWarning, match="ELSession"):
        sim = ELSimulator(ex, ol, init, n_samples=ns, lr=0.05)
    got = sim.run()
    want = ELSession(ol, metric_name="accuracy", lr=0.05).with_executor(
        ex, init_params=init, n_samples=ns).run()
    assert isinstance(got, SimResult)
    assert [(r.interval, r.edge, r.total_consumed) for r in got.records] == \
        [(r.interval, r.edge, r.total_consumed) for r in want.records]
    assert got.arm_pulls == want.arm_pulls
    assert got.final_metric == want.final_metric


def test_simulator_exposes_the_coordinator_and_both_loops():
    ol, ex, ns = microbench.el_fixture("cpu")
    ol = dataclasses.replace(ol, budget=800.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        sim = ELSimulator(ex, ol, ex.init_params(0), n_samples=ns)
    assert sim.coord is sim.session.coordinator()
    assert sim.run_sync(max_rounds=3).n_aggregations <= 3
    assert sim.run_async(max_events=4).n_aggregations <= 4
