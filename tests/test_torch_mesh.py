"""Several ranks on the CPU: the port's meshes (``repro_torch.launch.mesh``),
its rank spawner (``repro_torch.launch.hostdev``), the sharded and donated
sync run (``ELSession.run_sync_ingraph(mesh=, donate=)``), the collective
census and ``local_sgd.make_el_round`` over ranks.

Two gloo worlds are spawned once for the whole file, concurrently: one of
2 ranks (a 2 x 1 (data, model) mesh) and one of 4 (the 2 x 2 debug mesh;
its ``model`` axis replicates the classic models' parameters, as the
reference's resolver does).  Every rank of each runs every scenario
(``tests/torch_mesh_worker.py``, which imports the port only) on the
reference's ``jax.random`` draws replayed through the RNG seam.  Each
rank's run must be bit for bit the unsharded port run (records, final
params) and make the reference's decisions (intervals, arm pulls,
rounds, termination; ``consumed`` / ``wall`` bit-equal at fixed cost);
its donated twin must give the same records with the params aliased; its
census must show at least one all-gather and no all-reduce; and the
sharded OL4EL round must equal one rank's, bit for bit.

The ``model`` axis: in the same worlds, a (1, 2) mesh of the 2 ranks and
the (2, 2) mesh of the 4 split each edge's model (qwen3-1.7b dense,
olmoe-1b-7b MoE with its experts split, mamba2-370m; smoke widths, f32,
AdamW, remat on): a ``make_el_round`` round and two ``make_el_program``
rounds, after which every rank's gathered params and moments are bit for
bit the unsharded port run's, its losses equal, and its blocks the shapes
``el_state_specs`` names (held spec for spec against the reference's).
"""

import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys
import threading
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_ingraph import jax_round_draws  # noqa: E402
from test_torch_sharding import _assert_same_specs  # noqa: E402
from torch_mesh_worker import model_axis  # noqa: E402

from repro import config as ref_config  # noqa: E402
from repro.el import ELSession as JaxSession  # noqa: E402
from repro.federated import local_sgd as ref_local_sgd  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.launch.classic import classic_fixture as jax_fixture  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.el import ELSession  # noqa: E402
from repro_torch.el.rng import ReplayDraws  # noqa: E402
from repro_torch.federated import local_sgd  # noqa: E402
from repro_torch.interop import params_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.launch import hostdev  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.launch.classic import classic_fixture  # noqa: E402
from repro_torch.models import LM  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_mesh_worker.py"
SAMPLES, EDGES, BUDGET, MAX_ROUNDS = 1000, 4, 2500.0, 64
ARCHS = ("svm-wafer", "kmeans-traffic")
WORLDS = {2: ((2, 1), ("data", "model")), 4: ((2, 2), ("data", "model"))}
LM_CASE = {"arch": "qwen3-1.7b", "edges": 4, "h_max": 2, "mode": "sync",
           "seed": 7, "intervals": [[1, 2, 2, 1], [2, 1, 1, 2]],
           "weights": [1.0, 2.0, 0.5, 1.5],
           "train": dict(optimizer="sgd", peak_lr=0.05, momentum=0.9,
                         warmup_steps=2)}
#: the model axis: each world's (data, model) mesh, and the families
MODEL_MESHES = {2: ((1, 2), ("data", "model")),
                4: ((2, 2), ("data", "model"))}
MODEL_ARCHS = ("qwen3-1.7b", "olmoe-1b-7b", "mamba2-370m")
MODEL_EDGES, MODEL_H_MAX, MODEL_ROUNDS = 2, 2, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(rep):
    return [(r.interval, r.n_aggregations, r.total_consumed, r.wall_time,
             r.metric, r.utility) for r in rep.records]


@pytest.fixture(scope="module")
def cases():
    """Per arch: the worker's case (fixture sizes, config, the
    reference's init as numpy, its draws), the reference's report and the
    unsharded port run's."""
    out = {}
    for arch in ARCHS:
        jf = jax_fixture(arch, samples=SAMPLES, n_edges=EDGES,
                         kmeans_impl="jnp")
        tf = classic_fixture(arch, samples=SAMPLES, n_edges=EDGES,
                             device="cpu")
        cfg_kw = dict(mode="sync", n_edges=EDGES, budget=BUDGET,
                      utility=tf["utility"], heterogeneity=2.0,
                      cost_model="fixed")
        cfg = dataclasses.replace(tf["exp"].ol4el, **cfg_kw)
        draws = jax_round_draws(cfg.seed + 17, MAX_ROUNDS, cfg.max_interval,
                                EDGES, cfg.max_interval,
                                tf["executor"].batch)
        init = jax.tree.map(np.asarray, jf["init_params"])
        ref = (JaxSession(dataclasses.replace(jf["exp"].ol4el, **cfg_kw),
                          metric_name=jf["metric"], lr=jf["lr"])
               .with_executor(jf["executor"], init_params=jf["init_params"],
                              n_samples=jf["n_samples"])
               .run_sync_ingraph(max_rounds=MAX_ROUNDS))
        port = (ELSession(cfg, metric_name=tf["metric"], lr=tf["lr"])
                .with_executor(tf["executor"],
                               init_params=params_from_numpy(init, "cpu"),
                               n_samples=tf["n_samples"])
                .run_sync_ingraph(max_rounds=MAX_ROUNDS,
                                  draws=ReplayDraws(*draws), contract=True))
        out[arch] = ({"name": arch, "arch": arch, "samples": SAMPLES,
                      "edges": EDGES, "cfg": cfg_kw, "init": init,
                      "draws": draws, "max_rounds": MAX_ROUNDS}, ref, port)
    return out


def _lm_tokens():
    vocab = get_smoke_config(LM_CASE["arch"]).model.vocab_size
    return np.random.default_rng(0).integers(
        0, vocab, (2, LM_CASE["edges"], LM_CASE["h_max"], 2, 16), np.int32)


def _model_cfgs(arch):
    """The smoke config at f32 with remat on, and its AdamW train config."""
    exp = get_smoke_config(arch)
    return (dataclasses.replace(exp.model, dtype="float32", remat=True),
            dataclasses.replace(exp.train, warmup_steps=2))


@pytest.fixture(scope="module")
def model_cases():
    """Per arch: a round's intervals and weights, tokens [rounds, E, h_max,
    B, S] (the round's, then the program's), the program's costs and
    budgets and its Gumbel draws [rounds, E, h_max]."""
    rng = np.random.default_rng(1)
    out = {}
    for arch in MODEL_ARCHS:
        model_cfg, train_cfg = _model_cfgs(arch)
        out[arch] = {
            "arch": arch, "model_cfg": model_cfg, "train_cfg": train_cfg,
            "edges": MODEL_EDGES, "h_max": MODEL_H_MAX, "seed": 3,
            "intervals": [2, 1], "weights": [1.0, 3.0],
            "tokens": rng.integers(0, model_cfg.vocab_size, (
                MODEL_ROUNDS, MODEL_EDGES, MODEL_H_MAX, 2, 16), np.int32),
            "comp": [40.0, 60.0], "comm": [50.0, 50.0],
            "budgets": [400.0, 400.0],
            "gumbel": rng.gumbel(size=(MODEL_ROUNDS - 1, MODEL_EDGES,
                                       MODEL_H_MAX)).astype(np.float32)}
    return out


@pytest.fixture(scope="module")
def worlds(cases, model_cases, tmp_path_factory):
    """Each world's per-rank results, both worlds spawned at once."""
    lm = dict(LM_CASE, tokens=_lm_tokens())
    results, threads = {}, []
    for world, mesh in WORLDS.items():
        d = tmp_path_factory.mktemp(f"world{world}")
        spec = {"mesh": mesh, "classic": [c[0] for c in cases.values()],
                "lm": lm, "model": list(model_cases.values()),
                "model_mesh": MODEL_MESHES[world]}
        with open(d / "spec.pkl", "wb") as f:
            pickle.dump(spec, f)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

        def go(world=world, d=d, env=env):
            results[world] = (d, hostdev.spawn_ranks(
                world, [sys.executable, str(WORKER), str(d / "spec.pkl"),
                        str(d)], env=env, capture=True, timeout=600))
        threads.append(threading.Thread(target=go))
        threads[-1].start()
    for t in threads:
        t.join()
    out = {}
    for world, (d, procs) in results.items():
        for p in procs:
            assert p.returncode == 0, p.stderr[-4000:]
        out[world] = [pickle.load(open(d / f"rank{r}.pkl", "rb"))
                      for r in range(world)]
    return out


@pytest.fixture(scope="module")
def lm_one_rank():
    """The OL4EL round over all four edges on one rank."""
    exp = get_smoke_config(LM_CASE["arch"])
    model = LM(dataclasses.replace(exp.model, dtype="float32"), device="cpu")
    tc = dataclasses.replace(exp.train, **LM_CASE["train"])
    rnd = local_sgd.make_el_round(model, tc, LM_CASE["h_max"],
                                  LM_CASE["mode"])
    state = local_sgd.init_el_state(
        model, tc, LM_CASE["edges"],
        torch.Generator().manual_seed(LM_CASE["seed"]))
    losses = []
    for r, tokens in enumerate(_lm_tokens()):
        state, met = rnd(state, {"tokens": torch.from_numpy(tokens)},
                         torch.tensor(LM_CASE["intervals"][r],
                                      dtype=torch.int32),
                         torch.tensor(LM_CASE["weights"]))
        losses.append(float(met["mean_loss"]))
    return losses, tree_to_numpy(state.params)


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)


GRID = [(w, a) for w in WORLDS for a in ARCHS]


@pytest.mark.parametrize("world,arch", GRID)
def test_sharded_sync_run_is_the_unsharded_run_on_every_rank(
        worlds, cases, world, arch):
    _, _, port = cases[arch]
    for rank, res in enumerate(worlds[world]):
        got = res["classic"][arch]
        assert res["rank"] == rank and res["mesh"] == dict(zip(
            WORLDS[world][1], WORLDS[world][0]))
        np.testing.assert_array_equal(got["records"], _records(port))
        _equal_trees(got["params"], tree_to_numpy(port.final_params))
        assert got["final"] == port.final_metric
        assert (got["n_rounds"], got["arm_pulls"], got["terminated"]) == \
            (port.n_aggregations, list(port.arm_pulls),
             port.terminated_reason)
        loop = got["device_loop"]
        assert loop["graphs_captured"] == 0 and loop["replays"] == 0


@pytest.mark.parametrize("world,arch", GRID)
def test_sharded_sync_run_makes_the_references_decisions(
        worlds, cases, world, arch):
    _, ref, _ = cases[arch]
    assert len(ref.records) > 12
    for res in worlds[world]:
        got = res["classic"][arch]["records"]
        assert [g[0] for g in got] == [r.interval for r in ref.records]
        assert res["classic"][arch]["arm_pulls"] == list(ref.arm_pulls)
        assert res["classic"][arch]["terminated"] == ref.terminated_reason
        np.testing.assert_array_equal(
            np.float32([g[2] for g in got]),
            np.float32([r.total_consumed for r in ref.records]))
        np.testing.assert_array_equal(
            np.float32([g[3] for g in got]),
            np.float32([r.wall_time for r in ref.records]))


@pytest.mark.parametrize("world,arch", GRID)
def test_donated_sharded_run_aliases_the_params(worlds, world, arch):
    for res in worlds[world]:
        got = res["classic"][arch]
        np.testing.assert_array_equal(got["donated_records"],
                                      got["records"])
        _equal_trees(got["donated_params"], got["params"])
        assert got["donated_shares_storage"]
        assert got["donated_alias_bytes"] == got["donated_param_bytes"] > 0
        assert got["alias_bytes"] == 0
        assert "donated" in got["reuse"]


@pytest.mark.parametrize("world,arch", GRID)
def test_census_shows_gather_before_reduce(worlds, cases, world, arch):
    """One chunk of 16 masked rounds: one all-gather of the edge stack a
    round, nothing reduced across ranks; the unsharded run issues none."""
    init = cases[arch][0]["init"]
    row_bytes = sum(v.nbytes for v in init.values())
    for res in worlds[world]:
        got = res["classic"][arch]
        assert set(got["collectives"]) == {"all-gather"}
        assert got["collectives"]["all-gather"]["count"] == 16
        # each rank's [E / 2, ...] share of the f32 edge stack, a round
        assert got["collectives"]["all-gather"]["bytes"] == \
            16 * row_bytes * EDGES // 2 == got["collective_bytes"]
    assert cases[arch][2].telemetry["profile"]["collectives"] == {}


@pytest.mark.parametrize("world", list(WORLDS))
def test_sharded_el_round_is_one_ranks(worlds, lm_one_rank, world):
    """Over a (world, 1) data mesh: each rank holds E / world edges."""
    losses, params = lm_one_rank
    per = LM_CASE["edges"] // world
    for rank, res in enumerate(worlds[world]):
        lm = res["lm"]
        assert lm["edges"] == (rank * per, (rank + 1) * per)
        assert lm["losses"] == losses
        _equal_trees(lm["params"], params)
        assert all(np.isfinite(lm["losses"]))


@pytest.fixture(scope="module")
def model_one_rank(model_cases):
    """Each model case run unsharded, on one rank."""
    return {arch: model_axis(case, None)
            for arch, case in model_cases.items()}


MODEL_GRID = [(w, a) for w in MODEL_MESHES for a in MODEL_ARCHS]


@pytest.mark.parametrize("world,arch", MODEL_GRID)
def test_model_axis_state_is_the_unsharded_runs(worlds, model_one_rank,
                                                world, arch):
    """Every rank's params and AdamW moments, gathered over the model and
    edge groups after a round and two program rounds, are the unsharded
    run's bit for bit; its losses and decisions are equal."""
    want = model_one_rank[arch]
    assert all(np.isfinite(want["losses"]))
    for res in worlds[world]:
        got = res["model"][arch]
        assert got["losses"] == want["losses"]
        assert got["intervals"] == want["intervals"]
        assert got["budgets"] == want["budgets"]
        _equal_trees(got["state"], want["state"])


def _split(shape, spec, sizes):
    """A leaf's block shape under ``spec`` on a mesh of axis ``sizes``."""
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        out.append(n // int(np.prod([sizes[a] for a in axes])))
    return tuple(out)


@pytest.mark.parametrize("world,arch", MODEL_GRID)
def test_model_axis_blocks_are_the_specs(worlds, model_cases, world, arch):
    """The port's ``el_state_specs`` are the reference's on the world's
    mesh; each rank holds blocks of exactly the shapes they name, and the
    ``model`` axis really splits leaves of every family (olmoe's experts
    on the expert dim)."""
    from repro_torch.interop import tree_leaves
    from repro_torch.sharding import map_specs
    shape, axes = MODEL_MESHES[world]
    duck = type("Duck", (), {"axis_names": axes,
                             "devices": np.empty(shape)})()
    case = model_cases[arch]
    meta = local_sgd.init_el_state(LM(case["model_cfg"], device="meta"),
                                   case["train_cfg"], MODEL_EDGES, None)
    specs = local_sgd.el_state_specs(case["model_cfg"], duck, meta)
    rexp = ref_config.get_smoke_config(arch)
    rcfg = dataclasses.replace(rexp.model, dtype="float32", remat=True)
    rtc = dataclasses.replace(rexp.train, warmup_steps=2)
    ref_state = jax.eval_shape(lambda: ref_local_sgd.init_el_state(
        ref_build(rcfg), rtc, MODEL_EDGES, jax.random.key(0)))
    _assert_same_specs(specs, ref_local_sgd.el_state_specs(rcfg, duck,
                                                           ref_state))
    sizes = dict(zip(axes, shape))
    flat_specs = [b.spec for b in tree_leaves(map_specs(
        lambda spec: types.SimpleNamespace(spec=spec), specs))]
    want = [_split(tuple(t.shape), s, sizes)
            for t, s in zip(tree_leaves(meta), flat_specs)]
    # the step counters follow the rank's edges, as every leaf's edge dim
    # does (the reference's spec replicates its [E] counters)
    step = len(tree_leaves(meta.params))
    assert tree_leaves(meta)[step] is meta.opt.step
    want[step] = (MODEL_EDGES // sizes["data"],)
    split = [tuple(t.shape) != w and "model" in s
             for t, s, w in zip(tree_leaves(meta), flat_specs, want)]
    assert sum(split) > 0
    for res in worlds[world]:
        assert res["model"][arch]["shapes"] == want
    if arch == "olmoe-1b-7b":
        we = specs.params["groups"]["sub0"]["ffn"]["we_gate"]
        assert tuple(we) == ("data", None, "model", None, None)


@pytest.mark.parametrize("world", list(WORLDS))
def test_a_rank_imports_no_jax_or_reference(worlds, world):
    assert all(res["modules"] == [] for res in worlds[world])


# -- the mesh and the spawner -------------------------------------------------------


def test_flag_scan_and_mesh_shapes(monkeypatch):
    monkeypatch.delenv("REPRO_SWEEP_DEVICES", raising=False)
    assert hostdev.requested_ranks(["--mesh", "debug"]) == 4
    assert hostdev.requested_ranks(["--mesh=debug"]) == 4
    assert hostdev.requested_ranks(["--mesh", "none"]) is None
    assert hostdev.requested_ranks(["--mesh", "prod"]) is None
    assert hostdev.requested_ranks([]) is None
    assert hostdev.requested_ranks(["--devices", "2"], "--devices") == 4
    monkeypatch.setenv("REPRO_SWEEP_DEVICES", "8")
    assert hostdev.requested_ranks(["--mesh", "debug"]) == 8
    assert port_mesh.debug_mesh_shape(4) == (2, 2)
    assert port_mesh.debug_mesh_shape(8) == (4, 2)
    assert port_mesh.debug_mesh_shape(1) == (1, 1)
    monkeypatch.delenv("REPRO_DEBUG_MESH", raising=False)
    assert port_mesh.production_shape() == ((16, 16), ("data", "model"))
    assert port_mesh.production_shape(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))
    monkeypatch.setenv("REPRO_DEBUG_MESH", "2")
    assert port_mesh.production_shape() == ((2, 2), ("data", "model"))
    assert port_mesh.production_shape(multi_pod=True)[0] == (2, 2, 2)


def test_a_failed_rank_stops_its_world():
    code = ("import os, sys, time\n"
            "if os.environ['RANK'] == '1': sys.exit(3)\n"
            "time.sleep(60)\n")
    res = hostdev.spawn_ranks(2, [sys.executable, "-c", code], capture=True,
                              timeout=50)
    assert res[1].returncode == 3 and res[0].returncode != 0
    assert hostdev.world_returncode(res) != 0


def test_a_mesh_needs_its_world_and_nccl_a_card_a_rank(monkeypatch):
    """In this process (a world of one) a 2 x 2 mesh cannot form; NCCL
    without a card raises before joining anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_mesh.make_debug_mesh()
    code = ("import torch.distributed as dist\n"
            "from repro_torch.launch import mesh\n"
            "try:\n"
            "    mesh.make_debug_mesh(device='cpu')\n"
            "except RuntimeError as e:\n"
            "    assert 'needs 4 ranks' in str(e), e\n"
            "m = mesh.make_mesh((1, 1), ('data', 'model'), device='cpu')\n"
            "assert m.coordinate == {'data': 0, 'model': 0}\n"
            "assert m.backend == 'gloo' and m.rank == 0\n"
            "assert mesh.edge_shard(m, 4) is None\n"
            "dist.destroy_process_group()\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("WORLD_SIZE", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]


def test_census_counts_host_ops_and_nccl_kernels_once():
    """A gloo op shows in a CUDA trace as a host op and a device
    annotation of the same name (counted once, its input's bytes); an
    NCCL collective as a host op and a kernel (counted once, by the
    kernel, its bytes the host op's)."""
    from torch.autograd import DeviceType
    from repro_torch.obs.prof import census_of_events

    class Event:
        def __init__(self, name, device, shapes=()):
            self.name, self.device_type = name, device
            self.input_shapes = list(shapes)

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [Event("gloo:all_gather", cpu, [[2, 96]]),
              Event("gloo:all_gather", gpu),
              Event("nccl:all_gather", cpu, [[4, 8]]),
              Event("nccl:all_gather", gpu),
              Event("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgs)", gpu),
              Event("ncclDevKernel_AllReduce_Sum_f32_RING_LL", gpu),
              Event("nccl:all_reduce", cpu, [[3]]),
              Event("aten::mm", cpu, [[2, 2], [2, 2]])]
    counts, total = census_of_events(events)
    assert counts == {"all-gather": {"count": 2, "bytes": 2 * 96 * 4
                                     + 4 * 8 * 4},
                      "all-reduce": {"count": 1, "bytes": 12}}
    assert total == 2 * 96 * 4 + 4 * 8 * 4 + 12


def test_the_launcher_refuses_what_part_1_does_not_run(monkeypatch):
    """The async engine runs over a mesh and donating since part 2 (here
    in a rank of a launched world of one, this process: nothing is
    spawned); an LM arch with ``--mesh`` is still refused, as the
    reference refuses it."""
    from repro_torch.launch import train
    base = ["--mode", "ol4el", "--edges", "2", "--samples", "200",
            "--device", "cpu"]
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    rep = train.main(["--arch", "svm-wafer", "--el-mode", "async",
                      "--budget", "1500", "--mesh", "debug", "--donate"]
                     + base)
    assert rep.mode == "async" and rep.n_aggregations > 0
    assert rep.terminated_reason == "budget_exhausted"
    assert rep.telemetry["device_loop"]["batch_k"] == 1   # one device
    with pytest.raises(SystemExit):          # the reference's restriction
        train.main(["--arch", "qwen3-1.7b", "--smoke", "--mesh", "debug"]
                   + base)
