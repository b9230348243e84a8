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

The baseline steps over a (pod x) data x model mesh (``repro_torch.
train.state``'s ``mesh=``), in the same worlds: the 2 ranks as (2, 1) and
(1, 2) (data, model) meshes, the 4 as (2, 2) and a (2, 1, 2) (pod, data,
model) mesh, on qwen3-1.7b, olmoe-1b-7b and mamba2-370m at smoke width,
f32, remat on.  Two train steps (AdamW, and SGD with momentum) from the
whole state cut to the rank's blocks: each rank's blocks are the matching
``local_slices`` of the unsharded port step's parameters within 1e-5,
its losses within 1e-5; the SGD run is held to the reference's
``make_train_step`` on the same numpy inputs too (AdamW's first steps
scale each gradient element to about +-1, so a rounding-level difference
in a near-zero element moves a parameter by up to the learning rate: the
unsharded port and the reference are held to each other on AdamW's losses
only, ``tests/test_torch_train.py``; the dropping MoE case below trains
with SGD for the same reason).  Ranks that differ only in their
``model`` coordinate agree bit for bit.  A MoE whose step routes T * k >
4096 assignments drops tokens: the step's dispatch of a rank's rows is the
unsharded dispatch's, a rank-local one is not.  The prefill's logits of a
rank's rows and 15 decode steps after a prefill (the batch over the edge
ranks; batch 1 with the K/V sequence split, windows inside one rank's
block and across two) are the unsharded rows and the reference's on the
same inputs within 1e-5; so is the dropping MoE's dispatch of a rank's
rows.
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
from torch_mesh_worker import (model_axis, step_decode,  # noqa: E402
                               step_prefill, step_train)

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
#: the baseline steps: each world's meshes, the families, the sizes
STEP_MESHES = {2: [((2, 1), ("data", "model")), ((1, 2), ("data", "model"))],
               4: [((2, 2), ("data", "model")),
                   ((2, 1, 2), ("pod", "data", "model"))]}
STEP_ARCHS = ("qwen3-1.7b", "olmoe-1b-7b", "mamba2-370m")
STEP_BATCH, STEP_SEQ, STEP_TOL, AUX_TOL = 4, 16, 1e-5, 1e-6
#: decodes: (batch, window); prefill 6 positions, then 15 steps in a
#: 32-slot cache (two ranks' blocks of 16: a window of 3 sits inside one
#: block at most positions, one of 9 spans both)
DECODES = ((4, 0), (1, 0), (1, 3), (1, 9))
PREFILL_LEN, MAX_LEN, DECODE_STEPS = 6, 32, 15
#: the dropping MoE: 8 x 320 tokens, top 2 of 4 experts, capacity factor
#: 1; its grouped dispatch in 4 groups (2 a rank on the 2 edge ranks)
DROP_SHAPE, DROP_MESHES, DROP_GROUPS = (8, 320), ((2, 1), (2, 1, 2)), 4


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


def _step_cfgs(arch):
    """The smoke config at f32 with remat on; AdamW (the smoke config's)
    and SGD with momentum, warm-up 2 steps."""
    exp = get_smoke_config(arch)
    return (dataclasses.replace(exp.model, dtype="float32", remat=True),
            {"adamw": dataclasses.replace(exp.train, warmup_steps=2),
             "sgd": dataclasses.replace(exp.train, warmup_steps=2,
                                        optimizer="sgd", peak_lr=0.05,
                                        momentum=0.9)})


@pytest.fixture(scope="module")
def step_cases():
    """Per arch: the port's init as numpy (seed 3), two batches of tokens,
    the decode prompts; and the dropping MoE case: its init, whose router
    is scaled by 30 so that no top-2 choice sits within rounding of a tie
    while it trains, and a dispatch input ``moe_x`` for its first MoE
    block ``moe_p`` at the unscaled router (at 30x the logits' rounding
    reaches the gates 30-fold, up to 1.5e-5 in the reference's y)."""
    rng = np.random.default_rng(2)
    out = []
    for arch in STEP_ARCHS:
        model_cfg, tcs = _step_cfgs(arch)
        init = tree_to_numpy(LM(model_cfg, device="cpu").init(
            torch.Generator().manual_seed(3)))
        out.append({
            "arch": arch, "model_cfg": model_cfg, "train_cfgs": tcs,
            "init": init, "tokens": rng.integers(
                0, model_cfg.vocab_size, (2, STEP_BATCH, STEP_SEQ),
                np.int32),
            "prompt": rng.integers(0, model_cfg.vocab_size, (
                4, PREFILL_LEN + DECODE_STEPS), np.int32),
            "prefill_len": PREFILL_LEN, "max_len": MAX_LEN,
            "decode": DECODE_STEPS,
            "decodes": DECODES if arch != "mamba2-370m" else DECODES[:2]})
    model_cfg, tcs = _step_cfgs("olmoe-1b-7b")
    model_cfg = dataclasses.replace(model_cfg, moe=dataclasses.replace(
        model_cfg.moe, capacity_factor=1.0))
    init = tree_to_numpy(LM(model_cfg, device="cpu").init(
        torch.Generator().manual_seed(4)))
    moe_p = {k: v[0].copy() for k, v in
             init["groups"]["sub0"]["ffn"].items()}
    init["groups"]["sub0"]["ffn"]["router"] *= 30.0
    b, s = DROP_SHAPE
    out.append({"arch": "olmoe-1b-7b", "drop": True, "meshes": DROP_MESHES,
                "model_cfg": model_cfg, "train_cfgs": {"sgd": tcs["sgd"]},
                "init": init, "moe_p": moe_p, "groups": DROP_GROUPS,
                "tokens": rng.integers(
                    0, model_cfg.vocab_size, (2, b, s), np.int32),
                "moe_x": rng.standard_normal(
                    (b, s, model_cfg.d_model)).astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def spawned(cases, model_cases, step_cases, tmp_path_factory):
    """Both worlds, spawned at once and left running (``worlds`` waits)."""
    lm = dict(LM_CASE, tokens=_lm_tokens())
    results, threads = {}, []
    for world, mesh in WORLDS.items():
        d = tmp_path_factory.mktemp(f"world{world}")
        spec = {"mesh": mesh, "classic": [c[0] for c in cases.values()],
                "one_edge_mesh": ONE_EDGE_MESH if world == 4 else None,
                "lm": lm, "model": list(model_cases.values()),
                "model_mesh": MODEL_MESHES[world],
                "step_meshes": STEP_MESHES[world], "step_cases": step_cases}
        with open(d / "spec.pkl", "wb") as f:
            pickle.dump(spec, f)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

        def go(world=world, d=d, env=env):
            results[world] = (d, hostdev.spawn_ranks(
                world, [sys.executable, str(WORKER), str(d / "spec.pkl"),
                        str(d)], env=env, capture=True, timeout=600))
        threads.append(threading.Thread(target=go))
        threads[-1].start()
    return results, threads


@pytest.fixture(scope="module")
def step_refs(step_cases):
    """Per arch, the unsharded port run of every step scenario and the
    reference's on the same numpy inputs: its SGD steps
    (``repro.train.state.make_train_step``, jitted), its prefill logits
    (``make_prefill_step``) and its prefill + decode logits
    (``decode_step``, jitted) at each (batch, window); the dropping case's
    unsharded training and dispatch, the port's and the reference's
    ``moe_ffn``.  Computed while the worlds run."""
    from repro.models import moe as ref_moe
    from repro.train import optimizer as ref_opt
    from repro.train import state as ref_state
    from repro_torch.models import moe as port_moe
    jnp = jax.numpy
    out = {}
    for case in step_cases:
        arch = case["arch"]
        rexp = ref_config.get_smoke_config(arch)
        rcfg = dataclasses.replace(rexp.model, dtype="float32", remat=True)
        if case.get("drop"):
            rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
                rcfg.moe, capacity_factor=1.0))
            p = params_from_numpy(case["moe_p"], "cpu")
            rp = {k: jnp.asarray(v) for k, v in case["moe_p"].items()}
            out["drop"] = step_train(case, None, "sgd")
            for name, groups in (("dispatch", 0),
                                 ("grouped", case["groups"])):
                cfg = case["model_cfg"]
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, dispatch_groups=groups))
                y, aux = port_moe.moe_ffn(p, cfg,
                                          torch.from_numpy(case["moe_x"]))
                ry, raux = ref_moe.moe_ffn(rp, dataclasses.replace(
                    rcfg, moe=dataclasses.replace(
                        rcfg.moe, dispatch_groups=groups)),
                    jnp.asarray(case["moe_x"]))
                out["drop"].update({
                    name: y.numpy(), "reference_" + name: np.asarray(ry),
                    name + "_aux": {k: float(v) for k, v in aux.items()},
                    "reference_" + name + "_aux": {
                        k: float(v) for k, v in raux.items()}})
            continue
        rtc = dataclasses.replace(rexp.train, warmup_steps=2,
                                  optimizer="sgd", peak_lr=0.05,
                                  momentum=0.9)
        rp = jax.tree.map(jnp.asarray, case["init"])
        rm = ref_build(rcfg)
        js = ref_state.TrainState(rp, ref_opt.init_opt_state(rtc, rp))
        jstep = jax.jit(ref_state.make_train_step(rm, rtc))
        losses = []
        for tokens in case["tokens"]:
            js, met = jstep(js, {"tokens": jnp.asarray(tokens)})
            losses.append(float(met["loss"]))
        ref_decode = {}
        n0, toks = case["prefill_len"], jnp.asarray(case["prompt"])
        for b, w in case["decodes"]:
            wm = ref_build(dataclasses.replace(rcfg, sliding_window=w))
            dec = jax.jit(wm.decode_step)
            _, cache = wm.prefill(rp, toks[:b, :n0],
                                  wm.init_cache(b, case["max_len"]))
            logits = []
            for i in range(case["decode"]):
                lg, cache = dec(rp, toks[:b, n0 + i:n0 + i + 1], cache)
                logits.append(np.asarray(lg))
            ref_decode[f"{b}/{w}"] = logits
        out[arch] = {
            "train": {opt: step_train(case, None, opt)
                      for opt in case["train_cfgs"]},
            "reference": {
                "losses": losses,
                "params": jax.tree.map(np.asarray, js.params),
                "prefill": np.asarray(ref_state.make_prefill_step(rm)(
                    rp, {"tokens": jnp.asarray(case["tokens"][0])})),
                "decode": ref_decode},
            "prefill": step_prefill(case, None),
            "decode": {f"{b}/{w}": step_decode(case, None, b, w)
                       for b, w in case["decodes"]}}
    return out


@pytest.fixture(scope="module")
def worlds(spawned, step_refs):
    """Each world's per-rank results."""
    results, threads = spawned
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
#: the 4 ranks as a (4, 1) mesh too: one edge a rank
ONE_EDGE_MESH = ((4, 1), ("data", "model"))


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


@pytest.mark.parametrize("arch", ARCHS)
def test_one_edge_a_rank_is_the_unsharded_run(worlds, cases, arch):
    """The 4 ranks as a (4, 1) mesh, one edge a rank, its lone lane run
    beside a copy (on a card cuBLAS rounds a batch of one matrix apart
    from a batch of several): every rank's run and donated twin bit for
    bit the unsharded run, one gathered row a rank a round."""
    _, _, port = cases[arch]
    row_bytes = sum(v.nbytes for v in cases[arch][0]["init"].values())
    for res in worlds[4]:
        got = res["one_edge"][arch]
        np.testing.assert_array_equal(got["records"], _records(port))
        _equal_trees(got["params"], tree_to_numpy(port.final_params))
        np.testing.assert_array_equal(got["donated_records"],
                                      got["records"])
        _equal_trees(got["donated_params"], got["params"])
        assert got["cell"] == (True, False)
        assert got["collectives"] == {"all-gather": {
            "count": 16, "bytes": 16 * row_bytes}}


@pytest.mark.parametrize("world,arch", GRID)
def test_gloo_cells_gather_and_run_eagerly(worlds, world, arch):
    """Over gloo a sharded cell gathers (the census reads that) but no
    CUDA graph can hold the gathers, which run in host memory: the run
    and its donated twin capture nothing and replay nothing, every chunk
    eager."""
    for res in worlds[world]:
        got = res["classic"][arch]
        assert got["cell"] == (True, False)
        for loop in (got["device_loop"], got["donated_loop"]):
            assert loop["graphs_captured"] == 0 and loop["replays"] == 0
            assert loop["chunks"] > 0


@pytest.mark.parametrize("world", list(WORLDS))
def test_edge_gather_is_each_leafs_gather_in_both_forms(worlds, world):
    """``gather_edge_stack``'s one gather a dtype lays out every leaf as
    gathering it alone would (rank-major row blocks, bools as bytes), the
    same stack on every rank; ``all_gather_rows``' two forms, the list
    of views that gloo takes and the tensor-to-tensor call that NCCL
    takes, write the same bytes."""
    first = worlds[world][0]["gather"]
    for res in worlds[world]:
        g = res["gather"]
        assert g["stack"].keys() == g["per_leaf"].keys()
        for k, want in g["per_leaf"].items():
            got = g["stack"][k]
            assert got.dtype == (np.bool_ if k == "m" else want.dtype)
            np.testing.assert_array_equal(
                got.view(np.uint8) if k == "m" else got, want)
            np.testing.assert_array_equal(got, first["stack"][k])
        # the edge group: the data axis (the 4-rank world's model axis
        # holds copies)
        assert g["ranks"] == WORLDS[world][0][0]
        assert g["rows"].shape == (g["ranks"] * 3, 7)
        np.testing.assert_array_equal(g["list_form"], g["rows"])
        np.testing.assert_array_equal(g["tensor_form"], g["rows"])


@pytest.mark.parametrize("backend,captured", [("nccl", True),
                                              ("gloo", False),
                                              ("planned", True)])
def test_the_capture_rule_follows_the_gathers_backend(monkeypatch, backend,
                                                      captured):
    """A sharded cell's chunks are CUDA graphs where a graph can hold its
    gathers: NCCL's (device kernels) and a plan's (no exchange), not
    gloo's (host memory).  Without a card: the sync and async cells over
    a ``PlanMesh(2)`` (2 of 4 edges a rank) with the edge group's backend
    read as ``backend``, and the runner's choice for such a cell on a
    CUDA device and on the CPU; a cell with no mesh gathers nothing and
    is captured on a card."""
    import dataclasses
    from repro_torch.el.events.program import make_async_cell
    from repro_torch.el.ingraph import captures_chunks, make_sync_cell
    from repro_torch.launch.mesh import PlanMesh
    if backend != "planned":
        monkeypatch.setattr(port_mesh, "group_backend", lambda g: backend)
    assert port_mesh.graph_capturable(None)
    assert port_mesh.graph_capturable(port_mesh.PlannedGroup(2)) == captured
    fx = classic_fixture("svm-wafer", samples=200, n_edges=EDGES,
                         device="cpu")
    ex = fx["executor"]
    cuda = torch.device("cuda")
    for mode, make in (("sync", make_sync_cell), ("async", make_async_cell)):
        cfg = dataclasses.replace(fx["exp"].ol4el, mode=mode, n_edges=EDGES,
                                  utility=fx["utility"])
        for mesh in (None, PlanMesh(2)):
            cell = make(ex.model, ex.edge_data, ex.eval_set, cfg, lr=ex.lr,
                        batch=ex.batch, mesh=mesh, device="cpu")
            want = (False, True) if mesh is None else (True, captured)
            assert (cell.sharded, cell.capturable) == want, (mode, mesh)
            assert captures_chunks(dataclasses.replace(cell, device=cuda)) \
                == want[1]
            assert not captures_chunks(cell)


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


# -- the baseline steps over a (pod x) data x model mesh ---------------------------


STEP_GRID = [(w, tuple(m[0]), a) for w in STEP_MESHES
             for m in STEP_MESHES[w] for a in STEP_ARCHS]


def _stub(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.arange(int(np.prod(shape)))
                                 .reshape(shape))


def _edge(shape, coord):
    """(edge index, edge ranks) of a rank's coordinate."""
    idx, n = 0, 1
    for a, size in zip(("pod", "data"), shape[:-1] if len(shape) == 3
                       else (1,) + tuple(shape[:-1])):
        idx, n = idx * size + coord.get(a, 0), n * size
    return idx, n


def _rank_blocks(arch, shape, rank, full):
    """``full``'s leaves cut to ``rank``'s blocks on a mesh of ``shape``
    (``param_specs(fsdp=True)``, ``Placement.local_slices``)."""
    from repro_torch.sharding import Placement, map_specs, param_specs
    cfg, _ = _step_cfgs(arch)
    mesh = _stub(shape)
    specs = param_specs(cfg, mesh, LM(cfg, device="meta").init(None),
                        fsdp=True)
    flat = jax.tree_util.tree_leaves(map_specs(
        lambda sp: types.SimpleNamespace(spec=sp), specs))
    return [leaf[Placement(mesh, sp.spec).local_slices(leaf.shape, rank)]
            for leaf, sp in zip(jax.tree_util.tree_leaves(full), flat)]


def _close(got, want, tol=STEP_TOL):
    got, want = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(
        want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


@pytest.mark.parametrize("world,shape,arch", STEP_GRID)
def test_mesh_train_step_blocks_are_the_unsharded_steps(
        worlds, step_refs, world, shape, arch):
    """Two steps over the mesh: each rank's blocks are the unsharded port
    step's ``local_slices`` and its losses the step's, within 1e-5, with
    AdamW and with SGD; the SGD run is the reference's too."""
    ref = step_refs[arch]
    for rank, res in enumerate(worlds[world]):
        got = res["steps"][shape][arch]["train"]
        for opt, want in ref["train"].items():
            np.testing.assert_allclose(got[opt]["losses"], want["losses"],
                                       rtol=0, atol=STEP_TOL)
            _close(got[opt]["params"],
                   _rank_blocks(arch, shape, rank, want["params"]))
        np.testing.assert_allclose(got["sgd"]["losses"],
                                   ref["reference"]["losses"], rtol=0,
                                   atol=STEP_TOL)
        _close(got["sgd"]["params"],
               _rank_blocks(arch, shape, rank, ref["reference"]["params"]))


@pytest.mark.parametrize("world,shape,arch", STEP_GRID)
def test_mesh_prefill_and_decode_rows_are_the_unsharded_rows(
        worlds, step_refs, world, shape, arch):
    """The prefill's logits of a rank's rows and 15 decode steps' logits
    after a prefill, within 1e-5 of the unsharded port's rows and of the
    reference's on the same inputs: the batch of 4 over the edge ranks,
    batch 1 with the K/V sequence split over them (windows 3 and 9: inside
    one rank's block, across both)."""
    ref = step_refs[arch]
    for res in worlds[world]:
        coord = res["steps"][shape]["coordinate"]
        edge, n_edge = _edge(shape, coord)
        got = res["steps"][shape][arch]
        rows = slice(edge * STEP_BATCH // n_edge,
                     (edge + 1) * STEP_BATCH // n_edge)
        _close(got["prefill"], ref["prefill"][rows])
        _close(got["prefill"], ref["reference"]["prefill"][rows])
        for key, want in ref["decode"].items():
            batch = int(key.split("/")[0])
            dec = got["decode"][key]
            layout = ("replicated" if n_edge == 1 else "batch"
                      if batch % n_edge == 0 else "replicated"
                      if arch == "mamba2-370m" else "sequence")
            assert dec["layout"] == layout, key
            r = (slice(edge * batch // n_edge, (edge + 1) * batch // n_edge)
                 if layout == "batch" else slice(None))
            assert len(dec["logits"]) == DECODE_STEPS
            for g, w, rw in zip(dec["logits"], want["logits"],
                                ref["reference"]["decode"][key]):
                _close(g, w[r])
                _close(g, rw[r])


@pytest.mark.parametrize("world,shape", [(w, tuple(m[0])) for w in
                                         STEP_MESHES
                                         for m in STEP_MESHES[w]])
def test_mesh_steps_agree_bit_for_bit_across_model_ranks(worlds, world,
                                                         shape):
    """Ranks that differ only in their ``model`` coordinate compute the
    same rows on the same gathered weights: equal losses, equal blocks of
    every leaf the ``model`` axis leaves whole, equal logits, bit for
    bit."""
    from repro_torch.sharding import map_specs, param_specs
    by_edge = {}
    for res in worlds[world]:
        c = dict(res["steps"][shape]["coordinate"])
        c.pop("model")
        by_edge.setdefault(tuple(sorted(c.items())), []).append(
            res["steps"][shape])
    pairs = [g for g in by_edge.values() if len(g) > 1]
    assert len(pairs) == (world if shape[-1] > 1 else 0) // 2
    for first, *rest in pairs:
        for other in rest:
            for arch in STEP_ARCHS:
                cfg, _ = _step_cfgs(arch)
                specs = jax.tree_util.tree_leaves(map_specs(
                    lambda sp: types.SimpleNamespace(spec=sp),
                    param_specs(cfg, _stub(shape), LM(
                        cfg, device="meta").init(None), fsdp=True)))
                a, b = first[arch], other[arch]
                for opt in a["train"]:
                    assert a["train"][opt]["losses"] == \
                        b["train"][opt]["losses"]
                    for x, y, sp in zip(
                            jax.tree_util.tree_leaves(
                                a["train"][opt]["params"]),
                            jax.tree_util.tree_leaves(
                                b["train"][opt]["params"]), specs):
                        if "model" not in tuple(sp.spec):
                            np.testing.assert_array_equal(x, y)
                np.testing.assert_array_equal(a["prefill"], b["prefill"])
                for key in a["decode"]:
                    for x, y in zip(a["decode"][key]["logits"],
                                    b["decode"][key]["logits"]):
                        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("world", list(WORLDS))
def test_mesh_moe_dispatch_is_the_steps_where_it_drops(worlds, step_refs,
                                                       world):
    """8 x 320 tokens route 5,120 > 4,096 assignments: the capacity
    drops.  Over the edge ranks the step's dispatch of a rank's rows is
    the unsharded dispatch's rows exactly and the reference's
    ``moe_ffn``'s within 1e-5, and so is the grouped dispatch whose 4
    groups tile the 2 edge ranks (the reference's grouped branch); each
    one's aux values are the unsharded port's and the reference's within
    1e-6; a rank-local dispatch (its own
    capacity and positions) differs on some rank; two SGD steps are the
    unsharded steps within 1e-5 (AdamW's first steps would turn the
    rounding of the embedding's near-zero gradient sums into moves of up
    to the learning rate: see the module's doc)."""
    ref = step_refs["drop"]
    b = DROP_SHAPE[0]
    differs = []
    shapes = [tuple(m[0]) for m in STEP_MESHES[world]
              if tuple(m[0]) in DROP_MESHES]
    assert shapes
    for shape in shapes:
        for rank, res in enumerate(worlds[world]):
            got = res["steps"][shape]["drop"]
            edge, n_edge = _edge(shape, res["steps"][shape]["coordinate"])
            rows = slice(edge * b // n_edge, (edge + 1) * b // n_edge)
            for name in ("dispatch", "grouped"):
                np.testing.assert_array_equal(got[name], ref[name][rows])
                _close(got[name], ref["reference_" + name][rows])
                for key, v in got[name + "_aux"].items():
                    for want in (ref[name + "_aux"],
                                 ref["reference_" + name + "_aux"]):
                        np.testing.assert_allclose(v, want[key], rtol=0,
                                                   atol=AUX_TOL)
            differs.append(not np.array_equal(got["local"],
                                              ref["dispatch"][rows]))
            np.testing.assert_allclose(got["losses"], ref["losses"], rtol=0,
                                       atol=STEP_TOL)
            _close(got["params"], _rank_blocks("olmoe-1b-7b", shape, rank,
                                               ref["params"]))
    assert any(differs)


def test_split_attention_partials_combine_to_the_whole():
    """``attend_partial`` over two halves of the keys, combined in rank
    order, is the whole softmax within 1e-6; a half with no valid key
    (outside the window) adds exact zeros."""
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 1, 4, 8, generator=g)
    k, v = torch.randn(2, 16, 2, 8, generator=g), torch.randn(
        2, 16, 2, 8, generator=g)
    valid = torch.arange(16) >= 10                  # the window: 10..15
    whole = L._sdpa(q, k, v, torch.where(valid, 0.0, -1e30)[None], 0.5)
    parts = torch.stack([L.attend_partial(q, k[:, h], v[:, h], valid[h], 0.5)
                         for h in (slice(0, 8), slice(8, 16))])
    assert torch.all(parts[0, ..., :-2] == 0) and torch.all(
        parts[0, ..., -1] == 0)
    assert torch.all(torch.isinf(parts[0, ..., -2]))
    np.testing.assert_allclose(L.combine_split_attention(parts), whole,
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(L.combine_split_attention(parts),
                                  L.combine_split_attention(parts[1:]))


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
    NCCL collective as a host op, an annotation and a kernel (counted
    once, by the host op, its input's bytes: a world of one's gather
    launches no NCCL kernel, a copy instead); NCCL's tensor-to-tensor
    gather is ``nccl:_all_gather_base``."""
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
              Event("aten::mm", cpu, [[2, 2], [2, 2]]),
              Event("nccl:_all_gather_base", cpu, [[2, 10]]),
              Event("nccl:_all_gather_base", gpu),
              Event("Memcpy DtoD (Device -> Device)", gpu)]
    counts, total = census_of_events(events)
    assert counts == {"all-gather": {"count": 3, "bytes": 2 * 96 * 4
                                     + 4 * 8 * 4 + 2 * 10 * 4},
                      "all-reduce": {"count": 1, "bytes": 12}}
    assert total == 2 * 96 * 4 + 4 * 8 * 4 + 2 * 10 * 4 + 12


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
