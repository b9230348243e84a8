"""One rank of a gloo world, for ``tests/test_torch_mesh.py``.

    python tests/torch_mesh_worker.py SPEC.pkl OUT_DIR

run as every rank of a world that ``repro_torch.launch.hostdev.
spawn_ranks`` starts.  It imports the port only (never jax or the
reference), runs every scenario of ``SPEC`` on this rank and pickles what
it saw to ``OUT_DIR/rank<r>.pkl``:

  * ``classic``: per case, the sync run through ``run_sync_ingraph(mesh=,
    contract=True)`` on replayed draws (records, final params, the
    profile's census, the device loop), then the same run donated
    (``donate=True``), and whether running the donated params again
    raises;
  * ``lm``: ``local_sgd.make_el_round`` over a data-only mesh, the rank's
    edges' state gathered after the rounds;
  * ``model``: per arch, each edge's model split over the ``model`` axis
    of the world's ``model_mesh`` (``init_el_state(mesh=)``): one
    ``make_el_round`` round, then ``make_el_program`` rounds on replayed
    draws; the losses, the shapes of the rank's blocks, and the whole
    state (params and moments) gathered over the model group and the edge
    group;
  * ``modules``: any ``jax`` / ``repro`` / ``benchmarks`` module the rank
    imported.
"""

import dataclasses
import os
import pickle
import sys

import torch


def _records(rep):
    return [(r.interval, r.n_aggregations, r.total_consumed, r.wall_time,
             r.metric, r.utility) for r in rep.records]


def classic_case(case, mesh):
    from repro_torch.el import ELSession
    from repro_torch.el.rng import ReplayDraws
    from repro_torch.interop import tree_from_numpy, tree_to_numpy
    from repro_torch.launch.classic import classic_fixture
    fx = classic_fixture(case["arch"], samples=case["samples"],
                         n_edges=case["edges"], device="cpu")
    cfg = dataclasses.replace(fx["exp"].ol4el, **case["cfg"])

    def run(**kw):
        params = tree_from_numpy(case["init"], "cpu")
        session = (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
                   .with_executor(fx["executor"], init_params=params,
                                  n_samples=fx["n_samples"]))
        rep = session.run_sync_ingraph(
            max_rounds=case["max_rounds"], draws=ReplayDraws(*case["draws"]),
            mesh=mesh, contract=True, **kw)
        return session, params, rep

    _, _, rep = run()
    session, donated, drep = run(donate=True)
    try:
        session.run_sync_ingraph(max_rounds=case["max_rounds"],
                                 draws=ReplayDraws(*case["draws"]),
                                 mesh=mesh, donate=True)
        reuse = "ran"
    except RuntimeError as e:
        reuse = str(e)
    prof = rep.telemetry["profile"]
    return {"records": _records(rep), "params": tree_to_numpy(
        rep.final_params), "n_rounds": rep.n_aggregations,
        "arm_pulls": list(rep.arm_pulls), "final": rep.final_metric,
        "terminated": rep.terminated_reason,
        "collectives": prof["collectives"],
        "collective_bytes": prof["collective_bytes"],
        "alias_bytes": prof["alias_bytes"],
        "device_loop": rep.telemetry["device_loop"],
        "donated_records": _records(drep),
        "donated_params": tree_to_numpy(drep.final_params),
        "donated_alias_bytes": drep.telemetry["profile"]["alias_bytes"],
        "donated_param_bytes": sum(v.nbytes for v in case["init"].values()),
        "donated_shares_storage": all(
            drep.final_params[k].data_ptr() == donated[k].data_ptr()
            for k in donated),
        "reuse": reuse}


def lm_round(case, world):
    from repro_torch.config import get_smoke_config
    from repro_torch.federated import local_sgd
    from repro_torch.interop import tree_to_numpy
    from repro_torch.launch.mesh import gather_edge_stack, make_mesh
    from repro_torch.models import LM
    exp = get_smoke_config(case["arch"])
    model_cfg = dataclasses.replace(exp.model, dtype="float32")
    tc = dataclasses.replace(exp.train, **case["train"])
    mesh = make_mesh((world, 1), ("data", "model"), device="cpu")
    model = LM(model_cfg, device="cpu")
    rnd = local_sgd.make_el_round(model, tc, case["h_max"], case["mode"],
                                  mesh=mesh)
    mine = rnd.edges(case["edges"])
    state = local_sgd.init_el_state(
        model, tc, case["edges"],
        torch.Generator().manual_seed(case["seed"]), edges=mine)
    losses = []
    for r, tokens in enumerate(case["tokens"]):
        state, met = rnd(state, {"tokens": torch.from_numpy(
            tokens[mine.start:mine.stop])},
            torch.tensor(case["intervals"][r], dtype=torch.int32),
            torch.tensor(case["weights"], dtype=torch.float32))
        losses.append(float(met["mean_loss"]))
    group = mesh.edge_group()
    return {"edges": (mine.start, mine.stop), "losses": losses,
            "params": tree_to_numpy(gather_edge_stack(state.params, group))}


def model_axis(case, mesh):
    """``case``'s arch with each edge's model over ``mesh``'s ``model``
    axis (``tests/test_torch_mesh.py``'s ``model_cases``); ``mesh=None``:
    the unsharded run on one rank."""
    from repro_torch.el.rng import ReplayDraws
    from repro_torch.federated import local_sgd
    from repro_torch.interop import tree_leaves, tree_to_numpy
    from repro_torch.launch.mesh import edge_shard
    from repro_torch.models import LM
    model_cfg, tc = case["model_cfg"], case["train_cfg"]
    model = LM(model_cfg, device="cpu")
    n_edges, h_max = case["edges"], case["h_max"]
    rnd = local_sgd.make_el_round(model, tc, h_max, "sync", mesh=mesh)
    mine = rnd.edges(n_edges)
    state = local_sgd.init_el_state(
        model, tc, n_edges, torch.Generator().manual_seed(case["seed"]),
        edges=mine, mesh=mesh)
    shapes = [tuple(t.shape) for t in tree_leaves(state)]
    tokens = case["tokens"]
    state, met = rnd(state, {"tokens": torch.from_numpy(
        tokens[0][mine.start:mine.stop])},
        torch.tensor(case["intervals"], dtype=torch.int32),
        torch.tensor(case["weights"], dtype=torch.float32))
    losses = [float(met["mean_loss"])]

    def data_fn(edge_ids, rnd_idx, steps):
        return {"tokens": torch.from_numpy(
            tokens[1 + rnd_idx][edge_ids.numpy()][:, steps.numpy()])}
    prog = local_sgd.make_el_program(
        model, tc, n_edges, h_max, len(tokens) - 1, data_fn,
        case["comp"], case["comm"], mode="async", ucb_c=1.0, mesh=mesh)
    state, _, budgets, hist = prog(
        state, local_sgd.el_bandit_init(n_edges, h_max, "cpu"),
        torch.tensor(case["budgets"]), ReplayDraws(gumbel=case["gumbel"]))
    full, shard = state, edge_shard(mesh, n_edges)
    if mesh is not None:
        specs = local_sgd.el_state_specs(
            model_cfg, mesh, local_sgd.init_el_state(
                LM(model_cfg, device="meta"), tc, n_edges, None))
        full = local_sgd.gather_el_state(state, specs, mesh)
    if shard is not None:
        full = shard.gather(full)
    return {"edges": (mine.start, mine.stop), "shapes": shapes,
            "losses": losses + hist["loss"].tolist(),
            "intervals": hist["intervals"].tolist(),
            "budgets": budgets.tolist(), "state": tree_to_numpy(full)}


def main():
    spec_path, out_dir = sys.argv[1:3]
    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    from repro_torch.launch.mesh import make_mesh
    world = int(os.environ["WORLD_SIZE"])
    mesh = make_mesh(*spec["mesh"], device="cpu")
    out = {"rank": mesh.rank, "mesh": dict(mesh.shape),
           "coordinate": mesh.coordinate,
           "classic": {c["name"]: classic_case(c, mesh)
                       for c in spec["classic"]}}
    if spec.get("lm"):
        out["lm"] = lm_round(spec["lm"], world)
    if spec.get("model"):
        model_mesh = make_mesh(*spec["model_mesh"], device="cpu")
        out["model"] = {c["arch"]: model_axis(c, model_mesh)
                        for c in spec["model"]}
    out["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in
                            ("jax", "jaxlib", "repro", "benchmarks"))
    with open(os.path.join(out_dir, f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
