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
    raises; the cell's ``sharded`` / ``capturable`` flags;
  * ``gather``: the edge group's gathers, both forms, against a gather of
    each leaf alone;
  * ``one_edge`` (a world given ``one_edge_mesh``): ``classic`` over that
    mesh, one edge a rank;
  * ``lm``: ``local_sgd.make_el_round`` over a data-only mesh, the rank's
    edges' state gathered after the rounds;
  * ``model``: per arch, each edge's model split over the ``model`` axis
    of the world's ``model_mesh`` (``init_el_state(mesh=)``): one
    ``make_el_round`` round, then ``make_el_program`` rounds on replayed
    draws; the losses, the shapes of the rank's blocks, and the whole
    state (params and moments) gathered over the model group and the edge
    group;
  * ``steps``: per (pod x) data x model mesh of ``step_meshes`` and per
    arch, the baseline steps over it (``repro_torch.train.state``'s
    ``mesh=``): two train steps from the whole state cut to the rank's
    blocks (AdamW and SGD with momentum; the losses and the rank's blocks
    of the parameters), the prefill's logits of the rank's rows, and 15
    decode steps after an unsharded prefill whose cache is cut to the
    rank's blocks (the batch over the edge ranks; batch 1 with the K/V
    sequence split, at each window of the case); a ``drop`` case trains
    a MoE whose dispatch drops tokens and runs its first MoE block's
    dispatch on the rank's rows three ways (the step's, rank-local, and
    grouped with the groups tiling the edge ranks);
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

    first, _, rep = run()
    cell = first._fastpath.cell
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
        "cell": (cell.sharded, cell.capturable),
        "donated_loop": drep.telemetry["device_loop"],
        "donated_records": _records(drep),
        "donated_params": tree_to_numpy(drep.final_params),
        "donated_alias_bytes": drep.telemetry["profile"]["alias_bytes"],
        "donated_param_bytes": sum(v.nbytes for v in case["init"].values()),
        "donated_shares_storage": all(
            drep.final_params[k].data_ptr() == donated[k].data_ptr()
            for k in donated),
        "reuse": reuse}


def gather_case(mesh):
    """The edge group's gathers against a gather of each leaf alone, the
    old layout: ``gather_edge_stack`` of a tree of every dtype it packs
    (f32, int64, bool), and ``all_gather_rows`` in both forms on one
    buffer: gloo's list of views, and the tensor-to-tensor call it makes
    on NCCL (the group's backend read as ``"nccl"``)."""
    import torch.distributed as dist
    from repro_torch.interop import tree_to_numpy
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.mesh import all_gather_rows, gather_edge_stack
    group = mesh.edge_group()
    world = dist.get_world_size(group)
    # the edge coordinate's data: every edge group gathers the same stack
    gen = torch.Generator().manual_seed(11 + mesh.coordinate["data"])
    tree = {"w": torch.randn(2, 3, 4, generator=gen),
            "b": torch.randn(2, 5, generator=gen),
            "n": torch.randint(0, 9, (2, 3), generator=gen),
            "m": torch.rand(2, 2, generator=gen) > 0.5}

    def per_leaf(leaf):
        parts = [torch.empty_like(leaf) for _ in range(world)]
        dist.all_gather(parts, leaf, group=group)
        return torch.cat(parts)
    local = torch.randn(3, 7, generator=gen)
    forms = {}
    backend = mesh_mod.group_backend
    for nccl in (False, True):
        if nccl:
            mesh_mod.group_backend = lambda g: "nccl"
        try:
            out = local.new_empty((world * 3, 7))
            all_gather_rows(out, local, group)
        finally:
            mesh_mod.group_backend = backend
        forms[nccl] = out.numpy()
    return {"stack": tree_to_numpy(gather_edge_stack(tree, group)),
            "per_leaf": {k: per_leaf(v.view(torch.uint8) if v.dtype ==
                                     torch.bool else v).numpy()
                         for k, v in tree.items()},
            "list_form": forms[False], "tensor_form": forms[True],
            "rows": per_leaf(local).numpy(), "ranks": world}


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


def step_train(case, mesh, opt):
    """Two train steps of ``case`` with optimizer ``opt`` over ``mesh``
    (``None``: unsharded): the losses and the (rank's blocks of the)
    parameters."""
    from repro_torch.interop import tree_from_numpy, tree_to_numpy
    from repro_torch.models import LM
    from repro_torch.train.layout import local_rows
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.state import TrainState, make_train_step
    model = LM(case["model_cfg"], device="cpu")
    tc = case["train_cfgs"][opt]
    params = tree_from_numpy(case["init"], "cpu")
    state = TrainState(params, init_opt_state(tc, params))
    step = make_train_step(model, tc, mesh=mesh)
    if mesh is not None:
        state = step.layout.shard_state(state)
    losses = []
    for tokens in case["tokens"]:
        state, met = step(state, local_rows(
            {"tokens": torch.from_numpy(tokens)}, mesh))
        losses.append(float(met["loss"]))
    return {"losses": losses, "params": tree_to_numpy(state.params)}


def step_prefill(case, mesh):
    from repro_torch.interop import tree_from_numpy
    from repro_torch.models import LM
    from repro_torch.train.layout import local_rows
    from repro_torch.train.state import make_prefill_step
    step = make_prefill_step(LM(case["model_cfg"], device="cpu"),
                             mesh=mesh)
    params = tree_from_numpy(case["init"], "cpu")
    if mesh is not None:
        params = step.layout.shard(params)
    tokens = {"tokens": torch.from_numpy(case["tokens"][0])}
    return step(params, local_rows(tokens, mesh)).numpy()


def step_decode(case, mesh, batch, window):
    """A prefill of ``case["prompt"]``'s first ``batch`` rows, then
    ``decode`` steps of its next tokens on the cache cut to the rank's
    blocks (``mesh=None``: the whole cache): the logits of each step (the
    rank's rows when the batch tiles its edge ranks), and the layout."""
    from repro_torch.interop import tree_from_numpy
    from repro_torch.models import LM
    from repro_torch.train.layout import local_rows
    from repro_torch.train.state import make_decode_step
    cfg = dataclasses.replace(case["model_cfg"], sliding_window=window)
    model = LM(cfg, device="cpu")
    params = tree_from_numpy(case["init"], "cpu")
    toks = torch.from_numpy(case["prompt"][:batch])
    n0, max_len = case["prefill_len"], case["max_len"]
    _, cache = model.prefill(params, toks[:, :n0],
                             model.init_cache(batch, max_len))
    step = make_decode_step(model, mesh=mesh, batch=batch, max_len=max_len)
    layout = "whole"
    if mesh is not None:
        params = step.layout.shard(params)
        cache = step.cache_layout.shard(cache)
        cl = step.cache_layout
        layout = ("batch" if cl.batch_split else
                  "sequence" if cl.kv_split is not None else "replicated")
    logits = []
    for i in range(case["decode"]):
        t = toks[:, n0 + i:n0 + i + 1]
        if layout == "batch":
            t = local_rows(t, mesh)
        out, cache = step(params, t, cache)
        logits.append(out.numpy())
    return {"logits": logits, "layout": layout}


def step_drop(case, mesh):
    """The dropping MoE case: its two train steps, and the dispatch of
    ``case["moe_x"]``'s rows on this rank through its first MoE block
    (``moe_p``), as the step's (over the edge group) and rank-local, and
    the grouped dispatch (``case["groups"]`` groups, a multiple of the
    edge ranks) over the edge group; each dispatch's aux values."""
    from repro_torch.interop import tree_from_numpy
    from repro_torch.models import moe as MoE
    from repro_torch.train.layout import edge_group, local_rows
    out = step_train(case, mesh, "sgd")
    p = tree_from_numpy(case["moe_p"], "cpu")
    x = local_rows(torch.from_numpy(case["moe_x"]), mesh)
    cfg = case["model_cfg"]
    grouped = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch_groups=case["groups"]))
    for name, c in (("dispatch", cfg), ("grouped", grouped)):
        y, aux = MoE.moe_ffn(p, c, x, edge_group(mesh))
        out[name] = y.numpy()
        out[name + "_aux"] = {k: float(v) for k, v in aux.items()}
    out["local"] = MoE.moe_ffn(p, cfg, x)[0].numpy()
    return out


def mesh_steps(spec, mesh):
    """The ``steps`` scenario of one mesh (see the module's doc)."""
    out = {}
    for case in spec["step_cases"]:
        if case.get("drop"):
            out["drop"] = step_drop(case, mesh)
            continue
        out[case["arch"]] = {
            "train": {opt: step_train(case, mesh, opt)
                      for opt in case["train_cfgs"]},
            "prefill": step_prefill(case, mesh),
            "decode": {f"{b}/{w}": step_decode(case, mesh, b, w)
                       for b, w in case["decodes"]}}
    return out


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
                       for c in spec["classic"]},
           "gather": gather_case(mesh)}
    if spec.get("one_edge_mesh"):        # one edge a rank
        one = make_mesh(*spec["one_edge_mesh"], device="cpu")
        out["one_edge"] = {c["name"]: classic_case(c, one)
                           for c in spec["classic"]}
    if spec.get("lm"):
        out["lm"] = lm_round(spec["lm"], world)
    if spec.get("model"):
        model_mesh = make_mesh(*spec["model_mesh"], device="cpu")
        out["model"] = {c["arch"]: model_axis(c, model_mesh)
                        for c in spec["model"]}
    if spec.get("step_meshes"):
        out["steps"] = {}
        for shape, axes in spec["step_meshes"]:
            step_mesh = make_mesh(shape, axes, device="cpu")
            out["steps"][tuple(shape)] = {
                "coordinate": step_mesh.coordinate,
                **mesh_steps(dict(spec, step_cases=[
                    c for c in spec["step_cases"]
                    if not c.get("drop") or tuple(shape) in c["meshes"]]),
                    step_mesh)}
    out["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in
                            ("jax", "jaxlib", "repro", "benchmarks"))
    with open(os.path.join(out_dir, f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
