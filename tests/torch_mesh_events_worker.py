"""One rank of a gloo world, for ``tests/test_torch_mesh_events.py``.

    python tests/torch_mesh_events_worker.py SPEC.pkl OUT_DIR

run as every rank of a world that ``repro_torch.launch.hostdev.
spawn_ranks`` starts.  It imports the port only (never jax or the
reference), runs :func:`run_all` over the world's mesh and pickles what
it saw to ``OUT_DIR/rank<r>.pkl``.  The test file calls the same
:func:`run_all` with ``mesh=None`` for the unsharded port runs, so both
sides run one code path:

  * ``async``: per arch, ``run_async_ingraph(mesh=, contract=True)`` on
    the replayed draws at ``"one"`` event a step and at the ``"auto"``
    wave width (0, resolved on the mesh; without one, ``spec["auto_k"]``,
    the width the worlds resolve): events, final params, the census, the
    device loop, the cell's flags; then the auto-width run donated, and
    whether running the donated params again raises;
  * ``scenario``: the churn scenario's sync round and async event run
    (their device loops and cells' flags too);
  * ``sweep``: a 4-cell sync grid and a 4-cell async grid (two wave
    widths) through ``ELSession.sweep(mesh=)``, and the error of a 3-cell
    grid;
  * ``fleet``: a ``FleetServer(mesh=)`` of 4 slots, tenants admitted
    mid-flight: its reports, its subscriber stream and ``stats()``;
  * ``scenario_one_edge`` (a world given ``one_edge_mesh``): the churn
    scenario's runs over that mesh, one edge a rank;
  * ``modules``: any ``jax`` / ``repro`` / ``benchmarks`` module the rank
    imported.
"""

import dataclasses
import math
import os
import pickle
import sys

import numpy as np
import torch

_FIXTURES = {}


def fixture(arch, spec):
    from repro_torch.launch.classic import classic_fixture
    if arch not in _FIXTURES:
        _FIXTURES[arch] = classic_fixture(arch, samples=spec["samples"],
                                          n_edges=spec["edges"],
                                          device="cpu")
    return _FIXTURES[arch]


def session(fx, cfg_kw, init=None, params=None):
    """A session on ``fx``'s executor with its config replaced by
    ``cfg_kw``, from ``params``, ``init`` (numpy) or the fixture's
    params."""
    from repro_torch.el import ELSession
    from repro_torch.interop import tree_from_numpy
    cfg = dataclasses.replace(fx["exp"].ol4el, **cfg_kw)
    if params is None:
        params = (fx["init_params"] if init is None
                  else tree_from_numpy(init, "cpu"))
    return (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
            .with_executor(fx["executor"], init_params=params,
                           n_samples=fx["n_samples"]
                           if cfg.mode == "sync" else None))


def events(rep):
    return [(r.edge, r.interval, r.total_consumed, r.wall_time, r.metric,
             r.utility) for r in rep.records]


def numpy_tree(tree):
    from repro_torch.interop import tree_to_numpy
    return tree_to_numpy(tree)


def cell_flags(sess):
    """The ``sharded`` / ``capturable`` flags of the session's last
    program's cell."""
    cell = sess._fastpath.cell
    return cell.sharded, cell.capturable


def async_case(case, spec, mesh):
    from repro_torch.el.rng import ReplayDraws
    fx = fixture(case["arch"], spec)
    auto = 0 if mesh is not None else spec["auto_k"]
    out = {}
    for name, k in (("one", 1), ("auto", auto)):
        kw = dict(case["cfg"], async_batch_k=k)
        sess = session(fx, kw, case["init"])
        rep = sess.run_async_ingraph(
            draws=ReplayDraws(**case["draws"]), mesh=mesh, contract=True)
        prof = rep.telemetry["profile"]
        out[name] = {"events": events(rep), "params": numpy_tree(
            rep.final_params), "arm_pulls": list(rep.arm_pulls),
            "n": rep.n_aggregations, "terminated": rep.terminated_reason,
            "final": rep.final_metric, "wall": rep.wall_time,
            "collectives": prof["collectives"],
            "collective_bytes": prof["collective_bytes"],
            "alias_bytes": prof["alias_bytes"],
            "device_loop": rep.telemetry["device_loop"],
            "cell": cell_flags(sess)}
    from repro_torch.interop import tree_from_numpy
    donated = tree_from_numpy(case["init"], "cpu")
    sess = session(fx, dict(case["cfg"], async_batch_k=auto), params=donated)
    drep = sess.run_async_ingraph(draws=ReplayDraws(**case["draws"]),
                                  mesh=mesh, donate=True, contract=True)
    try:
        sess.run_async_ingraph(draws=ReplayDraws(**case["draws"]),
                               mesh=mesh, donate=True)
        reuse = "ran"
    except RuntimeError as e:
        reuse = str(e)
    out["donated"] = {
        "events": events(drep), "params": numpy_tree(drep.final_params),
        "alias_bytes": drep.telemetry["profile"]["alias_bytes"],
        "shares_storage": all(drep.final_params[k].data_ptr()
                              == donated[k].data_ptr() for k in donated),
        "reuse": reuse}
    return out


def scenario_case(case, spec, mesh):
    from repro_torch.el.rng import ReplayDraws
    from repro_torch.el.scenarios import ChurnSpec, ScenarioSpec
    fx = fixture(case["arch"], spec)
    scn = ScenarioSpec(churn=ChurnSpec(rate=0.3, period=16))
    out = {}
    for mode in ("sync", "async"):
        sess = session(fx, dict(case["cfg"], mode=mode, scenario=scn),
                       case["init"])
        draws = ReplayDraws(**case["draws"][mode])
        if mode == "sync":
            rep = sess.run_sync_ingraph(max_rounds=case["rounds"],
                                        draws=draws, mesh=mesh,
                                        contract=True)
        else:
            rep = sess.run_async_ingraph(draws=draws, mesh=mesh,
                                         contract=True)
        out[mode] = {"raw": rep.raw, "params": numpy_tree(rep.final_params),
                     "collectives": rep.telemetry["profile"]["collectives"],
                     "device_loop": rep.telemetry["device_loop"],
                     "cell": cell_flags(sess)}
    return out


def sweep_case(case, spec, mesh):
    from repro_torch.el.sweep import SweepSpec
    fx = fixture(case["arch"], spec)
    out = {}
    for mode, grid in case["grids"].items():
        rep = session(fx, dict(case["cfg"], mode=mode)).sweep(
            SweepSpec(**grid), mesh=mesh)
        out[mode] = {"out": rep.out, "params": numpy_tree(rep.final_params),
                     "finals": list(rep.final_metrics()),
                     "loops": rep.telemetry["device_loops"]}
    try:
        session(fx, case["cfg"]).sweep(SweepSpec(**case["untiled"]),
                                       mesh=mesh)
        out["untiled"] = None
    except ValueError as e:
        out["untiled"] = str(e)
    return out


def fleet_case(case, spec, mesh):
    from repro_torch.el.fleet import (FleetServer, ReportReady, RoundDelta,
                                      TenantRun)
    fx = fixture(case["arch"], spec)

    def run(i, t):
        cfg = dataclasses.replace(fx["exp"].ol4el, **dict(case["cfg"], **t))
        return TenantRun(cfg=cfg, executor=fx["executor"],
                         tenant_id=f"tenant-{i}", metric_name=fx["metric"],
                         n_samples=fx["n_samples"]
                         if cfg.mode == "sync" else None,
                         init_params=fx["init_params"],
                         max_rounds=case["rounds"])

    stream = []

    def on_event(ev):
        if isinstance(ev, RoundDelta):
            r = ev.record
            stream.append(("delta", ev.tenant_id, r.n_aggregations,
                           r.interval, r.edge, r.total_consumed,
                           r.wall_time, r.metric, r.utility))
        elif isinstance(ev, ReportReady):
            stream.append(("ready", ev.tenant_id, ev.report.n_aggregations,
                           ev.report.final_metric))

    server = FleetServer(n_slots=case["slots"],
                         rounds_per_wave=case["rounds_per_wave"], mesh=mesh,
                         device="cpu").subscribe(on_event)
    first, later = case["tenants"][:case["first"]], \
        case["tenants"][case["first"]:]
    for i, t in enumerate(first):
        server.submit(run(i, t))
    for _ in range(case["waves_before_more"]):
        server.step()
    for i, t in enumerate(later, len(first)):
        server.submit(run(i, t))
    reports = server.drain()
    return {"reports": {tid: {"events": events(r), "params": numpy_tree(
        r.final_params), "final": r.final_metric, "n": r.n_aggregations,
        "terminated": r.terminated_reason}
        for tid, r in reports.items()},
        "stream": stream, "stats": server.stats(),
        "sharded": [c.batch.shard is not None for c in server.cohorts()]}


def run_all(spec, mesh):
    """Every case of ``spec`` over ``mesh`` (``None``: unsharded)."""
    torch.set_num_threads(1)
    return {"async": {c["arch"]: async_case(c, spec, mesh)
                      for c in spec["async"]},
            "scenario": scenario_case(spec["scenario"], spec, mesh),
            "sweep": sweep_case(spec["sweep"], spec, mesh),
            "fleet": fleet_case(spec["fleet"], spec, mesh)}


def same(a, b) -> bool:
    """Equal, NaNs equal, arrays and floats bit for bit."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


def main():
    spec_path, out_dir = sys.argv[1:3]
    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(*spec["mesh"], device="cpu")
    out = {"rank": mesh.rank, "mesh": dict(mesh.shape),
           **run_all(spec, mesh)}
    if spec.get("one_edge_mesh"):        # one edge a rank
        out["scenario_one_edge"] = scenario_case(
            spec["scenario"], spec, make_mesh(*spec["one_edge_mesh"],
                                              device="cpu"))
    out["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in
                            ("jax", "jaxlib", "repro", "benchmarks"))
    with open(os.path.join(out_dir, f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
