"""The host twin of the compiled async program: ``run_async`` on the
program's draws.

``ELSession.run_async(rng_streams="jax")`` lands here (the name is the
reference's: "the compiled program's streams", which in the port are the
RNG seam's).  It is the same priority-queue event loop as the numpy host
path (a heap of ``(finish_time, edge, interval, cost)`` blocks, staleness
merges, per-edge bandits, charge-at-completion budgets), but every draw
comes from the seam provider the compiled program reads, indexed by
event, and every piece of arithmetic runs through the program's own
per-event pieces (``make_async_kernels``), in f32.  So it is the
transparent twin of the compiled scheduler: at fixed cost the two agree
bit for bit on event order, merge values and charged costs, and any
divergence is a fault of the device loop.

Like the reference's twin it has no scenario branch: with
``cfg.scenario`` set it runs the scenario-less event loop (no masks, no
multipliers, no drift; the scenario knobs ``async_knobs`` adds go
unread).
"""

from __future__ import annotations

import heapq
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import OL4ELConfig
from repro_torch.core.bandit import device_bandit_init
from repro_torch.el.events.knobs import async_knobs, default_event_horizon
from repro_torch.el.events.program import make_async_kernels
from repro_torch.el.ingraph import _edge_sum, _knob_tensor
from repro_torch.el.report import ELReport, RoundRecord
from repro_torch.el.rng import TorchDraws
from repro_torch.interop import tree_map

Params = Any


def run_async_reference(executor, cfg: OL4ELConfig, init_params: Params, *,
                        metric_name: str = "accuracy",
                        metric_fn: Optional[Callable] = None,
                        max_events: Optional[int] = None, draws=None,
                        callbacks: Sequence[Callable] = ()) -> ELReport:
    """Run the async event queue on the host with the compiled program's
    draws and f32 arithmetic; returns an ``ELReport``.

    ``draws`` is the seam provider; ``None`` draws from a
    ``torch.Generator`` on the executor's device seeded with ``cfg.seed
    + 17``, as ``run_async_ingraph`` does.  The metric is evaluated at
    every event (the bandits consume the utility of every event).
    """
    t0 = time.perf_counter()
    horizon = (default_event_horizon(cfg) if max_events is None
               else int(max_events))
    kernels = make_async_kernels(
        executor.model, executor.edge_data, executor.eval_set, cfg,
        lr=executor.lr, batch=executor.batch, metric_fn=metric_fn,
        metric_name=metric_name, device=getattr(executor, "device", None))
    dev = kernels["device"]
    knobs = {k: _knob_tensor(v, dev) for k, v in async_knobs(cfg).items()}
    n_edges, k_arms = cfg.n_edges, cfg.max_interval
    if draws is None:
        draws = TorchDraws(torch.Generator(device=dev)
                           .manual_seed(cfg.seed + 17))
    init_bufs = {"init_gumbel": torch.zeros(n_edges, k_arms, device=dev),
                 "init_normal": torch.zeros(n_edges, device=dev)}
    bufs = {"gumbel": torch.zeros(1, n_edges, k_arms, device=dev),
            "uniform": torch.zeros(1, n_edges, k_arms, executor.batch,
                                   device=dev),
            "normal": torch.zeros(1, n_edges, device=dev)}
    draws.fill_init(init_bufs)

    def schedule(edge: int, bstate, resid, wall, gumbel, normal):
        return kernels["schedule"](
            bstate, resid, knobs["costs_ek"][edge], knobs["ucb_c"],
            knobs["min_edge_cost"][edge], knobs["cost_noise"],
            knobs["comp"][edge], knobs["comm"][edge], wall, gumbel, normal)

    bandits = [device_bandit_init(k_arms, dev) for _ in range(n_edges)]
    # in-flight blocks: (finish_time, edge, interval, cost) — the same
    # realized-cost draw sets the finish time and is charged at completion
    heap: List[Tuple[float, int, int, float]] = []
    zero = torch.zeros((), device=dev)
    for e in range(n_edges):
        active, interval, cost, finish = schedule(
            e, bandits[e], knobs["budget"], zero,
            init_bufs["init_gumbel"][e], init_bufs["init_normal"][e])
        if bool(active):
            heapq.heappush(heap, (float(finish), e, int(interval),
                                  float(cost)))

    global_params = tree_map(lambda p: p.to(dev, copy=True), init_params)
    edge_params: List[Params] = [global_params] * n_edges
    edge_ids = torch.arange(n_edges, device=dev)
    consumed = torch.zeros(n_edges, device=dev)
    fetch_version = [0] * n_edges
    version = 0
    if kernels["metric"] is not None:
        prev_metric = kernels["metric"](global_params).reshape(()).float()
    else:
        prev_metric = torch.full((), float("nan"), device=dev)

    def scalar(v, dtype=torch.float32):
        return torch.tensor(v, dtype=dtype, device=dev)

    records: List[RoundRecord] = []
    wall, t = 0.0, 0
    while heap and t < horizon:
        wall, e, interval, cost = heapq.heappop(heap)
        draws.fill(bufs, t)
        # edge e finishes `interval` local iterations and uploads
        lanes = torch.tensor([e], device=dev)
        p_new = kernels["local_train"](
            tree_map(lambda a: a.unsqueeze(0), edge_params[e]),
            scalar([interval], torch.int64), bufs["uniform"][:, e], lanes)
        p_new = tree_map(lambda a: a[0], p_new)
        cost_t = scalar(cost)
        consumed = torch.where(edge_ids == e, consumed + cost_t, consumed)
        new_global = kernels["merge"](
            global_params, p_new, knobs["async_alpha"],
            scalar(version, torch.int64), scalar(fetch_version[e],
                                                 torch.int64))
        version += 1
        metric, utility = kernels["eval_step"](new_global, global_params,
                                               prev_metric)
        bandits[e] = kernels["bandit_update"](
            bandits[e], scalar(interval - 1, torch.int64), utility, cost_t)
        t += 1
        rec = RoundRecord(wall, float(_edge_sum(consumed)), float(metric),
                          float(utility), float(interval), e, t)
        records.append(rec)
        for cb in callbacks:
            cb(rec)
        # edge e fetches the fresh global model, schedules its next block
        edge_params[e] = new_global
        fetch_version[e] = version
        active, nxt_i, nxt_c, finish = schedule(
            e, bandits[e], knobs["budget"] - consumed[e], scalar(wall),
            bufs["gumbel"][0, e], bufs["normal"][0, e])
        if bool(active):
            heapq.heappush(heap, (float(finish), e, int(nxt_i),
                                  float(nxt_c)))
        prev_metric = metric
        global_params = new_global

    pulls = np.zeros(k_arms, np.int64)
    for b in bandits:
        pulls += b["counts"].cpu().numpy().astype(np.int64)
    final = executor.evaluate(global_params)[metric_name]
    return ELReport(
        records=records,
        final_metric=float(final),
        n_aggregations=t,
        total_consumed=float(_edge_sum(consumed)),
        wall_time=wall,
        terminated_reason="max_events" if heap else "budget_exhausted",
        policy=cfg.policy,
        mode="async",
        arm_pulls=[int(c) for c in pulls],
        elapsed_s=time.perf_counter() - t0,
        final_params=global_params,
    )
