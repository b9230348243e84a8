"""The compiled asynchronous EL engine on the device: a whole budgeted
async run with no host priority queue and no host sync per event.

The host ``ELSession.run_async`` drives a Python priority queue: pop the
next finishing edge, train its block, staleness-merge it into the global
model, update that edge's bandit, schedule its next block.  The reference
(``repro.el.events.program``) turns that loop into one
``lax.while_loop``: edge finish times live in an ``[E]`` array, and each
step

    argmin finish time  (the next event)
      → masked local block on the event edge (``make_local_block``)
      → staleness-weighted merge into the global model
      → utility → the event edge's bandit update + budget charge
      → schedule the edge's next block (``schedule_block``), its finish
        time, or ``+inf`` when its budget affords no arm

until the budgets silence every edge or the event horizon is reached.
Here the step is torch ops on the run's device, the event edge a device
index (gathers and ``where`` over the edge dimension, never a host int),
and the ``while_loop`` the sync round's pattern (``ChunkRunner``): fixed
chunks of masked steps, each captured once as a CUDA graph on a card,
termination and the next event's index read once per chunk.

**K-event waves** (``batch_k > 1``): a step pops the ``batch_k`` earliest
completions (edges by finish time, ties lower edge first, as successive
argmin pops take them), accepts the prefix of lanes that finish before
any block an earlier lane could reschedule (``wave_safe_gap``), runs the
accepted lanes' local blocks as one batched block over ``batch_k`` lanes
(one ``kmeans_assign`` launch a local step), and replays merge, bandit
and scheduling lane by lane under a validity mask, so every value equals
the single-event program's.  Lanes past the accepted prefix run masked
and write nothing.

Draws come through the RNG seam (``repro_torch.el.rng``) indexed by event:
a chunk's buffers hold every edge's draws for events ``[t_base, t_base +
R * batch_k)``, and lane j of a step at event t reads item ``t - t_base +
j``, row ``e_j``.  ``make_async_kernels`` hands the same per-event pieces
to the host twin (``repro_torch.el.events.reference``); at fixed cost the
two agree bit for bit.

Scenario bodies (ROADMAP Queue 1 item 10), telemetry rings (item 12) and
sharded runs (item 14) are not ported.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import OL4ELConfig
from repro_torch.core.bandit import device_bandit_update
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.el.events.knobs import resolve_async_batch_k
from repro_torch.el.events.scheduler import (schedule_block, staleness_alpha,
                                             staleness_merge, wave_safe_gap)
from repro_torch.el.events.state import (bandit_fleet_init, bandit_place,
                                         bandit_slice)
from repro_torch.el.ingraph import (ChunkRunner, ELCell, _edge_sum,
                                    _pad_edge_data, _tree_l2,
                                    check_ingraph_support, default_metric_fn,
                                    make_local_block)
from repro_torch.interop import tree_map

Params = Any
Carry = Dict[str, Any]
Knobs = Dict[str, torch.Tensor]


def _build_parts(model, edge_data, eval_set, cfg: OL4ELConfig, *,
                 lr: float, batch: int, metric_fn: Optional[Callable],
                 metric_name: str, device: torch.device):
    """The data-plane pieces both async paths share: the lane-indexed
    local block (the sync round's minibatch streams) and ``eval_step``,
    the one closure that yields (metric, utility)."""
    xs, ys, n_per_edge = _pad_edge_data(edge_data, device)
    local_block = make_local_block(model, xs, ys, n_per_edge, batch, lr,
                                   cfg.max_interval)
    if metric_fn is None:
        metric_fn = default_metric_fn(model, eval_set, metric_name)
    if cfg.utility == "eval_gain" and metric_fn is None:
        raise ValueError(
            "utility='eval_gain' needs a device metric; pass metric_fn= "
            "or use utility='param_delta'")
    nan = torch.full((), float("nan"), device=device)

    def eval_step(params: Params, prev_params: Params,
                  prev_metric: torch.Tensor):
        if cfg.utility == "eval_gain":
            with_gain = getattr(metric_fn, "with_gain", None)
            if with_gain is not None:      # XLA's one rounding of the gain
                return with_gain(params, prev_metric)
            metric = metric_fn(params)
            return metric, metric - prev_metric
        metric = metric_fn(params) if metric_fn is not None else nan
        return metric, 1.0 / (1.0 + _tree_l2(prev_params, params))

    return local_block, metric_fn, eval_step


def _at(a: torch.Tensor, *index: torch.Tensor) -> torch.Tensor:
    """``a[index]`` for 0-dim device index tensors, as a gather: torch
    turns a 0-dim integer index into a host int (a sync, refused inside a
    CUDA graph capture), so each index goes in as a 1-element one."""
    return a[tuple(i.reshape(1) for i in index)][0]


def _ascending(finish: torch.Tensor, edge_ids: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(finish[order], order)``: the edges by finish time, ties lower
    edge first (what successive argmin pops take), with no sort kernel
    and no host sync: edge e's place is the number of edges before it."""
    f_row, f_col = finish[None, :], finish[:, None]
    before = (f_row < f_col) | ((f_row == f_col)
                                & (edge_ids[None, :] < edge_ids[:, None]))
    order = torch.empty_like(edge_ids).scatter_(0, before.sum(1), edge_ids)
    return finish[order], order


def make_async_cell(model, edge_data, eval_set, cfg: OL4ELConfig, *,
                    lr: float, batch: int,
                    n_samples: Optional[np.ndarray] = None,
                    metric_fn: Optional[Callable] = None,
                    metric_name: str = "accuracy",
                    max_events: int = 256, mesh=None, telemetry=None,
                    batch_k: Optional[int] = None,
                    device: DeviceLike = None) -> ELCell:
    """The budgeted async event loop as an :class:`ELCell` on ``device``
    (default: the model's).  ``batch_k`` is the K-event wave width
    (``None``: ``resolve_async_batch_k(cfg)``); 1 builds the single-event
    body.  ``n_samples`` is ignored: the async global update is the
    staleness mix, not a weighted average."""
    del n_samples
    if mesh is not None:
        raise NotImplementedError(
            "make_async_cell(mesh=...): sharded runs arrive with ROADMAP "
            "Queue 1 item 14")
    if telemetry not in (None, False):
        raise NotImplementedError(
            "make_async_cell(telemetry=...): the device rings arrive with "
            "ROADMAP Queue 1 item 12")
    check_ingraph_support(cfg, caller="make_async_program")
    dev = resolve_device(device if device is not None
                         else getattr(model, "device", None))
    n_edges, k = cfg.n_edges, cfg.max_interval
    if len(edge_data) != n_edges:
        raise ValueError(f"cfg.n_edges = {n_edges} but the executor has "
                         f"{len(edge_data)} edge datasets")
    if batch_k is None:
        batch_k = resolve_async_batch_k(cfg)
    batch_k = max(1, min(int(batch_k), n_edges))
    local_block, metric_fn, eval_step = _build_parts(
        model, edge_data, eval_set, cfg, lr=lr, batch=batch,
        metric_fn=metric_fn, metric_name=metric_name, device=dev)

    pos = torch.arange(max_events, device=dev)
    edge_ids = torch.arange(n_edges, device=dev)
    lane_ids = torch.arange(batch_k, device=dev)
    always = torch.ones((), dtype=torch.bool, device=dev)
    n_edges_f = torch.tensor(float(max(n_edges, 1)), device=dev)

    def on_edge(hit: torch.Tensor, new, old):
        """``old`` with the rows where ``hit`` [E] holds set to ``new``."""
        return torch.where(hit.reshape((-1,) + (1,) * (old.dim() - 1)),
                           new, old)

    def init(init_params: Params, knobs: Knobs, draws) -> Carry:
        fleet = bandit_fleet_init(n_edges, k, dev)
        zero = torch.zeros((), device=dev)
        # every edge selects its first block, in edge order (the host
        # loop's pre-event decide / realized_cost round)
        sched = [schedule_block(
            bandit_slice(fleet, edge_ids[e]), knobs["budget"],
            knobs["costs_ek"][e],
            knobs["ucb_c"], knobs["min_edge_cost"][e], knobs["cost_noise"],
            knobs["comp"][e], knobs["comm"][e], zero,
            draws["init_gumbel"][e], draws["init_normal"][e])
            for e in range(n_edges)]
        gparams = tree_map(lambda p: p.to(dev, copy=True), init_params)
        prev_metric = (metric_fn(gparams).reshape(()).float()
                       if metric_fn is not None
                       else torch.full((), float("nan"), device=dev))
        hist = {
            "metric": torch.full((max_events,), float("nan"), device=dev),
            "utility": torch.zeros(max_events, device=dev),
            "interval": torch.zeros(max_events, dtype=torch.int32,
                                    device=dev),
            "edge": torch.full((max_events,), -1, dtype=torch.int32,
                               device=dev),
            "cost": torch.zeros(max_events, device=dev),
            "consumed": torch.zeros(max_events, device=dev),
            "wall": torch.zeros(max_events, device=dev),
        }
        return {"gparams": gparams,
                "edge_params": tree_map(lambda p: p.unsqueeze(0).repeat(
                    (n_edges,) + (1,) * p.dim()), gparams),
                "fleet": fleet,
                "consumed": torch.zeros(n_edges, device=dev),
                "finish": torch.stack([s[3] for s in sched]),
                "infl_i": torch.stack([s[1] for s in sched]),
                "infl_c": torch.stack([s[2] for s in sched]),
                "fetch_ver": torch.zeros(n_edges, dtype=torch.int64,
                                         device=dev),
                "version": torch.zeros((), dtype=torch.int64, device=dev),
                "t": torch.zeros((), dtype=torch.int64, device=dev),
                "prev_metric": prev_metric,
                "wall": torch.zeros((), device=dev),
                "hist": hist}

    def event_cap(knobs: Knobs) -> torch.Tensor:
        # the history length bounds the exact cap the knob carries
        return knobs["event_cap"].long().clamp(max=max_events)

    def cond(carry: Carry, knobs: Knobs) -> torch.Tensor:
        return ((carry["t"] < event_cap(knobs))
                & torch.isfinite(carry["finish"]).any())

    def event(state, knobs: Knobs, e, wall, interval, cost, p_new, gumbel,
              normal):
        """One completion of edge ``e`` (a 0-dim index) at ``wall``, its
        block's params ``p_new``: charge, merge, utility, bandit, and the
        edge's next block.  ``state`` is (gparams, fleet, consumed,
        fetch_ver, version, prev_metric)."""
        gparams, fleet, consumed, fetch_ver, version, prev_metric = state
        hit = edge_ids == e
        consumed = torch.where(hit, consumed + cost, consumed)
        alpha = staleness_alpha(knobs["async_alpha"], version,
                                _at(fetch_ver, e), n_edges_f)
        new_global = staleness_merge(gparams, p_new, alpha)
        version = version + 1
        metric, utility = eval_step(new_global, gparams, prev_metric)
        bstate_e = device_bandit_update(bandit_slice(fleet, e), interval - 1,
                                        utility, cost)
        fleet = bandit_place(fleet, e, bstate_e)
        fetch_ver = torch.where(hit, version, fetch_ver)
        _, nxt_i, nxt_c, fin = schedule_block(
            bstate_e, knobs["budget"] - _at(consumed, e),
            _at(knobs["costs_ek"], e), knobs["ucb_c"],
            _at(knobs["min_edge_cost"], e), knobs["cost_noise"],
            _at(knobs["comp"], e), _at(knobs["comm"], e), wall, gumbel,
            normal)
        state = (new_global, fleet, consumed, fetch_ver, version, metric)
        return state, utility, (nxt_i, nxt_c, fin)

    def commit(carry: Carry, state, ok, t, e, wall, interval, cost,
               utility, nxt):
        """Write event ``t``'s results into the carry where ``ok``: the
        edge's fetched model and next block, and the history row."""
        new_global, _, consumed, _, _, metric = state
        hit = (edge_ids == e) & ok
        nxt_i, nxt_c, fin = nxt
        at = (pos == t) & ok
        hist = carry["hist"]
        return dict(
            carry,
            edge_params=tree_map(lambda a, g: on_edge(hit, g.unsqueeze(0), a),
                                 carry["edge_params"], new_global),
            finish=torch.where(hit, fin, carry["finish"]),
            infl_i=torch.where(hit, nxt_i, carry["infl_i"]),
            infl_c=torch.where(hit, nxt_c, carry["infl_c"]),
            hist={
                "metric": torch.where(at, metric, hist["metric"]),
                "utility": torch.where(at, utility, hist["utility"]),
                "interval": torch.where(at, interval.int(),
                                        hist["interval"]),
                "edge": torch.where(at, e.int(), hist["edge"]),
                "cost": torch.where(at, cost, hist["cost"]),
                "consumed": torch.where(at, _edge_sum(consumed),
                                        hist["consumed"]),
                "wall": torch.where(at, wall, hist["wall"]),
            })

    def state_of(carry: Carry):
        return (carry["gparams"], carry["fleet"], carry["consumed"],
                carry["fetch_ver"], carry["version"], carry["prev_metric"])

    def with_state(carry: Carry, state) -> Carry:
        gparams, fleet, consumed, fetch_ver, version, metric = state
        return dict(carry, gparams=gparams, fleet=fleet, consumed=consumed,
                    fetch_ver=fetch_ver, version=version, prev_metric=metric)

    def item(draws, offset: torch.Tensor) -> torch.Tensor:
        """A chunk-buffer index, kept inside the buffers (a masked step's
        offset may point past the chunk)."""
        return offset.clamp(0, draws["gumbel"].shape[0] - 1)

    def body_one(carry: Carry, knobs: Knobs, draws) -> Carry:
        t = carry["t"]
        e = torch.argmin(carry["finish"])           # the event horizon
        wall = _at(carry["finish"], e)
        interval, cost = _at(carry["infl_i"], e), _at(carry["infl_c"], e)
        at = item(draws, t - draws["t_base"])
        lanes = e.reshape(1)
        p_new = local_block(tree_map(lambda a: a[lanes], carry["edge_params"]),
                            interval.reshape(1),
                            draws["uniform"][at.reshape(1), lanes], lanes)
        state, utility, nxt = event(
            state_of(carry), knobs, e, wall, interval, cost,
            tree_map(lambda a: a[0], p_new), _at(draws["gumbel"], at, e),
            _at(draws["normal"], at, e))
        carry = commit(carry, state, always, t, e, wall, interval, cost,
                       utility, nxt)
        return dict(with_state(carry, state), t=t + 1, wall=wall)

    def body_wave(carry: Carry, knobs: Knobs, draws) -> Carry:
        t0 = carry["t"]
        f_all, e_all = _ascending(carry["finish"], edge_ids)
        f_sorted, e_sorted = f_all[:batch_k], e_all[:batch_k]
        gap = wave_safe_gap(knobs["min_edge_cost"], knobs["cost_noise"])
        # a prefix mask: every guard is monotone in the lane index, so
        # lane j is event t0 + j
        valid = (lane_ids == 0) | (torch.isfinite(f_sorted)
                                   & (f_sorted < f_sorted[0] + gap)
                                   & (t0 + lane_ids < event_cap(knobs)))
        n_batch = valid.sum()
        interval_l = carry["infl_i"][e_sorted]
        cost_l = carry["infl_c"][e_sorted]
        at = item(draws, t0 - draws["t_base"] + lane_ids)
        # the data plane: one batched block over the lanes, each from the
        # params its edge fetched before this wave (lanes are distinct
        # edges); lanes past the prefix run masked
        p_new = local_block(tree_map(lambda a: a[e_sorted],
                                     carry["edge_params"]),
                            torch.where(valid, interval_l, 0),
                            draws["uniform"][at, e_sorted], e_sorted)
        gumbel, normal = draws["gumbel"][at, e_sorted], \
            draws["normal"][at, e_sorted]
        # the control plane: the merge chain is sequential (lane j + 1
        # merges into lane j's model), replayed lane by lane, masked
        for j in range(batch_k):
            ok = valid[j]
            state, utility, nxt = event(
                state_of(carry), knobs, e_sorted[j], f_sorted[j],
                interval_l[j], cost_l[j], tree_map(lambda a: a[j], p_new),
                gumbel[j], normal[j])
            if j:
                state = tree_map(lambda n, o: torch.where(ok, n, o), state,
                                 state_of(carry))
            carry = with_state(
                commit(carry, state, ok, t0 + j, e_sorted[j], f_sorted[j],
                       interval_l[j], cost_l[j], utility, nxt), state)
        return dict(carry, t=t0 + n_batch, wall=_at(f_sorted, n_batch - 1))

    def finalize(carry: Carry, knobs: Knobs) -> Tuple[Params, Dict]:
        out = dict(carry["hist"])
        out["n_rounds"] = carry["t"]
        out["budgets_left"] = knobs["budget"] - carry["consumed"]
        out["arm_pulls"] = carry["fleet"]["counts"]                # [E, K]
        out["wall_time"] = carry["wall"]
        # blocks still in flight at exit: 0 means the budgets silenced
        # every edge ("budget_exhausted"), more that the horizon cut the
        # run ("max_events")
        out["n_active"] = torch.isfinite(carry["finish"]).sum()
        return carry["gparams"], out

    draw_shapes = {"gumbel": (n_edges, k), "uniform": (n_edges, k, batch),
                   "normal": (n_edges,)}
    return ELCell(init=init, cond=cond,
                  body=body_one if batch_k == 1 else body_wave,
                  finalize=finalize, horizon=max_events,
                  draw_shapes=draw_shapes, device=dev,
                  init_draw_shapes={"init_gumbel": (n_edges, k),
                                    "init_normal": (n_edges,)},
                  items_per_step=batch_k)


class AsyncProgram(ChunkRunner):
    """The async engine on a :class:`ChunkRunner`: a chunk is
    ``rounds_per_chunk`` steps of up to ``batch_k`` events each, so its
    draw buffers hold ``rounds_per_chunk x batch_k`` events from the
    chunk's first; every step reads the whole buffers and its own offset
    from ``t_base``."""

    def _step_draws(self, r: int, t_base: torch.Tensor) -> Dict[str, Any]:
        return dict(self.draw_bufs, t_base=t_base)


def make_async_program(model, edge_data, eval_set, cfg: OL4ELConfig, *,
                       lr: float, batch: int,
                       n_samples: Optional[np.ndarray] = None,
                       metric_fn: Optional[Callable] = None,
                       metric_name: str = "accuracy",
                       max_events: int = 256, mesh=None, telemetry=None,
                       batch_k: Optional[int] = None,
                       device: DeviceLike = None,
                       rounds_per_chunk: int = 16) -> AsyncProgram:
    """Build ``program(init_params, knobs, draws) -> (params, out)`` — the
    whole budgeted async run as device-resident chunks of masked event
    steps (:class:`AsyncProgram`), with the knobs (``ASYNC_KNOB_NAMES`` /
    ``async_knobs``) as inputs so one program serves any knob point, and
    the draws from an RNG-seam provider.

    ``out`` holds per-event ``metric``, ``utility``, ``interval``,
    ``edge``, ``cost`` (the charge), ``consumed`` (cumulative total over
    edges) and ``wall`` (the event time), plus ``n_rounds`` (events),
    ``wall_time``, the final per-edge ``budgets_left``, the per-edge
    bandits' ``arm_pulls`` ``[E, K]`` and ``n_active`` (blocks in flight
    at exit).
    """
    cell = make_async_cell(
        model, edge_data, eval_set, cfg, lr=lr, batch=batch,
        n_samples=n_samples, metric_fn=metric_fn, metric_name=metric_name,
        max_events=max_events, mesh=mesh, telemetry=telemetry,
        batch_k=batch_k, device=device)
    return AsyncProgram(cell, rounds_per_chunk)


def make_async_kernels(model, edge_data, eval_set, cfg: OL4ELConfig, *,
                       lr: float, batch: int,
                       metric_fn: Optional[Callable] = None,
                       metric_name: str = "accuracy",
                       device: DeviceLike = None) -> Dict[str, Any]:
    """The per-event pieces of ``make_async_program`` for the host twin:
    the same closures and ops, so the twin reproduces the program's
    arithmetic exactly."""
    check_ingraph_support(cfg, caller="make_async_kernels")
    dev = resolve_device(device if device is not None
                         else getattr(model, "device", None))
    local_block, metric_fn, eval_step = _build_parts(
        model, edge_data, eval_set, cfg, lr=lr, batch=batch,
        metric_fn=metric_fn, metric_name=metric_name, device=dev)
    n_edges_f = torch.tensor(float(max(cfg.n_edges, 1)), device=dev)

    def merge(gparams, p_new, alpha0, version, fetch_ver):
        alpha = staleness_alpha(alpha0, version, fetch_ver, n_edges_f)
        return staleness_merge(gparams, p_new, alpha)

    return {
        "device": dev,
        "local_train": local_block,
        "schedule": schedule_block,
        "merge": merge,
        "metric": metric_fn,
        "eval_step": eval_step,
        "bandit_update": device_bandit_update,
    }
