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

**Scenarios** (``cfg.scenario``, K = 1 only): ``body_one_scn`` reads row
``t % period`` of the activity and cost-multiplier schedules at event t.
A popped edge that is dropped out makes a *probe*: its block runs masked
(interval 0), and it charges nothing, pulls no arm, bumps no version and
retries the same block ``min_edge_cost[e]`` later.  A live edge's next
block is scheduled on costs scaled by its straggler multiplier, and the
drift rotates the sampled indices.  The scenario body takes the same
draws as the scenario-less one.

**Telemetry** (``telemetry=``, ``repro_torch.obs.rings``): every event
records its edge, arm, charge, the edge's residual budget, the merge's
alpha and staleness, the inter-arrival time and the edge's bandit
statistics at slot ``t % ring_size``; a wave writes its accepted lanes'
rows.  Off, the carry is the ungated one.

**Over ranks** (``mesh=``, a ``repro_torch.launch.mesh.Mesh``): the
per-edge datasets and the ``[E, ...]`` fetched-params stack split over
the mesh's edge axes (``repro_torch.launch.mesh.edge_shard``: tiled, or
replicated when the edge count does not tile them); everything else (the
bandits, budgets, finish times, the event order, the draws, the global
params, termination) is control plane, computed by every rank from the
same inputs.  A step's data plane runs on the owners: every rank runs
the same fixed-width block (one lane for a single event, ``batch_k`` for
a wave), a lane whose edge it does not own masked (interval 0, its row
index clamped into the rank's rows); one all-gather of the ``[L, ...]``
results follows (``gather_edge_stack``), and lane l takes the owner's
row.  Only the owner writes an event's new global model into its row of
the stack.  Nothing is summed across ranks, and a lane's result does not
depend on the lanes beside it, so a sharded run is bit-identical on
every rank to the unsharded one.  On NCCL ranks its chunks are CUDA
graphs that hold the gathers, as an unsharded run's are; over gloo they
run eagerly (``ELCell.capturable``).
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
                                    gain_fn, make_local_block)
from repro_torch.interop import tree_map

Params = Any
Carry = Dict[str, Any]
Knobs = Dict[str, torch.Tensor]


def _build_parts(model, edge_data, eval_set, cfg: OL4ELConfig, *,
                 lr: float, batch: int, metric_fn: Optional[Callable],
                 metric_name: str, device: torch.device,
                 drift: bool = False, rows: slice = slice(None)):
    """The data-plane pieces both async paths share: the lane-indexed
    local block (the sync round's minibatch streams; ``drift=`` the
    scenario path's drift-aware one) over the datasets of the edges
    ``rows`` (a rank's shard; its lanes index them) and ``eval_step``, the
    one closure that yields (metric, utility)."""
    xs, ys, n_per_edge = _pad_edge_data(edge_data, device, rows)
    local_block = make_local_block(model, xs, ys, n_per_edge, batch, lr,
                                   cfg.max_interval, drift=drift)
    if metric_fn is None:
        metric_fn = default_metric_fn(model, eval_set, metric_name)
    if cfg.utility == "eval_gain" and metric_fn is None:
        raise ValueError(
            "utility='eval_gain' needs a device metric; pass metric_fn= "
            "or use utility='param_delta'")
    nan = torch.full((), float("nan"), device=device)
    eval_gain = gain_fn(metric_fn) if cfg.utility == "eval_gain" else None

    def eval_step(params: Params, prev_params: Params,
                  prev_metric: torch.Tensor):
        if eval_gain is not None:
            return eval_gain(params, prev_metric)
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
    rank = before.sum(1)
    order = torch.zeros_like(rank).scatter(0, rank, edge_ids)
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
    (``None``: ``resolve_async_batch_k(cfg, mesh)``); 1 builds the
    single-event body.  With ``cfg.scenario`` set the body is the single-event
    scenario body (``batch_k`` > 1 raises) and the history gains
    ``active_edges``.  ``n_samples`` is ignored: the async global update
    is the staleness mix, not a weighted average.  ``telemetry=`` gates
    the rings (see ``make_sync_cell``); a wave wider than the ring
    raises.  ``mesh=``: the run over the mesh's ranks (see the module's
    docstring); the cell's ``sharded`` flag says whether it gathers (it
    does not when the edge dim replicates) and ``capturable`` whether a
    CUDA graph can hold the gathers."""
    from repro_torch.launch.mesh import edge_shard, graph_capturable
    from repro_torch.obs.rings import (as_spec, async_ring_init,
                                       async_ring_record,
                                       async_ring_record_wave,
                                       finalize_telemetry)
    del n_samples
    spec = as_spec(telemetry)
    check_ingraph_support(cfg, caller="make_async_program")
    dev = resolve_device(device if device is not None
                         else getattr(model, "device", None))
    # the fleet-dynamics scenario: None keeps every closure below the
    # scenario-less engine; a ScenarioSpec swaps in the churn-aware
    # single-event body (dropout probes, uncharged dead edges)
    scn = cfg.scenario
    period = scn.period if scn is not None else 0
    n_edges, k = cfg.n_edges, cfg.max_interval
    if len(edge_data) != n_edges:
        raise ValueError(f"cfg.n_edges = {n_edges} but the executor has "
                         f"{len(edge_data)} edge datasets")
    if batch_k is None:
        batch_k = resolve_async_batch_k(cfg, mesh)
    batch_k = max(1, min(int(batch_k), n_edges))
    if scn is not None and batch_k > 1:
        raise ValueError(
            f"async_batch_k={batch_k} with a ScenarioSpec: the scenario "
            "path (per-event activity masks, dropout probes) is defined "
            "on the single-event program only — pin async_batch_k=1 or "
            "leave it 0 (auto resolves to 1 under a scenario)")
    if spec is not None and batch_k > spec.ring_size:
        raise ValueError(
            f"async_batch_k={batch_k} exceeds the telemetry ring size "
            f"{spec.ring_size}: a wave's per-event ring writes would "
            "collide within one scatter — raise telemetry= or lower "
            "the batch width")
    shard = edge_shard(mesh, n_edges)
    n_local = n_edges if shard is None else shard.n_local
    my_rows = slice(None) if shard is None else shard.rows
    local_block, metric_fn, eval_step = _build_parts(
        model, edge_data, eval_set, cfg, lr=lr, batch=batch,
        metric_fn=metric_fn, metric_name=metric_name, device=dev,
        drift=scn is not None,
        rows=my_rows)

    pos = torch.arange(max_events, device=dev)
    edge_ids = torch.arange(n_edges, device=dev)
    # the edges of this rank's rows of the fetched-params stack
    local_ids = edge_ids[my_rows]
    lane_ids = torch.arange(batch_k, device=dev)
    always = torch.ones((), dtype=torch.bool, device=dev)
    n_edges_f = torch.tensor(float(max(n_edges, 1)), device=dev)

    def on_edge(hit: torch.Tensor, new, old):
        """``old`` with the rows where ``hit`` [E] holds set to ``new``."""
        return torch.where(hit.reshape((-1,) + (1,) * (old.dim() - 1)),
                           new, old)

    def owned(lanes: torch.Tensor, interval: torch.Tensor):
        """(rows, interval): each lane's row in this rank's stack and
        datasets, and its interval, 0 (masked) where the rank does not own
        the lane's edge, whose row index is then clamped into the rank's
        rows."""
        if shard is None:
            return lanes, interval
        rows, mine = shard.local_rows(lanes)
        return rows, torch.where(mine, interval, 0)

    def block(edge_params: Params, lanes: torch.Tensor,
              interval: torch.Tensor, uniform: torch.Tensor,
              shift: Optional[torch.Tensor] = None) -> Params:
        """The lanes' local blocks, each from the params its edge fetched,
        run by the edges' owners."""
        rows, interval = owned(lanes, interval)
        kw = {} if shift is None else {"shift": shift}
        p_lanes = local_block(
            tree_map(lambda a: a[rows], edge_params), interval, uniform,
            rows, **kw)
        # one gather of every rank's lanes, each lane's from its owner
        return p_lanes if shard is None else shard.from_owners(p_lanes,
                                                               lanes)

    def init(init_params: Params, knobs: Knobs, draws, *,
             copy: bool = True) -> Carry:
        """The initial carry; ``copy=False`` (a donated run) takes
        ``init_params``' tensors as the global model's own."""
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
        gparams = tree_map(lambda p: p.to(dev, copy=copy), init_params)
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
        if scn is not None:
            hist["active_edges"] = torch.zeros(max_events, dtype=torch.int32,
                                               device=dev)
        carry = {"gparams": gparams,
                 "edge_params": tree_map(lambda p: p.unsqueeze(0).repeat(
                     (n_local,) + (1,) * p.dim()), gparams),
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
        if spec is not None:
            carry["telem"] = async_ring_init(
                spec, k, scenario=scn is not None, device=dev)
        return carry

    def event_cap(knobs: Knobs) -> torch.Tensor:
        # the history length bounds the exact cap the knob carries
        return knobs["event_cap"].long().clamp(max=max_events)

    def cond(carry: Carry, knobs: Knobs) -> torch.Tensor:
        return ((carry["t"] < event_cap(knobs))
                & torch.isfinite(carry["finish"]).any())

    def staleness(version, fetch_ver_e):
        """The raw staleness the ring records: ``staleness_alpha``'s
        exact f32 expression."""
        return (version - fetch_ver_e).float() / n_edges_f

    def event(state, knobs: Knobs, e, wall, interval, cost, p_new, gumbel,
              normal):
        """One completion of edge ``e`` (a 0-dim index) at ``wall``, its
        block's params ``p_new``: charge, merge, utility, bandit, and the
        edge's next block.  ``state`` is (gparams, fleet, consumed,
        fetch_ver, version, prev_metric).  Also returns the event's ring
        signals (``None`` with telemetry off)."""
        gparams, fleet, consumed, fetch_ver, version, prev_metric = state
        hit = edge_ids == e
        consumed = torch.where(hit, consumed + cost, consumed)
        alpha = staleness_alpha(knobs["async_alpha"], version,
                                _at(fetch_ver, e), n_edges_f)
        stale = (staleness(version, _at(fetch_ver, e))
                 if spec is not None else None)
        new_global = staleness_merge(gparams, p_new, alpha)
        version = version + 1
        metric, utility = eval_step(new_global, gparams, prev_metric)
        bstate_e = device_bandit_update(bandit_slice(fleet, e), interval - 1,
                                        utility, cost)
        fleet = bandit_place(fleet, e, bstate_e)
        fetch_ver = torch.where(hit, version, fetch_ver)
        resid = knobs["budget"] - _at(consumed, e)
        _, nxt_i, nxt_c, fin = schedule_block(
            bstate_e, resid,
            _at(knobs["costs_ek"], e), knobs["ucb_c"],
            _at(knobs["min_edge_cost"], e), knobs["cost_noise"],
            _at(knobs["comp"], e), _at(knobs["comm"], e), wall, gumbel,
            normal)
        state = (new_global, fleet, consumed, fetch_ver, version, metric)
        signals = (None if spec is None else
                   {"resid": resid, "alpha": alpha, "stale": stale,
                    "bstate": bstate_e})
        return state, utility, (nxt_i, nxt_c, fin), signals

    def commit(carry: Carry, state, ok, t, e, wall, interval, cost,
               utility, nxt):
        """Write event ``t``'s results into the carry where ``ok``: the
        edge's fetched model and next block, and the history row."""
        new_global, _, consumed, _, _, metric = state
        hit = (edge_ids == e) & ok
        mine = (local_ids == e) & ok
        nxt_i, nxt_c, fin = nxt
        at = (pos == t) & ok
        hist = carry["hist"]
        return dict(
            carry,
            edge_params=tree_map(lambda a, g: on_edge(mine, g.unsqueeze(0),
                                                      a),
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
        p_new = block(carry["edge_params"], lanes, interval.reshape(1),
                      draws["uniform"][at.reshape(1), lanes])
        state, utility, nxt, sig = event(
            state_of(carry), knobs, e, wall, interval, cost,
            tree_map(lambda a: a[0], p_new), _at(draws["gumbel"], at, e),
            _at(draws["normal"], at, e))
        new = commit(carry, state, always, t, e, wall, interval, cost,
                     utility, nxt)
        new = dict(with_state(new, state), t=t + 1, wall=wall)
        if spec is not None:
            new["telem"] = async_ring_record(
                carry["telem"], spec, t=t, edge=e, arm=interval - 1,
                cost=cost, budget_resid=sig["resid"], alpha=sig["alpha"],
                staleness=sig["stale"], interarrival=wall - carry["wall"],
                bstate_e=sig["bstate"])
        return new

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
        p_new = block(carry["edge_params"], e_sorted,
                      torch.where(valid, interval_l, 0),
                      draws["uniform"][at, e_sorted])
        gumbel, normal = draws["gumbel"][at, e_sorted], \
            draws["normal"][at, e_sorted]
        # the control plane: the merge chain is sequential (lane j + 1
        # merges into lane j's model), replayed lane by lane, masked
        sigs = []
        for j in range(batch_k):
            ok = valid[j]
            state, utility, nxt, sig = event(
                state_of(carry), knobs, e_sorted[j], f_sorted[j],
                interval_l[j], cost_l[j], tree_map(lambda a: a[j], p_new),
                gumbel[j], normal[j])
            if j:
                state = tree_map(lambda n, o: torch.where(ok, n, o), state,
                                 state_of(carry))
            carry = with_state(
                commit(carry, state, ok, t0 + j, e_sorted[j], f_sorted[j],
                       interval_l[j], cost_l[j], utility, nxt), state)
            sigs.append(sig)
        new = dict(carry, t=t0 + n_batch, wall=_at(f_sorted, n_batch - 1))
        if spec is not None:
            # the lanes' commits left the carry's rings and wall as the
            # wave found them; lanes past the accepted prefix write no row
            prev_walls = torch.cat([carry["wall"].reshape(1), f_sorted[:-1]])
            lanes = {name: torch.stack([s[name] for s in sigs])
                     for name in ("resid", "alpha", "stale")}
            new["telem"] = async_ring_record_wave(
                carry["telem"], spec, t0=t0, valid=valid, edge=e_sorted,
                arm=interval_l - 1, cost=cost_l,
                budget_resid=lanes["resid"], alpha=lanes["alpha"],
                staleness=lanes["stale"], interarrival=f_sorted - prev_walls,
                arm_counts=torch.stack([s["bstate"]["counts"]
                                        for s in sigs]),
                arm_utility=torch.stack([s["bstate"]["utility_sum"]
                                         for s in sigs]))
        return new

    def body_one_scn(carry: Carry, knobs: Knobs, draws) -> Carry:
        # the scenario variant of body_one: the popped edge's activity bit
        # decides between a real completion and a dropout PROBE, which
        # discards the block (no merge, no charge, no bandit pull, no
        # version bump) and retries the same in-flight block after a
        # reconnect delay: churned edges burn wall clock, never budget
        t = carry["t"]
        e = torch.argmin(carry["finish"])           # the event horizon
        hit = edge_ids == e
        wall = _at(carry["finish"], e)
        slot_i = torch.remainder(t, period)
        act_row = _at(knobs["scn_active"], slot_i) > 0               # [E]
        is_act = _at(act_row, e)
        live = hit & is_act
        interval, cost = _at(carry["infl_i"], e), _at(carry["infl_c"], e)
        at = item(draws, t - draws["t_base"])
        lanes = e.reshape(1)
        # a dropped edge runs its steps masked (interval 0); the drift
        # phase rotates the sampling window
        p_new = block(carry["edge_params"], lanes,
                      torch.where(is_act, interval, 0).reshape(1),
                      draws["uniform"][at.reshape(1), lanes],
                      shift=knobs["scn_drift"] * t.float())
        gparams, version = carry["gparams"], carry["version"]
        # charge at completion, live edges only: probes are free
        consumed = torch.where(hit, carry["consumed"]
                               + torch.where(is_act, cost, 0.0),
                               carry["consumed"])
        alpha = staleness_alpha(knobs["async_alpha"], version,
                                _at(carry["fetch_ver"], e), n_edges_f)
        stale = (staleness(version, _at(carry["fetch_ver"], e))
                 if spec is not None else None)
        merged = staleness_merge(gparams, tree_map(lambda a: a[0], p_new),
                                 alpha)
        new_global = tree_map(lambda m, g: torch.where(is_act, m, g),
                              merged, gparams)
        version = version + is_act.long()
        metric, utility = eval_step(new_global, gparams,
                                    carry["prev_metric"])
        # arm -1 makes the bandit update a no-op, so a probe pulls nothing
        bstate_e = device_bandit_update(
            bandit_slice(carry["fleet"], e),
            torch.where(is_act, interval - 1, -1), utility, cost)
        fleet = bandit_place(carry["fleet"], e, bstate_e)
        # only a live edge refetches the global model (into its owner's
        # row)
        mine = (local_ids == e) & is_act
        edge_params = tree_map(lambda a, g: on_edge(mine, g.unsqueeze(0), a),
                               carry["edge_params"], new_global)
        fetch_ver = torch.where(live, version, carry["fetch_ver"])
        # straggler spikes scale the NEXT block's cost surface at
        # scheduling time (cost = m * (i * comp + comm) by linearity);
        # each scaled cost is an f32 tensor, as the reference's
        m = _at(knobs["scn_mult"], slot_i, e)
        min_cost_e = _at(knobs["min_edge_cost"], e)
        resid = knobs["budget"] - _at(consumed, e)
        _, nxt_i, nxt_c, fin = schedule_block(
            bstate_e, resid,
            _at(knobs["costs_ek"], e) * m, knobs["ucb_c"], min_cost_e * m,
            knobs["cost_noise"], _at(knobs["comp"], e) * m,
            _at(knobs["comm"], e) * m, wall, _at(draws["gumbel"], at, e),
            _at(draws["normal"], at, e))
        # a probe keeps its in-flight block and retries after a reconnect
        # delay of the edge's minimum block cost
        fin = torch.where(is_act, fin, wall + min_cost_e)
        nxt_i = torch.where(is_act, nxt_i, interval)
        nxt_c = torch.where(is_act, nxt_c, cost)
        at_t = pos == t
        n_act = act_row.int().sum().int()
        hist = carry["hist"]
        hist = {
            "metric": torch.where(at_t, metric, hist["metric"]),
            "utility": torch.where(at_t, torch.where(is_act, utility, 0.0),
                                   hist["utility"]),
            "interval": torch.where(at_t, torch.where(is_act, interval, 0)
                                    .int(), hist["interval"]),
            "edge": torch.where(at_t, e.int(), hist["edge"]),
            "cost": torch.where(at_t, torch.where(is_act, cost, 0.0),
                                hist["cost"]),
            "consumed": torch.where(at_t, _edge_sum(consumed),
                                    hist["consumed"]),
            "wall": torch.where(at_t, wall, hist["wall"]),
            "active_edges": torch.where(at_t, n_act, hist["active_edges"]),
        }
        new = dict(carry, gparams=new_global, edge_params=edge_params,
                   fleet=fleet, consumed=consumed,
                   finish=torch.where(hit, fin, carry["finish"]),
                   infl_i=torch.where(hit, nxt_i, carry["infl_i"]),
                   infl_c=torch.where(hit, nxt_c, carry["infl_c"]),
                   fetch_ver=fetch_ver, version=version, t=t + 1,
                   prev_metric=metric, wall=wall, hist=hist)
        if spec is not None:
            # a probe records its edge and arm, charges 0 and counts as
            # one dropout; rejoins are not observed per event
            new["telem"] = async_ring_record(
                carry["telem"], spec, t=t, edge=e, arm=interval - 1,
                cost=torch.where(is_act, cost, 0.0), budget_resid=resid,
                alpha=alpha, staleness=stale,
                interarrival=wall - carry["wall"], bstate_e=bstate_e,
                scn=(n_act, 1 - is_act.int(), torch.zeros_like(n_act)))
        return new

    if scn is not None:
        body = body_one_scn
    else:
        body = body_one if batch_k == 1 else body_wave

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
        if spec is not None:
            out["telemetry"] = finalize_telemetry(carry["telem"],
                                                  carry["t"], spec)
        return carry["gparams"], out

    draw_shapes = {"gumbel": (n_edges, k), "uniform": (n_edges, k, batch),
                   "normal": (n_edges,)}
    return ELCell(init=init, cond=cond, body=body,
                  finalize=finalize, horizon=max_events,
                  draw_shapes=draw_shapes, device=dev,
                  init_draw_shapes={"init_gumbel": (n_edges, k),
                                    "init_normal": (n_edges,)},
                  items_per_step=batch_k, sharded=shard is not None,
                  capturable=shard is None or graph_capturable(shard.group),
                  params_key="gparams")


class AsyncProgram(ChunkRunner):
    """The async engine on a :class:`ChunkRunner`: a chunk is
    ``rounds_per_chunk`` steps of up to ``batch_k`` events each, so its
    draw buffers hold ``rounds_per_chunk x batch_k`` events from the
    chunk's first; every step reads the whole buffers and its own offset
    from ``t_base``."""

    def _step_draws(self, bufs: Dict[str, torch.Tensor], r: int,
                    t_base: torch.Tensor) -> Dict[str, Any]:
        return dict(bufs, t_base=t_base)


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
    at exit); with ``telemetry=`` the nested ``out["telemetry"]`` rings.
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
