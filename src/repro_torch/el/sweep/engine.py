"""The sweep engine: a whole ablation grid as one device loop.

The reference vmaps its compiled sync round or async event program over a
flattened ``[n_cells]`` axis and jits the result.  Here the same program's
runner (``repro_torch.el.ingraph.ChunkRunner``) takes the cell dimension
itself: every carry, knob and draw buffer gains a leading ``[C]``, and the
masked step is vmapped (``torch.func.vmap``) over the cells, so each op of a
round (or event) is one kernel over all cells, each K-means local step
one launch of ``kmeans_assign``'s batched entry over every (cell, edge)
pair, and each chunk one CUDA graph replay on a card.  Each cell makes
the decisions of an independent ``run_sync_ingraph`` /
``run_async_ingraph`` with that cell's config on the same draws.

Knobs are stacked per cell (``stack_knobs``; with a scenario its
``[C, period, E]`` schedules and, in sync, a per-cell ``policy_id``, so a
``policy`` x ``churn_rate`` grid is one program) and draws come from one
RNG-seam provider per cell (``cell_draws``: each cell's solo stream,
``torch.Generator`` seeded with ``seed + 17``, as the reference's
``cell_keys`` seeds each cell with its solo run's key).

``CellBatch`` is the same vmapped step run a wave at a time over a
fixed set of slots with an activity mask — the fleet's engine.

``telemetry=`` gives every cell (or slot) its own device rings
(``repro_torch.obs.rings``): a sweep's come back stacked under
``out["telemetry"]``, a slot's from ``finalize_slot``.

**Over ranks** (``mesh=``, a ``repro_torch.launch.mesh.Mesh``): the
sweep dim goes over the mesh's edge axes (``sweep_partition_specs``, the
reference's placement; a grid that does not tile them raises
``ValueError``).  Each rank runs its own block of cells, with their
knobs and draw providers, as a runner over those cells alone (the cells'
own programs are mesh-less, as the reference's per-cell program is);
ranks that share a data coordinate run the same cells (the ``model``
axis replicates them).  When a rank's cells have all terminated, the
stacked ``(params, out)`` are all-gathered into ``[n_cells, ...]``, so
every rank returns every cell.  A cohort's slot dim splits the same way
(``make_cell_batch(mesh=)``, by ``repro_torch.sharding.
el_cohort_state_specs``, replicated when it does not tile): a slot's
owner places and steps it, each wave's running flags and streamed
history rows are all-gathered, and a finalize's rows come from their
owners.  No collective runs inside a chunk, so on a card the chunks stay
CUDA graphs.
"""

from __future__ import annotations

import math
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import OL4ELConfig
from repro_torch.device import DeviceLike
from repro_torch.el.events.knobs import (ASYNC_KNOB_NAMES, async_knobs,
                                         resolve_async_batch_k)
from repro_torch.el.events.program import AsyncProgram, make_async_cell
from repro_torch.el.ingraph import (KNOB_NAMES, ChunkRunner, SyncProgram,
                                    _knob_tensor, check_ingraph_support,
                                    make_sync_cell, sync_knobs)
from repro_torch.el.rng import CellDraws, TorchDraws
from repro_torch.el.sweep.spec import SweepSpec
from repro_torch.interop import tree_map
from repro_torch.sharding import (EL_EDGE_KNOBS, EL_SCALAR_KNOBS,
                                  EL_SCHEDULE_KNOBS, P, Placement)

Params = Any
Carry = Dict[str, Any]


def knob_names(mode: str, scenario: bool = False) -> Tuple[str, ...]:
    """The knob set of the mode's compiled program; ``scenario`` appends
    the scenario engine's schedule knobs (``scn_active`` / ``scn_mult`` /
    ``scn_drift``, plus ``policy_id`` on sync)."""
    names = ASYNC_KNOB_NAMES if mode == "async" else KNOB_NAMES
    if scenario:
        from repro_torch.el.scenarios.schedule import scenario_knob_names
        names = names + scenario_knob_names(mode)
    return names


def stack_knobs(cell_cfgs: Sequence[OL4ELConfig]) -> Dict[str, np.ndarray]:
    """Per-cell ``sync_knobs`` / ``async_knobs`` (by the cells' mode)
    stacked along a leading [n_cells] axis."""
    knobs_fn = async_knobs if cell_cfgs[0].mode == "async" else sync_knobs
    per_cell = [knobs_fn(c) for c in cell_cfgs]
    return {k: np.stack([knobs[k] for knobs in per_cell])
            for k in knob_names(cell_cfgs[0].mode,
                                cell_cfgs[0].scenario is not None)}


def cell_draws(cell_cfgs: Sequence[OL4ELConfig],
               device: torch.device) -> CellDraws:
    """One ``TorchDraws`` per cell on ``device``, seeded with the cell's
    ``seed + 17``: the stream an independent ``run_sync_ingraph`` /
    ``run_async_ingraph`` of that cell draws (the reference's
    ``cell_keys``)."""
    return CellDraws([TorchDraws(torch.Generator(device=device)
                                 .manual_seed(c.seed + 17))
                      for c in cell_cfgs])


# ---------------------------------------------------------------------------
# Mesh placement (the sweep dim over the edge axes, a per-edge knob dim
# over ``model`` when it divides)
# ---------------------------------------------------------------------------


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, np.shape(mesh.devices)))


def sweep_partition_specs(axis_names: Sequence[str],
                          axis_sizes: Dict[str, int],
                          n_cells: int, n_edges: int,
                          mode: str = "sync",
                          scenario: bool = False
                          ) -> Tuple[P, Dict[str, P]]:
    """PartitionSpecs for a sweep's (draws, knobs): the sweep dim over the
    edge axes, a per-edge knob dim over ``model`` when it divides.  Pure
    (no ranks); raises ``ValueError`` when the grid does not tile the
    mesh, with the reference's message."""
    sweep_axes = tuple(a for a in ("pod", "data") if a in axis_names)
    if not sweep_axes:
        raise ValueError(
            f"mesh axes {tuple(axis_names)} have no edge axes "
            "('pod'/'data') to shard the sweep dim over")
    n_shards = math.prod(axis_sizes[a] for a in sweep_axes)
    if n_cells % n_shards != 0:
        raise ValueError(
            f"sweep of {n_cells} cells does not tile the mesh's "
            f"{sweep_axes} axes ({n_shards} shards); pad the grid (e.g. "
            f"add seeds) to a multiple of {n_shards} or run without a "
            "mesh")
    model_size = axis_sizes.get("model", 1)
    edge_ax = "model" if (model_size > 1
                          and n_edges % model_size == 0) else None

    def spec_for(name: str) -> P:
        if name in EL_EDGE_KNOBS:                     # [C, E]
            return P(sweep_axes, edge_ax)
        if name in EL_SCALAR_KNOBS:                   # [C]
            return P(sweep_axes)
        if name == "costs_ek":                        # [C, E, K] (async)
            return P(sweep_axes, edge_ax, None)
        if name in EL_SCHEDULE_KNOBS:                 # [C, S, E]
            return P(sweep_axes, None, None)
        return P(sweep_axes, None)                    # costs_k [C, K]

    return P(sweep_axes), {name: spec_for(name)
                           for name in knob_names(mode, scenario)}


def sweep_input_shardings(mesh, n_cells: int, n_edges: int,
                          mode: str = "sync", scenario: bool = False):
    """:class:`~repro_torch.sharding.Placement` s of a sweep's (init_params,
    draws, knobs): params replicated, the sweep dim over the edge
    axes."""
    key_spec, knob_specs = sweep_partition_specs(
        mesh.axis_names, _axis_sizes(mesh), n_cells, n_edges, mode,
        scenario)
    return (Placement(mesh, P()), Placement(mesh, key_spec),
            {k: Placement(mesh, s) for k, s in knob_specs.items()})


def cell_shard(mesh, n_cells: int, n_edges: int, mode: str = "sync",
               scenario: bool = False):
    """This rank's block of a sweep's cells (a ``repro_torch.launch.mesh.
    EdgeShard`` over the edge group), or ``None`` when the sweep dim has
    one shard and every rank runs every cell.  Raises ``ValueError`` as
    :func:`sweep_partition_specs` does."""
    from repro_torch.launch.mesh import EdgeShard
    rows = sweep_input_shardings(mesh, n_cells, n_edges, mode,
                                 scenario)[1].local_slices(
        (n_cells,), mesh.rank)[0]
    if rows.stop - rows.start == n_cells:
        return None
    return EdgeShard(rows.start, rows.stop, n_cells, mesh.edge_group())


def gather_cells(shard, params: Params, out: Dict[str, Any],
                 device: torch.device) -> Tuple[Params, Dict[str, Any]]:
    """A rank's ``[C_local, ...]`` (params, numpy out) all-gathered into
    ``[C, ...]`` over ``shard``'s group, in one gather a dtype."""
    full = shard.gather({"params": params, "out": tree_map(
        lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device),
        out)})
    return (tree_map(torch.clone, full["params"]),
            tree_map(lambda g: np.array(g.cpu()), full["out"]))


def _make_cell(model, edge_data, eval_set, cfg: OL4ELConfig, horizon: int,
               **kw):
    """The mode's cell (``make_sync_cell`` / ``make_async_cell``) at a
    history of ``horizon`` rounds or events, and its runner class."""
    if cfg.mode == "async":
        return make_async_cell(
            model, edge_data, eval_set, cfg, max_events=horizon,
            batch_k=resolve_async_batch_k(cfg), **kw), AsyncProgram
    return make_sync_cell(model, edge_data, eval_set, cfg,
                          max_rounds=horizon, **kw), SyncProgram


def make_sweep_program(model, edge_data, eval_set, cfg: OL4ELConfig,
                       spec: SweepSpec, *, lr: float, batch: int,
                       n_samples: Optional[np.ndarray] = None,
                       metric_fn: Optional[Callable] = None,
                       metric_name: str = "accuracy",
                       mesh=None, telemetry=None, device: DeviceLike = None,
                       rounds_per_chunk: int = 16) -> ChunkRunner:
    """Build the sweep: ``program(init_params, knobs, draws) ->
    (params_stacked, out_stacked)``, every output with a leading
    ``[n_cells]`` axis; ``knobs`` from :func:`stack_knobs`, ``draws`` a
    ``CellDraws`` (:func:`run_sweep_program` supplies both).

    The program is the mode's own runner (``SyncProgram`` /
    ``AsyncProgram``, picked by ``cfg.mode``) at ``spec.max_rounds`` with
    ``n_cells = spec.n_cells``: the very cell ``run_sync_ingraph`` /
    ``run_async_ingraph`` drives, vmapped over the cells.  ``telemetry=``
    gates the per-cell rings (see ``make_sync_cell``); each cell's come
    back stacked under ``out["telemetry"]``.

    ``mesh=``: the runner takes this rank's block of cells alone
    (:func:`cell_shard`), and :func:`run_sweep_program` with the same
    ``mesh`` gathers every rank's; a grid that does not tile the mesh's
    edge axes raises ``ValueError``.
    """
    cfgs = spec.cell_cfgs(cfg)
    for c in cfgs:
        check_ingraph_support(c, caller="ELSession.sweep")
    if cfg.mode == "async" and len({c.async_batch_k for c in cfgs}) > 1:
        raise ValueError(
            "a multi-valued async_batch_k grid needs one program per K "
            "(each K is a different wave body); split with "
            "spec.per_batch_k() — ELSession.sweep does this "
            "automatically")
    # structural fields (n_edges, utility, mode, ...) are identical across
    # cells by SweepSpec construction — any cell builds the program
    shard = None if mesh is None else cell_shard(
        mesh, spec.n_cells, cfg.n_edges, cfg.mode, cfg.scenario is not None)
    cell, runner = _make_cell(
        model, edge_data, eval_set, cfgs[0], spec.max_rounds, lr=lr,
        batch=batch, n_samples=n_samples, metric_fn=metric_fn,
        metric_name=metric_name, telemetry=telemetry, device=device)
    return runner(cell, rounds_per_chunk, n_cells=spec.n_cells
                  if shard is None else shard.n_local)


def run_sweep_program(program: ChunkRunner, init_params: Params,
                      cell_cfgs: List[OL4ELConfig], draws=None, *,
                      mesh=None) -> Tuple[Params, Dict[str, np.ndarray]]:
    """Run a sweep program over ``cell_cfgs`` (``spec.cell_cfgs(cfg)``):
    their stacked knobs, and ``draws`` — one provider per cell (a list
    or a ``CellDraws``; default :func:`cell_draws`).  ``mesh=`` (the
    program's own, from :func:`make_sweep_program`): this rank runs its
    block of the cells and providers (:func:`cell_shard`) and returns
    every rank's cells, gathered."""
    if draws is not None and not isinstance(draws, CellDraws):
        draws = CellDraws(draws)
    if draws is not None and len(draws.providers) != len(cell_cfgs):
        raise ValueError(f"{len(draws.providers)} draw providers for "
                         f"{len(cell_cfgs)} cells")
    c0 = cell_cfgs[0]
    shard = None if mesh is None else cell_shard(
        mesh, len(cell_cfgs), c0.n_edges, c0.mode, c0.scenario is not None)
    if shard is not None:
        cell_cfgs = cell_cfgs[shard.rows]
        if draws is not None:
            draws = CellDraws(draws.providers[shard.rows])
    if draws is None:
        draws = cell_draws(cell_cfgs, program.device)
    params, out = program(init_params, stack_knobs(cell_cfgs), draws)
    if shard is None:
        return params, out
    return gather_cells(shard, params, out, program.device)


# ---------------------------------------------------------------------------
# Steppable cell batches (the fleet data plane)
# ---------------------------------------------------------------------------


class CellBatch:
    """A resumable slot-batched EL engine: the sweep's vmapped cell run
    ``rounds_per_wave`` masked steps at a time over a fixed ``[n_slots]``
    batch with an activity mask, instead of to completion in one call.

    Between waves the host may harvest finished slots (``take_slot`` /
    ``take_many`` + ``finalize_slot``) and admit new tenants into the
    freed rows (``init_slot`` + ``place`` / ``place_many``) — continuous
    batching over the EL control plane.  Per-slot math is the
    :class:`~repro_torch.el.ingraph.ELCell`'s ``cond`` / ``body``
    verbatim, masked by ``active & cond``, so every tenant's trajectory
    is the one an independent ``run_sync_ingraph`` /
    ``run_async_ingraph`` of that tenant makes on the same draws.  An
    inactive slot's step writes back its own values: its bandit state,
    budget and history stay byte for byte.

    Each slot reads its draws from its own provider (given to ``place``)
    at its own ``t``.  ``step`` is one CUDA graph replay on a card (the
    first captures it), eager on the CPU.

    Donation: ``step``, ``place`` and ``place_many`` update the stacked
    buffers in place and return them; the first stacked carry ``step``
    sees becomes the batch's static buffer (a later, different one is
    copied into it), so callers treat the value they passed as consumed.

    Over ranks (``shard``: a ``repro_torch.launch.mesh.EdgeShard`` of the
    slot dim) the runner and the stacked carry hold this rank's slots
    ``shard.lo .. shard.hi - 1`` alone.  Every method still takes the
    whole batch's slot numbers, knob rows and masks: a slot's owner
    writes and steps it, and what the host reads across slots (each
    wave's ``t`` and running flags, history rows, finalized rows) is
    all-gathered (:meth:`gather_slots`), so every rank sees every slot.
    """

    def __init__(self, program: ChunkRunner, mode: str, shard=None):
        self.program = program
        self.mode = mode
        self.shard = shard
        self.n_local = int(program.n_cells)
        self.n_slots = self.n_local if shard is None else shard.n_edges
        self.rounds_per_wave = program.rounds_per_chunk
        self.horizon = program.cell.horizon
        self.device = program.device
        self.draws = CellDraws([None] * self.n_local)
        #: every slot's ``t`` after the latest ``step`` (host ints)
        self.last_t: List[int] = [0] * self.n_slots
        #: the fleet cohort whose tenants the static buffers hold
        #: (``repro_torch.el.fleet.Cohort``; None when free)
        self.owner = None

    def _rows(self, slots: Sequence[int]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows, mine) of ``slots``: each slot's row in this rank's stack
        (clamped into it) and whether this rank owns it."""
        ids = torch.as_tensor([int(s) for s in slots], dtype=torch.long,
                              device=self.device)
        if self.shard is None:
            return ids, torch.ones_like(ids, dtype=torch.bool)
        return self.shard.local_rows(ids)

    def gather_slots(self, tree: Any) -> Any:
        """A tree of ``[n_local, ...]`` per-slot rows as ``[n_slots,
        ...]``: every rank's rows, all-gathered (the tree itself on one
        rank)."""
        return tree if self.shard is None else self.shard.gather(tree)

    def _knobs(self, knobs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {n: v.to(self.device) if isinstance(v, torch.Tensor)
                else _knob_tensor(v, self.device)
                for n, v in knobs.items()}

    def init_slot(self, init_params: Params, knobs_row: Dict[str, Any],
                  draws) -> Carry:
        """A single slot's initial carry: ``knobs_row`` one cell's knobs
        (``sync_knobs`` / ``async_knobs``), ``draws`` the tenant's
        provider (its initial draws are taken here)."""
        cell = self.program.cell
        init_bufs = {n: torch.zeros(shape, device=self.device)
                     for n, shape in cell.init_draw_shapes.items()}
        if init_bufs:
            draws.fill_init(init_bufs)
        return cell.init(init_params, self._knobs(knobs_row), init_bufs)

    def broadcast(self, carry_one: Carry) -> Carry:
        """A fresh stacked carry (this rank's rows), every row a copy of
        ``carry_one`` (rows are read only after ``place`` overwrites
        them)."""
        return tree_map(lambda v: v.unsqueeze(0).repeat(
            (self.n_local,) + (1,) * v.dim()), carry_one)

    def place(self, stacked: Carry, carry_one: Carry, slot: int,
              draws) -> Carry:
        """Row ``slot`` replaced by ``carry_one`` (in place, by its
        owner), its draws from ``draws`` from now on."""
        return self.place_many(stacked, [carry_one], [slot], [draws])

    def place_many(self, stacked: Carry, carries: Sequence[Carry],
                   slots: Sequence[int], draws: Sequence) -> Carry:
        """Every named row replaced in one scatter per leaf (in place; a
        rank writes the rows it owns).  Pad by repeating the last real
        (carry, slot, draws): duplicate writes are idempotent."""
        rows, own = self._rows(slots)
        mine = [(row, c, d) for row, o, c, d in zip(
            rows.tolist(), own.tolist(), carries, draws) if o]
        if not mine:
            return stacked
        rows, carries, draws = zip(*mine)
        idx = torch.as_tensor(rows, dtype=torch.long, device=self.device)
        new = tree_map(lambda *xs: torch.stack(xs), *carries)
        tree_map(lambda s, r: s.index_copy_(0, idx, r), stacked, new)
        for row, d in zip(rows, draws):
            self.draws.providers[row] = d
        return stacked

    def take_slot(self, stacked: Carry, slot: int) -> Carry:
        """A copy of row ``slot``."""
        return tree_map(lambda s: s[0], self.take_many(stacked, [slot]))

    def take_many(self, stacked: Carry, slots: Sequence[int]) -> Carry:
        """The named rows stacked along a leading axis, one gather per
        leaf; over ranks each row from its owner (every rank gathers its
        rows for the named slots, a slot it does not own read from a
        clamped row, and takes each slot's from the owner's block)."""
        rows, _ = self._rows(slots)
        got = tree_map(lambda s: s[rows], stacked)
        if self.shard is None:
            return got
        ids = torch.as_tensor([int(s) for s in slots], dtype=torch.long,
                              device=self.device)
        return self.shard.from_owners(got, ids)

    def _adopt(self, stacked: Carry, knobs_stacked: Dict[str, Any],
               active) -> List[bool]:
        """The stacked carry, this rank's knob rows and activity mask into
        the program's static buffers (the first carry seen becomes the
        buffer); returns this rank's mask."""
        p = self.program
        mine = slice(None) if self.shard is None else self.shard.rows
        knobs = self._knobs({n: v[mine] for n, v in knobs_stacked.items()})
        if p.carry is None:
            p.carry, p.knobs = stacked, knobs
        else:
            if stacked is not p.carry:
                tree_map(lambda d, s: d.copy_(s), p.carry, stacked)
            tree_map(lambda d, s: d.copy_(s), p.knobs, knobs)
        act = [bool(a) for a in torch.as_tensor(active).tolist()][mine]
        p.active.copy_(torch.tensor(act, dtype=torch.bool))
        return act

    def profile_view(self, stacked: Carry, knobs_stacked: Dict[str, Any],
                     active) -> Dict[str, Any]:
        """What ``repro_torch.obs.prof.profile_jit`` measures of one wave,
        with the stacked carry, knobs and mask adopted as ``step`` adopts
        them (no draw is taken): the wave's inputs, its outputs (the
        carry, updated in place, and the status), one masked step and the
        chunk to capture (or warm up)."""
        p = self.program
        self._adopt(stacked, knobs_stacked, active)
        return {"device": self.device,
                "arguments": (p.carry, p.knobs, p.draw_bufs, p.active),
                "outputs": (p.carry, p.status),
                "step": p._one_step,
                "chunk": p._prepare_chunk}

    def step(self, stacked: Carry, knobs_stacked: Dict[str, Any],
             active) -> Tuple[Carry, torch.Tensor]:
        """``rounds_per_wave`` masked steps of every slot where ``active``
        (a ``[n_slots]`` bool) holds; returns the stacked carry (updated
        in place) and ``running`` = ``active & cond`` after the wave, and
        leaves every slot's ``t`` in ``last_t``.  Over ranks each rank
        steps its slots, and the slots' ``t`` and running flags are
        all-gathered."""
        p = self.program
        act = self._adopt(stacked, knobs_stacked, active)
        self.draws.fill(p.draw_bufs, p.carry["t"].tolist(), rows=act)
        p._run_chunk()
        # (t, running) a slot, every rank's
        rows = self.gather_slots(p.status[1:].reshape(2, self.n_local).t()
                                 .contiguous()).tolist()
        self.last_t = [t for t, _ in rows]
        running = torch.tensor([bool(r) for _, r in rows], dtype=torch.bool)
        return p.carry, running

    def finalize_slot(self, carry_one: Carry, knobs_row: Dict[str, Any]
                      ) -> Tuple[Params, Dict[str, np.ndarray]]:
        """The cell's ``finalize`` on one slot: ``(params, out)``, ``out``
        as numpy copies (the programs' ``out``; with rings on, the slot's
        own ``out["telemetry"]``)."""
        params, out = self.program.cell.finalize(carry_one,
                                                 self._knobs(knobs_row))
        return params, tree_map(lambda v: v.to("cpu", copy=True).numpy(),
                                out)


def make_cell_batch(model, edge_data, eval_set, cfg: OL4ELConfig, *,
                    n_slots: int, rounds_per_wave: int = 32,
                    lr: float, batch: int,
                    n_samples: Optional[np.ndarray] = None,
                    metric_fn: Optional[Callable] = None,
                    metric_name: str = "accuracy",
                    horizon: int = 512, mesh=None, telemetry=None,
                    device: DeviceLike = None) -> CellBatch:
    """Build the steppable slot-batch engine for one structural config.

    ``cfg`` contributes only structure (mode, n_edges, utility, wave
    width); per-slot knob values and draw providers arrive at call time,
    exactly as in :func:`make_sweep_program` — so one ``CellBatch`` serves
    every tenant that shares the structure.  ``horizon`` is the history
    length (``max_rounds`` sync, ``max_events`` async); use
    ``padded_event_horizon`` for async cohorts.  ``telemetry=`` gates the
    cell's rings (see ``make_sync_cell``): the stacked carry gains a
    per-slot ``"telem"`` subtree, ``init_slot`` gives an admitted tenant
    empty rings and ``finalize_slot`` emits the slot's
    ``out["telemetry"]``.

    ``mesh=``: the slot dim over the mesh's ranks
    (``repro_torch.launch.mesh.edge_shard``: the slot axes of
    ``repro_torch.sharding.el_cohort_state_specs`` are the edge dim's;
    see :class:`CellBatch`).  A slot dim that does not tile the edge
    axes replicates, as the reference's placement does, and says so in
    a warning: every rank then runs every slot and gathers nothing.
    """
    check_ingraph_support(cfg, caller="make_cell_batch")
    from repro_torch.launch.mesh import edge_shard
    shard = edge_shard(mesh, n_slots)
    if (mesh is not None and shard is None
            and np.asarray(mesh.devices).size > 1):
        warnings.warn(
            f"make_cell_batch: {n_slots} slots do not tile the mesh "
            f"{dict(mesh.shape)}'s edge axes; every rank holds and steps "
            "every slot (the slot dim replicates)", stacklevel=2)
    cell, runner = _make_cell(
        model, edge_data, eval_set, cfg, horizon, lr=lr, batch=batch,
        n_samples=n_samples, metric_fn=metric_fn, metric_name=metric_name,
        telemetry=telemetry, device=device)
    n_local = n_slots if shard is None else shard.n_local
    return CellBatch(runner(cell, rounds_per_wave, n_cells=n_local),
                     cfg.mode, shard)
