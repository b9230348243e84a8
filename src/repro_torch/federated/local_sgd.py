"""The OL4EL data plane over ranks: masked local-SGD rounds (port of
``repro.federated.local_sgd``).

Every edge server holds a full model replica; model and optimizer state
carry a leading edge dimension.  ``el_round`` runs one coordination round
for the edges: edge *i* takes its first ``intervals[i]`` local train
steps (``repro_torch.train.state.make_train_step``), then the
participation-weighted parameter mean is formed over the edges.  The
per-edge intervals come from the bandit between rounds (cloud = control
plane, edges = data plane).

Over a mesh (``mesh=``, a ``repro_torch.launch.mesh.Mesh``) the edge
dimension splits over the mesh's edge axes (``pod``, ``data``) by the
resolver's tile-or-replicate rule (``repro_torch.sharding.
el_edge_dim_axes``): each rank holds only its own edges' state and
batches.  Before the mean it all-gathers the ``[E, ...]`` parameter stack
(``repro_torch.launch.mesh.gather_edge_stack``) and reduces it in edge
order, in f32, on every rank; no all-reduce sits on the parameter path,
so a run on R ranks is bit-identical to the run on one, on every rank.
Intervals, weights, the bandit, budgets and the draws are replicated.

A ``model`` axis of M > 1 ranks splits each edge's model: a rank holds
only its block of each leaf (parameters and optimizer moments) along the
dim :func:`el_state_specs` puts on ``model`` (the reference's
``param_specs`` layout; a leaf the resolver replicates stays whole), and
gathers each block over the model group just before use, as FSDP /
ZeRO-3 does (:class:`ModelAxis`): the model's ``param_hook`` all-gathers
a group's leaves inside the group's ``checkpoint`` (its full weights live
only during its forward and its recompute), and the embedding, head,
final norm and prefix layers where they are used; the gather's backward
keeps the rank's block of the gradient.  Every model rank runs the same
batch on the same gathered weights, so their gradients are equal and
nothing is reduced.  The clip's global norm gathers one gradient leaf at
a time and reduces it as the unsharded step does, and AdamW's update is
elementwise on the blocks, so every rank's blocks are the matching
slices of the unsharded run's state, bit for bit.  The edge stack's
gather and the mean then run on the blocks.  :func:`shard_el_state` /
:func:`gather_el_state` carry a state across the two layouts.

Where the reference scans all ``h_max`` steps and keeps a masked step's
result by ``where(take, new, old)``, a rank reads the round's ``[E]``
intervals to the host once and runs edge *i*'s first ``intervals[i]``
steps only: a skipped step leaves the state exactly as the ``where``
does, without a second copy of a full-width state.  The train step
updates the edge's parameters and moments in place (views into the
stacked state).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.core.bandit import (device_bandit_init, device_bandit_update,
                                     device_select_arm)
from repro_torch.el.ingraph import _edge_sum, _fma32
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.launch.mesh import (edge_shard, gather_edge_stack,
                                     gather_model_dim, group_rank,
                                     group_size)
from repro_torch.sharding import P, edge_axes, map_specs, param_specs
from repro_torch.train.optimizer import OptState, init_opt_state
from repro_torch.train.state import TrainState, make_train_step

Params = Any


class ELMeshState(NamedTuple):
    """Per-edge training state: every leaf has a leading edge dim (the
    rank's own edges over a mesh; over a ``model`` axis, their blocks)."""
    params: Params
    opt: Any


def _stack(trees: List[Any]) -> Any:
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def init_el_state(model, train_cfg: TrainConfig, n_edges: int,
                  gen: Optional[torch.Generator],
                  edges: Optional[range] = None, *,
                  mesh=None) -> ELMeshState:
    """Edge e's parameters are the e-th ``model.init(gen)`` draw, its
    optimizer state fresh; ``edges``: keep only these edges' state (a
    rank's share; every edge is still drawn, in order, so edge e's
    parameters do not depend on the split).  ``mesh`` with a ``model``
    axis: keep only this rank's block of each kept edge's leaves (each
    edge cut as it is drawn, so no full state of the rank's edges is
    ever held).  ``gen=None`` on a ``meta`` model gives the state's
    shapes (the planner's)."""
    keep = range(n_edges) if edges is None else edges
    axis = model_axis(model, mesh)
    params = []
    for e in range(n_edges):
        p = model.init(gen)
        if e in keep:
            params.append(p if axis is None else axis.shard(p))
    opts = [init_opt_state(train_cfg, p) for p in params]
    return ELMeshState(_stack(params), _stack(opts))


def el_bandit_init(n_edges: int, n_arms: int, device=None) -> Dict:
    """One device bandit per edge, stacked: ``[E, K]`` statistics and
    ``[E]`` pull counts (the reference's vmapped ``jax_bandit_init``)."""
    return _stack([device_bandit_init(n_arms, device)
                   for _ in range(n_edges)])


def _model_dim(spec) -> Optional[int]:
    """The dim a spec puts on the ``model`` axis, or ``None``."""
    for d, entry in enumerate(spec):
        if entry == "model" or (isinstance(entry, tuple)
                                and "model" in entry):
            return d
    return None


class _GatherShard(torch.autograd.Function):
    """Forward: a leaf's blocks all-gathered over the model group along
    ``dim``; backward: this rank's block of the incoming gradient, a copy
    (so the full gradient is freed at once)."""

    @staticmethod
    def forward(ctx, shard, dim, group):
        ctx.dim, ctx.n = dim, shard.shape[dim]
        ctx.lo = group_rank(group) * ctx.n
        return gather_model_dim(shard, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.lo, ctx.n).contiguous(), None, None


class ModelAxis:
    """One edge's model split over a mesh's ``model`` group: ``dims`` is
    the parameter tree's ``model`` dim per leaf (``None``: replicated),
    from ``repro_torch.sharding.param_specs`` on the full shapes
    ``params_shape``; a ``Mesh`` or a ``PlanMesh`` (whose group records
    the gathers)."""

    def __init__(self, model_cfg: ModelConfig, mesh, params_shape: Params):
        self.group = mesh.model_group()
        self.index, self.world = group_rank(self.group), group_size(
            self.group)
        self.dims = map_specs(_model_dim,
                              param_specs(model_cfg, mesh, params_shape))
        groups = self.dims["groups"]
        # a group's tree: the stacked leaves less their [n_groups] dim, or
        # (unstacked) any group of the list
        self.group_dims = (tree_map(lambda d: None if d is None else d - 1,
                                    groups)
                           if model_cfg.scan_layers else groups[0])

    def shard(self, params: Params) -> Params:
        """One edge's full parameter tree cut to this rank's blocks."""
        return tree_map(lambda leaf, d: _cut(leaf, d, self.index,
                                             self.world),
                        params, self.dims)

    def use(self, tree: Params, *key) -> Params:
        """The ``LM.param_hook``: the blocks at ``key`` gathered."""
        if key == ("groups",):
            dims = self.group_dims
        else:
            dims = self.dims
            for k in key:
                dims = dims[k]
        return tree_map(lambda leaf, d: leaf if d is None
                        else _GatherShard.apply(leaf, d, self.group),
                        tree, dims)

    def full_leaves(self, grads: Params):
        """The clip's leaves: each gradient block gathered, one at a time,
        in ``tree_leaves`` order."""
        for g, d in zip(tree_leaves(grads), tree_leaves(self.dims)):
            yield _gather(g, d, self.group)


def _cut(leaf: torch.Tensor, dim: Optional[int], index: int,
         world: int) -> torch.Tensor:
    """Block ``index`` of ``world`` along ``dim``, its own storage (so
    the whole leaf can be freed); the leaf itself for ``dim=None``."""
    if dim is None:
        return leaf
    n = leaf.shape[dim] // world
    return leaf.narrow(dim, index * n, n).clone(
        memory_format=torch.contiguous_format)


def _gather(leaf: torch.Tensor, dim: Optional[int], group) -> torch.Tensor:
    return leaf if dim is None else gather_model_dim(leaf, dim, group)


def model_axis(model, mesh) -> Optional[ModelAxis]:
    """``model``'s :class:`ModelAxis` on ``mesh``, or ``None`` (no mesh,
    or no ``model`` axis of 2 or more ranks)."""
    if mesh is None or mesh.model_group() is None:
        return None
    from repro_torch.models import LM
    return ModelAxis(model.cfg, mesh,
                     LM(model.cfg, device="meta").init(None))


def _state_dims(specs: ELMeshState) -> ELMeshState:
    return map_specs(_model_dim, specs)


def shard_el_state(state: ELMeshState, specs: ELMeshState,
                   mesh) -> ELMeshState:
    """This rank's blocks of a state of its edges (whole leaves):
    each leaf cut along the dim its spec (:func:`el_state_specs`) puts on
    ``model``; a leaf the resolver replicates stays whole.  The edge dim
    is the caller's (``init_el_state(edges=)``)."""
    group = mesh.model_group()
    if group is None:
        return state
    index, world = group_rank(group), group_size(group)
    return tree_map(lambda leaf, d: _cut(leaf, d, index, world), state,
                    _state_dims(specs))


def gather_el_state(state: ELMeshState, specs: ELMeshState,
                    mesh) -> ELMeshState:
    """The whole leaves of a state of blocks (:func:`shard_el_state`'s
    inverse): each leaf all-gathered over the model group along its
    ``model`` dim.  For tests and checkpoints; a collective every model
    rank calls."""
    group = mesh.model_group()
    if group is None:
        return state
    return tree_map(lambda leaf, d: _gather(leaf, d, group), state,
                    _state_dims(specs))


def _edge_view(tree: Any, j: int) -> Any:
    return tree_map(lambda a: a[j], tree)


def _write_back(dst: Any, src: Any) -> None:
    """Copy each leaf of ``src`` into the view ``dst`` unless the step
    already updated it there (a new tensor: the step counter, SGD's
    momentum buffer)."""
    def put(d, s):
        if s.data_ptr() != d.data_ptr():
            d.copy_(s)
    tree_map(put, dst, src)


def make_el_round(model, train_cfg: TrainConfig, h_max: int,
                  mode: str = "sync", *, mesh=None) -> Callable:
    """Build the round function.

    ``el_round(state, batches, intervals, weights)`` with
      state:     ``ELMeshState``, the rank's edges on the leading dim
                 (over a ``model`` axis, its blocks: ``init_el_state(
                 mesh=)``)
      batches:   tree; tokens ``[E_rank, h_max, B_e, S]``, the rank's edges
      intervals: ``[E]`` int32 (1..h_max), from the cloud bandit
      weights:   ``[E]`` f32 aggregation weights (sync: data sizes;
                 async emulation: staleness discounts)
    returns ``(state, metrics)``: the state updated in place (sync: every
    edge restarts from the weighted mean; async: each edge blends toward
    it at ``1 / interval``), ``metrics`` ``mean_loss`` and
    ``mean_interval`` (replicated).  ``el_round.edges(n_edges)`` is the
    range of edges this rank holds.
    """
    axis = model_axis(model, mesh)
    if axis is None:
        train_step = make_train_step(model, train_cfg)
    else:
        model = copy.copy(model)
        model.param_hook = axis.use
        train_step = make_train_step(model, train_cfg,
                                     full_leaves=axis.full_leaves)

    def edges(n_edges: int) -> range:
        shard = edge_shard(mesh, n_edges)
        return range(n_edges) if shard is None else range(shard.lo,
                                                          shard.hi)

    def el_round(state: ELMeshState, batches, intervals: torch.Tensor,
                 weights: torch.Tensor
                 ) -> Tuple[ELMeshState, Dict[str, torch.Tensor]]:
        n_edges = int(intervals.shape[0])
        shard = edge_shard(mesh, n_edges)
        mine = edges(n_edges)
        iv = intervals.tolist()                 # the round's one host read
        dev = tree_leaves(state.params)[0].device
        losses = []
        for j, e in enumerate(mine):
            view = TrainState(_edge_view(state.params, j),
                              _edge_view(state.opt, j))
            total = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(min(iv[e], h_max)):
                new, metrics = train_step(
                    view, tree_map(lambda a: a[j, i], batches))
                _write_back(view, new)
                total = total + metrics["loss"].float()
            losses.append(total / max(iv[e], 1))
        losses = torch.stack(losses)
        params = state.params
        if shard is not None:
            params = gather_edge_stack(params, shard.group)
            losses = gather_edge_stack(losses, shard.group)
        weights = weights.to(dev)
        w = (weights / _edge_sum(weights)).float()
        agg = tree_map(lambda p: _mean(p, w), params)
        if mode == "sync":
            # every edge restarts from the fresh global model
            tree_map(lambda local, g: local.copy_(
                g.to(local.dtype).expand_as(local)), state.params, agg)
        else:
            # async emulation: edges blend toward the global model at
            # 1 / interval (the staleness rate)
            alpha = 1.0 / (1.0 + (intervals.to(dev) - 1).float())
            a_mine = alpha[mine.start:mine.stop]

            def blend(local, g):
                a = a_mine.reshape((-1,) + (1,) * (local.dim() - 1))
                local.copy_((local.float() * (1.0 - a)
                             + g.float()[None] * a).to(local.dtype))
            tree_map(blend, state.params, agg)
        metrics = {"mean_loss": _edge_sum(losses * w),
                   "mean_interval": intervals.to(dev).float().mean()}
        return state, metrics

    el_round.edges = edges
    return el_round


def _mean(leaf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Σ_e w_e leaf_e in f32, edge by edge in order: a product, then one
    fused multiply-add an edge (``einsum("e...,e->...")``)."""
    acc = (leaf[0].double() * w[0].double()).float()
    for e in range(1, leaf.shape[0]):
        acc = _fma32(leaf[e], w[e], acc)
    return acc


def make_el_program(model, train_cfg: TrainConfig, n_edges: int,
                    h_max: int, n_rounds: int, data_fn,
                    comp_costs, comm_costs, mode: str = "async",
                    ucb_c: float = 2.0, *, mesh=None) -> Callable:
    """The whole OL4EL loop: in-graph bandit selection, the masked
    local-SGD round, budget accounting and bandit updates, ``n_rounds``
    rounds.

    ``data_fn(edge_ids, round_idx, step_idx)`` returns a batch tree with
    leading dims ``[len(edge_ids), h_max, ...]``; a rank asks for its own
    edges only.  ``program(el_state, bandit_states, budgets, draws)`` ->
    ``(el_state, bandit_states, budgets, history)``, ``draws`` an RNG-seam
    provider (``repro_torch.el.rng``): each round asks it for one Gumbel
    array ``[E, h_max]``, row e edge e's categorical draw (the
    reference's ``jax_select_arm`` on ``split(split(rng)[1], E)[e]``), so
    a ``ReplayDraws`` of those reproduces the reference's arms.  A round
    in which no edge can afford an arm keeps the state (the reference's
    ``where(any_active, new, old)``) but still yields the round's loss:
    it runs on a copy of the state, discarded.
    """
    el_round = make_el_round(model, train_cfg, h_max, mode=mode, mesh=mesh)
    mine = el_round.edges(n_edges)

    def program(el_state: ELMeshState, bandit_states: Dict,
                budgets: torch.Tensor, draws):
        dev = budgets.device
        comp = torch.as_tensor(comp_costs, dtype=torch.float32, device=dev)
        comm = torch.as_tensor(comm_costs, dtype=torch.float32, device=dev)
        arms_cost = _fma32(torch.arange(1, h_max + 1, dtype=torch.float32,
                                        device=dev)[None, :],
                           comp[:, None], comm[:, None])        # [E, K]
        ids = torch.arange(mine.start, mine.stop, device=dev)
        steps = torch.arange(h_max, device=dev)
        bstates, prev_loss = bandit_states, torch.tensor(
            float("inf"), device=dev)
        hist: Dict[str, list] = {"loss": [], "intervals": [], "active": [],
                                 "budgets": []}
        for rnd in range(n_rounds):
            g = draws.gumbel((n_edges, h_max), dev)
            arms = torch.stack([device_select_arm(
                g[e], _edge_view(bstates, e), budgets[e], arms_cost[e],
                torch.tensor(ucb_c, dtype=torch.float32, device=dev))
                for e in range(n_edges)])                          # [E]
            active = arms >= 0
            intervals = torch.where(active, arms + 1, 1).int()
            if mode == "sync":
                # one shared decision: the first active edge's arm
                first = torch.argmax(active.int())
                intervals = intervals[first].expand(n_edges).clone()
                active = active[first].expand(n_edges).clone()
            batches = data_fn(ids, rnd, steps)
            weights = active.float()
            any_active = bool(active.any())
            safe_w = weights if any_active else torch.ones_like(weights)
            target = el_state if any_active else ELMeshState(
                *tree_map(torch.clone, tuple(el_state)))
            _, metrics = el_round(target, batches, intervals, safe_w)
            loss = metrics["mean_loss"]
            utility = torch.where(torch.isfinite(prev_loss),
                                  prev_loss - loss, 0.0)
            cost_e = _fma32(intervals.float(), comp, comm)
            budgets = budgets - torch.where(active, cost_e, 0.0)
            bstates = _stack([device_bandit_update(
                _edge_view(bstates, e), arms[e], utility, cost_e[e])
                for e in range(n_edges)])
            prev_loss = loss
            for name, v in (("loss", loss), ("intervals", intervals),
                            ("active", active), ("budgets", budgets)):
                hist[name].append(v)
        return el_state, bstates, budgets, {k: torch.stack(v)
                                            for k, v in hist.items()}

    return program


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


def el_state_specs(model_cfg: ModelConfig, mesh,
                   state_shape: ELMeshState) -> ELMeshState:
    """PartitionSpecs: the leading edge dim over (pod, data); params by
    the per-arch resolver; optimizer moments mirror the params (SGD's
    scalar placeholders shard the edge dim only); the step replicates."""
    ea = edge_axes(mesh)

    def strip_lead(tree):
        return tree_map(lambda x: _Shape(tuple(x.shape)[1:]), tree)

    p_specs = param_specs(model_cfg, mesh, strip_lead(state_shape.params))
    p_specs = map_specs(lambda s: P(ea, *s), p_specs)
    p_leaf_shapes = [tuple(x.shape) for x in tree_leaves(state_shape.params)]
    nu_shape = state_shape.opt.nu
    nu_leaf_shapes = [tuple(x.shape) for x in tree_leaves(nu_shape)]
    if p_leaf_shapes == nu_leaf_shapes:
        nu_specs = p_specs
    else:   # stacked scalar placeholders [E]: shard the edge dim only
        nu_specs = tree_map(
            lambda x: P(ea, *([None] * (len(x.shape) - 1)))
            if len(x.shape) else P(), nu_shape)
    opt_specs = OptState(step=P(), mu=p_specs, nu=nu_specs)
    return ELMeshState(params=p_specs, opt=opt_specs)
