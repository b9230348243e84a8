"""One rank's share of a language model over a (pod x) data x model mesh:
its blocks of the parameters and optimizer state, its rows of a batch and
its blocks of a decode cache, in the reference's layouts
(``repro_torch.sharding.param_specs`` / ``cache_specs``), and how a
rank's step reads them.

:class:`ParamLayout` is the one parameter layout of every sharded step:
the OL4EL round (``repro_torch.federated.local_sgd``, ``fsdp=False``: each
edge's model split over ``model``), the baseline train step (``fsdp=True``:
also split over the edge axes, the ZeRO-3 layout) and the serving steps
(``fsdp=False``).  A rank holds block i of a leaf along each dim a spec
puts on an axis (i its coordinate there, several axes flattened in the
mesh's order, as ``repro_torch.sharding.Placement.local_slices`` cuts).
The model's ``param_hook`` (:meth:`ParamLayout.use`) gathers a leaf's
blocks where the model uses them, over ``model`` and then over the edge
group, inside a layer group's ``checkpoint`` (so a group's full weights
live only in its forward and its recompute).  The backward of the model
gather keeps the rank's block (every model rank runs the same rows on
the same weights, so their gradients are equal); the backward of the
edge gather sums the edge ranks' gradients, which differ because their
rows differ, in rank order, and keeps the rank's block (a deterministic
reduce-scatter, ``repro_torch.launch.mesh.reduce_scatter_dim``); a leaf
the layout leaves whole over the edges (the 1-D norms, a dim that does not
divide) has its gradient summed the same way on every rank
(``all_reduce_ordered``).  The clip's global norm reads each gradient
leaf gathered whole, one at a time (:meth:`ParamLayout.full_leaves`), and
AdamW's update is elementwise on the blocks.

:class:`CacheLayout` holds the decode cache in ``cache_specs``' layout:
when the batch tiles the edge ranks a rank holds its rows; else (batch 1,
``long_500k``) the K/V *sequence* is split over the edge ranks and
attention runs split-KV (``repro_torch.models.layers.
attention_decode_split``).  A ``model``-split K/V, conv or SSM dim is
gathered per layer just before use, and the rank writes back its block.
"""

from __future__ import annotations

import copy
from typing import Any, Iterator, Optional, Tuple

import torch

from repro_torch.interop import tree_leaves, tree_map
from repro_torch.launch.mesh import (all_reduce_ordered, gather_model_dim,
                                     group_rank, group_size,
                                     reduce_scatter_dim)
from repro_torch.models.layers import block_write_slot
from repro_torch.sharding import cache_specs, map_specs, param_specs

Params = Any


def _axis_dim(spec, names: Tuple[str, ...]) -> Optional[int]:
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        if any(a in names for a in axes):
            return d
    return None


def model_dim(spec) -> Optional[int]:
    """The dim a spec puts on the ``model`` axis, or ``None``."""
    return _axis_dim(spec, ("model",))


def edge_dim(spec) -> Optional[int]:
    """The dim a spec puts on the edge axes (``pod`` / ``data``), or
    ``None``."""
    return _axis_dim(spec, ("pod", "data"))


def _live(group):
    return group if group is not None and group_size(group) > 1 else None


def edge_group(mesh):
    """``mesh``'s edge group (pod x data, ranks in the flattened
    coordinate's order), or ``None`` without a mesh or with one edge
    rank."""
    return None if mesh is None else _live(mesh.edge_group())


def _coord(group) -> Tuple[int, int]:
    return (0, 1) if group is None else (group_rank(group), group_size(group))


def _cut(leaf: torch.Tensor, dim: Optional[int], index: int,
         world: int) -> torch.Tensor:
    """Block ``index`` of ``world`` along ``dim``, its own storage (so
    the whole leaf can be freed); the leaf itself for ``dim=None``."""
    if dim is None or leaf.dim() == 0:
        return leaf
    n = leaf.shape[dim] // world
    return leaf.narrow(dim, index * n, n).clone(
        memory_format=torch.contiguous_format)


def _gather(leaf: torch.Tensor, dim: Optional[int], group) -> torch.Tensor:
    if dim is None or group is None or leaf.dim() == 0:
        return leaf
    return gather_model_dim(leaf, dim, group)


def _shift(dims):
    """A stacked group tree's dims less its leading ``[n_groups]``."""
    return tree_map(lambda d: None if d is None else d - 1, dims)


class _GatherModel(torch.autograd.Function):
    """Forward: a leaf's blocks all-gathered over the model group along
    ``dim``; backward: this rank's block of the incoming gradient, a copy
    (so the full gradient is freed at once)."""

    @staticmethod
    def forward(ctx, block, dim, group):
        ctx.dim, ctx.n = dim, block.shape[dim]
        ctx.lo = group_rank(group) * ctx.n
        return gather_model_dim(block, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.lo, ctx.n).contiguous(), None, None


class _GatherEdge(torch.autograd.Function):
    """Forward: a leaf's blocks all-gathered over the edge group along
    ``dim``; backward: the edge ranks' gradients summed in rank order,
    this rank's block of the sum (a deterministic reduce-scatter)."""

    @staticmethod
    def forward(ctx, block, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_model_dim(block, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim(grad, ctx.dim, ctx.group), None, None


class _SumEdge(torch.autograd.Function):
    """Forward: the leaf; backward: the edge ranks' gradients summed in
    rank order, on every rank."""

    @staticmethod
    def forward(ctx, leaf, group):
        ctx.group = group
        return leaf.view_as(leaf)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_ordered(grad.contiguous(), ctx.group), None


class Blocks:
    """A tree's layout over a mesh: ``dims`` / ``edge_dims`` are its
    ``model`` and edge-axes dims per leaf (``None``: whole along it) from
    ``specs``; this rank is block ``index`` of ``world`` over the model
    group and ``edge_index`` of ``edge_world`` over the edge group
    (``None``: each leaf whole over the edge axes, whatever its spec)."""

    def __init__(self, specs, model_group, edge_group=None):
        self.model_group, self.edge_group = model_group, edge_group
        self.index, self.world = _coord(model_group)
        self.edge_index, self.edge_world = _coord(edge_group)
        self.dims = map_specs(model_dim, specs)
        self.edge_dims = map_specs(
            edge_dim if edge_group is not None else lambda _: None, specs)

    def shard(self, tree: Any) -> Any:
        """A tree of whole leaves (or one shaped like it: AdamW's moments)
        cut to this rank's blocks."""
        return tree_map(lambda leaf, md, ed: _cut(
            _cut(leaf, md, self.index, self.world), ed, self.edge_index,
            self.edge_world), tree, self.dims, self.edge_dims)

    def gather(self, tree: Any) -> Any:
        """:meth:`shard`'s inverse: each leaf gathered whole (a collective
        every rank calls; for tests and checkpoints)."""
        return tree_map(lambda leaf, md, ed: _gather(
            _gather(leaf, ed, self.edge_group), md, self.model_group),
            tree, self.dims, self.edge_dims)


class ParamLayout(Blocks):
    """One model's parameters over a mesh (a ``Mesh`` or a ``PlanMesh``,
    whose groups record the collectives), by ``param_specs(fsdp=fsdp)``
    on the full shapes ``params_shape``.  ``fsdp=True`` is the layout of
    a data-parallel step whose rows split over the edge ranks: every
    gradient is summed over the edge group in the backward."""

    def __init__(self, model_cfg, mesh, params_shape: Params, *,
                 fsdp: bool = False):
        super().__init__(
            param_specs(model_cfg, mesh, params_shape, fsdp=fsdp),
            _live(mesh.model_group()), edge_group(mesh) if fsdp else None)
        groups = (self.dims["groups"], self.edge_dims["groups"])
        # a group's tree: the stacked leaves less their [n_groups] dim, or
        # (unstacked) any group of the list
        self.group_dims = (tuple(_shift(g) for g in groups)
                           if model_cfg.scan_layers
                           else tuple(g[0] for g in groups))

    @classmethod
    def for_model(cls, model, mesh, *, fsdp: bool = False
                  ) -> "ParamLayout":
        """The layout of ``model``'s parameter tree (its shapes from a
        ``meta`` twin: nothing drawn)."""
        from repro_torch.models import LM
        return cls(model.cfg, mesh,
                   LM(model.cfg, device="meta").init(None), fsdp=fsdp)

    # -- carrying trees across ---------------------------------------------

    def shard_state(self, state):
        """A ``TrainState`` of whole leaves cut to this rank's blocks: the
        parameters and each moment tree shaped like them (SGD's 0-d
        placeholders stay as they are); the step is replicated."""
        return self._state(state, self.shard)

    def gather_state(self, state):
        """:meth:`shard_state`'s inverse (a collective every rank
        calls)."""
        return self._state(state, self.gather)

    @staticmethod
    def _state(state, fn):
        opt = state.opt
        return type(state)(fn(state.params), type(opt)(
            opt.step, fn(opt.mu), fn(opt.nu)))

    # -- a step's reads --------------------------------------------------------

    def _at(self, key) -> Tuple[Any, Any]:
        if key == ("groups",):
            return self.group_dims
        md, ed = self.dims, self.edge_dims
        for k in key:
            md, ed = md[k], ed[k]
        return md, ed

    def _use_leaf(self, leaf, md, ed):
        if md is not None and self.model_group is not None:
            leaf = _GatherModel.apply(leaf, md, self.model_group)
        if ed is not None:
            leaf = _GatherEdge.apply(leaf, ed, self.edge_group)
        elif self.edge_group is not None:
            leaf = _SumEdge.apply(leaf, self.edge_group)
        return leaf

    def use(self, tree: Params, *key) -> Params:
        """The ``LM.param_hook``: the blocks at ``key`` gathered whole,
        over ``model`` first, then over the edge group."""
        md, ed = self._at(key)
        return tree_map(self._use_leaf, tree, md, ed)

    def full_leaves(self, grads: Params) -> Iterator[torch.Tensor]:
        """The clip's leaves: each gradient block gathered whole, one at a
        time, in ``tree_leaves`` order."""
        for g, md, ed in zip(tree_leaves(grads), tree_leaves(self.dims),
                             tree_leaves(self.edge_dims)):
            yield _gather(_gather(g, ed, self.edge_group), md,
                          self.model_group)

    def hooked(self, model, token_group=None):
        """A shallow copy of ``model`` that reads its parameters through
        this layout, its batch's rows split over ``token_group``
        (``LM.token_group``)."""
        out = copy.copy(model)
        out.param_hook = self.use
        out.token_group = token_group
        return out


def local_rows(batch: Any, mesh) -> Any:
    """This rank's rows of a global batch tree (every leaf's dim 0 split
    over the edge ranks, as ``batch_spec``'s ``P(edge axes)``); a batch
    that does not tile them is refused, as that spec refuses it."""
    group = edge_group(mesh)
    if group is None:
        return batch
    index, world = _coord(group)

    def cut(x):
        if x.shape[0] % world:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                             f"over the {world} ranks of the edge axes")
        n = x.shape[0] // world
        return x[index * n:(index + 1) * n]
    return tree_map(cut, batch)


class KVSplit:
    """A decode's K/V sequence split over the edge group: this rank holds
    slots ``lo .. lo + n - 1`` (positions, or a ring cache's slots)."""

    def __init__(self, lo: int, n: int, group):
        self.lo, self.n, self.group = lo, n, group


class CacheLayout(Blocks):
    """The decode cache of ``model`` for ``batch`` slots of ``max_len``
    positions over ``mesh``, in ``cache_specs``' layout (:meth:`shard` /
    :meth:`gather` carry a whole cache, ``LM.init_cache`` / ``prefill``'s,
    across); ``kv_split`` the rank's share of a sequence-split K/V
    (``None`` when the batch tiles the edge ranks or there is one)."""

    def __init__(self, model, mesh, batch: int, max_len: int):
        meta = copy.copy(model)
        meta.device = torch.device("meta")
        self.shape = meta.init_cache(batch, max_len)
        super().__init__(cache_specs(model.cfg, mesh, self.shape, batch),
                         _live(mesh.model_group()), edge_group(mesh))
        self.stacked = model.cfg.scan_layers
        self.ring = model.ring_cache
        self.batch_split = (self.edge_group is not None
                            and batch % self.edge_world == 0)
        self.kv_split = None
        if self.edge_group is not None and not self.batch_split:
            # a K/V leaf split over the edge axes along its sequence dim
            # (the cache's slots: max_len, or a ring's window)
            seq = [leaf.shape[ed] for leaf, ed in zip(
                tree_leaves(self.shape), tree_leaves(self.edge_dims))
                if ed is not None and ed == leaf.dim() - 3]
            if seq:
                n = seq[0] // self.edge_world
                self.kv_split = KVSplit(self.edge_index * n, n,
                                        self.edge_group)

    @property
    def token_group(self):
        """The group a decode step's batch rows split over (``None``: each
        rank runs every row)."""
        return self.edge_group if self.batch_split else None

    def _block(self, leaf, md, ed) -> Tuple[int, ...]:
        shape = list(leaf.shape)
        if md is not None and self.model_group is not None:
            shape[md] //= self.world
        if ed is not None:
            shape[ed] //= self.edge_world
        return tuple(shape)

    def init(self, device) -> Any:
        """This rank's blocks of the zero cache on ``device``."""
        return tree_map(lambda leaf, md, ed: torch.zeros(
            self._block(leaf, md, ed), dtype=leaf.dtype, device=device),
            self.shape, self.dims, self.edge_dims)

    def _layer_dims(self, key) -> Any:
        """The ``model`` dims of one block's cache at ``key``
        (``("prefix_layers", i)`` or ``("groups", "sub<i>")``)."""
        if key[0] == "prefix_layers":
            return self.dims["prefix_layers"][key[1]]
        groups = self.dims["groups"]
        groups = _shift(groups) if self.stacked else groups[0]
        return groups[key[1]]

    def _slot(self, index: torch.Tensor, length: int) -> torch.Tensor:
        """The slot the new token's K/V went to in a layer's block (on a
        rank that does not own it, a slot of its block it rewrote
        unchanged)."""
        split = self.kv_split
        lo, blocks = (0, 1) if split is None else (split.lo, self.edge_world)
        return block_write_slot(index, lo, length, length * blocks,
                                self.ring)[2]

    def run(self, block_fn, p, kind: str, ffn: str, x: torch.Tensor,
            c: Any, index: torch.Tensor, key: tuple):
        """One decode block on this rank's blocks ``c`` of the layer at
        ``key``: its ``model``-split leaves gathered whole, the block run,
        and the rank's block written back (a K/V's new row; a new SSM or
        conv state's block)."""
        md = self._layer_dims(key)
        if self.model_group is None:
            return block_fn(p, kind, ffn, x, c)
        full = {n: _gather(leaf, md[n], self.model_group)
                for n, leaf in c.items()}
        x, new = block_fn(p, kind, ffn, x, full)
        out = {}
        for name, leaf in c.items():
            d = md[name]
            if d is None:
                out[name] = new[name]
            elif name in ("k", "v"):
                slot = self._slot(index, leaf.shape[1])
                leaf.index_copy_(1, slot, new[name].index_select(1, slot)
                                 .narrow(d, self.index * leaf.shape[d],
                                         leaf.shape[d]))
                out[name] = leaf
            else:
                out[name] = _cut(new[name], d, self.index, self.world)
        return x, out
