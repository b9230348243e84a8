"""Mesh construction (port of ``repro.launch.mesh``).

A function, not a module-level constant, so importing this module never
touches ``torch.distributed``; callers control when a world is joined.

The reference builds ``jax.make_mesh`` over the devices of one process.
Here a mesh is a world of processes, one rank per card (or, on the CPU,
one gloo process per rank; ``repro_torch.launch.hostdev`` spawns them),
and :class:`Mesh` wraps ``torch.distributed.device_mesh.init_device_mesh``
so that callers read ``axis_names``, ``devices`` (the ranks, in the mesh's
shape) and ``shape`` as they read a ``jax.sharding.Mesh``.  The shapes,
axis names and ``REPRO_DEBUG_MESH`` are the reference's:

  Single pod: 16x16 = 256 ranks, axes (data, model).
  Multi-pod:  2x16x16 = 512 ranks, axes (pod, data, model).

Backend: ``device=None`` means CUDA and NCCL and raises without a card
(as ``repro_torch.device.resolve_device`` does); ``device="cpu"`` means
gloo.  An explicit ``backend=`` is the only other way to pick one (gloo
with CUDA tensors lets several ranks share one card).  Nothing picks a
backend silently.

The world comes from the environment: ``RANK`` / ``WORLD_SIZE`` with
``REPRO_DIST_INIT`` (the ``file://`` rendezvous ``hostdev`` sets) or
torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``).  A mesh
function joins it once (``init_world``); a process outside any launched
world is a world of one.
"""

from __future__ import annotations

import collections
import contextlib
import io
import os
from typing import Any, Optional, Tuple

import numpy as np

#: Mesh axes the per-edge data plane spreads over (``repro_torch.sharding``).
EDGE_AXES = ("pod", "data")


def _backend_for(device, backend: Optional[str]) -> Tuple[str, str]:
    """(device type, backend) of a mesh: CUDA + NCCL by default, the CPU +
    gloo for ``device="cpu"``, ``backend`` only when given."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    return dev.type, backend


def init_world(backend: str, device_type: str = "cpu") -> None:
    """Join the launched world (or a world of one) with ``backend``, once
    a process.  On CUDA the rank's card is ``LOCAL_RANK`` modulo the
    cards it sees, set before the group forms; NCCL refuses two ranks of
    one communicator on one card, so a world larger than the cards under
    NCCL raises."""
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"this process already joined a {dist.get_backend()} "
                f"world; a {backend} mesh cannot share it")
        return
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if device_type == "cuda":
        n_cards = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_RANK", str(rank)))
        if backend == "nccl" and world > n_cards:
            raise RuntimeError(
                f"an NCCL world of {world} ranks needs {world} cards, "
                f"this machine has {n_cards}; pass backend='gloo' to share "
                "one card")
        torch.cuda.set_device(local % n_cards)
    init = os.environ.get("REPRO_DIST_INIT")
    if init is None:
        if world == 1 and "MASTER_ADDR" not in os.environ:
            import tempfile
            init = "file://" + os.path.join(tempfile.mkdtemp(), "rdzv")
        else:
            init = "env://"
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)


class Mesh:
    """A ``torch.distributed`` device mesh read as a ``jax.sharding.Mesh``:
    ``axis_names``, ``devices`` (the ranks, an int array in the mesh's
    shape), ``shape`` (axis name -> size, in order), ``size``; plus the
    torch ``device_mesh``, the ``backend``, this process's ``rank`` and
    ``coordinate``, :meth:`edge_group` and :meth:`model_group`.  What
    block of a tensor a rank holds is ``repro_torch.sharding.
    Placement``'s to say."""

    def __init__(self, device_mesh, backend: str, device_type: str):
        import torch.distributed as dist
        self.device_mesh = device_mesh
        self.backend = backend
        self.device_type = device_type
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.devices = np.asarray(device_mesh.mesh.cpu().numpy(),
                                  dtype=np.int64)
        self.rank = dist.get_rank()
        where = np.argwhere(self.devices == self.rank)[0]
        self.coordinate = dict(zip(self.axis_names, (int(c) for c in where)))
        self._edge_group = self._make_group(self.edge_axes)
        self._model_group = self._make_group(
            ("model",) if self.shape.get("model", 1) > 1 else ())

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def edge_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in EDGE_AXES if a in self.axis_names)

    def _make_group(self, axes: Tuple[str, ...]):
        """The group of ranks that differ only along ``axes`` (several
        axes: their flattened coordinate), on the mesh's own backend:
        every rank forms every such group, in the same order, as
        ``new_group`` requires.  Group ranks run in the flattened
        coordinate's order; ``None`` for no axes."""
        import torch.distributed as dist
        if not axes:
            return None
        dims = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in dims]
        moved = np.moveaxis(self.devices, dims, range(len(dims)))
        flat = moved.reshape((-1,) + moved.shape[len(dims):])
        mine = None
        for idx in np.ndindex(*[self.devices.shape[i] for i in rest]):
            ranks = [int(r) for r in flat[(slice(None),) + idx]]
            group = dist.new_group(ranks, backend=self.backend)
            if self.rank in ranks:
                mine = group
        return mine

    def edge_group(self):
        """The process group over the edge axes (``None`` without any)."""
        return self._edge_group

    def model_group(self):
        """The process group over the ``model`` axis, its ranks in model
        coordinate order (``None`` without a ``model`` axis of 2 or
        more): the ranks that hold the shards of one edge's model."""
        return self._model_group

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, backend={self.backend!r}, "
                f"rank={self.rank})")


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device: Any = None, backend: Optional[str] = None) -> Mesh:
    """A :class:`Mesh` of ``shape`` over the launched world, which must
    hold exactly ``prod(shape)`` ranks."""
    import inspect

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    device_type, backend = _backend_for(device, backend)
    init_world(backend, device_type)
    world = dist.get_world_size()
    if world != int(np.prod(shape)):
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs "
            f"{int(np.prod(shape))} ranks, the launched world has {world}")
    kw = {}
    if "backend_override" in inspect.signature(init_device_mesh).parameters:
        # each axis's group on the mesh's backend (a gloo mesh on a card
        # would otherwise get NCCL groups)
        kw["backend_override"] = {a: backend for a in axes}
    return Mesh(init_device_mesh(device_type, tuple(shape),
                                 mesh_dim_names=tuple(axes), **kw),
                backend, device_type)


def production_shape(*, multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The production mesh's shape and axes (``REPRO_DEBUG_MESH=d``
    shrinks it to d x d, or 2 x d x d multi-pod)."""
    if os.environ.get("REPRO_DEBUG_MESH"):        # tiny-mesh CI/debug mode
        d = int(os.environ["REPRO_DEBUG_MESH"])
        shape = (2, d, d) if multi_pod else (d, d)
    else:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False, device: Any = None,
                         backend: Optional[str] = None) -> Mesh:
    shape, axes = production_shape(multi_pod=multi_pod)
    return make_mesh(shape, axes, device=device, backend=backend)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *, device: Any = None,
                    backend: Optional[str] = None) -> Mesh:
    """Small (data, model) mesh for multi-rank tests (on the CPU, gloo
    ranks that ``repro_torch.launch.hostdev`` spawns)."""
    return make_mesh((n_data, n_model), ("data", "model"), device=device,
                     backend=backend)


def debug_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """``(n_devices // 2, 2)``: 4 ranks give a 2x2 (data, model) mesh and
    8 a 4-wide ``data`` axis -- the one sizing rule every launcher
    shares."""
    d = max(n_devices // 2, 1)
    return d, n_devices // d


def make_debug_mesh_for(n_devices: int, *, device: Any = None,
                        backend: Optional[str] = None) -> Mesh:
    """The debug mesh over a world of ``n_devices`` ranks."""
    return make_debug_mesh(*debug_mesh_shape(n_devices), device=device,
                           backend=backend)


def debug_mesh_world(argv, module: str, *, device: Any = None
                     ) -> Tuple[Optional[Mesh], Optional[int]]:
    """A launcher's ``--mesh debug``: in a process that is no rank yet,
    spawn the world (``repro_torch.launch.hostdev.force_host_devices``:
    ``REPRO_SWEEP_DEVICES`` ranks of ``python -m module argv``) and return
    ``(None, its exit code)``; in a rank, ``(the debug mesh over the
    launched world, None)``."""
    from repro_torch.launch import hostdev
    rc = hostdev.force_host_devices(argv=argv, module=module)
    if rc is not None:
        return None, rc
    return make_debug_mesh_for(int(os.environ.get("WORLD_SIZE", "1")),
                               device=device), None


@contextlib.contextmanager
def launcher_world(mesh: Optional[Mesh]):
    """A launcher's body over ``mesh``: only rank 0's standard output
    shows, and the process leaves the world on the way out (nothing for
    ``mesh=None``)."""
    if mesh is None:
        yield
        return
    import torch.distributed as dist
    try:
        with (contextlib.nullcontext() if mesh.rank == 0
              else contextlib.redirect_stdout(io.StringIO())):
            yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The edge data plane's one collective
# ---------------------------------------------------------------------------


class EdgeShard:
    """This rank's rows ``lo .. hi - 1`` of an ``[n_edges, ...]`` data-plane
    dim split over a mesh's edge axes (``repro_torch.sharding.
    el_edge_dim_axes``), and the group that gathers them back."""

    def __init__(self, lo: int, hi: int, n_edges: int, group):
        self.lo, self.hi, self.n_edges, self.group = lo, hi, n_edges, group

    @property
    def rows(self) -> slice:
        return slice(self.lo, self.hi)

    @property
    def n_local(self) -> int:
        return self.hi - self.lo

    def gather(self, tree: Any) -> Any:
        """``gather_edge_stack`` of ``tree`` over this shard's group."""
        return gather_edge_stack(tree, self.group)

    def local_rows(self, ids):
        """(rows, mine) of an ``[L]`` tensor of edge ids: each id's row in
        this rank's block, clamped into it, and whether this rank owns
        the id."""
        rows = ids - self.lo
        mine = (rows >= 0) & (rows < self.n_local)
        return rows.clamp(0, self.n_local - 1), mine

    def from_owners(self, tree: Any, ids) -> Any:
        """A tree of ``[L, ...]`` rows, one for each of ``ids`` and
        computed by every rank (at :meth:`local_rows`), as each id's row
        from the rank that owns it: one gather, then row l of the block
        of the rank that holds ``ids[l]`` (the group's rank order is the
        blocks' order)."""
        import torch
        from repro_torch.interop import tree_map
        width = ids.shape[0]
        pick = (ids // self.n_local) * width + torch.arange(
            width, device=ids.device)
        return tree_map(lambda a: a[pick], self.gather(tree))


def edge_shard(mesh, n_edges: int) -> Optional[EdgeShard]:
    """The rank's :class:`EdgeShard` of an ``n_edges`` dim on ``mesh``, or
    ``None`` when there is no mesh or the dim replicates (it does not tile
    the edge axes, or they have one coordinate): then every rank holds
    every edge and nothing is gathered."""
    if mesh is None:
        return None
    from repro_torch.sharding import P, Placement, el_edge_dim_axes
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    ea = el_edge_dim_axes(mesh.axis_names, sizes, n_edges)
    if ea is None:
        return None
    rows = Placement(mesh, P(ea)).local_slices((n_edges,), mesh.rank)[0]
    return EdgeShard(rows.start, rows.stop, n_edges, mesh.edge_group())


def gather_edge_stack(tree: Any, group) -> Any:
    """All-gather a tree of ``[E_local, ...]`` edge stacks into ``[E,
    ...]`` stacks, rows in the group's rank order (the flattened edge
    coordinate's).  One ``all_gather`` a dtype: the leaves are flattened
    side by side into one ``[E_local, F]`` buffer and gathered into the
    row blocks of one ``[E, F]`` buffer, each output leaf a view of it.
    This is the explicit gather in front of every cross-edge reduction
    that keeps a sharded run bit-identical to an unsharded one: the
    reduction then runs on every rank, in edge order, on the whole stack
    (no all-reduce, whose partial sums would reorder it).  Booleans
    travel as bytes.  A :class:`PlannedGroup` allocates the same buffers and exchanges
    nothing (the planner's)."""
    import torch
    import torch.distributed as dist
    from repro_torch.interop import tree_leaves, tree_map
    leaves = tree_leaves(tree)
    planned = isinstance(group, PlannedGroup)
    world = group_size(group)
    out_leaves: dict = {}
    by_dtype: dict = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        local = torch.cat([leaves[i].reshape(leaves[i].shape[0], -1)
                           for i in idx], dim=1)
        if dtype == torch.bool:            # gathered as bytes
            local = local.view(torch.uint8)
        full = local.new_empty((world * local.shape[0], local.shape[1]))
        parts = list(full.chunk(world))
        if planned:
            group.record(local)
            for part in parts:
                part.copy_(local)
        else:
            dist.all_gather(parts, local, group=group)
        del local
        full = full.view(dtype)
        col = 0
        for i in idx:
            width = leaves[i][0].numel()
            out_leaves[i] = full[:, col:col + width].reshape(
                (full.shape[0],) + tuple(leaves[i].shape[1:]))
            col += width
    # tree_leaves runs in sorted-key order, tree_map in the tree's own:
    # match the leaves by identity
    order = {id(leaf): i for i, leaf in enumerate(leaves)}
    return tree_map(lambda leaf: out_leaves[order[id(leaf)]], tree)


def group_rank(group) -> int:
    """This process's rank within ``group`` (0 in a plan)."""
    if isinstance(group, PlannedGroup):
        return 0
    import torch.distributed as dist
    return dist.get_rank(group)


def group_size(group) -> int:
    """The ranks of ``group`` (a :class:`PlannedGroup`'s ``world``)."""
    if isinstance(group, PlannedGroup):
        return group.world
    import torch.distributed as dist
    return dist.get_world_size(group)


def gather_model_dim(shard, dim: int, group):
    """All-gather the ranks' shards of one tensor along ``dim`` over a
    model group: rank i's shard is block i of the result, which is a new
    contiguous tensor (the layout of the unsharded tensor, so a kernel or
    a reduction sees what it sees on one rank).  One ``all_gather`` into
    an ``[M, *shard.shape]`` buffer, then one copy that moves the blocks
    into ``dim`` (none for ``dim == 0``).  A :class:`PlannedGroup`
    allocates the same buffers and exchanges nothing."""
    import torch.distributed as dist
    planned = isinstance(group, PlannedGroup)
    world = group_size(group)
    local = shard.contiguous()
    buf = local.new_empty((world,) + tuple(local.shape))
    parts = list(buf.unbind(0))
    if planned:
        group.record(local)
        for part in parts:
            part.copy_(local)
    else:
        dist.all_gather(parts, local, group=group)
    del local, parts
    full = list(shard.shape)
    full[dim] *= world
    return buf.movedim(0, dim).reshape(full)


class PlannedGroup:
    """A group of ``world`` ranks that exist only in a plan
    (``repro_torch.launch.dryrun --step el_round``): a gather over it
    allocates what the real one does and copies this rank's rows into
    every block; ``calls`` lists each gather's (mnemonic, bytes sent)."""

    def __init__(self, world: int):
        self.world = world
        self.calls: list = []

    def record(self, local) -> None:
        self.calls.append(("all-gather", local.numel()
                           * local.element_size()))


class PlanMesh:
    """A (data, model) mesh of ``n_data`` x ``n_model`` ranks seen from
    rank 0, for plans: what ``repro_torch.sharding``, :func:`edge_shard`
    and ``repro_torch.federated.local_sgd`` read of a :class:`Mesh`, its
    edge group and (``n_model > 1``) its model group
    :class:`PlannedGroup` s."""

    def __init__(self, n_data: int, n_model: int = 1):
        self.axis_names = ("data", "model")
        self.devices = np.arange(n_data * n_model).reshape(n_data, n_model)
        self.shape = collections.OrderedDict(zip(self.axis_names,
                                                 self.devices.shape))
        self.group = PlannedGroup(n_data)
        self.model = PlannedGroup(n_model) if n_model > 1 else None
        self.rank = 0

    def edge_group(self) -> PlannedGroup:
        return self.group

    def model_group(self) -> Optional[PlannedGroup]:
        return self.model
