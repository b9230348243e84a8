"""Per-architecture placement policy: which mesh axes each tensor's dims
split over (port of ``repro.sharding``).

Maps every parameter / activation / cache tensor to a :class:`PartitionSpec`
for the production meshes.  Rules are *name + shape* based and
divisibility-checked against the actual mesh axis sizes, because the
assigned architectures have head counts (40, 56, 36, 24...) that do not
all divide the 16-way model axis: the resolver prefers sharding heads,
falls back to head_dim, then to replication.

Conventions:
  * ``model`` axis: tensor-parallel dim (heads / d_ff / experts / d_inner).
  * ``data`` (+ ``pod``) axes: the batch -- and, for the batch=1
    long-context shape, the KV-cache *sequence* dim instead
    (flash-decoding style).

Every function here reads only a mesh's ``axis_names`` and
``devices.shape`` and the leaves' ``.shape``: a ``repro_torch.launch.mesh.
Mesh``, or any object with those two attributes, and trees of tensors
(``meta`` ones included) or of anything with a ``shape``.  Trees are the
port's nested dicts, lists and NamedTuples (``repro_torch.interop``).
:func:`to_shardings` turns specs into :class:`Placement` s, which also say
which block of a tensor a rank of a live mesh holds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from repro_torch.config import ModelConfig

#: Mesh axes the per-edge (batch/fleet) dims spread over.
_EDGE_AXIS_NAMES = ("pod", "data")


class PartitionSpec(tuple):
    """One entry per tensor dim: an axis name, a tuple of axis names, or
    ``None`` (replicated along that dim).  A one-name tuple is stored as
    the name and an empty tuple as ``None``, as ``jax.sharding.
    PartitionSpec`` normalizes them, so specs compare equal to the
    reference's (which compare equal to plain tuples)."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                if not e:
                    return None
                return e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _axis_size(mesh, name: str) -> int:
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get(name, 1)


def edge_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in _EDGE_AXIS_NAMES if a in mesh.axis_names)


def tree_map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts, lists and NamedTuples,
    ``path`` the keys from the root as the reference's key paths read
    them (``_leaf_path_keys``): a dict's key, a list's index, ``None`` for
    a NamedTuple's field."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        named = hasattr(tree, "_fields")
        items = [tree_map_with_path(fn, v, path + (None if named else i,))
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if named else type(tree)(items)
    return fn(path, tree)


def _tree_map(fn: Callable, tree: Any, is_leaf=None) -> Any:
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        items = [_tree_map(fn, v, is_leaf) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return fn(tree)


def map_specs(fn: Callable, specs: Any) -> Any:
    """``fn`` over every :class:`PartitionSpec` of a tree of them."""
    return _tree_map(fn, specs,
                     is_leaf=lambda x: isinstance(x, PartitionSpec))


def _leaf_param_name(keys) -> str:
    """The rule-lookup name of a param-tree leaf: the last string key on
    its path, ignoring ``sub*`` wrapper levels."""
    return next((k for k in reversed(keys) if isinstance(k, str)
                 and not k.startswith("sub")), "")


def _div(n: int, m: int) -> bool:
    return m > 0 and n % m == 0


def _prod(it) -> int:
    out = 1
    for v in it:
        out *= v
    return out


def _param_spec(name: str, shape: Tuple[int, ...], ms: int
                ) -> PartitionSpec:
    """PartitionSpec for one parameter leaf (no stacking dim)."""
    nd = len(shape)

    def pick(*cands: Tuple[int, str]) -> PartitionSpec:
        """First candidate dim divisible by the model-axis size wins."""
        spec: list = [None] * nd
        for dim, axis in cands:
            if _div(shape[dim], ms):
                spec[dim] = axis
                return P(*spec)
        return P(*spec)

    if name == "embed":
        if nd == 3:                       # [CB, V, d]
            return pick((1, "model"), (2, "model"))
        return pick((0, "model"), (1, "model"))          # [V, d]
    if name == "lm_head":
        if nd == 3:                       # [CB, d, V]
            return pick((2, "model"), (1, "model"))
        return pick((1, "model"), (0, "model"))          # [d, V]
    if name in ("wq", "wk", "wv"):        # [d, H, hd]
        return pick((1, "model"), (2, "model"))
    if name == "wo" and nd == 3:          # [H, hd, d]
        return pick((0, "model"), (1, "model"))
    if name == "wo" and nd == 2:          # mlp down [f, d]
        return pick((0, "model"))
    if name in ("bq", "bk", "bv"):        # [H, hd]
        return pick((0, "model"), (1, "model"))
    if name in ("wi_gate", "wi_up", "ws_gate", "ws_up"):  # [d, f]
        return pick((1, "model"))
    if name == "ws_down":                 # [f, d]
        return pick((0, "model"))
    if name == "router":                  # [d, E]
        return pick((1, "model"))
    if name in ("we_gate", "we_up"):      # [E, d, f]
        return pick((0, "model"), (2, "model"))
    if name == "we_down":                 # [E, f, d]
        return pick((0, "model"), (1, "model"))
    if name == "in_proj":                 # [d, 2di+2n+nh]
        return pick((1, "model"))
    if name == "conv_w":                  # [K, C]
        return pick((1, "model"))
    if name in ("conv_b", "gate_norm", "A_log", "D", "dt_bias"):
        return pick((0, "model"))
    if name == "out_proj":                # [di, d]
        return pick((0, "model"))
    # norms, scalars, classic-model params: replicate
    return P(*([None] * nd))


def param_specs(cfg: ModelConfig, mesh, params_shape: Any,
                fsdp: bool = False) -> Any:
    """PartitionSpec tree matching ``params_shape`` (``LM.init(None)``'s
    meta tree, or any tree of shaped leaves).

    ``fsdp=True`` additionally shards each parameter's largest still-
    unsharded dim over the edge (pod+data) axes when divisible (the
    ZeRO-3/FSDP layout)."""
    ms = _axis_size(mesh, "model")
    ea = edge_axes(mesh)
    n_edge = _prod(_axis_size(mesh, a) for a in ea)

    def add_fsdp(spec: PartitionSpec, shape: Tuple[int, ...]
                 ) -> PartitionSpec:
        if not fsdp or len(shape) < 2 or n_edge <= 1:
            return spec
        dims = sorted(range(len(shape)), key=lambda i: -shape[i])
        out = list(spec) + [None] * (len(shape) - len(spec))
        for i in dims:
            if out[i] is None and _div(shape[i], n_edge):
                out[i] = ea
                return P(*out)
        return spec

    def leaf_spec(keys, leaf) -> PartitionSpec:
        name = _leaf_param_name(keys)
        # scanned models stack group params on a leading n_groups dim;
        # unrolled models keep a list of per-group dicts (no extra dim)
        stacked = ("groups" in keys) and cfg.scan_layers
        shape = tuple(leaf.shape)
        if stacked:
            base = add_fsdp(_param_spec(name, shape[1:], ms), shape[1:])
            return P(None, *base)
        return add_fsdp(_param_spec(name, shape, ms), shape)

    return tree_map_with_path(leaf_spec, params_shape)


def batch_spec(mesh) -> PartitionSpec:
    """Token batches: batch dim over the edge (pod+data) axes."""
    return P(edge_axes(mesh))


def batch_sharding(cfg: ModelConfig, mesh, batch_shape: Any,
                   shard_batch: bool = True) -> Any:
    """PartitionSpecs for a train/prefill input batch tree (the
    reference's ``batch_sharding`` returns the same specs)."""
    ea = edge_axes(mesh)

    def leaf(keys, x) -> PartitionSpec:
        nd = len(x.shape)
        if not shard_batch or x.shape[0] % max(
                1, _prod(_axis_size(mesh, a) for a in ea)):
            return P(*([None] * nd))
        if "prefix_emb" in keys:
            return P(ea, None, None)
        return P(ea, *([None] * (nd - 1)))

    return tree_map_with_path(leaf, batch_shape)


def cache_specs(cfg: ModelConfig, mesh, cache_shape: Any,
                batch: int) -> Any:
    """PartitionSpecs for the decode cache.

    batch >= n_edge_devices -> shard batch over edge axes; batch == 1
    (long-context) -> shard the KV *sequence* dim over the edge axes
    instead."""
    ms = _axis_size(mesh, "model")
    ea = edge_axes(mesh)
    n_edge = _prod(_axis_size(mesh, a) for a in ea)
    shard_batch = _div(batch, n_edge)

    def leaf_spec(keys, leaf) -> PartitionSpec:
        name = _leaf_param_name(keys)
        stacked = ("groups" in keys) and cfg.scan_layers
        shape = tuple(leaf.shape)[1:] if stacked else tuple(leaf.shape)
        nd = len(shape)
        spec: list = [None] * nd
        if name in ("k", "v"):            # [B, S, KV, hd]
            if shard_batch:
                spec[0] = ea
            elif _div(shape[1], n_edge):
                spec[1] = ea              # seq-sharded KV (batch=1)
            if _div(shape[2], ms):
                spec[2] = "model"
            elif _div(shape[3], ms):
                spec[3] = "model"
        elif name == "conv":              # [B, K-1, C]
            if shard_batch:
                spec[0] = ea
            if _div(shape[2], ms):
                spec[2] = "model"
        elif name == "ssm":               # [B, H, P, N]
            if shard_batch:
                spec[0] = ea
            if _div(shape[1], ms):
                spec[1] = "model"
            elif _div(shape[2], ms):
                spec[2] = "model"
        # "index": replicated scalar
        if stacked:
            return P(None, *spec)
        return P(*spec)

    return tree_map_with_path(leaf_spec, cache_shape)


# ---------------------------------------------------------------------------
# Placements: specs on a live mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Placement:
    """A spec on a mesh, the counterpart of ``jax.sharding.
    NamedSharding``: ``local_slices(shape, rank)`` is the block of a tensor
    of ``shape`` that ``rank`` holds (a dim split over axes of sizes
    s1, s2, ... is cut into s1 * s2 * ... equal blocks, block i for the
    rank whose flattened coordinate along those axes is i; a dim that does
    not divide raises, as XLA refuses such a sharding)."""

    mesh: Any
    spec: PartitionSpec

    def _coordinate(self, rank: int) -> Dict[str, int]:
        import numpy as np
        where = np.argwhere(np.asarray(self.mesh.devices) == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not in the mesh")
        return dict(zip(self.mesh.axis_names, (int(c) for c in where[0])))

    def local_slices(self, shape: Sequence[int], rank: int
                     ) -> Tuple[slice, ...]:
        coord = self._coordinate(rank)
        out = []
        for dim, entry in enumerate(tuple(self.spec)
                                    + (None,) * (len(shape)
                                                 - len(self.spec))):
            if entry is None:
                out.append(slice(None))
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            idx, n = 0, 1
            for a in axes:
                size = _axis_size(self.mesh, a)
                idx, n = idx * size + coord[a], n * size
            if shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"split over {axes} ({n} ways)")
            block = shape[dim] // n
            out.append(slice(idx * block, (idx + 1) * block))
        return tuple(out)

    @property
    def replicated(self) -> bool:
        return all(e is None for e in self.spec)


def to_shardings(mesh, specs: Any) -> Any:
    """Every spec of ``specs`` as a :class:`Placement` on ``mesh``."""
    return map_specs(lambda s: Placement(mesh, s), specs)


# ---------------------------------------------------------------------------
# EL data-plane placement (the compiled sync round, repro_torch.el.ingraph,
# and the OL4EL round over ranks, repro_torch.federated.local_sgd)
# ---------------------------------------------------------------------------

#: Control-plane knobs with a trailing per-edge dim ``[..., E]``
#: (replicated in a single run: the control plane replicates).
EL_EDGE_KNOBS = ("comp", "comm", "min_edge_cost")
#: Scalar control-plane knobs (``[n_cells]`` in a sweep, 0-d in a run).
EL_SCALAR_KNOBS = ("ucb_c", "budget", "cost_noise", "async_alpha",
                   "event_cap", "scn_drift", "policy_id")
#: Scenario schedule knobs ``[period, E]`` -- control plane like every
#: other knob: replicated in a single run.
EL_SCHEDULE_KNOBS = ("scn_active", "scn_mult")


def el_edge_dim_axes(axis_names: Sequence[str],
                     axis_sizes: Dict[str, int],
                     n_edges: int) -> Optional[Tuple[str, ...]]:
    """Mesh axes the ``[n_edges, ...]`` data-plane dim shards over: the
    (``pod``, ``data``) axes when the edge count tiles them, ``None``
    (replicate) otherwise -- a 3-edge fleet on a 2-wide data axis still
    runs, without edge parallelism."""
    ea = tuple(a for a in _EDGE_AXIS_NAMES if a in axis_names)
    n_shards = _prod(axis_sizes.get(a, 1) for a in ea)
    if ea and n_shards > 1 and n_edges % n_shards == 0:
        return ea
    return None


def el_run_partition_specs(axis_names: Sequence[str],
                           axis_sizes: Dict[str, int],
                           n_edges: int,
                           knob_names: Sequence[str]
                           ) -> Tuple[PartitionSpec,
                                      Dict[str, PartitionSpec]]:
    """PartitionSpecs for one EL run's (edge data, knobs): the per-edge
    datasets ``xs [E, N, d]`` / ``ys [E, N]`` shard their edge dim over
    (``pod``, ``data``) via :func:`el_edge_dim_axes`; every control-plane
    knob replicates."""
    ea = el_edge_dim_axes(axis_names, axis_sizes, n_edges)
    edge_spec = P(ea) if ea else P(None)
    knob_specs = {name: P() for name in knob_names}
    return edge_spec, knob_specs


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def el_stacked_param_specs(mesh, n_edges: int, stacked_params: Any) -> Any:
    """PartitionSpecs for an ``[n_edges, ...]``-stacked param tree: the
    leading edge dim over (``pod``, ``data``) when it tiles, each
    parameter's own dims by the per-arch resolver (classic and unknown
    names replicate).  Scanned-LM group stacking is not handled here, as
    in the reference."""
    ms = _axis_size(mesh, "model")
    ea = el_edge_dim_axes(mesh.axis_names, _sizes(mesh), n_edges)

    def leaf_spec(keys, leaf) -> PartitionSpec:
        name = _leaf_param_name(keys)
        base = _param_spec(name, tuple(leaf.shape)[1:], ms)
        return P(ea, *base)

    return tree_map_with_path(leaf_spec, stacked_params)


def el_cohort_slot_axes(axis_names: Sequence[str],
                        axis_sizes: Dict[str, int],
                        n_slots: int) -> Optional[Tuple[str, ...]]:
    """Mesh axes a fleet cohort's ``[n_slots, ...]`` tenant-slot dim
    shards over: the single-run edge dim's tiles-or-replicates policy."""
    return el_edge_dim_axes(axis_names, axis_sizes, n_slots)


def el_cohort_state_specs(mesh, n_slots: int, state: Any) -> Any:
    """PartitionSpecs for a cohort's slot-stacked carry/knob tree: a leaf
    with a leading ``[n_slots]`` dim shards it over the cohort slot axes,
    anything else replicates."""
    ea = el_cohort_slot_axes(mesh.axis_names, _sizes(mesh), n_slots)

    def leaf_spec(leaf) -> PartitionSpec:
        nd = len(leaf.shape)
        if ea and nd >= 1 and leaf.shape[0] == n_slots:
            return P(ea, *([None] * (nd - 1)))
        return P(*([None] * nd))

    return _tree_map(leaf_spec, state)


def el_run_in_shardings(mesh, model_cfg: Optional[ModelConfig],
                        params_shape: Any,
                        knob_names: Sequence[str]) -> Tuple[Any, ...]:
    """Placements for the compiled EL programs' inputs ``(init_params,
    rng, knobs)``: params by the per-arch resolver (classic models
    replicate), the draws and every knob replicated (the control
    plane)."""
    if model_cfg is not None:
        p_sh = to_shardings(mesh, param_specs(model_cfg, mesh,
                                              params_shape))
    else:
        p_sh = _tree_map(lambda _: Placement(mesh, P()), params_shape)
    rep = Placement(mesh, P())
    return p_sh, rep, {k: rep for k in knob_names}
