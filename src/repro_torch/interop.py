"""Carry parameters and caches between the port and numpy.

The reference draws its parameters from ``jax.random``, which torch cannot
reproduce, so a run that must start from the reference's model takes its
tree as numpy (``jax.tree.map(np.asarray, params)`` on the reference side)
and places it here.  A tree is a nested structure of dicts and lists with
array leaves: the classic models' flat ``dict[str, array]``, and the LM's
nested one with its stacked ``groups`` level (leaves ``[n_groups, ...]``),
the cache's scalar ``index``, and the optimizer's ``OptState`` (a
NamedTuple of ``step``, ``mu`` and ``nu``).  Structure, shapes and dtypes
are kept, bfloat16 included (numpy holds it as ``ml_dtypes.bfloat16``).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` to every leaf of a tree of dicts and lists (and
    NamedTuples), with the matching leaves of ``rest`` as further
    arguments; the trees must share one structure."""
    if isinstance(tree, dict):
        if any(not isinstance(r, dict) or r.keys() != tree.keys()
               for r in rest):
            raise ValueError(f"trees differ: keys {sorted(tree)} vs "
                             f"{[sorted(r) for r in rest]}")
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError("trees differ in a list's length")
        items = [tree_map(fn, *vs) for vs in zip(tree, *rest)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """The leaves in the reference's order: ``jax.tree.leaves`` sorts dict
    keys at every level and keeps list and tuple order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _leaf_to_tensor(v, dev: torch.device) -> torch.Tensor:
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":           # ml_dtypes: same bits as torch
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.tensor(a, device=dev)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def tree_from_numpy(tree: Tree, device: DeviceLike = None) -> Tree:
    """numpy (or array-like) leaves -> tensors on ``device`` (default
    CUDA), structure and dtypes kept.  The leaves are copied, never
    aliased."""
    dev = resolve_device(device)
    return tree_map(lambda v: _leaf_to_tensor(v, dev), tree)


def tree_to_numpy(tree: Tree) -> Tree:
    """Tensors (any device) -> numpy copies on the host."""
    return tree_map(_leaf_to_numpy, tree)


# the classic models' flat parameter dicts are trees too
params_from_numpy = tree_from_numpy
params_to_numpy = tree_to_numpy
