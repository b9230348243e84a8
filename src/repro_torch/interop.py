"""Carry parameters and caches between the port and numpy.

The reference draws its parameters from ``jax.random``, which torch cannot
reproduce, so a run that must start from the reference's model takes its
tree as numpy (``jax.tree.map(np.asarray, params)`` on the reference side)
and places it here.  A tree is a nested structure of dicts and lists with
array leaves: the classic models' flat ``dict[str, array]``, and the LM's
nested one with its stacked ``groups`` level (leaves ``[n_groups, ...]``)
and the cache's scalar ``index``.  Structure, shapes and dtypes are kept,
bfloat16 included (numpy holds it as ``ml_dtypes.bfloat16``).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Tree = Any


def tree_map(fn: Callable, tree: Tree) -> Tree:
    """Apply ``fn`` to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


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
