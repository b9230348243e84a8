"""Dependency-free checkpointing: trees <-> .npz files (port of
``repro.train.checkpoint``).

The file format is the reference's, so a checkpoint written by either
package restores in the other: one array per leaf, keyed by its path as a
'/'-joined string (dict keys by name; list and tuple items by index;
NamedTuple fields by name, as ``params/...``, ``opt/step``, ``opt/mu/...``
of a ``TrainState``; ``_root`` for a bare leaf), bfloat16 leaves stored
as float32 under a ``bf16:`` prefix, and the step, if given, under
``_ckpt_step``.  ``restore`` rebuilds into a template tree (every leaf
present, shapes checked, values cast to the template's dtype) and places
each leaf on its template leaf's device, so it round-trips parameters,
optimizer state and EL reports' final parameters alike.

Both directions go one leaf at a time through the host (``np.savez``'s
own zip layout, written leaf by leaf), so a training state of tens of GB
on the card never has a whole copy in host memory.
"""

from __future__ import annotations

import os
import zipfile
from typing import Any, Callable, Tuple

import numpy as np
import torch

from repro_torch.interop import tree_from_numpy, tree_to_numpy

Tree = Any


def _map_with_key(fn: Callable[[str, Any], Any], tree: Tree,
                  path: Tuple[str, ...] = ()) -> Tree:
    """``fn(key, leaf)`` on every leaf, the key the reference's
    ``_path_str`` of the leaf's path (``_root`` for a bare leaf); the
    tree's structure is kept."""
    if isinstance(tree, dict):
        return {k: _map_with_key(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_key(fn, getattr(tree, name),
                                          path + (name,))
                            for name in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_key(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path) or "_root", tree)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, tree: Tree, step: int | None = None) -> None:
    path = _npz(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:

        def write(key: str, arr: np.ndarray) -> None:
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)

        def leaf(key: str, t: torch.Tensor) -> None:
            arr = tree_to_numpy(t)
            if arr.dtype.name == "bfloat16":
                write("bf16:" + key, arr.astype(np.float32))
            else:
                write(key, arr)

        _map_with_key(leaf, tree)
        if step is not None:
            write("_ckpt_step", np.asarray(step))


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    if dtype == torch.bfloat16:
        import ml_dtypes
        return np.dtype(ml_dtypes.bfloat16)
    return torch.empty((), dtype=dtype).numpy().dtype


def restore(path: str, template: Tree) -> Tree:
    """Load a checkpoint into the structure of ``template`` (a tree of
    tensors): each leaf cast to its template leaf's dtype and placed on
    that leaf's device."""
    with np.load(_npz(path), allow_pickle=False) as data:
        names = {k[5:] if k.startswith("bf16:") else k: k
                 for k in data.files}

        def load(key: str, leaf: torch.Tensor) -> torch.Tensor:
            if key not in names:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[names[key]].astype(_numpy_dtype(leaf.dtype),
                                          copy=False)
            if arr.shape != tuple(leaf.shape):
                raise ValueError(
                    f"shape mismatch for {key!r}: ckpt {arr.shape} "
                    f"vs template {tuple(leaf.shape)}")
            return tree_from_numpy(arr, leaf.device)

        return _map_with_key(load, template)


def latest_step(path: str) -> int | None:
    try:
        data = np.load(_npz(path))
    except FileNotFoundError:
        return None
    with data:
        if "_ckpt_step" in data.files:
            return int(data["_ckpt_step"])
    return None
