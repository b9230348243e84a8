"""Carry parameters between the port and numpy.

The reference's K-means centres come from ``jax.random.normal``, which
torch cannot reproduce, so a run that must start from the reference's
model takes its params as numpy (``jax.tree.map(np.asarray, params)`` on
the reference side) and places them here.  Params are flat
``dict[str, array]`` in both packages.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def params_from_numpy(tree: Dict[str, np.ndarray],
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """numpy (or array-like) leaves -> tensors on ``device`` (default
    CUDA), dtypes kept.  The leaves are copied, never aliased."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), device=dev) for k, v in tree.items()}


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Tensors (any device) -> numpy copies on the host."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
