"""Model aggregation primitives (cloud-side global updates).

Each mirrors the reference's arithmetic op for op, so the same inputs give
the same f32 values: leaves are upcast to f32, the scalar weights are
rounded to f32 first (as JAX rounds a numpy/Python scalar against an f32
array), and a weighted average is summed over the edges in index order.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def _f32(v: float) -> float:
    """``v`` rounded to the nearest f32 (held in a Python float)."""
    return float(np.float32(v))


def weighted_average(params_list: Sequence[Params],
                     weights: Sequence[float]) -> Params:
    """Synchronous global update: weighted average of edge models."""
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    out = {}
    for name, first in params_list[0].items():
        acc = sum(_f32(wi) * p[name].float() for wi, p in zip(w, params_list))
        out[name] = acc.to(first.dtype)
    return out


def staleness_mix(global_params: Params, edge_params: Params,
                  alpha: float) -> Params:
    """Asynchronous global update: G <- (1-a) G + a theta_e, with a the
    staleness-discounted mixing rate."""
    keep, take = _f32(1.0 - float(alpha)), _f32(float(alpha))
    return {name: (keep * g.float() + take * edge_params[name].float()
                   ).to(g.dtype)
            for name, g in global_params.items()}


def staleness_alpha(base: float, staleness: float) -> float:
    """Polynomial staleness discount  a = base / (1 + s)."""
    return base / (1.0 + max(staleness, 0.0))
