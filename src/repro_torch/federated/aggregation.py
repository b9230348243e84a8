"""Model aggregation primitives (cloud-side global updates).

Each mirrors the reference's arithmetic op for op, so the same inputs give
the same f32 values: leaves are upcast to f32, the scalar weights are
rounded to f32 first (as JAX rounds a numpy/Python scalar against an f32
array), and a weighted average is summed over the edges in index order.
Parameters are any tree of dicts and lists (``interop.tree_map``): the
classic models' flat dicts and the LM's nested ``groups/sub0/...`` tree
alike, as the reference takes any pytree through ``jax.tree.map``.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from repro_torch.interop import tree_map

Params = Any


def _f32(v: float) -> float:
    """``v`` rounded to the nearest f32 (held in a Python float)."""
    return float(np.float32(v))


def weighted_average(params_list: Sequence[Params],
                     weights: Sequence[float]) -> Params:
    """Synchronous global update: weighted average of edge models."""
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    w32 = [_f32(wi) for wi in w]

    def avg(*leaves):
        acc = sum(wi * leaf.float() for wi, leaf in zip(w32, leaves))
        return acc.to(leaves[0].dtype)

    return tree_map(avg, *params_list)


def staleness_mix(global_params: Params, edge_params: Params,
                  alpha: float) -> Params:
    """Asynchronous global update: G <- (1-a) G + a theta_e, with a the
    staleness-discounted mixing rate."""
    keep, take = _f32(1.0 - float(alpha)), _f32(float(alpha))
    return tree_map(lambda g, e: (keep * g.float() + take * e.float()
                                  ).to(g.dtype),
                    global_params, edge_params)


def staleness_alpha(base: float, staleness: float) -> float:
    """Polynomial staleness discount  a = base / (1 + s)."""
    return base / (1.0 + max(staleness, 0.0))
