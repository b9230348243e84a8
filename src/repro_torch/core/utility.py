"""Learning-utility estimators (§III.A).

The paper defines utility either (a) via a model-specific metric on a small
test set uploaded to the cloud, or (b) via the difference between global
parameters at consecutive slots — smaller difference = higher utility
(their K-means example uses the negative center shift).

All estimators map onto a common interface:
    ``utility(prev_snapshot, new_snapshot) -> float``
where snapshots carry whatever the estimator needs (params and/or metric).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.interop import tree_leaves, tree_map

Params = Any


def param_l2_delta(prev_params: Params, new_params: Params) -> float:
    """Global L2 distance between two parameter trees.

    Computed on the params' device with one host read per call: each
    leaf's squared distance is summed in f32 (leaves in the order
    ``jax.tree.leaves`` gives the reference: dict keys sorted at every
    level), and the per-leaf sums are added in f64 as the reference adds
    Python floats.
    """
    sq = tree_map(lambda a, b: (a.float() - b.float()).square().sum(),
                  prev_params, new_params)
    per_leaf = torch.stack(tree_leaves(sq))
    return math.sqrt(per_leaf.double().sum().item())


@dataclasses.dataclass
class UtilityEstimator:
    """kind: 'param_delta' | 'eval_gain' | 'loss_delta'."""

    kind: str = "param_delta"
    scale: float = 1.0

    def __call__(self, prev: Dict[str, Any], new: Dict[str, Any]) -> float:
        if self.kind == "param_delta":
            # smaller parameter movement => closer to convergence => higher
            # utility (paper §III.A): u = 1 / (1 + ||Δθ||)
            delta = param_l2_delta(prev["params"], new["params"])
            return self.scale / (1.0 + delta)
        if self.kind == "eval_gain":
            return self.scale * (new["metric"] - prev["metric"])
        if self.kind == "loss_delta":
            return self.scale * (prev["loss"] - new["loss"])
        raise ValueError(f"unknown utility kind {self.kind!r}")
