"""Synthetic stand-ins for the paper's datasets (not public), in numpy.

A copy of the reference generators: the same seeds draw the same numbers
in the same order, so every array is bit-equal to the reference's.

* Wafer (SVM): 20,000 samples, 59-dim features, 8 classes — anisotropic
  Gaussian class clusters with partial overlap so linear-SVM accuracy
  saturates below 100%.
* Traffic (K-means): 20,000 samples, 64-dim image-feature-like mixture with
  K=3 unequal clusters.

``partition_edges`` produces the non-IID per-edge splits (Dirichlet over
class proportions).  The arrays stay numpy here; ``ClassicExecutor``
moves them to the device once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def make_wafer_dataset(n: int = 20000, d: int = 59, n_classes: int = 8,
                       seed: int = 0, test_frac: float = 0.2
                       ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    means = rng.normal(0.0, 0.55, size=(n_classes, d))
    # shared anisotropy so classes overlap in some directions
    basis = rng.normal(0.0, 1.0, size=(d, d))
    scales = np.exp(rng.normal(0.0, 0.4, size=d))
    y = rng.integers(0, n_classes, size=n)
    x = means[y] + rng.normal(0.0, 1.0, size=(n, d)) * scales
    x = x @ (basis / np.sqrt(d))
    x = (x - x.mean(0)) / (x.std(0) + 1e-6)
    n_test = int(n * test_frac)
    idx = rng.permutation(n)
    tr, te = idx[n_test:], idx[:n_test]
    return ({"x": x[tr].astype(np.float32), "y": y[tr].astype(np.int32)},
            {"x": x[te].astype(np.float32), "y": y[te].astype(np.int32)})


def make_traffic_dataset(n: int = 20000, d: int = 64, k: int = 3,
                         seed: int = 0, test_frac: float = 0.2
                         ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed + 1)
    weights = np.array([0.5, 0.3, 0.2])[:k]
    weights = weights / weights.sum()
    means = rng.normal(0.0, 0.35, size=(k, d))
    y = rng.choice(k, size=n, p=weights)
    x = means[y] + rng.normal(0.0, 1.0, size=(n, d))
    n_test = int(n * test_frac)
    idx = rng.permutation(n)
    tr, te = idx[n_test:], idx[:n_test]
    return ({"x": x[tr].astype(np.float32), "y": y[tr].astype(np.int32)},
            {"x": x[te].astype(np.float32), "y": y[te].astype(np.int32)})


def partition_edges(data: Dict[str, np.ndarray], n_edges: int,
                    alpha: float = 1.0, seed: int = 0
                    ) -> List[Dict[str, np.ndarray]]:
    """Dirichlet non-IID split of (x, y) across edge servers."""
    rng = np.random.default_rng(seed + 2)
    y = data["y"]
    n_classes = int(y.max()) + 1
    edge_indices: List[List[int]] = [[] for _ in range(n_edges)]
    for cls in range(n_classes):
        cls_idx = np.where(y == cls)[0]
        rng.shuffle(cls_idx)
        props = rng.dirichlet([alpha] * n_edges)
        cuts = (np.cumsum(props) * len(cls_idx)).astype(int)[:-1]
        for e, part in enumerate(np.split(cls_idx, cuts)):
            edge_indices[e].extend(part.tolist())
    out = []
    for e in range(n_edges):
        idx = np.asarray(edge_indices[e], dtype=np.int64)
        rng.shuffle(idx)
        if len(idx) == 0:                        # never leave an edge empty
            idx = rng.integers(0, len(y), size=8)
        out.append({k: v[idx] for k, v in data.items()})
    return out
