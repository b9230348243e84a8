"""The classic-workload executor: the ML data plane the EL runtime drives.

``ClassicExecutor`` runs SVM / K-means local training on per-edge
(non-IID) datasets and satisfies ``repro_torch.el.EdgeExecutor``
structurally (``local_train`` / ``evaluate`` / ``init_params``).  The
per-edge datasets and the evaluation set are moved to the device once;
minibatch indices are drawn on the host from the reference's numpy stream
(``default_rng(seed).integers``), copied over in one transfer per block,
and gathered on the device.  A block of ``n_iters`` local steps is a
Python loop of ``model.step`` (the reference's ``lax.scan`` of
``local_step``, whose unused metrics XLA drops) with no host sync inside.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


class ClassicExecutor:
    """SVM / K-means on per-edge datasets."""

    def __init__(self, model, edge_data: List[Dict[str, np.ndarray]],
                 eval_set: Dict[str, np.ndarray], batch: int = 64,
                 lr: float = 0.05, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model
        self.edge_data = edge_data
        self._edges = [{k: torch.as_tensor(v, device=self.device)
                        for k, v in e.items()} for e in edge_data]
        self.eval_set = {k: torch.as_tensor(v, device=self.device)
                         for k, v in eval_set.items()}
        self.batch = batch
        self.lr = lr

    def init_params(self, seed: int = 0) -> Params:
        return self.model.init(torch.Generator().manual_seed(seed))

    def sample_batches(self, edge: int, n_iters: int, seed: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[n_iters, batch]`` minibatches (with replacement) of ``edge``'s
        data: the reference's index draw, gathered on the device."""
        data = self._edges[edge]
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, data["y"].shape[0], size=(n_iters, self.batch))
        idx = torch.as_tensor(idx, device=self.device)
        return data["x"][idx], data["y"][idx]

    def local_train(self, params: Params, edge: int, n_iters: int,
                    seed: int) -> Tuple[Params, Dict]:
        xs, ys = self.sample_batches(edge, n_iters, seed)
        for i in range(n_iters):
            params = self.model.step(params, {"x": xs[i], "y": ys[i]},
                                     self.lr)
        return params, {}

    def evaluate(self, params: Params) -> Dict[str, float]:
        return self.model.evaluate(params, self.eval_set)
