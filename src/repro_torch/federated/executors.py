"""Executors: the ML data plane the EL runtime drives.

``ClassicExecutor`` runs SVM / K-means local training on per-edge
(non-IID) datasets and satisfies ``repro_torch.el.EdgeExecutor``
structurally (``local_train`` / ``evaluate`` / ``init_params``).  The
per-edge datasets and the evaluation set are moved to the device once;
minibatch indices are drawn on the host from the reference's numpy stream
(``default_rng(seed).integers``), copied over in one transfer per block,
and gathered on the device.  A block of ``n_iters`` local steps is a
Python loop of ``model.step`` (the reference's ``lax.scan`` of
``local_step``, whose unused metrics XLA drops) with no host sync inside.

``LMExecutor`` trains a language model under the same interface
(params only; each local block starts fresh optimizer moments, the
standard local-SGD simplification, as in the reference).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.interop import tree_map
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.state import (TrainState, make_eval_step,
                                     make_train_step)

Params = Any


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


class LMExecutor:
    """Language models under the EL interface (loss-based metric), on the
    model's device.

    ``local_train`` runs ``n_iters`` train steps (grad, clip, AdamW or
    SGD) from the given parameters, left untouched, over the edge's
    stream ``data.batch(edge, start + i)``, where ``start`` is a per-edge
    step counter the block advances; its optimizer state starts fresh.
    ``evaluate`` is the CE loss on ``data.batch(999, 0)``.  The
    reference's masked ``lax.scan`` over ``h_max`` steps is a Python
    loop of ``n_iters`` steps.
    """

    def __init__(self, model, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 batch: int = 4, seq_len: int = 64, seed: int = 0):
        self.model = model
        self.device = model.device
        self.train_cfg = train_cfg
        self.data = SyntheticLMData.for_model(model_cfg, batch, seq_len,
                                              seed=seed)
        self._train_step = make_train_step(model, train_cfg)
        self._eval_step = make_eval_step(model)
        self._step_counter = np.zeros(64, np.int64)
        self._eval_batch = self.data.batch(999, 0, device=self.device)

    def init_params(self, seed: int = 0) -> Params:
        return self.model.init(
            torch.Generator(device=self.device).manual_seed(seed))

    def local_train(self, params: Params, edge: int, n_iters: int,
                    seed: int) -> Tuple[Params, Dict]:
        n_iters = int(n_iters)
        own = tree_map(torch.clone, params)     # the update is in place
        state = TrainState(own, init_opt_state(self.train_cfg, own))
        start = int(self._step_counter[edge])
        self._step_counter[edge] += n_iters
        for i in range(n_iters):
            batch = self.data.batch(edge, start + i, device=self.device)
            state, _ = self._train_step(state, batch)
        return state.params, {}

    def evaluate(self, params: Params) -> Dict[str, float]:
        loss = float(self._eval_step(params, self._eval_batch)["ce_loss"])
        return {"loss": loss, "neg_loss": -loss}
