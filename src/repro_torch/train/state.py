"""Train state + step factories (port of ``repro.train.state``).

The gradient is ``torch.autograd.grad`` of ``model.loss`` over the
parameter tree's leaves; the update is ``apply_updates``, in place.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.interop import tree_map
from repro_torch.train.optimizer import OptState, apply_updates, \
    init_opt_state

Params = Any


class TrainState(NamedTuple):
    params: Params
    opt: OptState


def init_train_state(model, train_cfg: TrainConfig,
                     gen: torch.Generator) -> TrainState:
    params = model.init(gen)
    return TrainState(params=params, opt=init_opt_state(train_cfg, params))


def loss_and_grads(model, params: Params, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor], Params]:
    """``model.loss`` and its gradient tree (same structure as
    ``params``); the metrics are detached, so holding them keeps no
    activations alive."""
    leaves = []

    def track(p: torch.Tensor) -> torch.Tensor:
        leaves.append(p.detach().requires_grad_())
        return leaves[-1]

    tracked = tree_map(track, params)
    loss, metrics = model.loss(tracked, batch)
    it = iter(torch.autograd.grad(loss, leaves))
    grads = tree_map(lambda _: next(it), tracked)
    return {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model, train_cfg: TrainConfig):
    """Standard synchronous train step: grad -> clip -> update.  The
    state's parameters and moments are updated in place."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        metrics, grads = loss_and_grads(model, state.params, batch)
        params, opt, opt_metrics = apply_updates(
            train_cfg, state.params, grads, state.opt)
        return TrainState(params, opt), dict(metrics, **opt_metrics)

    return train_step


def make_eval_step(model):
    def eval_step(params: Params, batch: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            _, metrics = model.loss(params, batch)
        return metrics

    return eval_step


def make_prefill_step(model, last_only: bool = False):
    def prefill_step(params: Params, batch: Dict[str, torch.Tensor]
                     ) -> torch.Tensor:
        with torch.no_grad():
            logits, _ = model.forward(params, batch["tokens"],
                                      batch.get("prefix_emb"),
                                      last_only=last_only)
        return logits

    return prefill_step


def make_decode_step(model):
    def decode_step(params: Params, tokens: torch.Tensor, cache: Any
                    ) -> Tuple[torch.Tensor, Any]:
        with torch.no_grad():
            return model.decode_step(params, tokens, cache)

    return decode_step
